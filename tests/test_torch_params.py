"""PyTorch port: shipped weights, the copies it keeps of JAX-package code,
and import hygiene.

Every copy the port keeps (constants, numpy builders, host decoder, MIDI
writer, WAV reader) is pinned here equal to the JAX package's original, so
the two cannot drift apart silently.
"""

import ast
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from basic_pitch_torch import constants as t_constants
from basic_pitch_torch.decode import device as t_device
from basic_pitch_torch.decode import export as t_export
from basic_pitch_torch.decode import notes as t_notes
from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_torch.ops import cqt as t_cqt
from basic_pitch_torch.ops import harmonic as t_harmonic
from basic_pitch_torch.ops import resample as t_resample
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_tpu import constants as j_constants
from basic_pitch_tpu.decode import device as j_device
from basic_pitch_tpu.decode import export as j_export
from basic_pitch_tpu.decode import notes as j_notes
from basic_pitch_tpu.models import nmp as j_nmp
from basic_pitch_tpu.models import params as j_params
from basic_pitch_tpu.ops import cqt as j_cqt
from basic_pitch_tpu.ops import harmonic as j_harmonic
from basic_pitch_tpu.ops import resample as j_resample
from basic_pitch_tpu.utils import audio as j_audio

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "basic_pitch_torch"


def test_checkpoint_is_byte_identical():
    assert t_params.ICASSP_2022_WEIGHTS_PATH.read_bytes() == j_params.ICASSP_2022_WEIGHTS_PATH.read_bytes()


def test_from_jax_params_round_trips_exactly():
    flat = t_params.load_flat()
    state = t_params.from_jax_params(flat)
    model = t_nmp.NMP()
    model.load_state_dict(state)  # every key present, every shape right
    for name in t_params.CONV_NAMES:
        w = state[f"{name}.weight"].numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
        np.testing.assert_array_equal(w, flat[f"{name}/w"])
        np.testing.assert_array_equal(state[f"{name}.bias"].numpy(), flat[f"{name}/b"])
    for name in t_params.BN_NAMES:
        for jax_field, torch_field in t_params.BN_FIELDS.items():
            np.testing.assert_array_equal(state[f"{name}.{torch_field}"].numpy(), flat[f"{name}/{jax_field}"])
    n_arrays = 2 * len(t_params.CONV_NAMES) + 4 * len(t_params.BN_NAMES)
    assert len(flat) == n_arrays


def test_constants_copy_matches():
    names = [n for n in dir(j_constants) if n.isupper()]
    assert names
    for name in names:
        a, b = getattr(j_constants, name), getattr(t_constants, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize(
    "geometry",
    [
        {},
        dict(sr=22050, hop_length=512, fmin=32.70, n_bins=48, bins_per_octave=24),
    ],
)
def test_cqt_builders_match(geometry):
    a, b = j_cqt.build_cqt_kernels(**geometry), t_cqt.build_cqt_kernels(**geometry)
    for field in ("sr", "hop_length", "fmin", "n_bins", "bins_per_octave", "n_octaves", "n_fft",
                  "n_filters", "downsample_factor"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("top_octave_kernels", "lowpass", "length_norm"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    if a.early_lowpass is None:
        assert b.early_lowpass is None
    else:
        np.testing.assert_array_equal(a.early_lowpass, b.early_lowpass)
    np.testing.assert_array_equal(
        j_cqt._decimation_matrix(a.lowpass.astype(np.float64)), t_cqt.decimation_matrix(b.lowpass)
    )


def test_model_cqt_geometry_matches():
    a, b = j_nmp.cqt_kernels_for(8), t_nmp.cqt_kernels()
    np.testing.assert_array_equal(a.top_octave_kernels, b.top_octave_kernels)
    assert a.n_bins == b.n_bins == 309
    assert t_nmp.HARMONICS == j_nmp.DEFAULT_CONFIG.harmonics


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_strided_toeplitz_matches(stride):
    taps = np.random.RandomState(stride).randn(200)
    np.testing.assert_array_equal(
        j_cqt.strided_toeplitz_matrix(taps, stride), t_cqt.strided_toeplitz_matrix(taps, stride)
    )


def test_decimate2_taps_and_matrix_match():
    np.testing.assert_array_equal(j_resample.decimate2_taps(), t_resample.decimate2_taps())
    np.testing.assert_array_equal(j_resample._decimate2_matrix(), t_resample.decimate2_matrix())


def test_bend_tables_match():
    for a, b in zip(j_device._bend_tables(), t_device._bend_tables()):
        np.testing.assert_array_equal(a, b)


def test_harmonic_shifts_match():
    for bps in (1, 3):
        harmonics = (0.5, 1, 2, 3, 4, 5, 6, 7, 1.5)
        assert t_harmonic.harmonic_shifts(bps, harmonics) == j_harmonic.harmonic_shifts(bps, harmonics)


def test_host_decoder_copy_matches():
    rng = np.random.RandomState(4)
    frames = (rng.rand(400, 88) ** 3).astype(np.float32)
    onsets = (rng.rand(400, 88) ** 5).astype(np.float32)
    contours = rng.rand(400, 264).astype(np.float32)
    cfg_j = j_notes.DecodeConfig(min_freq=60.0, max_freq=2000.0)
    cfg_t = t_notes.DecodeConfig(min_freq=60.0, max_freq=2000.0)
    notes_j = j_notes.decode_note_events(frames, onsets, cfg_j)
    notes_t = t_notes.decode_note_events(frames, onsets, cfg_t)
    assert notes_j == notes_t and len(notes_j) > 10
    assert j_notes.extract_pitch_bends(contours, notes_j) == t_notes.extract_pitch_bends(contours, notes_t)
    np.testing.assert_array_equal(j_notes.model_frames_to_time(1000), t_notes.model_frames_to_time(1000))
    for p in (21, 60, 108):
        assert j_notes.midi_pitch_to_contour_bin(p) == t_notes.midi_pitch_to_contour_bin(p)
    assert j_notes.hz_to_midi(261.6) == t_notes.hz_to_midi(261.6)


@pytest.mark.parametrize("multiple_pitch_bends", [False, True])
def test_midi_writer_bytes_match(multiple_pitch_bends):
    rng = np.random.RandomState(9)
    events = []
    for _ in range(30):
        s = float(rng.uniform(0, 20))
        n = int(rng.randint(1, 12))
        events.append((s, s + float(rng.uniform(0.05, 2)), int(rng.randint(21, 109)),
                       float(rng.uniform(0, 1)), [int(x) for x in rng.randint(-3, 4, n)]))
    out = []
    for export in (j_export, t_export):
        buf = io.BytesIO()
        export.note_events_to_midi(events, multiple_pitch_bends).write(buf)
        out.append(buf.getvalue())
    assert out[0] == out[1]


def test_wav_reader_copy_matches(tmp_path):
    rng = np.random.RandomState(2)
    x = (rng.rand(5000, 2) * 1.6 - 0.8).astype(np.float32)
    path = tmp_path / "two.wav"
    j_audio.write_wav(path, x, 44100)
    a, sr_a = j_audio.read_wav(path)
    b, sr_b = t_audio.read_wav(path)
    assert sr_a == sr_b == 44100
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j_audio.to_mono(a), t_audio.to_mono(b))
    mono = t_audio.to_mono(b)
    np.testing.assert_allclose(
        t_audio.resample(mono, 44100, 16000), j_audio.resample(mono, 44100, 16000), atol=1e-6
    )


CHIP_SCRIPTS = ("chip_smoke.py", "chip_decode_times.py")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / name for name in CHIP_SCRIPTS]


def test_no_jax_or_reference_package_imports_in_sources():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "basic_pitch_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import basic_pitch_torch\n"
        "for m in pkgutil.walk_packages(basic_pitch_torch.__path__, 'basic_pitch_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'basic_pitch_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'basic_pitch_torch.pipeline' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_transcriber_without_device_raises_when_no_gpu(monkeypatch):
    from basic_pitch_torch import pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.StreamingTranscriber()
    with pytest.raises(RuntimeError):
        pipeline.StreamingTranscriber(device="cuda")
    assert pipeline.StreamingTranscriber(windows_per_chunk=1, device="cpu").decode_backend == "plain"


@pytest.mark.parametrize("script", CHIP_SCRIPTS)
def test_chip_scripts_refuse_without_a_gpu(script):
    """With no CUDA device the chip scripts exit non-zero and print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs an NVIDIA GPU" in proc.stderr
