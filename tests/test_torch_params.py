"""PyTorch port: shipped weights, the copies it keeps of JAX-package code,
and import hygiene.

Every copy the port keeps (constants, numpy builders, host decoder, MIDI
writer/reader/synth, WAV reader/writer and loaders, export helpers, CLI
printing, host allocator tuning, the training data codecs and loader
constants, the training defaults) is pinned here equal to the JAX package's
original, so the two cannot drift apart silently.
"""

import ast
import dataclasses
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from basic_pitch_torch import _build as t_build
from basic_pitch_torch import constants as t_constants
from basic_pitch_torch.data import loader as t_loader
from basic_pitch_torch.data import proto as t_proto
from basic_pitch_torch.data import serialization as t_serialization
from basic_pitch_torch.data import tfrecord as t_tfrecord
from basic_pitch_torch.decode import device as t_device
from basic_pitch_torch.decode import export as t_export
from basic_pitch_torch.decode import notes as t_notes
from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_torch.ops import cqt as t_cqt
from basic_pitch_torch.ops import harmonic as t_harmonic
from basic_pitch_torch.ops import resample as t_resample
from basic_pitch_torch.train import loop as t_loop
from basic_pitch_torch.train import losses as t_losses
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_torch.utils import hostmem as t_hostmem
from basic_pitch_torch.utils import midi as t_midi
from basic_pitch_torch.utils import printing as t_printing
from basic_pitch_tpu import constants as j_constants
from basic_pitch_tpu.data import loader as j_loader
from basic_pitch_tpu.data import proto as j_proto
from basic_pitch_tpu.data import serialization as j_serialization
from basic_pitch_tpu.data import tfrecord as j_tfrecord
from basic_pitch_tpu.decode import device as j_device
from basic_pitch_tpu.decode import export as j_export
from basic_pitch_tpu.decode import notes as j_notes
from basic_pitch_tpu.models import nmp as j_nmp
from basic_pitch_tpu.models import params as j_params
from basic_pitch_tpu.ops import cqt as j_cqt
from basic_pitch_tpu.ops import harmonic as j_harmonic
from basic_pitch_tpu.ops import resample as j_resample
from basic_pitch_tpu.train import loop as j_loop
from basic_pitch_tpu.train import losses as j_losses
from basic_pitch_tpu.utils import audio as j_audio
from basic_pitch_tpu.utils import hostmem as j_hostmem
from basic_pitch_tpu.utils import midi as j_midi
from basic_pitch_tpu.utils import printing as j_printing

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


@pytest.mark.parametrize("n_harmonics", [1, 2, 5, 8])
def test_model_config_geometry_matches(n_harmonics):
    assert t_nmp.default_harmonics(n_harmonics) == j_nmp.default_harmonics(n_harmonics)
    assert t_nmp.n_semitones_for_harmonics(n_harmonics) == j_nmp.n_semitones_for_harmonics(n_harmonics)
    a, b = j_nmp.cqt_kernels_for(n_harmonics), t_nmp.cqt_kernels_for(n_harmonics)
    assert a.n_bins == b.n_bins
    np.testing.assert_array_equal(a.top_octave_kernels, b.top_octave_kernels)
    j_config, t_config = j_nmp.ModelConfig(n_harmonics=n_harmonics), t_nmp.ModelConfig(n_harmonics=n_harmonics)
    for field in ("n_harmonics", "n_filters_contour", "n_filters_notes", "n_filters_onsets", "no_contours",
                  "trainable_cqt", "harmonics"):
        assert getattr(t_config, field) == getattr(j_config, field), field
    assert (t_nmp.BN_EPSILON, t_nmp.BN_MOMENTUM, t_nmp.MAX_N_SEMITONES) == (
        j_nmp.BN_EPSILON, j_nmp.BN_MOMENTUM, j_nmp.MAX_N_SEMITONES
    )


def test_training_defaults_match():
    """The losses' constants, `TrainConfig`'s fields and defaults, and the
    transport's head geometry."""
    assert (t_losses.DEFAULT_LABEL_SMOOTHING, t_losses.DEFAULT_POSITIVE_WEIGHT, t_losses._EPS) == (
        j_losses.DEFAULT_LABEL_SMOOTHING, j_losses.DEFAULT_POSITIVE_WEIGHT, j_losses._EPS
    )
    t_fields = {f.name: f.default for f in dataclasses.fields(t_loop.TrainConfig)}
    j_fields = {f.name: f.default for f in dataclasses.fields(j_loop.TrainConfig)}
    assert t_fields == j_fields
    assert t_loop.TRAIN_PRECISIONS == tuple(j_loop._TRAIN_PRECISIONS)
    assert t_loop._HEAD_BINS == j_loop._HEAD_BINS and t_loop._WIRE_MIN_BUCKET == j_loop._WIRE_MIN_BUCKET
    for name in ("ReduceLROnPlateau", "EarlyStopping"):
        t_defaults = {f.name: f.default for f in dataclasses.fields(getattr(t_loop, name))}
        j_defaults = {f.name: f.default for f in dataclasses.fields(getattr(j_loop, name))}
        assert t_defaults == j_defaults, name


def test_loader_constants_match():
    assert t_loader.N_SAMPLES_PER_TRACK == j_loader.N_SAMPLES_PER_TRACK
    assert t_loader._SPARSE_CAP_FLOORS == j_loader._SPARSE_CAP_FLOORS
    assert t_loader._HEAD_BINS == j_loader._HEAD_BINS and t_loader._HEAD_TO_SER == j_loader._HEAD_TO_SER
    assert t_serialization.FEATURE_NAMES == j_serialization.FEATURE_NAMES


def test_proto_and_tfrecord_copies_match(tmp_path):
    """The protobuf codec gives the JAX package's bytes for every feature
    kind and decodes them alike; the table-driven CRC-32C equals the JAX
    package's (native where built) on seeded buffers."""
    rng = np.random.RandomState(3)
    features = {
        "bytes": [b"abc", b""],
        "ints": rng.randint(-(2**40), 2**40, 17).astype(np.int64),
        "floats": rng.randn(9).astype(np.float32),
        "tensor": j_proto.encode_tensor(rng.randn(3, 4).astype(np.float32)),
    }
    encoded = t_proto.encode_example(features)
    assert encoded == j_proto.encode_example(features)
    a, b = t_proto.decode_example(encoded), j_proto.decode_example(encoded)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key], dtype=object if key in ("bytes", "tensor") else None),
                                      np.asarray(b[key], dtype=object if key in ("bytes", "tensor") else None))
    for dtype in (np.float32, np.int32, np.int64):
        arr = (rng.randn(2, 5) * 100).astype(dtype)
        assert t_proto.encode_tensor(arr) == j_proto.encode_tensor(arr)
        np.testing.assert_array_equal(t_proto.decode_tensor(t_proto.encode_tensor(arr)), arr)
    for n in (0, 1, 7, 8, 9, 1000, 4099):
        data = rng.bytes(n)
        assert t_tfrecord.crc32c(data) == j_tfrecord.crc32c(data), n
        assert t_tfrecord.masked_crc(data) == j_tfrecord.masked_crc(data), n
    assert t_tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_model_cqt_geometry_matches():
    a, b = j_nmp.cqt_kernels_for(8), t_nmp.cqt_kernels_for(t_nmp.DEFAULT_CONFIG.n_harmonics)
    np.testing.assert_array_equal(a.top_octave_kernels, b.top_octave_kernels)
    assert a.n_bins == b.n_bins == 309
    assert t_nmp.DEFAULT_CONFIG.harmonics == j_nmp.DEFAULT_CONFIG.harmonics


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


@pytest.mark.parametrize("alias", ["get_infered_onsets", "get_pitch_bends", "output_to_notes_polyphonic"])
def test_reference_named_decoder_aliases_match(alias):
    """The reference-named aliases of the host decoder: the JAX signature,
    and on the same seeded posteriorgrams the same events (amplitudes within
    2e-6) as the JAX package's."""
    import inspect

    assert str(inspect.signature(getattr(t_notes, alias))) == str(inspect.signature(getattr(j_notes, alias)))
    rng = np.random.RandomState(14)
    frames = (rng.rand(400, 88) ** 3).astype(np.float32)
    onsets = (rng.rand(400, 88) ** 5).astype(np.float32)
    contours = rng.rand(400, 264).astype(np.float32)
    if alias == "get_infered_onsets":
        np.testing.assert_allclose(t_notes.get_infered_onsets(onsets, frames), j_notes.get_infered_onsets(onsets, frames), atol=2e-6, rtol=0)
        return
    args = (frames, onsets, 0.5, 0.3, 11, True, 2000.0, 60.0)
    notes_t = t_notes.output_to_notes_polyphonic(*args)
    notes_j = j_notes.output_to_notes_polyphonic(*args)
    assert len(notes_t) > 10
    if alias == "get_pitch_bends":
        notes_t = t_notes.get_pitch_bends(contours, notes_t)
        notes_j = j_notes.get_pitch_bends(contours, notes_j)
    assert [n[:3] + n[4:] for n in notes_t] == [n[:3] + n[4:] for n in notes_j]
    np.testing.assert_allclose([n[3] for n in notes_t], [n[3] for n in notes_j], atol=2e-6, rtol=0)
    for melodia in (False, True):
        kw = dict(melodia_trick=melodia, energy_tol=5)
        assert t_notes.output_to_notes_polyphonic(*args, **kw) == j_notes.output_to_notes_polyphonic(*args, **kw)


def test_flat_and_nested_params_match_jax(nmp_params):
    """The port's `flatten_params` is the JAX package's (keys, order,
    values); `unflatten_params` inverts it; `flat_params` of an `NMP` is
    its checkpoint."""
    want = j_params.flatten_params(nmp_params)
    got = t_params.flatten_params(nmp_params)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    tree = t_params.unflatten_params(got)
    assert list(tree) == list(nmp_params) and all(list(tree[k]) == list(nmp_params[k]) for k in tree)
    assert list(t_params.flatten_params(tree)) == list(want)
    flat = t_params.load_flat()
    from_module = t_params.flat_params(t_params.model_from_flat(flat))
    assert set(from_module) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(from_module[key], flat[key])


def test_format_tables_match():
    """The copies of the format readers', writer's and evaluator's tables:
    magic numbers, dtype and op codes, the shape tables that identify each
    layer, the I/O names, the op set and the serialization selector."""
    import basic_pitch_torch as t_root
    import basic_pitch_tpu as j_root
    from basic_pitch_torch.cli import export as t_export_cli
    from basic_pitch_torch.cli import predict as t_predict_cli
    from basic_pitch_torch.models import coreml_import as t_coreml
    from basic_pitch_torch.models import onnx_eval as t_eval
    from basic_pitch_torch.models import onnx_export as t_onnx_export
    from basic_pitch_torch.models import onnx_import as t_onnx
    from basic_pitch_torch.models import savedmodel as t_sm
    from basic_pitch_torch.models import tflite_import as t_tflite
    from basic_pitch_tpu.cli import export as j_export_cli
    from basic_pitch_tpu.cli import predict as j_predict_cli
    from basic_pitch_tpu.models import coreml_import as j_coreml
    from basic_pitch_tpu.models import onnx_eval as j_eval
    from basic_pitch_tpu.models import onnx_export as j_onnx_export
    from basic_pitch_tpu.models import onnx_import as j_onnx
    from basic_pitch_tpu.models import savedmodel as j_sm
    from basic_pitch_tpu.models import tflite_import as j_tflite

    pins = {
        (t_sm, j_sm): ("TABLE_MAGIC", "_DTYPES", "_SUFFIX", "_BN_ROLES"),
        (t_tflite, j_tflite): ("_TFLITE_MAGIC", "_FLOAT32", "_BUILTIN_ADD", "_BUILTIN_CONV_2D", "_BUILTIN_MUL", "_CONV_BY_SHAPE"),
        (t_onnx, j_onnx): ("_FLOAT", "_CONV_BY_SHAPE"),
        (t_coreml, j_coreml): ("_CONV_BY_SIZE", "_BLOB_SENTINEL", "_BLOB_DTYPE_F32"),
        (t_onnx_export, j_onnx_export): (
            "OPSET", "IR_VERSION", "INPUT_NAME", "OUTPUT_NAMES", "_FLOAT", "_INT64",
            "_ATTR_FLOAT", "_ATTR_INT", "_ATTR_STRING", "_ATTR_INTS",
        ),
        (t_eval, j_eval): ("_FLOAT", "_INT64"),
        (t_export_cli, j_export_cli): ("ALL_FORMATS",),
    }
    for (t_mod, j_mod), names in pins.items():
        for name in names:
            assert getattr(t_mod, name) == getattr(j_mod, name), f"{t_mod.__name__}.{name}"
    assert set(t_eval._OPS) == set(j_eval._OPS)
    assert t_onnx_export.PRODUCER == b"basic_pitch_tpu"
    assert {s.name: s.value for s in t_root.FilenameSuffix} == {s.name: s.value for s in j_root.FilenameSuffix}
    assert t_root.ICASSP_2022_MODEL_PATH == t_params.ICASSP_2022_WEIGHTS_PATH
    for width in (1, 8, 32):
        j_bn, t_bn = j_nmp.identity_bn_stats(width), t_nmp.identity_bn_stats(width)
        assert set(j_bn) == set(t_bn)
        for key in j_bn:
            np.testing.assert_array_equal(t_bn[key], j_bn[key])
            assert t_bn[key].dtype == j_bn[key].dtype
    parser_opts = lambda parser: {a.dest: a.choices for a in parser._actions if a.choices}  # noqa: E731
    assert parser_opts(t_predict_cli.build_parser())["model_serialization"] == parser_opts(j_predict_cli.build_parser())["model_serialization"]


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


@pytest.mark.parametrize("channels,rate", [(1, 22050), (2, 44100)])
def test_wav_writer_bytes_match(channels, rate):
    x = (np.random.RandomState(channels).rand(3001, channels) * 2.4 - 1.2).astype(np.float32)  # clips
    outs = []
    for audio in (j_audio, t_audio):
        buf = io.BytesIO()
        audio.write_wav(buf, x[:, 0] if channels == 1 else x, rate)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def test_pcm16_reader_and_load_audio_copies_match(tmp_path):
    rng = np.random.RandomState(6)
    mono = (rng.rand(9000) * 1.6 - 0.8).astype(np.float32)
    cases = {
        "mono22.wav": (mono, 22050),
        "mono44.wav": (mono, 44100),
        "mono16k.wav": (mono, 16000),
        "stereo22.wav": (np.stack([mono, mono[::-1]], axis=1), 22050),
    }
    for name, (x, rate) in cases.items():
        t_audio.write_wav(tmp_path / name, x, rate)
    (tmp_path / "not_audio.bin").write_bytes(b"\x00" * 64)
    for name in list(cases) + ["not_audio.bin"]:
        a = j_audio.read_wav_pcm16_mono(tmp_path / name)
        b = t_audio.read_wav_pcm16_mono(tmp_path / name)
        if a is None:
            assert b is None, name
        else:
            assert a[1] == b[1] and b[0].dtype == np.int16, name
            np.testing.assert_array_equal(a[0], b[0])
        assert t_audio._is_wav(tmp_path / name) == j_audio._is_wav(tmp_path / name)
    assert t_audio.read_wav_pcm16_mono(tmp_path / "mono16k.wav") is None
    assert t_audio._is_wav(tmp_path / "missing.wav") is False
    # at the model rate there is no resampling: mono and stereo load exactly
    for name in ("mono22.wav", "stereo22.wav"):
        a, sr_a = j_audio.load_audio(tmp_path / name, 22050)
        b, sr_b = t_audio.load_audio(tmp_path / name, 22050)
        assert sr_a == sr_b == 22050 and b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t_audio.read_wav_mono(tmp_path / name)[0], j_audio.read_wav_mono(tmp_path / name)[0])
    a, _ = j_audio.load_audio(tmp_path / "mono16k.wav", 22050)
    b, _ = t_audio.load_audio(tmp_path / "mono16k.wav", 22050)
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    assert t_audio.ffmpeg_available() == j_audio.ffmpeg_available()
    if not t_audio.ffmpeg_available():
        with pytest.raises(t_audio.WavFormatError, match="ffmpeg"):
            t_audio.load_audio(tmp_path / "not_audio.bin", 22050)


def _midi_events(n, seed):
    rng = np.random.RandomState(seed)
    events = []
    for _ in range(n):
        s = float(rng.uniform(0, 5))
        events.append((s, s + float(rng.uniform(0.05, 1)), int(rng.randint(21, 109)),
                       float(rng.uniform(0, 1)), [int(x) for x in rng.randint(-3, 4, int(rng.randint(1, 6)))]))
    return events


@pytest.mark.parametrize("multiple_pitch_bends", [False, True])
def test_midi_reader_and_synth_copies_match(tmp_path, multiple_pitch_bends):
    events = _midi_events(25, seed=multiple_pitch_bends)
    path = tmp_path / "notes.mid"
    t_export.note_events_to_midi(events, multiple_pitch_bends, midi_tempo=97).write(path)
    a, b = j_midi.read_midi(path), t_midi.read_midi(path)
    assert (a.tempo, a.resolution) == (b.tempo, b.resolution)
    assert len(a.instruments) == len(b.instruments) > 0
    for ia, ib in zip(a.instruments, b.instruments):
        assert ia.program == ib.program
        assert [dataclasses.astuple(n) for n in ia.notes] == [dataclasses.astuple(n) for n in ib.notes]
        assert [dataclasses.astuple(x) for x in ia.pitch_bends] == [dataclasses.astuple(x) for x in ib.pitch_bends]
    n_sounding = sum(int(np.round(127 * e[3])) > 0 for e in events)
    assert sum(len(i.notes) for i in b.instruments) == n_sounding
    # the written bytes read back round-trip through the writer unchanged
    buf = io.BytesIO()
    b.write(buf)
    assert t_midi.read_midi(_write(tmp_path / "again.mid", buf.getvalue())).instruments == b.instruments
    np.testing.assert_array_equal(a.synthesize(8000), b.synthesize(8000))
    np.testing.assert_array_equal(
        j_export.note_events_to_midi(events).synthesize(), t_export.note_events_to_midi(events).synthesize()
    )


def _write(path, data):
    path.write_bytes(data)
    return path


def test_model_output_to_notes_and_sonify_copies_match(tmp_path):
    rng = np.random.RandomState(12)
    output = {
        "note": (rng.rand(300, 88) ** 3).astype(np.float32),
        "onset": (rng.rand(300, 88) ** 5).astype(np.float32),
        "contour": rng.rand(300, 264).astype(np.float32),
    }
    kw = dict(onset_thresh=0.5, frame_thresh=0.3, min_note_len=5, min_freq=80.0, max_freq=3000.0)
    midi_j, events_j = j_export.model_output_to_notes(output, **kw)
    midi_t, events_t = t_export.model_output_to_notes(output, **kw)
    assert events_t == events_j and len(events_t) > 10
    assert t_export.model_output_to_notes(output, include_pitch_bends=False, **kw)[1] == j_export.model_output_to_notes(
        output, include_pitch_bends=False, **kw
    )[1]
    j_export.sonify_midi(midi_j, tmp_path / "j.wav", sr=8000)
    t_export.sonify_midi(midi_t, tmp_path / "t.wav", sr=8000)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()
    gram = rng.rand(88, 40).astype(np.float32)
    y_j, fs_j = j_export.sonify_salience(gram, 1, save_path=str(tmp_path / "sj.wav"))
    y_t, fs_t = t_export.sonify_salience(gram, 1, save_path=str(tmp_path / "st.wav"))
    assert fs_j == fs_t
    np.testing.assert_array_equal(y_j, y_t)
    np.testing.assert_allclose(t_audio.read_wav(tmp_path / "st.wav")[0], j_audio.read_wav(tmp_path / "sj.wav")[0], atol=1 / 32768)


def test_printing_copy_matches(capsys, tmp_path):
    assert t_printing.OUTPUT_EMOJIS == j_printing.OUTPUT_EMOJIS
    outs = []
    for mod in (j_printing, t_printing):
        for kind in ("MIDI", "MODEL_OUTPUT_NPZ", "NOTE_EVENTS", "OTHER_KIND"):
            mod.generating_file_message(kind)
            mod.file_saved_confirmation(kind, tmp_path / "x")
            mod.failed_to_save(kind, tmp_path / "x")
        with mod.no_warnings():
            import logging

            assert logging.getLogger().level == logging.ERROR
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Saved to" in outs[1]


def test_hostmem_copy_matches():
    for name in ("_M_TRIM_THRESHOLD", "_M_MMAP_THRESHOLD", "_M_ARENA_MAX"):
        assert getattr(t_hostmem, name) == getattr(j_hostmem, name)
    first = t_hostmem.tune_host_allocator()
    assert first == j_hostmem.tune_host_allocator()
    assert t_hostmem.tune_host_allocator() == first  # idempotent


def test_codec_constants_match():
    from basic_pitch_torch.ops import pcmcodec as t_codec
    from basic_pitch_tpu.ops import pcmcodec as j_codec

    for name in ("BLOCK", "KSET", "_MIN_BUCKET", "_MERGE_MIN_ROWS", "_ORDERS", "LPC_ORDER", "_LPC_MAX_SHIFT",
                 "_LPC_MARGIN", "_WORDS_SIG_BITS"):
        assert getattr(t_codec, name) == getattr(j_codec, name), name
    for order in (1, 2, 3, 8):
        assert [t_codec.words_per_block(k, order) for k in t_codec.KSET] == [j_codec.words_per_block(k, order) for k in j_codec.KSET]
    for n in list(range(0, 300)) + [1000, 4095, 4097, 123457, 2**20 + 3]:
        assert t_codec._quantize_words(n) == j_codec._quantize_words(n), n
        assert t_codec._bucket(n) == j_codec._bucket(n), n
    assert t_nmp._IM2COL_MAX_PATCH_ELEMS == j_nmp._IM2COL_MAX_PATCH_ELEMS
    assert t_nmp.PRECISIONS == tuple(j_loop._TRAIN_PRECISIONS)


def _code_only(text: str) -> list:
    """C++ source without comments or blank lines, whitespace-normalized."""
    lines = []
    for line in text.splitlines():
        code = line.split("//", 1)[0].strip()
        if code:
            lines.append(" ".join(code.split()))
    return lines


def test_packer_copy_matches():
    """csrc/pcm_pack.cpp holds the packer part of the JAX package's host
    library (from `diff_residual` to the end) with the same code; only the
    comments may differ."""
    j_src = (REPO / "basic_pitch_tpu" / "native" / "bp_native.cpp").read_text()
    t_src = (PORT / "csrc" / "pcm_pack.cpp").read_text()
    start = "static inline int32_t diff_residual"
    j_code = _code_only(j_src[j_src.index(start):])
    t_code = _code_only(t_src[t_src.index(start):])
    assert t_code == j_code
    assert t_code[-1] == '}' and len(t_code) > 200
    j_build = (REPO / "basic_pitch_tpu" / "native" / "__init__.py").read_text()
    assert '["g++", ' + ", ".join(f'"{f}"' for f in t_build.HOST_FLAGS) + ', "-o"' in j_build


CHIP_SCRIPTS = ("chip_smoke.py", "chip_decode_times.py", "chip_serve_times.py", "chip_codec_times.py")
TRAINING_SLICE = ("train/losses.py", "train/loop.py", "train/visualize.py", "data/proto.py", "data/tfrecord.py",
                  "data/serialization.py", "data/loader.py", "cli/train.py")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / name for name in CHIP_SCRIPTS]


SETTINGS_SLICE = ("ops/pcmcodec.py", "ops/transport.py", "models/nmp.py", "pipeline.py")


def test_scans_cover_the_training_slice():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert set(TRAINING_SLICE) <= scanned


def test_scans_cover_the_settings_slice():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert set(SETTINGS_SLICE) <= scanned


FORMATS_SLICE = ("models/savedmodel.py", "models/tflite_import.py", "models/onnx_import.py",
                 "models/coreml_import.py", "models/onnx_export.py", "models/onnx_eval.py", "models/tf_export.py",
                 "cli/export.py", "__init__.py")


def test_scans_cover_the_formats_slice():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert set(FORMATS_SLICE) <= scanned


DATA_SLICE = ("utils/eval.py", "data/annotations.py", "data/fetch.py", "data/commandline.py", "data/pipeline.py",
              "data/datasets/base.py", "data/datasets/guitarset.py", "data/datasets/ikala.py",
              "data/datasets/maestro.py", "data/datasets/medleydb_pitch.py", "data/datasets/slakh.py",
              "cli/download.py", "cli/eval.py", "utils/flops.py", "utils/profiling.py")


def test_scans_cover_the_data_slice():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert set(DATA_SLICE) <= scanned


PARALLEL_SLICE = ("parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py", "parallel/selfcheck.py",
                  "native.py", "device.py")


def test_scans_cover_the_parallel_slice():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert set(PARALLEL_SLICE) <= scanned


def _code(path: pathlib.Path) -> str:
    """A module's code without its docstrings, with the JAX package's name
    read as the port's: equal for a copy, whatever its comments say."""
    tree = ast.parse(path.read_text().replace("basic_pitch_tpu", "basic_pitch_torch"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


# the ETL and evaluation copies; `data/commandline.py` differs only in the
# default destination (``~/data/basic_pitch_torch/<dataset>``), which the
# name swap reads as equal and `test_commandline_parsers_match` pins
EXACT_COPIES = ("utils/eval.py", "data/annotations.py", "data/fetch.py", "data/commandline.py", "data/pipeline.py",
                "data/datasets/__init__.py", "data/datasets/base.py", "data/datasets/guitarset.py",
                "data/datasets/ikala.py", "data/datasets/maestro.py", "data/datasets/medleydb_pitch.py",
                "data/datasets/slakh.py")


@pytest.mark.parametrize("module", EXACT_COPIES)
def test_data_copies_match(module):
    assert _code(PORT / module) == _code(REPO / "basic_pitch_tpu" / module)


def _options(parser) -> list:
    return [(tuple(a.option_strings), a.dest, a.default, a.choices, a.type, a.nargs, a.const, a.help)
            for a in parser._actions]


@pytest.mark.parametrize("dataset", ["guitarset", "ikala", "maestro", "medleydb_pitch", "slakh"])
def test_commandline_parsers_match(dataset):
    """Each builder's flags equal the JAX builder's; the default
    destination differs by the package name only."""
    import importlib

    t_mod = importlib.import_module(f"basic_pitch_torch.data.datasets.{dataset}")
    j_mod = importlib.import_module(f"basic_pitch_tpu.data.datasets.{dataset}")
    t_parser, j_parser = t_mod.build_parser(), j_mod.build_parser()
    t_opts, j_opts = _options(t_parser), _options(j_parser)
    home = pathlib.Path.home()
    assert t_parser.get_default("destination") == str(home / "data" / "basic_pitch_torch" / dataset)
    assert j_parser.get_default("destination") == str(home / "data" / "basic_pitch_tpu" / dataset)
    swap = [tuple(str(x).replace("basic_pitch_tpu", "basic_pitch_torch") if isinstance(x, str) else x for x in o)
            for o in j_opts]
    assert t_opts == swap
    assert t_parser.get_default("validation_percent") == j_parser.get_default("validation_percent")
    assert t_mod.DATASET_NAME == j_mod.DATASET_NAME == dataset


def test_new_cli_parsers_match():
    """``basic-pitch-torch-eval`` has the JAX CLI's options plus
    ``--device``; ``basic-pitch-torch-download`` dispatches the same
    datasets."""
    from basic_pitch_torch.cli import download as t_download
    from basic_pitch_torch.cli import eval as t_eval_cli
    from basic_pitch_tpu.cli import download as j_download
    from basic_pitch_tpu.cli import eval as j_eval_cli

    t_opts = _options(t_eval_cli.build_parser())
    assert [o for o in t_opts if o[0] != ("--device",)] == _options(j_eval_cli.build_parser())
    device = next(o for o in t_opts if o[0] == ("--device",))
    assert device[2] == "cuda" and device[3] == ["cuda", "cpu"]
    assert t_download._dispatch_table().keys() == j_download._dispatch_table().keys()
    assert t_eval_cli.MIDI_SUFFIXES == j_eval_cli.MIDI_SUFFIXES and t_eval_cli.AUDIO_SUFFIXES == j_eval_cli.AUDIO_SUFFIXES


def test_fetch_catalog_matches():
    from basic_pitch_torch.data import fetch as t_fetch
    from basic_pitch_tpu.data import fetch as j_fetch

    assert t_fetch.CATALOG.keys() == j_fetch.CATALOG.keys()
    for name, remotes in t_fetch.CATALOG.items():
        assert [dataclasses.asdict(r) for r in remotes] == [dataclasses.asdict(r) for r in j_fetch.CATALOG[name]], name
        assert [r.is_archive for r in remotes] == [r.is_archive for r in j_fetch.CATALOG[name]]
    assert t_fetch._CHUNK == j_fetch._CHUNK


def test_importing_the_port_loads_no_tensorflow():
    """The package root, `inference` (whose format readers are numpy) and
    the export CLI load no tensorflow; only `models/tf_export.py` does,
    and only the export CLI's SavedModel/TFLite branch imports it."""
    code = (
        "import sys\n"
        "import basic_pitch_torch\n"
        "assert 'torch' not in sys.modules\n"
        "import basic_pitch_torch.inference, basic_pitch_torch.cli.export, basic_pitch_torch.cli.predict\n"
        "from basic_pitch_torch.models import savedmodel, tflite_import, onnx_import, coreml_import, onnx_export, onnx_eval\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('tensorflow', 'jax', 'basic_pitch_tpu'))\n"
        "assert not bad, bad[:5]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    tf_imports = [p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py") if "import tensorflow" in p.read_text()]
    assert tf_imports == ["models/tf_export.py"]


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
    """Every port module imported: no module of the port asks for jax or
    the JAX package, not even inside a try. An import hook records who asks.
    tensorflow (imported by `models/tf_export.py` only) asks for jax itself
    where jax is installed (`tensorflow/lite/python/util.py`, in a try):
    that request is tensorflow's, and the only one allowed."""
    code = (
        "import importlib, pkgutil, sys\n"
        "ROOTS = ('jax', 'jaxlib', 'basic_pitch_tpu')\n"
        "asked = []\n"
        "class Recorder:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ROOTS:\n"
        "            f = sys._getframe(1)\n"
        "            while f is not None and f.f_globals.get('__name__', '').startswith(('importlib', '_frozen_importlib')):\n"
        "                f = f.f_back\n"
        "            who = f.f_globals.get('__name__', '?') if f is not None else '?'\n"
        "            if who.split('.')[0] not in ROOTS:\n"
        "                asked.append((who, name))\n"
        "        return None\n"
        "sys.meta_path.insert(0, Recorder())\n"
        "import basic_pitch_torch\n"
        "for m in pkgutil.walk_packages(basic_pitch_torch.__path__, 'basic_pitch_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [a for a in asked if a[0].split('.')[0] != 'tensorflow']\n"
        "assert not bad, bad\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'basic_pitch_tpu']\n"
        "if 'tensorflow' not in sys.modules:\n"
        "    assert not [k for k in sys.modules if k.split('.')[0] in ROOTS]\n"
        "assert 'basic_pitch_torch.pipeline' in sys.modules\n"
        f"assert all('basic_pitch_torch.' + m[:-3].replace('/', '.').removesuffix('.__init__') in sys.modules for m in {TRAINING_SLICE + SETTINGS_SLICE + DATA_SLICE + PARALLEL_SLICE!r})\n"
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


def test_port_console_scripts_resolve():
    """Every ``basic-pitch-torch*`` script in pyproject names a callable of
    the port, the two of this slice among them."""
    import importlib
    import tomllib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    port = {name: target for name, target in scripts.items() if name.startswith("basic-pitch-torch")}
    assert {"basic-pitch-torch-eval", "basic-pitch-torch-download"} <= set(port)
    for name, target in port.items():
        module, func = target.split(":")
        assert module.startswith("basic_pitch_torch."), name
        assert callable(getattr(importlib.import_module(module), func)), name
