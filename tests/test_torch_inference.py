"""PyTorch port, `inference`: the windowed library path (`run_inference`,
`predict`, `predict_and_save`) and the batched one
(`predict_and_save_streaming`) against the JAX package on the CPU.

Audio is a seeded tone mix over a noise floor, written as WAV files with
the port's `write_wav`. A 1e-6 posteriorgram difference may move one
threshold crossing, so events are held to the rule of
`tests/test_torch_pipeline.py`: the counts differ by at most one, and all
but one event match on pitch with start and end within 50 ms.
"""

import io
import json

import numpy as np
import pytest
import torch

from basic_pitch_torch import inference as t_inference
from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_tpu import constants as j_constants
from basic_pitch_tpu import inference as j_inference
from basic_pitch_tpu import pipeline as j_pipeline
from basic_pitch_tpu.decode import export as j_export
from torch_port_helpers import MIDI_SET, SR, assert_events_agree, one_torch_thread, tone_mix  # noqa: F401

def read_csv_events(path):
    events = []
    for line in path.read_text().splitlines()[1:]:
        cols = line.split(",")
        events.append((float(cols[0]), float(cols[1]), int(cols[2]), int(cols[3])))
    return events


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    mono22 = root / "mix22.wav"
    t_audio.write_wav(mono22, tone_mix(SR), SR)
    stereo44 = root / "mix44.wav"
    # the channels differ by their own noise, and the mixdown keeps a noise
    # floor (two independent floors averaged would halve it, and near-silent
    # CQT bins would carry float32 rounding only)
    left = tone_mix(2 * SR, seed=1)
    right = left + 0.02 * np.random.RandomState(2).randn(len(left)).astype(np.float32)
    t_audio.write_wav(stereo44, np.stack([left, right], axis=1), 2 * SR)
    return {"mono22": mono22, "stereo44": stereo44}


@pytest.fixture(scope="module")
def jax_model():
    return j_inference.Model()


@pytest.fixture(scope="module")
def port_model():
    return t_inference.Model(device="cpu")


@pytest.fixture(scope="module")
def jax_prediction(jax_model, wavs):
    return j_inference.predict(wavs["mono22"], jax_model)


@pytest.fixture(scope="module")
def port_prediction(port_model, wavs):
    return t_inference.predict(wavs["mono22"], port_model)


@pytest.mark.parametrize("name,atol", [("mono22", 1e-4), ("stereo44", 2e-4)])
def test_run_inference_matches_jax(jax_model, port_model, wavs, name, atol):
    """At 44.1 kHz both packages resample on the host: the JAX package with
    its native decimator where built, the port with scipy; the two agree to
    float32 rounding, which the dB normalisation amplifies in quiet bins."""
    ref = j_inference.run_inference(wavs[name], jax_model)
    out = t_inference.run_inference(wavs[name], port_model)
    assert set(out) == set(ref) == {"note", "onset", "contour"}
    for key in ref:
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key], ref[key], atol=atol, rtol=0, err_msg=key)


def test_predict_events_match_jax(jax_prediction, port_prediction):
    _, _, ref = jax_prediction
    _, midi, events = port_prediction
    assert len(ref) > 4
    assert_events_agree(events, ref)
    assert set(MIDI_SET) <= {e[2] for e in events}
    assert sum(len(i.notes) for i in midi.instruments) == sum(
        int(np.round(127 * e[3])) > 0 for e in events
    )


def test_windowing_and_buckets_match_jax():
    hop = j_constants.WINDOW_HOP_SAMPLES
    audio = np.random.RandomState(0).randn(hop * 5 + 1000).astype(np.float32)
    w_t, times_t = t_inference.window_audio_file(audio, hop)
    w_j, times_j = j_inference.window_audio_file(audio, hop)
    np.testing.assert_array_equal(w_t, w_j)
    assert times_t == times_j and w_t.shape == (6, j_constants.AUDIO_N_SAMPLES)
    out = np.random.RandomState(1).rand(6, 172, 88).astype(np.float32)
    for length, n_olap in ((200607, 30), (5000, 30), (200607, 0)):
        np.testing.assert_array_equal(
            t_inference.unwrap_output(out, length, n_olap), j_inference.unwrap_output(out, length, n_olap)
        )
    with pytest.raises(ValueError):
        t_inference.unwrap_output(out[0], 200607, 30)
    for n in (1, 2, 3, 5, 64, 100, 128, 129, 1000):
        assert t_inference._bucket_size(n) == j_inference._bucket_size(n)


def test_model_predict_batches_match_one_call(port_model):
    """Bucket padding and the 128-window split change no window's output."""
    rng = np.random.RandomState(3)
    windows = (0.1 * rng.randn(3, j_constants.AUDIO_N_SAMPLES)).astype(np.float32)
    whole = port_model.predict(windows)
    for i in range(3):
        single = port_model.predict(windows[i])
        for key in whole:
            np.testing.assert_allclose(single[key][0], whole[key][i], atol=1e-6, rtol=0)
    with_channel = port_model.predict(windows[..., None])
    for key in whole:
        np.testing.assert_array_equal(with_channel[key], whole[key])


def test_model_predict_empty_batch(port_model):
    out = port_model.predict(np.zeros((0, j_constants.AUDIO_N_SAMPLES), np.float32))
    assert out["note"].shape == (0, j_constants.ANNOT_N_FRAMES, j_constants.N_FREQ_BINS_NOTES)
    assert out["onset"].shape == (0, j_constants.ANNOT_N_FRAMES, j_constants.N_FREQ_BINS_NOTES)
    assert out["contour"].shape == (0, j_constants.ANNOT_N_FRAMES, j_constants.N_FREQ_BINS_CONTOURS)


def test_model_sources(wavs, port_model):
    """A flat parameter dict and an NMP module load as the checkpoint does;
    the serializations the port cannot read yet are named, not guessed."""
    windows, _, _ = t_inference.get_audio_input(wavs["mono22"], 7680, j_constants.WINDOW_HOP_SAMPLES)
    ref = port_model.predict(windows[:2])
    module = t_nmp.NMP()
    module.load_state_dict(t_params.from_jax_params(t_params.load_flat()))
    for source in (t_params.load_flat(), module):
        out = t_inference.Model(source, device="cpu").predict(windows[:2])
        for key in ref:
            np.testing.assert_array_equal(out[key], ref[key])
    with pytest.raises(ValueError, match="ONNX"):
        t_inference.Model("nmp.onnx", device="cpu")
    with pytest.raises(ValueError, match="TFLite"):
        t_inference.Model("nmp.tflite", device="cpu")
    with pytest.raises(ValueError, match="CoreML"):
        t_inference.Model("nmp.mlpackage", device="cpu")
    with pytest.raises(ValueError, match="cannot load"):
        t_inference.Model(42, device="cpu")


def test_entry_points_need_a_gpu_unless_told_cpu(wavs, port_model, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_inference.Model()
    with pytest.raises(RuntimeError):
        t_inference.predict(wavs["mono22"])
    with pytest.raises(RuntimeError):
        t_inference.predict_and_save_streaming([wavs["mono22"]], tmp_path, True, False, False, False)
    with pytest.raises(RuntimeError):
        t_inference.predict(wavs["mono22"], port_model, device="cuda")
    assert list(tmp_path.iterdir()) == []
    assert t_inference._as_model(port_model, "cpu") is port_model


def test_predict_and_save_writes_jax_bytes(port_model, wavs, tmp_path):
    """All four artifacts; the CSV and the MIDI are byte for byte what the
    JAX package's writers make of the same events."""
    t_inference.predict_and_save([wavs["mono22"]], tmp_path, True, True, True, True, port_model)
    produced = {p.suffix for p in tmp_path.iterdir()}
    assert produced == {".mid", ".npz", ".wav", ".csv"}
    _, _, events = t_inference.predict(wavs["mono22"], port_model)
    j_csv = tmp_path / "jax.csv"
    j_inference.save_note_events(events, j_csv)
    assert (tmp_path / "mix22_basic_pitch.csv").read_bytes() == j_csv.read_bytes()
    buf = io.BytesIO()
    j_export.note_events_to_midi(events).write(buf)
    assert (tmp_path / "mix22_basic_pitch.mid").read_bytes() == buf.getvalue()
    post = np.load(tmp_path / "mix22_basic_pitch.npz", allow_pickle=True)["basic_pitch_model_output"].item()
    assert set(post) == {"note", "onset", "contour"}
    samples, sr = t_audio.read_wav(tmp_path / "mix22_basic_pitch.wav")
    assert sr == 44100 and samples.shape[1] == 1 and np.abs(samples).max() > 0.01


def test_output_collision_refused_and_paths_verified(port_model, wavs, tmp_path):
    t_inference.predict_and_save([wavs["mono22"]], tmp_path, True, False, False, False, port_model)
    with pytest.raises(IOError, match="already exists"):
        t_inference.predict_and_save([wavs["mono22"]], tmp_path, True, False, False, False, port_model)
    with pytest.raises(ValueError, match="does not exist"):
        t_inference.verify_input_path(tmp_path / "missing.wav")
    with pytest.raises(ValueError, match="not a file"):
        t_inference.verify_input_path(tmp_path)
    with pytest.raises(ValueError, match="does not exist"):
        t_inference.verify_output_dir(tmp_path / "missing_dir")
    with pytest.raises(ValueError, match="not a directory"):
        t_inference.verify_output_dir(wavs["mono22"])
    t_inference.verify_output_dir(tmp_path)
    assert t_inference.build_output_path("a/b/x.wav", tmp_path, t_inference.OutputExtensions.NOTE_EVENTS) == (
        tmp_path / "x_basic_pitch.csv"
    )


def test_debug_file(port_model, wavs, port_prediction, tmp_path):
    debug = tmp_path / "debug.json"
    _, _, events = t_inference.predict(wavs["mono22"], port_model, debug_file=debug)
    data = json.loads(debug.read_text())
    assert data["audio_original_length"] == 6 * SR
    assert len(data["audio_windowed"]) == 1 and len(data["audio_windowed"][0]) == j_constants.AUDIO_N_SAMPLES
    assert len(data["unwrapped_output"]["note"]) == port_prediction[0]["note"].shape[0]
    assert [tuple(e[:3]) for e in data["estimated_notes"]] == [tuple(e[:3]) for e in events]
    assert data["min_note_length"] == 11


@pytest.mark.parametrize("name", ["mono22", "stereo44"])
def test_streaming_path_matches_windowed_path(port_model, wavs, tmp_path, name):
    """`predict_and_save_streaming` (transcriber, device decode) against
    `predict_and_save` (windowed model, host decode): the same events by the
    one-flip rule, posteriorgrams within 1e-4. The mono PCM16 file goes up
    as int16, the stereo one through the host's float path."""
    windowed, batched = tmp_path / "windowed", tmp_path / "batched"
    windowed.mkdir()
    batched.mkdir()
    t_inference.predict_and_save([wavs[name]], windowed, True, False, True, True, port_model)
    t_inference.predict_and_save_streaming(
        [wavs[name]], batched, True, False, True, True, port_model, windows_per_chunk=3
    )
    assert {p.suffix for p in batched.iterdir()} == {".mid", ".npz", ".csv"}
    stem = wavs[name].stem
    ref = read_csv_events(windowed / f"{stem}_basic_pitch.csv")
    out = read_csv_events(batched / f"{stem}_basic_pitch.csv")
    assert len(ref) > 4
    assert_events_agree(out, ref)

    def post(d):
        return np.load(d / f"{stem}_basic_pitch.npz", allow_pickle=True)["basic_pitch_model_output"].item()

    a, b = post(windowed), post(batched)
    for key in ("note", "onset", "contour"):
        assert a[key].shape == b[key].shape
        np.testing.assert_allclose(b[key], a[key], atol=1e-4, rtol=0, err_msg=key)


def test_streaming_path_groups_many_files(port_model, wavs, tmp_path):
    """More files than one dispatch group (16): every file gets its
    artifacts, and a repeated recording gives the same events each time."""
    clip = tmp_path / "clip.wav"
    t_audio.write_wav(clip, tone_mix(SR, seconds=1.5), SR)
    files = []
    for i in range(17):
        path = tmp_path / f"copy{i:02d}.wav"
        path.write_bytes(clip.read_bytes())
        files.append(path)
    out = tmp_path / "out"
    out.mkdir()
    t_inference.predict_and_save_streaming(files, out, False, False, False, True, port_model, windows_per_chunk=1)
    csvs = sorted(out.glob("*.csv"))
    assert len(csvs) == 17
    assert len({p.read_bytes() for p in csvs}) == 1
    assert len(read_csv_events(csvs[0])) >= 1


def test_transcribe_batch_of_nothing_is_empty():
    jax_tr = j_pipeline.StreamingTranscriber(windows_per_chunk=2, decode_backend="xla", pcm_transport="raw")
    port_tr = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu")
    assert jax_tr.transcribe_batch([]) == []
    assert port_tr.transcribe_batch([]) == []
    assert port_tr.transcribe_batch([], return_model_outputs=True) == []


def test_predict_and_save_streaming_asks_for_auto_transport(port_model, wavs, tmp_path, monkeypatch):
    """The batched path measures its transport, as the JAX package's does
    (`inference.py:518` there): the transcriber is built with "auto"."""
    seen = []
    real = t_pipeline.StreamingTranscriber

    def spy(*args, **kwargs):
        seen.append(kwargs.get("pcm_transport"))
        return real(*args, **kwargs)

    monkeypatch.setattr(t_pipeline, "StreamingTranscriber", spy)
    t_inference.predict_and_save_streaming([wavs["mono22"]], tmp_path, False, False, False, True, port_model, windows_per_chunk=1)
    assert seen == ["auto"]
    assert len(list(tmp_path.glob("*.csv"))) == 1
