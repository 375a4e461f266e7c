"""PyTorch port, the transcriber end to end against the JAX transcriber.

Both run on the CPU with two windows per chunk, on a seeded polyphonic tone
mix over a noise floor (without the floor, near-silent CQT bins carry only
float32 rounding, which the dB normalisation amplifies past 1e-4 in either
implementation).
"""

import numpy as np
import pytest
import torch

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.decode import device as t_device
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_tpu import pipeline as j_pipeline
from basic_pitch_tpu.utils import audio as j_audio

SR = 22050
MIDI_SET = (45, 52, 57, 60, 64, 67, 71, 76)


def tone_mix(sr: int, seconds: float = 6.0, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.02 * rng.randn(len(t))
    for i, midi in enumerate(MIDI_SET):
        start = 0.25 + 0.6 * i
        f0 = 440.0 * 2 ** ((midi - 69) / 12)
        seg = (t >= start) & (t < start + 1.5)
        tt = t[seg] - start
        y[seg] += 0.25 * np.exp(-1.2 * tt) * (np.sin(2 * np.pi * f0 * tt) + 0.4 * np.sin(4 * np.pi * f0 * tt))
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def jax_tr():
    return j_pipeline.StreamingTranscriber(windows_per_chunk=2, decode_backend="xla", pcm_transport="raw")


@pytest.fixture(scope="module")
def port_tr():
    return t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu")


@pytest.fixture(scope="module")
def audio22():
    return tone_mix(SR)


@pytest.fixture(scope="module")
def jax_events(jax_tr, audio22):
    return jax_tr.transcribe(audio22, SR)


@pytest.mark.parametrize(
    "rate,dtype,atol",
    [
        (SR, "float32", 1e-4),
        # at 44.1 kHz the 257-tap decimation matmul adds its own float32
        # rounding ahead of the CQT, in a different summation order in each
        # implementation; the dB normalisation amplifies it in quiet bins
        (2 * SR, "float32", 2e-4),
        (2 * SR, "int16", 2e-4),
    ],
)
def test_posteriorgrams_match_jax(jax_tr, port_tr, rate, dtype, atol):
    y = tone_mix(rate)
    if dtype == "int16":
        y = np.round(y * 32767).astype(np.int16)
    ref = jax_tr.posteriorgrams(y, rate)
    out = port_tr.posteriorgrams(y, rate)
    for key in ("note", "onset", "contour"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key], ref[key], atol=atol, rtol=0, err_msg=key)


def test_int16_scaled_on_device_equals_float(port_tr):
    pcm = np.round(tone_mix(SR, seconds=3.0) * 32767).astype(np.int16)
    a = port_tr.posteriorgrams(pcm, SR)
    b = port_tr.posteriorgrams(pcm.astype(np.float32) / 32768.0, SR)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_jax_posteriorgrams_decode_to_jax_events(jax_tr, port_tr, audio22, jax_events):
    """The same posteriorgrams through the port's decode give JAX's events:
    times, pitches and bends equal, amplitudes within the decoder's 2e-6
    (their sums run in another order)."""
    post = jax_tr.posteriorgrams(audio22, SR)
    _, _, n_chunks, n_frames = port_tr._geometry(audio22, SR)
    rows = n_chunks * port_tr.w * t_pipeline.FRAMES_PER_WINDOW

    def padded(x):
        return torch.from_numpy(np.pad(x, ((0, rows - x.shape[0]), (0, 0))))

    out = {k: padded(post[k]) for k in ("note", "onset", "contour")}
    out["bends"] = t_device.bend_matrix(out["contour"])
    ticket = port_tr._decode_dispatch(out, n_frames, n_chunks, t_pipeline.DecodeOptions(), 16384)
    events = port_tr._collect_many([ticket])[0]
    assert len(events) == len(jax_events) > 4
    for a, b in zip(events, jax_events):
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2] and a[4] == b[4]
        assert abs(a[3] - b[3]) <= 2e-6


def test_events_match_jax(port_tr, audio22, jax_events):
    """The rule of tests/test_pipeline.py: a 1e-6 posteriorgram difference
    may move one threshold crossing."""
    events = port_tr.transcribe(audio22, SR)
    assert abs(len(events) - len(jax_events)) <= 1
    matched = sum(
        a[2] == b[2] and abs(a[0] - b[0]) < 0.05 and abs(a[1] - b[1]) < 0.05
        for a, b in zip(sorted(events), sorted(jax_events))
    )
    assert matched >= len(jax_events) - 1
    assert set(MIDI_SET) <= {e[2] for e in events}


def test_clean_tone_comes_back_at_its_pitch():
    sr = SR
    t = np.arange(int(3.0 * sr)) / sr
    f0 = 440.0 * 2 ** ((60 - 69) / 12)
    y = np.zeros_like(t, dtype=np.float32)
    seg = slice(int(0.5 * sr), int(2.0 * sr))
    tt = t[seg] - 0.5
    y[seg] = (0.4 * np.exp(-1.5 * tt) * (
        np.sin(2 * np.pi * f0 * tt) + 0.5 * np.sin(4 * np.pi * f0 * tt) + 0.25 * np.sin(6 * np.pi * f0 * tt)
    )).astype(np.float32)
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu")
    events = tr.transcribe(y, sr)
    assert len(events) >= 1
    best = max(events, key=lambda e: e[1] - e[0])
    assert best[2] == 60
    assert abs(best[0] - 0.5) < 0.15


def test_rejects_48k(port_tr):
    with pytest.raises(ValueError, match="22050 or 44100"):
        port_tr.posteriorgrams(np.zeros(1000, np.float32), 48000)
    with pytest.raises(ValueError):
        port_tr.transcribe(np.zeros(1000, np.float32), 48000)


def test_transcribe_batch_returns_model_outputs(port_tr, audio22):
    short = audio22[: 3 * SR]
    results = port_tr.transcribe_batch([(audio22, SR), (short, SR)], return_model_outputs=True)
    assert len(results) == 2
    for (events, outputs), y in zip(results, (audio22, short)):
        post = port_tr.posteriorgrams(y, SR)
        for key in ("note", "onset", "contour"):
            np.testing.assert_array_equal(outputs[key], post[key])
        assert events == port_tr.transcribe(y, SR)
    assert port_tr.host_fallbacks == 0


def test_overflow_falls_back_to_host_decoder(port_tr, audio22):
    """A ticket whose device decode reports overflow is decoded on the host
    from the posteriorgrams, and gives the same events."""
    expected = port_tr.transcribe(audio22, SR)
    _, _, n_chunks, n_frames = port_tr._geometry(audio22, SR)
    out, _, _ = port_tr._forward(audio22, SR)
    before = port_tr.host_fallbacks
    ticket = port_tr._decode_dispatch(out, n_frames, n_chunks, t_pipeline.DecodeOptions(), 16384)
    ticket["decoded_dev"] = ticket["decoded_dev"]._replace(overflow=torch.tensor(True))
    events = port_tr._collect_many([ticket])[0]
    assert port_tr.host_fallbacks == before + 1
    assert len(events) == len(expected)
    for a, b in zip(events, expected):
        assert a[2] == b[2] and abs(a[0] - b[0]) < 1e-9 and abs(a[1] - b[1]) < 1e-9


def test_transcribe_file(port_tr, tmp_path):
    y = tone_mix(2 * SR, seconds=3.0)
    path = tmp_path / "mix.wav"
    j_audio.write_wav(path, y, 2 * SR)
    samples, sr = t_audio.read_wav(path)
    direct = port_tr.posteriorgrams(t_audio.to_mono(samples), sr)
    via_file = port_tr.transcribe_file(path)
    for key in direct:
        np.testing.assert_array_equal(via_file[key], direct[key])
    with port_tr:
        pass  # the context manager closes idempotently
