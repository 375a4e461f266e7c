"""PyTorch port, window packing: the recordings of one `transcribe_batch`
call share W-window model chunks, on one device and over a device list.

On the CPU at W = 4: a call of four recordings (2, 4 = W, 6 and 5 needed
windows; 22.05 kHz float32 and 44.1 kHz int16; the last holds a note longer
than `BEND_INLINE_FRAMES`) gives, for each recording, the events and the
posteriorgrams of its own `transcribe` and `posteriorgrams` calls, and of
its own call over two devices at rows of W windows, bit for bit; so does
the same call over two devices, whose steps of two rows hold windows of
several recordings. The model is window-local, so a window's outputs do
not depend on its neighbours in the batch. Then the counters:
``transcriber.windows_run`` is the call's needed windows rounded up to
whole chunks, and one recording runs as many as before;
``transcriber.chunks_shared`` counts the chunks that hold windows of more
than one recording. A device list of one packs as one device does, and so
does a list of two.
"""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.decode import device as t_device
from basic_pitch_torch.utils import profiling
from torch_port_helpers import one_torch_thread, to_pcm16, tone_mix  # noqa: F401

SR = 22050
W = 4


def _sustained(sr: int, seconds: float, seed: int) -> np.ndarray:
    """A steady C4 from 1.0 s to 5.5 s (~390 frames) over a noise floor."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.02 * rng.randn(len(t))
    f0 = 440.0 * 2 ** ((60 - 69) / 12)
    seg = (t >= 1.0) & (t < 5.5)
    y[seg] += 0.3 * (np.sin(2 * np.pi * f0 * t[seg]) + 0.4 * np.sin(4 * np.pi * f0 * t[seg]))
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def recordings():
    recs = [
        (tone_mix(SR, 2.5, seed=1), SR),  # 2 windows, fewer than W
        (to_pcm16(tone_mix(2 * SR, 5.5, seed=2)), 2 * SR),  # W windows
        (tone_mix(SR, 9.0, seed=3), SR),  # 6 windows: more than W
        (to_pcm16(_sustained(2 * SR, 7.0, seed=4)), 2 * SR),  # 5 windows, one long note
    ]
    assert [t_pipeline._needed_windows(len(a), sr != SR) for a, sr in recs] == [2, W, 6, 5]
    return recs


@pytest.fixture(scope="module")
def own(recordings):
    """Each recording's own calls, on one device and over two devices (rows
    of W windows, the batch of a one-device call)."""
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=W, device="cpu", pcm_transport="raw")
    whole = t_pipeline.StreamingTranscriber(windows_per_chunk=2 * W, devices=["cpu"] * 2, pcm_transport="raw")
    out = []
    for audio, sr in recordings:
        out.append({
            "events": tr.transcribe(audio, sr),
            "post": tr.posteriorgrams(audio, sr),
            "whole": whole.transcribe_batch([(audio, sr)], return_model_outputs=True)[0],
        })
    assert any(len(e[4]) > t_device.BEND_INLINE_FRAMES for e in out[3]["events"])
    return out


@pytest.mark.parametrize("return_model_outputs", [False, True], ids=["events", "outputs"])
@pytest.mark.parametrize(
    "compute_group,devices", [(1, None), (2, None), (1, ["cpu"] * 2)], ids=["1", "2", "two-devices"])
def test_packed_batch_equals_each_recording_alone(recordings, own, compute_group, devices, return_model_outputs):
    """17 windows in chunks of 4: at k = 1 the 6- and 5-window recordings
    span two and three model calls; at k = 2 they span two (8 + 8, then 1
    padded to a chunk at the flush). Over two devices at W = 8 a step is two
    rows of 4 on the grid of the one device's chunks (8 + 8, then 1 in
    row 0 and zeros in row 1); the 44.1 kHz recordings start at windows 2
    and 12, so the first one's pieces start inside its 4-window slices."""
    tr = t_pipeline.StreamingTranscriber(
        windows_per_chunk=W if devices is None else 2 * W, device=None if devices else "cpu", devices=devices,
        pcm_transport="raw", compute_group=compute_group)
    got = tr.transcribe_batch(recordings, return_model_outputs=return_model_outputs)
    assert len(got) == len(recordings)
    for result, ref in zip(got, own):
        events = result[0] if return_model_outputs else result
        assert events == ref["events"] == ref["whole"][0]
        if return_model_outputs:
            for key in ("note", "onset", "contour"):
                np.testing.assert_array_equal(result[1][key], ref["post"][key], err_msg=key)
                np.testing.assert_array_equal(result[1][key], ref["whole"][1][key], err_msg=key)
    assert tr.host_fallbacks == 0


def _shared_chunks(needed, w):
    owners = [i for i, n in enumerate(needed) for _ in range(n)]
    return sum(len(set(owners[c : c + w])) > 1 for c in range(0, len(owners), w))


@pytest.mark.parametrize(
    "seconds,compute_group,devices",
    [
        ((1.0, 2.5, 4.0), 2, None),  # 1 + 2 + 3 windows: 4, then 2 at the flush
        ((1.0, 2.5, 4.0), 1, None),
        ((4.0, 1.0), 2, None),  # the call of tests/test_torch_profiling.py's span tree
        ((4.0,), 2, None),  # one recording: 3 windows run as 2 chunks, as before packing
        ((1.0,), 1, None),
        ((1.0, 2.5, 4.0), 1, ["cpu"]),  # a device list of one packs too
        ((1.0, 2.5, 4.0), 2, ["cpu"] * 2),  # and so does a list of two, in steps of one W-window chunk
    ],
)
def test_packed_counters(seconds, compute_group, devices):
    w = 2
    tr = t_pipeline.StreamingTranscriber(
        windows_per_chunk=w, device=None if devices else "cpu", devices=devices, pcm_transport="raw",
        compute_group=compute_group)
    recs = [(tone_mix(SR, s, seed=i), SR) for i, s in enumerate(seconds)]
    needed = [t_pipeline._needed_windows(len(a), False) for a, _ in recs]
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.transcribe_batch(recs)
    counters = profiling.summary()["counters"]
    profiling.reset()
    total = sum(needed)
    assert counters["transcriber.windows_needed"] == total
    assert counters["transcriber.windows_run"] == -(-total // w) * w
    if len(recs) == 1:  # the windows the transcriber ran per recording before packing
        assert counters["transcriber.windows_run"] == tr._geometry(*recs[0])[2] * w
    assert counters["transcriber.chunks_shared"] == _shared_chunks(needed, w)
    if len(recs) > 1:
        assert counters["transcriber.chunks_shared"] > 0
