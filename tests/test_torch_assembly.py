"""PyTorch port, event assembly: `decode/device.notes_to_events` against the
JAX package's `notes_to_events_packed` (and, without bends, its
`notes_to_events`), on the same buffers, then through
`model_frames_to_time`.

The port builds a recording's second-domain events in one vectorised pass;
JAX walks the notes one by one. The events must be equal in order, bends
Python ints, and every time the Python float of `times[i]`, bit for bit.
The cases cover no note and one, the lengths around BEND_INLINE_FRAMES
(notes past it take their bends from the device matrix's pitch column), two
long notes on one column, ends at and past the last frame, the bend range's
extremes, a fetch bucket with garbage past `n_notes`, and a dense
recording's shape. Then the counters of a `transcribe_batch` call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.decode import device as t_device
from basic_pitch_torch.decode import notes as t_notes
from basic_pitch_torch.utils import profiling
from basic_pitch_tpu.decode import device as j_device
from basic_pitch_tpu.decode import notes as j_notes
from torch_port_helpers import one_torch_thread, tone_mix  # noqa: F401

INLINE = t_device.BEND_INLINE_FRAMES
OFFSET = t_notes.MIDI_PITCH_OFFSET


def _notes(lengths, n_frames, rng, pitches=None):
    """(start, end, pitch, amplitude) of notes of the given lengths at random
    starts inside `n_frames`."""
    out = []
    for i, length in enumerate(lengths):
        start = int(rng.randint(0, n_frames - length + 1))
        pitch = int(pitches[i]) if pitches is not None else int(rng.randint(OFFSET, OFFSET + 88))
        out.append((start, start + length, pitch, float(np.float32(rng.uniform(0.05, 1.0)))))
    return out


def _dense(rng):
    """~1 100 notes of mean ~31 frames over a 60 s recording's 5 168 frames."""
    lengths = np.clip(rng.geometric(1 / 31, 1100), 1, INLINE)
    return 5168, _notes(lengths.tolist(), 5168, rng)


CASES = {
    "none": lambda rng: (400, []),
    "one": lambda rng: (400, [(17, 40, 60, 0.5)]),
    "lengths": lambda rng: (1000, _notes([1, 255, 256, 257, 600], 1000, rng, [40, 52, 64, 76, 88])),
    "two_long_one_column": lambda rng: (1400, [(10, 310, 64, 0.25), (20, 60, 64, 0.5), (700, 1300, 64, 0.75), (5, 9, 70, 1.0)]),
    "last_frame": lambda rng: (300, [(250, 300, 50, 0.5), (0, 299, 51, 0.25), (280, 299, 52, 0.125), (0, 300, 53, 1.0)]),
    "bend_extremes": lambda rng: (600, _notes([30, 260, 8, 120], 600, rng)),
    "bucket": lambda rng: (800, _notes([12, 40, 3, 300, 90], 800, rng)),
    "dense": _dense,
}
# the fetch bucket of each case: rows past the note count hold garbage
CAPACITY = {"none": 8, "one": 1, "bucket": 1024, "dense": 2048}


def _buffers(case, seed=0):
    """The host buffers `_collect_many` hands the assembly: torch
    `DecodedNotes` of `capacity` rows, the per-note inline bends, the bend
    matrix, and the same buffers as the JAX package's `DecodedNotes`."""
    rng = np.random.RandomState(seed)
    n_frames, notes = CASES[case](rng)
    n = len(notes)
    cap = CAPACITY.get(case, n + 3)
    if case == "bend_extremes":
        bends_all = rng.choice(np.array([-25, 25], np.int8), size=(n_frames, 88))
    else:
        bends_all = rng.randint(-25, 26, size=(n_frames, 88)).astype(np.int8)
    fields = [rng.randint(-5, 10_000, cap).astype(np.int32) for _ in range(3)]
    amps = rng.uniform(-3, 3, cap).astype(np.float32)
    for i, (s, e, p, a) in enumerate(notes):
        fields[0][i], fields[1][i], fields[2][i], amps[i] = s, e, p, a
    decoded = t_device.DecodedNotes(
        *(torch.from_numpy(f) for f in fields), torch.from_numpy(amps),
        n_notes=torch.tensor(n, dtype=torch.int32), overflow=torch.tensor(False),
    )
    inline = t_device.gather_note_bends(torch.from_numpy(bends_all), decoded).numpy()
    inline[n:] = rng.randint(-128, 128, size=inline[n:].shape)
    j_decoded = j_device.DecodedNotes(
        *(jnp.asarray(f) for f in fields), jnp.asarray(amps),
        n_notes=jnp.asarray(n, jnp.int32), overflow=jnp.asarray(False),
    )
    return n_frames, decoded, inline, bends_all, j_decoded


def _jax_events(frame_events, n_frames):
    times = j_notes.model_frames_to_time(n_frames)
    return [(float(times[s]), float(times[min(e, n_frames - 1)]), p, a, b) for s, e, p, a, b in frame_events]


def _assert_python_types(events, decoded, n_frames):
    times = t_notes.model_frames_to_time(n_frames)
    n = int(decoded.n_notes)
    for (start_s, end_s, _, _, bends), s, e in zip(events, decoded.starts[:n].tolist(), decoded.ends[:n].tolist()):
        assert type(start_s) is float and start_s.hex() == float(times[s]).hex()
        assert type(end_s) is float and end_s.hex() == float(times[min(e, n_frames - 1)]).hex()
        assert bends is None or all(type(b) is int for b in bends)


@pytest.mark.parametrize("case", list(CASES))
def test_events_equal_jax_packed(case):
    n_frames, decoded, inline, bends_all, j_decoded = _buffers(case)
    got = t_device.notes_to_events(
        decoded, t_notes.model_frames_to_time(n_frames), inline, torch.from_numpy(bends_all))
    want = _jax_events(j_device.notes_to_events_packed(j_decoded, inline, jnp.asarray(bends_all)), n_frames)
    assert got == want
    assert len(got) == int(decoded.n_notes)
    assert [len(e[4]) for e in got] == [e - s for s, e in zip(decoded.starts.tolist(), decoded.ends.tolist())][: len(got)]
    _assert_python_types(got, decoded, n_frames)
    if case == "bend_extremes":
        assert {b for e in got for b in e[4]} == {-25, 25}


@pytest.mark.parametrize("case", ["none", "one", "last_frame", "bucket", "dense"])
def test_events_without_bends_equal_jax(case):
    n_frames, decoded, _, _, j_decoded = _buffers(case)
    got = t_device.notes_to_events(decoded, t_notes.model_frames_to_time(n_frames))
    want = _jax_events(j_device.notes_to_events(j_decoded, None), n_frames)
    assert got == want
    assert all(e[4] is None for e in got)
    _assert_python_types(got, decoded, n_frames)


def _held(sr, seconds, seed):
    """A steady C4 from 1.0 s to 5.5 s (~390 frames, longer than
    BEND_INLINE_FRAMES) over a noise floor."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.02 * rng.randn(len(t))
    f0 = 440.0 * 2 ** ((60 - 69) / 12)
    seg = (t >= 1.0) & (t < 5.5)
    y[seg] += 0.3 * (np.sin(2 * np.pi * f0 * t[seg]) + 0.4 * np.sin(4 * np.pi * f0 * t[seg]))
    return y.astype(np.float32)


@pytest.mark.parametrize("include_pitch_bends", [True, False], ids=["bends", "no_bends"])
def test_counters_once_per_recording(monkeypatch, include_pitch_bends):
    """Each recording of a `transcribe_batch` call adds once to each counter:
    its events, their bend frames, and its notes longer than the inline
    buffer."""
    sr = 22050
    recordings = [(tone_mix(sr, 3.0, seed=1), sr), (_held(sr, 7.0, seed=2), sr), (tone_mix(sr, 1.5, seed=3), sr)]
    names = ("transcriber.notes_assembled", "transcriber.bend_frames_assembled", "transcriber.long_note_columns")
    calls = []
    real_count = profiling.count
    monkeypatch.setattr(profiling, "count", lambda name, n=1: (calls.append(name), real_count(name, n)))
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=4, device="cpu", pcm_transport="raw")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        results = tr.transcribe_batch(recordings, include_pitch_bends=include_pitch_bends)
    counters = profiling.summary()["counters"]
    profiling.reset()
    assert tr.host_fallbacks == 0
    events = [e for result in results for e in result]
    long_notes = sum(e[4] is not None and len(e[4]) > INLINE for e in events)
    assert [calls.count(name) for name in names] == [len(recordings)] * 3
    assert counters["transcriber.notes_assembled"] == len(events) > 10
    assert counters["transcriber.bend_frames_assembled"] == sum(len(e[4] or ()) for e in events)
    assert counters["transcriber.long_note_columns"] == long_notes
    assert (long_notes > 0) == include_pitch_bends
