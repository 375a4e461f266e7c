"""Seeded audio, the event-agreement rule and the thread setting shared by
the port's serving-surface tests (`tests/test_torch_{inference,streaming,
serve,cli}.py`). Not a test module: pytest collects nothing here.

Import the autouse fixture by name into a test module to apply it there:

    from torch_port_helpers import one_torch_thread  # noqa: F401
"""

import numpy as np
import pytest
import torch

SR = 22050
MIDI_SET = (45, 52, 57, 60, 64, 67, 71, 76)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The test workers share the machine's cores: one intra-op thread each
    keeps the plain decoder's many small ops from waiting on oversubscribed
    thread pools."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tone_mix(sr: int = SR, seconds: float = 6.0, seed: int = 0) -> np.ndarray:
    """The eight tones of MIDI_SET, 0.6 s apart and 1.5 s long, over a
    seeded noise floor (without one, near-silent CQT bins carry only float32
    rounding, which the dB normalisation amplifies past 1e-4)."""
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


def melody(midis, note_s: float = 0.45, gap_s: float = 0.40, lead_s: float = 0.5, tail_s: float = 1.0) -> np.ndarray:
    """A well-separated monophonic melody at SR, the material where
    streaming and offline decodes must agree exactly."""

    def tone(f0: float) -> np.ndarray:
        t = np.arange(int(note_s * SR)) / SR
        env = np.minimum(1.0, t / 0.02) * np.exp(-1.5 * t)
        y = sum(w * np.sin(2 * np.pi * f0 * h * t) for h, w in ((1, 1.0), (2, 0.5), (3, 0.25)))
        return (0.35 * env * y).astype(np.float32)

    parts = [np.zeros(int(lead_s * SR), np.float32)]
    for m in midis:
        parts.append(tone(440.0 * 2 ** ((m - 69) / 12)))
        parts.append(np.zeros(int(gap_s * SR), np.float32))
    parts.append(np.zeros(int(tail_s * SR), np.float32))
    return np.concatenate(parts)


def to_pcm16(audio: np.ndarray) -> np.ndarray:
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)


def assert_events_agree(events, ref, tol_s: float = 0.05) -> None:
    """The one-flip rule: a 1e-6 posteriorgram difference may move one
    threshold crossing, so the counts differ by at most one, and all but one
    reference event has a distinct counterpart of the same pitch with start
    and end within tol_s."""
    assert abs(len(events) - len(ref)) <= 1, (len(events), len(ref))
    free = list(events)
    matched = 0
    for s, e, p, *_ in ref:
        hit = next((x for x in free if x[2] == p and abs(x[0] - s) < tol_s and abs(x[1] - e) < tol_s), None)
        if hit is not None:
            free.remove(hit)
            matched += 1
    assert matched >= len(ref) - 1, (matched, len(ref))
