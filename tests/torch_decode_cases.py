"""Seeded inputs that would break a wrong batched commit of the greedy note
decode, shared by the CPU tests (against the JAX decoders), the card's tests
and `chip_smoke.py` (the CUDA kernel against `decode_plain`)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# what every case decodes with, before its own overrides
DEFAULTS = dict(onset_thresh=0.5, frame_thresh=0.3, min_note_len=5, max_notes=8192, max_melodia_iters=32768)


def _note(frames: np.ndarray, onsets: "np.ndarray | None", pitch: int, start: int, length: int, level: float) -> None:
    frames[start : start + length, pitch] = level
    if onsets is not None:
        onsets[start - 1 : start + 2, pitch] = (0.2, 0.9, 0.2)


def adversarial_cases() -> List[Tuple[str, np.ndarray, np.ndarray, dict]]:
    """(name, frames, onsets, overrides of DEFAULTS) cases: notes walked or
    seeded together whose zeroing meets each other's frames, ties, caps
    reached in the middle of a batch, walks across many table blocks, and
    padding past valid_frames."""
    rng = np.random.RandomState(21)
    cases = []

    # onset notes at one frame on adjacent pitches: f+1 is taken first and
    # zeroes row f under f's walk; pitches 2 apart do not meet
    f, o = np.zeros((400, 88), np.float32), np.zeros((400, 88), np.float32)
    for t0, pitches in ((50, (40, 41, 42, 70, 72)), (200, (60, 61, 15, 16, 17, 18))):
        for p in pitches:
            _note(f, o, p, t0, int(rng.randint(20, 140)), float(rng.uniform(0.5, 0.9)))
    cases.append(("adjacent-onsets-same-frame", f, o, {}))

    # a later onset (taken first) zeroes frames that an earlier note of the
    # same or an adjacent pitch is still walking through
    f, o = np.zeros((500, 88), np.float32), np.zeros((500, 88), np.float32)
    _note(f, o, 30, 100, 250, 0.7)
    _note(f, o, 31, 220, 80, 0.8)
    _note(f, o, 50, 300, 150, 0.6)
    _note(f, o, 50, 380, 40, 0.85)
    _note(f, o, 70, 60, 300, 0.5)
    _note(f, o, 69, 110, 30, 0.9)
    cases.append(("later-onset-cuts-earlier-walk", f, o, {}))

    # melodia only (no onsets): equal peaks in rows 3 apart, at one frame
    # (the smaller row first) and at different frames (the earlier first),
    # and at the edge rows 0 and 87
    f, o = np.zeros((300, 88), np.float32), np.zeros((300, 88), np.float32)
    for p, t_peak in ((20, 120), (23, 120), (26, 110), (29, 120), (0, 150), (3, 150), (87, 150), (84, 140)):
        f[t_peak - 20 : t_peak + 20, p] = 0.6
        f[t_peak, p] = 0.9
    cases.append(("equal-melodia-peaks-3-apart", f, o, {}))

    # a seed's own row keeps a second, higher peak than the next seed of
    # its batch, so that seed is dropped and taken again later
    f, o = np.zeros((400, 88), np.float32), np.zeros((400, 88), np.float32)
    for p, t_peak, peak in ((40, 115, 0.95), (40, 315, 0.9), (50, 215, 0.85), (60, 160, 0.8), (44, 60, 0.82)):
        f[t_peak - 15 : t_peak + 15, p] = 0.6
        f[t_peak, p] = peak
    cases.append(("own-row-outranks-next-seed", f, o, {}))

    # melodia seeds in rows 4 apart, capped after 5 iterations
    f, o = np.zeros((300, 88), np.float32), np.zeros((300, 88), np.float32)
    for i, p in enumerate(range(8, 56, 4)):
        t_peak = 40 + 17 * i
        f[t_peak - 12 : t_peak + 12, p] = 0.5
        f[t_peak, p] = 0.95 - 0.03 * i
    cases.append(("melodia-cap-mid-batch", f, o, dict(max_melodia_iters=5)))

    # 20 onset notes at one frame, 3 pitches apart, with room for 7 notes;
    # then the same with the cap reached among melodia's seeds
    f, o = np.zeros((200, 88), np.float32), np.zeros((200, 88), np.float32)
    for p in range(10, 70, 3):
        _note(f, o, p, 60, 30, 0.8)
    cases.append(("max-notes-mid-onset-batch", f, o, dict(max_notes=7)))
    f, o = np.zeros((300, 88), np.float32), np.zeros((300, 88), np.float32)
    _note(f, o, 80, 5, 15, 1.0)  # sets the inferred onsets' scale: none on the melodia rows
    for p in (5, 40, 75):
        _note(f, o, p, 30, 40, 0.9)
    for i, p in enumerate(range(12, 70, 4)):
        f[150 + 5 * i : 180 + 5 * i, p] = 0.5
        f[165 + 5 * i, p] = 0.9 - 0.02 * i
    cases.append(("max-notes-mid-melodia-batch", f, o, dict(max_notes=6)))

    # walks across many 128-frame steps and table blocks: an onset note of
    # 1280 frames and a melodia note of 1300 frames seeded near its end,
    # both with dips below the threshold shorter than energy_tol. A short
    # note at level 1.0 sets the scale of the inferred onsets, so that the
    # dips, the melodia row's slow ramp and its seed infer none
    for name, T, span in (("long-walks-many-blocks", 1500, 1280), ("walks-across-table-groups", 4600, 4200)):
        f, o = np.zeros((T, 88), np.float32), np.zeros((T, 88), np.float32)
        _note(f, o, 80, 5, 15, 1.0)
        _note(f, o, 30, 20, span, 0.8)
        f[100:110, 60] = np.linspace(0.05, 0.5, 10)
        f[110 : span + 120, 60] = 0.5
        for t in range(150, span + 20, 97):
            f[t : t + 9, 30] = 0.28
            f[t + 40 : t + 48, 60] = 0.28
        f[span + 70, 60] = 0.7
        cases.append((name, f, o, {}))

    # valid_frames far short of the arrays, with loud padding that must be
    # ignored: notes and melodia rows held to the last valid frames (the
    # walks' no-stop tails) and a melodia peak in the last valid block
    f = (rng.rand(2000, 88) * 0.95).astype(np.float32)
    o = (rng.rand(2000, 88) * 0.95).astype(np.float32)
    f[:300], o[:300] = 0.0, 0.0
    _note(f, o, 80, 5, 15, 1.0)
    _note(f, o, 20, 200, 100, 0.8)
    f[150:300, 45] = 0.5
    f[298, 45] = 0.9
    f[260:300, 60] = 0.6
    cases.append(("padding-past-valid-frames", f, o, dict(valid_frames=300)))

    # a negative frame threshold over negative frames: every frame is above
    # it, and the zeroed padding past valid_frames outranks them, so the
    # first melodia seeds lie there; then the cap cuts the loop
    f = np.full((700, 88), -0.01, np.float32)
    f[400:600] = 0.7
    o = np.zeros((700, 88), np.float32)
    cases.append(("negative-threshold-seeds-padding", f, o, dict(valid_frames=250, frame_thresh=-0.05, max_melodia_iters=60)))
    return cases
