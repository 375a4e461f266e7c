"""The comparisons that decide ``correct``.

Each returns plain numbers; a cell's limits file (`limits/<workload>.json`)
gives each number its limit, and a number above its limit makes the run
not correct. The references are in `reference/`; nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from reference import decode as ref_decode

DECODE_DEFAULTS = {
    "onset_threshold": 0.5,
    "frame_threshold": 0.3,
    "min_note_length": 11,
    "melodia_trick": True,
    "infer_onsets": True,
}


def posteriorgram_gap(program: Dict[str, np.ndarray], reference: Dict[str, np.ndarray]) -> float:
    """Largest absolute difference over the note, onset and contour
    posteriorgrams; a shape mismatch reads as 1 (the whole range)."""
    gap = 0.0
    for key in ("note", "onset", "contour"):
        a, b = program.get(key), reference[key]
        if a is None or a.shape != b.shape:
            return 1.0
        gap = max(gap, float(np.max(np.abs(a.astype(np.float64) - b))) if a.size else 0.0)
    return gap


def reference_events(posteriorgrams: Dict[str, np.ndarray], options: Dict) -> List[tuple]:
    """The frozen reference decoder on posteriorgrams: events (start s, end
    s, MIDI pitch, amplitude, bends), the port's time convention (an end
    past the last frame is the last frame's time)."""
    config = ref_decode.DecodeConfig(
        onset_threshold=options["onset_threshold"],
        frame_threshold=options["frame_threshold"],
        min_note_length=options["min_note_length"],
        infer_onsets=options["infer_onsets"],
        melodia_trick=options["melodia_trick"],
    )
    frames = posteriorgrams["note"].astype(np.float32)
    notes = ref_decode.decode_note_events(frames, posteriorgrams["onset"].astype(np.float32), config)
    with_bends = ref_decode.extract_pitch_bends(posteriorgrams["contour"].astype(np.float32), notes)
    n_frames = frames.shape[0]
    times = ref_decode.model_frames_to_time(n_frames)
    return [
        (float(times[s]), float(times[min(e, n_frames - 1)]), int(p), float(a), [int(v) for v in b])
        for s, e, p, a, b in with_bends
    ]


def _key(event: Sequence) -> Tuple[float, float, int]:
    return (round(float(event[0]), 6), round(float(event[1]), 6), int(event[2]))


def compare_events(program: Iterable[Sequence], reference: Iterable[Sequence]) -> Dict[str, float]:
    """Events matched by (start, end, pitch). Returns the unmatched events
    on both sides (``unmatched``; ``unmatched_share`` of all events of both
    sides), the largest amplitude gap over matched events (``amp_gap``) and
    the matched events' bend values that differ (``bends_differ``)."""
    prog = {}
    for ev in program:
        prog.setdefault(_key(ev), []).append(ev)
    unmatched, matched, amp_gap, bends_differ, total = 0, 0, 0.0, 0, 0
    for ev in reference:
        total += 1
        bucket = prog.get(_key(ev))
        if not bucket:
            unmatched += 1
            continue
        other = bucket.pop()
        matched += 1
        amp_gap = max(amp_gap, abs(float(other[3]) - float(ev[3])))
        a, b = other[4], ev[4]
        if a is None or b is None:
            bends_differ += 0 if a is None and b is None else max(len(a or []), len(b or []))
        else:
            n = min(len(a), len(b))
            bends_differ += int(np.count_nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))) + abs(len(a) - len(b))
    rest = sum(len(v) for v in prog.values())
    unmatched += rest
    total += matched + rest
    return {
        "unmatched": float(unmatched),
        "unmatched_share": unmatched / total if total else 0.0,
        "amp_gap": amp_gap,
        "bends_differ": float(bends_differ),
    }


def norm_gap(program: Dict[str, np.ndarray], reference: Dict[str, np.ndarray], keys: Optional[Iterable[str]] = None) -> float:
    """Worst leaf's gap of norms: | |a| - |b| | over the larger of the
    reference leaf's norm and the median reference leaf's norm."""
    keys = list(reference if keys is None else keys)
    if not keys:
        return 0.0
    norms = {k: float(np.linalg.norm(reference[k])) for k in keys}
    median = float(np.median(list(norms.values())))
    gap = 0.0
    for k in keys:
        a = float(np.linalg.norm(program[k])) if k in program else math.inf
        gap = max(gap, abs(a - norms[k]) / max(norms[k], median, 1e-30))
    return gap


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number without a limit, or a limit without a number, fails."""
    table = {}
    ok = True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        if value is None or limit is None or not value <= limit:
            ok = False
        table[name] = {"value": value, "limit": limit}
    return ok, table
