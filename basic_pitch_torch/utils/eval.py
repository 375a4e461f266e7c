"""Transcription evaluation: note-event precision/recall/F1.

A copy of `basic_pitch_tpu/utils/eval.py` (the port imports nothing of the
JAX package). Notes match when onsets are within ``onset_tolerance``
seconds and pitches within ``pitch_tolerance`` cents (optionally offsets
within ``offset_ratio`` of the reference duration), under a maximum
bipartite matching (scipy's `linear_sum_assignment`): the criteria of
mir_eval.transcription's precision_recall_f1_overlap.
`tests/test_torch_eval.py` holds it equal to the JAX module.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Note = Tuple[float, float, int]  # (start_s, end_s, midi_pitch)


def _max_bipartite_match(valid: np.ndarray) -> int:
    """Maximum-cardinality matching size of a boolean (n_ref, n_est) matrix."""
    if valid.size == 0 or not valid.any():
        return 0
    from scipy.optimize import linear_sum_assignment

    cost = np.where(valid, -1.0, 0.0)
    rows, cols = linear_sum_assignment(cost)
    return int(valid[rows, cols].sum())


def match_notes(
    reference: Sequence[Note],
    estimated: Sequence[Note],
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: float = None,
    offset_min_tolerance: float = 0.05,
) -> int:
    """Number of matched note pairs under the standard criteria."""
    if not reference or not estimated:
        return 0
    ref = np.asarray([(s, e, p) for s, e, p in reference], np.float64)
    est = np.asarray([(s, e, p) for s, e, p in estimated], np.float64)

    onset_ok = np.abs(ref[:, None, 0] - est[None, :, 0]) <= onset_tolerance
    pitch_ok = np.abs(ref[:, None, 2] - est[None, :, 2]) * 100.0 <= pitch_tolerance
    valid = onset_ok & pitch_ok
    if offset_ratio is not None:
        durations = ref[:, 1] - ref[:, 0]
        tol = np.maximum(offset_ratio * durations, offset_min_tolerance)
        offset_ok = np.abs(ref[:, None, 1] - est[None, :, 1]) <= tol[:, None]
        valid &= offset_ok
    return _max_bipartite_match(valid)


def precision_recall_f1(
    reference: Sequence[Note],
    estimated: Sequence[Note],
    **kwargs: float,
) -> Dict[str, float]:
    """Note-level precision/recall/F1 (onset+pitch criterion by default)."""
    n_match = match_notes(reference, estimated, **kwargs)
    precision = n_match / len(estimated) if estimated else 0.0
    recall = n_match / len(reference) if reference else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "n_reference": len(reference),
        "n_estimated": len(estimated),
        "n_matched": n_match,
    }


def events_to_notes(events: Sequence) -> List[Note]:
    """(start, end, pitch, amplitude, bends) tuples -> (start, end, pitch)."""
    return [(float(e[0]), float(e[1]), int(e[2])) for e in events]
