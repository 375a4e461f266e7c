"""Annotation rasterization: note/f0 events -> sparse time-frequency grids.

A copy of `basic_pitch_tpu/data/annotations.py`: note intervals and pitch
tracks are mapped onto the training time grid (ANNOTATION_HOP seconds per
frame) and the log-spaced frequency-bin grids (FREQ_BINS_NOTES /
FREQ_BINS_CONTOURS), yielding the sparse (frame, bin) indices + values
stored in training examples, as the reference builders' mirdata
`to_sparse_index` calls do. `tests/test_torch_params.py` pins it equal.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from basic_pitch_torch import constants

SparseIndices = List[Tuple[int, int]]


def time_grid_for_duration(duration_s: float) -> np.ndarray:
    """The training time grid: arange(0, duration + hop, hop) — the same
    convention as the reference builders (`guitarset.py:96`)."""
    return np.arange(0, duration_s + constants.ANNOTATION_HOP, constants.ANNOTATION_HOP)


def hz_to_bin(freqs_hz: np.ndarray, freq_grid: np.ndarray) -> np.ndarray:
    """Nearest log-frequency bin per frequency; -1 when outside the grid
    (more than half a bin beyond either end)."""
    freqs_hz = np.asarray(freqs_hz, np.float64)
    log_grid = np.log2(freq_grid)
    step = log_grid[1] - log_grid[0]
    with np.errstate(divide="ignore"):
        log_f = np.log2(np.maximum(freqs_hz, 1e-12))
    idx = np.round((log_f - log_grid[0]) / step).astype(np.int64)
    valid = (log_f >= log_grid[0] - step / 2) & (log_f <= log_grid[-1] + step / 2)
    return np.where(valid, np.clip(idx, 0, len(freq_grid) - 1), -1)


def notes_to_sparse(
    intervals_s: np.ndarray,  # (n, 2) start/end seconds
    pitches_hz: np.ndarray,  # (n,)
    time_grid: np.ndarray,
    freq_grid: np.ndarray,
    amplitudes: Optional[np.ndarray] = None,
    onsets_only: bool = False,
) -> Tuple[SparseIndices, List[float]]:
    """Rasterize note events onto (time frame, frequency bin) cells.

    A note covers every grid frame with start <= t < end (onsets_only keeps
    just the first frame). Values are the note amplitudes (1.0 by default).
    """
    indices: SparseIndices = []
    values: List[float] = []
    if len(intervals_s) == 0:
        return indices, values
    bins = hz_to_bin(np.asarray(pitches_hz), freq_grid)
    amps = np.ones(len(bins)) if amplitudes is None else np.asarray(amplitudes, np.float64)
    n_frames = len(time_grid)
    hop = constants.ANNOTATION_HOP
    for (start, end), freq_bin, amp in zip(np.asarray(intervals_s), bins, amps):
        if freq_bin < 0:
            continue
        first = int(np.ceil(round(start / hop, 9)))
        if onsets_only:
            frames = [first] if 0 <= first < n_frames else []
        else:
            last = int(np.ceil(round(end / hop, 9)))  # exclusive
            frames = range(max(first, 0), min(last, n_frames))
        for frame in frames:
            indices.append((frame, int(freq_bin)))
            values.append(float(amp))
    return indices, values


def f0_to_sparse(
    times_s: np.ndarray,
    freqs_hz: np.ndarray,
    time_grid: np.ndarray,
    freq_grid: np.ndarray,
    confidences: Optional[np.ndarray] = None,
) -> Tuple[SparseIndices, List[float]]:
    """Rasterize a frame-level pitch track: each sample lands on its nearest
    grid frame; unvoiced samples (freq <= 0) are dropped."""
    indices: SparseIndices = []
    values: List[float] = []
    times_s = np.asarray(times_s, np.float64)
    freqs_hz = np.asarray(freqs_hz, np.float64)
    if times_s.size == 0:
        return indices, values
    conf = np.ones_like(freqs_hz) if confidences is None else np.asarray(confidences, np.float64)
    voiced = freqs_hz > 0
    bins = hz_to_bin(freqs_hz[voiced], freq_grid)
    frames = np.round(times_s[voiced] / constants.ANNOTATION_HOP).astype(np.int64)
    n_frames = len(time_grid)
    seen = set()
    for frame, freq_bin, c in zip(frames, bins, conf[voiced]):
        if freq_bin < 0 or not (0 <= frame < n_frames):
            continue
        key = (int(frame), int(freq_bin))
        if key in seen:
            continue
        seen.add(key)
        indices.append(key)
        values.append(float(c))
    return indices, values
