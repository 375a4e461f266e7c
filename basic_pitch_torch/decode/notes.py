"""Posteriorgram -> note-event decoding.

Converts the model's frame-level note/onset/contour activations into discrete
note events with amplitudes and optional pitch bends. Algorithm semantics
are those of `basic_pitch_tpu/decode/notes.py`, of which this is a copy:

  * optional onset inference from positive frame-energy differences,
  * strict-local-max onset peak picking over time,
  * per-onset backward-in-time greedy tracking with an energy-tolerance gap
    counter, zeroing claimed energy (+/- one semitone) as it goes,
  * the "melodia trick": iterative global-argmax region growing over the
    residual energy (forward + backward passes),
  * per-note pitch-bend estimation by gaussian-weighted argmax over contour
    bins around the note's pitch.

This module is the host (numpy) implementation: the transcriber's overflow
fallback, and the behavioural oracle for `basic_pitch_torch.decode.device`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from basic_pitch_torch import constants

MIDI_PITCH_OFFSET = 21  # MIDI number of A0, the lowest decoded pitch
MAX_FREQ_IDX = 87
DEFAULT_ENERGY_TOLERANCE = 11  # frames of sub-threshold energy ending a note
MAGIC_ALIGNMENT_OFFSET = 0.0018  # seconds; empirical model/annotation shift
N_PITCH_BEND_TICKS = 8192
PITCH_BEND_TICKS_PER_CONTOUR_BIN = 4096 / constants.CONTOURS_BINS_PER_SEMITONE

# (start_frame, end_frame, midi_pitch, amplitude)
FrameNote = Tuple[int, int, int, float]
# (start, end, midi_pitch, amplitude, pitch_bends or None)
NoteEvent = Tuple[float, float, int, float, Optional[List[int]]]


def hz_to_midi(freq_hz: float) -> float:
    return 69.0 + 12.0 * np.log2(freq_hz / 440.0)


def midi_to_hz(pitch_midi: float) -> float:
    return 440.0 * 2.0 ** ((pitch_midi - 69.0) / 12.0)


def midi_pitch_to_contour_bin(pitch_midi: int) -> float:
    """Fractional contour-bin index of a MIDI pitch (3 bins/semitone grid
    anchored at A0) — `note_creation.py:168-179`."""
    pitch_hz = midi_to_hz(pitch_midi)
    return (
        12.0
        * constants.CONTOURS_BINS_PER_SEMITONE
        * np.log2(pitch_hz / constants.ANNOTATIONS_BASE_FREQUENCY)
    )


def constrain_frequency(
    onsets: np.ndarray,
    frames: np.ndarray,
    max_freq: Optional[float],
    min_freq: Optional[float],
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero activations outside [min_freq, max_freq] (`note_creation.py:314`)."""
    onsets = onsets.copy()
    frames = frames.copy()
    if min_freq is not None:
        min_idx = int(np.round(hz_to_midi(min_freq) - MIDI_PITCH_OFFSET))
        onsets[:, :min_idx] = 0
        frames[:, :min_idx] = 0
    if max_freq is not None:
        max_idx = int(np.round(hz_to_midi(max_freq) - MIDI_PITCH_OFFSET))
        onsets[:, max_idx:] = 0
        frames[:, max_idx:] = 0
    return onsets, frames


def infer_onsets_from_frames(
    onsets: np.ndarray, frames: np.ndarray, n_diff: int = 2
) -> np.ndarray:
    """Merge predicted onsets with rescaled positive frame-energy jumps.

    For each lag n in 1..n_diff, computes frames[t] - frames[t-n] (zero-padded
    history), takes the minimum over lags, clips negatives, zeroes the first
    n_diff frames, rescales to the max of the predicted onsets, and returns
    the elementwise max with them (`note_creation.py:289-311`).
    """
    diffs = []
    for lag in range(1, n_diff + 1):
        padded = np.concatenate([np.zeros((lag, frames.shape[1])), frames])
        diffs.append(padded[lag:] - padded[:-lag])
    frame_diff = np.min(diffs, axis=0)
    frame_diff[frame_diff < 0] = 0
    frame_diff[:n_diff] = 0
    peak = np.max(frame_diff)
    if peak > 0:
        frame_diff = np.max(onsets) * frame_diff / peak
    return np.maximum(onsets, frame_diff)


def local_maxima_along_time(x: np.ndarray) -> np.ndarray:
    """Boolean mask of strict local maxima along axis 0 (edges excluded) —
    the scipy.signal.argrelmax(axis=0) criterion used at
    `note_creation.py:398-400`."""
    mask = np.zeros_like(x, dtype=bool)
    if x.shape[0] >= 3:
        interior = (x[1:-1] > x[:-2]) & (x[1:-1] > x[2:])
        mask[1:-1] = interior
    return mask


@dataclasses.dataclass
class DecodeConfig:
    onset_threshold: float = 0.5
    frame_threshold: float = 0.3
    min_note_length: int = 11  # frames
    infer_onsets: bool = True
    min_freq: Optional[float] = None
    max_freq: Optional[float] = None
    melodia_trick: bool = True
    energy_tolerance: int = DEFAULT_ENERGY_TOLERANCE


def _forward_scan(col: np.ndarray, start: int, thresh: float, tol: int):
    """Bookkeeping of the greedy forward walk from `start`+1, vectorized.

    The walk counts consecutive sub-threshold frames and stops after `tol`
    of them (or at n_frames-1). Equivalently: with last_above[t] the latest
    position <= t that is above threshold (or <= start), the gap counter at
    t is t - last_above[t], and the walk stops at the first t where it
    reaches `tol`.

    Returns (end, i_final): exclusive end of above-threshold frames, and the
    exclusive end of visited frames (melodia zeroes everything visited).
    """
    n_frames = col.shape[0]
    pos = np.arange(n_frames)
    above = (col >= thresh) | (pos <= start)
    last_above = np.maximum.accumulate(np.where(above, pos, -1))
    consec = pos - last_above
    lo, hi = start + 1, n_frames - 1  # visited range is [lo, hi)
    hit = np.flatnonzero(consec[lo:hi] >= tol)
    if hit.size:
        i_final = lo + hit[0] + 1
        gap = tol
    else:
        i_final = max(lo, n_frames - 1)
        gap = consec[n_frames - 2] if n_frames - 2 >= lo else 0
    return i_final - gap, i_final


def _backward_scan(col: np.ndarray, start: int, thresh: float, tol: int):
    """Mirror-image of `_forward_scan` for the melodia backward walk from
    `start`-1 down to 1. Returns (note_start, i_final) where frames
    (i_final, start) were visited."""
    n_frames = col.shape[0]
    pos = np.arange(n_frames)
    above = (col >= thresh) | (pos >= start)
    next_above = np.minimum.accumulate(np.where(above, pos, n_frames + 1)[::-1])[::-1]
    consec = next_above - pos
    in_range = np.flatnonzero((consec >= tol) & (pos <= start - 1) & (pos >= 1))
    if in_range.size:
        i_final = in_range[-1] - 1
        gap = tol
    else:
        i_final = min(start - 1, 0)
        gap = consec[1] if start - 1 >= 1 else 0
    return i_final + 1 + gap, i_final


def decode_note_events(
    frames: np.ndarray,
    onsets: np.ndarray,
    config: DecodeConfig,
) -> List[FrameNote]:
    """Greedy polyphonic note tracking (`output_to_notes_polyphonic`,
    `note_creation.py:360-509`).

    Args:
        frames: (n_times, 88) note-frame activations.
        onsets: (n_times, 88) onset activations.

    Returns:
        Frame-domain note tuples (start, end, midi_pitch, amplitude), in the
        same order the reference emits them (onsets processed backward in
        time, then melodia notes by descending residual energy).
    """
    n_frames = frames.shape[0]
    onsets, frames = constrain_frequency(onsets, frames, config.max_freq, config.min_freq)
    if config.infer_onsets:
        onsets = infer_onsets_from_frames(onsets, frames)

    # peak-valued matrix thresholded with >=, matching the reference exactly
    # (note the quirk: threshold 0 admits every cell, peaks or not,
    # `note_creation.py:396-404`)
    peak_values = np.where(local_maxima_along_time(onsets), onsets, 0.0)
    onset_times, onset_freqs = np.nonzero(peak_values >= config.onset_threshold)

    remaining = frames.copy()
    notes: List[FrameNote] = []

    # process onsets backward in time so later notes claim energy first
    for start, freq in zip(onset_times[::-1], onset_freqs[::-1]):
        if start >= n_frames - 1:
            continue
        end, _ = _forward_scan(
            remaining[:, freq], start, config.frame_threshold, config.energy_tolerance
        )
        if end - start <= config.min_note_length:
            continue
        lo_f, hi_f = max(freq - 1, 0), min(freq + 1, MAX_FREQ_IDX)
        remaining[start:end, lo_f : hi_f + 1] = 0
        notes.append((int(start), int(end), int(freq) + MIDI_PITCH_OFFSET, float(np.mean(frames[start:end, freq]))))

    if config.melodia_trick:
        while remaining.max() > config.frame_threshold:
            mid, freq = np.unravel_index(remaining.argmax(), remaining.shape)
            remaining[mid, freq] = 0
            col = remaining[:, freq]

            fwd_end, fwd_final = _forward_scan(
                col, mid, config.frame_threshold, config.energy_tolerance
            )
            end = fwd_end - 1
            start, bwd_final = _backward_scan(
                col, mid, config.frame_threshold, config.energy_tolerance
            )

            # zero everything the walks visited, +/- one semitone
            lo_f, hi_f = max(freq - 1, 0), min(freq + 1, MAX_FREQ_IDX)
            remaining[bwd_final + 1 : mid, lo_f : hi_f + 1] = 0
            remaining[mid + 1 : fwd_final, lo_f : hi_f + 1] = 0

            if end - start <= config.min_note_length:
                continue
            notes.append(
                (int(start), int(end), int(freq) + MIDI_PITCH_OFFSET, float(np.mean(frames[start:end, freq])))
            )

    return notes


def extract_pitch_bends(
    contours: np.ndarray,
    notes: List[FrameNote],
    n_bins_tolerance: int = 25,
) -> List[Tuple[int, int, int, float, Optional[List[int]]]]:
    """Per-note pitch bends: gaussian-weighted argmax over nearby contour
    bins per frame, in 1/3-semitone units (`note_creation.py:182-220`)."""
    window = 2 * n_bins_tolerance + 1
    sigma = 5.0
    gaussian = np.exp(-0.5 * ((np.arange(window) - n_bins_tolerance) / sigma) ** 2)
    n_bins = constants.N_FREQ_BINS_CONTOURS

    out = []
    for start, end, pitch, amplitude in notes:
        center = int(np.round(midi_pitch_to_contour_bin(pitch)))
        lo = max(center - n_bins_tolerance, 0)
        hi = min(n_bins, center + n_bins_tolerance + 1)
        gauss_lo = max(0, n_bins_tolerance - center)
        gauss_hi = window - max(0, center - (n_bins - n_bins_tolerance - 1))
        weighted = contours[start:end, lo:hi] * gaussian[gauss_lo:gauss_hi]
        shift = n_bins_tolerance - gauss_lo
        bends = list(np.argmax(weighted, axis=1) - shift)
        out.append((start, end, pitch, amplitude, bends))
    return out


def model_frames_to_time(n_frames: int) -> np.ndarray:
    """Frame-index -> seconds, correcting each window's accumulated drift.

    Each window of ANNOT_N_FRAMES frames covers slightly less than
    ANNOT_N_FRAMES hops of audio; the per-window offset plus a small
    empirical alignment constant is subtracted cumulatively
    (`note_creation.py:346-357`).
    """
    raw = np.arange(n_frames) * constants.FFT_HOP / constants.AUDIO_SAMPLE_RATE
    window_numbers = np.floor(np.arange(n_frames) / constants.ANNOT_N_FRAMES)
    window_offset = (constants.FFT_HOP / constants.AUDIO_SAMPLE_RATE) * (
        constants.ANNOT_N_FRAMES - (constants.AUDIO_N_SAMPLES / constants.FFT_HOP)
    ) + MAGIC_ALIGNMENT_OFFSET
    return raw - window_offset * window_numbers


# ---------------------------------------------------------------------------
# reference-named aliases: code ported from the reference package calls these
# exact names (its `basic_pitch/note_creation.py:182,289,360`)
# ---------------------------------------------------------------------------


def get_infered_onsets(
    onsets: np.ndarray, frames: np.ndarray, n_diff: int = 2
) -> np.ndarray:
    """Reference name for `infer_onsets_from_frames` (note the reference's
    spelling), same argument order and semantics."""
    return infer_onsets_from_frames(onsets, frames, n_diff)


def get_pitch_bends(
    contours: np.ndarray,
    note_events: List[FrameNote],
    n_bins_tolerance: int = 25,
) -> List[Tuple[int, int, int, float, Optional[List[int]]]]:
    """Reference name for `extract_pitch_bends` (`note_creation.py:182`)."""
    return extract_pitch_bends(contours, note_events, n_bins_tolerance)


def output_to_notes_polyphonic(
    frames: np.ndarray,
    onsets: np.ndarray,
    onset_thresh: float,
    frame_thresh: float,
    min_note_len: int,
    infer_onsets: bool,
    max_freq: Optional[float],
    min_freq: Optional[float],
    melodia_trick: bool = True,
    energy_tol: int = DEFAULT_ENERGY_TOLERANCE,
) -> List[FrameNote]:
    """Reference-signature wrapper over `decode_note_events`
    (`note_creation.py:360-371`): same positional order and defaults."""
    config = DecodeConfig(
        onset_threshold=onset_thresh,
        frame_threshold=frame_thresh,
        min_note_length=min_note_len,
        infer_onsets=infer_onsets,
        min_freq=min_freq,
        max_freq=max_freq,
        melodia_trick=melodia_trick,
        energy_tolerance=energy_tol,
    )
    return decode_note_events(frames, onsets, config)
