"""On-device note-event decoding: onset preprocessing, the plain greedy
decoder, pitch bends and event assembly.

PyTorch counterpart of `basic_pitch_tpu/decode/device.py`. Posteriorgrams
stay on the device; only compact note buffers cross to the host. The two
greedy stages (onset-anchored notes, then the "melodia" residual-energy
loop) run in the hand-written CUDA kernel of `decode/greedy_kernel.py` on
a GPU. `decode_plain` below is their plain PyTorch version with
`device.decode`'s semantics: the CPU path, and what the kernel is held
against on the card. Both share `greedy_inputs`, the preprocessing and
onset-candidate ordering, so the exactness contract has one
implementation of everything around the greedy loops.

Emission order (onset notes backward in time, then melodia notes by
descending residual energy) and every edge condition match the JAX
decoder; `tests/test_torch_decode.py` fuzzes this against it.
"""

from __future__ import annotations

import functools
import itertools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from basic_pitch_torch import constants
from basic_pitch_torch.decode import notes as host_decode
from basic_pitch_torch.utils import profiling

F = constants.N_FREQ_BINS_NOTES  # 88
N_BEND_TOLERANCE = 25
BEND_WINDOW = 2 * N_BEND_TOLERANCE + 1
BEND_INLINE_FRAMES = 256  # per-note bend frames shipped in the compact buffer
INT_MAX = 2**31 - 1


class DecodedNotes(NamedTuple):
    """Fixed-size note buffers (valid entries: index < n_notes)."""

    starts: torch.Tensor  # (max_notes,) int32
    ends: torch.Tensor  # (max_notes,) int32
    pitches: torch.Tensor  # (max_notes,) int32 — MIDI numbers
    amplitudes: torch.Tensor  # (max_notes,) float32
    n_notes: torch.Tensor  # () int32
    overflow: torch.Tensor  # () bool — buffers or iteration caps were hit


class GreedyInputs(NamedTuple):
    """What the greedy stages consume, prepared on the frames' device."""

    frames_ft: torch.Tensor  # (88, T) float32 preprocessed frames, contiguous
    order: torch.Tensor  # (k,) int32 flat onset ids in reference order, -1 padded
    n_onsets: torch.Tensor  # () int32, min(candidate count, k)
    onset_overflow: torch.Tensor  # () bool, candidates beyond k were dropped
    t_end: int  # logical frame count


def preprocess(
    frames: torch.Tensor,
    onsets: torch.Tensor,
    freq_mask: Optional[torch.Tensor],
    infer_onsets: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frequency constraining + onset inference from frame-energy jumps."""
    if freq_mask is not None:
        frames = frames * freq_mask[None, :]
        onsets = onsets * freq_mask[None, :]
    if infer_onsets:
        diffs = []
        for lag in (1, 2):
            padded = torch.cat([frames.new_zeros((lag, F)), frames])
            diffs.append(padded[lag:] - padded[:-lag])
        frame_diff = torch.clamp(torch.minimum(diffs[0], diffs[1]), min=0.0)
        frame_diff[:2] = 0.0
        peak = frame_diff.max()
        # ratio pinned to exactly 1 at the peak, so the structural tie
        # scaled[argmax(frame_diff)] == max(onsets) survives any division
        ratio = torch.where(frame_diff == peak, torch.ones_like(frame_diff), frame_diff / peak)
        scaled = torch.where(peak > 0, onsets.max() * ratio, torch.zeros_like(ratio))
        onsets = torch.maximum(onsets, scaled)
    return frames, onsets


def onset_peak_mask(onsets: torch.Tensor, t_end: int, onset_thresh: float) -> torch.Tensor:
    """Strict time-local onset maxima, thresholded with >= (threshold 0
    admits non-peaks, as in the reference), every frame past t_end excluded."""
    n_frames = onsets.shape[0]
    interior = (onsets[1:-1] > onsets[:-2]) & (onsets[1:-1] > onsets[2:])
    peak_mask = torch.zeros_like(onsets, dtype=torch.bool)
    peak_mask[1:-1] = interior
    pos_t = torch.arange(n_frames, device=onsets.device)[:, None]
    peak_mask = peak_mask & (pos_t <= t_end - 2)
    peak_values = torch.where(peak_mask, onsets, torch.zeros_like(onsets))
    return (peak_values >= onset_thresh) & (pos_t < t_end)


def onset_candidate_order(onset_mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Onset candidates in the reference's order (time desc, then freq desc
    == descending flat index), compacted into a (k,) int32 buffer of flat
    ids (-1 padded); candidates past ``k`` are dropped. Returns (order,
    total candidate count). A cumsum plus a scatter into a buffer with one
    extra drop slot, so nothing waits for the device."""
    total = onset_mask.numel()
    mask_desc = onset_mask.reshape(-1).flip(0)
    # torch's integer cumsum is int64 whatever the input
    positions = torch.cumsum(mask_desc.to(torch.int32), 0) - 1
    dest = torch.where(mask_desc & (positions < k), positions, torch.full_like(positions, k))
    flat_ids_desc = (total - 1) - torch.arange(total, device=onset_mask.device, dtype=torch.int32)
    order = torch.full((k + 1,), -1, dtype=torch.int32, device=onset_mask.device)
    order.scatter_(0, dest, flat_ids_desc)
    return order[:k], onset_mask.sum().to(torch.int32)


def greedy_inputs(
    frames: torch.Tensor,
    onsets: torch.Tensor,
    onset_thresh: float,
    freq_mask: Optional[torch.Tensor],
    infer_onsets: bool,
    max_notes: int,
    valid_frames: Optional[int],
) -> GreedyInputs:
    """Pad-mask, preprocess, peak-pick and order the onset candidates."""
    n_frames = frames.shape[0]
    t_end = n_frames if valid_frames is None else int(valid_frames)
    if valid_frames is not None:
        # zero the padded tail so both stages behave exactly as if the
        # arrays ended at t_end (the melodia seed search sees every frame)
        pad_mask = (torch.arange(n_frames, device=frames.device)[:, None] < t_end).to(frames.dtype)
        frames = frames * pad_mask
        onsets = onsets * pad_mask
    frames, onsets = preprocess(frames, onsets, freq_mask, infer_onsets)
    onset_mask = onset_peak_mask(onsets, t_end, onset_thresh)
    # candidate capacity scales with the recording, not the note buffer
    k = min(max(max_notes, n_frames), n_frames * F)
    order, full_count = onset_candidate_order(onset_mask, k)
    return GreedyInputs(
        frames_ft=frames.t().contiguous(),
        order=order,
        n_onsets=torch.clamp(full_count, max=k),
        onset_overflow=full_count > k,
        t_end=t_end,
    )


# ---------------------------------------------------------------------------
# plain greedy stages
# ---------------------------------------------------------------------------


def _forward_scan(col: torch.Tensor, t0: int, thresh: float, tol: int, t_end: int) -> Tuple[int, int]:
    """End bookkeeping of the forward walk from t0+1 (run lengths by cummax).

    Returns (end, i_final): the exclusive end of above-threshold frames, and
    the exclusive end of visited frames.
    """
    n = col.shape[0]
    pos = torch.arange(n, device=col.device)
    above = (col >= thresh) | (pos <= t0)
    last_above = torch.cummax(torch.where(above, pos, torch.full_like(pos, -1)), 0).values
    consec = pos - last_above
    in_range = (consec >= tol) & (pos >= t0 + 1) & (pos <= t_end - 2)
    t_stop = int(torch.where(in_range, pos, torch.full_like(pos, n)).min())
    if t_stop < n:
        i_final, k_final = t_stop + 1, tol
    else:
        i_final = max(t0 + 1, t_end - 1)
        k_final = int(consec[min(max(t_end - 2, 0), n - 1)]) if t_end - 2 >= t0 + 1 else 0
    return i_final - k_final, i_final


def _backward_scan(col: torch.Tensor, t0: int, thresh: float, tol: int) -> Tuple[int, int]:
    """Start bookkeeping of the melodia backward walk from t0-1 (suffix cummin).

    Returns (start, i_final): the inclusive start of above-threshold frames,
    and the inclusive end of the walk (frames (i_final, t0) were visited).
    """
    n = col.shape[0]
    pos = torch.arange(n, device=col.device)
    above = (col >= thresh) | (pos >= t0)
    rev = torch.where(above, pos, torch.full_like(pos, n + 1)).flip(0)
    next_above = torch.cummin(rev, 0).values.flip(0)
    consec = next_above - pos
    in_range = (consec >= tol) & (pos <= t0 - 1) & (pos >= 1)
    t_stop = int(torch.where(in_range, pos, torch.full_like(pos, -1)).max())
    if t_stop >= 0:
        i_final, k_final = t_stop - 1, tol
    else:
        i_final = min(t0 - 1, 0)
        k_final = int(consec[1]) if t0 - 1 >= 1 else 0
    return i_final + 1 + k_final, i_final


def _row_stats(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row max and the first position achieving it."""
    rmax = rows.max(dim=1).values
    tfirst = torch.argmax((rows == rmax[:, None]).to(torch.uint8), dim=1)
    return rmax, tfirst


def greedy_stages_plain(
    inputs: GreedyInputs,
    frame_thresh: float,
    min_note_len: int,
    energy_tol: int,
    max_notes: int,
    max_melodia_iters: int,
    melodia_trick: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two greedy stages, one note at a time in a Python loop.

    Returns (packed (max_notes, 4) int32 [start, end, midi pitch,
    bitcast(amplitude)], n_notes () int32, overflow () bool), the layout the
    kernel writes. The residual matrix is updated in place on a copy.
    """
    device = inputs.frames_ft.device
    frames_ft = inputs.frames_ft
    remaining = frames_ft.clone()
    t_end = inputs.t_end
    thresh = float(np.float32(frame_thresh))
    notes: List[Tuple[int, int, int, float]] = []
    overflow = False

    def emit(start: int, end: int, freq: int, amp_sum: torch.Tensor, span: int) -> None:
        nonlocal overflow
        if len(notes) >= max_notes:
            overflow = True
            return
        amplitude = float(amp_sum / np.float32(max(span, 1)))
        notes.append((start, end, freq + host_decode.MIDI_PITCH_OFFSET, amplitude))

    # ---- stage 1: onset-anchored notes, backward in time ----
    n_onsets = int(inputs.n_onsets)
    for flat in inputs.order[:n_onsets].tolist():
        t0, freq = divmod(flat, F)
        if flat < 0 or t0 >= t_end - 1:
            continue
        end, _ = _forward_scan(remaining[freq], t0, thresh, energy_tol, t_end)
        if end - t0 <= min_note_len:
            continue
        remaining[max(freq - 1, 0) : min(freq + 1, F - 1) + 1, t0:end] = 0.0
        emit(t0, end, freq, frames_ft[freq, t0:end].sum(), end - t0)

    if melodia_trick:
        # ---- stage 2: melodia, residual-energy region growing ----
        rowmax, tfirst = _row_stats(remaining)
        lanes = torch.arange(F, device=device)
        it = 0
        while True:
            peak = rowmax.max()
            if not bool(peak > thresh):
                break
            if it >= max_melodia_iters:
                overflow = True  # cut with energy left
                break
            # np.argmax((T, F)) tie order: smallest t, then smallest f
            key = torch.where(rowmax == peak, tfirst * F + lanes, torch.full_like(lanes, INT_MAX))
            t_mid, freq = divmod(int(key.min()), F)
            col = remaining[freq].clone()
            col[t_mid] = 0.0
            fwd_end, fwd_final = _forward_scan(col, t_mid, thresh, energy_tol, t_end)
            bwd_start, bwd_final = _backward_scan(col, t_mid, thresh, energy_tol)
            lo_f, hi_f = max(freq - 1, 0), min(freq + 1, F - 1) + 1
            remaining[lo_f:hi_f, bwd_final + 1 : t_mid] = 0.0
            remaining[lo_f:hi_f, t_mid + 1 : fwd_final] = 0.0
            remaining[freq, t_mid] = 0.0
            rowmax[lo_f:hi_f], tfirst[lo_f:hi_f] = _row_stats(remaining[lo_f:hi_f])
            i_start, i_end = bwd_start, fwd_end - 1
            if i_end - i_start > min_note_len:
                emit(i_start, i_end, freq, frames_ft[freq, i_start:i_end].sum(), i_end - i_start)
            it += 1

    packed = torch.zeros((max_notes, 4), dtype=torch.int32)
    if notes:
        rows = np.array([n[:3] for n in notes], dtype=np.int32)
        amps = np.array([n[3] for n in notes], dtype=np.float32).view(np.int32)
        packed[: len(notes)] = torch.from_numpy(np.concatenate([rows, amps[:, None]], axis=1))
    return (
        packed.to(device),
        torch.tensor(len(notes), dtype=torch.int32, device=device),
        torch.tensor(overflow, device=device),
    )


def unpack(packed: torch.Tensor, n_notes: torch.Tensor, overflow: torch.Tensor) -> DecodedNotes:
    """(max_notes, 4) int32 [start, end, pitch, amp bits] -> DecodedNotes."""
    return DecodedNotes(
        starts=packed[:, 0],
        ends=packed[:, 1],
        pitches=packed[:, 2],
        amplitudes=packed[:, 3].contiguous().view(torch.float32),
        n_notes=n_notes,
        overflow=overflow,
    )


def decode_plain(
    frames: torch.Tensor,
    onsets: torch.Tensor,
    onset_thresh: float,
    frame_thresh: float,
    min_note_len: int,
    freq_mask: Optional[torch.Tensor] = None,
    infer_onsets: bool = True,
    melodia_trick: bool = True,
    energy_tol: int = host_decode.DEFAULT_ENERGY_TOLERANCE,
    max_notes: int = 4096,
    max_melodia_iters: int = 8192,
    valid_frames: Optional[int] = None,
) -> DecodedNotes:
    """Plain PyTorch greedy decode with `device.decode`'s semantics.

    Args:
        frames / onsets: (T, 88) float32 posteriorgrams.
        freq_mask: optional (88,) 0/1 mask (frequency constraining).
        max_notes / max_melodia_iters: buffer and iteration bounds; the
            `overflow` flag reports truncation.
        valid_frames: logical frame count when the arrays are zero-padded.
    """
    inputs = greedy_inputs(frames, onsets, onset_thresh, freq_mask, infer_onsets, max_notes, valid_frames)
    packed, n_notes, overflow = greedy_stages_plain(
        inputs, frame_thresh, min_note_len, energy_tol, max_notes, max_melodia_iters, melodia_trick
    )
    return unpack(packed, n_notes, overflow | inputs.onset_overflow)


# ---------------------------------------------------------------------------
# pitch bends
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _bend_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static gather tables for all 88 possible note pitches: (indices
    (88, 51) into the contour bins, validity (88, 51), gaussian (51,))."""
    centers = np.round(
        [host_decode.midi_pitch_to_contour_bin(p + host_decode.MIDI_PITCH_OFFSET) for p in range(F)]
    ).astype(np.int32)
    offsets = np.arange(BEND_WINDOW) - N_BEND_TOLERANCE
    idx = centers[:, None] + offsets[None, :]
    valid = (idx >= 0) & (idx < constants.N_FREQ_BINS_CONTOURS)
    gaussian = np.exp(-0.5 * ((np.arange(BEND_WINDOW) - N_BEND_TOLERANCE) / 5.0) ** 2)
    return np.clip(idx, 0, constants.N_FREQ_BINS_CONTOURS - 1), valid, gaussian.astype(np.float32)


def bend_matrix(contours: torch.Tensor) -> torch.Tensor:
    """(T, 264) contours -> (T, 88) int8 per-frame bend for every pitch:
    bend[t, p] = argmax_j(contours[t, window_p] * gaussian) - 25, in
    1/3-semitone units (ties go to the first j)."""
    idx, valid, gaussian = _bend_tables()
    device = contours.device
    windows = contours[:, torch.from_numpy(idx).long().to(device)]  # (T, 88, 51)
    weighted = torch.where(
        torch.from_numpy(valid).to(device)[None],
        windows * torch.from_numpy(gaussian).to(device),
        torch.full_like(windows, -1.0),
    )
    return (torch.argmax(weighted, dim=-1) - N_BEND_TOLERANCE).to(torch.int8)


def gather_note_bends(bends_all: torch.Tensor, decoded: DecodedNotes) -> torch.Tensor:
    """(T, 88) bend matrix -> per-note (max_notes, BEND_INLINE_FRAMES) int8.

    Rows past `n_notes` are zero; notes longer than BEND_INLINE_FRAMES take
    their full row from `bends_all` at assembly. One vectorised gather.
    """
    max_notes = decoded.starts.shape[0]
    n_frames = bends_all.shape[0]
    live = torch.arange(max_notes, device=bends_all.device) < decoded.n_notes
    starts = torch.where(live, decoded.starts, torch.zeros_like(decoded.starts)).clamp(0, n_frames).long()
    pitch = (decoded.pitches - host_decode.MIDI_PITCH_OFFSET).clamp(0, F - 1).long()
    padded = torch.cat([bends_all, bends_all.new_zeros((BEND_INLINE_FRAMES, F))])
    t_idx = starts[:, None] + torch.arange(BEND_INLINE_FRAMES, device=bends_all.device)[None, :]
    rows = padded[t_idx, pitch[:, None]]
    return torch.where(live[:, None], rows, torch.zeros_like(rows))


# ---------------------------------------------------------------------------
# host-facing assembly
# ---------------------------------------------------------------------------


def notes_to_events(
    decoded: DecodedNotes,
    times: np.ndarray,
    bends_inline: Optional[np.ndarray] = None,
    bends_all_device: Optional[torch.Tensor] = None,
) -> "list[tuple]":
    """Host-side buffers -> second-domain events (start_s, end_s, pitch,
    amplitude, bends), built with whole-array operations and one `tolist`
    per field rather than Python work per note or frame.

    `times` maps frames to seconds (`notes.model_frames_to_time`); an end
    past the last frame takes the last frame's time. `bends_inline` None
    gives bends None. Otherwise each note's bends (Python ints) are its
    frames of the compact per-note buffer, or, for a note longer than
    BEND_INLINE_FRAMES, its slice of its pitch's column of the
    device-resident matrix, fetched in one gather of those columns.

    The tuples and bend lists are made by `zip` and `map` inside one
    `list` call, not by a comprehension: CPython's cyclic collector runs
    only between bytecodes, so a recording's thousands of new objects meet
    one young collection instead of one every 700 objects, and far fewer
    of them are promoted towards the full collections that walk the whole
    heap.
    """
    n = int(decoded.n_notes)
    starts = decoded.starts[:n].numpy()
    ends = decoded.ends[:n].numpy()
    pitches = decoded.pitches[:n].numpy()
    fields = (
        times[starts].tolist(),
        times[np.minimum(ends, len(times) - 1)].tolist(),
        pitches.tolist(),
        decoded.amplitudes[:n].double().tolist(),
    )
    profiling.count("transcriber.notes_assembled", n)
    if bends_inline is None:
        profiling.count("transcriber.bend_frames_assembled", 0)
        profiling.count("transcriber.long_note_columns", 0)
        return list(zip(*fields, itertools.repeat(None, n)))
    lengths = ends - starts
    long_notes = np.flatnonzero(lengths > BEND_INLINE_FRAMES)
    inline_lengths = lengths.copy()
    inline_lengths[long_notes] = 0
    # the short notes' frames, in note order
    flat = bends_inline[:n][np.arange(BEND_INLINE_FRAMES, dtype=lengths.dtype) < inline_lengths[:, None]]
    if long_notes.size:
        flat = _splice_long_bends(flat, lengths, long_notes, starts, pitches, bends_all_device)
    profiling.count("transcriber.bend_frames_assembled", len(flat))
    profiling.count("transcriber.long_note_columns", long_notes.size)
    bends = flat.tolist()
    offsets = np.concatenate(([0], np.cumsum(lengths))).tolist()
    per_note = map(bends.__getitem__, map(slice, offsets[:-1], offsets[1:]))
    return list(zip(*fields, per_note))


def _splice_long_bends(
    short_flat: np.ndarray,
    lengths: np.ndarray,
    long_notes: np.ndarray,
    starts: np.ndarray,
    pitches: np.ndarray,
    bends_all_device: torch.Tensor,
) -> np.ndarray:
    """Every note's bend frames in note order: the short notes' from
    `short_flat`, each long note's `[start, end)` slice of its pitch column,
    from one device gather of the long notes' distinct columns."""
    cols, col_of = np.unique(pitches[long_notes] - host_decode.MIDI_PITCH_OFFSET, return_inverse=True)
    index = torch.from_numpy(cols).long().to(bends_all_device.device)
    with profiling.span("bp.transcriber.fetch"):
        fetched = bends_all_device[:, index].cpu().numpy()
    is_long = np.zeros(len(lengths), bool)
    is_long[long_notes] = True
    in_long = np.repeat(is_long, lengths)
    flat = np.empty(len(in_long), short_flat.dtype)
    flat[~in_long] = short_flat
    long_lengths = lengths[long_notes]
    note = np.repeat(np.arange(len(long_notes)), long_lengths)
    step = np.arange(len(note)) - np.repeat(np.cumsum(long_lengths) - long_lengths, long_lengths)
    flat[in_long] = fetched[starts[long_notes][note] + step, col_of[note]]
    return flat
