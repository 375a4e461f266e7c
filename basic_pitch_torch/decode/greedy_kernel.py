"""Wrapper of the hand-written CUDA greedy decode kernel (`csrc/greedy_decode.cu`).

`decode_greedy` has `decode_pallas`'s signature and returns `DecodedNotes`.
Around the launch it does what the JAX wrapper does: pad-mask past t_end,
preprocess, onset peak picking and candidate ordering (shared with
`device.decode_plain` through `device.greedy_inputs`), and ORs the onset
overflow into the result. A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises — there is no fallback and no
frame-count gate. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from basic_pitch_torch.decode import device as device_decode
from basic_pitch_torch.decode import notes as host_decode

F = device_decode.F
TABLE_BLOCK = 1024  # frames per block-table entry (TBLOCK in the source)
MAX_INT32 = 2**31 - 1

# kernel launches made by `decode_greedy` in this process
launches = 0


def _kernel() -> ctypes.CDLL:
    from basic_pitch_torch import _build

    lib = _build.load("greedy_decode")
    fn = lib.greedy_decode_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def greedy_stages(
    inputs: device_decode.GreedyInputs,
    frame_thresh: float,
    min_note_len: int,
    energy_tol: int,
    max_notes: int,
    max_melodia_iters: int,
    melodia_trick: bool,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Launch the kernel on the current stream. Returns (packed (max_notes,
    4) int32, n_notes () int32, overflow () bool) without synchronising."""
    global launches
    frames_ft = inputs.frames_ft
    T = frames_ft.shape[1]
    k = inputs.order.shape[0]
    _check("frames", frames_ft, torch.float32, (F, T))
    _check("order", inputs.order, torch.int32, (k,))
    _check("n_onsets", inputs.n_onsets, torch.int32, ())
    dev = frames_ft.device
    for name, value in (("T * 88", T * F), ("max_notes", max_notes), ("max_melodia_iters", max_melodia_iters)):
        if not 0 < value <= MAX_INT32:
            raise ValueError(f"{name} = {value} is outside what the kernel takes (1 .. 2**31 - 1)")
    if not 0 < inputs.t_end <= T:
        raise ValueError(f"t_end {inputs.t_end} must lie in 1 .. {T}")
    for name, value in (("min_note_len", min_note_len), ("energy_tol", energy_tol)):
        if abs(int(value)) > MAX_INT32:
            raise ValueError(f"{name} = {value} does not fit an int32")

    lib = _kernel()
    nb = -(-T // TABLE_BLOCK)
    residual = frames_ft.clone()
    bmax = torch.empty((F, nb), dtype=torch.float32, device=dev)
    btf = torch.empty((F, nb), dtype=torch.int32, device=dev)
    notes = torch.empty((max_notes, 4), dtype=torch.int32, device=dev)
    meta = torch.empty((4,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.greedy_decode_launch(
            frames_ft.data_ptr(), residual.data_ptr(), inputs.order.data_ptr(),
            inputs.n_onsets.data_ptr(), bmax.data_ptr(), btf.data_ptr(),
            notes.data_ptr(), meta.data_ptr(),
            T, inputs.t_end, int(min_note_len), int(energy_tol), max_notes,
            max_melodia_iters, 1 if melodia_trick else 0, float(frame_thresh), stream,
        )
    if err != 0:
        raise RuntimeError(f"greedy_decode kernel launch failed: cudaError_t {err}")
    launches += 1
    n_notes = torch.clamp(meta[0], max=max_notes)
    overflow = (meta[1] > 0) | (meta[0] > max_notes)
    return notes, n_notes, overflow


def decode_greedy(
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
) -> device_decode.DecodedNotes:
    """Greedy note decode of (T, 88) posteriorgrams: the CUDA kernel for
    CUDA tensors, `device.decode_plain` for CPU tensors, and an error for
    anything else."""
    if frames.device.type == "cpu":
        return device_decode.decode_plain(
            frames, onsets, onset_thresh, frame_thresh, min_note_len, freq_mask,
            infer_onsets, melodia_trick, energy_tol, max_notes, max_melodia_iters, valid_frames,
        )
    if frames.device.type != "cuda" or onsets.device != frames.device:
        raise ValueError(f"decode_greedy takes CPU or CUDA tensors on one device, got {frames.device} and {onsets.device}")
    for name, t in (("frames", frames), ("onsets", onsets)):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != F:
            raise ValueError(f"{name} must be (T, {F}) float32, got {tuple(t.shape)} {t.dtype}")
    inputs = device_decode.greedy_inputs(
        frames, onsets, onset_thresh, freq_mask, infer_onsets, max_notes, valid_frames
    )
    notes, n_notes, overflow = greedy_stages(
        inputs, frame_thresh, min_note_len, energy_tol, max_notes, max_melodia_iters, melodia_trick
    )
    return device_decode.unpack(notes, n_notes, overflow | inputs.onset_overflow)
