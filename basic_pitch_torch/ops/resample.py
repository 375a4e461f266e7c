"""On-device decimation by two (44.1 kHz -> 22.05 kHz).

PyTorch counterpart of `basic_pitch_tpu/ops/resample.py`: a 257-tap
Kaiser-windowed halfband lowpass (beta 14.77, scipy `firwin`) applied as
one block-Toeplitz matmul, the same construction as the CQT's octave
cascade. Semantics match ``scipy.signal.resample_poly(x, 1, 2,
window=taps)``: zero phase, ceil(n/2) output samples.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from basic_pitch_torch.ops import cqt

_BLOCK = 128
KAISER_BETA = 14.77
N_TAPS = 257  # odd, symmetric, centered


@functools.lru_cache(maxsize=None)
def decimate2_taps() -> np.ndarray:
    """257-tap Kaiser-windowed halfband lowpass (cutoff at the new Nyquist)."""
    from scipy.signal import firwin

    return firwin(N_TAPS, 0.5, window=("kaiser", KAISER_BETA)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def decimate2_matrix() -> np.ndarray:
    """(512, 128) block matrix: y[128 i + t] = sum_j h[j] z[256 i + 2 t + j]."""
    return cqt.strided_toeplitz_matrix(decimate2_taps(), 2, _BLOCK)


def decimate2_output_length(n: int) -> int:
    """resample_poly's output-length convention: ceil(n / 2)."""
    return -(-n // 2)


def decimate2(
    x: torch.Tensor,
    halo: bool = False,
    n_out: Optional[int] = None,
    matrix: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Anti-aliased decimation by two of (batch, n) or (n,) audio.

    Without ``halo``, returns ceil(n / 2) samples, output sample k aligned
    with input sample 2k. With ``halo=True`` the input already carries the
    filter's 128-sample left context: output t is sum_j h[j] x[2t + j], and
    ``n_out`` sets the output length (the chunked transcriber hands each
    chunk its halo so chunk boundaries are seamless). ``matrix`` is
    `decimate2_matrix()` already on ``x``'s device; without it the matrix is
    copied there on each call.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    _, length = x.shape
    if halo:
        if n_out is None:
            raise ValueError("halo mode requires explicit n_out")
        pad_left = 0
    else:
        n_out = decimate2_output_length(length) if n_out is None else n_out
        pad_left = (N_TAPS - 1) // 2  # 128
    if matrix is None:
        matrix = torch.from_numpy(decimate2_matrix()).to(x.device)
    n_blocks = -(-n_out // _BLOCK)
    z_len = 2 * _BLOCK * (n_blocks + 1)
    z = F.pad(x, (pad_left, max(0, z_len - pad_left - length)))[:, :z_len]
    y = cqt.strided_blocked_matmul(z, matrix, 2, n_blocks)[:, :n_out]
    return y[0] if squeeze else y


# ---------------------------------------------------------------------------
# 44.1 kHz -> 16 kHz (160/441), MT3's input rate
# ---------------------------------------------------------------------------

POLY_UP, POLY_DOWN = 160, 441
POLY_HALF = 10 * POLY_DOWN  # scipy's filter half length for these rates
POLY_HALO = -(-POLY_HALF // POLY_UP)  # 28 inputs a block reads on each side
POLY_SPAN = POLY_DOWN + 2 * POLY_HALO  # 497 inputs per block of 160 outputs
POLY_KAISER_BETA = 5.0  # resample_poly's default window


@functools.lru_cache(maxsize=None)
def poly_taps() -> np.ndarray:
    """resample_poly's 8 821-tap Kaiser lowpass for 160/441, gain 160."""
    from scipy.signal import firwin

    return firwin(2 * POLY_HALF + 1, 1.0 / POLY_DOWN, window=("kaiser", POLY_KAISER_BETA)) * POLY_UP


@functools.lru_cache(maxsize=None)
def poly_matrix() -> np.ndarray:
    """(497, 160) polyphase block: output 160 b + t = sum_m x[441 b - 28 + m]
    W[m, t], W[m, t] = h[441 t - 160 (m - 28) + 4410] (zero outside the taps)."""
    h = poly_taps()
    idx = POLY_DOWN * np.arange(POLY_UP)[None, :] - POLY_UP * (np.arange(POLY_SPAN)[:, None] - POLY_HALO) + POLY_HALF
    valid = (idx >= 0) & (idx < len(h))
    w = np.zeros(idx.shape, np.float64)
    w[valid] = h[idx[valid]]
    return w.astype(np.float32)


def poly_output_length(n: int) -> int:
    """resample_poly's output length for 160/441: ceil(160 n / 441)."""
    return -(-n * POLY_UP // POLY_DOWN)


def resample_160_441(x: torch.Tensor, n_blocks: int, matrix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """44.1 kHz -> 16 kHz as one block matmul, ``scipy.signal.resample_poly(x,
    160, 441)``'s arithmetic. ``x`` holds input samples 441 b0 - 28 ..
    441 (b0 + n_blocks) + 28 of a recording (zeros outside it); returns its
    outputs 160 b0 .. 160 (b0 + n_blocks) - 1. ``matrix`` is `poly_matrix()`
    on ``x``'s device (copied there when not given)."""
    if matrix is None:
        matrix = torch.from_numpy(poly_matrix()).to(x.device)
    need = POLY_DOWN * n_blocks + 2 * POLY_HALO
    if x.shape[-1] < need:
        raise ValueError(f"{n_blocks} blocks need {need} input samples, got {x.shape[-1]}")
    return (x.unfold(-1, POLY_SPAN, POLY_DOWN)[:n_blocks] @ matrix).reshape(-1)
