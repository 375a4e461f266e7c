"""Constant-Q transform front-end.

PyTorch counterpart of `basic_pitch_tpu/ops/cqt.py`: the multi-rate CQT
(complex analysis kernels for the top octave only; each lower octave comes
from lowpass-filtering and decimating the signal by two). The numpy
builders are copies of the JAX package's, pinned equal by
`tests/test_torch_params.py`. The compute keeps the JAX package's matmul
formulation: each stride-2 FIR is one block-Toeplitz matmul and each octave
one (frames, n_fft) x (n_fft, 2*n_filters) product, never a strided
convolution (the conv form lost accuracy through the 8-stage cascade).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from basic_pitch_torch.ops import spectral

DEFAULT_LOWPASS_KERNEL_LENGTH = 256
DEFAULT_LOWPASS_TRANSITION_BANDWIDTH = 0.001
HANN_WINDOW_BANDWIDTH = 1.5
_DEC_BLOCK = 128  # output samples per decimation block


def design_lowpass_fir(
    band_center: float = 0.5,
    kernel_length: int = DEFAULT_LOWPASS_KERNEL_LENGTH,
    transition_bandwidth: float = DEFAULT_LOWPASS_TRANSITION_BANDWIDTH,
) -> np.ndarray:
    """Anti-aliasing FIR for decimation-by-two, via frequency sampling
    (unity gain up to band_center/(1+tb), zero above band_center*(1+tb))."""
    import scipy.signal

    passband_max = band_center / (1 + transition_bandwidth)
    stopband_min = band_center * (1 + transition_bandwidth)
    freqs = [0.0, passband_max, stopband_min, 1.0]
    gains = [1.0, 1.0, 0.0, 0.0]
    return scipy.signal.firwin2(kernel_length, freqs, gains).astype(np.float64)


def make_cqt_analysis_kernels(
    q: float,
    fs: float,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Time-domain complex CQT kernels, centered in a power-of-two support.

    Returns:
        (kernels complex128 (n_bins, fft_len), fft_len, lengths, freqs)
    """
    fft_len = int(2 ** np.ceil(np.log2(np.ceil(q * fs / fmin))))
    freqs = fmin * 2.0 ** (np.arange(n_bins) / float(bins_per_octave))
    lengths = np.ceil(q * fs / freqs)

    kernels = np.zeros((n_bins, fft_len), dtype=np.complex128)
    for k, freq in enumerate(freqs):
        length = int(np.ceil(q * fs / freq))
        # center the kernel; odd lengths sit one sample left of center
        start = int(np.ceil(fft_len / 2.0 - length / 2.0)) - (length % 2)
        n_idx = np.arange(length) - (length + 1) // 2
        window = spectral.hann_periodic(length, np.float64)
        sig = window * np.exp(1j * 2.0 * np.pi * freq * n_idx / fs) / length
        sig = sig / np.abs(sig).sum()  # L1 basis norm, librosa-style
        kernels[k, start : start + length] = sig
    return kernels, fft_len, lengths, freqs


@dataclasses.dataclass(frozen=True)
class CQTKernels:
    """Build-time constants for the multi-rate CQT (all host numpy)."""

    sr: int
    hop_length: int
    fmin: float
    n_bins: int
    bins_per_octave: int
    n_octaves: int
    n_fft: int
    # stacked (real; imag) top-octave kernels, shape (2*n_filters, n_fft)
    top_octave_kernels: np.ndarray
    lowpass: np.ndarray  # (kernel_length,)
    length_norm: np.ndarray  # sqrt(ceil(Q*kernel_sr/f)) per output bin, (n_bins,)
    n_filters: int
    downsample_factor: int = 1
    early_lowpass: "np.ndarray | None" = None  # (kernel_length,), stride=factor

    @property
    def cascade_hop(self) -> int:
        """Top-octave frame hop at the (possibly pre-decimated) cascade rate."""
        return self.hop_length // self.downsample_factor


def build_cqt_kernels(
    sr: int = 22050,
    hop_length: int = 256,
    fmin: float = 27.5,
    n_bins: int = 309,
    bins_per_octave: int = 36,
    filter_scale: float = 1.0,
) -> CQTKernels:
    """Precompute every filterbank the CQT needs (a copy of the JAX builder)."""
    q = float(filter_scale) / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    n_filters = min(bins_per_octave, n_bins)
    n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))

    fmin_t = fmin * 2.0 ** (n_octaves - 1)
    remainder = n_bins % bins_per_octave
    if remainder == 0:
        fmax_t = fmin_t * 2.0 ** ((bins_per_octave - 1) / bins_per_octave)
    else:
        fmax_t = fmin_t * 2.0 ** ((remainder - 1) / bins_per_octave)
    fmin_t = fmax_t / 2.0 ** (1.0 - 1.0 / bins_per_octave)
    if fmax_t > sr / 2:
        raise ValueError(f"top CQT bin {fmax_t:.1f} Hz exceeds Nyquist; reduce n_bins")

    # early-downsample decision (librosa heuristic)
    filter_cutoff = fmax_t * (1 + 0.5 * HANN_WINDOW_BANDWIDTH / q)
    nyquist = sr // 2
    count1 = max(0, int(np.ceil(np.log2(0.85 * nyquist / filter_cutoff)) - 1) - 1)
    count2 = max(0, int(np.ceil(np.log2(hop_length))) - n_octaves + 1)
    downsample_factor = 2 ** min(count1, count2)

    if hop_length % downsample_factor != 0:
        raise ValueError(
            f"hop_length ({hop_length}) must be divisible by the early-"
            f"downsample factor ({downsample_factor}) for this geometry"
        )
    cascade_hop = hop_length // downsample_factor
    if cascade_hop % (2 ** (n_octaves - 1)) != 0:
        raise ValueError(
            f"cascade hop ({cascade_hop}) must be divisible by 2**(n_octaves-1) "
            f"({2 ** (n_octaves - 1)}) for the multi-rate cascade"
        )

    kernel_sr = sr / float(downsample_factor)
    early_lowpass = None
    if downsample_factor > 1:
        early_lowpass = design_lowpass_fir(band_center=1.0 / downsample_factor).astype(np.float32)

    basis, n_fft, _, _ = make_cqt_analysis_kernels(q, kernel_sr, fmin_t, n_filters, bins_per_octave)

    freqs_all = fmin * 2.0 ** (np.arange(n_bins) / float(bins_per_octave))
    lengths_all = np.ceil(q * kernel_sr / freqs_all)

    top = np.concatenate([basis.real, basis.imag], axis=0).astype(np.float32)

    return CQTKernels(
        sr=sr,
        hop_length=hop_length,
        fmin=fmin,
        n_bins=n_bins,
        bins_per_octave=bins_per_octave,
        n_octaves=n_octaves,
        n_fft=n_fft,
        top_octave_kernels=top,
        lowpass=design_lowpass_fir().astype(np.float32),
        length_norm=np.sqrt(lengths_all).astype(np.float32),
        n_filters=n_filters,
        downsample_factor=downsample_factor,
        early_lowpass=early_lowpass,
    )


def strided_toeplitz_matrix(taps: np.ndarray, stride: int, block: int = _DEC_BLOCK) -> np.ndarray:
    """Block-Toeplitz matrix turning a stride-``stride`` FIR into one matmul.

    With z the left-padded signal, y[n] = sum_k h[k] z[stride*n + k]; output
    block i depends only on z blocks (i, i+1):
    y[block i + t] = sum_o seg_i[o] W[o, t], W[o, t] = h[o - stride t].
    Returns (2*stride*block, block).
    """
    k = taps.shape[0]
    assert k <= stride * block + stride, "taps must fit the two-block segment span"
    w = np.zeros((2 * stride * block, block), dtype=np.float64)
    offsets = np.arange(2 * stride * block)[:, None] - stride * np.arange(block)[None, :]
    valid = (offsets >= 0) & (offsets < k)
    w[valid] = taps[offsets[valid]]
    return w.astype(np.float32)


def decimation_matrix(lowpass: np.ndarray) -> np.ndarray:
    """The CQT cascade's (512, 128) stride-2 matrix (256-tap FIR)."""
    assert lowpass.shape[0] == 2 * _DEC_BLOCK, "decimation matrix assumes 256-tap FIR"
    return strided_toeplitz_matrix(lowpass.astype(np.float64), 2)


def strided_blocked_matmul(z: torch.Tensor, w: torch.Tensor, stride: int, n_blocks: int) -> torch.Tensor:
    """Apply a `strided_toeplitz_matrix` to a prepared
    (batch, stride*block*(n_blocks+1)) signal; returns (batch, n_blocks*block)."""
    batch = z.shape[0]
    block = w.shape[1]
    zb = z.reshape(batch, n_blocks + 1, stride * block)
    segs = torch.cat([zb[:, :-1], zb[:, 1:]], dim=-1)  # (b, n_blocks, 2*stride*block)
    return torch.matmul(segs, w).reshape(batch, n_blocks * block)


def decimated_length(length: int, stride: int = 2) -> int:
    """Output length of the symmetric-padded 256-tap stride-``stride`` FIR."""
    return (length - 2) // stride + 1


def _decimate_by_n(x: torch.Tensor, w: torch.Tensor, n_taps: int, stride: int) -> torch.Tensor:
    """Anti-aliased decimation by ``stride`` (symmetric zero padding, VALID
    stride-n FIR) as one block matmul against ``w`` from
    `strided_toeplitz_matrix`."""
    _, length = x.shape
    n_out = decimated_length(length, stride)
    n_blocks = -(-n_out // _DEC_BLOCK)
    pad_left = (n_taps - 1) // 2
    z_len = stride * _DEC_BLOCK * (n_blocks + 1)
    z = F.pad(x, (pad_left, z_len - pad_left - length))
    return strided_blocked_matmul(z, w, stride, n_blocks)[:, :n_out]


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's "reflect" padding of the last axis by ``pad`` on each side,
    also where ``pad`` reaches past the signal (short low octaves): the
    index reflects with period 2 * (n - 1). `F.pad` only takes pad < n."""
    n = x.shape[-1]
    idx = torch.arange(-pad, n + pad, device=x.device)
    if n > 1:
        idx = torch.remainder(idx, 2 * (n - 1))
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    else:
        idx = torch.zeros_like(idx)
    return x[..., idx]


def _octave_cqt(x: torch.Tensor, kernel_matrix: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """Complex CQT of one octave: reflect-pad, frame, and one matmul.

    Returns (batch, n_filters, n_frames, 2) with imag negated (analysis
    convention).
    """
    x = _reflect_pad(x, n_fft // 2)
    frames = x.unfold(-1, n_fft, hop)[:, :n_frames]  # (b, n_frames, n_fft)
    both = torch.matmul(frames, kernel_matrix)
    n_filters = kernel_matrix.shape[1] // 2
    real = both[..., :n_filters].transpose(1, 2)
    imag = -both[..., n_filters:].transpose(1, 2)
    return torch.stack([real, imag], dim=-1)


def cqt_frame_count(n_samples: int, hop_length: int) -> int:
    """Frames produced for a centered CQT over n_samples: floor(L/hop) + 1."""
    return n_samples // hop_length + 1


class CQT(nn.Module):
    """Magnitude CQT with its filterbanks held as buffers, so `.to(device)`
    moves them once and a forward call copies nothing from the host."""

    def __init__(self, kernels: CQTKernels):
        super().__init__()
        self.kernels = kernels
        self.register_buffer(
            "kernel_matrix", torch.from_numpy(np.ascontiguousarray(kernels.top_octave_kernels.T)), persistent=False
        )
        self.register_buffer(
            "dec_matrix", torch.from_numpy(decimation_matrix(kernels.lowpass)), persistent=False
        )
        factor = kernels.downsample_factor
        self.register_buffer(
            "norm", torch.from_numpy(kernels.length_norm * np.float32(factor)), persistent=False
        )
        if factor > 1:
            early = strided_toeplitz_matrix(kernels.early_lowpass.astype(np.float64), factor)
            self.register_buffer("early_matrix", torch.from_numpy(early), persistent=False)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """(batch, n_samples) float32 -> (batch, n_frames, n_bins) magnitudes,
        low bin first."""
        k = self.kernels
        if k.downsample_factor > 1:
            audio = _decimate_by_n(audio, self.early_matrix, k.early_lowpass.shape[0], k.downsample_factor)
        n_frames = cqt_frame_count(audio.shape[-1], k.cascade_hop)

        octaves = []  # index 0 = top octave
        hop = k.cascade_hop
        x_down = audio
        for octave in range(k.n_octaves):
            if octave > 0:
                hop //= 2
                x_down = _decimate_by_n(x_down, self.dec_matrix, k.lowpass.shape[0], 2)
            octaves.append(_octave_cqt(x_down, self.kernel_matrix, k.n_fft, hop, n_frames))

        # low octave first, then crop to the requested bin count from the top
        full = torch.cat(octaves[::-1], dim=1)[:, -k.n_bins :]
        full = full * self.norm[None, :, None, None]
        mag = torch.sqrt(torch.sum(torch.square(full), dim=-1))
        return mag.transpose(1, 2)


def cqt_magnitude(kernels: CQTKernels, audio: torch.Tensor) -> torch.Tensor:
    """Functional form of `CQT` (builds the buffers on ``audio``'s device)."""
    return CQT(kernels).to(audio.device)(audio)
