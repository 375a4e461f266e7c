"""MT3's log-mel front end on the device.

Each segment's own samples are framed every ``hop`` samples into
``n_fft``-point frames, zeros past the segment's end (TensorFlow's
``stft(pad_end=True)``: ceil(n / hop) frames), weighted by a periodic Hann
window and transformed with a real FFT; the magnitudes go through an
HTK-mel matrix built as `tf.signal.linear_to_mel_weight_matrix` builds it
(triangles on mel = 1127 ln(1 + f / 700), the DC bin zero), then
log(max(mel, floor)). The FFT is cuFFT's; the mel weighting is one float32
matmul (TF32 off, the port's rule).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def mel_weights(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) float32 weights of the linear bins."""
    bins = _hz_to_mel(np.arange(1, n_fft // 2 + 1) * (sample_rate / n_fft))
    edges = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    rise = (bins[:, None] - edges[None, :-2]) / (edges[1:-1] - edges[:-2])[None]
    fall = (edges[None, 2:] - bins[:, None]) / (edges[2:] - edges[1:-1])[None]
    w = np.clip(np.minimum(rise, fall), 0.0, None)
    return np.vstack([np.zeros((1, n_mels)), w]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann(n: int) -> np.ndarray:
    """The periodic Hann window of ``n`` points (float32)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def log_mel(segs: torch.Tensor, window: torch.Tensor, weights: torch.Tensor, hop: int, floor: float) -> torch.Tensor:
    """(B, n) float32 segments -> (B, ceil(n / hop), n_mels) log-mel
    magnitudes; ``window`` is `hann(n_fft)` and ``weights`` `mel_weights`, on
    the segments' device."""
    n_fft = window.shape[0]
    n_frames = -(-segs.shape[1] // hop)
    frames = F.pad(segs, (0, n_fft - hop)).unfold(1, n_fft, hop)[:, :n_frames]
    mag = torch.fft.rfft(frames * window, n=n_fft).abs()
    return torch.log(torch.clamp(mag @ weights, min=floor))
