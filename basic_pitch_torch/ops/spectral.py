"""Per-example dB normalization of a magnitude spectrogram.

PyTorch counterpart of `basic_pitch_tpu/ops/spectral.py` (`normalized_log`,
and the periodic Hann window the CQT kernel builder needs).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def normalized_log(magnitude: torch.Tensor) -> torch.Tensor:
    """Rescale a (batch, time, freq) magnitude spectrogram to dB in [0, 1].

    magnitude -> power -> 10*log10(power + 1e-10), then shift each example by
    its min and divide by its max (0 where the max is 0). The log10 is a
    ratio of natural logs, as in the JAX package.
    """
    power = torch.square(magnitude)
    ln10 = torch.log(torch.tensor(10.0, dtype=magnitude.dtype, device=magnitude.device))
    log_power = 10.0 * (torch.log(power + 1e-10) / ln10)
    log_power_min = torch.amin(log_power, dim=(1, 2), keepdim=True)
    offset = log_power - log_power_min
    offset_max = torch.amax(offset, dim=(1, 2), keepdim=True)
    return torch.where(offset_max > 0.0, offset / offset_max, torch.zeros_like(offset))


def hann_periodic(n: int, dtype: type = np.float32) -> np.ndarray:
    """Periodic (DFT-even) Hann window of length n."""
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * np.arange(n) / n)).astype(dtype)
