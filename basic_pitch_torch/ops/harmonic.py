"""Harmonic stacking: align harmonics of a CQT as channels.

PyTorch counterpart of `basic_pitch_tpu/ops/harmonic.py`. For each harmonic
h the CQT is shifted along frequency by round(bins_per_octave * log2(h))
bins, so that the h-th harmonic of every fundamental lands on that
fundamental's bin; the shifted copies are stacked as channels and cropped.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

SEMITONES_PER_OCTAVE = 12


def harmonic_shifts(bins_per_semitone: int, harmonics: Sequence[float]) -> Tuple[int, ...]:
    """Frequency-bin shift per harmonic: round(B * log2(h)), B bins/octave.

    Python's round() rounds half to even, as np.round and tf.math.round do.
    """
    bins_per_octave = SEMITONES_PER_OCTAVE * bins_per_semitone
    return tuple(int(round(bins_per_octave * math.log2(h))) for h in harmonics)


def harmonic_stack(
    x: torch.Tensor,
    bins_per_semitone: int,
    harmonics: Sequence[float],
    n_output_freqs: int,
) -> torch.Tensor:
    """(batch, n_times, n_freqs, 1) -> (batch, n_times, n_output_freqs, len(harmonics))."""
    if x.ndim != 4:
        raise ValueError(f"expected rank-4 input (b, t, f, 1), got shape {tuple(x.shape)}")
    channels = []
    for shift in harmonic_shifts(bins_per_semitone, harmonics):
        if shift == 0:
            shifted = x
        elif shift > 0:
            # pad takes (last dim, second-to-last dim, ...) pairs
            shifted = F.pad(x[:, :, shift:, :], (0, 0, 0, shift))
        else:
            shifted = F.pad(x[:, :, :shift, :], (0, 0, -shift, 0))
        channels.append(shifted)
    stacked = torch.cat(channels, dim=-1)
    return stacked[:, :, :n_output_freqs, :]
