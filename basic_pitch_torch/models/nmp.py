"""NMP ("Notes, Multipitch, Onsets") transcription network, eval forward.

PyTorch counterpart of `basic_pitch_tpu/models/nmp.py` at its default
configuration (8 harmonics, 8 contour filters, 32 note filters, 32 onset
filters, contours on):

    audio (b, 43844) -> CQT (b, 172, 309) -> NormalizedLog -> BatchNorm
      -> HarmonicStack([0.5, 1..7], crop 264) -> (b, 8, 172, 264)
      contour head: Conv(8, 3x39) -> BN -> ReLU -> Conv(1, 5x5, sigmoid)
      note head:    Conv(32, 7x7, stride (1,3)) -> ReLU -> Conv(1, 7x3, sigmoid)
      onset head:   Conv(32, 5x5, stride (1,3)) -> BN -> ReLU
                    -> concat(note_pre) -> Conv(1, 3x3, sigmoid)

Inside, activations are NCHW with H = time and W = frequency; the outputs
keep the JAX package's (batch, time, freq) layout. Convolutions use
TensorFlow's SAME padding, written out explicitly because
`nn.Conv2d(padding="same")` rejects stride > 1: when the total pad is odd,
the extra row or column goes after (bottom or right).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from basic_pitch_torch import constants
from basic_pitch_torch.ops import cqt as cqt_ops
from basic_pitch_torch.ops.harmonic import harmonic_stack
from basic_pitch_torch.ops.spectral import normalized_log

BN_EPSILON = 1e-3  # Keras BatchNormalization default
N_HARMONICS = 8
HARMONICS = (0.5,) + tuple(float(h) for h in range(1, N_HARMONICS))

# maximum CQT semitone count representable below Nyquist
MAX_N_SEMITONES = int(
    np.floor(12.0 * np.log2(0.5 * constants.AUDIO_SAMPLE_RATE / constants.ANNOTATIONS_BASE_FREQUENCY))
)


def n_semitones_for_harmonics(n_harmonics: int) -> int:
    """Extra semitones of CQT needed so the top harmonic is still visible."""
    return min(
        int(np.ceil(12.0 * np.log2(n_harmonics)) + constants.ANNOTATIONS_N_SEMITONES),
        MAX_N_SEMITONES,
    )


@functools.lru_cache(maxsize=1)
def cqt_kernels() -> cqt_ops.CQTKernels:
    """The CQT geometry of the default model (309 bins, 36 per octave)."""
    return cqt_ops.build_cqt_kernels(
        sr=constants.AUDIO_SAMPLE_RATE,
        hop_length=constants.FFT_HOP,
        fmin=constants.ANNOTATIONS_BASE_FREQUENCY,
        n_bins=n_semitones_for_harmonics(N_HARMONICS) * constants.CONTOURS_BINS_PER_SEMITONE,
        bins_per_octave=12 * constants.CONTOURS_BINS_PER_SEMITONE,
    )


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow SAME padding (before, after) of one spatial dimension."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """`nn.Conv2d` with TensorFlow SAME padding for any stride."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int], stride: Tuple[int, int] = (1, 1)):
        super().__init__(cin, cout, kernel, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom = _same_pad(x.shape[2], self.kernel_size[0], self.stride[0])
        left, right = _same_pad(x.shape[3], self.kernel_size[1], self.stride[1])
        return super().forward(F.pad(x, (left, right, top, bottom)))


class NMP(nn.Module):
    """The default NMP model; load weights with `models.params.from_jax_params`."""

    def __init__(self):
        super().__init__()
        self.cqt = cqt_ops.CQT(cqt_kernels())
        nh = len(HARMONICS)
        self.bn_cqt = nn.BatchNorm2d(1, eps=BN_EPSILON)
        self.contour_conv = SameConv2d(nh, 8, (3, 39))
        self.bn_contour = nn.BatchNorm2d(8, eps=BN_EPSILON)
        self.contour_out = SameConv2d(8, 1, (5, 5))
        self.note_conv = SameConv2d(1, 32, (7, 7), stride=(1, 3))
        self.note_out = SameConv2d(32, 1, (7, 3))
        self.onset_conv = SameConv2d(nh, 32, (5, 5), stride=(1, 3))
        self.bn_onset = nn.BatchNorm2d(32, eps=BN_EPSILON)
        self.onset_out = SameConv2d(33, 1, (3, 3))
        self.eval()

    def frontend(self, audio: torch.Tensor) -> torch.Tensor:
        """(b, AUDIO_N_SAMPLES) -> harmonically stacked, normalized CQT,
        NCHW (b, n_harmonics, n_frames, 264)."""
        x = normalized_log(self.cqt(audio)).unsqueeze(1)  # (b, 1, t, 309)
        x = self.bn_cqt(x)
        stacked = harmonic_stack(
            x.permute(0, 2, 3, 1),
            constants.CONTOURS_BINS_PER_SEMITONE,
            HARMONICS,
            constants.N_FREQ_BINS_CONTOURS,
        )  # (b, t, 264, h)
        return stacked.permute(0, 3, 1, 2).contiguous()

    def forward(self, audio: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(b, 43844) float32 at 22050 Hz -> {"onset": (b,t,88),
        "contour": (b,t,264), "note": (b,t,88)}."""
        x = self.frontend(audio)

        c = torch.relu(self.bn_contour(self.contour_conv(x)))
        contour = torch.sigmoid(self.contour_out(c))  # (b, 1, t, 264)

        n = torch.relu(self.note_conv(contour))
        n_pre = torch.sigmoid(self.note_out(n))  # (b, 1, t, 88)

        o = torch.relu(self.bn_onset(self.onset_conv(x)))
        o = torch.cat([n_pre, o], dim=1)  # note-pre first, then the onset stack
        onset = torch.sigmoid(self.onset_out(o))

        return {"onset": onset[:, 0], "contour": contour[:, 0], "note": n_pre[:, 0]}
