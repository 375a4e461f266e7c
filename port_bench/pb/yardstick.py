"""The yardstick: operation and byte counts, and the card's peaks.

Frozen copies of the port's measurement arithmetic, worked from shapes
alone so that no change to the program can move them:

- `window_forward_flops`: the NMP model's matmul and convolution FLOPs on
  one 43 844-sample window (the CQT's blocked decimation and octave
  matmuls plus the seven SAME-padded head convolutions), the counts of
  `basic_pitch_torch/utils/flops.py` at the published widths (8 harmonics,
  filters 8/32/32, 309 CQT bins of 36 per octave in 9 octaves, n_fft 256,
  no early downsampling). Elementwise work is left out.
- `train_step_flops_per_window`: forward plus backward, three forwards.
- `greedy_decode_bytes`: the least traffic of one greedy note decode: the
  valid frames of the note and onset posteriorgrams read once, each kept
  note (16 bytes) and the count written once.
- `PEAKS`: the NVIDIA H100's published dense rates (data sheet, SXM part,
  700 W), keyed on the name `torch.cuda.get_device_name()` gives. Any other
  name has no peak, and a share of the peak is then not reported.
"""

from __future__ import annotations

from typing import Dict, Optional

# the CQT geometry of the published model (8 harmonics)
CQT_N_FFT = 256
CQT_N_FILTERS = 36
CQT_N_OCTAVES = 9
CQT_HOP = 256
WINDOW_SAMPLES = 43844
_DEC_BLOCK = 128

# the head geometry: 172 frames, 264 contour bins, 88 note bins
FRAMES = 172
CONTOUR_BINS = 264
NOTE_BINS = 88

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "float32_flops": 67.0e12,  # outside the tensor cores
        "tf32_flops": 495.0e12,
        "bf16_flops": 989.0e12,
        "hbm_bytes": 3.35e12,
    },
}


def peak(device_name: str, key: str) -> Optional[float]:
    """The named card's peak ``key``, or None for a card not in the table."""
    return PEAKS.get(device_name, {}).get(key)


def _decimated_length(length: int, stride: int = 2) -> int:
    return (length - 2) // stride + 1


def _dec_matmul_flops(n_out: int, stride: int = 2) -> int:
    n_blocks = -(-n_out // _DEC_BLOCK)
    return 2 * n_blocks * (2 * stride * _DEC_BLOCK) * _DEC_BLOCK


def cqt_forward_flops() -> int:
    """Matmul FLOPs of the CQT front end on one window."""
    total = 0
    length = WINDOW_SAMPLES
    n_frames = length // CQT_HOP + 1
    for octave in range(CQT_N_OCTAVES):
        if octave > 0:
            length = _decimated_length(length)
            total += _dec_matmul_flops(length)
        total += 2 * n_frames * CQT_N_FFT * 2 * CQT_N_FILTERS
    return total


def _conv_flops(out_h: int, out_w: int, cout: int, kh: int, kw: int, cin: int) -> int:
    return 2 * out_h * out_w * cout * kh * kw * cin


def heads_forward_flops(n_harmonics: int = 8, filters=(8, 32, 32)) -> int:
    """Conv FLOPs of the contour, note and onset heads on one window."""
    fc, fn, fo = filters
    t, f = FRAMES, CONTOUR_BINS
    f3 = -(-f // 3)
    return (
        _conv_flops(t, f, fc, 3, 39, n_harmonics)
        + _conv_flops(t, f, 1, 5, 5, fc)
        + _conv_flops(t, f3, fn, 7, 7, 1)
        + _conv_flops(t, f3, 1, 7, 3, fn)
        + _conv_flops(t, f3, fo, 5, 5, n_harmonics)
        + _conv_flops(t, f3, 1, 3, 3, fn + 1)
    )


def window_forward_flops() -> int:
    return cqt_forward_flops() + heads_forward_flops()


def train_step_flops_per_window() -> int:
    return 3 * window_forward_flops()


def greedy_decode_bytes(valid_frames: int, n_notes: int) -> int:
    """Least bytes one greedy decode moves: frames and onsets of the valid
    frames read once (float32, 88 pitches each), 16 bytes a kept note and
    16 bytes of count and flags written once."""
    return 2 * valid_frames * NOTE_BINS * 4 + n_notes * 16 + 16


def model_windows(n_samples: int, sample_rate: int) -> int:
    """Model windows a recording needs, padding of the last chunk not
    counted (the transcriber's front pad of 3 840 samples at 22.05 kHz)."""
    hop, pad_front = 36164, 3840
    length = -(-n_samples // 2) if sample_rate == 44100 else n_samples
    return max(1, -(-(length + pad_front) // hop))


def model_frames(n_samples: int, sample_rate: int) -> int:
    """Valid posteriorgram frames of a recording (142 per window hop)."""
    length = -(-n_samples // 2) if sample_rate == 44100 else n_samples
    return int(length / 36164 * 142)
