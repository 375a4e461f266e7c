"""Analytic FLOP accounting for the NMP model: the MFU denominator.

The counts are those of `basic_pitch_tpu/utils/flops.py`, exactly: every
shape in the model is static, so the FLOPs of one forward window are
build-time arithmetic. The CQT is a chain of dense matmuls (per-octave
kernel matmul + stride-2 decimation matmuls, 128-sample output blocks) and
the three heads are seven SAME-padded convs (`models/nmp.py`). Elementwise
work (BN, sigmoid, harmonic stack, normalized-log) is O(activations) and is
left out, per standard MFU practice.

The counts are the model's analytic work, whatever lowering computes it:
they do not depend on ``conv_impl`` (an im2col or Toeplitz lowering does
more arithmetic for the same result, and reads a higher MFU).

The peak table holds the NVIDIA H100's published dense rates (data sheet,
SXM part, 700 W), keyed on the name `torch.cuda.get_device_name()` gives.
Any other name, the CPU included, has no peak, so MFU is left out rather
than reported against a wrong one.
"""

from __future__ import annotations

from typing import Dict, Optional

from basic_pitch_torch import constants

# Dense peak TFLOP/s by device name, per matmul precision of
# `models/nmp.PRECISIONS`: "highest" is float32 outside the tensor cores,
# "high" TF32 and "default" bf16 on the tensor cores.
_PEAK_TFLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"highest": 67.0, "high": 495.0, "default": 989.0},
}
_PRECISION_ALIASES = {"bf16": "default"}  # the JAX package's name of the bf16 peak


def _dec_matmul_flops(n_out: int, stride: int = 2, block: int = 128) -> int:
    """FLOPs of one strided blocked matmul producing n_out samples.

    Each 128-sample output block is a (2*stride*block, block) dot against a
    two-block input segment (`ops/cqt.strided_blocked_matmul`).
    """
    n_blocks = -(-n_out // block)
    return 2 * n_blocks * (2 * stride * block) * block


def cqt_forward_flops(n_samples: int = constants.AUDIO_N_SAMPLES, n_harmonics: int = 8) -> int:
    """Exact matmul FLOPs of the CQT front end on one (1, n_samples) window."""
    from basic_pitch_torch.models import nmp
    from basic_pitch_torch.ops import cqt as cqt_ops

    kernels = nmp.cqt_kernels_for(n_harmonics)
    total = 0
    length = n_samples
    if kernels.downsample_factor > 1:
        n_out = cqt_ops.decimated_length(length, kernels.downsample_factor)
        total += _dec_matmul_flops(n_out, kernels.downsample_factor)
        length = n_out
    n_frames = cqt_ops.cqt_frame_count(length, kernels.cascade_hop)
    for octave in range(kernels.n_octaves):
        if octave > 0:
            length = cqt_ops.decimated_length(length)
            total += _dec_matmul_flops(length)
        # (n_frames, n_fft) x (n_fft, 2*n_filters) per octave
        total += 2 * n_frames * kernels.n_fft * 2 * kernels.n_filters
    return total


def _conv_flops(out_h: int, out_w: int, cout: int, kh: int, kw: int, cin: int) -> int:
    return 2 * out_h * out_w * cout * kh * kw * cin


def heads_forward_flops(n_harmonics: int = 8) -> int:
    """Exact conv FLOPs of the three NMP heads on one window (`models/nmp.py`)."""
    t = constants.ANNOT_N_FRAMES  # 172
    f = constants.N_FREQ_BINS_CONTOURS  # 264
    f3 = -(-f // 3)  # stride-3 SAME output width: 88
    nh = n_harmonics
    total = 0
    total += _conv_flops(t, f, 8, 3, 39, nh)  # contour_conv
    total += _conv_flops(t, f, 1, 5, 5, 8)  # contour_out
    total += _conv_flops(t, f3, 32, 7, 7, 1)  # note_conv (stride (1,3))
    total += _conv_flops(t, f3, 1, 7, 3, 32)  # note_out
    total += _conv_flops(t, f3, 32, 5, 5, nh)  # onset_conv (stride (1,3))
    total += _conv_flops(t, f3, 1, 3, 3, 32 + 1)  # onset_out
    return total


def window_forward_flops(n_harmonics: int = 8) -> int:
    """Matmul+conv FLOPs of one forward pass over one 43844-sample window."""
    return cqt_forward_flops(n_harmonics=n_harmonics) + heads_forward_flops(n_harmonics)


def train_step_flops_per_window(n_harmonics: int = 8) -> int:
    """Forward + backward: dgrad and wgrad each cost one forward's FLOPs."""
    return 3 * window_forward_flops(n_harmonics)


def peak_tflops(device_name: str, precision: str = "highest") -> Optional[float]:
    """Dense peak of the named card at a matmul precision ("highest",
    "high" or "default"; "bf16" is the last one's JAX name).

    Returns None when the name has no table entry (the CPU, another card),
    so callers can omit MFU rather than report it against a wrong peak.
    """
    peaks = _PEAK_TFLOPS.get(device_name)
    if peaks is None:
        return None
    return peaks[_PRECISION_ALIASES.get(precision, precision)]


def mfu_report(total_flops: float, device_s: float, device_name: str) -> Dict[str, float]:
    """Measured FLOP rate + MFU against the bf16 and the float32 peaks (the
    JAX report's keys; on the port the "highest" peak is the float32 rate
    outside the tensor cores)."""
    achieved_tflops = total_flops / max(device_s, 1e-9) / 1e12
    out = {"achieved_tflops": round(achieved_tflops, 3)}
    bf16 = peak_tflops(device_name, "default")
    if bf16 is not None:
        out["mfu_pct_vs_bf16_peak"] = round(100.0 * achieved_tflops / bf16, 2)
        out["mfu_pct_vs_fp32_highest_peak"] = round(
            100.0 * achieved_tflops / peak_tflops(device_name, "highest"), 2
        )
    return out
