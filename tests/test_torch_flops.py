"""PyTorch port: `basic_pitch_torch/utils/flops.py`, the MFU denominator.

The FLOP counts must equal the JAX package's exactly (the analytic work of
the model, whatever lowering computes it), and the peak table holds the
NVIDIA H100's published dense rates keyed on the card's name; any other
name, the CPU included, leaves MFU out.
"""

import numpy as np
import pytest

from basic_pitch_torch import constants
from basic_pitch_torch.utils import flops
from basic_pitch_tpu.utils import flops as j_flops

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("n_harmonics", [1, 2, 8])
def test_window_counts_equal_jax(n_harmonics):
    assert flops.cqt_forward_flops(n_harmonics=n_harmonics) == j_flops.cqt_forward_flops(n_harmonics=n_harmonics)
    assert flops.heads_forward_flops(n_harmonics) == j_flops.heads_forward_flops(n_harmonics)
    assert flops.window_forward_flops(n_harmonics) == j_flops.window_forward_flops(n_harmonics)
    assert flops.train_step_flops_per_window(n_harmonics) == j_flops.train_step_flops_per_window(n_harmonics)


def test_default_window_count():
    assert flops.cqt_forward_flops() == 102_285_312
    assert flops.heads_forward_flops() == 968_734_272
    assert flops.window_forward_flops() == 1_071_019_584


@pytest.mark.parametrize("n_samples", [4096, 22050, constants.AUDIO_N_SAMPLES, 2 * constants.AUDIO_N_SAMPLES + 1, 441000])
def test_cqt_counts_equal_jax_over_lengths(n_samples):
    for nh in (2, 8):
        assert flops.cqt_forward_flops(n_samples, nh) == j_flops.cqt_forward_flops(n_samples, nh)


@pytest.mark.parametrize("n_out, stride", [(1, 2), (128, 2), (129, 2), (21922, 2), (1000, 4)])
def test_decimation_count_equals_jax(n_out, stride):
    assert flops._dec_matmul_flops(n_out, stride) == j_flops._dec_matmul_flops(n_out, stride)


def test_heads_flops_matches_hand_count():
    t, f, f3 = 172, 264, 88
    hand = (
        2 * t * f * 8 * (3 * 39 * 8)
        + 2 * t * f * 1 * (5 * 5 * 8)
        + 2 * t * f3 * 32 * (7 * 7 * 1)
        + 2 * t * f3 * 1 * (7 * 3 * 32)
        + 2 * t * f3 * 32 * (5 * 5 * 8)
        + 2 * t * f3 * 1 * (3 * 3 * 33)
    )
    assert flops.heads_forward_flops() == hand


def test_cqt_flops_scale_with_length():
    short = flops.cqt_forward_flops(n_samples=constants.AUDIO_N_SAMPLES)
    double = flops.cqt_forward_flops(n_samples=2 * constants.AUDIO_N_SAMPLES)
    assert 1.5 * short < double < 2.5 * short


@pytest.mark.parametrize("precision, peak", [("highest", 67.0), ("high", 495.0), ("default", 989.0), ("bf16", 989.0)])
def test_h100_peaks(precision, peak):
    assert flops.peak_tflops(H100, precision) == peak


def test_mfu_report_math():
    # 10 TFLOP in 1 s on the H100: 10/989 of bf16, 10/67 of float32
    r = flops.mfu_report(10e12, 1.0, H100)
    assert set(r) == {"achieved_tflops", "mfu_pct_vs_bf16_peak", "mfu_pct_vs_fp32_highest_peak"}  # the JAX keys
    assert abs(r["achieved_tflops"] - 10.0) < 1e-6
    np.testing.assert_allclose(r["mfu_pct_vs_bf16_peak"], 1000.0 / 989.0, atol=0.01)
    np.testing.assert_allclose(r["mfu_pct_vs_fp32_highest_peak"], 1000.0 / 67.0, atol=0.01)
    # the model's work per 128-window chunk over 40 ms
    chunk = 128 * flops.window_forward_flops()
    r = flops.mfu_report(chunk, 0.040, H100)
    assert r["achieved_tflops"] == round(chunk / 0.040 / 1e12, 3)
    np.testing.assert_allclose(r["mfu_pct_vs_fp32_highest_peak"], 100 * chunk / 0.040 / 67e12, atol=0.01)


@pytest.mark.parametrize("name", ["cpu", "CPU x86_64", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite", ""])
def test_unknown_device_omits_mfu(name):
    r = flops.mfu_report(1e12, 1.0, name)
    assert r == {"achieved_tflops": 1.0}
    for precision in ("highest", "high", "default"):
        assert flops.peak_tflops(name, precision) is None
    # and the JAX table does not know the H100
    assert j_flops.peak_tflops(H100) is None
