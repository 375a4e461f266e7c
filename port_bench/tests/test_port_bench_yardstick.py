"""The frozen counts, pinned to the numbers of the port's own arithmetic
(`basic_pitch_torch/utils/flops.py` at the published widths, and the
greedy decode bound of `chip_smoke.py` at its main shape)."""

from pb import yardstick


def test_window_flops_are_the_ports_counts():
    assert yardstick.cqt_forward_flops() == 102_285_312
    assert yardstick.heads_forward_flops() == 968_734_272
    assert yardstick.window_forward_flops() == 1_071_019_584
    assert yardstick.train_step_flops_per_window() == 3_213_058_752


def test_greedy_decode_bytes_at_the_main_shape():
    # 60 s at 22.05 kHz: 5 168 valid frames, 1 272 notes -> 3 658 640 B
    assert yardstick.greedy_decode_bytes(5168, 1272) == 3_658_640


def test_windows_and_frames_of_a_recording():
    # 60 s at 44.1 kHz: 1 323 000 samples at 22.05 kHz, with the front pad
    assert yardstick.model_windows(2_646_000, 44100) == 37
    assert yardstick.model_frames(2_646_000, 44100) == 5194
    assert yardstick.model_windows(1, 22050) == 1


def test_peaks_only_for_the_named_card():
    assert yardstick.peak("NVIDIA H100 80GB HBM3", "float32_flops") == 67.0e12
    assert yardstick.peak("NVIDIA H100 80GB HBM3", "hbm_bytes") == 3.35e12
    assert yardstick.peak("cpu", "float32_flops") is None
