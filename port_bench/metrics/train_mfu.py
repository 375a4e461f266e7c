"""train_mfu: three forwards' analytic FLOPs per window stepped (forward,
and the backward's two products) over the window's wall seconds and the
card's float32 peak, in percent."""

from pb import yardstick


def read(run):
    peak = yardstick.peak(run.device_name, "float32_flops")
    if run.stats.get("kind") != "train" or peak is None:
        return None
    return 100.0 * run.stats["windows"] * yardstick.train_step_flops_per_window() / run.stats["window_s"] / peak
