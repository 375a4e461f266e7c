"""model_mfu.offline: the model's analytic FLOPs on the windows the audio
needs (a chunk's padding not counted) over the window's wall seconds and
the card's float32 peak, in percent."""

from pb import yardstick


def read(run):
    peak = yardstick.peak(run.device_name, "float32_flops")
    if run.stats.get("kind") != "offline" or peak is None:
        return None
    flops = run.stats["windows"] * yardstick.window_forward_flops()
    return 100.0 * flops / run.stats["window_s"] / peak
