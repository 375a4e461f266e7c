"""model_mfu.mt3: MT3's analytic FLOPs on the window's segments (front-end
matmuls, encoder, cross keys and values, and each decode step at its cache
length, for the tokens each segment emitted; `pb/mt3_yardstick.py`) over
the window's wall seconds and the card's float32 peak, in percent."""

from pb import mt3_yardstick


def read(run):
    peak = mt3_yardstick.peak(run.device_name, "float32_flops")
    if run.stats.get("kind") != "mt3" or peak is None:
        return None
    flops = sum(mt3_yardstick.segment_flops(n) for n in run.stats["token_counts"])
    return 100.0 * flops / run.stats["window_s"] / peak
