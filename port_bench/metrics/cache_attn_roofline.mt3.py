"""cache_attn_roofline.mt3: the least time of the traced span's decode-step
attention (the keys and values of each segment's self-attention cache at
every step's length and of its cross-attention, read once at the card's
HBM rate; `pb/mt3_yardstick.py`) over the device time of the
`_mt3_cache_attention` kernel's launches in the trace, in percent."""

from pb import mt3_yardstick


def read(run):
    peak = mt3_yardstick.peak(run.device_name, "hbm_bytes")
    if run.trace is None or peak is None or run.stats.get("kind") != "mt3":
        return None
    seconds, launches = run.trace.device_seconds("_mt3_cache_attention")
    if not launches or seconds <= 0:
        return None
    least = sum(mt3_yardstick.cache_attention_bytes(n) for n in run.stats["traced_token_counts"]) / peak
    return 100.0 * least / seconds
