"""greedy_decode_roofline: the least time of the traced span's greedy
decodes (their bytes bound at the card's HBM rate) over the device time of
the `greedy_decode` kernel's launches in the trace, in percent."""

from pb import yardstick


def read(run):
    peak = yardstick.peak(run.device_name, "hbm_bytes")
    if run.trace is None or peak is None or run.stats.get("kind") != "offline":
        return None
    seconds, launches = run.trace.device_seconds("greedy_decode")
    if not launches or seconds <= 0:
        return None
    least = sum(yardstick.greedy_decode_bytes(frames, notes) for frames, notes in run.stats["traced_decodes"]) / peak
    return 100.0 * least / seconds
