"""window_fill_pct.offline: the model windows the recordings need over the
windows the model ran (each recording padded to whole W-window chunks), from
the transcriber's counters in the traced span, in percent."""

from pb import spans


def read(run):
    got = spans.summary(run, "offline")
    if got is None or not got["counters"].get("transcriber.windows_run"):
        return None
    return 100.0 * got["counters"]["transcriber.windows_needed"] / got["counters"]["transcriber.windows_run"]
