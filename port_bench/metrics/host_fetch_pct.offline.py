"""host_fetch_pct.offline: host time of the device-to-host copies
(`bp.transcriber.fetch`: note counts, note fields, bends, posteriorgrams,
total, waits for the device included) over the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "offline", "bp.transcriber.fetch")
