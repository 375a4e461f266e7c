"""host_decode_pct.offline: host time of the decode wrapper
(`bp.decode.dispatch`: the decode inputs, the greedy_decode launch and the
bend gather, total) over the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "offline", "bp.decode.dispatch")
