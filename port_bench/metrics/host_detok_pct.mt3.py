"""host_detok_pct.mt3: host time of reading tokens back into events
(`bp.mt3.detokenize`, total) over the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "mt3", "bp.mt3.detokenize")
