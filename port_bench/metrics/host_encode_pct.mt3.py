"""host_encode_pct.mt3: host time of MT3's encoder and cross keys and
values (`bp.mt3.encode`, total) over the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "mt3", "bp.mt3.encode")
