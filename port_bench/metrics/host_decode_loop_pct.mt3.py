"""host_decode_loop_pct.mt3: host time of MT3's greedy loop (`bp.mt3.decode`:
the decode steps' launches and the tokens' copy to the host, total, waits
for the card included) over the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "mt3", "bp.mt3.decode")
