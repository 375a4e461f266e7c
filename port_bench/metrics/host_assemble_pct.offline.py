"""host_assemble_pct.offline: host time of event assembly
(`bp.transcriber.assemble`, self time: its fetches left out) over the
traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "offline", "bp.transcriber.assemble", "self_s")
