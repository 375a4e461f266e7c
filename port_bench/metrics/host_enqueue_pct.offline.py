"""host_enqueue_pct.offline: host time of the transcriber's forward enqueue
(`bp.transcriber.forward`: the uploads and the model calls, total) over the
traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "offline", "bp.transcriber.forward")
