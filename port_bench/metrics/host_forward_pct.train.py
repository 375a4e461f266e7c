"""host_forward_pct.train: host time of the train step's forward
(`bp.train.forward`: materialize the batch, forward and losses, total) over
the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "train", "bp.train.forward")
