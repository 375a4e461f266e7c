"""host_backward_pct.train: host time of the train step's backward
(`bp.train.backward`, total) over the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "train", "bp.train.backward")
