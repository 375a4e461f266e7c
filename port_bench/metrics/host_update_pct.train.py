"""host_update_pct.train: host time of the train step's update
(`bp.train.update`: Adam, the unit-norm constraint, the batch-norm
averages, total) over the traced span, in percent."""

from pb import spans


def read(run):
    return spans.host_pct(run, "train", "bp.train.update")
