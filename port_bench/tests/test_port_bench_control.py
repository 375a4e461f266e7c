"""The control of each cell's check, on the card: the reference computed in
TF32 (the next precision below the float32 the configurations state), put
in the program's place, comes out not correct. TF32 exists only on the
card, so these skip without one. At the cells' own sizes the control is
run with `run.py --control tf32` (see PERF.md for its readings)."""

import time

import pytest

from cells import SEED, tiny
from pb import bench


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["nmp.offline-mixed", "nmp.offline-dense", "nmp.serve-poisson", "train.b16-highest"])
def test_control_is_not_correct(card, workload):
    cell = tiny(workload)
    if cell.traffic["kind"] == "train":
        cell.config["train"]["batch_size"] = 8
    else:  # the reference's rounding shows over some tens of seconds of audio
        cell.traffic["durations"] = {"dist": "loguniform", "min_s": 15, "max_s": 40}
    ctx = bench.Context(cell=cell, seed=SEED, seconds=5.0, trace=False, device=card, t_start=time.monotonic(), control="tf32")
    assert bench.execute(ctx)["correct"] is False
