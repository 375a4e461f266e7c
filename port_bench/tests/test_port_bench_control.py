"""The control of each cell's check, on the card: the reference computed in
TF32 (the next precision below the float32 the configurations state), put
in the program's place, comes out not correct. TF32 exists only on the
card, so these skip without one. Each cell runs at its own size: cut to
the CPU tests' size, the dense mix hides the reference's TF32 rounding
(PERF.md, Findings). `run.py --control tf32` runs the same control."""

import time

import pytest

from cells import CELLS, SEED, load
from pb import bench


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    ctx = bench.Context(cell=load(workload), seed=SEED, seconds=5.0, trace=False, device=card, t_start=time.monotonic(), control="tf32")
    assert bench.execute(ctx)["correct"] is False
