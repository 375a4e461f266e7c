"""Cells cut to a size a CPU test run holds: the same code paths, small
chunks, short recordings, small batches, each by its kind's ``tiny``."""

import importlib
import json
import time
from typing import Optional

import torch

from pb import bench

SEED = 2**31 + 4242

# a cell whose files are here and that BENCHMARK.json does not list (its
# latency tails spread too widely for a bound; PERF.md, Open questions)
UNLISTED = {
    "nmp.serve-poisson": dict(
        config="nmp-icassp2022", traffic="serve-poisson",
        end_to_end=["latency_p50_ms", "latency_p95_ms", "setup_s"],
        per_layer=["requests_per_batch.serve", "device_idle_pct.serve"],
    ),
}


# every cell the harness's tests drive: BENCHMARK.json's, then the unlisted
CELLS = [w["name"] for w in json.loads((bench.ROOT / "BENCHMARK.json").read_text())["workloads"]] + list(UNLISTED)


def load(workload: str) -> bench.Cell:
    if workload not in UNLISTED:
        return bench.load_cell(workload)
    entry = UNLISTED[workload]
    return bench.Cell(
        name=workload,
        chips=1,
        config=json.loads((bench.BENCH_DIR / "configs" / f"{entry['config']}.json").read_text()),
        traffic=json.loads((bench.BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((bench.BENCH_DIR / "limits" / f"{workload}.json").read_text()),
        end_to_end=[{"name": n, "unit": "ms" if n.endswith("_ms") else "s"} for n in entry["end_to_end"]],
        per_layer=[{"name": n, "unit": "%" if "pct" in n else "requests"} for n in entry["per_layer"]],
    )


def tiny(workload: str) -> bench.Cell:
    """The cell cut by its kind's own ``tiny``."""
    cell = load(workload)
    return importlib.import_module(f"pb.kinds.{cell.traffic['kind']}").tiny(cell)


def execute(workload: str, seconds: Optional[float] = None, trace: bool = False) -> dict:
    """A run of the cut cell, for ``seconds`` or, by default, the
    ``test_seconds`` its kind's ``tiny`` set."""
    cell = tiny(workload)
    seconds = cell.traffic["test_seconds"] if seconds is None else seconds
    ctx = bench.Context(cell=cell, seed=SEED, seconds=seconds, trace=trace,
                        device=torch.device("cpu"), t_start=time.monotonic())
    return bench.execute(ctx)
