"""Cells cut to a size a CPU test run holds: the same code paths, small
chunks, short recordings, small batches."""

import json
import time

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
    cell = load(workload)
    kind = cell.traffic["kind"]
    if kind in ("offline", "serve"):
        cell.config["transcriber"].update(windows_per_chunk=2, pcm_transport="raw")
        cell.traffic.update(pool=4, snippet_s=2, snippets_per_level=1, check_sample=2)
        d = cell.traffic["durations"]
        cell.traffic["durations"] = {"dist": "fixed", "seconds": 3} if d["dist"] == "fixed" else {"dist": "loguniform", "min_s": 2, "max_s": 5}
    if kind == "offline":
        cell.traffic["batch"] = 2
    if kind == "serve":
        cell.traffic.update(rate_per_s=1.5)
        cell.traffic["server"]["max_batch"] = 2
    if kind == "train":
        cell.config["train"]["batch_size"] = 2
        cell.traffic.update(pool=4)
    return cell


def execute(workload: str, seconds: float = 2.0, trace: bool = False) -> dict:
    ctx = bench.Context(cell=tiny(workload), seed=SEED, seconds=seconds, trace=trace,
                        device=torch.device("cpu"), t_start=time.monotonic())
    return bench.execute(ctx)
