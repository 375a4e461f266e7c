"""One run of one cell: find its files by name, run its kind, read its
metrics and print the result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the checkout's root maps the workload to a
configuration (its ``file``) and a traffic mix (`traffic/<traffic>.json`,
whose ``kind`` names the runner `pb/kinds/<kind>.py`). The cell's limits
are `limits/<workload>.json`, and each metric is read by
`metrics/<metric name>.py`. Every line but the last goes to standard error
or comes before the result on standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import types
from typing import Callable, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# whole top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "basic_pitch_tpu")
TRACE_SECONDS = 4.0  # the traced span that follows the window in a --trace 1 run


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _for_cell(metrics: List[Dict], workload: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root``'s `BENCHMARK.json`, with its
    configuration, traffic mix and limits read from their files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bench_dir = root / BENCH_DIR.name
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=json.loads((root / config_entry["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{workload}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], workload),
        per_layer=_for_cell(bench["per_layer"], workload),
    )


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: "object"  # torch.device
    t_start: float  # time.monotonic() at process start
    control: Optional[str] = None  # "tf32": the reference in the program's place
    rate: Optional[float] = None  # serve: offered rate instead of the cell's (the knee sweep)
    log: Callable[[str], None] = lambda line: print(line, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    stats: Dict  # what the metric readers read
    numbers: Dict[str, float]  # what the check compares with the limits
    memory_peak_bytes: int
    trace: "object" = None  # trace.TraceSummary of the traced span


def read_metric(name: str, run: types.SimpleNamespace) -> Optional[float]:
    """The reader `metrics/<name>.py`'s ``read(run)``: a number, or None
    when the run holds nothing for it."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def _finite(x: Optional[float]) -> Optional[float]:
    return None if x is None else (x if math.isfinite(x) else 1e300)


def execute(ctx: Context) -> Dict:
    """Run the cell once and return its result object (the last line)."""
    import torch

    from pb import check

    kind = importlib.import_module(f"pb.kinds.{ctx.cell.traffic['kind']}")
    out: Outcome = kind.run(ctx)
    run = types.SimpleNamespace(
        stats=out.stats,
        trace=out.trace,
        device_name=torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
    )
    metrics = {}
    for m in ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end:
        value = read_metric(m["name"], run)
        if value is None:
            if not ctx.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ok, table = check.verdict(out.numbers, ctx.cell.limits)
    device = {
        "platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
        "kind": run.device_name,
        "count": ctx.cell.chips,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    result = {"correct": bool(ok), "attempted": int(out.attempted), "failed": int(out.failed), "metrics": metrics, "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]} for k, v in table.items()}
    return result


def set_cache_dirs(root: pathlib.Path = ROOT) -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    port's own `basic_pitch_torch/build/` is there already)."""
    cache = root / BENCH_DIR.name / ".cache"
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def main(argv: List[str], t_start: float) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", choices=("tf32",), default=None,
                        help="put the reference, in TF32, in the program's place (the control of the check)")
    parser.add_argument("--rate", type=float, default=None, help="serve cells: offer this rate (the knee sweep)")
    args = parser.parse_args(argv)

    set_cache_dirs()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(
            f"no result: the cell needs {cell.chips} CUDA device(s); "
            f"available={torch.cuda.is_available()} count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 3
    ctx = Context(
        cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda:0"), t_start=t_start, control=args.control, rate=args.rate,
    )
    result = execute(ctx)
    found = forbidden_modules()
    if found:
        print(f"no result: modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
