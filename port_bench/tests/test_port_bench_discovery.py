"""Every cell's files are found by name, every metric has its reader, and
a cell of a kind the harness has never seen runs from new files only."""

import copy
import hashlib
import importlib
import json
import pathlib
import sys
import time
import types

import pytest
import torch

import pb.kinds
from pb import bench

BENCHMARK = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
READERS = sorted(p.name[: -len(".py")] for p in (bench.BENCH_DIR / "metrics").glob("*.py"))


def check_cell(cell: bench.Cell) -> None:
    """The cell's kind is a module `pb/kinds/<kind>.py` with ``run`` and
    ``tiny`` (whose cut names its test run's seconds), and its limits and
    metrics are there."""
    kind = cell.traffic["kind"]
    assert any((pathlib.Path(d) / f"{kind}.py").exists() for d in pb.kinds.__path__)
    module = importlib.import_module(f"pb.kinds.{kind}")
    assert callable(module.run) and callable(module.tiny)
    assert module.tiny(copy.deepcopy(cell)).traffic["test_seconds"] > 0
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found_by_name(workload):
    check_cell(bench.load_cell(workload))


def test_every_metric_has_a_reader():
    assert set(METRICS) <= set(READERS)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_nothing_from_an_empty_run(name):
    run = types.SimpleNamespace(stats={"kind": "none"}, trace=None, device_name="cpu")
    assert bench.read_metric(name, run) is None


@pytest.mark.parametrize(
    "stats, expected",
    [
        ({"kind": "offline", "setup_s": 17.0, "window_s": 51.3, "audio_s": 96431.7, "windows": 40000, "traced_decodes": []}, 96431.7 / 51.3),
        ({"kind": "train", "setup_s": 22.0, "windows": 32000, "window_s": 51.0}, None),
        ({"kind": "serve", "setup_s": 20.0, "latencies_s": [0.2, 0.3], "requests": 2, "batches": 1}, None),
        ({"kind": "other", "setup_s": 1.0, "window_s": 2.0}, None),
    ],
    ids=["offline", "train", "serve", "window-without-audio"],
)
def test_audio_s_per_s_reads_what_the_run_measured(stats, expected):
    """The reading of each existing kind's stats is the one it always was."""
    run = types.SimpleNamespace(stats=stats, trace=None, device_name="cpu")
    assert bench.read_metric("audio_s_per_s", run) == expected


def test_configs_are_under_paths_and_name_their_source():
    for config in BENCHMARK["configs"]:
        path = bench.ROOT / config["file"]
        assert config["file"].startswith(BENCHMARK["paths"][0] + "/") and path.exists()
        data = json.loads(path.read_text())
        assert data["name"] == config["name"] and data["source"] == config["source"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        bench.load_cell("no.such-cell")


OTHER_KIND = "routed_elsewhere"
OTHER_KIND_SOURCE = f'''"""A kind outside the benchmark: its run reports audio and a window."""

from pb import bench


def run(ctx):
    stats = {{"kind": "{OTHER_KIND}", "setup_s": 0.25, "audio_s": 96.0, "window_s": 2.0}}
    return bench.Outcome(attempted=4, failed=0, stats=stats, numbers={{"token_gap": 0.5}}, memory_peak_bytes=0)


def tiny(cell):
    cell.traffic["test_seconds"] = 1.0
    return cell
'''


def _bench_files() -> dict:
    skip = {"__pycache__", ".cache"}
    return {
        str(p.relative_to(bench.BENCH_DIR)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(bench.BENCH_DIR.rglob("*")) if p.is_file() and not skip & set(p.parts)
    }


@pytest.fixture
def other_kind(tmp_path, monkeypatch):
    """A kind module written outside `port_bench/`, on `pb.kinds`' path."""
    kinds = tmp_path / "kinds"
    kinds.mkdir()
    (kinds / f"{OTHER_KIND}.py").write_text(OTHER_KIND_SOURCE)
    monkeypatch.setattr(pb.kinds, "__path__", [*pb.kinds.__path__, str(kinds)])
    yield OTHER_KIND
    sys.modules.pop(f"pb.kinds.{OTHER_KIND}", None)
    if hasattr(pb.kinds, OTHER_KIND):
        delattr(pb.kinds, OTHER_KIND)


def test_a_new_kind_runs_from_new_files_only(tmp_path, other_kind):
    before = _bench_files()
    root = tmp_path / "checkout"
    files = {
        "port_bench/configs/other-model.json": {"name": "other-model", "source": "https://example.org/other-model"},
        "port_bench/traffic/other-mix.json": {"kind": other_kind},
        "port_bench/limits/other.cell.json": {"token_gap": 1.0},
        "BENCHMARK.json": {
            "configs": [{"name": "other-model", "file": "port_bench/configs/other-model.json"}],
            "workloads": [{"name": "other.cell", "config": "other-model", "traffic": "other-mix", "chips": 1}],
            "end_to_end": [
                {"name": "audio_s_per_s", "unit": "audio-s/s", "workloads": ["other.cell"]},
                {"name": "setup_s", "unit": "s"},
            ],
            "per_layer": [{"name": f"device_idle_pct.{other_kind}", "unit": "%", "workloads": ["other.cell"]}],
        },
    }
    for name, data in files.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_text(json.dumps(data))

    cell = bench.load_cell("other.cell", root=root)
    check_cell(cell)
    cut = importlib.import_module(f"pb.kinds.{other_kind}").tiny(cell)
    ctx = bench.Context(cell=cut, seed=1, seconds=cut.traffic["test_seconds"], trace=False,
                        device=torch.device("cpu"), t_start=time.monotonic())
    result = bench.execute(ctx)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"] == {"audio_s_per_s": {"value": 48.0, "unit": "audio-s/s"}, "setup_s": {"value": 0.25, "unit": "s"}}
    assert _bench_files() == before
