"""Every cell's files are found by name, and every metric has its reader."""

import json
import types

import pytest

from pb import bench

BENCHMARK = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
READERS = sorted(p.name[: -len(".py")] for p in (bench.BENCH_DIR / "metrics").glob("*.py"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found_by_name(workload):
    cell = bench.load_cell(workload)
    assert cell.traffic["kind"] in ("offline", "serve", "train")
    assert (bench.BENCH_DIR / "pb" / "kinds" / f"{cell.traffic['kind']}.py").exists()
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_every_metric_has_a_reader():
    assert set(METRICS) <= set(READERS)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_nothing_from_an_empty_run(name):
    run = types.SimpleNamespace(stats={"kind": "none"}, trace=None, device_name="cpu")
    assert bench.read_metric(name, run) is None


def test_configs_are_under_paths_and_name_their_source():
    for config in BENCHMARK["configs"]:
        path = bench.ROOT / config["file"]
        assert config["file"].startswith(BENCHMARK["paths"][0] + "/") and path.exists()
        data = json.loads(path.read_text())
        assert data["name"] == config["name"] and data["source"] == config["source"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        bench.load_cell("no.such-cell")
