"""A run's result line, the trace reduction and the refusals, on the CPU."""

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from cells import execute
from pb import bench, trace


def test_last_line_keys_and_order():
    result = execute("nmp.offline-mixed")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(row) == {"value", "limit"} for row in result["checks"].values())
    json.dumps(result)


def test_traced_line_has_the_device_window_and_breakdown():
    result = execute("nmp.offline-dense", seconds=1.0, trace=True)
    assert "audio_s_per_s" not in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"]) and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


def _event(name, lo, hi, cuda=False, annotation=False):
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=lo, end=hi), device_type=dev, is_user_annotation=annotation)


def test_trace_summary_busy_idle_and_gaps():
    events = [
        _event(trace.WINDOW_SPAN, 0, 1000),
        _event("bench.transcribe_batch", 0, 600),
        _event("bench.upload", 500, 700),
        _event("greedy_decode_kernel", 100, 200, cuda=True),
        _event("conv", 150, 300, cuda=True),
        _event("conv", 650, 800, cuda=True),
        _event("bench.transcribe_batch", 100, 600, cuda=True, annotation=True),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1e-3) and s.busy_s == pytest.approx(350e-6)
    assert s.kernel_s == pytest.approx({"greedy_decode_kernel": 100e-6, "conv": 300e-6})
    assert s.device_seconds("greedy_decode") == (pytest.approx(100e-6), 1)
    # gaps: 0-100 and 300-650 under transcribe_batch (mid 475), 800-1000 under none
    assert s.gaps_s == pytest.approx({"bench.transcribe_batch": 450e-6, "outside bench spans": 200e-6})
    b = s.breakdown()
    assert b["device_ops"][0] == ["conv", pytest.approx(300e-6)]


def test_no_result_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(bench.BENCH_DIR / "run.py"), "--workload", "nmp.offline-mixed", "--seed", "1", "--seconds", "1"],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.BENCH_DIR, tmp_path / bench.BENCH_DIR.name, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "nmp.offline-mixed", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
