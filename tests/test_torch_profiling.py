"""PyTorch port: `basic_pitch_torch/utils/profiling.py` on the CPU.

`trace` writes a Chrome/Perfetto trace that holds an `annotate` region and
the ops run inside it; `Timers` is a copy of the JAX package's, held equal
on one scripted clock; `device_memory_stats` gives ``{}`` for the CPU and
raises with no device and no GPU.
"""

import json

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

from basic_pitch_torch.utils import profiling
from basic_pitch_tpu.utils import profiling as j_profiling


def test_trace_writes_an_annotated_region(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("bp/matmul_region"):
            y = x @ x
        z = y.sum()
    assert float(z) == float(z)
    path = tmp_path / "trace" / profiling.TRACE_NAME
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert "bp/matmul_region" in names
    region = next(e for e in events if e.get("name") == "bp/matmul_region")
    inside = [e for e in events if e.get("name") == "aten::mm"]
    assert inside and all(region["ts"] <= e["ts"] <= region["ts"] + region["dur"] for e in inside)
    assert region["cat"] == "user_annotation"


def test_trace_on_the_cpu_records_no_cuda_activity(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.trace(tmp_path):
        torch.ones(8).add_(1)
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
    assert not any(str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy") for e in events)


def _scripted_timers(module, monkeypatch):
    """Timers of ``module`` on a clock that advances 0.25 s, 0.5 s, ... per
    reading, so two copies can be compared exactly."""
    ticks = iter(i * i * 0.125 for i in range(100))
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
    timers = module.Timers()
    for name in ("decode", "model", "decode", "upload", "model", "model"):
        with timers(name):
            pass
    return timers


def test_timers_summary_and_report_equal_jax(monkeypatch):
    got = _scripted_timers(profiling, monkeypatch)
    want = _scripted_timers(j_profiling, monkeypatch)
    assert got.summary() == want.summary()
    assert got.report() == want.report()
    rows = {name: count for name, _, count in got.summary()}
    assert rows == {"decode": 2, "model": 3, "upload": 1}
    assert [r[1] for r in got.summary()] == sorted((r[1] for r in got.summary()), reverse=True)
    got.reset()
    assert got.summary() == [] and got.report().splitlines()[1:] == []


def test_timers_thread_safe():
    import threading

    timers = profiling.Timers()

    def work():
        for _ in range(200):
            with timers("x"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert timers.summary()[0][2] == 1600


def test_device_memory_stats_cpu_and_no_gpu(monkeypatch):
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    assert profiling.device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_stats()
