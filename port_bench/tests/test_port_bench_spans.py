"""The readers of the program's own spans and counters (`pb/spans.py` and
the metrics that use it): what each reads from the recorder of
`basic_pitch_torch.utils.profiling`, over the traced span's wall; nothing
from an untraced run, a run of another kind, or a program without the
recorder."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from basic_pitch_torch.utils import profiling
from pb import bench

OFFLINE = ("window_fill_pct.offline", "host_enqueue_pct.offline", "host_decode_pct.offline",
           "host_fetch_pct.offline", "host_assemble_pct.offline")
TRAIN = ("host_forward_pct.train", "host_backward_pct.train", "host_update_pct.train")
SERVE = ("queue_wait_p95_ms.serve",)


def _run(kind, window_s=1.0):
    return types.SimpleNamespace(stats={"kind": kind}, trace=types.SimpleNamespace(window_s=window_s), device_name="cpu")


@pytest.fixture
def recorded(monkeypatch):
    """A scripted recording: time in ms of a clock that the spans read."""
    profiling.reset()
    now = [0]
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=lambda: now[0]))

    def at(ms):
        now[0] = int(ms * 1e6)

    yield at
    profiling.reset()


def test_offline_readers(recorded):
    at = recorded
    with profile(activities=[ProfilerActivity.CPU]):
        at(0)
        with profiling.span("bp.transcriber.batch"):
            at(10)
            with profiling.span("bp.transcriber.forward"):
                profiling.count("transcriber.windows_needed", 37)
                profiling.count("transcriber.windows_run", 128)
                at(110)
            with profiling.span("bp.decode.dispatch"):
                at(130)
            with profiling.span("bp.transcriber.fetch"):
                at(330)
            with profiling.span("bp.transcriber.assemble"):
                at(340)
                with profiling.span("bp.transcriber.fetch"):
                    at(390)
                at(400)
        at(500)
    got = {name: bench.read_metric(name, _run("offline", window_s=0.5)) for name in OFFLINE}
    assert got == pytest.approx({
        "window_fill_pct.offline": 100 * 37 / 128,
        "host_enqueue_pct.offline": 20.0,  # 100 ms of 500
        "host_decode_pct.offline": 4.0,
        "host_fetch_pct.offline": 50.0,  # 200 + 50 ms
        "host_assemble_pct.offline": 4.0,  # 70 ms less its 50 ms fetch
    })
    assert sum(v for k, v in got.items() if k != "window_fill_pct.offline") <= 100.0
    for name in OFFLINE:
        assert bench.read_metric(name, _run("train", window_s=0.5)) is None


def test_train_readers(recorded):
    at = recorded
    with profile(activities=[ProfilerActivity.CPU]):
        at(0)
        with profiling.span("bp.train.step"):
            with profiling.span("bp.train.forward"):
                at(30)
            with profiling.span("bp.train.backward"):
                at(80)
            with profiling.span("bp.train.update"):
                at(100)
    got = {name: bench.read_metric(name, _run("train", window_s=0.2)) for name in TRAIN}
    assert got == pytest.approx({"host_forward_pct.train": 15.0, "host_backward_pct.train": 25.0,
                                 "host_update_pct.train": 10.0})
    for name in TRAIN:
        assert bench.read_metric(name, _run("offline", window_s=0.2)) is None


def test_queue_wait_p95_is_the_nearest_rank(recorded):
    with profile(activities=[ProfilerActivity.CPU]):
        for ms in range(1, 41):  # 1 .. 40 ms
            profiling.record("bp.serve.queue_wait", ms / 1e3, None)
    assert bench.read_metric("queue_wait_p95_ms.serve", _run("serve")) == pytest.approx(38.0)
    assert bench.read_metric("queue_wait_p95_ms.serve", _run("offline")) is None


@pytest.mark.parametrize("name", OFFLINE + TRAIN + SERVE)
def test_nothing_from_an_untraced_run_or_a_program_without_the_recorder(name, recorded, monkeypatch):
    kind = name.rsplit(".", 1)[1]
    with profile(activities=[ProfilerActivity.CPU]):
        for span in ("bp.transcriber.forward", "bp.decode.dispatch", "bp.transcriber.fetch",
                     "bp.transcriber.assemble", "bp.train.forward", "bp.train.backward", "bp.train.update"):
            with profiling.span(span):
                pass
        profiling.count("transcriber.windows_needed", 1)
        profiling.count("transcriber.windows_run", 2)
        profiling.record("bp.serve.queue_wait", 0.001, None)
    assert bench.read_metric(name, _run(kind)) is not None
    untraced = types.SimpleNamespace(stats={"kind": kind}, trace=None, device_name="cpu")
    assert bench.read_metric(name, untraced) is None
    monkeypatch.delattr(profiling, "summary")
    assert bench.read_metric(name, _run(kind)) is None


def test_an_empty_recorder_reads_nothing():
    profiling.reset()
    for name in OFFLINE + TRAIN + SERVE:
        assert bench.read_metric(name, _run(name.rsplit(".", 1)[1])) is None
    assert torch.autograd.profiler._is_profiler_enabled is False
