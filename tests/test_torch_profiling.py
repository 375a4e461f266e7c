"""PyTorch port: `basic_pitch_torch/utils/profiling.py` on the CPU.

`trace` writes a Chrome/Perfetto trace that holds a `span` region and the
ops run inside it, and the recorder's spans beside it. The recorder: off,
a span opens no profiler range and nothing is kept; under a profiler, spans
nest with parent and request ids and self times (on a scripted clock), are
kept from every thread, agree with the profiler's own events, and are
bounded; counters count only while tracing. Then the program's spans: a
traced `transcribe_batch`, `train_step` and HTTP request give their span
trees and counters and the same results as untraced calls.
`device_memory_stats` gives ``{}`` for the CPU and raises with no device and
no GPU.
"""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_port_helpers import one_torch_thread, tone_mix  # noqa: F401

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch import serve
from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.ops import resample as t_resample
from basic_pitch_torch.train import loop as t_loop
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_torch.utils import profiling

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _tree(spans):
    """{span id: span} and {parent id: [child names]}."""
    by_id = {s.id: s for s in spans}
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s.name)
    return by_id, children


def test_trace_writes_an_annotated_region(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(tmp_path / "trace"):
        with profiling.span("bp.matmul_region"):
            y = x @ x
            profiling.count("matmuls", 1)
        z = y.sum()
    assert float(z) == float(z)
    path = tmp_path / "trace" / profiling.TRACE_NAME
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert "bp.matmul_region" in names
    region = next(e for e in events if e.get("name") == "bp.matmul_region")
    inside = [e for e in events if e.get("name") == "aten::mm"]
    assert inside and all(region["ts"] <= e["ts"] <= region["ts"] + region["dur"] for e in inside)
    kept = json.loads((tmp_path / "trace" / profiling.SPANS_NAME).read_text())
    assert [s["name"] for s in kept["spans"]] == ["bp.matmul_region"]
    assert region["cat"] == "cpu_op"  # `record_function`'s C++ form
    assert kept["counters"] == {"matmuls": 1} and kept["dropped"] == 0
    assert kept["summary"]["bp.matmul_region"]["count"] == 1
    assert kept["trace_start_ns"] <= kept["spans"][0]["start_ns"] < kept["spans"][0]["end_ns"]


def test_trace_on_the_cpu_records_no_cuda_activity(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.trace(tmp_path):
        torch.ones(8).add_(1)
    events = json.loads((tmp_path / profiling.TRACE_NAME).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
    assert not any(str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy") for e in events)


def test_tracing_off_opens_no_range_and_keeps_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened with tracing off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("bp.off", request=7, note="x") as got:
        with profiling.span("bp.off.child"):
            profiling.count("off", 3)
    profiling.record("bp.off.wait", 0.5, None)
    assert got is None and profiling.current() is None and profiling.new_request() is None
    assert profiling.spans() == []
    assert profiling.summary() == {"spans": {}, "counters": {}, "dropped": 0}


def test_spans_nest_with_parents_requests_and_self_time(monkeypatch):
    """On a clock that reads 0, 10, 20, ... ns: a parent with two children,
    one of which has a child, then a span given its own request."""
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=lambda: next(ticks)))
    with profile(activities=CPU):
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.span("bp.a", size=3) as a:  # 0 .. 70
            with profiling.span("bp.b"):  # 10 .. 40
                with profiling.span("bp.c"):  # 20 .. 30
                    pass
            with profiling.span("bp.b"):  # 50 .. 60
                assert profiling.current().name == "bp.b"
        request = profiling.new_request()
        with profiling.span("bp.d", request=request):  # 80 .. 90
            pass
    spans = {(s.name, s.start_ns): s for s in profiling.spans()}
    assert [(s.name, s.start_ns, s.end_ns) for s in profiling.spans()] == [
        ("bp.c", 20, 30), ("bp.b", 10, 40), ("bp.b", 50, 60), ("bp.a", 0, 70), ("bp.d", 80, 90)]
    assert a.parent is None and a.attrs == {"size": 3}
    assert spans[("bp.b", 10)].parent == a.id and spans[("bp.b", 50)].parent == a.id
    assert spans[("bp.c", 20)].parent == spans[("bp.b", 10)].id
    assert {s.request for s in profiling.spans() if s.name != "bp.d"} == {a.request}
    assert spans[("bp.d", 80)].request == request != a.request
    got = profiling.summary()["spans"]
    assert got["bp.a"] == {"count": 1, "total_s": pytest.approx(70e-9), "self_s": pytest.approx(30e-9)}
    assert got["bp.b"] == {"count": 2, "total_s": pytest.approx(40e-9), "self_s": pytest.approx(30e-9)}
    assert got["bp.c"] == {"count": 1, "total_s": pytest.approx(10e-9), "self_s": pytest.approx(10e-9)}
    assert profiling.current() is None


def test_spans_of_other_threads_are_kept_and_not_their_parents_self_time():
    """A thread started inside a profile records (the profiler's thread-local
    state says off there); a span begun on one thread and closed on another
    (`record`) is its opener's child and counts in its self time only on
    the opener's thread."""
    seen = {}

    def worker(opener):
        time.sleep(0.005)  # the recorded 1 ms lies inside the opener's span
        seen["local"] = torch.autograd._profiler_enabled()
        with profiling.span("bp.worker") as w:
            seen["worker"] = w
        profiling.record("bp.waited", 0.001, opener)

    with profile(activities=CPU):
        with profiling.span("bp.main") as main:
            thread = threading.Thread(target=worker, args=(main,))
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    assert seen["local"] is False
    worker_span, waited = seen["worker"], profiling.spans("bp.waited")[0]
    assert worker_span.thread != main.thread and worker_span.parent is None
    assert worker_span.request != main.request
    assert (waited.parent, waited.thread, waited.request) == (main.id, main.thread, main.request)
    assert waited.end_ns - waited.start_ns == 1_000_000
    got = profiling.summary()["spans"]
    assert got["bp.main"]["self_s"] == pytest.approx(got["bp.main"]["total_s"] - 1e-3, abs=1e-9)


def test_counters_count_only_while_tracing():
    profiling.count("c", 5)
    with profile(activities=CPU):
        profiling.count("c", 2)
        profiling.count("c")
        profiling.count("d", 0.5)
    profiling.count("c", 100)
    assert profiling.summary()["counters"] == {"c": 3, "d": 0.5}


def test_the_recorder_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "max_spans", 5)
    with profile(activities=CPU):
        for _ in range(8):
            with profiling.span("bp.many"):
                profiling.count("n")
    got = profiling.summary()
    assert len(profiling.spans()) == 5 and got["dropped"] == 3
    assert got["spans"]["bp.many"]["count"] == 5 and got["counters"] == {"n": 8}


def _worst_disagreement_us(n=20):
    """The largest gap, in us, between a span's start or end in the recorder
    and in `prof.events()` over ``n`` spans."""
    profiling.reset()
    x = torch.randn(32, 32)
    with profile(activities=CPU) as prof:
        for i in range(n):
            with profiling.span(f"bp.agree.{i}"):
                x = torch.tanh(x @ x)
    start = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("bp.agree.")}
    assert len(events) == n == len(profiling.spans())
    return max(
        max(abs((s.start_ns - start) / 1e3 - events[s.name].time_range.start),
            abs((s.end_ns - start) / 1e3 - events[s.name].time_range.end))
        for s in profiling.spans()
    )


def test_recorder_and_profiler_events_agree():
    """Each span's start and end in the recorder and in `prof.events()`
    agree within 0.1 ms (both on the Unix-epoch clock the profiler's event
    times count from). The two readings are microseconds apart, so only the
    scheduler taking the core between them can part them: a clock that
    disagrees fails every one of three tries, a preempted try does not
    fail the test."""
    tries = []
    for _ in range(3):
        tries.append(_worst_disagreement_us())
        if tries[-1] < 100.0:
            break
    assert tries[-1] < 100.0, tries


def _windows(n_samples, sr):
    """The model windows a recording needs: ceil((L + 3840) / 36164) for L
    samples at 22.05 kHz."""
    length = t_resample.decimate2_output_length(n_samples) if sr == 44100 else n_samples
    return -(-(length + 3840) // 36164)


def test_traced_transcribe_batch_gives_the_span_tree_per_recording():
    w = 2
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=w, device="cpu", pcm_transport="raw")
    a = (tone_mix(22050, seconds=72328 / 22050) * 32767).astype(np.int16)  # 3 windows: 2 chunks
    b = (tone_mix(44100, seconds=1.0, seed=1) * 32767).astype(np.int16)  # 1 window: 1 chunk
    recordings = [(a, 22050), (b, 44100)]
    needed = [_windows(len(a), 22050), _windows(len(b), 44100)]
    assert needed == [3, 1]
    want = tr.transcribe_batch(recordings, return_model_outputs=True)
    assert profiling.spans() == []
    with profile(activities=CPU):
        got = tr.transcribe_batch(recordings, return_model_outputs=True)
    assert [g[0] for g in got] == [x[0] for x in want]
    for g, x in zip(got, want):
        assert all(np.array_equal(g[1][k], x[1][k]) for k in x[1])
    summary = profiling.summary()
    # packed: a's three windows and b's one fill two shared chunks, the
    # second holding windows of both; the assembly counts each recording's
    # events and their bend frames
    events = [e for g in got for e in g[0]]
    assert summary["counters"] == {
        "transcriber.windows_needed": 4, "transcriber.windows_run": 2 * w, "transcriber.chunks_shared": 1,
        "transcriber.notes_assembled": len(events),
        "transcriber.bend_frames_assembled": sum(len(e[4]) for e in events),
        "transcriber.long_note_columns": 0}
    spans = profiling.spans()
    by_id, children = _tree(spans)
    (batch,) = profiling.spans("bp.transcriber.batch")
    forwards = profiling.spans("bp.transcriber.forward")
    assert [f.parent for f in forwards] == [batch.id] * 2
    assert len({f.request for f in forwards} | {batch.request}) == 3
    # the one model call (k * w = 4 windows) runs once b's window is in, so
    # it belongs to b's forward
    for forward, n_chunks, n_models in zip(forwards, (2, 1), (0, 1)):
        mine = [s for s in spans if s.request == forward.request]
        assert sorted(s.name for s in mine) == sorted(
            ["bp.transcriber.forward", "bp.decode.dispatch", "bp.transcriber.fetch", "bp.transcriber.assemble",
             "bp.transcriber.fetch"] + ["bp.transcriber.model"] * n_models + ["bp.transcriber.upload"] * n_chunks)
        assert sorted(children[forward.id]) == ["bp.transcriber.model"] * n_models + ["bp.transcriber.upload"] * n_chunks
        (assemble,) = [s for s in mine if s.name == "bp.transcriber.assemble"]
        assert children[assemble.id] == ["bp.transcriber.fetch"]  # the posteriorgrams
        assert {by_id[s.parent].name for s in mine if s.name in ("bp.decode.dispatch", "bp.transcriber.fetch")} == {
            "bp.transcriber.batch", "bp.transcriber.assemble"}
    # the note counts: one fetch for the call, under the batch's own request
    assert [s.name for s in spans if s.request == batch.request] == ["bp.transcriber.fetch", "bp.transcriber.batch"]
    rows = summary["spans"]
    assert rows["bp.transcriber.batch"]["count"] == 1 and rows["bp.transcriber.fetch"]["count"] == 5
    parts = (rows["bp.transcriber.forward"]["total_s"] + rows["bp.decode.dispatch"]["total_s"]
             + rows["bp.transcriber.fetch"]["total_s"] + rows["bp.transcriber.assemble"]["self_s"])
    assert parts <= rows["bp.transcriber.batch"]["total_s"]


NARROW = dict(n_harmonics=2, n_filters_contour=4, n_filters_notes=4, n_filters_onsets=4)


def _train_batch(seed, b=2):
    rng = np.random.RandomState(seed)
    return {
        "audio": (rng.randn(b, 43844) * 0.1).astype(np.float32),
        "targets": {
            "contour": (rng.rand(b, 172, 264) > 0.9).astype(np.float32),
            "note": (rng.rand(b, 172, 88) > 0.9).astype(np.float32),
            "onset": (rng.rand(b, 172, 88) > 0.97).astype(np.float32),
        },
    }


def test_traced_train_step_splits_forward_backward_update():
    config = t_loop.TrainConfig()
    host = _train_batch(3)
    states = []
    for traced in (False, True):
        model = t_nmp.init_params(t_nmp.NMP(t_nmp.ModelConfig(**NARROW)), torch.Generator().manual_seed(0))
        opt = t_loop.make_optimizer(model, config)
        with profile(activities=CPU) if traced else torch.no_grad():
            batch, _ = t_loop.upload_batch(host, torch.device("cpu"))
        with profile(activities=CPU) if traced else torch.enable_grad():
            loss = t_loop.train_step(model, opt, batch, config)["loss"]
        states.append((model.state_dict(), opt.state_dict()["state"], float(loss)))
    (want, want_adam, want_loss), (got, got_adam, got_loss) = states
    assert got_loss == want_loss
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(got_adam[i][k], want_adam[i][k]) for i in want_adam for k in want_adam[i])
    (upload,) = profiling.spans("bp.train.upload")
    (step,) = profiling.spans("bp.train.step")
    by_id, children = _tree(profiling.spans())
    assert children[step.id] == ["bp.train.forward", "bp.train.backward", "bp.train.update"]
    assert {s.request for s in profiling.spans() if s.name != "bp.train.upload"} == {step.request}
    assert upload.parent is None and upload.request != step.request
    rows = profiling.summary()["spans"]
    assert rows["bp.train.step"]["self_s"] < rows["bp.train.step"]["total_s"]


class _Quick:
    """A transcriber that answers at once with no events."""

    def transcribe_batch(self, recordings, **params):
        return [[] for _ in recordings]


def test_traced_service_request_has_request_queue_wait_and_dispatch():
    service = serve.TranscriptionService(_Quick(), max_batch=4, max_wait_ms=20.0)
    srv = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    import io

    buf = io.BytesIO()
    t_audio.write_wav(buf, tone_mix(22050, seconds=0.5), 22050)
    try:
        assert service.snapshot_metrics()["queue_wait_seconds"] == 0.0
        with profile(activities=CPU):
            req = urllib.request.Request(f"http://{host}:{port}/v1/transcribe", data=buf.getvalue())
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
        metrics = service.snapshot_metrics()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        service.close()
    assert not thread.is_alive()
    (request,) = profiling.spans("bp.serve.request")
    (wait,) = profiling.spans("bp.serve.queue_wait")
    (dispatch,) = profiling.spans("bp.serve.dispatch")
    assert request.request == wait.request == dispatch.request
    assert wait.parent == request.id and wait.thread == request.thread
    assert dispatch.thread != request.thread and dispatch.attrs == {"requests": [request.request]}
    assert request.start_ns <= wait.start_ns < wait.end_ns <= dispatch.start_ns < dispatch.end_ns <= request.end_ns
    # the group waited out the 20 ms gather window for more requests
    assert metrics["requests"] == 1 and metrics["queue_wait_seconds"] >= 0.02
    assert (wait.end_ns - wait.start_ns) * 1e-9 == pytest.approx(metrics["queue_wait_seconds"], abs=1e-6)


def test_device_memory_stats_cpu_and_no_gpu(monkeypatch):
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    assert profiling.device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_stats()
