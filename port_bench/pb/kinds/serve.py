"""HTTP serving under open-loop Poisson load.

Set-up starts the load generator (`pb/loadgen.py`, a process of its own,
which makes the pool's WAV bodies from the seed), builds the transcriber
with the configuration's settings, a `serve.TranscriptionService` with the
traffic file's ``server`` settings and `serve.make_server` on 127.0.0.1
at a free port in this process, and lets the generator warm the server up
with a burst of ``server.max_batch`` requests and a lone one. The window
then offers requests at the cell's rate for ``seconds`` (a traced run
offers load on past the window and traces ``pb.bench.TRACE_SECONDS`` of
it); each
request's latency runs from its due time to the last byte of its
response, and every answer is waited for.

A 503 (shed), a 504 (timeout) or a connection error counts as failed; any
other status but 200 is an answer that says the wrong thing. The check
takes a sample of the answered requests, drawn from the seed with the
longest clip in it, and holds each response's events against the frozen
reference decoder on the float64 reference's posteriorgrams of the same
samples.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading
import time
from typing import Dict, List

import numpy as np

from pb import bench, check, traffic
from pb import trace as tracing
from pb.kinds.offline import ControlTranscriber, make_transcriber, tiny_recordings
from reference import nmp as ref_nmp

WAIT_S = 60.0  # an answer is waited for this long past the last due time
LOAD_FAILURES = (503, 504, -1)
PROFILER_START_S = 15.0


class Spanned:
    """The transcriber as the service sees it, its batch calls inside a
    ``bench.transcribe_batch`` span; every other attribute is the
    transcriber's own."""

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)

    def transcribe_batch(self, *args, **kwargs):
        with tracing.span("bench.transcribe_batch"):
            return self._inner.transcribe_batch(*args, **kwargs)


def events_of(body: str) -> List[tuple]:
    notes = json.loads(body)["notes"]
    return [(n["start_time_s"], n["end_time_s"], n["pitch_midi"], n["amplitude"], n["pitch_bends"]) for n in notes]


def percentile(values: List[float], q: float) -> float:
    """The q-quantile (0..1) by linear interpolation, numpy's default."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def run(ctx: "bench.Context") -> "bench.Outcome":
    import torch

    from basic_pitch_torch import serve

    spec, config = ctx.cell.traffic, ctx.cell.config
    rate = float(ctx.rate or spec["rate_per_s"])
    if ctx.control:
        return control(ctx)
    # a traced run offers load on past the window while the profiler starts
    # (CUPTI's start takes seconds) and for the traced span
    span_s = ctx.seconds + (bench.TRACE_SECONDS + PROFILER_START_S if ctx.trace else 0.0)
    server_cfg = spec["server"]
    transcriber = make_transcriber(config, ctx.device)
    service = serve.TranscriptionService(
        Spanned(transcriber), max_batch=server_cfg["max_batch"], max_wait_ms=server_cfg["max_wait_ms"], max_queue=server_cfg["max_queue"]
    )
    submit = service.submit

    def spanned_submit(*args, **kwargs):
        with tracing.span("bench.submit"):
            return submit(*args, **kwargs)

    service.submit = spanned_submit
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, name="bench-http", daemon=True)
    thread.start()
    settings = {
        "port": server.server_address[1], "seed": ctx.seed, "spec": spec, "rate": rate,
        "window": ctx.seconds, "seconds": span_s, "wait_s": WAIT_S, "warmup": server_cfg["max_batch"],
    }
    gen = subprocess.Popen(
        [sys.executable, str(bench.BENCH_DIR / "pb" / "loadgen.py"), json.dumps(settings)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
    )
    tracer = tracing.Tracer(ctx.trace, ctx.device)
    try:
        ready = json.loads(gen.stdout.readline())
        ctx.log(f"load generator ready: {ready}")
        before = service.snapshot_metrics()
        t0 = time.monotonic() + 0.05
        setup_s = t0 - ctx.t_start
        gen.stdin.write(f"go {t0!r}\n")
        gen.stdin.flush()
        after = None
        if tracer.enabled:
            time.sleep(max(0.0, t0 + ctx.seconds - time.monotonic()))
            after = service.snapshot_metrics()
            with tracer.span():
                with tracing.span("bench.serve_window"):
                    ctx.log(f"traced span starts {time.monotonic() - t0 - ctx.seconds:.1f} s after the window")
                    time.sleep(bench.TRACE_SECONDS)
        rows = []
        for line in gen.stdout:
            row = json.loads(line)
            if row.get("done"):
                break
            rows.append(row)
        gen.wait(timeout=30)
        after = after or service.snapshot_metrics()
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del transcriber, service
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    window = [r for r in rows if r["due"] < t0 + ctx.seconds]
    horizon = ctx.seconds + WAIT_S  # a request that never answers ranks here
    latencies = sorted(
        (r["end"] - r["due"]) if r["status"] == 200 else horizon for r in window
    )
    late = [r["sent"] - r["due"] for r in window]
    ok = [r for r in window if r["status"] == 200]
    failed = [r for r in window if r["status"] in LOAD_FAILURES]
    ctx.log(
        f"rate {rate} req/s: {len(window)} offered, {len(ok)} answered, {len(failed)} failed "
        f"(statuses {sorted(set(r['status'] for r in window))}); generator late p50 {percentile(late, 0.5) * 1e3:.2f} ms, "
        f"max {max(late) * 1e3:.2f} ms; latency p50 {percentile(latencies, 0.5) * 1e3:.1f} ms, "
        f"p95 {percentile(latencies, 0.95) * 1e3:.1f} ms; first third p50 "
        f"{percentile(latencies[: max(1, len(window) // 3)], 0.5) * 1e3:.1f}"
    )
    thirds = [[(r["end"] - r["due"]) if r["status"] == 200 else horizon for r in window[k * len(window) // 3 : (k + 1) * len(window) // 3]] for k in range(3)]
    ctx.log("latency p50 by third of the window (ms): " + ", ".join(f"{percentile(t, 0.5) * 1e3:.1f}" if t else "-" for t in thirds))
    numbers = compare(ctx, [r for r in rows if r["status"] == 200])
    numbers["error_answers"] = float(sum(1 for r in rows if r["status"] not in (200,) + LOAD_FAILURES))
    stats = {
        "kind": "serve",
        "setup_s": setup_s,
        "latencies_s": [(r["end"] - r["due"]) if r["status"] == 200 else horizon for r in window],
        "requests": after["requests"] - before["requests"],
        "batches": after["batches"] - before["batches"],
    }
    return bench.Outcome(
        attempted=len(window), failed=len(failed), stats=stats, numbers=numbers,
        memory_peak_bytes=memory_peak, trace=tracer.summary,
    )


def _sample(seed: int, spec: Dict, clips: List[int]) -> List[int]:
    """Up to ``check_sample`` distinct clips from ``clips``, drawn from the
    seed, with the longest first."""
    plan = {p["index"]: p for p in traffic.recording_plan(spec)}
    distinct = sorted(set(clips))
    if not distinct:
        return []
    longest = max(distinct, key=lambda c: plan[c]["samples"])
    others = [c for c in distinct if c != longest]
    picks = traffic.rng(seed, 8).permutation(len(others))[: int(spec["check_sample"]) - 1]
    return [longest] + [others[i] for i in picks]


def _reference(ctx, clips: List[int]):
    import torch

    audio = {p["index"]: a for p, a in traffic.recordings(ctx.seed, ctx.cell.traffic, only=set(clips)) if a is not None}
    ref = ref_nmp.Reference(ctx.device, torch.float64)
    params = ref_nmp.load_weights(str(bench.ROOT / ctx.cell.config["weights"]), ctx.device, torch.float64)
    options = {**check.DECODE_DEFAULTS, **ctx.cell.config["decode"]}
    sr = int(ctx.cell.traffic["sample_rate"])
    return audio, {c: check.reference_events(ref.posteriorgrams(params, audio[c], sr), options) for c in clips}


def _numbers(pairs) -> Dict[str, float]:
    numbers = {"served_unmatched_share": 0.0, "served_amp_gap": 0.0}
    for served, expected in pairs:
        cmp = check.compare_events(served, expected)
        numbers["served_unmatched_share"] = max(numbers["served_unmatched_share"], cmp["unmatched_share"])
        numbers["served_amp_gap"] = max(numbers["served_amp_gap"], cmp["amp_gap"])
    return numbers


def compare(ctx, answered: List[Dict]) -> Dict[str, float]:
    """The sampled answers against the reference (see the module's doc)."""
    t = time.monotonic()
    clips = _sample(ctx.seed, ctx.cell.traffic, [r["clip"] for r in answered])
    _, expected = _reference(ctx, clips)
    # each sampled clip's first answer
    first = {}
    for r in answered:
        first.setdefault(r["clip"], r)
    numbers = _numbers((events_of(first[c]["body"]), expected[c]) for c in clips)
    numbers["no_answer_sampled"] = 0.0 if clips else 1.0
    ctx.log(f"check of {len(clips)} answers took {time.monotonic() - t:.1f} s")
    return numbers


def control(ctx) -> "bench.Outcome":
    """The reference in TF32 in the program's place, on the clips the
    window would offer first."""
    plan = traffic.schedule(ctx.cell.traffic, float(ctx.rate or ctx.cell.traffic["rate_per_s"]), ctx.seconds)
    clips = _sample(ctx.seed, ctx.cell.traffic, [c for _, c in plan])
    audio, expected = _reference(ctx, clips)
    stand_in = ControlTranscriber(ctx.cell.config, ctx.device)
    sr = int(ctx.cell.traffic["sample_rate"])
    served = {c: stand_in.transcribe_batch([(audio[c], sr)])[0] for c in clips}
    numbers = _numbers((served[c], expected[c]) for c in clips)
    numbers["no_answer_sampled"] = 0.0 if clips else 1.0
    numbers["error_answers"] = 0.0
    return bench.Outcome(attempted=len(clips), failed=0, stats={"kind": "serve", "setup_s": 0.0, "latencies_s": [0.0], "requests": 0, "batches": 0},
                         numbers=numbers, memory_peak_bytes=0)


def tiny(cell: "bench.Cell") -> "bench.Cell":
    """The cell cut to a size a CPU test run holds (see the offline kind's
    ``tiny``), at a low rate and small server batches, over a window
    long enough for its load to arrive."""
    tiny_recordings(cell)
    cell.traffic.update(rate_per_s=1.5, test_seconds=3.0)
    cell.traffic["server"]["max_batch"] = 2
    return cell
