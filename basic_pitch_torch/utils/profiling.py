"""Tracing and profiling hooks.

The port's counterpart of `basic_pitch_tpu/utils/profiling.py`: a
`torch.profiler` trace of a region (CPU activity, plus CUDA kernels where a
GPU is present) written as a Chrome/Perfetto trace, the program's spans and
counters on the profiler's clock, and the CUDA caching allocator's
statistics.

Spans and counters. `span(name, **attrs)` marks a region and `count(name,
n)` adds to a counter; `summary()` gives, per span name, the count, the
total and the self time, and the counters. Tracing is on while a torch
profiler records anywhere in the process (`trace` below, a
`torch.profiler.profile` of the caller's, the benchmark's traced run);
nothing else turns it on. Then a span is also a profiler range on the
thread that opens it, beside the kernels it launches, and the recorder
keeps it in memory: name, start and end in Unix-epoch nanoseconds (the
clock the profiler's events count from, `kineto_results.trace_start_ns()`),
parent span, thread, and a request id that every span of one recording,
train step or HTTP request shares. Off, a span costs one check and records
nothing, and counters count nothing. The profiler's callbacks are
thread-local: a span on a thread the profiler does not cover (the
service's dispatch and handler threads) is kept by the recorder but is not
on the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import pathlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

TRACE_NAME = "trace.json"
SPANS_NAME = "spans.json"  # the recorder's spans and counters, beside the trace
MAX_SPANS = 100_000  # spans kept; later ones are counted as dropped

# the profiler range a span opens while tracing (`record_function`'s C++
# form: its clock reading lies within microseconds of the recorder's)
record_function = torch._C._profiler._RecordFunctionFast


@dataclasses.dataclass
class Span:
    """One closed span; times are Unix-epoch nanoseconds."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    request: int
    attrs: Dict[str, Any]


class Recorder:
    """The spans and counters recorded while tracing, bounded by
    ``max_spans`` (later spans are counted in ``dropped``)."""

    def __init__(self) -> None:
        self.max_spans = MAX_SPANS
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open = threading.local()  # this thread's stack of open spans
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.spans: List[Span] = []
            self.counters: Dict[str, float] = {}
            self.dropped = 0

    def new_request(self) -> int:
        return next(self._ids)

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread."""
        stack = getattr(self._open, "stack", None)
        return stack[-1] if stack else None

    def open(self, name: str, start_ns: int, request: Optional[int], attrs: Dict[str, Any]) -> Span:
        """Open a span on this thread: its request is ``request``, else its
        parent's, else a new one."""
        parent = self.current()
        if request is None:
            request = parent.request if parent is not None else self.new_request()
        span = Span(next(self._ids), name, start_ns, 0, None if parent is None else parent.id,
                    threading.get_ident(), request, attrs)
        if parent is None:
            self._open.stack = [span]
        else:
            self._open.stack.append(span)
        return span

    def close(self, span: Span, end_ns: int) -> None:
        span.end_ns = end_ns
        self._open.stack.pop()
        self._keep(span)

    def add(self, name: str, seconds: float, parent: Optional[Span], attrs: Dict[str, Any]) -> None:
        """Keep a span of ``seconds`` that ends now and began elsewhere (on
        ``parent``'s thread, under it)."""
        end = time.time_ns()
        thread = threading.get_ident() if parent is None else parent.thread
        request = self.new_request() if parent is None else parent.request
        self._keep(Span(next(self._ids), name, end - int(seconds * 1e9), end,
                        None if parent is None else parent.id, thread, request, attrs))

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(span)
            else:
                self.dropped += 1

    def count(self, name: str, n: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> Dict[str, Any]:
        """{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
        {name: value}, "dropped": n}. A span's self time is its duration
        minus what its children on its own thread cover."""
        with self._lock:
            spans = list(self.spans)
            counters = dict(self.counters)
            dropped = self.dropped
        children: Dict[int, List[Span]] = {}
        for s in spans:
            if s.parent is not None:
                children.setdefault(s.parent, []).append(s)
        out: Dict[str, Dict[str, float]] = {}
        for s in spans:
            covered, edge = 0, s.start_ns
            for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
                if c.thread != s.thread:
                    continue
                lo, hi = max(c.start_ns, edge), min(c.end_ns, s.end_ns)
                if hi > lo:
                    covered += hi - lo
                    edge = hi
            row = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += (s.end_ns - s.start_ns) * 1e-9
            row["self_s"] += (s.end_ns - s.start_ns - covered) * 1e-9
        return {"spans": out, "counters": counters, "dropped": dropped}


RECORDER = Recorder()


class _Active:
    """A span while tracing: a profiler range around the recorder's span."""

    __slots__ = ("_name", "_request", "_attrs", "_range", "_span")

    def __init__(self, name: str, request: Optional[int], attrs: Dict[str, Any]) -> None:
        self._name = name
        self._request = request
        self._attrs = attrs

    # the clock is read right after the range opens and right before it
    # closes, so the two agree to a few microseconds
    def __enter__(self) -> Span:
        self._range = record_function(self._name)
        self._range.__enter__()
        self._span = RECORDER.open(self._name, time.time_ns(), self._request, self._attrs)
        return self._span

    def __exit__(self, *exc: object) -> None:
        end = time.time_ns()
        self._range.__exit__(*exc)
        RECORDER.close(self._span, end)


# what a span is with tracing off. Tracing is on while torch's
# `_is_profiler_enabled` is: every profiler sets it for the whole process on
# start, where `torch.autograd._profiler_enabled()` answers for the calling
# thread only
_OFF = contextlib.nullcontext()


def span(name: str, request: Optional[int] = None, **attrs: Any) -> "contextlib.AbstractContextManager[Optional[Span]]":
    """Mark the enclosed region as ``name`` (yields the `Span`, or None when
    tracing is off). ``request`` sets its request id (`new_request`);
    otherwise it takes its parent's, or a new one at the top of a
    thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Active(name, request, attrs)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.count(name, n)


def new_request() -> Optional[int]:
    """A fresh request id while tracing, for spans of one unit of work that
    do not nest (None when off)."""
    return RECORDER.new_request() if _autograd_profiler._is_profiler_enabled else None


def current() -> Optional[Span]:
    """The innermost span open on this thread (None when tracing is off)."""
    return RECORDER.current() if _autograd_profiler._is_profiler_enabled else None


def record(name: str, seconds: float, parent: Optional[Span], **attrs: Any) -> None:
    """Keep a span of ``seconds`` ending now that began on another thread
    (under ``parent``, opened there), while tracing. It is in the recorder
    only, not on the profiler's timeline."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.add(name, seconds, parent, attrs)


def summary() -> Dict[str, Any]:
    """The recorder's `Recorder.summary`."""
    return RECORDER.summary()


def spans(name: Optional[str] = None) -> List[Span]:
    """The kept spans (of ``name`` only, when given)."""
    return [s for s in list(RECORDER.spans) if name is None or s.name == name]


def reset() -> None:
    """Forget every kept span and counter."""
    RECORDER.reset()


@contextlib.contextmanager
def trace(log_dir: Union[str, pathlib.Path]) -> Iterator[None]:
    """Profile the enclosed region and write ``<log_dir>/trace.json`` and,
    beside it, ``spans.json``: the spans and counters recorded in the
    region (the recorder starts afresh), each span with its epoch
    nanoseconds, the profiler's ``trace_start_ns`` and the `summary`.

    CPU activity is always recorded; CUDA kernels too where a GPU is
    present. View the trace at ui.perfetto.dev or chrome://tracing.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / TRACE_NAME))
    totals = summary()
    kept = {
        "trace_start_ns": prof.profiler.kineto_results.trace_start_ns(),
        "spans": [dataclasses.asdict(s) for s in spans()],
        "summary": totals["spans"],
        "counters": totals["counters"],
        "dropped": totals["dropped"],
    }
    (out / SPANS_NAME).write_text(json.dumps(kept, default=str))


def device_memory_stats(device: Optional[Union[str, torch.device]] = None) -> Dict[str, int]:
    """The CUDA caching allocator's statistics of ``device``
    (`torch.cuda.memory_stats`), or of the current CUDA device when none is
    given: ``allocated_bytes.all.peak`` is the peak since the last
    `torch.cuda.reset_peak_memory_stats`. A CPU device gives ``{}``. With
    no device and no GPU it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for the CPU's (empty) stats")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cpu":
        return {}
    return dict(torch.cuda.memory_stats(device))
