"""Tracing and profiling hooks.

The port's counterpart of `basic_pitch_tpu/utils/profiling.py`: a
`torch.profiler` trace of a region (CPU activity, plus CUDA kernels where a
GPU is present) written as a Chrome/Perfetto trace, named regions that show
on its timeline, simple scoped wall-clock timers (a copy of the JAX
package's `Timers`), and the CUDA caching allocator's statistics.
"""

from __future__ import annotations

import contextlib
import pathlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Union[str, pathlib.Path]) -> Iterator[None]:
    """Profile the enclosed region and write ``<log_dir>/trace.json``.

    CPU activity is always recorded; CUDA kernels too where a GPU is
    present. View the trace at ui.perfetto.dev or chrome://tracing.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / TRACE_NAME))


def annotate(name: str) -> record_function:
    """Named region that shows up on profiler timelines."""
    return record_function(name)


class Timers:
    """Thread-safe scoped wall-clock accumulator.

    >>> timers = Timers()
    >>> with timers("decode"):
    ...     ...
    >>> timers.summary()
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self._totals[name] = self._totals.get(name, 0.0) + elapsed
                self._counts[name] = self._counts.get(name, 0) + 1

    def summary(self) -> List[Tuple[str, float, int]]:
        """(name, total_seconds, calls), slowest first."""
        with self._lock:
            rows = [
                (name, self._totals[name], self._counts[name]) for name in self._totals
            ]
        return sorted(rows, key=lambda r: -r[1])

    def report(self) -> str:
        lines = ["name                          total_s   calls   mean_ms"]
        for name, total, count in self.summary():
            lines.append(f"{name:<28} {total:8.3f} {count:7d} {1000*total/count:9.2f}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()


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
