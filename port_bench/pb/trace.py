"""The traced span of a run: `torch.profiler` over CPU and CUDA, reduced
to the device's busy time, kernel time by name and idle gaps by the host
span under them.

The benchmark names its own calls into the program with
`record_function` spans (``bench.*``); an idle gap of the device is named
by the innermost such span over its middle. Device activity is every
event the profiler puts on the card's timeline (kernels, copies, sets)
except the mirrored user spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]  # device seconds by operation name
    kernel_calls: Dict[str, int]
    gaps_s: Dict[str, float]  # idle seconds by the host span under them

    def device_seconds(self, fragment: str) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        ``fragment``."""
        secs = sum(v for k, v in self.kernel_s.items() if fragment in k)
        calls = sum(v for k, v in self.kernel_calls.items() if fragment in k)
        return secs, calls

    def breakdown(self, top: int = 10) -> Dict[str, List[list]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def summarize(events) -> TraceSummary:
    """Reduce a profiler's events (`FunctionEvent`s, times in us)."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    spans: List[Tuple[float, float, str]] = []
    device: List[Tuple[float, float]] = []
    kernel_s: Dict[str, float] = {}
    kernel_calls: Dict[str, int] = {}
    for e in events:
        lo, hi = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                continue
            device.append((lo, hi))
            kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (hi - lo) * 1e-6
            kernel_calls[e.name] = kernel_calls.get(e.name, 0) + 1
        elif e.name == WINDOW_SPAN:
            window = (lo, hi)
        elif e.name.startswith("bench."):
            spans.append((lo, hi, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = window
    busy = [(max(lo, w0), min(hi, w1)) for lo, hi in _merge(device) if hi > w0 and lo < w1]
    gaps_s: Dict[str, float] = {}
    edge = w0
    for lo, hi in busy + [(w1, w1)]:
        if lo > edge:
            mid = 0.5 * (edge + lo)
            under = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(under, key=lambda s: s[1] - s[0])[2] if under else "outside bench spans"
            gaps_s[name] = gaps_s.get(name, 0.0) + (lo - edge) * 1e-6
        edge = max(edge, hi)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(hi - lo for lo, hi in busy) * 1e-6,
        kernel_s=kernel_s,
        kernel_calls=kernel_calls,
        gaps_s=gaps_s,
    )


class Tracer:
    """Starts and stops the profiler around the traced span; a no-op when
    ``enabled`` is false."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def span(self) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sync(self.device)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                yield
                sync(self.device)
        self.summary = summarize(prof.events())


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A host span the trace names idle gaps by."""
    return torch.profiler.record_function(name)
