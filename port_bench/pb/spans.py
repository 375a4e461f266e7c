"""The program's own spans and counters (`basic_pitch_torch.utils.profiling`)
as the per-layer readers take them.

The program records only while a profiler runs, so in a ``--trace 1`` run
the recorder holds the traced span alone; its times are shares of that
span's wall (`TraceSummary.window_s`). A program without the recorder (one
older than its spans) gives no reading.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def summary(run, kind: str) -> Optional[Dict]:
    """The recorder's summary of a traced run of ``kind``, else None."""
    if run.trace is None or run.stats.get("kind") != kind or run.trace.window_s <= 0:
        return None
    from basic_pitch_torch.utils import profiling

    read = getattr(profiling, "summary", None)
    return None if read is None else read()


def host_pct(run, kind: str, span: str, field: str = "total_s") -> Optional[float]:
    """100 x the ``field`` ("total_s" or "self_s") of the spans named
    ``span`` over the traced span's wall."""
    got = summary(run, kind)
    if got is None or span not in got["spans"]:
        return None
    return 100.0 * got["spans"][span][field] / run.trace.window_s


def durations_s(run, kind: str, span: str) -> List[float]:
    """The durations of the kept spans named ``span`` in a traced run of
    ``kind`` (empty when there are none)."""
    if summary(run, kind) is None:
        return []
    from basic_pitch_torch.utils import profiling

    return [(s.end_ns - s.start_ns) * 1e-9 for s in profiling.spans(span)]
