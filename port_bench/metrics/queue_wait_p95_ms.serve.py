"""queue_wait_p95_ms.serve: the 95th percentile (nearest rank) of the
service's queue wait per request (`bp.serve.queue_wait`: from `submit`'s
enqueue to the dispatch thread taking the group) in the traced span, in
milliseconds."""

import math

from pb import spans


def read(run):
    waits = sorted(spans.durations_s(run, "serve", "bp.serve.queue_wait"))
    if not waits:
        return None
    return 1e3 * waits[math.ceil(0.95 * len(waits)) - 1]
