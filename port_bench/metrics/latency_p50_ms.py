"""latency_p50_ms: the 50th percentile over every request of the window
of the time from its due time to the last byte of its response (host
clock); a request that never answers ranks as answering at the horizon,
the window plus the minute it is waited for."""

import numpy as np


def read(run):
    if run.stats.get("kind") != "serve" or not run.stats["latencies_s"]:
        return None
    return 1e3 * float(np.quantile(np.asarray(run.stats["latencies_s"], np.float64), 0.50))
