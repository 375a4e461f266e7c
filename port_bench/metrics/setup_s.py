"""setup_s: seconds from process start to the first timed item (host
clock): imports, CUDA start, the program's set-up, the traffic, warm-up."""


def read(run):
    return run.stats.get("setup_s")
