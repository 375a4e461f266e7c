"""train_windows_per_s: 2 s training windows stepped over the window's
wall seconds, the window ending in a synchronise (host clock)."""


def read(run):
    if run.stats.get("kind") != "train":
        return None
    return run.stats["windows"] / run.stats["window_s"]
