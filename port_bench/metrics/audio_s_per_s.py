"""audio_s_per_s: seconds of audio whose events reached the host, over
the whole window's wall seconds (host clock)."""


def read(run):
    if run.stats.get("kind") != "offline":
        return None
    return run.stats["audio_s"] / run.stats["window_s"]
