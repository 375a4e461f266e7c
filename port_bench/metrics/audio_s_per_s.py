"""audio_s_per_s: seconds of audio whose events reached the host, over
the whole window's wall seconds (host clock). Any kind whose stats hold
``audio_s`` and ``window_s`` reports it."""


def read(run):
    if "audio_s" not in run.stats or "window_s" not in run.stats:
        return None
    return run.stats["audio_s"] / run.stats["window_s"]
