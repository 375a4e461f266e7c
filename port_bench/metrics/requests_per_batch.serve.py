"""requests_per_batch.serve: requests over transcriber batches the
service dispatched in the window (`TranscriptionService.snapshot_metrics`
read before and after it)."""


def read(run):
    if run.stats.get("kind") != "serve" or not run.stats["batches"]:
        return None
    return run.stats["requests"] / run.stats["batches"]
