"""Offline batch transcription: a closed loop of
`StreamingTranscriber.transcribe_batch` calls over a pool of recordings.

Set-up makes the pool from the seed, builds the transcriber with the
configuration's settings and runs the whole pool once (every shape the
window uses). The window then calls `transcribe_batch` on the pool's
batches in turn, one call after the other, asking for the model outputs
with the events as the reference's ``predict`` returns them, until
``seconds`` have passed; the call in flight at that moment finishes
inside the window. A traced run adds a traced span of the same loop.

The check takes a sample of the pool, drawn from the seed with the
longest recording in it, and holds the window's latest answer for each
against the reference: the posteriorgrams against the float64 reference's
from the same samples; the events against the frozen reference decoder
run on those reference posteriorgrams (the whole path), and, exactly,
against the same decoder run on the posteriorgrams the program returned
(the decode stage, judged from the program's own output).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List


from pb import bench, check, traffic, yardstick
from pb import trace as tracing
from reference import nmp as ref_nmp


def sample_indices(seed: int, plan: List[Dict], k: int) -> List[int]:
    """``k`` pool indices drawn from the seed, the longest recording first."""
    longest = max(plan, key=lambda p: p["samples"])["index"]
    others = [p["index"] for p in plan if p["index"] != longest]
    picks = traffic.rng(seed, 7).permutation(len(others))[: max(0, k - 1)]
    return [longest] + [others[i] for i in picks]


def make_transcriber(config: Dict, device):
    from basic_pitch_torch.pipeline import StreamingTranscriber

    t = config["transcriber"]
    return StreamingTranscriber(
        str(bench.ROOT / config["weights"]),
        windows_per_chunk=t["windows_per_chunk"],
        device=device,
        precision=t["precision"],
        conv_impl=t["conv_impl"],
        compute_group=t["compute_group"],
        pcm_transport=t["pcm_transport"],
    )


class ControlTranscriber:
    """The reference in TF32 (float32 with TF32 on) in the program's place:
    posteriorgrams from `reference/nmp.py`, events from the frozen
    decoder."""

    def __init__(self, config: Dict, device):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        self.model = ref_nmp.Reference(device, torch.float32)
        self.params = ref_nmp.load_weights(str(bench.ROOT / config["weights"]), device, torch.float32)

    def transcribe_batch(self, recordings, return_model_outputs=False, **options):
        out = []
        for audio, sr in recordings:
            post = self.model.posteriorgrams(self.params, audio, sr)
            events = check.reference_events(post, {**check.DECODE_DEFAULTS, **options})
            out.append((events, post) if return_model_outputs else events)
        return out


def run(ctx: "bench.Context") -> "bench.Outcome":
    import torch

    spec, config = ctx.cell.traffic, ctx.cell.config
    device = ctx.device
    decode = config["decode"]
    pool = traffic.recordings(ctx.seed, spec)
    plan = [p for p, _ in pool]
    sr = int(spec["sample_rate"])
    batch = int(spec["batch"])
    batches = [pool[i : i + batch] for i in range(0, len(pool), batch)]
    sample = sample_indices(ctx.seed, plan, int(spec["check_sample"]))
    kept: Dict[int, tuple] = {}  # pool index -> latest (events, outputs)

    if ctx.control:
        transcriber = ControlTranscriber(config, device)
        batches = [[(p, a) for p, a in pool if p["index"] in sample]]
    else:
        transcriber = make_transcriber(config, device)

    units: List[Dict] = []

    def call(items, traced: bool, label: str = "bench.transcribe_batch") -> None:
        t0 = time.monotonic()
        with tracing.span(label):
            results = transcriber.transcribe_batch([(a, sr) for _, a in items], return_model_outputs=True, **decode)
        t1 = time.monotonic()
        for (p, _), res in zip(items, results):
            if p["index"] in sample:
                kept[p["index"]] = res
        units.append({
            "t0": t0, "t1": t1, "traced": traced, "attempted": len(items), "answered": len(results),
            "audio_s": sum(p["samples"] for (p, _), _r in zip(items, results)) / sr,
            "windows": sum(yardstick.model_windows(p["samples"], sr) for (p, _), _r in zip(items, results)),
            "decodes": [(len(r[1]["note"]), len(r[0])) for r in results],
        })

    if not ctx.control:
        for items in batches:  # warm-up: every shape of the window
            call(items, False, "bench.warmup")
        units.clear()
    tracing.sync(device)
    setup_s = time.monotonic() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s; pool {len(pool)} recordings, {sum(p['samples'] for p in plan) / sr:.1f} s of audio")

    start = time.monotonic()
    i = 0
    while True:
        call(batches[i % len(batches)], False)
        i += 1
        if time.monotonic() - start >= ctx.seconds or ctx.control:
            break
    tracer = tracing.Tracer(ctx.trace and not ctx.control, device)
    if tracer.enabled:
        with tracer.span():
            t_trace = time.monotonic()
            while time.monotonic() - t_trace < bench.TRACE_SECONDS:
                call(batches[i % len(batches)], True)
                i += 1
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    host_fallbacks = getattr(transcriber, "host_fallbacks", 0)
    del transcriber
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    window = [u for u in units if not u["traced"]]
    attempted = sum(u["attempted"] for u in window)
    missing = sum(u["attempted"] - u["answered"] for u in units)
    ctx.log(f"window: {len(window)} calls, {attempted} recordings, host fallbacks {host_fallbacks}")
    numbers = compare(ctx, pool, sample, kept, decode)
    numbers["missing_answers"] = float(missing + sum(1 for i in sample if i not in kept))
    stats = {
        "kind": "offline",
        "setup_s": setup_s,
        "window_s": window[-1]["t1"] - window[0]["t0"],
        "audio_s": sum(u["audio_s"] for u in window),
        "windows": sum(u["windows"] for u in window),
        "traced_decodes": [d for u in units if u["traced"] for d in u["decodes"]],
    }
    return bench.Outcome(
        attempted=attempted,
        failed=sum(u["attempted"] - u["answered"] for u in window),
        stats=stats,
        numbers=numbers,
        memory_peak_bytes=memory_peak,
        trace=tracer.summary,
    )


def compare(ctx, pool, sample, kept, decode) -> Dict[str, float]:
    """The sampled answers against the reference (see the module's doc)."""
    import torch

    t0 = time.monotonic()
    sr = int(ctx.cell.traffic["sample_rate"])
    ref = ref_nmp.Reference(ctx.device, torch.float64)
    params = ref_nmp.load_weights(str(bench.ROOT / ctx.cell.config["weights"]), ctx.device, torch.float64)
    audio = {p["index"]: a for p, a in pool}
    numbers = {
        "posteriorgram_gap": 0.0, "decode_unmatched": 0.0, "decode_bends_differ": 0.0,
        "event_unmatched_share": 0.0, "event_amp_gap": 0.0,
    }
    options = {**check.DECODE_DEFAULTS, **decode}
    for index in sample:
        if index not in kept:
            continue
        events, outputs = kept[index]
        post = ref.posteriorgrams(params, audio[index], sr)
        numbers["posteriorgram_gap"] = max(numbers["posteriorgram_gap"], check.posteriorgram_gap(outputs, post))
        # the decode stage, from the program's own posteriorgrams: exact
        stage = check.compare_events(events, check.reference_events(outputs, options))
        numbers["decode_unmatched"] += stage["unmatched"]
        numbers["decode_bends_differ"] += stage["bends_differ"]
        # the whole path, against the reference's events from the audio
        whole = check.compare_events(events, check.reference_events(post, options))
        numbers["event_unmatched_share"] = max(numbers["event_unmatched_share"], whole["unmatched_share"])
        numbers["event_amp_gap"] = max(numbers["event_amp_gap"], whole["amp_gap"])
    ctx.log(f"check of {len(sample)} recordings took {time.monotonic() - t0:.1f} s")
    return numbers


def tiny_recordings(cell: "bench.Cell") -> None:
    """Cut a transcriber cell's recordings and chunks to a CPU test run's
    size (shared with the serve kind)."""
    cell.config["transcriber"].update(windows_per_chunk=2, pcm_transport="raw")
    cell.traffic.update(pool=4, snippet_s=2, snippets_per_level=1, check_sample=2)
    d = cell.traffic["durations"]
    cell.traffic["durations"] = {"dist": "fixed", "seconds": 3} if d["dist"] == "fixed" else {"dist": "loguniform", "min_s": 2, "max_s": 5}


def tiny(cell: "bench.Cell") -> "bench.Cell":
    """The cell cut to a size a CPU test run holds: the same code paths,
    small chunks, short recordings, small batches, and the seconds a
    test run measures (``test_seconds``). The harness's tests call it; a
    run on the card never does."""
    tiny_recordings(cell)
    cell.traffic.update(batch=2, test_seconds=2.0)
    return cell
