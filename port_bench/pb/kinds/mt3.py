"""MT3 batch transcription: a closed loop of
`Mt3Transcriber.transcribe_batch` calls over a pool of recordings.

The pool is the offline kind's, seed for seed (`traffic.recordings` with
the same recording fields). Each segment's token budget (``token_budget:
"codec"``) is what MT3's codec, `reference/mt3.py`'s `notes_to_tokens`,
makes of the notes `traffic.tone_mix` rendered in that segment, as program
0 at velocity 127, ties included, capped at ``token_cap``; the notes are
rebuilt here from the generator's own salts (`snippet_notes`), without the
audio. The weights are drawn from the seed on the card (`weights_seed`).

Set-up makes the pool and the budgets, builds the transcriber with the
configuration's settings and runs the whole pool once (every shape the
window uses). The window then calls `transcribe_batch` on the pool's
batches in turn, until ``seconds`` have passed; the call in flight at that
moment finishes inside the window. A traced run adds a traced span of the
same loop.

The check takes a sample of ``check_sample`` recordings of one batch,
drawn from the seed, and after the window calls the batch once more,
keeping the sample's logits, mel and encoder output. It holds against the
reference: that call's tokens against the window's latest answer
(``tokens_differ``, segments); each token against the argmax of its own
logits, EOS masked where the budget masks it (``token_not_argmax``); the
logits against the float64 reference's full forward pass teacher-forced on
the program's own tokens (``logit_gap``: per segment, the largest gap over
the reference's largest logit), and the steps where the reference's argmax
is another token while its top-two margin, over its largest logit, is
above the ``logit_gap`` limit (``argmax_flips``); the mel and the encoder
output against the float64 reference's (``mel_gap``, from the same
samples: per segment, the largest gap of the mel magnitudes, exp of the
log-mel, over the reference's largest; ``encoder_gap``, the encoder stage
from the program's own mel: the largest gap over the reference's largest
value); and
the window's events against the reference's detokenizer run on the
program's own tokens, exactly (``detok_unmatched``).
"""

from __future__ import annotations

import gc
import time
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from pb import bench, traffic
from pb import trace as tracing
from reference import mt3 as ref_mt3

REF_BLOCK = 16  # segments a float64 reference pass takes at a time


def weights_seed(seed: int) -> int:
    return int(traffic.rng(seed, 17).integers(2**62))


def snippet_notes(seed: int, level: int, k: int, n_samples: int, sr: int, tones: Dict) -> List[tuple]:
    """The notes of snippet ``k`` of ``level`` voices: `traffic.tone_mix`'s
    draws from the same generator, in its order, without the audio."""
    gen = traffic.rng(seed, 1, level, k)
    gen.standard_normal(n_samples)  # the noise floor's draws
    lo_gap, hi_gap = tones["note_gap_s"]
    lo_len, hi_len = tones["note_len_s"]
    lo_p, hi_p = tones["pitch_midi"]
    seconds = n_samples / sr
    notes = []
    for _ in range(level):
        t = float(gen.uniform(0.0, hi_gap))
        while t < seconds - 0.05:
            midi = int(gen.integers(lo_p, hi_p + 1))
            dur = float(gen.uniform(lo_len, hi_len))
            notes.append((t, min(t + dur, seconds), midi))
            t += float(gen.uniform(lo_gap, hi_gap))
    return notes


def recording_notes(seed: int, spec: Dict, entry: Dict) -> List[tuple]:
    """The notes of one pool recording, as `traffic.recording` cuts it from
    its snippets."""
    sr = int(spec["sample_rate"])
    n = int(round(float(spec["snippet_s"]) * sr))
    level = entry["voices"]
    parts = [snippet_notes(seed, level, k, n, sr, spec["tones"]) for k in range(int(spec["snippets_per_level"]))]
    need = -(-entry["samples"] // n)
    picks = traffic.rng(seed, 2, entry["index"]).integers(0, len(parts), need)
    end = entry["samples"] / sr
    out = []
    for j, p in enumerate(picks):
        shift = j * n / sr
        out += [(on + shift, min(off + shift, end), midi) for on, off, midi in parts[p] if on + shift < end]
    return out


def token_budgets(notes: Sequence[tuple], n_segments: int, cfg: "ref_mt3.Config", cap: int) -> List[int]:
    """Each segment's count of MT3 codec tokens for ``notes`` (program 0,
    velocity 127), capped."""
    full = [(on, off, pitch, 127, 0, False) for on, off, pitch in notes]
    by_segment: Dict[int, list] = {}
    for note in full:
        for k in range(ref_mt3.segment_of(note[0], cfg), min(ref_mt3.segment_of(note[1], cfg), n_segments - 1) + 1):
            by_segment.setdefault(k, []).append(note)
    return [min(cap, len(ref_mt3.notes_to_tokens(by_segment.get(k, []), k, cfg))) for k in range(n_segments)]


def n_segments(n_samples: int, sr: int, cfg: "ref_mt3.Config") -> int:
    """Segments of a recording: its length at 16 kHz (resample_poly's for
    160/441) over a segment's samples, rounded up, at least one."""
    n16 = -(-n_samples * 160 // 441) if sr == 44100 else n_samples
    return max(1, -(-n16 // cfg.segment_samples))


def sample_batch(seed: int, n_batches: int, batch: int, k: int) -> Tuple[int, List[int]]:
    """(batch index, positions in it) of the check's sample, from the seed."""
    gen = traffic.rng(seed, 7)
    b = int(gen.integers(n_batches))
    return b, sorted(int(i) for i in gen.permutation(batch)[:k])


class ControlTranscriber:
    """The reference in TF32 (float32 with TF32 on) in the program's place:
    scipy's resampler, the reference's log-mel, encoder and greedy loop by
    full recomputation, and its detokenizer."""

    def __init__(self, cfg: "ref_mt3.Config", seed: int, device, max_new_tokens: int):
        import torch

        self.cfg, self.device, self.max_new_tokens = cfg, device, max_new_tokens
        self.params = ref_mt3.init_params(cfg, seed, device, torch.float32)

    def transcribe_batch(self, recordings, token_budgets=None, return_model_outputs=False, return_logits=()):
        import torch

        out = []
        keep = set(return_logits)
        for i, (audio, sr) in enumerate(recordings):
            segs = torch.from_numpy(ref_mt3.segments(ref_mt3.to_16k(audio, sr), self.cfg)).to(self.device, torch.float32)
            mel = ref_mt3.log_mel(segs, self.cfg, tf32=True)
            enc = ref_mt3.encode(self.params, mel, self.cfg, tf32=True)
            caps = [min(int(b), self.max_new_tokens) for b in token_budgets[i]]
            tokens, logits = ref_mt3.greedy(self.params, enc, caps, [True] * len(caps), self.cfg, tf32=True)
            events, programs = ref_mt3.tokens_to_events(tokens, len(audio) / sr, self.cfg)
            outputs = {"tokens": [np.asarray(t, np.int64) for t in tokens], "programs": programs}
            if i in keep:
                outputs.update(logits=[l.cpu().numpy() for l in logits], mel=mel.cpu().numpy(), encoded=enc.cpu().numpy())
            out.append((events, outputs) if return_model_outputs else events)
        return out


def run(ctx: "bench.Context") -> "bench.Outcome":
    import torch

    from basic_pitch_torch.models.mt3 import Mt3Config
    from basic_pitch_torch.mt3_pipeline import Mt3Transcriber

    spec, config = ctx.cell.traffic, ctx.cell.config
    device = ctx.device
    settings = config["transcriber"]
    cfg = ref_mt3.Config.from_dict(config["model"])
    pool = traffic.recordings(ctx.seed, spec)
    sr = int(spec["sample_rate"])
    batch = int(spec["batch"])
    seg_count = {p["index"]: n_segments(p["samples"], sr, cfg) for p, _ in pool}
    if spec["token_budget"] != "codec":
        raise ValueError(f"unknown token_budget {spec['token_budget']!r}")
    budgets = {
        p["index"]: token_budgets(recording_notes(ctx.seed, spec, p), seg_count[p["index"]], cfg, int(spec["token_cap"]))
        for p, _ in pool
    }
    batches = [pool[i : i + batch] for i in range(0, len(pool), batch)]
    b_check, positions = sample_batch(ctx.seed, len(batches), batch, int(spec["check_sample"]))
    sample = [batches[b_check][j][0]["index"] for j in positions]
    seed_w = weights_seed(ctx.seed)
    kept: Dict[int, tuple] = {}  # pool index -> latest (events, outputs)

    if ctx.control:
        transcriber = ControlTranscriber(cfg, seed_w, device, int(settings["max_new_tokens"]))
        batches = [[batches[b_check][j] for j in positions]]
        b_check, positions = 0, list(range(len(positions)))
    else:
        transcriber = Mt3Transcriber(
            seed_w, Mt3Config.from_dict(config["model"]), device=device,
            segments_per_call=int(settings["segments_per_call"]), max_new_tokens=int(settings["max_new_tokens"]),
            pcm_transport=settings["pcm_transport"],
        )

    units: List[Dict] = []

    def call(items, traced: bool, label: str = "bench.transcribe_batch", logits=()):
        t0 = time.monotonic()
        with tracing.span(label):
            results = transcriber.transcribe_batch(
                [(a, sr) for _, a in items], token_budgets=[budgets[p["index"]] for p, _ in items],
                return_model_outputs=True, return_logits=logits,
            )
        t1 = time.monotonic()
        units.append({
            "t0": t0, "t1": t1, "traced": traced, "attempted": len(items), "answered": len(results),
            "audio_s": sum(p["samples"] for (p, _), _r in zip(items, results)) / sr,
            "tokens": [len(t) for _, out in results for t in out["tokens"]],
        })
        return results

    def window_call(items, traced: bool, label: str = "bench.transcribe_batch") -> None:
        for (p, _), res in zip(items, call(items, traced, label)):
            if p["index"] in sample:
                kept[p["index"]] = res

    if not ctx.control:
        for items in batches:  # warm-up: every shape of the window
            window_call(items, False, "bench.warmup")
        units.clear()
    tracing.sync(device)
    if device.type == "cuda":  # the peak of the window's calls, not of the warm-up's growth
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.monotonic() - ctx.t_start
    all_budgets = [b for v in budgets.values() for b in v]
    ctx.log(f"set-up {setup_s:.3f} s; pool {len(pool)} recordings, {sum(p['samples'] for p, _ in pool) / sr:.1f} s of audio, "
            f"{len(all_budgets)} segments, token budgets median {np.median(all_budgets):.0f} max {max(all_budgets)}")

    start = time.monotonic()
    i = 0
    while True:
        window_call(batches[i % len(batches)], False)
        i += 1
        if time.monotonic() - start >= ctx.seconds or ctx.control:
            break
    tracer = tracing.Tracer(ctx.trace and not ctx.control, device)
    if tracer.enabled:
        with tracer.span():
            t_trace = time.monotonic()
            while time.monotonic() - t_trace < bench.TRACE_SECONDS:
                window_call(batches[i % len(batches)], True)
                i += 1
    window = [u for u in units if not u["traced"]]
    traced = [u for u in units if u["traced"]]
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if not ctx.control:
        per_token = cfg.n_dec_layers * 2 * cfg.n_heads * cfg.d_head * 4
        held = transcriber.model.cache_bytes()
        ctx.log(f"memory peak {memory_peak} B; self K/V filled at most {max(sum(u['tokens']) for u in window) * per_token} B "
                f"of {held['self_kv']} B held ({held['rows']} rows x {held['positions']} positions), cross K/V {held['cross_kv']} B")
    check = call(batches[b_check], False, "bench.check", logits=positions)
    units.pop()
    del transcriber
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    attempted = sum(u["attempted"] for u in window)
    missing = sum(u["attempted"] - u["answered"] for u in units)
    ctx.log(f"window: {len(window)} calls, {attempted} recordings")
    checked = {batches[b_check][j][0]["index"]: check[j] for j in positions if j < len(check)}
    numbers = compare(ctx, cfg, pool, sample, kept, checked, seed_w)
    numbers["missing_answers"] = float(missing + sum(1 for s in sample if s not in kept or s not in checked))
    stats = {
        "kind": "mt3",
        "setup_s": setup_s,
        "window_s": window[-1]["t1"] - window[0]["t0"],
        "audio_s": sum(u["audio_s"] for u in window),
        "token_counts": [n for u in window for n in u["tokens"]],
        "traced_token_counts": [n for u in traced for n in u["tokens"]],
    }
    return bench.Outcome(
        attempted=attempted,
        failed=sum(u["attempted"] - u["answered"] for u in window),
        stats=stats,
        numbers=numbers,
        memory_peak_bytes=memory_peak,
        trace=tracer.summary,
    )


def mel_gap(program, reference) -> float:
    """Per segment, the largest gap of the mel magnitudes over the
    reference's largest, the worst segment's. Magnitudes and not their logs:
    where the resampler's stopband leaves a band a thousandth of the noise
    floor, float32 rounding moves its log by a few 1e-3 and nothing the
    encoder sees."""
    if program.shape != reference.shape:
        return 1e300
    a, b = program.exp(), reference.exp()
    return float(((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).max())


def unmatched_events(events, programs, ref_events, ref_programs) -> float:
    """Events on either side without an equal one on the other (start, end,
    pitch, amplitude and program; a repeated event counts as often as it
    stands)."""

    def keys(evs, progs):
        return Counter((round(s, 6), round(e, 6), int(p), round(float(a), 6), int(prog)) for (s, e, p, a, _), prog in zip(evs, progs))

    a, b = keys(events, programs), keys(ref_events, ref_programs)
    return float(sum(((a - b) + (b - a)).values()) + abs(len(events) - len(programs)) + abs(len(ref_events) - len(ref_programs)))


def compare(ctx, cfg, pool, sample, kept, checked, seed_w) -> Dict[str, float]:
    """The sampled answers against the reference (see the module's doc)."""
    import torch

    t0 = time.monotonic()
    sr = int(ctx.cell.traffic["sample_rate"])
    flip_limit = float(ctx.cell.limits["logit_gap"])
    params = ref_mt3.init_params(cfg, seed_w, ctx.device, torch.float64)
    audio = {p["index"]: a for p, a in pool}
    numbers = {
        "tokens_differ": 0.0, "token_not_argmax": 0.0, "logit_gap": 0.0, "argmax_flips": 0.0,
        "mel_gap": 0.0, "encoder_gap": 0.0, "detok_unmatched": 0.0,
    }
    for index in sample:
        if index not in kept or index not in checked:
            continue
        events, outputs = kept[index]
        ref_events, ref_programs = ref_mt3.tokens_to_events(outputs["tokens"], len(audio[index]) / sr, cfg)
        numbers["detok_unmatched"] += unmatched_events(events, outputs["programs"], ref_events, ref_programs)
        _, out = checked[index]
        numbers["tokens_differ"] += float(sum(
            not np.array_equal(x, y) for x, y in zip(out["tokens"], outputs["tokens"])
        ) + abs(len(out["tokens"]) - len(outputs["tokens"])))
        segs = torch.from_numpy(ref_mt3.segments(ref_mt3.to_16k(audio[index], sr), cfg)).to(ctx.device)
        mel = ref_mt3.log_mel(segs, cfg)
        prog_mel = torch.from_numpy(out["mel"]).to(ctx.device, torch.float64)
        numbers["mel_gap"] = max(numbers["mel_gap"], mel_gap(prog_mel, mel))
        # the encoder stage, from the program's own mel
        stage = ref_mt3.encode(params, prog_mel, cfg) if mel.shape == prog_mel.shape else None
        prog_enc = torch.from_numpy(out["encoded"]).to(ctx.device, torch.float64)
        numbers["encoder_gap"] = max(
            numbers["encoder_gap"],
            float((prog_enc - stage).abs().max() / stage.abs().max()) if stage is not None and stage.shape == prog_enc.shape else 1e300,
        )
        enc = ref_mt3.encode(params, mel, cfg)
        for lo in range(0, len(out["tokens"]), REF_BLOCK):
            toks = [list(t) for t in out["tokens"][lo : lo + REF_BLOCK]]
            longest = max((len(t) for t in toks), default=0)
            if not longest:
                continue
            inputs = torch.stack([
                torch.nn.functional.pad(ref_mt3.teacher_inputs(t, ctx.device), (0, longest - len(t)), value=ref_mt3.PAD)
                if t else torch.full((longest,), ref_mt3.PAD, dtype=torch.long, device=ctx.device)
                for t in toks
            ])
            full = ref_mt3.decode_logits(params, enc[lo : lo + len(toks)], inputs, cfg)
            for j, t in enumerate(toks):
                if not t:
                    continue
                ref = full[j, : len(t)]
                got = torch.from_numpy(out["logits"][lo + j]).to(ctx.device, torch.float64)
                token = torch.tensor(t, device=ctx.device)
                scale = float(ref.abs().max())
                numbers["logit_gap"] = max(numbers["logit_gap"], float((got - ref).abs().max()) / scale)
                masked_got, masked_ref = got.clone(), ref.clone()  # every segment has a budget: EOS masked
                masked_got[:, ref_mt3.EOS] = float("-inf")
                masked_ref[:, ref_mt3.EOS] = float("-inf")
                numbers["token_not_argmax"] += float((masked_got.argmax(-1) != token).sum())
                top2 = masked_ref.topk(2, dim=-1).values
                margin = (top2[:, 0] - top2[:, 1]) / scale
                numbers["argmax_flips"] += float(((masked_ref.argmax(-1) != token) & (margin > flip_limit)).sum())
    ctx.log(f"check of {len(sample)} recordings took {time.monotonic() - t0:.1f} s")
    return numbers


def tiny(cell: "bench.Cell") -> "bench.Cell":
    """The cell cut to a size a CPU test run holds: MT3 at the tier-1
    tests' size (2 + 2 layers, width 64, 2 heads of 32, MLP 128, 16 mel
    bins, 32 frames a segment), 3 s recordings from short snippets, two a
    call, and the seconds a test run measures (``test_seconds``). The
    harness's tests call it; a run on the card never does."""
    cell.config["model"].update(n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=2, d_head=32, d_mlp=128,
                                n_mels=16, frames=32)
    cell.config["transcriber"].update(pcm_transport="raw")
    cell.traffic.update(pool=4, snippet_s=2, snippets_per_level=1, check_sample=2, batch=2, test_seconds=2.0,
                        durations={"dist": "fixed", "seconds": 3})
    return cell
