"""The one traffic generator: recordings, request schedules and training
batches made from a seed and a traffic file's parameters.

Every seed gets the same work: durations are the quantiles of the traffic
file's distribution, each paired with one voice count (spread evenly over
its range), in one order; request arrivals are one realisation of a
Poisson process (`schedule`). The seed draws the notes, so each run
transcribes other audio of the same sizes at the same times.

Audio is a polyphonic mix of harmonic tones over a noise floor. A
recording is cut from snippets (a few seconds each, one set per voice
count) drawn in seeded order, so that set-up makes minutes of audio in
about a second. numpy only: the load generator's process imports this
file and nothing of torch.
"""

from __future__ import annotations

import io
import struct
from typing import Dict, List, Tuple

import numpy as np

SEED_MASK = (1 << 64) - 1
FIXED_SEED = 0  # what every seed shares: sizes, their order, the arrival pattern


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a salt."""
    return np.random.default_rng(np.random.SeedSequence([seed & SEED_MASK, *salt]))


def durations(spec: Dict, n: int) -> np.ndarray:
    """``n`` durations in seconds: the mid-quantiles of a log-uniform
    distribution over [min_s, max_s], or ``n`` times a fixed value."""
    if spec["dist"] == "fixed":
        return np.full(n, float(spec["seconds"]))
    if spec["dist"] != "loguniform":
        raise ValueError(f"unknown duration distribution {spec['dist']!r}")
    lo, hi = float(spec["min_s"]), float(spec["max_s"])
    q = (np.arange(n) + 0.5) / n
    return lo * (hi / lo) ** q


def voices(spec: Dict, n: int) -> np.ndarray:
    """``n`` voice counts spread evenly over [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def arrival_gaps(rate_per_s: float, n: int) -> np.ndarray:
    """``n`` gaps of a Poisson process at ``rate_per_s``: the exponential
    distribution's mid-quantiles (their order is the seed's)."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate_per_s


def tone_mix(gen: np.random.Generator, n_samples: int, sr: int, n_voices: int, tones: Dict) -> Tuple[np.ndarray, List[tuple]]:
    """Seeded mix of ``n_voices`` streams of harmonic tones over a noise
    floor. Returns (float32 audio, [(onset s, offset s, MIDI pitch)])."""
    y = float(tones["noise"]) * gen.standard_normal(n_samples)
    gain = 0.25 / np.sqrt(n_voices)
    lo_gap, hi_gap = tones["note_gap_s"]
    lo_len, hi_len = tones["note_len_s"]
    lo_p, hi_p = tones["pitch_midi"]
    seconds = n_samples / sr
    notes = []
    for _ in range(n_voices):
        t = float(gen.uniform(0.0, hi_gap))
        while t < seconds - 0.05:
            midi = int(gen.integers(lo_p, hi_p + 1))
            dur = float(gen.uniform(lo_len, hi_len))
            f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0)
            i0, i1 = int(t * sr), min(n_samples, int((t + dur) * sr))
            tt = np.arange(i1 - i0) / sr
            env = np.exp(-1.5 * tt) * np.minimum(1.0, tt / 0.005)
            y[i0:i1] += gain * env * (np.sin(2 * np.pi * f0 * tt) + 0.4 * np.sin(4 * np.pi * f0 * tt))
            notes.append((t, min(t + dur, seconds), midi))
            t += float(gen.uniform(lo_gap, hi_gap))
    return y.astype(np.float32), notes


def to_int16(y: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(y * 32767.0), -32768, 32767).astype(np.int16)


def snippets(seed: int, spec: Dict, levels: np.ndarray) -> Dict[int, List[np.ndarray]]:
    """int16 snippets per voice count in ``levels``."""
    sr = int(spec["sample_rate"])
    n = int(round(float(spec["snippet_s"]) * sr))
    out = {}
    for level in sorted(set(int(v) for v in levels)):
        out[level] = [
            to_int16(tone_mix(rng(seed, 1, level, k), n, sr, level, spec["tones"])[0])
            for k in range(int(spec["snippets_per_level"]))
        ]
    return out


def recording(seed: int, index: int, n_samples: int, parts: List[np.ndarray]) -> np.ndarray:
    """One int16 recording of ``n_samples``: snippets of one voice count in
    seeded order, end to end."""
    gen = rng(seed, 2, index)
    need = -(-n_samples // len(parts[0]))
    picks = gen.integers(0, len(parts), need)
    return np.concatenate([parts[p] for p in picks])[:n_samples]


def recording_plan(spec: Dict) -> List[Dict]:
    """The pool's recordings in their order: index, duration, samples and
    voice count of each (the same for every seed)."""
    n = int(spec["pool"])
    secs = durations(spec["durations"], n)
    vox = voices(spec["voices"], n)
    # each duration has one voice count and one place in the pool for every
    # seed, so a seed changes the notes, not the work
    vox = vox[rng(FIXED_SEED, 3).permutation(n)]
    order = rng(FIXED_SEED, 5).permutation(n)
    sr = int(spec["sample_rate"])
    return [
        {"index": int(i), "seconds": float(secs[i]), "samples": int(round(secs[i] * sr)), "voices": int(vox[i])}
        for i in order
    ]


def recordings(seed: int, spec: Dict, only: "set | None" = None) -> List[Tuple[Dict, "np.ndarray | None"]]:
    """(plan entry, int16 samples) for the pool in the seed's order;
    entries outside ``only`` (pool indices) get no samples."""
    plan = recording_plan(spec)
    parts = snippets(seed, spec, np.array([p["voices"] for p in plan]))
    return [
        (p, recording(seed, p["index"], p["samples"], parts[p["voices"]]) if only is None or p["index"] in only else None)
        for p in plan
    ]


def wav_bytes(samples: np.ndarray, sr: int) -> bytes:
    """A mono PCM16 WAV file."""
    data = samples.astype("<i2").tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
    buf.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
    buf.write(b"data" + struct.pack("<I", len(data)) + data)
    return buf.getvalue()


def schedule(spec: Dict, rate_per_s: float, seconds: float) -> List[Tuple[float, int]]:
    """(due time from the window's start, pool index) of every request the
    window offers: one realisation of a Poisson process at ``rate_per_s``
    (the exponential quantiles in one fixed order) over the pool cycled in
    one fixed order, the same for every seed. A tail latency near capacity
    swings with which clips meet which burst, so the seed draws the clips'
    notes (`recordings`) and nothing of the schedule."""
    n = max(1, int(np.ceil(rate_per_s * seconds)))
    gaps = arrival_gaps(rate_per_s, n)[rng(FIXED_SEED, 4).permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    pool = int(spec["pool"])
    cycle = rng(FIXED_SEED, 6).permutation(pool)
    return [(float(t), int(cycle[i % pool])) for i, t in enumerate(due) if t < seconds]


# ---------------------------------------------------------------------------
# training batches in the loader's device_targets layout
# ---------------------------------------------------------------------------

FRAMES = 172
HEAD_BINS = {"onset": 88, "contour": 264, "note": 88}
SPARSE_CAP_FLOORS = {"onset": 512, "note": 2048, "contour": 4096}
FPS = 22050 / 256


def window_targets(notes: List[tuple]) -> Dict[str, np.ndarray]:
    """Dense (172, bins) targets of one 2 s window from its notes: notes
    and onsets on the note grid, contours on the bin of the pitch with
    half weight on its neighbours."""
    dense = {head: np.zeros((FRAMES, bins), np.float32) for head, bins in HEAD_BINS.items()}
    for onset, offset, midi in notes:
        p = midi - 21
        if not 0 <= p < 88:
            continue
        t0, t1 = int(round(onset * FPS)), min(FRAMES, int(round(offset * FPS)))
        if t0 >= FRAMES:
            continue
        dense["onset"][t0, p] = 1.0
        dense["note"][t0:t1, p] = 1.0
        c = 3 * p + 1
        dense["contour"][t0:t1, c] = 1.0
        dense["contour"][t0:t1, c - 1] = np.maximum(dense["contour"][t0:t1, c - 1], 0.5)
        dense["contour"][t0:t1, c + 1] = np.maximum(dense["contour"][t0:t1, c + 1], 0.5)
    return dense


def _sparse(head: str, mats: List[np.ndarray], cap: int) -> Dict[str, np.ndarray]:
    bins = HEAD_BINS[head]
    stacked = np.stack(mats)
    bs, ts, fs = np.nonzero(stacked)
    counts = np.bincount(bs, minlength=len(mats))
    idx = np.full((len(mats), cap), FRAMES * bins, np.int32)
    val = np.zeros((len(mats), cap), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    pos = np.arange(len(bs)) - starts[bs]
    idx[bs, pos] = ts.astype(np.int32) * np.int32(bins) + fs.astype(np.int32)
    val[bs, pos] = stacked[bs, ts, fs]
    return {"idx": idx, "val": val}


def train_batches(seed: int, spec: Dict, batch: int) -> List[Dict]:
    """``pool`` batches of ``batch`` 2 s windows at 22.05 kHz: int16 audio,
    sparse COO targets (flat index t * bins + f, sentinel padding, one pow2
    cap per head over the pool, the loader's floors) and unit weights."""
    n_batches = int(spec["pool"])
    n = n_batches * batch
    sr, samples = int(spec["sample_rate"]), int(spec["window_samples"])
    vox = voices(spec["voices"], n)[rng(seed, 5).permutation(n)]
    audio, targets = [], []
    for i in range(n):
        y, notes = tone_mix(rng(seed, 6, i), samples, sr, int(vox[i]), spec["tones"])
        audio.append(to_int16(y))
        targets.append(window_targets(notes))
    caps = {}
    for head in HEAD_BINS:
        most = max(int(np.count_nonzero(t[head])) for t in targets)
        cap = SPARSE_CAP_FLOORS[head]
        while cap < most:
            cap *= 2
        caps[head] = cap
    out = []
    for b in range(n_batches):
        rows = range(b * batch, (b + 1) * batch)
        out.append({
            "audio": np.stack([audio[i] for i in rows]),
            "targets_sparse": {head: _sparse(head, [targets[i][head] for i in rows], caps[head]) for head in ("onset", "contour", "note")},
            "weights": {head: np.ones(batch, np.float32) for head in ("onset", "contour", "note")},
        })
    return out


def dense_targets(batch: Dict) -> Dict[str, np.ndarray]:
    """The dense (B, 172, bins) targets a sparse batch stands for."""
    out = {}
    for head, sp in batch["targets_sparse"].items():
        cells = FRAMES * HEAD_BINS[head]
        flat = np.zeros((sp["idx"].shape[0], cells + 1), np.float32)
        np.put_along_axis(flat, sp["idx"].astype(np.int64), sp["val"], axis=1)
        out[head] = flat[:, :cells].reshape(-1, FRAMES, HEAD_BINS[head])
    return out
