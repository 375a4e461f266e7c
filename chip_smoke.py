#!/usr/bin/env python3
"""Drive the PyTorch port (`basic_pitch_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, its SM clock and maximum SM clock and
     the host's CPU model (also printed by the serving phase), torch/CUDA
     versions, and the build of
     every native source from csrc/, all compilers started together (nvcc
     sm_90a for the kernels, g++ for the codec's host packer and the native
     host library);
  2. each kernel against its plain PyTorch version on the card. The greedy
     decode: seeded fuzz cases, adversarial cases for the kernel's batched
     commit (tests/torch_decode_cases.py, with its re-walk counter), the
     main path's own decode inputs (T = 18 176 frames, max_notes 16 384,
     melodia on), timed at that shape, a dense seeded roll and an 8-voice
     tone mix at the same shape, and one hour of sparse frames (T = 310
     000); for each, the kernel's time with melodia off and on and its
     counters. The codec decode (`pcm_decode`), bit for bit against its
     plain version and pcm / 32768: fixed orders 1-3, LPC and the default
     mode, width ladders reaching every k of KSET, int16 extremes, the LPC
     fuzz, lengths from 1 sample to one 44.1 kHz piece, and the kernel's
     tiling cases (tests/torch_codec_cases.py); its own device time (N
     launches in a CUDA graph over buffers larger than the L2), the
     wrapper's time, the plain version's, the pinned copy of the raw int16
     bytes, its bytes bound (the bytes the kernel touches) and, for LPC, its
     chain bound (248 dependent steps at the latency measured on the card),
     at the piece the codec path decodes (the 10 min recording's last
     piece, its 110 needed windows, ~1.2x), in its default mode and forced to LPC,
     and at a noisy full chunk that the path sends raw;
  3. the main path at full width: StreamingTranscriber(device="cuda",
     windows_per_chunk=128) with the shipped weights transcribes ~60 s
     recordings (22.05 kHz float32, 44.1 kHz int16, and a batch of 4); the
     kernel must launch once per recording, the host fallback must never
     fire, and the synthesised notes must come back; then the 8-voice tone
     mix, and where one recording's wall goes for it and a sparse one. Then
     the transcriber's settings: the upload + model stage for each
     head_precision (highest, high, default) and conv_impl (conv, im2col,
     toeplitz:24, mxu:24), with the posteriorgram difference and the event
     churn against highest/conv on the 8-voice mix (the float32 lowerings
     held to 1e-4 and the one-flip rule); compute_group 1 against 2 on a
     10 min recording of three chunks (ms per chunk; posteriorgrams within
     5e-3, events by the one-flip rule); and the raw, codec and auto
     transports on int16 60 s and 10 min recordings (events identical,
     bytes uploaded, wall, transport.report()); the codec-fed path must
     launch both kernels, and forced codec must raise when its kernel
     cannot be built;
  4. posteriorgrams on the card against the port on the CPU within 1e-4 on
     the tests' golden audio with the process-wide TF32 flags turned on,
     which shows that the "highest" stages keep TF32 off (a transcriber at
     precision="high" is the control, which must break the bound);
  5. the serving surfaces at full width with the shipped weights: the HTTP
     server (8 concurrent 30 s requests whose events must equal
     `transcribe_batch` on the requests the service grouped, run again,
     and a lone `transcribe` wherever the group's model calls have its
     shapes, else agree with it by the one-flip rule with posteriorgrams
     within 1e-3, since a batch's requests share model chunks; csv and midi
     bodies, a chunked /v1/stream
     whose events must arrive before the body ends), `predict_and_save`
     against `predict_and_save_streaming` (the one-flip rule, posteriorgrams
     within 1e-4), the predict CLI in a subprocess and the stream CLI; the
     kernel must launch on every path that decodes on the card, and never
     on the windowed `predict` path, which decodes on the host; then the
     serve CLI in a subprocess with --pcm-transport auto --head-precision
     high, answering two requests;
  6. the model formats: the shipped weights written as nmp.onnx by the
     port's writer and by `basic-pitch-torch-export --format onnx --device
     cuda` (rc 0, the same bytes, its round-trip deviation printed); the
     ONNX file loaded by inference.Model's sniffing, its posteriorgrams on
     the 60 s recording within FOLD_ATOL (1e-5) of the npz model's with
     TF32 off; the kernel against the plain decoder on that model's decode
     inputs; predict_and_save_streaming with the ONNX-loaded Model (one
     kernel launch, counted under "formats"; events equal to the npz
     model's or within the one-flip rule); the exported graph through the
     torch evaluator within 1e-4 of the NMP on 16 noise windows, both timed
     (CUDA events, median of 5); and `--format savedmodel` with tensorflow
     unimportable exiting 2 with the JAX package's message. SavedModel and
     TFLite files reach the card once such a file is in the repository;
  7. training at full width on a synthetic corpus (8 + 2 tracks of 10 s,
     written with the port's own TFRecord writer): one train step from the
     shipped weights on 16 windows on the card and on the CPU (loss within
     1e-6 relative, each gradient within 1e-3 of its tensor's largest; the
     CPU in float64 beside it shows float32's own error, and a TF32 step is
     the control that must break the bounds), a step on the loader's targets
     with random-walk PCM16 audio fed codec-packed (audio and targets
     bit-equal to the raw batch on the card, the same loss within 1e-6), step, forward and eval times at batch 16 for each
     precision with windows/s and peak memory, the loss falling over 5
     steps, the train CLI in a subprocess for two epochs and then in process
     for a third (it must resume), and the trained checkpoint transcribed by
     the transcriber, its notes from the kernel equal to the plain
     decoder's;
  8. the data, scoring and measurement path: a synthetic GuitarSet-layout
     corpus (6 tone mixes of 10 s at 44.1 kHz with JAMS of their notes)
     built by `basic-pitch-torch-download guitarset` in a subprocess (shard
     count and wall printed), two train steps on the card from those shards
     (`basic-pitch-torch-train --guitarset --device cuda`, rc 0, a
     checkpoint written), `basic-pitch-torch-eval --device cuda` in
     transcribe mode on one mix's WAV against the MIDI `predict_and_save`
     wrote on the card from it (F1 must be 1.0) and against its JAMS
     (recall >= 0.8); the MFU of the model stage (model only, one resident
     128-window chunk, CUDA events) at highest/conv, highest/toeplitz:24
     and high/conv against the H100's peak for each precision
     (`utils/flops.py`); and a `torch.profiler` trace of one 60 s
     transcribe (`utils/profiling.py`, written under
     basic_pitch_torch/build/) with its top 5 CUDA kernels, the device's
     busy share and the peak allocated memory; the trace must hold CUDA
     kernels, greedy_decode among them (its launch counted as "measure"),
     and no pcm_decode launch (the transport probe is refreshed before the
     trace and no call starts a re-probe);
  9. parallel and native: the transcriber over ["cuda:0", "cuda:0"] (the
     card's host has one GPU, so a repeated device is the list it can run)
     at W = 128 with the shipped weights, on the 8-voice 60 s mix and the
     60 s 44.1 kHz int16 recording: events and posteriorgrams equal bit
     for bit to one device at 64 windows (the shards' model batch), and
     against one device at 128 windows, whose cuDNN kernels round apart,
     posteriorgrams within 1e-3 (the card read 2.81e-4) and events by the
     one-flip rule (the amplitude difference printed); one greedy_decode launch per recording
     (counted as "parallel"), each shard's upload bytes at most the
     recording's whole chunks' / 2 plus the halo of each chunk, no bytes
     from a row that owns none of the needed windows, and forced codec
     on that recording and phase 3's 60 s 22.05 kHz int16 mix launching
     pcm_decode once per uploaded piece that packs smaller, at least once
     ("parallel_codec"), with the raw run's events; the wall
     of the sharded run against the single device's. Then data-parallel
     training: two `parallel.selfcheck` processes with gloo, both on cuda:0
     (NCCL refuses two ranks on one GPU), against one process on the same
     global batch of 16 (each step, dense and sparse, from the initial
     parameters: losses within 1e-5 relative, gradients by the training
     phase's rule, 1e-3 of each tensor's largest and 1e-6 for the
     pre-batch-norm biases, and parameters within 1e-3 wherever the
     gradient exceeds 1e-3 of its tensor's largest: Adam moves an element
     whose gradient is float32 noise by +-lr either way), each subprocess
     under a timeout, and one step in a world of one NCCL process. Then the native host library: WAV decode at 16/24/32-bit and
     float, decimation 44.1 -> 22.05 kHz and CRC32C over the phase-8
     records, each bit-equal to the numpy path, with MB/s of both beside
     the card's name and power limit and the host CPU; a call that took
     the numpy path fails the phase;
  10. MT3 at its published widths (seeded weights): one `transcribe_batch`
     call of 8 x 60 s 44.1 kHz int16 tone mixes of 12-16 voices (240
     segments, one decode batch) with codec token budgets (the reference's
     encoder of each segment's notes into tokens), once to capture the
     step's graphs and once under a `torch.profiler` trace (written under
     basic_pitch_torch/build/); every segment must emit its budget, and the
     trace must hold 16 `_mt3_cache_attention` launches per decode step
     (8 layers x self and cross; the counts come from the trace, since
     graph replays pass no wrapper), with their device time against the
     bytes the launches read at 3.35 TB/s. Then the kernel on that call's
     own caches, every layer's self view at lengths 1, 64, the median and
     the largest budget and its cross view at 256 frames, against the
     float64 plain version within 2e-6 of each case's largest output, and
     timed per launch (a CUDA graph over the 8 layers' views) beside its
     bytes bound, the plain version and `scaled_dot_product_attention`;
  11. a JSON line listing every hand kernel (greedy_decode, pcm_decode,
     _mt3_cache_attention) with its launches on the paths driven (their
     sum, the split beside it), its error against the plain version and its
     times;
  12. as the last line, {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io
import json
import logging
import pathlib
import struct
import subprocess
import sys
import time
from typing import Any, Callable, List, Tuple

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
SR = 22050
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (same sheet)


def tone_mix(sr: int, seconds: float, seed: int, noise: float = 0.01, voices: int = 1, offsets: bool = False) -> Tuple[np.ndarray, List[tuple]]:
    """Seeded polyphonic mix of harmonic tones over a noise floor: `voices`
    independent streams of notes (each note 0.5-1.2 s, a new one every
    0.35-0.7 s), so about 1.5 x voices notes sound at once. Returns
    (float32 audio, list of (onset seconds, MIDI pitch)), or of (onset
    seconds, offset seconds, MIDI pitch) with ``offsets``."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    y = noise * rng.randn(n)
    notes = []
    gain = 0.25 / voices ** 0.5
    for _ in range(voices):
        t_start = 0.3 + (float(rng.uniform(0.0, 0.35)) if voices > 1 else 0.0)
        while t_start < seconds - 1.0:
            midi = int(rng.randint(45, 82))
            dur = float(rng.uniform(0.5, 1.2))
            f0 = 440.0 * 2 ** ((midi - 69) / 12)
            i0, i1 = int(t_start * sr), min(n, int((t_start + dur) * sr))
            tt = np.arange(i1 - i0) / sr
            env = np.exp(-1.5 * tt) * np.minimum(1.0, tt / 0.005)
            y[i0:i1] += gain * env * (np.sin(2 * np.pi * f0 * tt) + 0.4 * np.sin(4 * np.pi * f0 * tt))
            notes.append((t_start, min(t_start + dur, seconds), midi) if offsets else (t_start, midi))
            t_start += float(rng.uniform(0.35, 0.7))
    return y.astype(np.float32), notes


def piano_roll(n_frames: int, n_notes: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded dense (T, 88) note/onset posteriorgrams: n_notes held notes of
    10-200 frames over low background activity, some of it above the frame
    threshold, so both greedy stages have work."""
    rng = np.random.RandomState(seed)
    frames = (rng.rand(n_frames, 88) ** 8 * 0.45).astype(np.float32)
    onsets = (rng.rand(n_frames, 88) ** 8 * 0.3).astype(np.float32)
    for _ in range(n_notes):
        p, s, length = rng.randint(0, 88), rng.randint(2, n_frames - 250), rng.randint(10, 200)
        level = rng.uniform(0.4, 0.9) * (1 + 0.1 * rng.randn(length)).clip(0.5, 1.1)
        frames[s : s + length, p] = np.maximum(frames[s : s + length, p], level)
        onsets[s - 1 : s + 2, p] = np.maximum(onsets[s - 1 : s + 2, p], [0.3, rng.uniform(0.6, 0.95), 0.3])
    return frames, onsets


def sparse_roll(n_frames: int, n_notes: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded (T, 88) posteriorgrams of a long recording with sparse notes:
    background below the frame threshold, n_notes notes of 10-200 frames,
    one note of 5000 frames and one held to the last frame, so walks cross
    many table blocks and the no-stop tail is taken."""
    rng = np.random.RandomState(seed)
    frames = (rng.rand(n_frames, 88) * 0.2).astype(np.float32)
    onsets = (rng.rand(n_frames, 88) * 0.1).astype(np.float32)
    spans = [(rng.randint(0, 88), rng.randint(2, n_frames - 250), rng.randint(10, 200)) for _ in range(n_notes)]
    spans += [(30, n_frames // 3, 5000), (50, n_frames - 300, 300)]
    for p, s, length in spans:
        frames[s : s + length, p] = rng.uniform(0.4, 0.9)
        onsets[s - 1 : s + 2, p] = (0.3, rng.uniform(0.6, 0.95), 0.3)
    return frames, onsets


def recall(events: List[tuple], notes: List[Tuple[float, int]], tol_s: float = 0.1) -> float:
    """Share of synthesised notes with a decoded event of the same pitch
    whose onset lies within tol_s."""
    hits = sum(any(e[2] == midi and abs(e[0] - t0) <= tol_s for e in events) for t0, midi in notes)
    return hits / max(len(notes), 1)


def compare_decoded(out: Any, ref: Any) -> float:
    """Kernel result against plain result: counts, flags, starts, ends and
    pitches exact, amplitudes within 2e-6. Returns the max amplitude error."""
    n_out, n_ref = int(out.n_notes), int(ref.n_notes)
    if n_out != n_ref or bool(out.overflow) != bool(ref.overflow):
        raise AssertionError(f"n_notes/overflow differ: kernel {n_out}/{bool(out.overflow)} plain {n_ref}/{bool(ref.overflow)}")
    for field in ("starts", "ends", "pitches"):
        a = getattr(out, field)[:n_out].cpu().numpy()
        b = getattr(ref, field)[:n_ref].cpu().numpy()
        if not np.array_equal(a, b):
            bad = int(np.flatnonzero(a != b)[0])
            raise AssertionError(f"{field} differ first at note {bad}: kernel {a[bad]} plain {b[bad]}")
    err = float(np.abs(out.amplitudes[:n_out].cpu().numpy() - ref.amplitudes[:n_ref].cpu().numpy()).max(initial=0.0))
    if err > 2e-6:
        raise AssertionError(f"amplitudes differ by {err} > 2e-6")
    return err


def cuda_ms(fn: Callable[[], Any], reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_median_ms(fn: Callable[[], Any], reps: int) -> float:
    """Median of ``reps`` calls, each timed alone with CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def clocks_and_host() -> str:
    """The card's SM clock now and its maximum, and the host's CPU model:
    what tells two runs' machines apart beside the card's name and power
    limit."""
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return f"clocks.sm, clocks.max.sm: {clocks}; host CPU: {host_cpu()}"


def host_cpu() -> str:
    """The CPU model from /proc/cpuinfo's first processor (else lscpu's),
    with the architecture, the logical CPU count and the family/model
    numbers, which name the generation where the model name is missing."""
    import os
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name")
    if not name:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
            name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines() if ln.startswith("Model name:")), None)
        except (OSError, subprocess.SubprocessError):
            name = None
    ids = ", ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "CPU implementer", "CPU part") if k in info)
    return f"{name or 'unknown'} ({platform.machine()}, {os.cpu_count()} logical CPUs{', ' + ids if ids else ''})"


def stage_split(greedy_kernel: Any, inputs: Any, min_note_len: int, max_notes: int, max_iters: int, reps: int) -> dict:
    """The kernel alone with melodia off (stage 1 only) and on (both
    stages), timed with CUDA events, and its counters: onset candidates,
    notes kept and, where the wrapper returns the kernel's meta, melodia
    iterations (meta[2]) and re-walks (meta[3]). An older checkout, whose
    `greedy_stages` returns no meta, gives a row without those counters:
    chip_decode_times.py times such a checkout beside this one."""
    row = {"candidates": int(inputs.n_onsets)}
    for melodia in (False, True):
        def call() -> Any:
            return greedy_kernel.greedy_stages(inputs, 0.3, min_note_len, 11, max_notes, max_iters, melodia)

        res = call()
        tag = "both" if melodia else "stage1"
        row[f"{tag}_ms"] = cuda_ms(call, reps)
        row[f"{tag}_notes"] = int(res[1])
        if len(res) > 3:
            meta = res[3].cpu().tolist()
            row[f"{tag}_rewalks"] = meta[3]
            if melodia:
                row["melodia_iters"] = meta[2]
    row["us_per_candidate"] = row["stage1_ms"] * 1e3 / max(row["candidates"], 1)
    if "melodia_iters" in row:
        row["us_per_melodia_iter"] = (row["both_ms"] - row["stage1_ms"]) * 1e3 / max(row["melodia_iters"], 1)
    return row


def print_split(name: str, row: dict) -> None:
    print(
        f"stage split [{name}]: stage 1 alone {row['stage1_ms']:.4f} ms for {row['candidates']} candidates, "
        f"{row['stage1_notes']} notes kept, {row['stage1_rewalks']} re-walks "
        f"({row['us_per_candidate']:.3f} us per candidate); both stages {row['both_ms']:.4f} ms, "
        f"{row['melodia_iters']} melodia iterations, {row['both_notes']} notes, {row['both_rewalks']} re-walks "
        f"({row['us_per_melodia_iter']:.3f} us per melodia iteration)"
    )


def breakdown(tr: Any, pipeline: Any, audio: np.ndarray, sr: int, reps: int) -> dict:
    """Where one recording's wall goes, synchronised after each stage (so
    the stages do not overlap here as they do in transcribe)."""
    import torch

    stages = {"upload+model": 0.0, "decode": 0.0, "fetch+assembly": 0.0}
    for _ in range(reps):
        t0 = time.perf_counter()
        out, n_frames, n_chunks = tr._forward(audio, sr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ticket = tr._decode_dispatch(out, n_frames, n_chunks, pipeline.DecodeOptions(), 16384)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tr._collect_many([ticket])
        t3 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key] += dt / reps
    return stages


def write_float_wav(path: pathlib.Path, samples: np.ndarray, sr: int) -> None:
    """IEEE float32 WAV (format tag 3), one column per channel."""
    x = np.asarray(samples, np.float32)
    x = x[:, None] if x.ndim == 1 else x
    payload = x.astype("<f4").tobytes()
    ch = x.shape[1]
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, ch, sr, sr * ch * 4, ch * 4, 32))
        fh.write(b"data" + struct.pack("<I", len(payload)) + payload)


def read_csv_events(path: pathlib.Path) -> List[Tuple[float, float, int]]:
    rows = path.read_text().splitlines()[1:]
    return [(float(r.split(",")[0]), float(r.split(",")[1]), int(r.split(",")[2])) for r in rows]


def events_agree(events: List[tuple], ref: List[tuple], tol_s: float = 0.05) -> int:
    """The one-flip rule: counts within one, and all but one reference event
    has a distinct counterpart of the same pitch with start and end within
    tol_s. Returns the number matched; raises when the rule fails."""
    free = list(events)
    matched = 0
    for s, e, p, *_ in ref:
        hit = next((x for x in free if x[2] == p and abs(x[0] - s) < tol_s and abs(x[1] - e) < tol_s), None)
        if hit is not None:
            free.remove(hit)
            matched += 1
    if abs(len(events) - len(ref)) > 1 or matched < len(ref) - 1:
        raise AssertionError(f"events disagree: {len(events)} vs {len(ref)}, {matched} matched")
    return matched


def served_against_groups(
    tr: Any, groups: list, pcms: List[np.ndarray], served: List[list], lone: List[list], lone_post: List[dict]
) -> int:
    """Each served response against its group run again: the service's
    ``groups`` (recordings and parameters of each `transcribe_batch` call it
    made) through `transcribe_batch` with the model outputs, whose events
    must equal the responses bit for bit. Against a lone `transcribe`
    (``lone``, ``lone_post``): posteriorgrams within 1e-3; events equal where
    the group's model calls have the lone request's shapes, else the
    one-flip rule with the amplitudes and pitch bends of events of the same
    start, end and pitch within 1e-3 and 1. Returns how many responses equal
    the lone events."""
    from basic_pitch_torch import pipeline

    def call_sizes(recordings: list) -> List[int]:
        chunks = -(-sum(pipeline._needed_windows(len(a), sr != SR) for a, sr in recordings) // tr.w)
        return [min(tr.compute_group, chunks - c) * tr.w for c in range(0, chunks, tr.compute_group)]

    def as_json(events: list) -> list:
        return [(s, e, p, a, list(b) if b is not None else None) for s, e, p, a, b in events]

    seen, equal = [], 0
    for recordings, params in groups:
        owners = [next(i for i, x in enumerate(pcms) if len(x) == len(a) and np.array_equal(x, a)) for a, _ in recordings]
        again = tr.transcribe_batch(recordings, return_model_outputs=True, **params)
        sizes = call_sizes(recordings)
        for i, (events, outputs), rec in zip(owners, again, recordings):
            if served[i] != as_json(events):
                raise AssertionError(f"request {i}: served events differ from transcribe_batch on its group {owners}")
            gap = max(float(np.abs(outputs[k] - lone_post[i][k]).max()) for k in lone_post[i])
            if gap > 1e-3:
                raise AssertionError(f"request {i} in group {owners}: posteriorgrams {gap:.3g} from a lone call (bound 1e-3)")
            want = as_json(lone[i])
            if sizes == call_sizes([rec]) and served[i] != want:
                raise AssertionError(f"request {i} in group {owners}, model calls {sizes} as a lone call's: events differ")
            events_agree(served[i], want)
            twins = {tuple(e[:3]): e for e in want}
            for s, e, p, a, b in served[i]:
                x = twins.get((s, e, p))
                if x is None:
                    continue
                bend_gap = max((abs(u - v) for u, v in zip(b or [], x[4] or [])), default=0)
                if abs(a - x[3]) > 1e-3 or (b is None) != (x[4] is None) or len(b or []) != len(x[4] or []) or bend_gap > 1:
                    raise AssertionError(f"request {i} in group {owners}: note ({s}, {e}, {p}) amplitude or bends apart")
            equal += served[i] == want
        seen += owners
    if sorted(seen) != list(range(len(pcms))):
        raise AssertionError(f"the service's groups hold requests {sorted(seen)}")
    return equal


def post_stream(base: str, pcm: np.ndarray, piece_s: float = 1.0) -> Tuple[List[dict], float, bool]:
    """POST raw s16le to /v1/stream with a chunked body. Returns (events,
    seconds from the first byte sent to the first event, whether an event
    arrived before the body's terminating chunk was sent)."""
    import socket

    host, port = base[len("http://"):].rsplit(":", 1)
    raw = pcm.astype("<i2").tobytes()
    step = int(piece_s * SR) * 2
    sock = socket.create_connection((host, int(port)), timeout=120)
    try:
        t0 = time.perf_counter()
        sock.sendall(b"POST /v1/stream HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n\r\n")
        for i in range(0, len(raw), step):
            piece = raw[i : i + step]
            sock.sendall(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
        got = b""
        while b"pitch_midi" not in got:
            data = sock.recv(65536)
            if not data:
                break
            got += data
        first_event_s = time.perf_counter() - t0
        early = b"pitch_midi" in got
        sock.sendall(b"0\r\n\r\n")
        while not got.endswith(b"\r\n0\r\n\r\n"):
            data = sock.recv(65536)
            if not data:
                break
            got += data
    finally:
        sock.close()
    header, _, body = got.partition(b"\r\n\r\n")
    if b" 200 " not in header.split(b"\r\n")[0]:
        raise AssertionError(f"/v1/stream answered {header[:80]!r}")
    payload, pos = b"", 0
    while True:
        eol = body.index(b"\r\n", pos)
        size = int(body[pos:eol], 16)
        if size == 0:
            break
        payload += body[eol + 2 : eol + 2 + size]
        pos = eol + 4 + size
    events = [json.loads(line) for line in payload.decode().splitlines() if line]
    if any("error" in e for e in events):
        raise AssertionError(f"/v1/stream reported {events}")
    return events, first_event_s, early


def quiet_bin_report(model: Any, path: pathlib.Path) -> str:
    """Why two float32 paths' posteriorgrams differ on tonal audio: the
    model's dB normalisation subtracts each window's quietest CQT bin, whose
    magnitude can sit far below the absolute float32 rounding of the loud
    bins' sums, so a summation order that changes with the batch (or the
    device) shifts the whole window. Runs the file's windows through the
    model at batch 32 (the windowed path's bucket) and 128 (the
    transcriber's chunk) on the card and on the CPU, and reports the
    posteriorgram differences beside the CQT's error relative to each
    window's peak and at each window's quietest bin."""
    import torch

    from basic_pitch_torch import inference

    windows, _, _ = inference.get_audio_input(path, 7680, 36164)
    n = len(windows)
    cpu = inference.Model(device="cpu")
    runs = {}
    with torch.inference_mode():
        for name, module, batch in (("card32", model.module, 32), ("card128", model.module, 128), ("cpu", cpu.module, n)):
            x = torch.from_numpy(np.pad(windows, ((0, batch - n), (0, 0)))).to(next(module.parameters()).device)
            cqt = module.cqt(x)[:n].cpu().numpy().reshape(n, -1)
            post = {k: v[:n].cpu().numpy() for k, v in module(x).items()}
            runs[name] = (cqt, post)
    ref_cqt, ref_post = runs["cpu"]
    quiet = ref_cqt.argmin(axis=1)
    live = ref_cqt[np.arange(n), quiet] > 0  # windows of zero padding have an exact zero minimum

    def post_diff(a: str, b: str) -> float:
        return max(float(np.abs(runs[a][1][k] - runs[b][1][k]).max()) for k in ref_post)

    peak_err = max(float((np.abs(runs[c][0] - ref_cqt).max(axis=1) / ref_cqt.max(axis=1)).max()) for c in ("card32", "card128"))
    quiet_err = max(
        float(np.abs(runs[c][0][np.arange(n), quiet][live] / ref_cqt[np.arange(n), quiet][live] - 1).max())
        for c in ("card32", "card128")
    )
    return (
        f"quiet bins [{path.name}, {n} windows]: posteriorgram max diff card batch 32 vs 128 {post_diff('card32', 'card128'):.3g}, "
        f"card vs cpu {post_diff('card32', 'cpu'):.3g} (32) / {post_diff('card128', 'cpu'):.3g} (128); CQT error card vs cpu "
        f"up to {peak_err:.2g} of the window's peak, but up to {quiet_err:.2g} of the window's quietest bin "
        f"(quietest/peak down to {float((ref_cqt[np.arange(n), quiet][live] / ref_cqt.max(axis=1)[live]).min()):.2g})"
    )


def serving_phase() -> dict:
    """The port's user surfaces at full width on the card: the HTTP server
    (make_server over TranscriptionService over StreamingTranscriber, as
    cli/serve.py builds it), the library's predict_and_save and
    predict_and_save_streaming, the predict CLI in a subprocess and the
    stream CLI in process. Returns the greedy-decode kernel's launches on
    each path (each count set to 0 just before its path and read just
    after)."""
    import tempfile
    import threading
    import urllib.request

    from basic_pitch_torch import inference, pipeline, serve
    from basic_pitch_torch.cli import serve as serve_cli
    from basic_pitch_torch.cli import stream as stream_cli
    from basic_pitch_torch.decode import greedy_kernel
    from basic_pitch_torch.utils import audio as audio_io
    from basic_pitch_torch.utils import midi as midi_io

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"serving phase on {smi}")
    print(clocks_and_host())
    t_phase = time.perf_counter()
    launches = {}

    # ---- HTTP: 8 concurrent 30 s requests, csv, midi, one stream ----
    transcriber = pipeline.StreamingTranscriber(windows_per_chunk=128)
    serve_cli._warm(transcriber, "10")
    wavs, pcms, expected, expected_post = [], [], [], []
    for i in range(8):
        y, _ = tone_mix(SR, 30.0, seed=400 + i, voices=1 if i < 4 else 8)
        buf = io.BytesIO()
        audio_io.write_wav(buf, y, SR)
        wavs.append(buf.getvalue())
        pcms.append(np.frombuffer(wavs[-1][44:], "<i2"))
        # the reference: the same int16 samples through transcribe, on this
        # thread, before the service's dispatch thread owns the transcriber
        expected.append(transcriber.transcribe(pcms[-1], SR))
        expected_post.append(transcriber.posteriorgrams(pcms[-1], SR))
    stream_audio, stream_notes = tone_mix(SR, 20.0, seed=500)
    stream_pcm = np.clip(np.round(stream_audio * 32768.0), -32768, 32767).astype(np.int16)

    service = serve.TranscriptionService(transcriber, max_batch=8, max_wait_ms=25.0)
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]

    def post(path: str, body: bytes) -> Tuple[int, bytes]:
        req = urllib.request.Request(base + path, data=body)
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()

    try:
        info = json.loads(urllib.request.urlopen(base + "/healthz", timeout=30).read())
        if info["decode_backend"] != "kernel" or info["pcm_transport"] != "auto":
            raise AssertionError(f"/healthz on the card says {info}")
        greedy_kernel.launches = 0
        m0 = service.snapshot_metrics()
        # the service's transcribe_batch calls, each with the recordings it grouped
        groups: List[Tuple[List[Tuple[np.ndarray, int]], dict]] = []

        def spy(recordings: List[Tuple[np.ndarray, int]], **params: Any) -> list:
            groups.append(([(np.array(a), sr) for a, sr in recordings], params))
            return batch_call(recordings, **params)

        batch_call, transcriber.transcribe_batch = transcriber.transcribe_batch, spy
        results: List[Any] = [None] * 8
        latency = [0.0] * 8
        barrier = threading.Barrier(8)

        def hit(i: int) -> None:
            barrier.wait()
            t0 = time.perf_counter()
            results[i] = post("/v1/transcribe", wavs[i])
            latency[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        del transcriber.transcribe_batch  # the spy
        m1 = service.snapshot_metrics()
        served = []
        for i, (status, body) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: status {status}")
            notes = json.loads(body)["notes"]
            served.append([(n["start_time_s"], n["end_time_s"], n["pitch_midi"], n["amplitude"], n["pitch_bends"]) for n in notes])
        batches = m1["batches"] - m0["batches"]
        if not batches < 8:
            raise AssertionError(f"8 concurrent requests took {batches} batches: no batching")
        status, body = post("/v1/transcribe?format=csv", wavs[0])
        if status != 200 or body != serve._events_csv(expected[0]):
            raise AssertionError("format=csv differs from the port's writer on the same events")
        status, body = post("/v1/transcribe?format=midi", wavs[4])
        if status != 200 or body != serve._events_midi(expected[4], 120.0, False):
            raise AssertionError("format=midi differs from the port's writer on the same events")
        m2 = service.snapshot_metrics()
        launches["serve"] = greedy_kernel.launches

        greedy_kernel.launches = 0
        stream_events, first_event_s, early = post_stream(base, stream_pcm)
        launches["stream_route"] = greedy_kernel.launches
        m3 = service.snapshot_metrics()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()

    served_equal = served_against_groups(transcriber, groups, pcms, served, expected, expected_post)
    requests = m2["requests"] - m0["requests"]
    flushes = m3["stream_flushes"] - m2["stream_flushes"]
    if launches["serve"] < requests or launches["stream_route"] < flushes or flushes < 1:
        raise AssertionError(f"kernel launches {launches} for {requests} requests and {flushes} stream flushes")
    if not early:
        raise AssertionError("no stream event arrived before the request body ended")
    stream_tuples = [(e["start_time_s"], e["end_time_s"], e["pitch_midi"]) for e in stream_events]
    r_stream = recall(stream_tuples, stream_notes)
    if r_stream < 0.8:
        raise AssertionError(f"/v1/stream recall {r_stream:.3f} < 0.8")
    lat = np.array(latency)
    print(
        f"serve: 8 concurrent 30 s requests (4 sparse, 4 8-voice) in {wall * 1e3:.1f} ms, "
        f"{8 / wall:.1f} requests/s; latency p50 {np.median(lat) * 1e3:.1f} ms, max {lat.max() * 1e3:.1f} ms; "
        f"{batches} batches ({batches / 8:.3f} per request); x_realtime_busy {m1['x_realtime_busy']} "
        f"(service lifetime {m2['x_realtime_busy']}); events equal transcribe_batch on the service's groups on all 8 "
        f"(equal to a lone transcribe on {served_equal}); csv and midi bytes equal"
    )
    print(
        f"serve: /v1/stream of 20 s: {flushes} flushes, {len(stream_events)} events, recall {r_stream:.3f}, "
        f"first event {first_event_s * 1e3:.1f} ms after the first byte (body sent unpaced)"
    )

    # ---- library and CLI ----
    lib_audio, lib_notes = tone_mix(SR, 30.0, seed=600)
    left, _ = tone_mix(2 * SR, 30.0, seed=601)
    right = left + 0.01 * np.random.RandomState(602).randn(len(left)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = pathlib.Path(tmp_name)
        files = [tmp / "pcm16_22k_mono.wav", tmp / "float_44k_stereo.wav"]
        audio_io.write_wav(files[0], lib_audio, SR)
        write_float_wav(files[1], np.stack([left, right], axis=1), 2 * SR)
        model = inference.Model()
        dirs = {name: tmp / name for name in ("warm", "windowed", "batched", "cli")}
        for d in dirs.values():
            d.mkdir()
        # first calls at these bucket shapes, outside the timed runs
        inference.predict_and_save(files[:1], dirs["warm"], False, False, False, False, model)
        inference.predict_and_save_streaming(files[:1], dirs["warm"], False, False, False, False, model)

        greedy_kernel.launches = 0
        t0 = time.perf_counter()
        inference.predict_and_save(files, dirs["windowed"], True, False, True, True, model)
        wall_windowed = time.perf_counter() - t0
        launches["predict_windowed"] = greedy_kernel.launches
        greedy_kernel.launches = 0
        t0 = time.perf_counter()
        inference.predict_and_save_streaming(files, dirs["batched"], True, False, True, True, model)
        wall_batched = time.perf_counter() - t0
        launches["predict_streaming"] = greedy_kernel.launches
        if launches["predict_windowed"] != 0 or launches["predict_streaming"] != len(files):
            raise AssertionError(f"kernel launches {launches}: the windowed path decodes on the host, the batched one on the card")
        for f in files:
            stem = f.stem + "_basic_pitch"
            ref = read_csv_events(dirs["windowed"] / f"{stem}.csv")
            out = read_csv_events(dirs["batched"] / f"{stem}.csv")
            matched = events_agree(out, ref)
            a = np.load(dirs["windowed"] / f"{stem}.npz", allow_pickle=True)["basic_pitch_model_output"].item()
            b = np.load(dirs["batched"] / f"{stem}.npz", allow_pickle=True)["basic_pitch_model_output"].item()
            diffs = {k: float(np.abs(a[k] - b[k]).max()) for k in ("note", "onset", "contour")}
            print(f"predict [{f.name}]: windowed {len(ref)} events, streaming {len(out)}, {matched} matched; posteriorgram max diff {diffs}")
            # the bound the JAX package's own test holds this comparison to
            # (tests/test_inference.py:147); quiet_bin_report says why two
            # float32 paths on tonal audio differ by more than 1e-4
            if max(diffs.values()) > 5e-3:
                raise AssertionError(f"{f.name}: windowed and streaming posteriorgrams differ by more than 5e-3")
        print(quiet_bin_report(model, files[0]))
        r_lib = recall(read_csv_events(dirs["batched"] / f"{files[0].stem}_basic_pitch.csv"), lib_notes)
        if r_lib < 0.8:
            raise AssertionError(f"predict_and_save_streaming recall {r_lib:.3f} < 0.8")
        print(
            f"predict: wall per 30 s file, windowed (model on the card, host decode) {wall_windowed / 2 * 1e3:.1f} ms, "
            f"streaming (transcriber, kernel decode) {wall_batched / 2 * 1e3:.1f} ms; recall {r_lib:.3f}"
        )

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "basic_pitch_torch.cli.predict", str(dirs["cli"]), str(files[0]), "--streaming"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        wall_cli = time.perf_counter() - t0
        if proc.returncode != 0 or "Done" not in proc.stdout:
            raise AssertionError(f"predict CLI failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")

        def note_count(path: pathlib.Path) -> int:
            return sum(len(inst.notes) for inst in midi_io.read_midi(path).instruments)

        n_cli = note_count(dirs["cli"] / f"{files[0].stem}_basic_pitch.mid")
        n_lib = note_count(dirs["batched"] / f"{files[0].stem}_basic_pitch.mid")
        if n_cli != n_lib or n_cli == 0:
            raise AssertionError(f"predict CLI wrote {n_cli} MIDI notes, the library {n_lib}")
        print(f"predict CLI --streaming (subprocess, start-up included): {wall_cli:.2f} s, {n_cli} MIDI notes as the library")

    greedy_kernel.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    stream_cli.main([], stdin=io.BytesIO(stream_pcm.tobytes()), stdout=out)
    wall_stream_cli = time.perf_counter() - t0
    launches["stream_cli"] = greedy_kernel.launches
    cli_events = [json.loads(line) for line in out.getvalue().splitlines()]
    r_cli = recall([(e["start_time_s"], e["end_time_s"], e["pitch_midi"]) for e in cli_events], stream_notes)
    if launches["stream_cli"] < 1 or r_cli < 0.8:
        raise AssertionError(f"stream CLI: {launches['stream_cli']} launches, recall {r_cli:.3f}")
    print(f"stream CLI (windows_per_chunk 16) on 20 s: {len(cli_events)} events, recall {r_cli:.3f}, {wall_stream_cli:.2f} s")
    print(f"serving phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def formats_phase(smi: str, main_audio: np.ndarray) -> int:
    """The model formats on the card (see the module docstring, phase 6):
    the shipped weights exported as ONNX by the port's writer and by
    basic-pitch-torch-export, loaded back by inference.Model's sniffing,
    transcribed through the greedy-decode kernel, and run by the torch
    evaluator. Returns the kernel's launches on the format-loaded path (the
    count set to 0 just before predict_and_save_streaming and read just
    after)."""
    import contextlib
    import tempfile
    from unittest import mock

    import torch

    import basic_pitch_torch.models as models_pkg
    from basic_pitch_torch import inference, pipeline
    from basic_pitch_torch.cli import export as export_cli
    from basic_pitch_torch.decode import device as device_decode
    from basic_pitch_torch.decode import greedy_kernel
    from basic_pitch_torch.models import nmp, onnx_eval, onnx_export
    from basic_pitch_torch.models import params as params_io
    from basic_pitch_torch.utils import audio as audio_io

    print(f"formats phase on {smi}")
    t_phase = time.perf_counter()
    heads = ("note", "onset", "contour")
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = pathlib.Path(tmp_name)
        # ---- export: the writer, and the export CLI verifying on the card ----
        onnx_path = tmp / "nmp.onnx"
        onnx_export.export_onnx(params_io.load_flat(), onnx_path)
        cli_out = io.StringIO()
        with contextlib.redirect_stdout(cli_out):
            rc = export_cli.main([str(tmp / "cli"), "--format", "onnx", "--device", "cuda"])
        if rc != 0 or (tmp / "cli" / "nmp.onnx").read_bytes() != onnx_path.read_bytes():
            raise AssertionError(f"basic-pitch-torch-export --format onnx --device cuda: rc {rc}\n{cli_out.getvalue()}")
        deviation = next(line for line in cli_out.getvalue().splitlines() if "round-trip max deviation" in line)
        print(f"basic-pitch-torch-export --format onnx --device cuda: rc 0, the writer's bytes; {deviation}")

        # ---- forward: the ONNX-loaded model against the npz one, TF32 off ----
        onnx_model = inference.Model(onnx_path, device="cuda")
        npz_model = inference.Model(device="cuda")
        tr_onnx = pipeline.StreamingTranscriber(onnx_model.module, windows_per_chunk=128, device="cuda")
        tr_npz = pipeline.StreamingTranscriber(npz_model.module, windows_per_chunk=128, device="cuda")
        pg_onnx = tr_onnx.posteriorgrams(main_audio, SR)
        pg_npz = tr_npz.posteriorgrams(main_audio, SR)
        d_fold = {k: float(np.abs(pg_onnx[k] - pg_npz[k]).max()) for k in heads}
        print(f"ONNX-loaded model vs npz model on the 60 s recording (TF32 off): max abs diff {d_fold}")
        if max(d_fold.values()) > 1e-5:
            raise AssertionError(f"the ONNX round trip moved posteriorgrams by {max(d_fold.values())} > FOLD_ATOL 1e-5")

        # ---- transcribe: kernel against plain on the ONNX model's inputs ----
        with torch.inference_mode():
            out, n_frames, n_chunks = tr_onnx._forward(main_audio, SR)
            note, onset, _, floor = tr_onnx.decode_inputs(out, n_frames, n_chunks)
        T = note.shape[0]
        max_notes = max(16384, floor)
        kw = dict(max_notes=max_notes, max_melodia_iters=2 * max_notes + 2 * T, valid_frames=n_frames)
        out_k = greedy_kernel.decode_greedy(note, onset, 0.5, 0.3, 11, **kw)
        ref_p = device_decode.decode_plain(note, onset, 0.5, 0.3, 11, **kw)
        err = compare_decoded(out_k, ref_p)
        print(f"kernel == plain [ONNX-loaded model, T={T}]: {int(out_k.n_notes)} notes, max amp err {err:.3g}")

        wav = tmp / "recording.wav"
        audio_io.write_wav(wav, main_audio, SR)
        (tmp / "npz").mkdir()
        (tmp / "onnx").mkdir()
        inference.predict_and_save_streaming([wav], tmp / "npz", False, False, False, True, npz_model)
        greedy_kernel.launches = 0
        t0 = time.perf_counter()
        inference.predict_and_save_streaming([wav], tmp / "onnx", False, False, False, True, onnx_model)
        wall = time.perf_counter() - t0
        launches = greedy_kernel.launches
        if launches != 1:
            raise AssertionError(f"the ONNX-loaded path launched the kernel {launches} times for one recording")
        got = read_csv_events(tmp / "onnx" / "recording_basic_pitch.csv")
        ref = read_csv_events(tmp / "npz" / "recording_basic_pitch.csv")
        matched = events_agree(got, ref)
        differ = len(set(got) ^ set(ref))
        print(
            f"predict_and_save_streaming with the ONNX-loaded Model: {len(got)} events (npz model {len(ref)}), "
            f"{differ} differ exactly, {matched} matched by the one-flip rule; {launches} kernel launch; {wall * 1e3:.1f} ms"
        )

        # ---- the torch evaluator on the exported graph ----
        graph = onnx_eval.OnnxGraph(onnx_path)
        rng = np.random.default_rng(11)
        x = torch.as_tensor(rng.standard_normal((16, 43844)) * 0.1, dtype=torch.float32, device="cuda")
        got_eval = onnx_eval.run_model(graph, x, device="cuda")
        with torch.inference_mode(), nmp.precision_scope("highest"):
            want_nmp = onnx_model.module(x)
        d_eval = max(float((got_eval[k] - want_nmp[k]).abs().max()) for k in heads)
        if d_eval > 1e-4:
            raise AssertionError(f"the torch evaluator and the NMP differ by {d_eval} > 1e-4")

        def nmp_forward() -> None:
            with torch.inference_mode(), nmp.precision_scope("highest"):
                onnx_model.module(x)

        eval_ms = cuda_median_ms(lambda: onnx_eval.run_model(graph, x, device="cuda"), reps=5)
        nmp_ms = cuda_median_ms(nmp_forward, reps=5)
        print(
            f"torch evaluator vs NMP on 16 windows: max abs diff {d_eval:.3g}; per 16-window batch "
            f"(CUDA events, median of 5) evaluator {eval_ms:.3f} ms, NMP {nmp_ms:.3f} ms [{smi}]"
        )

        # ---- without tensorflow the TF formats are refused ----
        # `import tensorflow` fails inside, wherever tensorflow is installed;
        # sys.modules and the package's attributes are restored after
        err_out = io.StringIO()
        with mock.patch.dict(sys.modules, {"tensorflow": None}), \
                mock.patch.dict(vars(models_pkg)), contextlib.redirect_stderr(err_out):
            sys.modules.pop("basic_pitch_torch.models.tf_export", None)
            vars(models_pkg).pop("tf_export", None)
            rc = export_cli.main([str(tmp / "tf"), "--format", "savedmodel", "--device", "cuda"])
        message = "savedmodel/tflite export needs tensorflow; skipping ['savedmodel'] (onnx export is runtime-free)"
        if rc != 2 or message not in err_out.getvalue():
            raise AssertionError(f"--format savedmodel without tensorflow: rc {rc}, stderr {err_out.getvalue()!r}")
        print(f"--format savedmodel without tensorflow: rc 2, {message!r}")
    print(
        "formats run on the card: onnx (the port's writer and basic-pitch-torch-export, read by inference.Model, "
        "transcribed through the kernel, run by the torch evaluator) and npz; SavedModel and TFLite wait for such "
        "a file in the repository"
    )
    print(f"formats phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_cli_phase(smi: str) -> None:
    """The serve CLI in a subprocess, started with --pcm-transport auto
    --head-precision high, answering two requests (a sparse and an 8-voice
    30 s PCM16 WAV; recall >= 0.8 on the sparse one) and reporting the mode
    it was asked for on /healthz."""
    import urllib.request

    from basic_pitch_torch.utils import audio as audio_io

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "basic_pitch_torch.cli.serve", "--port", str(port),
           "--pcm-transport", "auto", "--head-precision", "high", "--warmup", "5"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        info = None
        while info is None:
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                raise AssertionError(f"serve CLI did not come up:\n{proc.communicate(timeout=10)[0][-3000:]}")
            try:
                info = json.loads(urllib.request.urlopen(base + "/healthz", timeout=5).read())
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        if info["pcm_transport"] != "auto" or info["decode_backend"] != "kernel":
            raise AssertionError(f"serve CLI /healthz says {info}")
        counts = []
        for seed, voices in ((800, 1), (801, 8)):
            y, notes = tone_mix(SR, 30.0, seed=seed, voices=voices)
            buf = io.BytesIO()
            audio_io.write_wav(buf, y, SR)
            t1 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(base + "/v1/transcribe", data=buf.getvalue()), timeout=120) as resp:
                body = json.loads(resp.read())
            wall = time.perf_counter() - t1
            events = [(n["start_time_s"], n["end_time_s"], n["pitch_midi"]) for n in body["notes"]]
            counts.append((len(events), recall(events, notes), wall))
        if counts[0][1] < 0.8 or counts[1][0] == 0:
            raise AssertionError(f"serve CLI answers: {counts}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    print(
        f"serve CLI --pcm-transport auto --head-precision high [{smi}]: up in {up_s:.1f} s (subprocess, 5 s warm-up), "
        f"/healthz {info}; sparse 30 s: {counts[0][0]} events, recall {counts[0][1]:.3f}, {counts[0][2] * 1e3:.1f} ms; "
        f"8-voice 30 s: {counts[1][0]} events, {counts[1][2] * 1e3:.1f} ms"
    )


def width_ladder(order: int, widths: List[int], blocks: int = 80) -> np.ndarray:
    """int16 blocks that alternate +a, -a, whose order-`order` residuals are
    +-2**order * a: for each width k in `widths`, `blocks` blocks whose
    residuals need exactly k bits (enough blocks that no group merges)."""
    parts = []
    for k in widths:
        a = 0 if k == 2 else -(-(1 << (k - 2)) // (1 << order))
        if (a << order) > (1 << (k - 1)) - 1 or a > 32767:
            raise ValueError(f"width {k} is out of reach at order {order}")
        parts.append(np.tile(np.array([a, -a], np.int16), 256 * blocks // 2))
    return np.concatenate(parts)


def codec_cases(piece: np.ndarray) -> List[Tuple[str, np.ndarray, Any]]:
    """The pcm_decode cases as (name, pcm, packed): every fixed order, LPC
    and the default mode on the JAX package's codec test signals, width
    ladders that reach every k of KSET, int16 extremes, the adversarial LPC
    fuzz, lengths from 256 samples to one 44.1 kHz piece of a 128-window
    chunk, and the kernel's tiling cases (tests/torch_codec_cases.py: one
    block, groups of one to three rows so that group edges fall inside a
    CTA, block counts off a multiple of 32, group starts off 16 bytes)."""
    from basic_pitch_torch.ops import pcmcodec
    from torch_codec_cases import tiling_cases

    rng = np.random.RandomState(7)
    sine = (np.sin(np.arange(60000) * 0.07) * 18000).astype(np.int16)
    signals = {
        "random": (rng.randn(50000) * 4000).clip(-32768, 32767).astype(np.int16),
        "extremes": np.tile(np.array([-32768, 32767, 0, -1], np.int16), 300),
        "silence": np.zeros(4096, np.int16),
        "sine": sine,
        "mixed": np.concatenate([np.zeros(1000, np.int16), sine[:3000], (rng.randn(2000) * 30000).clip(-32768, 32767).astype(np.int16)]),
        "tiny": np.array([5], np.int16),
        "two_sines": (np.sin(np.arange(60000) * 0.031) * 12000 + np.sin(np.arange(60000) * 0.173) * 9000).astype(np.int16),
    }
    cases = []
    for name, pcm in signals.items():
        for kw in ({"order": 1}, {"order": 2}, {"order": 3}, {"mode": "lpc"}, {}):
            cases.append((f"{name} {kw}", pcm, kw))
    cases.append(("ladder k=2..17", width_ladder(1, list(range(2, 18))), {"order": 1}))
    cases.append(("ladder k=5..19", width_ladder(3, list(range(5, 20))), {"order": 3}))
    cases.append(("full-scale alternation", np.tile(np.array([-32768, 32767], np.int16), 20000), {}))
    fuzz = np.random.RandomState(99)
    for trial in range(12):
        n = int(fuzz.randint(300, 20000))
        kind = trial % 4
        if kind == 0:
            x = np.clip(np.sin(np.arange(n) * fuzz.uniform(0.005, 0.4)) * 50000, -32768, 32767)
        elif kind == 1:
            x = np.where(fuzz.randn(n) > 0, 32767, -32768)
        elif kind == 2:
            x = np.sin(np.arange(n) * 0.07) * 15000
            x[fuzz.randint(0, n, 5)] = 32767
        else:
            x = np.sin(np.cumsum(np.linspace(0.001, 1.2, n))) * fuzz.uniform(1000, 32000)
        for mode in (None, "lpc", "fixed"):
            cases.append((f"lpc fuzz {trial} mode={mode}", x.astype(np.int16), {"mode": mode}))
    for n in (256, 257, 1000, 44100):
        cases.append((f"length {n}", piece[:n], {}))
    cases.append((f"22.05 kHz piece ({len(piece)})", piece, {}))
    cases.append((f"22.05 kHz piece ({len(piece)}), lpc", piece, {"mode": "lpc"}))
    piece44 = np.concatenate([np.repeat(piece, 2), piece[:256]])
    cases.append((f"44.1 kHz piece ({len(piece44)})", piece44, {}))
    return [(name, pcm, pcmcodec.pack(pcm, **kw)) for name, pcm, kw in cases] + tiling_cases()


def pcm_decode_bytes(packed: Any, n_out: int) -> int:
    """The bytes pcm_decode must move for one piece: the group table, the
    words of each group's real rows (not the bucket over-read, the quantized
    tail or the zeroed slack of the wire), the real idx entries, the heads
    (and LPC coefficients and shifts) of every block, and the float32
    samples out."""
    from basic_pitch_torch.ops import pcmcodec

    rows = sum(g[2] for g in packed.groups)
    words = sum(g[2] * pcmcodec.words_per_block(g[0], packed.order) for g in packed.groups)
    side = packed.heads.nbytes + (packed.coeffs.nbytes + packed.shifts.nbytes if packed.coeffs is not None else 0)
    return 16 * len(packed.groups) + 4 * words + 4 * rows + side + 4 * n_out


def pcm_decode_device_ms(wire: Any, layout: Any, n_out: int, exact: Any, lib: Any = None, copies: int = 4,
                         launches: int = 16, replays: int = 10) -> float:
    """pcm_decode's own device time, ms a launch: ``launches`` launches of
    the kernel (``lib``, by default `pcmcodec.kernel()`) captured in one
    CUDA graph (no Python, validation or allocation between them) and
    replayed ``replays`` times under CUDA events. They cycle over ``copies``
    copies of the wire and the output, which together exceed the card's 50
    MB L2 at a full piece, so a launch finds its wire in device memory as a
    freshly uploaded piece would. Every output must equal ``exact`` after
    the replays (None: not checked)."""
    import torch

    from basic_pitch_torch.ops import pcmcodec

    lib = lib or pcmcodec.kernel()
    wires = [wire.clone() for _ in range(copies)]
    outs = [torch.full((n_out,), float("nan"), device=wire.device) for _ in range(copies)]

    def launch(i: int, stream: int) -> None:
        err = lib.pcm_decode_launch(
            wires[i].data_ptr(), layout.groups_off, layout.n_groups, layout.words_off, layout.idx_off,
            layout.heads_off, layout.coeffs_off, layout.shifts_off, layout.nb, layout.order,
            1 if layout.lpc else 0, n_out, outs[i].data_ptr(), stream,
        )
        if err:
            raise RuntimeError(f"pcm_decode launch failed: cudaError_t {err}")

    # a first launch outside the graph loads the kernel's module (lazily
    # loaded modules cannot load while a stream is capturing)
    for i in range(copies):
        launch(i, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    for out in outs:
        out.fill_(float("nan"))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for j in range(launches):
            launch(j % copies, stream)
    graph.replay()
    ms = cuda_ms(graph.replay, replays) / launches
    if exact is not None and not all(torch.equal(out, exact) for out in outs):
        raise AssertionError("pcm_decode in a CUDA graph: an output is not pcm / 32768")
    return ms


def lpc_chain_bound(steps: int = 1 << 20) -> Tuple[float, float, float]:
    """The LPC decode's chain bound: the kernel's 248 dependent steps (a
    multiply-add, the shift and the add) times one step's latency, measured
    by `pcm_lpc_chain_probe` (one thread, ``steps`` steps, clock64) at the
    SM clock measured over the same launch. Returns (ms, cycles a step, SM
    clock in Hz)."""
    import ctypes

    import torch

    from basic_pitch_torch.ops import pcmcodec

    fn = pcmcodec.kernel().pcm_lpc_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device="cuda")

    def probe() -> None:
        if fn(steps, 1, 1, out.data_ptr(), torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("pcm_lpc_chain_probe did not launch")

    probe()
    ms = cuda_ms(probe, reps=3)
    cycles = int(out[0])
    clock_hz = cycles / (ms * 1e-3)
    per_step = cycles / steps
    return 248 * per_step / clock_hz * 1e3, per_step, clock_hz


def codec_kernel_phase(piece: np.ndarray, path_piece: np.ndarray) -> dict:
    """pcm_decode against its plain version on the card, bit for bit, and
    both against pcm / 32768; then, at ``path_piece``, a piece as the
    codec path cuts and decodes it (it packs smaller than raw), in its
    default mode and forced to LPC, and at ``piece``, a full chunk of noisy
    audio that the path sends raw: the kernel's own device time (a CUDA
    graph, `pcm_decode_device_ms`), the wrapper's time, the plain version's,
    the pinned copies of the wire and of the raw int16 bytes, the bytes
    bound and, for LPC, the chain bound (`lpc_chain_bound`)."""
    import torch

    from basic_pitch_torch.ops import pcmcodec

    dev = torch.device("cuda")
    before = pcmcodec.launches
    widths = set()
    max_err = 0.0
    cases = codec_cases(piece)
    for name, pcm, packed in cases:
        widths |= {g[0] for g in packed.groups}
        wire, layout = pcmcodec.to_wire(packed)
        w_dev = torch.from_numpy(wire).to(dev)
        out = pcmcodec.decode_wire(w_dev, layout, len(pcm))
        ref = pcmcodec.decode_plain(w_dev, layout, len(pcm))
        exact = torch.from_numpy(pcm.astype(np.float32) / np.float32(32768.0)).to(dev)
        torch.cuda.synchronize()
        max_err = max(max_err, float((out - ref).abs().max()) if len(pcm) else 0.0)
        if not (torch.equal(out, ref) and torch.equal(out, exact)):
            bad = int(torch.nonzero(out != exact)[0]) if not torch.equal(out, exact) else -1
            raise AssertionError(f"pcm_decode [{name}]: kernel != plain or != pcm/32768 (first bad sample {bad})")
        if len(pcm) >= 44100 or "ladder" in name or "unaligned" in name:
            print(f"pcm_decode == plain == pcm/32768 [{name}]: {packed.mode} order {packed.order}, {packed.nb} blocks, "
                  f"groups (k, rows) {[(g[0], g[2]) for g in packed.groups]}, {packed.packed_bytes} of {pcm.nbytes} bytes")
    if pcmcodec.launches != before + len(cases):
        raise AssertionError("decode_wire did not launch the kernel once per call")
    if widths != set(pcmcodec.KSET):
        raise AssertionError(f"the cases reached widths {sorted(widths)}, not every k of KSET")
    print(f"pcm_decode: {len(cases)} cases bit-exact (fixed orders 1-3, lpc, default mode, every k of KSET, int16 "
          f"extremes, lengths 1 .. {len(piece) * 2 + 256}, one block, groups of 1-3 rows, block counts off 32, "
          f"group starts off 16 bytes)")

    chain_ms, step_cycles, clock_hz = lpc_chain_bound()
    print(f"pcm_decode LPC chain: {step_cycles:.2f} cycles a step at a measured SM clock of {clock_hz / 1e6:.0f} MHz; "
          f"248 steps = {chain_ms:.5f} ms")
    rows = {}
    for name, pcm, mode in (("path", path_piece, None), ("path_lpc", path_piece, "lpc"), ("noisy_raw", piece, None)):
        packed = pcmcodec.pack(pcm, mode=mode)
        if name != "noisy_raw" and not packed.packed_bytes < pcm.nbytes:
            raise AssertionError(f"pcm_decode [{name}]: {packed.packed_bytes} packed bytes, not fewer than raw {pcm.nbytes}")
        wire, layout = pcmcodec.to_wire(packed)
        w_dev = torch.from_numpy(wire).to(dev)
        n = len(pcm)
        exact = torch.from_numpy(pcm.astype(np.float32) / np.float32(32768.0)).to(dev)
        device_ms = pcm_decode_device_ms(w_dev, layout, n, exact)
        wrapper_ms = cuda_ms(lambda: pcmcodec.decode_wire(w_dev, layout, n), reps=20)
        plain_ms = cuda_ms(lambda: pcmcodec.decode_plain(w_dev, layout, n), reps=2)
        host_wire = torch.from_numpy(wire).pin_memory()
        wire_copy_ms = cuda_ms(lambda: host_wire.to(dev, non_blocking=True), reps=20)
        raw_host = torch.from_numpy(pcm).pin_memory()
        raw_copy_ms = cuda_ms(lambda: raw_host.to(dev, non_blocking=True), reps=20)
        # least time: the bytes the kernel must touch at the card's memory
        # rate, against its integer work (~10 operations a sample fixed, ~25
        # lpc) at the non-tensor rate, which is far below it; LPC also has
        # its chain of 248 dependent steps a block
        bytes_moved = pcm_decode_bytes(packed, n)
        ops = (25 if packed.mode == "lpc" else 10) * n
        bound_ms, bound_by = max((bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / FP32_OPS_PER_S * 1e3, "operations"))
        lpc = packed.mode == "lpc"
        rows[name] = dict(
            mode=packed.mode, order=packed.order, ms=device_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, chain_bound_ms=chain_ms if lpc else None,
            bound_share=bound_ms / device_ms, bytes_moved=bytes_moved, packed_bytes=packed.packed_bytes,
            wire_bytes=layout.nbytes, wire_copy_ms=wire_copy_ms, raw_copy_ms=raw_copy_ms,
        )
        chain = f", chain bound {chain_ms:.5f} ms ({chain_ms / device_ms:.1%} of it)" if lpc else ""
        print(
            f"pcm_decode [{name}: {n} samples, {packed.mode} order {packed.order}, {packed.packed_bytes} packed bytes "
            f"against {pcm.nbytes} raw, {pcm.nbytes / packed.packed_bytes:.3f}x]: kernel {device_ms:.5f} ms on the "
            f"device (CUDA graph), wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms; bound {bound_ms:.5f} ms by "
            f"{bound_by} ({bytes_moved} bytes touched of a {layout.nbytes}-byte wire, 3.35 TB/s), "
            f"{bound_ms / device_ms:.1%} of it{chain}; pinned copy of the wire {wire_copy_ms:.4f} ms, of the raw int16 "
            f"piece {raw_copy_ms:.4f} ms"
        )
    path, path_lpc = rows["path"], rows["path_lpc"]
    print(f"pcm_decode targets: path at {path['bound_share']:.1%} of its bytes bound (target >= 50%: "
          f"{'met' if path['bound_share'] >= 0.5 else 'missed'}); path_lpc {path_lpc['ms']:.5f} ms (target <= 0.030 ms: "
          f"{'met' if path_lpc['ms'] <= 0.030 else 'missed'})")
    return dict(path, lpc=path_lpc, noisy_raw=rows["noisy_raw"], max_abs_err=max_err)


def event_churn(events: List[tuple], ref: List[tuple]) -> int:
    """Events of either list with no exact (start, end, pitch) twin in the
    other."""
    a = {(e[0], e[1], e[2]) for e in events}
    b = {(e[0], e[1], e[2]) for e in ref}
    return len(a ^ b)


def forward_ms(tr: Any, audio: np.ndarray, sr: int, reps: int) -> float:
    """Median host-clock time of the transcriber's upload + model stage
    (`_forward`, synchronised), after one untimed call."""
    import torch

    tr._forward(audio, sr)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._forward(audio, sr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def settings_phase(smi: str, poly_audio: np.ndarray, pcm60: np.ndarray, pcm10: np.ndarray) -> dict:
    """The transcriber's settings at full width, W = 128 (see the module
    docstring, phase 3). Returns the launches of the codec-fed path."""
    import torch

    from basic_pitch_torch import pipeline
    from basic_pitch_torch.decode import greedy_kernel
    from basic_pitch_torch.ops import pcmcodec, transport

    t_phase = time.perf_counter()
    # ---- head_precision x conv_impl on the 8-voice 60 s mix ----
    ref_post = ref_events = None
    for head in ("highest", "high", "default"):
        for impl in ("conv", "im2col", "toeplitz:24", "mxu:24"):
            tr = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128, head_precision=head, conv_impl=impl)
            ms = forward_ms(tr, poly_audio, SR, reps=5)
            post = tr.posteriorgrams(poly_audio, SR)
            events = tr.transcribe(poly_audio, SR)
            if not all(np.isfinite(v).all() for v in post.values()) or post["note"].shape != (tr._geometry(poly_audio, SR)[3], 88):
                raise AssertionError(f"[{head}, {impl}] posteriorgrams {[(k, v.shape) for k, v in post.items()]}")
            if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
                raise AssertionError(f"[{head}, {impl}] left TF32 on")
            if ref_post is None:
                ref_post, ref_events = post, events
            diff = max(float(np.abs(post[k] - ref_post[k]).max()) for k in post)
            churn = event_churn(events, ref_events)
            print(
                f"model stage [head_precision {head}, conv_impl {impl}, {smi}]: upload + model {ms:.3f} ms per 60 s "
                f"(median of 5); posteriorgram max diff vs highest/conv {diff:.3g}; {len(events)} events, churn "
                f"{churn} of {len(ref_events)}"
            )
            if head == "highest":  # the lowerings compute the same convs in float32
                if diff > 1e-4:
                    raise AssertionError(f"conv_impl {impl} differs from conv by {diff} > 1e-4")
                events_agree(events, ref_events)
            del tr

    # ---- compute_group 1 against 2 on the 10 min recording (3 chunks) ----
    grouped = {}
    for k in (1, 2):
        tr = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128, compute_group=k, pcm_transport="raw")
        n_chunks = tr._geometry(pcm10, SR)[2]
        ms = forward_ms(tr, pcm10, SR, reps=3)
        grouped[k] = (ms, tr.posteriorgrams(pcm10, SR), tr.transcribe(pcm10, SR))
        del tr
    diff = max(float(np.abs(grouped[2][1][key] - grouped[1][1][key]).max()) for key in grouped[1][1])
    matched = events_agree(grouped[2][2], grouped[1][2])
    print(
        f"compute_group [{smi}, 10 min int16, {n_chunks} chunks of 128 windows]: k=1 {grouped[1][0] / n_chunks:.3f} ms "
        f"per chunk, k=2 {grouped[2][0] / n_chunks:.3f} ms per chunk (upload + model, median of 3); posteriorgram max "
        f"diff {diff:.3g}; events {len(grouped[2][2])} vs {len(grouped[1][2])}, {matched} matched"
    )
    if n_chunks < 3 or diff > 5e-3:
        raise AssertionError(f"compute_group: {n_chunks} chunks, posteriorgrams differ by {diff}")

    # ---- forced codec with a kernel that cannot be built: it raises ----
    import tempfile

    from basic_pitch_torch import _build

    def no_nvcc() -> str:
        raise RuntimeError("nvcc not found (simulated)")

    saved = (_build.BUILD_DIR, _build.nvcc_path, _build._loaded.pop("pcm_decode", None))
    try:
        with tempfile.TemporaryDirectory() as empty:
            _build.BUILD_DIR, _build.nvcc_path = pathlib.Path(empty), no_nvcc
            try:
                pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128, pcm_transport="codec")
            except RuntimeError as exc:
                print(f"forced codec without a buildable pcm_decode raises: {exc}")
            else:
                raise AssertionError("forced codec made a transcriber without its kernel")
    finally:
        _build.BUILD_DIR, _build.nvcc_path = saved[:2]
        if saved[2] is not None:
            _build._loaded["pcm_decode"] = saved[2]

    # ---- transport: raw, codec and auto on int16 60 s and 10 min ----
    launches = {"pcm_decode": 0, "greedy_decode": 0}
    for name, pcm in (("60 s", pcm60), ("10 min", pcm10)):
        by_mode = {}
        for mode in ("raw", "codec", "auto"):
            tr = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128, pcm_transport=mode)
            tr.transcribe(pcm, SR)  # the first call runs the probe under "auto"
            tr.piece_upload_bytes.clear()
            # counts from 0 just before each mode's runs; the codec-fed
            # transcription is this slice's path
            pcmcodec.launches = greedy_kernel.launches = 0
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                events = tr.transcribe(pcm, SR)
                walls.append(time.perf_counter() - t0)
            n_launches = pcmcodec.launches
            if mode == "codec":
                # a piece whose packed form is not smaller goes raw, as in
                # the JAX package; every transcription here decodes some
                launches["pcm_decode"] += pcmcodec.launches
                launches["greedy_decode"] += greedy_kernel.launches
                if pcmcodec.launches < 3 or greedy_kernel.launches != 3:
                    raise AssertionError(f"codec path: {pcmcodec.launches} pcm_decode, {greedy_kernel.launches} greedy_decode launches")
            by_mode[mode] = (events, tr.piece_upload_bytes["default"] // 3, float(np.median(walls)) * 1e3, n_launches)
            tr.close()
        n_chunks = tr._geometry(pcm, SR)[2]
        for mode, (events, nbytes, wall, n_launches) in by_mode.items():
            if events != by_mode["raw"][0]:
                raise AssertionError(f"{name}: {mode} transport events differ from raw")
            print(
                f"transport [{name} int16, {mode}, {smi}]: {nbytes} bytes uploaded per transcription "
                f"({by_mode['raw'][1] / nbytes:.3f}x fewer than raw), wall {wall:.1f} ms (median of 3), "
                f"{len(events)} events, identical to raw; pieces through pcm_decode {n_launches / 3:g} of {n_chunks}"
            )
    print(f"transport.report(): {json.dumps(transport.report('cuda'))}")
    print(f"settings phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


PRE_BN_BIASES = ("contour_conv/b", "onset_conv/b")  # zero gradient in exact arithmetic


def grad_errors(got: dict, ref: dict) -> dict:
    """Per gradient tensor: the largest difference relative to the
    reference tensor's largest gradient (absolute for the biases in front
    of a batch norm)."""
    out = {}
    for key, g in ref.items():
        err = float(np.abs(got[key] - g).max())
        out[key] = err if key in PRE_BN_BIASES else err / max(float(np.abs(g).max()), 1e-30)
    return out


def grad_violations(loss_rel: float, errors: dict) -> List[str]:
    """The bounds of the card-vs-CPU step: loss 1e-6 relative; gradients
    1e-3 of the tensor's largest (float32's own error is up to ~3e-4 of it,
    see the CPU float64 line), 1e-6 absolute for the biases in front of a
    batch norm."""
    bad = [f"loss {loss_rel:.3g} > 1e-6"] if not loss_rel <= 1e-6 else []
    for key, err in errors.items():
        bound = 1e-6 if key in PRE_BN_BIASES else 1e-3
        if not err <= bound:
            bad.append(f"{key} {err:.3g} > {bound:g}")
    return bad


def training_phase(smi: str) -> dict:
    """Training at full width on the card (see the module docstring, phase
    7). Returns the greedy-decode kernel's launches on the trained
    checkpoint's transcriptions."""
    import tempfile

    import torch

    from basic_pitch_torch import pipeline
    from basic_pitch_torch.cli import train as train_cli
    from basic_pitch_torch.data import loader
    from basic_pitch_torch.decode import device as device_decode
    from basic_pitch_torch.decode import greedy_kernel
    from basic_pitch_torch.models import nmp
    from basic_pitch_torch.models import params as params_io
    from basic_pitch_torch.train import loop as train_loop
    from torch_train_data import write_corpus

    print(f"training phase on {smi}")
    t_phase = time.perf_counter()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = pathlib.Path(tmp_name)
        t0 = time.perf_counter()
        source = write_corpus(tmp / "source", "GuitarSet", n_train=8, n_validation=2, seconds=10.0, seed=0)
        print(f"corpus: 8 train + 2 validation tracks of 10 s, 22.05 kHz PCM16, written in {time.perf_counter() - t0:.2f} s")
        train_iter, _ = loader.prepare_datasets(str(source), 100, 16, 1, ["GuitarSet"], [1.0], seed=0, device_targets=True)
        host_batch = next(train_iter)
        if host_batch["audio"].shape != (16, SR * 2 - 256) or "targets_sparse" not in host_batch:
            raise AssertionError(f"loader batch: {host_batch['audio'].shape}, keys {sorted(host_batch)}")

        # ---- one step from the shipped weights, card against CPU ----
        # the golden random-window audio and seeded noise windows: no
        # near-silent CQT bins (whose float32 rounding the dB normalisation
        # amplifies); the targets are the loader's
        rng = np.random.RandomState(11)
        golden = np.load(REPO / "tests" / "goldens" / "random_windows.npz")["audio"]
        parity_batch = dict(host_batch, audio=np.concatenate([golden, (0.1 * rng.randn(14, golden.shape[1])).astype(np.float32)]))
        flat = params_io.load_flat()
        config = train_loop.TrainConfig()

        def one_step(device: "torch.device", precision: str = "highest", dtype: "torch.dtype" = torch.float32) -> Tuple[float, dict]:
            model = params_io.model_from_flat(flat).to(device, dtype)
            batch = train_loop.materialize_batch(train_loop.upload_batch(parity_batch, device)[0])
            batch = {"audio": batch["audio"].to(dtype), "targets": {k: v.to(dtype) for k, v in batch["targets"].items()},
                     "weights": {k: v.to(dtype) for k, v in batch["weights"].items()}}
            if dtype == torch.float32:
                optimizer = train_loop.make_optimizer(model, config)
                loss = float(train_loop.train_step(model, optimizer, batch, dataclasses.replace(config, precision=precision))["loss"])
            else:  # the float64 reference: loss and gradients only
                total, _, _ = train_loop.loss_and_stats(model, batch, config)
                total.backward()
                loss = float(total.detach())
            state = dict(model.state_dict())
            state.update({name: p.grad for name, p in model.named_parameters()})
            grads = {k: v.astype(np.float64) for k, v in params_io.to_jax_params(state).items() if not k.endswith(("/mean", "/var"))}
            return loss, grads

        # as a transcriber in the same process leaves them: the steps must too
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        loss_gpu, grads_gpu = one_step(cuda)
        loss_tf32, grads_tf32 = one_step(cuda, precision="high")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss_cpu, grads_cpu = one_step(cpu)
        t_cpu = time.perf_counter() - t0
        loss_64, grads_64 = one_step(cpu, dtype=torch.float64)
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            raise AssertionError("a training step left TF32 on")
        rel = {name: abs(loss - loss_cpu) / abs(loss_cpu) for name, loss in (("card", loss_gpu), ("tf32", loss_tf32))}
        errors = grad_errors(grads_gpu, grads_cpu)
        errors_tf32 = grad_errors(grads_tf32, grads_cpu)
        errors_64 = grad_errors(grads_cpu, grads_64)
        print(
            f"train step, shipped weights, batch 16 (card {t_card:.2f} s for two steps, cpu {t_cpu:.2f} s): loss card "
            f"{loss_gpu:.8f} cpu {loss_cpu:.8f} (rel diff {rel['card']:.3g}; TF32 control {rel['tf32']:.3g}; cpu float32 "
            f"vs float64 {abs(loss_cpu - loss_64) / abs(loss_64):.3g})"
        )
        for name, errs in (("card vs cpu", errors), ("TF32 card vs cpu", errors_tf32), ("cpu float32 vs float64", errors_64)):
            print(f"gradient diff / tensor max [{name}]: " + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
        bad = grad_violations(rel["card"], errors)
        if bad:
            raise AssertionError(f"card and CPU train steps differ: {bad}")
        bad_tf32 = grad_violations(rel["tf32"], errors_tf32)
        if not bad_tf32:
            raise AssertionError("the TF32 control step stayed inside the bounds: the check cannot tell")
        print(f"TF32 control breaks the bounds as it must: {bad_tf32[:3]}")

        # ---- a train step fed a codec-packed batch ----
        from basic_pitch_torch.ops import pcmcodec

        # the loader's targets with quiet random-walk PCM16 audio (the JAX
        # package's codec train test, smaller steps): the corpus' loud noise
        # floor does not pack smaller than raw once the wire pads each
        # width's rows to a power of two, and audio that does not stays raw
        walk = np.cumsum(np.random.RandomState(12).randint(-30, 30, host_batch["audio"].shape), axis=1)
        quiet_batch = dict(host_batch, audio=np.clip(walk, -32768, 32767).astype(np.int16))
        wire_batch = train_loop.pack_batch_audio(quiet_batch, "codec", cuda)
        if "audio_packed" not in wire_batch:
            raise AssertionError("the random-walk int16 batch did not pack smaller than raw")
        pcmcodec.launches = 0
        dev_codec, bytes_codec = train_loop.upload_batch(wire_batch, cuda)
        codec_launches = pcmcodec.launches
        dev_raw, bytes_raw = train_loop.upload_batch(quiet_batch, cuda)
        mat_codec, mat_raw = train_loop.materialize_batch(dev_codec), train_loop.materialize_batch(dev_raw)
        if codec_launches != 1 or not torch.equal(mat_codec["audio"], mat_raw["audio"]):
            raise AssertionError(f"codec batch: {codec_launches} pcm_decode launches, audio equal {torch.equal(mat_codec['audio'], mat_raw['audio'])}")
        for head in mat_raw["targets"]:
            if not torch.equal(mat_codec["targets"][head], mat_raw["targets"][head]):
                raise AssertionError(f"codec batch: {head} targets differ")
        step_losses = []
        for dev_batch_ in (dev_codec, dev_raw):
            model = params_io.model_from_flat(flat).to(cuda)
            step_losses.append(float(train_loop.train_step(model, train_loop.make_optimizer(model, config), dev_batch_, config)["loss"]))
        if abs(step_losses[0] - step_losses[1]) > 1e-6 * abs(step_losses[1]):
            raise AssertionError(f"train step on the codec batch {step_losses[0]} vs raw {step_losses[1]}")
        print(
            f"train step on a codec-packed batch (random-walk int16, the loader's targets, {wire_batch['audio_packed'][0].mode}): "
            f"{bytes_codec} bytes uploaded against {bytes_raw} raw; audio and targets bit-equal on the card, "
            f"loss {step_losses[0]:.8f} vs raw {step_losses[1]:.8f}; {codec_launches} pcm_decode launch"
        )

        # ---- step times at batch 16 for each precision ----
        dev_batch = train_loop.upload_batch(host_batch, cuda)[0]
        for precision in train_loop.TRAIN_PRECISIONS:
            cfg = dataclasses.replace(config, precision=precision)
            model = nmp.init_params(nmp.NMP(), torch.Generator().manual_seed(0)).to(cuda)
            optimizer = train_loop.make_optimizer(model, cfg)
            first = [float(train_loop.train_step(model, optimizer, dev_batch, cfg)["loss"]) for _ in range(5)]
            if not (np.isfinite(first).all() and first[-1] < first[0]):
                raise AssertionError(f"{precision}: losses over 5 steps {first}")
            mat = train_loop.materialize_batch(dev_batch)

            def forward_only() -> None:
                with train_loop.precision_scope(precision):
                    train_loop.loss_and_stats(model, mat, cfg)

            def forward_backward() -> None:
                with train_loop.precision_scope(precision):
                    model.zero_grad(set_to_none=True)
                    train_loop.loss_and_stats(model, mat, cfg)[0].backward()

            torch.cuda.reset_peak_memory_stats()
            times = {
                "step": [cuda_ms(lambda: train_loop.train_step(model, optimizer, dev_batch, cfg), 1) for _ in range(10)],
                "forward": [cuda_ms(forward_only, 1) for _ in range(10)],
                "forward+backward": [cuda_ms(forward_backward, 1) for _ in range(10)],
                "eval": [cuda_ms(lambda: train_loop.eval_step(model, dev_batch, cfg), 1) for _ in range(10)],
            }
            peak = torch.cuda.max_memory_allocated() / 2**20
            med = {k: float(np.median(v)) for k, v in times.items()}
            print(
                f"train step [{precision}, batch 16, {smi}]: step {med['step']:.3f} ms (median of 10), "
                f"forward {med['forward']:.3f} ms, forward+backward {med['forward+backward']:.3f} ms, "
                f"eval step {med['eval']:.3f} ms; {16 / med['step'] * 1e3:.1f} windows/s; peak memory {peak:.1f} MiB; "
                f"loss over the first 5 steps {[round(x, 5) for x in first]}"
            )

        # ---- the train CLI in a subprocess, then its resume in process ----
        out_dir = tmp / "out"
        cli_args = ["--source", str(source), "--output", str(out_dir), "--guitarset", "--steps-per-epoch", "5",
                    "-v", "2", "-b", "16", "--size-evaluation-callback-datasets", "0"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "basic_pitch_torch.cli.train", *cli_args, "-e", "2"],
                              cwd=REPO, capture_output=True, text=True, timeout=300)
        walls = [time.perf_counter() - t0]
        if proc.returncode != 0:
            raise AssertionError(f"train CLI -e 2 failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        logs = [proc.stderr.splitlines()]

        class Collect(logging.Handler):
            def emit(self, record: logging.LogRecord) -> None:
                resumed_logs.append(record.getMessage())

        resumed_logs: List[str] = []
        root = logging.getLogger()
        handler = Collect()
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        try:
            t0 = time.perf_counter()
            train_cli.main([*cli_args, "-e", "3"])
            walls.append(time.perf_counter() - t0)
        finally:
            root.removeHandler(handler)
        logs.append(resumed_logs)
        run_dirs = sorted(p.parent for p in out_dir.glob("*/" + train_loop.TRAIN_STATE_NAME))
        if len(run_dirs) != 1:
            raise AssertionError(f"train CLI runs: {run_dirs}")
        run_dir = run_dirs[0]
        for name in ("model.best.npz", "checkpoints/model.00.npz", "checkpoints/model.01.npz", "checkpoints/model.02.npz"):
            if not (run_dir / name).exists():
                raise AssertionError(f"train CLI wrote no {name}")
        epoch_lines = [[line.split("INFO:root:")[-1] for line in lines if "epoch " in line and "train_loss=" in line] for lines in logs]
        if len(epoch_lines[0]) != 2 or len(epoch_lines[1]) != 1 or not epoch_lines[1][0].startswith("epoch 2:"):
            raise AssertionError(f"train CLI epochs: {epoch_lines}")
        if not any("resumed" in line for line in resumed_logs):
            raise AssertionError("the second train CLI run did not resume")
        for name, wall, lines in zip(("subprocess, start-up included", "in process, resumed"), walls, epoch_lines):
            print(f"train CLI ({name}) {wall:.2f} s: " + " | ".join(lines))

        # ---- the trained checkpoint through the transcriber and the kernel ----
        tr = pipeline.StreamingTranscriber(run_dir / "model.best.npz", device="cuda", windows_per_chunk=128)
        mixes = [tone_mix(SR, 30.0, seed=700 + i, voices=1 + 7 * i)[0] for i in range(2)]
        max_err = 0.0
        for i, mix in enumerate(mixes):
            with torch.inference_mode():
                out, n_frames, n_chunks = tr._forward(mix, SR)
                note, onset, _, floor = tr.decode_inputs(out, n_frames, n_chunks)
            max_notes = max(16384, floor)
            kw = dict(max_notes=max_notes, max_melodia_iters=2 * max_notes + 2 * note.shape[0], valid_frames=n_frames)
            # the default thresholds, and thresholds at this barely trained
            # model's own 99th (onset) and 90th (frame) percentiles, where
            # its posteriorgrams give the kernel notes to walk
            q_onset = float(torch.quantile(onset[:n_frames], 0.99))
            q_frame = float(torch.quantile(note[:n_frames], 0.9))
            for name, onset_t, frame_t in (("default thresholds", 0.5, 0.3), ("percentile thresholds", q_onset, q_frame)):
                out_k = greedy_kernel.decode_greedy(note, onset, onset_t, frame_t, 11, **kw)
                t0 = time.perf_counter()
                ref_p = device_decode.decode_plain(note, onset, onset_t, frame_t, 11, **kw)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                max_err = max(max_err, compare_decoded(out_k, ref_p))
                print(
                    f"kernel == plain [trained checkpoint, 30 s mix {i}, {name} {onset_t:.4f}/{frame_t:.4f}]: "
                    f"{int(out_k.n_notes)} notes, overflow {bool(out_k.overflow)}; plain decode {plain_s:.2f} s"
                )
            print(
                f"trained checkpoint posteriorgrams [30 s mix {i}]: note mean {float(note[:n_frames].mean()):.4f}, "
                f"max {float(note[:n_frames].max()):.4f}; onset max {float(onset[:n_frames].max()):.4f}"
            )
        greedy_kernel.launches = 0
        events = [tr.transcribe(mix, SR) for mix in mixes]
        launches = greedy_kernel.launches
        if launches != len(mixes):
            raise AssertionError(f"the trained checkpoint's transcriptions launched the kernel {launches} times")
        print(f"trained checkpoint transcribed: {[len(e) for e in events]} events, {launches} kernel launches, max amp err {max_err:.3g}")
    print(f"training phase took {time.perf_counter() - t_phase:.1f} s")
    return {"trained_checkpoint": launches}, codec_launches


def measure_corpus(root: pathlib.Path, n_tracks: int, seconds: float) -> List[Tuple[str, List[tuple]]]:
    """A GuitarSet-layout corpus of seeded 44.1 kHz tone mixes (PCM16 WAV)
    with JAMS files made from each mix's known notes: a note_midi
    annotation and a pitch contour every 10 ms of each note. Returns
    [(track id, [(onset s, offset s, MIDI pitch)])]."""
    from basic_pitch_torch.utils import audio as audio_io

    (root / "audio_mono-mic").mkdir(parents=True)
    (root / "annotation").mkdir()
    tracks = []
    for i in range(n_tracks):
        tid = f"{i:02d}_ToneMix{i}"
        y, notes = tone_mix(2 * SR, seconds, seed=800 + i, voices=1 + i % 3, offsets=True)
        audio_io.write_wav(root / "audio_mono-mic" / f"{tid}_mic.wav", y, 2 * SR)
        contour = [(float(t), 440.0 * 2 ** ((m - 69) / 12)) for s, e, m in notes for t in np.arange(s, e, 0.01)]
        jam = {"annotations": [
            {"namespace": "note_midi",
             "data": [{"time": s, "duration": e - s, "value": float(m), "confidence": None} for s, e, m in notes]},
            {"namespace": "pitch_contour",
             "data": [{"time": t, "duration": 0.0, "value": {"frequency": f, "index": 0, "voiced": True}}
                      for t, f in contour]},
        ]}
        (root / "annotation" / f"{tid}.jams").write_text(json.dumps(jam))
        tracks.append((tid, notes))
    return tracks


def trace_summary(path: pathlib.Path, region: str) -> dict:
    """What a `profiling.trace` file says about the span ``region``:
    the window (the region's host span), the CUDA kernels in it, their
    device time (ms by name) and launches (by name), the device's busy share (the union of kernel intervals
    over the window) and the top 5 kernels by device time with their share
    of all kernel time. Fails when the trace holds no CUDA kernel."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == region and e.get("cat") == "cpu_op"]
    if not spans:
        raise AssertionError(f"the trace holds no {region!r} region")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    kernels = [e for e in events if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"
               and lo <= float(e["ts"]) <= hi]
    if not kernels:
        raise AssertionError("the CUDA profiler recorded no CUDA kernel in the traced transcribe")
    by_name: dict = {}
    for e in kernels:
        total, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + float(e["dur"]), count + 1)
    kernel_us = sum(t for t, _ in by_name.values())
    busy_us, end = 0.0, lo
    for start, stop in sorted((float(e["ts"]), min(hi, float(e["ts"]) + float(e["dur"]))) for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {
        "window_ms": (hi - lo) / 1e3,
        "n_kernels": len(kernels),
        "kernel_ms": kernel_us / 1e3,
        "busy_share": busy_us / (hi - lo),
        "by_name": {name: t / 1e3 for name, (t, _) in by_name.items()},
        "calls": {name: n for name, (_, n) in by_name.items()},
        "top": [(name, t / 1e3, t / kernel_us, n) for name, (t, n) in top],
    }


def data_phase(smi: str) -> Tuple[dict, List[bytes]]:
    """The data -> score -> measure path on the card (see the module
    docstring, phase 8). Returns each kernel's launches in the traced
    transcribe, and the records of the built shards."""
    import tempfile

    import torch

    from basic_pitch_torch import inference, pipeline
    from basic_pitch_torch.cli import eval as eval_cli
    from basic_pitch_torch.data import serialization, tfrecord
    from basic_pitch_torch.decode import greedy_kernel
    from basic_pitch_torch.ops import pcmcodec
    from basic_pitch_torch.ops import upload as upload_ops
    from basic_pitch_torch.utils import flops, profiling

    print(f"data phase on {smi}")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = pathlib.Path(tmp_name)

        # ---- ETL: basic-pitch-torch-download in a subprocess (this process
        # has CUDA initialised, and the build forks a pool) ----
        n_tracks, seconds = 6, 10.0
        tracks = measure_corpus(tmp / "corpus", n_tracks, seconds)
        built = tmp / "built"
        cmd = [sys.executable, "-m", "basic_pitch_torch.cli.download", "guitarset", "--source", str(tmp / "corpus"),
               "--destination", str(built), "--timestamped", "false", "--batch-size", "2", "--num-workers", "2",
               "--split-seed", "0"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"basic-pitch-torch-download failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
        dataset_dir = built / "guitarset"
        shards = {split: sorted((dataset_dir / "splits" / split).glob("*.tfrecord")) for split in ("train", "validation")}
        if not shards["train"] or not shards["validation"]:
            raise AssertionError(f"the build wrote no train or no validation shard: {shards}")
        if not (dataset_dir / "_COMPLETE-t000.json").exists():
            raise AssertionError("the build wrote no completion marker")
        records = [r for paths in shards.values() for path in paths for r in tfrecord.read_tfrecords(path, verify=True)]
        if len(records) != n_tracks:
            raise AssertionError(f"the shards hold {len(records)} examples for {n_tracks} tracks")
        for record in records:
            parsed = serialization.parse_transcription_example(record)
            if abs(len(parsed.audio) - seconds * SR) > 1 or not parsed.notes.sum() > 0 or not parsed.contours.sum() > 0:
                raise AssertionError(f"{parsed.file_id}: {len(parsed.audio)} samples, notes {parsed.notes.sum()}, "
                                     f"contours {parsed.contours.sum()}")
        n_shards = sum(len(v) for v in shards.values())
        print(
            f"ETL [{smi}]: basic-pitch-torch-download guitarset --num-workers 2 --batch-size 2 built {n_shards} shards "
            f"(train {len(shards['train'])}, validation {len(shards['validation'])}) holding {len(records)} examples "
            f"from {n_tracks} tracks of {seconds:.0f} s at 44.1 kHz in {build_s:.2f} s (a subprocess, start-up included)"
        )

        # ---- two train steps on the card from those shards ----
        out_dir = tmp / "trained"
        cmd = [sys.executable, "-m", "basic_pitch_torch.cli.train", "--source", str(built), "--output", str(out_dir),
               "--guitarset", "--device", "cuda", "-e", "1", "--steps-per-epoch", "2", "-v", "1", "-b", "4",
               "--size-evaluation-callback-datasets", "0"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
        train_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train CLI on the built shards failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
        checkpoints = sorted(out_dir.glob("*/checkpoints/model.00.npz"))
        if len(checkpoints) != 1 or not (checkpoints[0].parent.parent / "model.best.npz").exists():
            raise AssertionError(f"train CLI on the built shards wrote no checkpoint: {sorted(out_dir.rglob('*'))}")
        epoch = [line.split("INFO:root:")[-1] for line in proc.stderr.splitlines() if "epoch 0:" in line and "train_loss=" in line]
        if len(epoch) != 1:
            raise AssertionError(f"train CLI on the built shards: {proc.stderr[-2000:]}")
        print(f"train from the built shards [{smi}]: basic-pitch-torch-train --guitarset --device cuda -e 1 "
              f"--steps-per-epoch 2 -b 4: rc 0 in {train_s:.2f} s (a subprocess, start-up included): {epoch[0]}; "
              f"wrote {checkpoints[0].relative_to(out_dir)}")

        # ---- evaluation on the card, transcribe mode (windowed predict,
        # decoded on the host: no greedy_decode launch) ----
        tid, notes = tracks[0]
        wav = tmp / "corpus" / "audio_mono-mic" / f"{tid}_mic.wav"
        jams = tmp / "corpus" / "annotation" / f"{tid}.jams"
        predicted = tmp / "predicted"
        predicted.mkdir()
        greedy_kernel.launches = 0
        inference.predict_and_save([wav], predicted, True, False, False, False, device="cuda")
        midi = predicted / f"{wav.stem}_basic_pitch.mid"
        scores = {}
        for name, reference in (("self-consistency, the MIDI predict_and_save wrote", midi), ("the corpus's JAMS", jams)):
            report = tmp / "report.json"
            t0 = time.perf_counter()
            rc = eval_cli.main([str(wav), str(reference), "--device", "cuda", "--json", str(report)])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"basic-pitch-torch-eval [{name}] returned {rc}")
            onset = json.loads(report.read_text())["aggregate"]["onset"]
            scores[name] = onset
            print(f"basic-pitch-torch-eval --device cuda [{tid}, 10 s at 44.1 kHz, against {name}, {smi}]: "
                  f"P {onset['precision']:.4f} R {onset['recall']:.4f} F1 {onset['f1']:.4f} "
                  f"({onset['n_matched']}/{onset['n_reference']} ref, {onset['n_estimated']} est) in {wall:.2f} s")
        self_score, jams_score = scores.values()
        if self_score["f1"] != 1.0:
            raise AssertionError(f"self-consistency F1 {self_score['f1']} != 1.0")
        if jams_score["recall"] < 0.8 or jams_score["n_reference"] != len(notes):
            raise AssertionError(f"recall against the JAMS {jams_score['recall']} < 0.8 ({jams_score})")
        if greedy_kernel.launches != 0:
            raise AssertionError(f"windowed predict launched the kernel {greedy_kernel.launches} times")

    # ---- MFU of the model stage on one resident 128-window chunk ----
    name = torch.cuda.get_device_name(0)
    long_audio, _ = tone_mix(SR, 215.0, seed=900)
    window_flops = flops.window_forward_flops()
    for precision, conv_impl in (("highest", "conv"), ("highest", "toeplitz:24"), ("high", "conv")):
        tr = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128, precision=precision,
                                           conv_impl=conv_impl, pcm_transport="raw")
        piece = torch.from_numpy(upload_ops.padded_slice(long_audio, 0, tr.chunk_len)).to("cuda")
        windows = pipeline.unfold_windows(piece, tr.w)

        def model_only() -> None:
            tr.model(windows, tr.precision, tr.head_precision, tr.conv_impl)

        with torch.inference_mode():
            model_only()
            model_only()
            ms = cuda_median_ms(model_only, 10)
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError(f"the TF32 flags stayed on after the {precision} model stage")
        total = tr.w * window_flops
        report = flops.mfu_report(total, ms / 1e3, name)
        peak = flops.peak_tflops(name, precision)
        against = f"{100 * report['achieved_tflops'] / peak:.2f}% of the {precision} peak ({peak:g} TFLOP/s)" if peak else "no peak for this card"
        print(f"MFU [{precision}/{conv_impl}, model only on one resident 128-window chunk, {smi}]: {ms:.3f} ms "
              f"(CUDA events, median of 10) for {total / 1e9:.1f} GFLOP ({tr.w} x {window_flops} FLOP): {against}; "
              f"mfu_report {json.dumps(report)}")

    # ---- a trace of one 60 s transcribe ----
    tr = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128)
    tr.reprobe_after_calls = False
    audio, notes = tone_mix(SR, 60.0, seed=100)
    tr.transcribe(audio, SR)  # first-call set-up outside the trace
    # a transport probe older than its TTL is re-measured here, on this
    # thread (behind any re-probe another transcriber started), and no call
    # starts one, so none lands inside the trace
    tr.refresh_transport(wait=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bytes = profiling.device_memory_stats()["allocated_bytes.all.current"]
    trace_dir = REPO / "basic_pitch_torch" / "build" / "measure_trace"
    region = "bp.transcriber.batch"  # the span `transcribe` opens
    greedy_kernel.launches = 0
    pcmcodec.launches = 0
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        events = tr.transcribe(audio, SR)
    traced_s = time.perf_counter() - t0
    launches = {"greedy_decode": greedy_kernel.launches, "pcm_decode": pcmcodec.launches}
    if launches["greedy_decode"] != 1:
        raise AssertionError(f"the traced transcribe launched greedy_decode {launches['greedy_decode']} times")
    # float32 audio crosses raw; only a transport re-probe would decode
    if launches["pcm_decode"] != 0:
        raise AssertionError(f"the traced transcribe launched pcm_decode {launches['pcm_decode']} times")
    if recall(events, notes) < 0.8:
        raise AssertionError(f"the traced transcribe's recall is {recall(events, notes):.3f}")
    peak_bytes = profiling.device_memory_stats()["allocated_bytes.all.peak"]
    summary = trace_summary(trace_dir / profiling.TRACE_NAME, region)
    decode_ms = [ms for k, ms in summary["by_name"].items() if "greedy_decode" in k]
    if not decode_ms:
        raise AssertionError("the trace holds no greedy_decode kernel")
    top = "; ".join(f"{k[:90]} {ms:.3f} ms ({100 * share:.1f}%, x{n})" for k, ms, share, n in summary["top"])
    print(
        f"trace of one 60 s transcribe [{smi}]: window {summary['window_ms']:.2f} ms (host wall {traced_s * 1e3:.1f} ms "
        f"with the profiler on), {summary['n_kernels']} CUDA kernels, {summary['kernel_ms']:.3f} ms of kernel time, "
        f"device busy share {100 * summary['busy_share']:.1f}% (union of kernel intervals over the window); "
        f"greedy_decode {sum(decode_ms):.3f} ms of device time; peak allocated {peak_bytes / 2**20:.1f} MiB, "
        f"{(peak_bytes - before_bytes) / 2**20:.1f} MiB above the {before_bytes / 2**20:.1f} MiB the process held "
        f"before the call (device_memory_stats); launches {json.dumps(launches)}; "
        f"{len(events)} events; written to {(trace_dir / profiling.TRACE_NAME).relative_to(REPO)}"
    )
    print(f"top 5 CUDA kernels by device time [{smi}]: {top}")
    print(f"data phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, records


def write_pcm_wav(path: pathlib.Path, samples: np.ndarray, sr: int, bits: int, is_float: bool) -> None:
    """Mono WAV of float samples in [-1, 1): IEEE float32, or PCM at 16, 24
    or 32 bits (the samples scaled to full scale and rounded)."""
    x = np.asarray(samples, np.float64)
    if is_float:
        payload = x.astype("<f4").tobytes()
    else:
        v = np.clip(np.round(x * 2.0 ** (bits - 1)), -(2 ** (bits - 1)), 2 ** (bits - 1) - 1).astype(np.int64)
        if bits == 24:
            payload = (v & 0xFFFFFF).astype("<u4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        else:
            payload = v.astype(f"<i{bits // 8}").tobytes()
    block = bits // 8
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3 if is_float else 1, 1, sr, sr * block, block, bits))
        fh.write(b"data" + struct.pack("<I", len(payload)) + payload)


def sharded_phase(smi: str, tr: Any, poly_audio: np.ndarray, pcm44: np.ndarray) -> dict:
    """Window-parallel transcription over ["cuda:0", "cuda:0"] (the card's
    host has one GPU, so a repeated device is the list it can run) against
    the single-device transcriber `tr` (see the module docstring, phase 9).
    Returns each kernel's launches on the sharded runs."""
    import torch

    from basic_pitch_torch import pipeline
    from basic_pitch_torch.decode import greedy_kernel
    from basic_pitch_torch.ops import pcmcodec

    t_phase = time.perf_counter()
    devices = ["cuda:0", "cuda:0"]
    sharded = pipeline.StreamingTranscriber(devices=devices, windows_per_chunk=128)
    # the single device at the shards' model batch (64 windows) computes
    # every window with the same kernels: the sharded run must equal it bit
    # for bit; against `tr` (128 windows) cuDNN's batch-64 and batch-128
    # kernels round apart (the quietest-CQT-bin limit, PERF.md §2)
    single64 = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=64)
    inputs = [("8-voice 60 s mix, 22.05 kHz float32", poly_audio, SR), ("60 s at 44.1 kHz int16", pcm44, 2 * SR)]
    refs = [tr.transcribe(y, rate) for _, y, rate in inputs]
    refs64 = [single64.transcribe(y, rate) for _, y, rate in inputs]
    for _, y, rate in inputs:
        sharded.transcribe(y, rate)  # first calls at 64 windows: cuDNN and the allocator set up
    torch.cuda.synchronize()
    greedy_kernel.launches = pcmcodec.launches = 0
    events = [sharded.transcribe(y, rate) for _, y, rate in inputs]
    launches = {"greedy_decode": greedy_kernel.launches, "pcm_decode": pcmcodec.launches}
    if launches["greedy_decode"] != len(inputs):
        raise AssertionError(f"the sharded path launched greedy_decode {launches['greedy_decode']} times for {len(inputs)} recordings")
    for (name, _, _), ev, ref, ref64 in zip(inputs, events, refs, refs64):
        if ev != ref64:
            raise AssertionError(f"sharded [{name}]: events differ from the single device's at 64 windows")
        if [e[:3] for e in ev] == [e[:3] for e in ref]:
            amp = max((abs(a[3] - b[3]) for a, b in zip(ev, ref)), default=0.0)
            verdict = f"starts, ends and pitches equal, amplitudes within {amp:.3g}"
        else:
            verdict = f"one-flip rule, {events_agree(ev, ref)} of {len(ref)} matched"
        print(f"sharded [{name}]: {len(ev)} events, identical to the single device at 64 windows; against 128 windows "
              f"({len(ref)} events): {verdict}")
    post_sharded = sharded.posteriorgrams(poly_audio, SR)
    post64 = single64.posteriorgrams(poly_audio, SR)
    post_single = tr.posteriorgrams(poly_audio, SR)
    same = {k: float(np.abs(post_sharded[k] - post64[k]).max()) for k in post64}
    diffs = {k: float(np.abs(post_sharded[k] - post_single[k]).max()) for k in post_single}
    print(f"sharded posteriorgrams [8-voice mix]: max abs diff against the single device at 64 windows "
          f"{json.dumps(same)} (must be 0), at 128 windows {json.dumps(diffs)} (bound 1e-3; 2.81e-4 read on the card)")
    if max(same.values()) != 0.0 or max(diffs.values()) > 1e-3:
        raise AssertionError(f"sharded posteriorgrams differ: {same} at 64 windows, {diffs} at 128")

    # each shard uploads the pieces of its own rows, only needed windows: at
    # most the raw bytes of the recording's whole 128-window chunks / N plus
    # the halo of each chunk (twice the overlap and the decimator's halos at
    # 44.1 kHz); a row that owns none of the needed windows uploads nothing
    # (the 37 windows of 60 s all lie in row 0 of the one step)
    sharded.piece_upload_bytes.clear()
    sharded.transcribe(pcm44, 2 * SR)
    per_shard = dict(sharded.piece_upload_bytes)
    n_chunks = sharded._geometry(pcm44, 2 * SR)[2]
    total_whole = sum(pipeline.StreamingTranscriber._row(pcm44, True, c * 128, 128).nbytes for c in range(n_chunks))
    bound = total_whole / len(devices) + n_chunks * 2 * (pipeline.OVERLAP + pipeline._DEC_HALO) * pcm44.itemsize
    print(f"upload bytes per shard [60 s at 44.1 kHz int16]: {json.dumps(per_shard)}; whole chunks {total_whole} B; "
          f"bound {bound:.0f} B (1/{len(devices)} + the halo of {n_chunks} chunk(s))")
    needed = pipeline._needed_windows(len(pcm44), True)
    rows_used = -(-min(needed, 128) // (128 // len(devices)))
    keys = [f"{pipeline.resolve_device(d)}/{r}" for r, d in enumerate(devices)][:rows_used]
    if sorted(per_shard) != keys or max(per_shard.values()) > bound:
        raise AssertionError(f"per-shard uploads {per_shard} break the bound {bound:.0f} B (rows {keys})")

    # forced codec: one pcm_decode launch per uploaded piece that packs
    # smaller than raw (the JAX rule), read from the pieces the calls
    # upload. The 44.1 kHz recording's one piece (37 windows, no zero tail)
    # does not; the 60 s 22.05 kHz int16 mix of phase 3's transport sweep
    # does, so the device list's codec path launches the kernel there
    pcm22 = np.round(tone_mix(SR, 60.0, seed=102)[0] * 32767).astype(np.int16)
    codec_inputs = [(pcm44, 2 * SR), (pcm22, SR)]
    raw_events = [events[1], sharded.transcribe(pcm22, SR)]
    sharded_codec = pipeline.StreamingTranscriber(devices=devices, windows_per_chunk=128, pcm_transport="codec")
    for y, rate in codec_inputs:
        sharded_codec.transcribe(y, rate)
    host_pieces = []
    real_upload = sharded_codec._upload_piece

    def spy(piece, packed, device, key):
        host_pieces.append(piece)
        return real_upload(piece, packed, device, key)

    sharded_codec._upload_piece = spy
    torch.cuda.synchronize()
    greedy_kernel.launches = pcmcodec.launches = 0
    codec_events = [sharded_codec.transcribe(y, rate) for y, rate in codec_inputs]
    codec_launches = {"greedy_decode": greedy_kernel.launches, "pcm_decode": pcmcodec.launches}
    packed_rows = sum(pcmcodec.pack(p).packed_bytes < p.nbytes for p in host_pieces)
    print(f"sharded codec run [60 s at 44.1 kHz and 22.05 kHz int16]: launches {json.dumps(codec_launches)} for "
          f"{len(host_pieces)} uploaded piece(s) ({packed_rows} pack smaller than raw)")
    if codec_launches != {"greedy_decode": len(codec_inputs), "pcm_decode": packed_rows} or not packed_rows:
        raise AssertionError(f"the codec run launched {codec_launches}, expected {len(codec_inputs)} greedy_decode "
                             f"and {packed_rows} (> 0) pcm_decode")
    if codec_events != raw_events:
        raise AssertionError("the lossless codec changed the sharded events")

    walls = {"single": [], "sharded": []}
    for _ in range(3):
        for name, t in (("single", tr), ("sharded", sharded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.transcribe(poly_audio, SR)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(
        f"wall per recording [8-voice 60 s mix, W = 128, {smi}]: single device {med['single']:.1f} ms, "
        f"sharded over {devices} {med['sharded']:.1f} ms ({med['sharded'] / med['single']:.2f}x; median of 3, "
        f"in turns; runs {json.dumps({k: [round(x, 1) for x in v] for k, v in walls.items()})})"
    )
    print(f"sharded transcription took {time.perf_counter() - t_phase:.1f} s")
    return {
        "greedy_decode": launches["greedy_decode"] + codec_launches["greedy_decode"],
        "pcm_decode_auto": launches["pcm_decode"],
        "pcm_decode_codec": codec_launches["pcm_decode"],
    }


def dp_errors(one: dict, two: dict, step: str) -> Tuple[dict, float, float]:
    """Two self-check dumps after ``step``: (each gradient's error by the
    training phase's rule, `grad_errors`; the largest parameter difference
    over the elements whose gradient exceeds 1e-3 of its tensor's largest,
    and over every element of the parameters without a gradient, the moving
    statistics; the largest parameter difference anywhere). Adam's first
    step moves every element by about lr whatever its gradient's size, so
    an element whose gradient lies within float32 rounding of zero may step
    either way: up to 2 lr apart, which only the third number includes."""
    prefix = f"{step}/grad/"
    g_one = {k[len(prefix) :]: v for k, v in one.items() if k.startswith(prefix)}
    g_two = {k[len(prefix) :]: v for k, v in two.items() if k.startswith(prefix)}
    errors = grad_errors(g_two, g_one)
    strict = anywhere = 0.0
    for key in (k for k in one if k.startswith(f"{step}/") and not k.startswith(prefix)):
        name = key[len(step) + 1 :]
        diff = np.abs(one[key] - two[key])
        anywhere = max(anywhere, float(diff.max()))
        if name in PRE_BN_BIASES:
            continue  # zero gradient in exact arithmetic: held by its gradient alone
        if name in g_one:
            g = np.abs(g_one[name])
            diff = diff[g > 1e-3 * g.max()]
        strict = max(strict, float(diff.max()) if diff.size else 0.0)
    return errors, strict, anywhere


def distributed_phase(smi: str) -> None:
    """Data-parallel training on the card: two self-check processes with
    gloo, both on cuda:0 (NCCL refuses two ranks on one GPU), against one
    process on the same global batch of 16; then one step in a world of one
    NCCL process, so NCCL's set-up and all-reduce run on the card."""
    import tempfile

    import torch
    import torch.distributed as tdist

    from basic_pitch_torch.models import nmp
    from basic_pitch_torch.parallel import distributed, selfcheck
    from basic_pitch_torch.train import loop as train_loop

    t_phase = time.perf_counter()
    batch = 16
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = pathlib.Path(tmp_name)
        one = selfcheck.run(0, 1, 0, batch, device="cuda", dump=str(tmp / "one.npz"), time_steps=5)
        t0 = time.perf_counter()
        two = selfcheck.launch(2, batch, device="cuda", backend="gloo", timeout=240,
                               extra=["--dump", str(tmp / "two.npz"), "--time-steps", "5"])
        two_wall = time.perf_counter() - t0
        dump_one, dump_two = dict(np.load(tmp / "one.npz")), dict(np.load(tmp / "two.npz"))
    for kind in ("loss_dense", "loss_sparse"):
        if two[0][kind] != two[1][kind]:
            raise AssertionError(f"the two processes disagree on {kind}: {two[0][kind]} vs {two[1][kind]}")
        rel = abs(two[0][kind] - one[kind]) / abs(one[kind])
        print(f"two processes (gloo, cuda:0 twice) against one [{kind}, global batch {batch}]: "
              f"{two[0][kind]:.7f} vs {one[kind]:.7f}, rel diff {rel:.3g} (bound 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"{kind}: two processes differ from one by {rel} relative")
    for step in ("dense", "sparse"):
        errors, strict, anywhere = dp_errors(dump_one, dump_two, step)
        bad = grad_violations(0.0, errors)
        worst = max((k for k in errors if k not in PRE_BN_BIASES), key=errors.get)
        print(f"{step} step, two processes against one: gradients within {errors[worst]:.3g} of their tensor's "
              f"largest (worst {worst}; bound 1e-3), pre-batch-norm biases' gradients differ by "
              f"{max(errors[k] for k in PRE_BN_BIASES):.3g} (bound 1e-6); parameters after it within {strict:.3g} "
              f"where the gradient exceeds 1e-3 of its tensor's largest (bound 1e-3), {anywhere:.3g} anywhere "
              f"(Adam moves every element by about lr a step, so where a gradient is float32 noise two runs part by up to 2 lr per step)")
        # each step starts from the initial parameters in both runs
        if bad or not strict <= 1e-3:
            raise AssertionError(f"{step}: {bad}, parameters differ by {strict} where the gradient is not noise")
    print(f"train step at global batch {batch} [{smi}]: one process {one['step_ms']:.2f} ms, two processes "
          f"(gloo, cuda:0 twice, {batch // 2} each) {two[0]['step_ms']:.2f} / {two[1]['step_ms']:.2f} ms (median of 5, host "
          f"clock, synchronised); the two-process run took {two_wall:.1f} s with start-up")

    # one NCCL process: the same step with and without the process group's sums
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{selfcheck.free_port()}", world_size=1, rank=0)
    try:
        dev = torch.device("cuda", 0)
        config = train_loop.TrainConfig()
        models = [nmp.init_params(nmp.NMP(), torch.Generator().manual_seed(0)).to(dev) for _ in range(2)]
        opts = [train_loop.make_optimizer(m, config) for m in models]
        dense = train_loop.upload_batch(selfcheck.synthetic_global_batch(batch), dev)[0]
        plain = float(train_loop.train_step(models[0], opts[0], dense, config)["loss"])
        summed = float(train_loop.train_step(models[1], opts[1], dense, config, distributed.all_sum)["loss"])
        rel = abs(summed - plain) / abs(plain)
        print(f"NCCL world of one ({tdist.get_backend()}): loss {summed:.7f} through the all-reduce against {plain:.7f} "
              f"without, rel diff {rel:.3g} (bound 1e-6)")
        if tdist.get_backend() != "nccl" or not rel <= 1e-6:
            raise AssertionError(f"the NCCL step differs from the plain step by {rel} relative")
    finally:
        tdist.destroy_process_group()
    print(f"distributed training took {time.perf_counter() - t_phase:.1f} s")


def native_phase(smi: str, records: List[bytes]) -> None:
    """The native host library against the numpy paths, bit for bit, with
    each one's rate (see the module docstring, phase 9). Fails if a call
    took the numpy path."""
    import tempfile

    from basic_pitch_torch import native
    from basic_pitch_torch.data import tfrecord
    from basic_pitch_torch.utils import audio as audio_io

    if not native.available():
        raise AssertionError("the native host library did not build")
    x = tone_mix(2 * SR, 60.0, seed=104)[0]
    rates = {}

    def served(name: str, fn: Callable[[], Any]) -> Tuple[Any, float]:
        before = native.calls[name]
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        if native.calls[name] != before + 1:
            raise AssertionError(f"{name} took the numpy path")
        return out, seconds

    with tempfile.TemporaryDirectory() as tmp_name:
        for bits, is_float in ((16, False), (24, False), (32, False), (32, True)):
            path = pathlib.Path(tmp_name) / f"{bits}{'f' if is_float else ''}.wav"
            write_pcm_wav(path, x, 2 * SR, bits, is_float)
            mb = path.stat().st_size / 1e6
            (got, _), t_native = served("decode_pcm_mono", lambda: audio_io.read_wav_mono(path))
            t0 = time.perf_counter()
            plain = audio_io.to_mono(audio_io.read_wav_bytes(path.read_bytes())[0])
            t_plain = time.perf_counter() - t0
            if got.tobytes() != plain.tobytes():
                raise AssertionError(f"WAV {bits}-bit{' float' if is_float else ''}: native decode differs from numpy")
            rates[f"wav{bits}{'f' if is_float else ''}"] = (mb / t_native, mb / t_plain)
    got, t_native = served("resample_poly", lambda: audio_io.resample(x, 2 * SR, SR))
    saved = native.resample_poly
    native.resample_poly = lambda *args: None  # the scipy path
    try:
        t0 = time.perf_counter()
        plain = audio_io.resample(x, 2 * SR, SR)
        t_plain = time.perf_counter() - t0
    finally:
        native.resample_poly = saved
    if got.tobytes() != plain.tobytes():
        raise AssertionError("native decimation differs from scipy")
    rates["decimate 44.1->22.05 kHz"] = (x.nbytes / 1e6 / t_native, x.nbytes / 1e6 / t_plain)
    mb = sum(len(r) for r in records) / 1e6
    before = native.calls["crc32c"]
    t0 = time.perf_counter()
    crcs = [tfrecord.crc32c(r) for r in records]
    t_native = time.perf_counter() - t0
    if native.calls["crc32c"] != before + len(records):
        raise AssertionError("crc32c took the table loop")
    t0 = time.perf_counter()
    plain_crcs = [tfrecord.crc32c_table(r) for r in records]
    t_plain = time.perf_counter() - t0
    if crcs != plain_crcs:
        raise AssertionError("native CRC32C differs from the table loop")
    rates[f"crc32c ({len(records)} phase-8 records)"] = (mb / t_native, mb / t_plain)
    print(f"native host paths [{smi}; host CPU {host_cpu()}], MB/s native / numpy, bit-equal: "
          + "; ".join(f"{k} {a:.1f} / {b:.1f} ({a / b:.1f}x)" for k, (a, b) in rates.items()))
    print(f"native calls this process: {json.dumps(native.calls)}")


MT3_RECORDINGS = 8  # one call of 60 s recordings: 240 segments, one decode batch
MT3_REL = 2e-6  # cache attention, float32 against float64, of each case's largest output


def mt3_token_budgets(notes: List[tuple], n_segments: int, cfg: Any, cap: int = 1024) -> List[int]:
    """Each segment's count of MT3 codec tokens (the reference's encoder of
    notes into tokens) for (onset s, offset s, pitch) notes as program 0,
    ties included, capped."""
    import mt3_reference as R

    full = [(on, off, pitch, 127, 0, False) for on, off, pitch in notes]
    by_segment: dict = {}
    for note in full:
        for k in range(R.segment_of(note[0], cfg), min(R.segment_of(note[1], cfg), n_segments - 1) + 1):
            by_segment.setdefault(k, []).append(note)
    return [min(cap, len(R.notes_to_tokens(by_segment.get(k, []), k, cfg))) for k in range(n_segments)]


def mt3_phase(smi: str) -> dict:
    """MT3 at its published widths on the card (see the module docstring,
    phase 10). Returns the kernels entry of `_mt3_cache_attention`."""
    import torch
    import torch.nn.functional as F

    import mt3_reference as R
    from basic_pitch_torch.models import mt3
    from basic_pitch_torch.mt3_pipeline import Mt3Transcriber
    from basic_pitch_torch.ops import cache_attention as cache_ops
    from basic_pitch_torch.utils import profiling

    print(f"MT3 phase on {smi}")
    t_phase = time.perf_counter()
    cfg = R.Config()
    tr = Mt3Transcriber(1717, device="cuda", segments_per_call=256)
    recordings, budgets = [], []
    for i in range(MT3_RECORDINGS):
        audio, notes = tone_mix(44100, 60.0, seed=170 + i, voices=12 + i % 5, offsets=True)
        recordings.append((np.round(np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16), 44100))
        budgets.append(mt3_token_budgets(notes, tr.n_segments(len(audio), 44100), cfg))
    flat = sorted((b for bs in budgets for b in bs), reverse=True)
    t0 = time.perf_counter()
    tr.transcribe_batch(recordings, token_budgets=budgets)  # captures the step's graphs
    torch.cuda.synchronize()
    print(f"MT3 first call (graph capture included): {time.perf_counter() - t0:.2f} s; {len(flat)} segments, "
          f"token budgets median {np.median(flat):.0f}, largest {flat[0]}, {sum(flat)} tokens")
    trace_dir = REPO / "basic_pitch_torch" / "build" / "mt3_trace"
    region = "smoke.mt3.transcribe_batch"
    before = cache_ops.LAUNCHES
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        with profiling.span(region):
            got = tr.transcribe_batch(recordings, token_budgets=budgets, return_model_outputs=True)
        torch.cuda.synchronize()
        counters = profiling.summary()["counters"]
    traced_s = time.perf_counter() - t0
    wrapper_launches = cache_ops.LAUNCHES - before
    emitted = [len(t) for _, out in got for t in out["tokens"]]
    if emitted != [b for bs in budgets for b in bs]:
        raise AssertionError("MT3 emitted other token counts than its budgets")
    summary = trace_summary(trace_dir / profiling.TRACE_NAME, region)
    names = [k for k in summary["calls"] if "_mt3_cache_attention" in k]
    launches = sum(summary["calls"][k] for k in names)
    device_ms = sum(summary["by_name"][k] for k in names)
    steps = int(counters["mt3.decode_steps"])
    per_step = 2 * cfg.n_dec_layers  # self and cross attention in every layer
    if launches != per_step * steps:
        raise AssertionError(f"the trace holds {launches} _mt3_cache_attention launches for {steps} decode steps")
    # the bytes the launches read: each step's rows (its bucket) over the
    # self cache at the step's length and the cross cache
    st = tr.model._state
    row_bytes = 2 * cfg.n_heads * cfg.d_head * 4
    neg = [-c for c in flat]
    run_bytes = 0
    for t in range(steps):
        live = int(np.searchsorted(neg, -t, side="left"))
        n = min(st["rows"], -(-live // mt3.ROW_BUCKET) * mt3.ROW_BUCKET)
        run_bytes += cfg.n_dec_layers * n * row_bytes * ((t + 1) + cfg.frames)
    run_bound_ms = run_bytes / HBM_BYTES_PER_S * 1e3
    print(f"MT3 traced call [{smi}]: host wall {traced_s * 1e3:.1f} ms with the profiler on, window "
          f"{summary['window_ms']:.2f} ms, device busy share {100 * summary['busy_share']:.1f}%; {steps} decode steps, "
          f"{int(counters['mt3.token_rows_run'])} token rows run, {int(counters['mt3.tokens_emitted'])} tokens, {sum(len(e) for e, _ in got)} events; "
          f"_mt3_cache_attention {launches} launches in the trace ({per_step} a step; the wrapper counted "
          f"{wrapper_launches}: graph replays pass no wrapper), {device_ms:.3f} ms of device time, "
          f"{device_ms / launches * 1e3:.2f} us a launch; bytes bound {run_bound_ms:.3f} ms "
          f"({run_bytes} B / {HBM_BYTES_PER_S:.3g} B/s): {100 * run_bound_ms / device_ms:.1f}% of it reached")
    top = "; ".join(f"{k[:80]} {ms:.3f} ms ({100 * share:.1f}%, x{n})" for k, ms, share, n in summary["top"])
    print(f"MT3 top 5 CUDA kernels by device time [{smi}]: {top}")

    # the kernel on this call's own caches: every layer's views, as the step passes them
    rows = len(flat)
    layers = range(cfg.n_dec_layers)
    lengths = sorted({1, 64, int(np.median(flat)), flat[0]})
    cases = [("self", L, [(st["cache"][i, 0, :rows], st["cache"][i, 1, :rows]) for i in layers]) for L in lengths]
    cases.append(("cross", cfg.frames, [(st["cross"][i, 0, :rows], st["cross"][i, 1, :rows]) for i in layers]))
    rows_out = []
    worst = 0.0
    for kind, L, views in cases:
        length = torch.tensor([L], device="cuda")
        # queries of the size the step's are: a key of the cache over sqrt(d_head)
        qs = [(k[:, :, L - 1] / cfg.d_head ** 0.5).contiguous() for k, _ in views]
        for q, (k, v) in zip(qs, views):
            got_o = cache_ops.cache_attention(q, k, v, length).double()
            want = cache_ops.cache_attention_plain(q.double(), k.double(), v.double(), length)
            rel = float((got_o - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
            if rel > MT3_REL:
                raise AssertionError(f"_mt3_cache_attention {kind} L={L}: {rel:.3g} of the largest output, over {MT3_REL}")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for q, (k, v) in zip(qs, views):
                cache_ops.cache_attention(q, k, v, length)
        ms = cuda_ms(graph.replay, 25) / len(views)
        plain_ms = cuda_ms(lambda: [cache_ops.cache_attention_plain(q, k, v, length) for q, (k, v) in zip(qs, views)], 5) / len(views)
        sdpa_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(q[:, :, None], k[:, :, :L], v[:, :, :L], scale=1.0)
                                   for q, (k, v) in zip(qs, views)], 5) / len(views)
        bound_ms = rows * row_bytes * L / HBM_BYTES_PER_S * 1e3
        rows_out.append({"case": kind, "rows": rows, "length": L, "ms": ms, "plain_ms": plain_ms, "library_ms": sdpa_ms,
                         "bound_ms": bound_ms})
        print(f"_mt3_cache_attention {kind} {rows} rows x {cfg.n_heads} heads at length {L} [{smi}]: {ms:.4f} ms a launch "
              f"(CUDA graph of the 8 layers' views, 25 replays), bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%), "
              f"plain {plain_ms:.4f} ms, SDPA(scale=1) {sdpa_ms:.4f} ms")
    del graph
    print(f"_mt3_cache_attention against the float64 plain version on the call's caches: worst {worst:.3g} of a "
          f"case's largest output (limit {MT3_REL})")
    tr.close()
    print(f"MT3 phase took {time.perf_counter() - t_phase:.1f} s")
    longest = next(r for r in rows_out if r["case"] == "self" and r["length"] == flat[0])
    return {
        "name": "_mt3_cache_attention",
        "route": "triton",
        "source": "basic_pitch_torch/ops/cache_attention.py",
        # no Pallas kernel: the JAX package runs no seq2seq model
        "replaces": None,
        "launches": launches,
        "launches_by_path": {"mt3": launches},
        "max_rel_err": worst,
        "ms": longest["ms"],
        "plain_ms": longest["plain_ms"],
        "bound_ms": longest["bound_ms"],
        "bound_by": "bytes",
        "library_ms": longest["library_ms"],
        "cases": rows_out,
        "traced_call": {"launches": launches, "device_ms": device_ms, "bound_ms": run_bound_ms, "decode_steps": steps},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from basic_pitch_torch import _build
    from basic_pitch_torch import pipeline
    from basic_pitch_torch.ops import transport
    from basic_pitch_torch.decode import device as device_decode
    from basic_pitch_torch.decode import greedy_kernel

    sys.path.insert(0, str(REPO / "tests"))
    from torch_decode_cases import DEFAULTS, adversarial_cases

    # ---------------- phase 1: card, versions, kernel build ----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(clocks_and_host())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    # every native source at once: one compiler process each
    t0 = time.perf_counter()
    names = ("greedy_decode", "pcm_decode", "pcm_pack", "bp_native")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, path in zip(names, pool.map(_build.build, names)):
            print(f"built {name} ({path.name})")
    for name in names:
        _build.load(name)
    print(f"built {', '.join(names)} in parallel in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")
    # the int16 recordings of phases 2 and 3: 60 s (one 128-window chunk,
    # 37 windows real) and 10 min (three chunks)
    pcm60 = np.round(tone_mix(SR, 60.0, seed=102)[0] * 32767).astype(np.int16)
    pcm10 = np.round(tone_mix(SR, 600.0, seed=103)[0] * 32767).astype(np.int16)

    # ---------------- phase 2: kernel against plain on the card ----------------
    max_err = 0.0
    fuzz = []
    for seed, T in ((0, 300), (1, 300), (2, 300), (7, 1500)):
        rng = np.random.RandomState(seed)
        fuzz.append((f"fuzz-{seed}-{T}", (rng.rand(T, 88) ** 3), (rng.rand(T, 88) ** 5), {}))
    rng = np.random.RandomState(3)
    fuzz.append(("onset-only", rng.rand(300, 88) ** 3, rng.rand(300, 88) ** 5, dict(melodia_trick=False)))
    rng = np.random.RandomState(8)
    fuzz.append(("dense-low-thresholds", rng.rand(300, 88) ** 2, rng.rand(300, 88) ** 4, dict(onset_thresh=0.3, frame_thresh=0.15)))
    rng = np.random.RandomState(5)
    fuzz.append(("forced-overflow", rng.rand(300, 88) ** 3, rng.rand(300, 88) ** 5, dict(max_notes=40)))
    cap_on = np.zeros((6400, 88))
    rng = np.random.RandomState(11)
    for t in range(2, 6398, 2):
        cap_on[t, rng.randint(0, 88)] = 0.9
    fuzz.append(("candidate-capacity", np.zeros((6400, 88)), cap_on, dict(melodia_trick=False)))
    # walks across several 1024-frame chunks, forward (onset note) and
    # backward (a melodia seed near the end of a 2900-frame note)
    long_f, long_o = np.zeros((3100, 88)), np.zeros((3100, 88))
    long_f[10:2050, 40] = 0.9
    long_o[9:12, 40] = (0.2, 0.9, 0.2)
    long_f[100:3000, 60] = 0.5
    long_f[2500, 60] = 0.95
    fuzz.append(("long-notes", long_f, long_o, {}))
    adversarial = adversarial_cases()
    fuzz += adversarial
    before = greedy_kernel.launches
    for name, frames, onsets, kw in fuzz:
        args = dict(DEFAULTS, **kw)
        f = torch.from_numpy(frames.astype(np.float32)).to(dev)
        o = torch.from_numpy(onsets.astype(np.float32)).to(dev)
        out = greedy_kernel.decode_greedy(f, o, **args)
        ref = device_decode.decode_plain(f, o, **args)
        torch.cuda.synchronize()
        err = compare_decoded(out, ref)
        max_err = max(max_err, err)
        print(f"kernel == plain [{name}]: {int(out.n_notes)} notes, overflow {bool(out.overflow)}, max amp err {err:.3g}")
    if greedy_kernel.launches != before + len(fuzz):
        raise AssertionError("decode_greedy did not launch the kernel once per call")
    # what each adversarial case made the batched commit do
    for name, frames, onsets, kw in adversarial:
        args = dict(DEFAULTS, **kw)
        f = torch.from_numpy(frames).to(dev)
        o = torch.from_numpy(onsets).to(dev)
        inputs = device_decode.greedy_inputs(f, o, args["onset_thresh"], None, True, args["max_notes"], args.get("valid_frames"))
        meta = greedy_kernel.greedy_stages(
            inputs, args["frame_thresh"], args["min_note_len"], 11, args["max_notes"], args["max_melodia_iters"], True
        )[3]
        count, ovf, iters, rewalks = meta.cpu().tolist()
        print(f"kernel counters [{name}]: {count} notes, overflow {ovf}, {iters} melodia iterations, {rewalks} re-walks")

    # pcm_decode at the path's own shapes: the 10 min recording's last piece
    # (its needed windows past the first two 128-window pieces, 110, and no
    # zero tail) packs smaller than raw and the codec path decodes it; a full
    # chunk of its noisy start packs larger and goes raw
    chunk_len = 128 * pipeline.HOP + pipeline.OVERLAP
    n_last = pipeline._needed_windows(len(pcm10), False) - 2 * 128
    codec_row = codec_kernel_phase(pcm10[:chunk_len], pipeline.StreamingTranscriber._row(pcm10, False, 256, n_last))

    tr = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128)
    main_audio, main_notes = tone_mix(SR, 60.0, seed=100)
    with torch.inference_mode():
        out, n_frames, n_chunks = tr._forward(main_audio, SR)
        note, onset, _, floor = tr.decode_inputs(out, n_frames, n_chunks)
    T = note.shape[0]
    max_notes = max(16384, floor)
    kw = dict(max_notes=max_notes, max_melodia_iters=2 * max_notes + 2 * T, valid_frames=n_frames)
    args = (note, onset, 0.5, 0.3, 11)
    out_k = greedy_kernel.decode_greedy(*args, **kw)
    ref_p = device_decode.decode_plain(*args, **kw)
    torch.cuda.synchronize()
    err = compare_decoded(out_k, ref_p)
    max_err = max(max_err, err)
    n_main = int(out_k.n_notes)
    print(f"kernel == plain [main shape T={T} max_notes={max_notes}]: {n_main} notes, max amp err {err:.3g}")
    kernel_ms = cuda_ms(lambda: greedy_kernel.decode_greedy(*args, **kw), reps=10)
    plain_ms = cuda_ms(lambda: device_decode.decode_plain(*args, **kw), reps=2)
    inputs = device_decode.greedy_inputs(note, onset, 0.5, None, True, max_notes, n_frames)
    split_main = stage_split(greedy_kernel, inputs, 11, max_notes, kw["max_melodia_iters"], reps=10)
    stages_ms = split_main["both_ms"]
    # least time: read the n_frames valid frames of frames and onsets once
    # (the padding past them is masked to zero) and write the kept notes
    # once; against one float32 comparison per valid input value at the
    # card's non-tensor float32 rate
    bytes_moved = 2 * n_frames * 88 * 4 + n_main * 16 + 16
    ops = 2 * n_frames * 88
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(
        f"greedy_decode at T={T} ({n_frames} valid frames): wrapper {kernel_ms:.3f} ms (kernel alone {stages_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({bytes_moved} bytes / 3.35 TB/s; {ops} float32 operations / 67 TFLOP/s)"
    )

    # the same shape with dense seeded activity (thousands of notes)
    dense_f, dense_o = piano_roll(T, 1500, seed=1)
    dense_args = (torch.from_numpy(dense_f).to(dev), torch.from_numpy(dense_o).to(dev), 0.5, 0.3, 11)
    dense_kw = dict(max_notes=max_notes, max_melodia_iters=2 * max_notes + 2 * T)
    out_k = greedy_kernel.decode_greedy(*dense_args, **dense_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_p = device_decode.decode_plain(*dense_args, **dense_kw)
    torch.cuda.synchronize()
    dense_plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_decoded(out_k, ref_p)
    max_err = max(max_err, err)
    dense_ms = cuda_ms(lambda: greedy_kernel.decode_greedy(*dense_args, **dense_kw), reps=5)
    print(
        f"kernel == plain [dense T={T}]: {int(out_k.n_notes)} notes, max amp err {err:.3g}; "
        f"wrapper {dense_ms:.3f} ms, plain {dense_plain_ms:.1f} ms"
    )
    print_split(f"main T={T}", split_main)
    dense_inputs = device_decode.greedy_inputs(*dense_args[:3], None, True, max_notes, None)
    print_split(f"dense T={T}", stage_split(greedy_kernel, dense_inputs, 11, max_notes, dense_kw["max_melodia_iters"], reps=5))

    # a dense tone mix (8 voices, ~12 notes at once) through the model: the
    # decode inputs a polyphonic recording really gives the kernel
    poly_audio, poly_notes = tone_mix(SR, 60.0, seed=300, voices=8)
    with torch.inference_mode():
        out, n_frames, n_chunks = tr._forward(poly_audio, SR)
        p_note, p_onset, _, _ = tr.decode_inputs(out, n_frames, n_chunks)
    poly_args = (p_note, p_onset, 0.5, 0.3, 11)
    poly_kw = dict(kw, valid_frames=n_frames)
    out_k = greedy_kernel.decode_greedy(*poly_args, **poly_kw)
    ref_p = device_decode.decode_plain(*poly_args, **poly_kw)
    err = compare_decoded(out_k, ref_p)
    max_err = max(max_err, err)
    poly_ms = cuda_ms(lambda: greedy_kernel.decode_greedy(*poly_args, **poly_kw), reps=10)
    print(f"kernel == plain [8-voice tone mix T={T}]: {int(out_k.n_notes)} notes, max amp err {err:.3g}; wrapper {poly_ms:.3f} ms")
    poly_inputs = device_decode.greedy_inputs(p_note, p_onset, 0.5, None, True, max_notes, n_frames)
    print_split(f"8-voice tone mix T={T}", stage_split(greedy_kernel, poly_inputs, 11, max_notes, kw["max_melodia_iters"], reps=10))

    # one hour of frames with sparse notes: the table layout at a long T
    long_T = 310_000
    lf, lo = sparse_roll(long_T, 300, seed=4)
    long_args = (torch.from_numpy(lf).to(dev), torch.from_numpy(lo).to(dev), 0.5, 0.3, 11)
    long_kw = dict(max_notes=16384, max_melodia_iters=2 * 16384 + 2 * long_T)
    out_k = greedy_kernel.decode_greedy(*long_args, **long_kw)
    t0 = time.perf_counter()
    ref_p = device_decode.decode_plain(*long_args, **long_kw)
    torch.cuda.synchronize()
    long_plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_decoded(out_k, ref_p)
    max_err = max(max_err, err)
    long_ms = cuda_ms(lambda: greedy_kernel.decode_greedy(*long_args, **long_kw), reps=5)
    print(
        f"kernel == plain [sparse T={long_T}]: {int(out_k.n_notes)} notes, max amp err {err:.3g}; "
        f"wrapper {long_ms:.3f} ms, plain {long_plain_ms:.1f} ms"
    )
    long_inputs = device_decode.greedy_inputs(*long_args[:3], None, True, 16384, None)
    print_split(f"sparse T={long_T}", stage_split(greedy_kernel, long_inputs, 11, 16384, long_kw["max_melodia_iters"], reps=5))

    # ---------------- phase 3: the main path at full width ----------------
    warm, _ = tone_mix(SR, 10.0, seed=99)
    tr.transcribe(warm, SR)  # first-call set-up (cuDNN, allocator) outside the timed run
    print(f"transport probe (pcm_transport='auto'): {json.dumps(transport.probe('cuda'))}")
    recordings = [("22.05k float32", main_audio, SR, main_notes)]
    y44, notes44 = tone_mix(2 * SR, 60.0, seed=101)
    recordings.append(("44.1k int16", np.round(y44 * 32767).astype(np.int16), 2 * SR, notes44))
    batch = []
    for i in range(4):
        rate = SR if i % 2 == 0 else 2 * SR
        y, notes = tone_mix(rate, 60.0, seed=200 + i)
        batch.append((f"batch[{i}] {rate} Hz", y, rate, notes))

    greedy_kernel.launches = 0
    fallbacks = tr.host_fallbacks
    torch.cuda.synchronize()
    walls = []
    results = []
    for name, y, rate, notes in recordings:
        t0 = time.perf_counter()
        events = tr.transcribe(y, rate)
        walls.append(time.perf_counter() - t0)
        results.append((name, events, notes, len(y) / rate))
    t0 = time.perf_counter()
    batch_events = tr.transcribe_batch([(y, rate) for _, y, rate, _ in batch])
    batch_wall = time.perf_counter() - t0
    main_launches = greedy_kernel.launches
    for (name, y, rate, notes), events in zip(batch, batch_events):
        results.append((name, events, notes, len(y) / rate))

    if main_launches != len(results):
        raise AssertionError(f"kernel launched {main_launches} times for {len(results)} recordings")
    if tr.host_fallbacks != fallbacks:
        raise AssertionError("the host-decode overflow fallback fired on the main path")
    for name, events, notes, seconds in results:
        r = recall(events, notes)
        print(f"main path [{name}]: {len(events)} events for {len(notes)} synthesised notes, recall {r:.3f}")
        if r < 0.8:
            raise AssertionError(f"{name}: only {r:.3f} of the synthesised notes came back")
    for (name, _, _, seconds), wall in zip(results, walls):
        print(f"wall per recording [{name}]: {wall * 1e3:.1f} ms for {seconds:.1f} s of audio, real-time factor {seconds / wall:.1f}x")
    batch_seconds = sum(s for _, _, _, s in results[len(walls):])
    print(f"wall for transcribe_batch of 4: {batch_wall * 1e3:.1f} ms ({batch_wall / 4 * 1e3:.1f} ms per recording), real-time factor {batch_seconds / batch_wall:.1f}x")

    # the dense 8-voice tone mix end to end, beside the sparse one
    t0 = time.perf_counter()
    poly_events = tr.transcribe(poly_audio, SR)
    poly_wall = time.perf_counter() - t0
    print(
        f"wall per recording [8-voice tone mix]: {poly_wall * 1e3:.1f} ms for 60.0 s of audio, real-time factor "
        f"{60.0 / poly_wall:.1f}x; {len(poly_events)} events for {len(poly_notes)} synthesised notes, "
        f"recall {recall(poly_events, poly_notes):.3f}"
    )
    if not poly_events:
        raise AssertionError("the 8-voice tone mix gave no events")
    for name, audio in (("22.05k float32", main_audio), ("8-voice tone mix", poly_audio)):
        stages = breakdown(tr, pipeline, audio, SR, reps=5)
        print(f"stage breakdown [{name}, mean of 5]: " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in stages.items()))

    # the settings of this slice: precision and lowerings, grouping, transport
    codec_path = settings_phase(smi, poly_audio, pcm60, pcm10)

    # ---------------- phase 4: card against CPU ----------------
    # the golden random-window audio of the tests (~4 s): no near-silent CQT
    # bins, whose float32 rounding the dB normalisation would amplify, so
    # what remains is the products' precision. TF32 turned on for one run is
    # the control that shows the check can tell.
    clip = np.load(REPO / "tests" / "goldens" / "random_windows.npz")["audio"].reshape(-1)
    gpu2 = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=2)
    cpu2 = pipeline.StreamingTranscriber(device="cpu", windows_per_chunk=2)
    pc = cpu2.posteriorgrams(clip, SR)
    # the process-wide flags turned on must not reach a "highest" model stage
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pg = gpu2.posteriorgrams(clip, SR)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    # the control: TF32 asked for, front end and heads
    pt = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=2, precision="high").posteriorgrams(clip, SR)
    d_tf32 = {}
    for key in ("note", "onset", "contour"):
        d = float(np.abs(pg[key] - pc[key]).max())
        d_tf32[key] = float(np.abs(pt[key] - pc[key]).max())
        print(f"posteriorgram {key}: card vs cpu max abs diff {d:.3g} (precision='high', TF32: {d_tf32[key]:.3g})")
        if not d <= 1e-4:
            raise AssertionError(f"{key}: card and CPU differ by {d} > 1e-4")
    if max(d_tf32.values()) <= 1e-4:
        raise AssertionError("the TF32 control stayed within 1e-4 of the CPU: the check cannot tell")

    # ---------------- phase 5: the serving surfaces ----------------
    by_path = {"main": main_launches, "codec_transport": codec_path["greedy_decode"], **serving_phase()}
    serve_cli_phase(smi)

    # ---------------- phase 6: model formats ----------------
    by_path["formats"] = formats_phase(smi, main_audio)

    # ---------------- phase 7: training ----------------
    trained, train_codec = training_phase(smi)
    by_path.update(trained)
    codec_by_path = {"codec_transport": codec_path["pcm_decode"], "train_codec_batch": train_codec}

    # ---------------- phase 8: data, scoring and measurement ----------------
    measured, records = data_phase(smi)
    by_path["measure"] = measured["greedy_decode"]
    codec_by_path["measure"] = measured["pcm_decode"]

    # ---------------- phase 9: parallel and native ----------------
    sharded = sharded_phase(smi, tr, poly_audio, recordings[1][1])
    by_path["parallel"] = sharded["greedy_decode"]
    codec_by_path["parallel"] = sharded["pcm_decode_auto"]
    codec_by_path["parallel_codec"] = sharded["pcm_decode_codec"]
    distributed_phase(smi)
    native_phase(smi, records)
    print(f"greedy_decode launches by path: {json.dumps(by_path)}")
    print(f"pcm_decode launches by path: {json.dumps(codec_by_path)}")

    # ---------------- phase 10: MT3 ----------------
    mt3_kernel = mt3_phase(smi)

    # ---------------- phase 11: kernels ----------------
    kernels = [{
        "name": "greedy_decode",
        "route": "cuda",
        "source": "basic_pitch_torch/csrc/greedy_decode.cu",
        "replaces": "basic_pitch_tpu/decode/pallas_kernel.py:90",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "pcm_decode",
        "route": "cuda",
        "source": "basic_pitch_torch/csrc/pcm_decode.cu",
        # no Pallas kernel: the JAX package decodes with XLA programs
        "replaces": "basic_pitch_tpu/ops/pcmcodec.py:531",
        "launches": sum(codec_by_path.values()),
        "launches_by_path": codec_by_path,
        "max_abs_err": codec_row["max_abs_err"],
        "ms": codec_row["ms"],
        "wrapper_ms": codec_row["wrapper_ms"],
        "plain_ms": codec_row["plain_ms"],
        "bound_ms": codec_row["bound_ms"],
        "bound_by": codec_row["bound_by"],
        "library_ms": None,
    }, mt3_kernel]
    print(json.dumps({"kernels": kernels}))

    # ---------------- phase 12: result ----------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
