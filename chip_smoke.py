#!/usr/bin/env python3
"""Drive the PyTorch port (`basic_pitch_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, torch/CUDA versions, and the build of
     every hand-written kernel from csrc/ (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card: seeded fuzz
     cases, adversarial cases for the kernel's batched commit
     (tests/torch_decode_cases.py, with its re-walk counter), the main path's own decode inputs (T = 18 176
     frames, max_notes 16 384, melodia on), timed at that shape, a dense
     seeded roll and an 8-voice tone mix at the same shape, and one hour of
     sparse frames (T = 310 000); for each, the kernel's time with melodia
     off and on and its counters (candidates, notes, melodia iterations,
     re-walks);
  3. the main path at full width: StreamingTranscriber(device="cuda",
     windows_per_chunk=128) with the shipped weights transcribes ~60 s
     recordings (22.05 kHz float32, 44.1 kHz int16, and a batch of 4); the
     kernel must launch once per recording, the host fallback must never
     fire, and the synthesised notes must come back; then the 8-voice tone
     mix, and where one recording's wall goes for it and a sparse one;
  4. posteriorgrams on the card against the port on the CPU within 1e-4 on
     the tests' golden audio, which shows that TF32 is off (a run with TF32
     on is printed beside it as the control);
  5. the serving surfaces at full width with the shipped weights: the HTTP
     server (8 concurrent 30 s requests whose events must equal
     `transcribe` on the card, csv and midi bodies, a chunked /v1/stream
     whose events must arrive before the body ends), `predict_and_save`
     against `predict_and_save_streaming` (the one-flip rule, posteriorgrams
     within 1e-4), the predict CLI in a subprocess and the stream CLI; the
     kernel must launch on every path that decodes on the card, and never
     on the windowed `predict` path, which decodes on the host;
  6. a JSON line listing every hand kernel with its launches on the paths
     driven (their sum, the split beside it), its error against the plain
     version and its times;
  7. as the last line, {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import io
import json
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


def tone_mix(sr: int, seconds: float, seed: int, noise: float = 0.01, voices: int = 1) -> Tuple[np.ndarray, List[Tuple[float, int]]]:
    """Seeded polyphonic mix of harmonic tones over a noise floor: `voices`
    independent streams of notes (each note 0.5-1.2 s, a new one every
    0.35-0.7 s), so about 1.5 x voices notes sound at once. Returns
    (float32 audio, list of (onset seconds, MIDI pitch))."""
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
            notes.append((t_start, midi))
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
    t_phase = time.perf_counter()
    launches = {}

    # ---- HTTP: 8 concurrent 30 s requests, csv, midi, one stream ----
    transcriber = pipeline.StreamingTranscriber(windows_per_chunk=128)
    serve_cli._warm(transcriber, "10")
    wavs, expected = [], []
    for i in range(8):
        y, _ = tone_mix(SR, 30.0, seed=400 + i, voices=1 if i < 4 else 8)
        buf = io.BytesIO()
        audio_io.write_wav(buf, y, SR)
        wavs.append(buf.getvalue())
        # the reference: the same int16 samples through transcribe, on this
        # thread, before the service's dispatch thread owns the transcriber
        expected.append(transcriber.transcribe(np.frombuffer(wavs[-1][44:], "<i2"), SR))
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
        if info["decode_backend"] != "kernel" or info["pcm_transport"] != "raw":
            raise AssertionError(f"/healthz on the card says {info}")
        greedy_kernel.launches = 0
        m0 = service.snapshot_metrics()
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
        m1 = service.snapshot_metrics()
        for i, (status, body) in enumerate(results):
            notes = json.loads(body)["notes"]
            got = [(n["start_time_s"], n["end_time_s"], n["pitch_midi"], n["amplitude"], n["pitch_bends"]) for n in notes]
            want = [(s, e, p, a, list(b) if b is not None else None) for s, e, p, a, b in expected[i]]
            if status != 200 or got != want:
                raise AssertionError(f"request {i}: status {status}, {len(got)} events, transcribe gave {len(want)}")
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
        f"(service lifetime {m2['x_realtime_busy']}); events equal transcribe on all 8; csv and midi bytes equal"
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from basic_pitch_torch import _build
    from basic_pitch_torch import pipeline
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
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load("greedy_decode")
    print(f"built greedy_decode ({_build.library_path('greedy_decode').name}) in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")

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

    # ---------------- phase 4: card against CPU ----------------
    # the golden random-window audio of the tests (~4 s): no near-silent CQT
    # bins, whose float32 rounding the dB normalisation would amplify, so
    # what remains is the products' precision. TF32 turned on for one run is
    # the control that shows the check can tell.
    clip = np.load(REPO / "tests" / "goldens" / "random_windows.npz")["audio"].reshape(-1)
    gpu2 = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=2)
    cpu2 = pipeline.StreamingTranscriber(device="cpu", windows_per_chunk=2)
    pc = cpu2.posteriorgrams(clip, SR)
    pg = gpu2.posteriorgrams(clip, SR)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pt = gpu2.posteriorgrams(clip, SR)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for key in ("note", "onset", "contour"):
        d = float(np.abs(pg[key] - pc[key]).max())
        d_tf32 = float(np.abs(pt[key] - pc[key]).max())
        print(f"posteriorgram {key}: card vs cpu max abs diff {d:.3g} (with TF32 on: {d_tf32:.3g})")
        if not d <= 1e-4:
            raise AssertionError(f"{key}: card and CPU differ by {d} > 1e-4")

    # ---------------- phase 5: the serving surfaces ----------------
    by_path = {"main": main_launches, **serving_phase()}
    print(f"greedy_decode launches by path: {json.dumps(by_path)}")

    # ---------------- phase 6: kernels ----------------
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
    }]
    print(json.dumps({"kernels": kernels}))

    # ---------------- phase 7: result ----------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
