#!/usr/bin/env python3
"""Time the HTTP server of one or more checkouts of the PyTorch port on one
NVIDIA GPU: rounds of 8 concurrent 30 s requests, in turns.

    python3 chip_serve_times.py [ROOT[@KWARGS] ...]

Each ROOT is the root of a checkout (default: this one); KWARGS, when
given, is a JSON object of `StreamingTranscriber` keyword arguments that
this root's transcriber takes (for example '{"pcm_transport": "raw"}' or
'{"transport_ttl_s": 0}', which asks for a transport re-probe on every
call). Give the roots in the order A B B A to compare two versions within
one run on one card. Each runs in a process of its own, which imports that
root's `basic_pitch_torch` and builds the server as `chip_smoke.py`'s
serving phase does: W = 128, `max_batch=8`, `max_wait_ms=25`, warmed with a
10 s clip, the same eight 30 s PCM16 WAV bodies (4 sparse, 4 8-voice tone
mixes, from this checkout's `chip_smoke.tone_mix`). Then ROUNDS rounds (5),
0.5 s apart, each 8 requests started together; per round it prints a JSON
line: wall, latency p50 and max, the slowest request's time to connect,
batches, and the service's busy seconds. The card's name and power limit
come first.
"""

from __future__ import annotations

import importlib.util
import io
import json
import pathlib
import subprocess
import sys
import threading
import time

HERE = pathlib.Path(__file__).resolve().parent
ROUNDS = 5


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(spec: str) -> int:
    root, _, kwargs_json = spec.partition("@")
    kwargs = json.loads(kwargs_json) if kwargs_json else {}
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import numpy as np

    from basic_pitch_torch import pipeline, serve
    from basic_pitch_torch.cli import serve as serve_cli
    from basic_pitch_torch.utils import audio as audio_io

    cs = _smoke()
    transcriber = pipeline.StreamingTranscriber(**{"windows_per_chunk": 128, **kwargs})
    serve_cli._warm(transcriber, "10")
    wavs = []
    for i in range(8):
        y, _ = cs.tone_mix(cs.SR, 30.0, seed=400 + i, voices=1 if i < 4 else 8)
        buf = io.BytesIO()
        audio_io.write_wav(buf, y, cs.SR)
        wavs.append(buf.getvalue())
    service = serve.TranscriptionService(transcriber, max_batch=8, max_wait_ms=25.0)
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]

    def post(i: int, connect: list, latency: list, barrier: threading.Barrier) -> None:
        import http.client

        barrier.wait()
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.connect()
        connect[i] = time.perf_counter() - t0
        conn.request("POST", "/v1/transcribe", body=wavs[i])
        resp = conn.getresponse()
        resp.read()
        latency[i] = time.perf_counter() - t0
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"request {i}: HTTP {resp.status}")

    try:
        for r in range(ROUNDS):
            time.sleep(0.5)
            m0 = service.snapshot_metrics()
            connect, latency = [0.0] * 8, [0.0] * 8
            barrier = threading.Barrier(8)
            threads = [threading.Thread(target=post, args=(i, connect, latency, barrier)) for i in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            wall = time.perf_counter() - t0
            m1 = service.snapshot_metrics()
            print(json.dumps({
                "root": root, "kwargs": kwargs, "round": r, "wall_ms": wall * 1e3,
                "p50_ms": float(np.median(latency)) * 1e3, "max_ms": max(latency) * 1e3,
                "max_connect_ms": max(connect) * 1e3, "batches": m1["batches"] - m0["batches"],
                "busy_ms": (m1["busy_seconds"] - m0["busy_seconds"]) * 1e3,
                "listen_backlog": getattr(server, "request_queue_size", None),
            }), flush=True)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    return 0


def main(specs: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_serve_times: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for spec in specs or [str(HERE)]:
        proc = subprocess.run([sys.executable, str(HERE / "chip_serve_times.py"), "--worker", spec], timeout=600)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
