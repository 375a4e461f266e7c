"""``basic-pitch-torch-serve`` — HTTP transcription server on one GPU.

The flags of `basic_pitch_tpu/cli/serve.py`, plus ``--device``. The JAX
server's ``--decode-backend`` and ``--pcm-transport`` have no counterpart:
the device fixes both (the greedy-decode CUDA kernel and raw upload on the
card, the plain decoder on the CPU). ``--head-precision`` waits for the
transcriber's precision settings.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from basic_pitch_torch.models.params import ICASSP_2022_WEIGHTS_PATH


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve basic-pitch transcription over HTTP "
        "(POST /v1/transcribe with a WAV body; GET /healthz, /metrics)."
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8132)
    parser.add_argument(
        "--model-path",
        default=str(ICASSP_2022_WEIGHTS_PATH),
        help="checkpoint: a flat-npz parameter archive",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the model and the note decode run (default cuda; fails without a GPU)",
    )
    parser.add_argument(
        "--windows-per-chunk", type=int, default=128,
        help="device dispatch width (see StreamingTranscriber)",
    )
    parser.add_argument(
        "--max-batch", type=int, default=8,
        help="max concurrent requests fused into one device dispatch",
    )
    parser.add_argument(
        "--max-wait-ms", type=float, default=25.0,
        help="how long the first request in a batch waits for company",
    )
    parser.add_argument(
        "--max-queue", type=int, default=32,
        help="bounded admission: pending requests beyond this are shed "
        "with HTTP 503 + Retry-After instead of queueing unboundedly",
    )
    parser.add_argument(
        "--request-timeout", type=float, default=None, metavar="SECONDS",
        help="per-request deadline: callers waiting longer get HTTP 504 and "
        "their request is dropped from later batches (default: no timeout)",
    )
    parser.add_argument(
        "--max-body-mb", type=float, default=256.0,
        help="largest accepted request body (413 beyond it)",
    )
    parser.add_argument(
        "--warmup", default="30",
        help="comma-separated clip lengths (seconds) to transcribe at boot, so "
        "the decode kernel is built and the first buckets' allocations and "
        "cuDNN set-up happen before the first caller; '' disables",
    )
    return parser


def _warm(transcriber, lengths_csv: str) -> None:
    """Transcribe synthetic clips of the given lengths. On the card the first
    one builds (nvcc) and loads the greedy-decode kernel. Runs on the
    calling thread, before the service's dispatch thread exists."""
    import time

    import numpy as np

    from basic_pitch_torch import constants

    sr = constants.AUDIO_SAMPLE_RATE
    for field in lengths_csv.split(","):
        field = field.strip()
        if not field:
            continue
        seconds = float(field)
        t = np.arange(int(seconds * sr)) / sr
        # repeating plucked tones: cheap to synthesize, dense enough in
        # notes to exercise realistic decode/fetch capacity buckets
        y = 0.3 * np.sin(2 * np.pi * 220.0 * t) * np.exp(-2.0 * (t % 0.5))
        pcm = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
        t0 = time.time()
        transcriber.transcribe(pcm, sr)
        logging.info("warmed %.0fs shapes in %.1fs", seconds, time.time() - t0)


def main(args: Optional[List[str]] = None) -> None:
    ns = build_parser().parse_args(args)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from basic_pitch_torch import pipeline, serve

    transcriber = pipeline.StreamingTranscriber(
        ns.model_path,
        windows_per_chunk=ns.windows_per_chunk,
        device=ns.device,
    )
    if ns.warmup:
        _warm(transcriber, ns.warmup)
    service = serve.TranscriptionService(
        transcriber,
        max_batch=ns.max_batch,
        max_wait_ms=ns.max_wait_ms,
        max_queue=ns.max_queue,
        request_timeout_s=ns.request_timeout,
    )
    server = serve.make_server(
        service, ns.host, ns.port,
        max_body_bytes=int(ns.max_body_mb * (1 << 20)),
    )
    host, port = server.server_address[:2]
    logging.info(
        "basic-pitch-torch-serve on http://%s:%d (device=%s decode=%s transport=%s)",
        host, port, transcriber.device, transcriber.decode_backend, transcriber.pcm_transport,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
