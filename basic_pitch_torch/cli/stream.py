"""``basic-pitch-torch-stream`` — live transcription of PCM on stdin.

The flags and NDJSON output of `basic_pitch_tpu/cli/stream.py`, plus
``--device``: raw PCM in, one JSON note event per line out, emitted as each
event finalizes (not at end of stream), through
`streaming.StreamingSession` over the port's transcriber (the greedy-decode
CUDA kernel on the card). Pairs with any capture tool:

    arecord -f S16_LE -r 22050 -c 1 -t raw | basic-pitch-torch-stream
    ffmpeg -i rtmp://... -f s16le -ar 22050 -ac 1 - | basic-pitch-torch-stream
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import BinaryIO, List, Optional, TextIO

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Transcribe raw PCM from stdin, emitting NDJSON note "
        "events as they finalize."
    )
    parser.add_argument("--sample-rate", type=int, default=22050,
                        choices=[22050, 44100])
    parser.add_argument("--pcm-format", choices=["s16le", "f32le"], default="s16le",
                        help="raw sample encoding on stdin (mono)")
    parser.add_argument("--block-seconds", type=float, default=0.25,
                        help="stdin read granularity")
    parser.add_argument("--segment-seconds", type=float, default=2.0,
                        help="decode cadence (latency/throughput knob)")
    parser.add_argument("--lookahead-seconds", type=float, default=1.0,
                        help="right-context before an event is final")
    parser.add_argument("--max-context-seconds", type=float, default=12.0)
    parser.add_argument("--model-path", default=None,
                        help="checkpoint (defaults to the ICASSP 2022 weights)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the model and the note decode run "
                        "(default cuda; fails without a GPU)")
    parser.add_argument("--windows-per-chunk", type=int, default=16,
                        help="device dispatch width (small favors latency)")
    parser.add_argument("--onset-threshold", type=float, default=0.5)
    parser.add_argument("--frame-threshold", type=float, default=0.3)
    parser.add_argument("--minimum-note-length", type=int, default=11,
                        help="frames, like StreamingTranscriber")
    parser.add_argument("--minimum-frequency", type=float, default=None)
    parser.add_argument("--maximum-frequency", type=float, default=None)
    parser.add_argument("--no-melodia", action="store_true")
    parser.add_argument("--no-pitch-bends", action="store_true")
    return parser


def _emit(events, out) -> int:
    for start, end, pitch, amplitude, bends in events:
        out.write(
            json.dumps(
                {
                    "start_time_s": round(float(start), 6),
                    "end_time_s": round(float(end), 6),
                    "pitch_midi": int(pitch),
                    "amplitude": round(float(amplitude), 6),
                    "velocity": int(np.round(127 * float(amplitude))),
                    "pitch_bends": (
                        [int(b) for b in bends] if bends is not None else None
                    ),
                }
            )
            + "\n"
        )
    out.flush()
    return len(events)


def main(
    args: Optional[List[str]] = None,
    stdin: Optional[BinaryIO] = None,
    stdout: Optional[TextIO] = None,
) -> int:
    ns = build_parser().parse_args(args)
    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout

    from basic_pitch_torch import pipeline, streaming
    from basic_pitch_torch.models.params import ICASSP_2022_WEIGHTS_PATH

    transcriber = pipeline.StreamingTranscriber(
        ns.model_path or str(ICASSP_2022_WEIGHTS_PATH),
        windows_per_chunk=ns.windows_per_chunk,
        device=ns.device,
    )
    session = streaming.StreamingSession(
        transcriber,
        sample_rate=ns.sample_rate,
        segment_seconds=ns.segment_seconds,
        lookahead_seconds=ns.lookahead_seconds,
        max_context_seconds=ns.max_context_seconds,
        onset_threshold=ns.onset_threshold,
        frame_threshold=ns.frame_threshold,
        min_note_length=ns.minimum_note_length,
        min_freq=ns.minimum_frequency,
        max_freq=ns.maximum_frequency,
        melodia_trick=not ns.no_melodia,
        include_pitch_bends=not ns.no_pitch_bends,
    )

    dtype = np.int16 if ns.pcm_format == "s16le" else np.float32
    bytes_per_sample = np.dtype(dtype).itemsize
    block_bytes = max(
        bytes_per_sample,
        int(ns.block_seconds * ns.sample_rate) * bytes_per_sample,
    )

    n_events = 0
    carry = b""
    try:
        while True:
            raw = stdin.read(block_bytes)
            if not raw:
                break
            raw = carry + raw
            usable = len(raw) - len(raw) % bytes_per_sample
            carry = raw[usable:]
            if usable:
                samples = np.frombuffer(raw[:usable], dtype=dtype)
                n_events += _emit(session.feed(samples), stdout)
    finally:
        n_events += _emit(session.close(), stdout)
    if carry:
        print(
            f"warning: {len(carry)} trailing byte(s) did not form a sample",
            file=sys.stderr,
        )
    print(
        f"stream done: {session.stats['flushes']:.0f} flushes, "
        f"{n_events} events",
        file=sys.stderr,
    )
    return 0


def console_entry_point() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    console_entry_point()
