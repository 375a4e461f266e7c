#!/usr/bin/env python3
"""Time the greedy decode kernel of one or more checkouts of the PyTorch port
on one NVIDIA GPU, stage by stage, in turns.

    python3 chip_decode_times.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); give two roots in
the order A B B A to compare two versions within one run on one card. Each
root runs in a process of its own, which imports that root's
`basic_pitch_torch`, builds its kernel and times `greedy_stages` (the kernel
alone, on inputs already on the card) with melodia off (stage 1 only) and
on, with CUDA events (`chip_smoke.stage_split`), on four cases:

  main      the transcriber's decode inputs for a 60 s tone mix (T = 18 176)
  dense     a seeded dense piano roll (1500 notes) at the same T
  8-voice   the transcriber's decode inputs for an 8-voice 60 s tone mix
  sparse    one hour of sparse frames (T = 310 000)

It prints one JSON line per root and case, and the card's name and power
limit. The inputs come from this checkout's `chip_smoke.py`.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str) -> int:
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch

    from basic_pitch_torch import pipeline
    from basic_pitch_torch.decode import device as device_decode
    from basic_pitch_torch.decode import greedy_kernel

    cs = _smoke()
    dev = torch.device("cuda")
    tr = pipeline.StreamingTranscriber(device="cuda", windows_per_chunk=128)
    max_notes = 16384
    cases = []
    for name, seed, voices in (("main", 100, 1), ("8-voice", 300, 8)):
        audio, _ = cs.tone_mix(cs.SR, 60.0, seed=seed, voices=voices)
        with torch.inference_mode():
            out, n_frames, n_chunks = tr._forward(audio, cs.SR)
            note, onset, _, _ = tr.decode_inputs(out, n_frames, n_chunks)
        cases.append((name, note, onset, n_frames))
    T = cases[0][1].shape[0]
    f, o = cs.piano_roll(T, 1500, seed=1)
    cases.append(("dense", torch.from_numpy(f).to(dev), torch.from_numpy(o).to(dev), None))
    f, o = cs.sparse_roll(310_000, 300, seed=4)
    cases.append(("sparse", torch.from_numpy(f).to(dev), torch.from_numpy(o).to(dev), None))
    for name, note, onset, valid in cases:
        n = note.shape[0]
        inputs = device_decode.greedy_inputs(note, onset, 0.5, None, True, max_notes, valid)
        row = cs.stage_split(greedy_kernel, inputs, 11, max_notes, 2 * max_notes + 2 * n, reps=10 if n < 100_000 else 5)
        print(json.dumps({"root": root, "case": name, "T": n, **row}), flush=True)
    return 0


def main(roots: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_times: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for root in roots or [str(HERE)]:
        proc = subprocess.run([sys.executable, str(HERE / "chip_decode_times.py"), "--worker", root])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
