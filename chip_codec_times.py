#!/usr/bin/env python3
"""Where the codec decode kernel's time goes, on one NVIDIA GPU: the
`pcm_decode` of this checkout beside variants of its source with one part
taken out or changed, timed in turns.

    python3 chip_codec_times.py [--rounds 2]

Each variant is `basic_pitch_torch/csrc/pcm_decode.cu` with one text
substitution, compiled with nvcc and `_build.NVCC_FLAGS` into a temporary
directory:

  kernel               the source as it is
  fixed, 1 stage       kStages = 1: a CTA's 32 rows staged as one span and
                       decoded once it has landed
  fixed, 4 stages      kStages = 4: four spans of 8 rows, all in flight
  lpc, no chain        the LPC recurrence replaced by x = r
  lpc, no reader       the LPC residual reader replaced by a constant
  lpc, neither         both

The LPC variants give wrong samples on purpose and are timed only; the
kernel and the stage variants must give pcm / 32768 bit for bit. Each is
timed as `chip_smoke.pcm_decode_device_ms` times the kernel (16 launches in
a CUDA graph over 4 copies of wire and output, past the 50 MB L2) on
`chip_smoke.py`'s two timed pieces: the 10 min recording's last 128-window
chunk in the default mode ("path") and forced to LPC ("path_lpc"). The
variants run in order, then in reverse, for ``--rounds`` rounds. Prints the
card's name and power limit, then one JSON line per variant and piece with
each round's ms, the bytes bound and the best share of it.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent

STAGES = "constexpr int kStages = 2;"
CHAIN = "const int32_t x = r + ((c[0] * h[(i + 7) & 7] + rest) >> shift);"
READER = "const int32_t r = rd.next(k);"
VARIANTS = {
    "kernel": [],
    "fixed, 1 stage": [(STAGES, "constexpr int kStages = 1;")],
    "fixed, 4 stages": [(STAGES, "constexpr int kStages = 4;")],
    "lpc, no chain": [(CHAIN, "const int32_t x = r + (rest & 0);")],
    "lpc, no reader": [(READER, "const int32_t r = i;")],
    "lpc, neither": [(CHAIN, "const int32_t x = r + (rest & 0);"), (READER, "const int32_t r = i;")],
}
EXACT = ("kernel", "fixed, 1 stage", "fixed, 4 stages")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(tmp: pathlib.Path, name: str, edits: "list[tuple[str, str]]") -> ctypes.CDLL:
    from basic_pitch_torch import _build

    text = _build.source("pcm_decode").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
        text = text.replace(old, new)
    stem = f"v{list(VARIANTS).index(name)}"
    src, lib = tmp / f"{stem}.cu", tmp / f"lib{stem}.so"
    src.write_text(text)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name!r}:\n{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    out.pcm_decode_launch.restype = ctypes.c_int
    out.pcm_decode_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_int64, ctypes.c_void_p,
                                                                                 ctypes.c_void_p]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_codec_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from basic_pitch_torch import pipeline
    from basic_pitch_torch.ops import pcmcodec
    from basic_pitch_torch.ops import upload as upload_ops

    cs = _smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    pcm10 = np.round(cs.tone_mix(cs.SR, 600.0, seed=103)[0] * 32767).astype(np.int16)
    chunk_len = 128 * pipeline.HOP + pipeline.OVERLAP
    last_lo = 2 * 128 * pipeline.HOP - pipeline.OVERLAP // 2
    piece = upload_ops.padded_slice(pcm10, last_lo, last_lo + chunk_len)
    exact = torch.from_numpy(piece.astype(np.float32) / np.float32(32768.0)).to(dev)
    pieces = {}
    for name, mode in (("path", None), ("path_lpc", "lpc")):
        packed = pcmcodec.pack(piece, mode=mode)
        wire, layout = pcmcodec.to_wire(packed)
        pieces[name] = (torch.from_numpy(wire).to(dev), layout, cs.pcm_decode_bytes(packed, len(piece)))
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(pathlib.Path(tmp), name, edits) for name, edits in VARIANTS.items()}
        times: dict = {}
        for rnd in range(args.rounds):
            for name in (list(VARIANTS) if rnd % 2 == 0 else list(reversed(VARIANTS))):
                for pname, (wire, layout, _) in pieces.items():
                    ms = cs.pcm_decode_device_ms(wire, layout, len(piece), exact if name in EXACT else None,
                                                 lib=libs[name])
                    times.setdefault((name, pname), []).append(ms)
    for (name, pname), ms in times.items():
        bound_ms = pieces[pname][2] / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps({"variant": name, "piece": pname, "ms": ms, "bound_ms": bound_ms,
                          "bound_share": bound_ms / min(ms), "exact_checked": name in EXACT, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
