"""Stress the exit of two-process runs: N concurrent pairs of
`tests/torch_dist_worker.py bn` (gloo on the CPU, one thread each, a free
port a pair), R rounds, counting the worker processes that exit nonzero.
Not a test module: pytest collects nothing here.

    python tests/torch_dist_stress.py [--root REPO] [--pairs 6] [--rounds 35]

Prints each nonzero exit with the end of its output, then one line:
``workers W nonzero K seconds S``. Exits 1 when K > 0. ``--root`` runs the
worker of another checkout (e.g. a parent commit unpacked elsewhere).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--rounds", type=int, default=35)
    args = parser.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root))
    workers = nonzero = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for rnd in range(args.rounds):
            procs = []
            for pair in range(args.pairs):
                port = free_port()
                for rank in range(2):
                    out = pathlib.Path(tmp) / f"{rnd}_{pair}_{rank}.npz"
                    cmd = [sys.executable, str(root / "tests" / "torch_dist_worker.py"), "bn", str(rank), "2",
                           str(port), str(out)]
                    procs.append((rank, subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
            for rank, proc in procs:
                try:
                    text = proc.communicate(timeout=300)[0]
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                workers += 1
                if proc.returncode != 0:
                    nonzero += 1
                    print(f"round {rnd} rank {rank} exit {proc.returncode}: {text[-400:]!r}", flush=True)
    print(f"workers {workers} nonzero {nonzero} seconds {time.perf_counter() - t0:.0f}", flush=True)
    return 1 if nonzero else 0


if __name__ == "__main__":
    sys.exit(main())
