"""Multi-process self-check: one process of an N-process data-parallel
train step, and the dry run of the parallel path.

PyTorch counterpart of `basic_pitch_tpu/parallel/selfcheck.py`. Each
process runs the full train step twice, on a dense batch and on a
device-rasterized sparse batch (`data/loader._collate_device`), over its
slice of the same seeded global batch, with the batch-norm statistics, the
losses and the gradients summed over processes (`train/loop.train_step`
with `distributed.all_sum`). Each step starts from the initial parameters
with a fresh optimizer (the JAX self-check takes the sparse step from where
the dense one left off), so that each step's gradients and parameters can
be held against one process's on their own: after one step of Adam two runs
part by up to 2 lr wherever a gradient is float32 noise, and a second step
from there would inherit that. It prints one ``SELFCHECK {...}`` line whose
losses must be the same on every process and equal one process's run on the
whole global batch.

Launch (one per process):

    python -m basic_pitch_torch.parallel.selfcheck \\
        --process-id k --num-processes n --port 8476 --global-batch 8 [--device cpu|cuda]

Several processes may share one card with ``--backend gloo`` (NCCL refuses
two ranks on one GPU), which is how a one-card machine runs the path.

`dryrun(n_devices, n_processes)` is the counterpart of
`__graft_entry__.dryrun_multichip`: a data-parallel step in
``n_processes`` processes that must agree, then `transcribe_batch` of an
int16 recording over a list of ``n_devices`` devices that must give the
events of one device at the shards' model batch exactly, each shard
uploading at most 1/N of the single device's raw bytes plus the halo of
each chunk. ``python -m
basic_pitch_torch.parallel.selfcheck --dryrun 8 --num-processes 2`` runs it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from basic_pitch_torch import constants

REPO = pathlib.Path(__file__).resolve().parent.parent.parent


def synthetic_global_batch(global_batch: int, seed: int = 0) -> dict:
    """Seeded dense training batch, the same on every process (the JAX
    self-check's, draw for draw)."""
    rng = np.random.RandomState(seed)
    frames = constants.ANNOT_N_FRAMES
    return {
        "audio": (rng.randn(global_batch, constants.AUDIO_N_SAMPLES) * 0.1).astype(np.float32),
        "targets": {
            "contour": rng.rand(global_batch, frames, 264).astype(np.float32),
            "note": rng.rand(global_batch, frames, 88).astype(np.float32),
            "onset": (rng.rand(global_batch, frames, 88) > 0.95).astype(np.float32),
        },
        "weights": {k: np.ones(global_batch, np.float32) for k in ("contour", "note", "onset")},
    }


def synthetic_sparse_items(global_batch: int, seed: int = 1) -> list:
    """Loader-shaped items for the device-rasterized (sparse COO) batch (the
    JAX self-check's, draw for draw)."""
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(global_batch):
        pcm = rng.randint(-32768, 32768, constants.AUDIO_N_SAMPLES)
        targets = {}
        for head, bins in (("onset", 88), ("note", 88), ("contour", 264)):
            m = np.zeros((constants.ANNOT_N_FRAMES, bins), np.float32)
            t = rng.randint(0, constants.ANNOT_N_FRAMES, 50)
            f = rng.randint(0, bins, 50)
            m[t, f] = rng.rand(50).astype(np.float32)
            targets[head] = m
        items.append(
            {
                "audio": (pcm.astype(np.float32) / 32768.0).astype(np.float32),
                "targets": targets,
                "weights": {k: 1.0 for k in ("onset", "note", "contour")},
            }
        )
    return items


def run(
    process_id: int,
    num_processes: int,
    port: int,
    global_batch: int,
    device: str = "cpu",
    backend: Optional[str] = None,
    init: Optional[str] = None,
    dump: Optional[str] = None,
    time_steps: int = 0,
) -> dict:
    """One process's self-check; returns its result dict. ``init`` is a
    flat ``.npz`` that each step starts from (else the reference's
    initialization from seed 0); ``dump`` writes the parameters after each
    step, and the gradients (summed over processes) it took, there (process
    0 only; "dense/<name>", "dense/grad/<name>", "sparse/..."); ``time_steps``
    more dense steps are timed after the checks."""
    from basic_pitch_torch.data import loader as data_loader
    from basic_pitch_torch.device import resolve_device
    from basic_pitch_torch.models import nmp
    from basic_pitch_torch.models import params as params_io
    from basic_pitch_torch.parallel import distributed as dist
    from basic_pitch_torch.train import loop as train_loop

    dev = resolve_device(device)
    dist.initialize(f"127.0.0.1:{port}", num_processes, process_id, backend=backend, device=dev)
    try:
        if dist.process_count() != num_processes:
            raise RuntimeError(f"process group has {dist.process_count()} processes, expected {num_processes}")
        config = train_loop.TrainConfig()
        all_sum = dist.all_sum if dist.spans_processes() else None
        snapshots: Dict[str, np.ndarray] = {}

        def fresh() -> "tuple[nmp.NMP, torch.optim.Optimizer]":
            if init is None:
                model = nmp.init_params(nmp.NMP(), torch.Generator().manual_seed(0))
            else:
                model = params_io.model_from_flat(params_io.load_flat(init))
            dist.replicate(model.to(dev))
            return model, train_loop.make_optimizer(model, config)

        def step(batch: dict, name: str) -> float:
            model, optimizer = fresh()
            metrics = train_loop.train_step(model, optimizer, train_loop.upload_batch(batch, dev)[0], config, all_sum)
            grads = dict(model.state_dict())
            grads.update((k, p.grad) for k, p in model.named_parameters() if p.grad is not None)
            for key, value in params_io.to_jax_params(model.state_dict()).items():
                snapshots[f"{name}/{key}"] = value
            for key, value in params_io.to_jax_params(grads).items():
                if not key.endswith(("/mean", "/var")):  # the moving statistics have no gradient
                    snapshots[f"{name}/grad/{key}"] = value
            return float(metrics["loss"])

        # every process makes the same global batch and takes its slice
        dense = dist.local_slice(synthetic_global_batch(global_batch))
        loss_dense = step(dense, "dense")
        # device-rasterized sparse batch of this process's items
        items = synthetic_sparse_items(global_batch)
        per = dist.local_batch_size(global_batch)
        loss_sparse = step(data_loader._collate_device(items[process_id * per : (process_id + 1) * per]), "sparse")
        if dump is not None and dist.process_index() == 0:
            np.savez(dump, **snapshots)

        step_ms = None
        if time_steps > 0:
            model, optimizer = fresh()
            batch = train_loop.upload_batch(dense, dev)[0]
            times = []
            for _ in range(time_steps):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                float(train_loop.train_step(model, optimizer, batch, config, all_sum)["loss"])
                times.append((time.perf_counter() - t0) * 1e3)
            step_ms = float(np.median(times))
        return {
            "process_id": process_id,
            "process_count": dist.process_count(),
            "global_batch": global_batch,
            "loss_dense": loss_dense,
            "loss_sparse": loss_sparse,
            "platform": dev.type,
            "device": str(dev),
            "backend": dist.tdist.get_backend() if dist.spans_processes() else None,
            "step_ms": step_ms,
        }
    finally:
        dist.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    num_processes: int,
    global_batch: int,
    device: str = "cpu",
    backend: Optional[str] = None,
    timeout: float = 120.0,
    extra: Sequence[str] = (),
    env: Optional[Dict[str, str]] = None,
) -> List[dict]:
    """Run ``num_processes`` self-check processes on a free port and return
    their results in process order. A process that fails, prints no result
    or outlives ``timeout`` seconds fails the launch, and every process is
    stopped before this returns."""
    port = free_port()
    cmd = [sys.executable, "-m", "basic_pitch_torch.parallel.selfcheck", "--num-processes", str(num_processes),
           "--port", str(port), "--global-batch", str(global_batch), "--device", device, *extra]
    if backend is not None:
        cmd += ["--backend", backend]
    procs = [
        subprocess.Popen(cmd + ["--process-id", str(k)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for k in range(num_processes)
    ]
    outputs = []
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outputs.append(out)
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"self-check processes did not finish within {timeout} s") from exc
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for proc, out in zip(procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"self-check process failed (rc {proc.returncode}):\n{out[-4000:]}")
        line = next((ln for ln in out.splitlines() if ln.startswith("SELFCHECK ")), None)
        if line is None:
            raise RuntimeError(f"no SELFCHECK line in the output:\n{out[-4000:]}")
        results.append(json.loads(line[len("SELFCHECK ") :]))
    return results


def dryrun(n_devices: int, n_processes: int = 1, device: str = "cpu", timeout: float = 300.0) -> dict:
    """The parallel path end to end (see the module docstring): raises on
    any disagreement, returns a summary. ``device`` "cpu" runs over
    ``["cpu"] * n_devices``; "cuda" over the visible cards in turn."""
    from basic_pitch_torch import pipeline

    if n_devices % n_processes:
        raise ValueError(f"{n_devices} devices do not divide into {n_processes} processes")
    results = launch(n_processes, n_devices, device, "gloo" if device == "cuda" and n_processes > 1 else None,
                     timeout=timeout)
    losses = {(r["loss_dense"], r["loss_sparse"]) for r in results}
    if len(losses) != 1 or not all(np.isfinite(v) for v in next(iter(losses))):
        raise AssertionError(f"processes disagree or diverged: {results}")

    if device == "cuda":
        devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(n_devices)]
    else:
        devices = ["cpu"] * n_devices
    # an int16 recording, so every shard row also goes through the codec
    rng = np.random.RandomState(0)
    audio_f = (rng.randn(6 * constants.AUDIO_N_SAMPLES) * 0.1).astype(np.float32)
    audio = (np.clip(audio_f, -1, 1) * 32767).astype(np.int16)
    sr = constants.AUDIO_SAMPLE_RATE
    sharded = pipeline.StreamingTranscriber(windows_per_chunk=n_devices, devices=devices, pcm_transport="codec")
    # one device at the shards' model batch (one window) runs every window
    # through the same kernels: the events must be equal, on any device
    single = pipeline.StreamingTranscriber(windows_per_chunk=1, device=devices[0], pcm_transport="codec")
    (ev_rows,) = sharded.transcribe_batch([(audio, sr)])
    (ev_single,) = single.transcribe_batch([(audio, sr)])
    if ev_rows != ev_single:
        raise AssertionError(f"sharded inference diverged: {len(ev_rows)} vs {len(ev_single)} events")
    # each shard received only its own windows: 1/N of the single device's
    # raw bytes plus the overlap halo of each chunk (the codec only shrinks
    # it); rows of one window each, so a row past the needed windows gets none
    per_shard = sharded.piece_upload_bytes
    n_chunks = sharded._geometry(audio, sr)[2]
    total_single = n_chunks * sharded.chunk_len * audio.itemsize
    bound = total_single / n_devices + n_chunks * pipeline.OVERLAP * audio.itemsize
    rows = min(n_devices, pipeline._needed_windows(len(audio), False))
    if len(per_shard) != rows or max(per_shard.values()) > bound:
        raise AssertionError(f"per-shard uploads {per_shard} exceed {bound:.0f} B (single device {total_single} B)")
    post = sharded.posteriorgrams(audio_f, sr)
    if not all(np.isfinite(v).all() for v in post.values()):
        raise AssertionError("non-finite posteriorgrams")
    summary = {
        "n_devices": n_devices,
        "n_processes": n_processes,
        "loss_dense": results[0]["loss_dense"],
        "loss_sparse": results[0]["loss_sparse"],
        "events": len(ev_rows),
        "max_shard_upload_bytes": max(per_shard.values()),
        "single_upload_bytes": total_single,
    }
    print(f"dryrun({n_devices}, n_processes={n_processes}): ok {json.dumps(summary)}")
    return summary


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--port", type=int, default=0, help="the coordinator's port on 127.0.0.1")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: NCCL on cuda, gloo on cpu")
    ap.add_argument("--init", default=None, help="flat .npz parameters to start from")
    ap.add_argument("--dump", default=None, help="write the parameters after each step here (.npz)")
    ap.add_argument("--time-steps", type=int, default=0, help="dense steps to time after the checks")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N_DEVICES",
                    help="run the dry run over N_DEVICES devices with --num-processes processes instead")
    ns = ap.parse_args(argv)
    if ns.dryrun is not None:
        dryrun(ns.dryrun, ns.num_processes, ns.device)
        return 0
    if ns.port == 0 and ns.num_processes > 1:
        ap.error("--port is required with --num-processes > 1")
    result = run(ns.process_id, ns.num_processes, ns.port, ns.global_batch, ns.device, ns.backend, ns.init,
                 ns.dump, ns.time_steps)
    print("SELFCHECK " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
