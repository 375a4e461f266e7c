"""Multi-process data parallelism on `torch.distributed`.

PyTorch counterpart of `basic_pitch_tpu/parallel/distributed.py`: the
process group, the host-local batch slices and the replication of the
model. The PyTorch idiom is one process per device, so there is no
``--devices-per-process``: each process trains on its own device, NCCL
joins CUDA processes and gloo CPU ones.

One step of `train/loop.train_step` over N processes equals one process
stepping on the global batch (the concatenation of every process's slice in
process order). Each process's loss is its share of the global loss (the
shares sum to it), the batch norms normalise with statistics summed over
every process (`all_sum`, differentiable), and the gradients are summed.
The global batch is never gathered: each process uploads its own slice to
its own device (`train/loop.upload_batch`), and the sums stand for the rest.

Launch pattern (one process per device):

    from basic_pitch_torch.parallel import distributed as dist
    dist.initialize("10.0.0.1:8476", num_processes=4, process_id=k, device="cuda:0")
    local = next(loader)                # this process's slice of the batch
    batch, _ = train_loop.upload_batch(local, device)
    metrics = train_loop.train_step(model, optimizer, batch, config, all_sum=dist.all_sum)

`python -m basic_pitch_torch.parallel.selfcheck` checks the path in N real
processes.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as tdist

from basic_pitch_torch.device import resolve_device
from basic_pitch_torch.parallel import mesh

# a rank that waits on a peer longer than this fails instead of hanging
TIMEOUT_S = 300.0


def _init_method(coordinator_address: Optional[str]) -> str:
    """JAX's "host:port" as a TCP rendezvous; None or "" means the
    environment (``MASTER_ADDR`` / ``MASTER_PORT``, as torchrun sets them)."""
    if not coordinator_address:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            raise ValueError(
                "multi-process training needs a coordinator address host:port "
                "(or MASTER_ADDR and MASTER_PORT in the environment)"
            )
        return "env://"
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: "str | torch.device | None" = None,
) -> None:
    """Join (or, as process 0, start) the process group.

    ``num_processes`` of None or <= 1 is a no-op, so single-process code
    needs no special case. ``backend`` None picks NCCL when this process's
    ``device`` is a CUDA device (None means the GPU, `resolve_device`) and
    gloo on the CPU. A second call in a process that already joined is a
    no-op."""
    if num_processes is None or int(num_processes) <= 1 or tdist.is_initialized():
        return
    if process_id is None or not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id must lie in [0, {num_processes}), got {process_id}")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    tdist.init_process_group(
        backend,
        init_method=_init_method(coordinator_address),
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )


def shutdown() -> None:
    """Leave the process group. Nothing of the port holds the group past
    this (see `_AllSum`), so its threads (gloo's loops, process 0's TCPStore
    server) end here and not while the interpreter exits."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def spans_processes() -> bool:
    """Does this process train together with others?"""
    return process_count() > 1


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of a global batch (which must divide evenly)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not divide across {n} processes")
    return global_batch_size // n


def local_slice(tree: Any, global_batch_size: Optional[int] = None) -> Any:
    """This process's rows of a host-global batch (for tools and tests that
    make the whole batch everywhere; the loader's ``num_shards`` /
    ``shard_index`` give real runs their slices directly)."""

    def slc(x: Any) -> np.ndarray:
        x = np.asarray(x)
        per = local_batch_size(x.shape[0] if global_batch_size is None else global_batch_size)
        start = process_index() * per
        return x[start : start + per]

    return mesh.map_batch(tree, slc)


class _AllSum(torch.autograd.Function):
    """all_reduce(SUM) over the default process group, with the same sum as
    its backward. The group is looked up when the collective runs and never
    stored, so nothing keeps it past `shutdown`.

    `torch.distributed.nn.functional` binds ``group.WORLD`` as a default
    argument of ten functions when it is first imported: imported after the
    group exists, it keeps the group alive after `destroy_process_group`,
    with its gloo threads and (in process 0) the TCPStore server, until the
    interpreter tears them down at exit, where the process can abort
    ("terminate called without an active exception"). Its successor,
    `torch.distributed._functional_collectives.all_reduce`, also keeps the
    group alive after `destroy_process_group`."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor) -> torch.Tensor:
        y = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(y, op=tdist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> torch.Tensor:
        return _AllSum.apply(grad)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every process, differentiable: its backward
    sums the incoming gradients over every process in turn, which is the
    gradient of a loss that is the sum of the processes' shares."""
    return _AllSum.apply(x)


def replicate(obj: Any, src: int = 0) -> Any:
    """Make every process hold process ``src``'s values: a module's
    parameters and buffers, or a tensor, broadcast in place (and returned).
    A no-op in a single process."""
    if not spans_processes():
        return obj
    tensors = list(obj.parameters()) + list(obj.buffers()) if isinstance(obj, torch.nn.Module) else [obj]
    with torch.no_grad():
        for t in tensors:
            tdist.broadcast(t.data, src)
    return obj


def broadcast_value(value: float, device: "str | torch.device", src: int = 0) -> float:
    """Process ``src``'s value of a Python float on every process (a
    validation loss, so that the LR schedule and early stopping decide
    alike everywhere)."""
    if not spans_processes():
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    tdist.broadcast(t, src)
    return float(t.item())
