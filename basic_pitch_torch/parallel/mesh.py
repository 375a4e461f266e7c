"""Device lists for window-parallel inference.

PyTorch counterpart of `basic_pitch_tpu/parallel/mesh.py`. The model is
under 1M parameters, so the parallel axes that pay are data parallelism
(training batches, `parallel/distributed.py`) and window parallelism
(inference: `pipeline.StreamingTranscriber(devices=...)` splits each step's
windows into rows, one per device). Parameters are replicated.

A "mesh" here is an explicit, ordered list of `torch.device`s: entry r holds
shard r. A device may repeat (``["cuda:0", "cuda:0"]``, or ``["cpu"] * 8``),
which runs the sharded path on fewer cards than shards. JAX's
`NamedSharding` and `PartitionSpec` have no counterpart: placement is the
list's order.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, TypeVar

import numpy as np
import torch

from basic_pitch_torch.device import resolve_device

T = TypeVar("T", torch.Tensor, torch.nn.Module)


def make_mesh(devices: "Optional[Sequence[str | torch.device]]" = None) -> List[torch.device]:
    """The ordered device list: every visible CUDA device by default, which
    raises when there is none; the CPU only when named (``["cpu"] * n``).
    A CUDA device named without a GPU raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; name the devices (e.g. ['cpu'] * 8) to run on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """The devices of a mesh without repeats, in first-seen order."""
    return list(dict.fromkeys(devices))


def map_batch(tree: Any, fn: Any) -> Any:
    """``fn`` over every array of a (nested dict) batch; a sparse head's
    "cap", an int, stays as it is."""
    if isinstance(tree, dict):
        return {k: (v if k == "cap" else map_batch(v, fn)) for k, v in tree.items()}
    return fn(tree)


def shard_batch(devices: Sequence[torch.device], tree: Any) -> List[Any]:
    """Split every leaf's leading (batch or window) axis into len(devices)
    equal parts: part r of each leaf (numpy or torch) goes to devices[r] as a
    tensor. Raises when an axis does not divide."""
    n = len(devices)

    def parts(x: Any) -> List[torch.Tensor]:
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if t.shape[0] % n:
            raise ValueError(f"leading axis {t.shape[0]} does not divide across {n} devices")
        return list(t.chunk(n))

    split = map_batch(tree, parts)
    return [map_batch(split, lambda p, r=r: p[r].to(dev)) for r, dev in enumerate(devices)]


def replicate(devices: Sequence[torch.device], obj: T) -> List[T]:
    """One copy of a module or tensor per entry of ``devices``; entries that
    name the same device share one copy, and a copy on ``obj``'s own device
    is ``obj`` itself."""
    copies: Dict[torch.device, T] = {}
    for dev in distinct(devices):
        if isinstance(obj, torch.nn.Module):
            own = next(obj.parameters()).device
            copies[dev] = obj if own == dev else copy.deepcopy(obj).to(dev)
        else:
            copies[dev] = obj.to(dev)
    return [copies[dev] for dev in devices]
