"""One process of a small two-process case for `tests/test_torch_distributed.py`
(gloo on the CPU). Not a test module: pytest collects nothing here.

    python tests/torch_dist_worker.py CASE RANK WORLD PORT OUT.npz

Every process makes the same seeded global batch, takes its slice
(`distributed.local_slice`), runs the case with `distributed.all_sum` and
writes what it computed to OUT.npz for the test to compare with one
process on the whole batch (`global_inputs` gives that batch), and what of
the process group outlived `distributed.shutdown`.
"""

import os
import pathlib
import sys
import weakref

import numpy as np
import torch
import torch.distributed

from basic_pitch_torch.models import nmp
from basic_pitch_torch.parallel import distributed as dist
from basic_pitch_torch.train import losses

GLOBAL_BATCH = 4


def global_inputs(case: str) -> dict:
    """The case's seeded global batch as numpy arrays."""
    rng = np.random.RandomState(11)
    if case == "bn":
        return {
            "x": (rng.randn(GLOBAL_BATCH, 3, 5, 7) * 2 + 0.5).astype(np.float32),
            "upstream": rng.randn(GLOBAL_BATCH, 3, 5, 7).astype(np.float32),
            "gamma": rng.rand(3).astype(np.float32) + 0.5,
            "beta": rng.randn(3).astype(np.float32),
        }
    # onset targets with many positives in the first half of the batch and
    # few in the second, so the two processes' pooled counts differ
    onset = np.zeros((GLOBAL_BATCH, 172, 88), np.float32)
    onset[: GLOBAL_BATCH // 2] = rng.rand(GLOBAL_BATCH // 2, 172, 88) > 0.7
    onset[GLOBAL_BATCH // 2 :] = rng.rand(GLOBAL_BATCH // 2, 172, 88) > 0.995
    return {
        "pred_onset": rng.rand(GLOBAL_BATCH, 172, 88).astype(np.float32),
        "pred_note": rng.rand(GLOBAL_BATCH, 172, 88).astype(np.float32),
        "pred_contour": rng.rand(GLOBAL_BATCH, 172, 264).astype(np.float32),
        "onset": onset,
        "note": (rng.rand(GLOBAL_BATCH, 172, 88) > 0.9).astype(np.float32),
        "contour": (rng.rand(GLOBAL_BATCH, 172, 264) > 0.9).astype(np.float32),
        "w_onset": np.array([1.0, 0.5, 0.0, 1.0], np.float32),
        "w_note": np.array([1.0, 1.0, 0.25, 1.0], np.float32),
        "w_contour": np.array([0.0, 1.0, 1.0, 1.0], np.float32),
    }


def bn_case(all_sum=None) -> dict:
    """Train-mode `nmp.BatchNorm` on this process's slice (the whole batch
    without ``all_sum``): outputs, statistics and gradients, the gradients
    of gamma and beta summed over processes."""
    inputs = global_inputs("bn")
    local = dist.local_slice({k: inputs[k] for k in ("x", "upstream")}) if all_sum else inputs
    bn = nmp.BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["gamma"]))
        bn.bias.copy_(torch.from_numpy(inputs["beta"]))
    x = torch.from_numpy(np.ascontiguousarray(local["x"])).requires_grad_(True)
    y, (mean, var) = bn(x, True, all_sum)
    (y * torch.from_numpy(np.ascontiguousarray(local["upstream"]))).sum().backward()
    gw, gb = bn.weight.grad, bn.bias.grad
    if all_sum is not None:
        gw, gb = all_sum(gw), all_sum(gb)
    return {"y": y.detach().numpy(), "mean": mean.numpy(), "var": var.numpy(), "x_grad": x.grad.numpy(),
            "gamma_grad": gw.numpy(), "beta_grad": gb.numpy()}


def onset_case(all_sum=None) -> dict:
    """`losses.total_loss` with the class-balanced onset loss on this
    process's slice: its share, the global losses and the gradient of the
    share with respect to this slice's predictions."""
    inputs = global_inputs("onset")
    local = dist.local_slice(inputs) if all_sum else inputs
    preds = {h: torch.from_numpy(np.ascontiguousarray(local[f"pred_{h}"])).requires_grad_(True)
             for h in ("onset", "note", "contour")}
    targets = {h: torch.from_numpy(np.ascontiguousarray(local[h])) for h in ("onset", "note", "contour")}
    weights = {h: torch.from_numpy(np.ascontiguousarray(local[f"w_{h}"])) for h in ("onset", "note", "contour")}
    total, per_head = losses.total_loss(preds, targets, weights, weighted_onset=True, all_sum=all_sum)
    total.backward()
    values = torch.stack([total.detach(), *(v.detach() for v in per_head.values())])
    out = {"share": values.numpy().copy(), "global": (all_sum(values) if all_sum else values).numpy()}
    out.update({f"grad_{h}": p.grad.numpy() for h, p in preds.items()})
    return out


def c10d_threads() -> list:
    """This process's threads that belong to a process group: gloo's loops
    and the TCPStore server (Linux thread names)."""
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            names.append(pathlib.Path(f"/proc/self/task/{tid}/comm").read_text().strip())
        except FileNotFoundError:  # the thread ended meanwhile
            pass
    return sorted(n for n in names if "gloo" in n or "tcpstore" in n)


def main() -> None:
    case, rank, world, port, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    torch.set_num_threads(1)
    dist.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    group = weakref.ref(torch.distributed.group.WORLD)
    try:
        result = (bn_case if case == "bn" else onset_case)(dist.all_sum)
        threads_in_group = c10d_threads()
    finally:
        dist.shutdown()
    # what outlives the group: nothing, when shutdown released it
    result.update(group_released=np.array(group() is None), threads_in_group=np.array(threads_in_group),
                  threads_after=np.array(c10d_threads(), dtype=str))
    np.savez(out, **result)


if __name__ == "__main__":
    main()
