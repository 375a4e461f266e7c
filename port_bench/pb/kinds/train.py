"""Training: the inner loop of the port's `train.loop.fit` (`upload_batch`
then `train_step`, with nothing waiting between steps) on a pool of host
batches in the loader's device-targets layout.

Set-up makes the initial weights from the seed on the card (one uniform
draw for every conv kernel, scaled per kernel to the reference's
VarianceScaling(2, fan_avg, uniform) limit; zero biases; identity batch
norm), hands them to the program's `NMP`, builds its Adam, and drives
that one object through its first steps with the window's own call and
feed: the first ``check_steps`` are the ones the check follows, the rest
of ``setup_steps`` warm up. The window then steps on, cycling the pool,
for ``seconds``, and synchronises once at its end.

The check follows the first ``check_steps`` steps with the float64
reference from the same initial weights and batches, and compares each
step's loss, the first gradient (worked out from Adam's first moment
after one step: exp_avg = (1 - beta1) g) and the change of every leaf
over the steps, each as the worst leaf's gap of norms. Leaves whose
reference gradient is under a thousandth of the median leaf's (a bias in
front of a batch norm) are left out of the change: Adam moves them by
round-off alone.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np

from pb import bench, check, traffic
from pb import trace as tracing
from reference import train as ref_train

SHAPES = {
    "contour_conv": (3, 39, 8, 8),
    "contour_out": (5, 5, 8, 1),
    "note_conv": (7, 7, 1, 32),
    "note_out": (7, 3, 32, 1),
    "onset_conv": (5, 5, 8, 32),
    "onset_out": (3, 3, 33, 1),
}
BN_WIDTHS = {"bn_cqt": 1, "bn_contour": 8, "bn_onset": 32}
BN_TORCH = {"gamma": "weight", "beta": "bias", "mean": "running_mean", "var": "running_var"}


def initial_weights(seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Flat HWIO weights from the seed, made on ``device`` in one draw."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    sizes = [math.prod(s) for s in SHAPES.values()]
    draw = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out = {}
    for (name, shape), part in zip(SHAPES.items(), torch.split(draw, sizes)):
        kh, kw, cin, cout = shape
        limit = math.sqrt(6.0 / ((cin * kh * kw + cout * kh * kw) / 2.0))
        out[f"{name}/w"] = (part * limit).reshape(shape)
        out[f"{name}/b"] = torch.zeros(cout, device=device)
    for name, width in BN_WIDTHS.items():
        out[f"{name}/gamma"] = torch.ones(width, device=device)
        out[f"{name}/beta"] = torch.zeros(width, device=device)
        out[f"{name}/mean"] = torch.zeros(width, device=device)
        out[f"{name}/var"] = torch.ones(width, device=device)
    return out


def _torch_key(flat_key: str) -> str:
    name, field = flat_key.split("/")
    if name in SHAPES:
        return f"{name}.{'weight' if field == 'w' else 'bias'}"
    return f"{name}.{BN_TORCH[field]}"


def load_into(model, flat: Dict) -> None:
    import torch

    state = model.state_dict()
    with torch.no_grad():
        for key, value in flat.items():
            tk = _torch_key(key)
            state[tk].copy_(value.permute(3, 2, 0, 1) if value.ndim == 4 else value)


def read_flat(model) -> Dict[str, np.ndarray]:
    state = model.state_dict()
    out = {}
    for name, shape in SHAPES.items():
        out[f"{name}/w"] = state[f"{name}.weight"].permute(2, 3, 1, 0).double().cpu().numpy()
        out[f"{name}/b"] = state[f"{name}.bias"].double().cpu().numpy()
    for name in BN_WIDTHS:
        for field, tf in BN_TORCH.items():
            out[f"{name}/{field}"] = state[f"{name}.{tf}"].double().cpu().numpy()
    return out


def first_gradients(model, optimizer) -> Dict[str, np.ndarray]:
    """The first step's gradient per leaf from Adam's first moment."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for p, state in optimizer.state.items():
        name, field = names[id(p)].split(".")
        flat = f"{name}/" + ({"weight": "w", "bias": "b"}[field] if name in SHAPES else {"weight": "gamma", "bias": "beta"}[field])
        g = state["exp_avg"] / (1.0 - beta1)
        out[flat] = (g.permute(2, 3, 1, 0) if g.ndim == 4 else g).double().cpu().numpy()
    return out


class Program:
    """The port's model, optimizer and step, as `fit` drives them."""

    def __init__(self, config: Dict, init: Dict, device):
        from basic_pitch_torch.models import nmp
        from basic_pitch_torch.train import loop

        self.loop = loop
        self.device = device
        self.model = nmp.NMP(nmp.ModelConfig(**config["model_config"])).to(device)
        load_into(self.model, init)
        self.config = loop.TrainConfig(precision=config["train"]["precision"], learning_rate=config["train"]["learning_rate"])
        self.optimizer = loop.make_optimizer(self.model, self.config)

    def step(self, host_batch: Dict):
        with tracing.span("bench.upload_batch"):
            batch, _ = self.loop.upload_batch(host_batch, self.device)
        with tracing.span("bench.train_step"):
            return self.loop.train_step(self.model, self.optimizer, batch, self.config)


class Control:
    """The reference in TF32 in the program's place."""

    def __init__(self, init: Dict, device):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        self.trainer = ref_train.Trainer(init, device, torch.float32)
        self.first = None

    def step(self, host_batch: Dict):
        value, grads = self.trainer.step(host_batch)
        if self.first is None:
            self.first = {k: g.double().cpu().numpy() for k, g in grads.items()}
        return {"loss": value}


def run(ctx: "bench.Context") -> "bench.Outcome":
    import torch

    spec, config = ctx.cell.traffic, ctx.cell.config
    device = ctx.device
    batch = int(config["train"]["batch_size"])
    pool = traffic.train_batches(ctx.seed, spec, batch)
    n_check, n_setup = int(spec["check_steps"]), int(spec["setup_steps"])
    init = initial_weights(ctx.seed, device)
    program = Control(init, device) if ctx.control else Program(config, init, device)
    losses, first = [], None
    for i in range(n_check):
        metrics = program.step(pool[i])
        losses.append(metrics["loss"])
        if i == 0 and not ctx.control:
            first = first_gradients(program.model, program.optimizer)
    after = read_flat(program.model) if not ctx.control else {k: v.double().cpu().numpy() for k, v in program.trainer.params.items()}
    losses = [float(v) for v in losses]
    if ctx.control:
        first = program.first
    steps = n_check
    units = []
    tracer = tracing.Tracer(ctx.trace and not ctx.control, device)
    if not ctx.control:
        for i in range(n_check, n_setup):
            program.step(pool[i % len(pool)])
        steps = n_setup
        tracing.sync(device)
        setup_s = time.monotonic() - ctx.t_start
        ctx.log(f"set-up {setup_s:.3f} s; {n_setup} steps, pool {len(pool)} batches of {batch}")

        def loop(seconds: float, traced: bool) -> None:
            nonlocal steps
            t0 = time.monotonic()
            n = 0
            while time.monotonic() - t0 < seconds:
                program.step(pool[steps % len(pool)])
                steps += 1
                n += 1
            tracing.sync(device)
            units.append({"steps": n, "wall_s": time.monotonic() - t0, "traced": traced})

        loop(ctx.seconds, False)
        if tracer.enabled:
            with tracer.span():
                loop(bench.TRACE_SECONDS, True)
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    else:
        setup_s, memory_peak = 0.0, 0
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = compare(ctx, init, pool[:n_check], losses, first, after)
    window = [u for u in units if not u["traced"]] or [{"steps": 0, "wall_s": 1.0}]
    stats = {
        "kind": "train",
        "setup_s": setup_s,
        "windows": window[0]["steps"] * batch,
        "window_s": window[0]["wall_s"],
    }
    return bench.Outcome(
        attempted=window[0]["steps"], failed=0, stats=stats, numbers=numbers,
        memory_peak_bytes=memory_peak, trace=tracer.summary,
    )


def compare(ctx, init, batches: List[Dict], losses: List[float], first: Dict, after: Dict) -> Dict[str, float]:
    import torch

    t = time.monotonic()
    ref_losses, ref_first, ref_after = ref_train.follow(init, batches, ctx.device, torch.float64)
    start = {k: v.double().cpu().numpy() for k, v in init.items()}
    norms = {k: float(np.linalg.norm(g)) for k, g in ref_first.items()}
    median = float(np.median(list(norms.values())))
    moving = [k for k in ref_after if not ref_train.trainable(k) or norms[k] >= 1e-3 * median]
    change = {k: after[k] - start[k] for k in moving}
    ref_change = {k: ref_after[k] - start[k] for k in moving}
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": check.norm_gap(first, ref_first),
        "change_gap": check.norm_gap(change, ref_change),
    }
    ctx.log(
        f"check: losses {losses} against {ref_losses}; left out of the change: "
        f"{sorted(set(ref_after) - set(moving))}; took {time.monotonic() - t:.1f} s"
    )
    return numbers


def tiny(cell: "bench.Cell") -> "bench.Cell":
    """The cell cut to a size a CPU test run holds: batch 2, a pool of 4,
    a test run of 1 s. The harness's tests call it; a run on the card
    never does."""
    cell.config["train"]["batch_size"] = 2
    cell.traffic.update(pool=4, test_seconds=1.0)
    return cell
