"""Training loop: the train step on one device or data-parallel over
processes, LR scheduling, early stopping, checkpoints and resume.

PyTorch counterpart of `basic_pitch_tpu/train/loop.py`. The
reference's behaviour (`basic_pitch/train.py:35-168` there) is kept: Adam, per-head smoothed BCE (optionally the class-balanced onset
loss), the unit-norm kernel constraint after each step, batch-norm moving
averages at momentum 0.99 folded in after the step, ReduceLROnPlateau
(factor 0.5, patience 10), EarlyStopping (patience 25), best and per-epoch
checkpoints in the JAX package's flat ``.npz`` layout, plus a resumable
train state (`torch.save`).

A batch is a dict of numpy arrays from `data/loader.py` (dense targets, or
int16 audio with sparse COO targets when the loader runs with
``device_targets``); `pack_batch_audio` (or `packed_batches` around a batch
stream) may replace int16 audio with its lossless codec form and trims the
sparse targets for the wire; `upload_batch` ships it to the device and
`materialize_batch` builds the dense float32 batch there.

Data parallelism (`parallel/distributed.py`, one process per device): each
process steps on its slice of the global batch with ``all_sum``, and the
step equals one process stepping on the whole batch (see `train_step`).
`fit` does so when the process group spans processes; only process 0 then
writes checkpoints, train state and logs.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from basic_pitch_torch import constants
from basic_pitch_torch.models import nmp
from basic_pitch_torch.models import params as params_io
from basic_pitch_torch.train import losses

Batch = Dict[str, Any]  # {"audio": (b, n), "targets": {...}, "weights": {...}}
Metrics = Dict[str, torch.Tensor]

_HEAD_BINS = {
    "onset": constants.N_FREQ_BINS_NOTES,
    "note": constants.N_FREQ_BINS_NOTES,
    "contour": constants.N_FREQ_BINS_CONTOURS,
}
TRAIN_STATE_NAME = "train_state.pt"


def materialize_batch(batch: Batch) -> Batch:
    """Dense float32 batch from a device batch, on its device.

    int16 audio dequantizes by the exact /32768 the WAV decoder used, and
    each head's flat COO (idx = t * bins + f, unique within a window)
    scatters into its dense (b, 172, bins) shape. Padding slots carry the
    sentinel 172 * bins: they scatter into one spare column, which is cut
    off, so the result equals the loader's dense collate bit for bit. Dense
    float32 batches pass through untouched.
    """
    audio = batch["audio"]
    if "targets_sparse" not in batch and audio.dtype != torch.int16:
        return batch
    out = {k: v for k, v in batch.items() if k != "targets_sparse"}
    if audio.dtype == torch.int16:
        out["audio"] = audio.to(torch.float32) / 32768.0
    if "targets_sparse" in batch:
        frames = constants.ANNOT_N_FRAMES
        dense = {}
        for head, sp in batch["targets_sparse"].items():
            cells = frames * _HEAD_BINS[head]
            idx, val = sp["idx"], sp["val"]
            flat = torch.zeros((idx.shape[0], cells + 1), dtype=val.dtype, device=val.device)
            flat.scatter_(1, idx.long(), val)
            dense[head] = flat[:, :cells].reshape(idx.shape[0], frames, _HEAD_BINS[head])
        out["targets"] = dense
    return out


# ---------------------------------------------------------------------------
# batch transport: int16 audio raw or through the PCM codec, sparse targets
# trimmed for the wire
# ---------------------------------------------------------------------------

_WIRE_MIN_BUCKET = 64


def _trim_sparse_for_wire(batch: Batch) -> Batch:
    """Slice each sparse head's (idx, val) to the batch's pow2 nnz bucket
    for the upload; `upload_batch` re-pads on the device to the loader's cap
    (sentinel idx, zero val: dropped slots, so materialization is unchanged
    bit for bit). Without the trim the cap's padding (~54 KB per window
    against ~1-2 KB of real nonzeros) would cross the link."""
    if "targets_sparse" not in batch:
        return batch
    out = dict(batch)
    trimmed = {}
    for head, sp in batch["targets_sparse"].items():
        idx, val = sp["idx"], sp["val"]
        cap = idx.shape[-1]
        sentinel = constants.ANNOT_N_FRAMES * _HEAD_BINS[head]
        nnz_max = int((idx != sentinel).sum(axis=-1).max()) if cap else 0
        bucket = _WIRE_MIN_BUCKET
        while bucket < nnz_max:
            bucket *= 2
        if bucket < cap:
            trimmed[head] = {
                "idx": np.ascontiguousarray(idx[..., :bucket]),
                "val": np.ascontiguousarray(val[..., :bucket]),
                "cap": cap,
            }
        else:
            trimmed[head] = {"idx": idx, "val": val, "cap": cap}
    out["targets_sparse"] = trimmed
    return out


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def pack_batch_audio(batch: Batch, pcm_transport: str = "auto", device: "str | torch.device | None" = None) -> Batch:
    """Host-side wire preparation: trim sparse-target padding off the wire
    and, when the transport is the codec, replace int16 batch audio with its
    packed form ("audio_packed": (PackedPCM, shape)). "auto" decides with
    the serial cost model (the loader's host CPU is busy, so pack time adds
    to the wall: `transport.resolve(serial=True)`, measured towards
    ``device``, "cuda" when None); audio that does not pack smaller stays
    raw. Run it where the loader runs (`packed_batches`)."""
    from basic_pitch_torch.ops import pcmcodec, transport

    batch = _trim_sparse_for_wire(batch)
    audio = batch.get("audio")
    if (
        isinstance(audio, np.ndarray)
        and audio.dtype == np.int16
        and transport.check_mode(pcm_transport) != "raw"
        and (pcm_transport == "codec" or transport.resolve("auto", device=device, serial=True) == "codec")
    ):
        packed = pcmcodec.pack(np.ascontiguousarray(audio).reshape(-1))
        if packed.packed_bytes < audio.nbytes:
            out = {k: v for k, v in batch.items() if k != "audio"}
            out["audio_packed"] = (packed, audio.shape)
            return out
    return batch


def packed_batches(
    batches: Iterator[Batch], pcm_transport: str = "auto", device: "str | torch.device | None" = None
) -> Iterator[Batch]:
    """A batch iterator with `pack_batch_audio` run on a prefetch thread."""
    from basic_pitch_torch.data.loader import _prefetch

    return _prefetch((pack_batch_audio(b, pcm_transport, device) for b in batches), depth=2)


def needs_upload(batch: Batch) -> bool:
    """True when the batch still lies on the host (numpy leaves, or codec
    audio) and must go through `upload_batch` before the step."""
    return "audio_packed" in batch or any(isinstance(leaf, np.ndarray) for leaf in _leaves(batch))


def upload_batch(batch: Batch, device: torch.device) -> Tuple[Batch, int]:
    """Ship one host batch (plain, stacked, wire-trimmed or codec-packed) to
    ``device``; returns the device batch and the bytes that crossed the
    link. Codec audio is reconstructed on the device as the exact float32
    samples the raw path gives (`materialize_batch` passes float32 audio
    through); trimmed sparse targets re-pad on the device to their cap."""
    from basic_pitch_torch.ops import pcmcodec

    nbytes = 0

    def put(x: Any) -> Any:
        nonlocal nbytes
        if not isinstance(x, np.ndarray):
            return x
        nbytes += x.nbytes
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    out: Batch = {}
    for key, value in batch.items():
        if key == "audio_packed":
            packed, shape = value
            nbytes += packed.packed_bytes
            out["audio"] = pcmcodec.decode_to_device(packed, int(np.prod(shape)), device).reshape(shape)
        elif key == "targets_sparse":
            heads = {}
            for head, sp in value.items():
                idx, val = put(sp["idx"]), put(sp["val"])
                extra = sp.get("cap", idx.shape[-1]) - idx.shape[-1]
                if extra > 0:
                    sentinel = constants.ANNOT_N_FRAMES * _HEAD_BINS[head]
                    idx = F.pad(idx, (0, extra), value=sentinel)
                    val = F.pad(val, (0, extra))
                heads[head] = {"idx": idx, "val": val}
            out[key] = heads
        elif isinstance(value, dict):
            out[key] = {k: put(v) for k, v in value.items()}
        else:
            out[key] = put(value)
    return out, nbytes


# ---------------------------------------------------------------------------
# configuration and schedulers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    # numerics of the TRAINING step only (evaluation and inference stay
    # float32): "highest" is float32 with TF32 off, "high" lets cuBLAS and
    # cuDNN use TF32, "default" runs the CQT matmuls and the convs under
    # bf16 autocast with the batch norm and the losses in float32
    precision: str = "highest"
    label_smoothing: float = losses.DEFAULT_LABEL_SMOOTHING
    weighted_onset_loss: bool = False
    positive_onset_weight: float = losses.DEFAULT_POSITIVE_WEIGHT
    bn_momentum: float = nmp.BN_MOMENTUM
    lr_reduction_factor: float = 0.5
    lr_patience: int = 10  # epochs without val improvement before LR cut
    lr_min_delta: float = 1e-4  # Keras ReduceLROnPlateau default
    lr_cooldown: int = 0
    min_lr: float = 0.0
    early_stop_patience: int = 25
    early_stop_min_delta: float = 0.0  # Keras EarlyStopping default
    steps_per_epoch: int = 100
    validation_steps: int = 10
    epochs: int = 500


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Keras-exact plateau LR scheduler (`keras.callbacks.ReduceLROnPlateau`,
    as the reference configures it at `train.py:130`: patience=10,
    factor=0.5, min_delta=1e-4, cooldown=0).

    An epoch improves iff ``current < best - min_delta``. During cooldown
    the wait counter is held at zero. A reduction fires when ``wait``
    reaches ``patience`` outside cooldown; it resets ``wait`` (but NOT
    ``best``) and starts the cooldown.
    """

    factor: float = 0.5
    patience: int = 10
    min_delta: float = 1e-4
    cooldown: int = 0
    min_lr: float = 0.0
    best: float = np.inf
    wait: int = 0
    cooldown_counter: int = 0

    def step(self, current: float, lr: float) -> Tuple[float, bool]:
        """Advance one epoch; returns (new_lr, reduced?)."""
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                self.cooldown_counter = self.cooldown
                self.wait = 0
                if lr > self.min_lr:
                    return max(lr * self.factor, self.min_lr), True
        return lr, False

    def state(self) -> Dict:
        return {"best": float(self.best), "wait": self.wait, "cooldown_counter": self.cooldown_counter}

    def load_state(self, state: Dict) -> None:
        self.best = float(state["best"])
        self.wait = int(state["wait"])
        self.cooldown_counter = int(state["cooldown_counter"])


@dataclasses.dataclass
class EarlyStopping:
    """Keras-exact early stopping (`keras.callbacks.EarlyStopping`, reference
    `train.py:129`: patience=25, min_delta=0). Improvement means
    ``current < best - min_delta``; stop once ``patience`` consecutive
    non-improving epochs have elapsed."""

    patience: int = 25
    min_delta: float = 0.0
    best: float = np.inf
    wait: int = 0

    def step(self, current: float) -> bool:
        """Advance one epoch; returns True when training should stop."""
        self.wait += 1
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        return self.wait >= self.patience

    def state(self) -> Dict:
        return {"best": float(self.best), "wait": self.wait}

    def load_state(self, state: Dict) -> None:
        self.best = float(state["best"])
        self.wait = int(state["wait"])


def make_optimizer(model: nmp.NMP, config: TrainConfig) -> torch.optim.Adam:
    """Adam (beta 0.9 / 0.999, eps 1e-8): optax ``adam``'s update. The LR is
    cut through ``param_groups`` (`set_learning_rate`)."""
    return torch.optim.Adam(model.parameters(), lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

# the model's precision names and scope (`nmp.precision_scope`); the step
# holds the TF32 flags for its forward, backward and update, and the model
# adds bf16 autocast to its forward under "default"
TRAIN_PRECISIONS = nmp.PRECISIONS
precision_scope = nmp.precision_scope


AllSum = Callable[[torch.Tensor], torch.Tensor]


def loss_and_stats(
    model: nmp.NMP, batch: Batch, config: TrainConfig, train: bool = True, all_sum: Optional[AllSum] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, nmp.BatchStats]]:
    """Forward and losses of a materialized device batch: (total, per-head
    losses, batch statistics per BN layer). ``train`` selects train-mode
    batch norm and ``config.precision``; ``train=False`` is eval-mode batch
    norm in float32. With ``all_sum`` (`parallel/distributed.all_sum`) the
    batch is this process's slice: the batch norms take the global
    statistics and the losses are this process's shares of the global
    batch's."""
    # float32 outputs for the losses under every precision
    outputs, stats = model.forward_and_stats(
        batch["audio"], train, precision=config.precision if train else "highest", all_sum=all_sum
    )
    total, per_head = losses.total_loss(
        outputs,
        batch["targets"],
        batch.get("weights"),
        label_smoothing=config.label_smoothing,
        weighted_onset=config.weighted_onset_loss,
        positive_weight=config.positive_onset_weight,
        no_contours=model.config.no_contours,
        all_sum=all_sum,
    )
    return total, per_head, stats


@torch.no_grad()
def update_bn_stats(model: nmp.NMP, batch_stats: Dict[str, nmp.BatchStats], momentum: float) -> None:
    """Fold train-mode batch statistics into the moving averages:
    new = momentum * old + (1 - momentum) * batch (Keras momentum)."""
    for name, stats in batch_stats.items():
        if stats is None:
            continue
        mean, var = stats
        bn = getattr(model, name)
        bn.running_mean.copy_(momentum * bn.running_mean + (1.0 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var + (1.0 - momentum) * var)


def apply_update(
    model: nmp.NMP, optimizer: torch.optim.Optimizer, batch_stats: Dict[str, nmp.BatchStats], config: TrainConfig
) -> None:
    """Everything after the gradients: the Adam step on the ``.grad`` of
    every parameter, the unit-norm constraint, then the BN moving averages
    (the JAX package's order, `train_step_body`)."""
    optimizer.step()
    nmp.apply_unit_norm_constraint(model)
    update_bn_stats(model, batch_stats, config.bn_momentum)


def _metrics(total: torch.Tensor, per_head: Dict[str, torch.Tensor], all_sum: Optional[AllSum] = None) -> Metrics:
    """The step's losses; with ``all_sum`` the processes' shares are summed
    (one collective) into the global batch's losses, equal everywhere."""
    values = [total.detach(), *(v.detach() for v in per_head.values())]
    if all_sum is not None:
        values = list(all_sum(torch.stack(values)).unbind())
    return {"loss": values[0], **{f"loss_{k}": v for k, v in zip(per_head, values[1:])}}


@torch.no_grad()
def sum_gradients(model: nmp.NMP, all_sum: AllSum) -> None:
    """Replace every parameter's gradient with its sum over processes (one
    collective over the gradients laid end to end)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    summed = all_sum(torch.cat([g.reshape(-1) for g in grads]))
    for g, s in zip(grads, summed.split([g.numel() for g in grads])):
        g.copy_(s.view_as(g))


def train_step(
    model: nmp.NMP, optimizer: torch.optim.Optimizer, batch: Batch, config: TrainConfig, all_sum: Optional[AllSum] = None
) -> Metrics:
    """One optimizer step on a device batch: materialize, train-mode forward,
    losses, backward, Adam, unit-norm constraint, BN moving averages.
    Returns the step's losses as 0-d device tensors (nothing waits for the
    device).

    With ``all_sum`` (a differentiable sum over processes) ``batch`` is this
    process's slice of the global batch, and the step equals one process
    stepping on the whole batch: the batch norms normalise with the global
    statistics (and fold those into the moving averages), each process's
    loss is its share of the global loss (the shares sum to it), the
    backward through ``all_sum`` carries every process's part of the
    statistics' gradient, and the gradients are then summed over processes,
    not averaged: the sum of the shares' gradients is the global loss's
    gradient. Every process then applies the same update."""
    batch = materialize_batch(batch)
    with precision_scope(config.precision):
        optimizer.zero_grad(set_to_none=True)
        total, per_head, stats = loss_and_stats(model, batch, config, all_sum=all_sum)
        total.backward()
        if all_sum is not None:
            sum_gradients(model, all_sum)
        apply_update(model, optimizer, stats, config)
    return _metrics(total, per_head, all_sum)


@torch.no_grad()
def eval_step(model: nmp.NMP, batch: Batch, config: TrainConfig, all_sum: Optional[AllSum] = None) -> Metrics:
    """Validation losses of a device batch: eval-mode batch norm, float32.
    With ``all_sum``, of the global batch whose slice ``batch`` is."""
    batch = materialize_batch(batch)
    with precision_scope("highest"):
        total, per_head, _ = loss_and_stats(model, batch, config, train=False, all_sum=all_sum)
    return _metrics(total, per_head, all_sum)


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """Stack k host batches leaf-wise on a NEW leading axis, for
    `multi_step`. Sparse heads wire-trimmed to different pow2 buckets are
    re-padded to the group's largest (sentinel rows are dropped at
    materialization, so nothing changes). Audio must still be raw: stack,
    then `pack_batch_audio`."""
    if any("audio_packed" in b for b in batches):
        raise ValueError("stack before pack_batch_audio, not after")
    first = batches[0]
    out: Batch = {"audio": np.stack([b["audio"] for b in batches])}
    if "targets" in first:
        out["targets"] = {k: np.stack([b["targets"][k] for b in batches]) for k in first["targets"]}
    if "targets_sparse" in first:
        heads = {}
        for head in first["targets_sparse"]:
            sps = [b["targets_sparse"][head] for b in batches]
            bucket = max(sp["idx"].shape[-1] for sp in sps)
            cap = max(sp.get("cap", sp["idx"].shape[-1]) for sp in sps)
            sentinel = constants.ANNOT_N_FRAMES * _HEAD_BINS[head]
            idx = np.stack([
                np.pad(sp["idx"], ((0, 0), (0, bucket - sp["idx"].shape[-1])), constant_values=sentinel)
                for sp in sps
            ])
            val = np.stack([np.pad(sp["val"], ((0, 0), (0, bucket - sp["val"].shape[-1]))) for sp in sps])
            heads[head] = {"idx": idx, "val": val, "cap": cap} if cap > bucket else {"idx": idx, "val": val}
        out["targets_sparse"] = heads
    if "weights" in first:
        out["weights"] = {k: np.stack([b["weights"][k] for b in batches]) for k in first["weights"]}
    return out


def grouped_batches(batches: Iterator[Batch], k: int) -> Iterator[Batch]:
    """Group a loader batch stream into stacked k-step batches for
    `multi_step` (``--steps-per-dispatch``); a trailing partial group is
    dropped."""
    group: List[Batch] = []
    for batch in batches:
        group.append(batch)
        if len(group) == k:
            yield stack_batches(group)
            group = []


def is_stacked(batch: Batch) -> bool:
    """True for a `stack_batches` result (leading step axis on every leaf)."""
    if "audio_packed" in batch:
        return len(batch["audio_packed"][1]) == 3
    audio = batch.get("audio")
    return audio is not None and audio.ndim == 3


def _step_slice(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: (v if k == "cap" else _step_slice(v, i)) for k, v in tree.items()}
    return tree[i]


def multi_step(model: nmp.NMP, optimizer: torch.optim.Optimizer, batches: Batch, config: TrainConfig) -> Metrics:
    """k optimizer steps over a stacked device batch in one call, equal to k
    sequential `train_step` calls. Metrics come back with the (k,) step
    axis."""
    k = batches["audio"].shape[0]
    per_step = [train_step(model, optimizer, _step_slice(batches, i), config) for i in range(k)]
    return {key: torch.stack([m[key] for m in per_step]) for key in per_step[0]}


# ---------------------------------------------------------------------------
# train state and the fit loop
# ---------------------------------------------------------------------------


def save_train_state(path: pathlib.Path, model: nmp.NMP, optimizer: torch.optim.Optimizer, extra: Dict) -> None:
    """Full-state checkpoint (model state, Adam state, bookkeeping) with
    `torch.save`, written to a temporary file and renamed into place, so an
    interrupted save leaves the previous state whole."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"params": model.state_dict(), "opt_state": optimizer.state_dict(), "extra": extra}, tmp)
    os.replace(tmp, path)


def restore_train_state(path: pathlib.Path, model: nmp.NMP, optimizer: torch.optim.Optimizer) -> Dict:
    """Load a `save_train_state` file into ``model`` and ``optimizer`` (the
    tensors land on the model's device; Adam's step counters stay on the
    host); returns the bookkeeping dict (epoch, best_val, lr, lr_plateau,
    early_stop)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["opt_state"])
    return state["extra"]


def fit(
    train_iter: Iterator[Batch],
    val_iter: Iterator[Batch],
    output_dir: pathlib.Path,
    config: TrainConfig = TrainConfig(),
    model_config: nmp.ModelConfig = nmp.DEFAULT_CONFIG,
    init: Optional[Dict[str, np.ndarray]] = None,
    seed: int = 0,
    callbacks: Tuple[Callable, ...] = (),
    log: Callable[[str], None] = print,
    resume: bool = True,
    device: "str | torch.device | None" = None,
) -> Dict[str, np.ndarray]:
    """Keras-fit-like loop: plateau LR reduction, early stopping, best and
    per-epoch checkpoints (`train.py:126-168` behaviours), and a full train
    state with automatic resume.

    ``init`` is a flat JAX-layout parameter dict to start from (else the
    reference's initialization from ``seed``). ``device`` is "cuda" (the
    default, which raises without a GPU) or "cpu". Callbacks are called as
    ``cb(epoch, model, train_metrics, val_metrics)``. Returns the best
    parameters as a flat JAX-layout dict.

    Over several processes (after `parallel/distributed.initialize`),
    ``train_iter`` yields this process's slice of each global batch (the
    loader's ``num_shards`` / ``shard_index``) and ``val_iter`` the same
    host-global batches on every process, of which each process evaluates
    its slice. The model starts from process 0's values, the validation
    loss that drives the LR schedule and early stopping is process 0's, and
    only process 0 writes checkpoints, the train state and logs and runs
    the callbacks; ``output_dir`` is shared, as a resume reads it on every
    process. Stacked (grouped) batches are single-process.
    """
    from basic_pitch_torch.parallel import distributed
    from basic_pitch_torch.pipeline import resolve_device
    from basic_pitch_torch.utils import hostmem

    device = resolve_device(device)
    hostmem.tune_host_allocator()  # warm-heap reuse of batch buffers
    is_main = distributed.process_index() == 0
    all_sum = distributed.all_sum if distributed.spans_processes() else None
    if not is_main:
        log = lambda msg: None  # noqa: E731 - only process 0 logs
    output_dir = pathlib.Path(output_dir)
    if is_main:
        (output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    state_path = output_dir / TRAIN_STATE_NAME

    if init is not None:
        model = params_io.model_from_flat(init, model_config)
    else:
        model = nmp.init_params(nmp.NMP(model_config), torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = make_optimizer(model, config)

    lr_plateau = ReduceLROnPlateau(
        factor=config.lr_reduction_factor,
        patience=config.lr_patience,
        min_delta=config.lr_min_delta,
        cooldown=config.lr_cooldown,
        min_lr=config.min_lr,
    )
    early_stop = EarlyStopping(patience=config.early_stop_patience, min_delta=config.early_stop_min_delta)
    best_val = np.inf
    lr = config.learning_rate
    start_epoch = 0
    if resume and state_path.exists():
        extra = restore_train_state(state_path, model, optimizer)
        start_epoch = int(extra["epoch"]) + 1
        best_val = float(extra["best_val"])
        lr = float(extra["lr"])
        lr_plateau.load_state(extra["lr_plateau"])
        early_stop.load_state(extra["early_stop"])
        set_learning_rate(optimizer, lr)
        log(f"resumed from {state_path} at epoch {start_epoch} (best_val={best_val:.4f})")
    distributed.replicate(model)  # every process starts from process 0's values

    # on resume the best checkpoint (if any) beats the latest state
    best_ckpt = output_dir / "model.best.npz"
    if start_epoch > 0 and best_ckpt.exists():
        best_params = params_io.load_flat(best_ckpt)
    else:
        best_params = params_io.to_jax_params(model.state_dict())

    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        train_losses = []
        steps_done = 0
        while steps_done < config.steps_per_epoch:
            batch = next(train_iter)
            stacked = is_stacked(batch)
            if stacked and all_sum is not None:
                raise ValueError("stacked (grouped) batches are single-process; feed per-step batches")
            if needs_upload(batch):
                batch, _ = upload_batch(batch, device)
            if stacked:
                metrics = multi_step(model, optimizer, batch, config)
                steps_done += int(metrics["loss"].shape[0])
            else:
                metrics = train_step(model, optimizer, batch, config, all_sum)
                steps_done += 1
            train_losses.append(metrics["loss"].reshape(-1))
        val_losses = []
        for _ in range(config.validation_steps):
            batch = next(val_iter)
            if all_sum is not None:  # host-global and identical everywhere: take this process's slice
                batch = distributed.local_slice(batch)
            if needs_upload(batch):
                batch, _ = upload_batch(batch, device)
            val_losses.append(eval_step(model, batch, config, all_sum)["loss"])

        train_loss = float(np.mean(torch.cat(train_losses).cpu().numpy()))
        # process 0's value decides the schedule everywhere
        val_loss = distributed.broadcast_value(float(np.mean(torch.stack(val_losses).cpu().numpy())), device)
        log(f"epoch {epoch}: train_loss={train_loss:.4f} val_loss={val_loss:.4f} lr={lr:.2e} ({time.time() - t0:.1f}s)")

        flat = params_io.to_jax_params(model.state_dict())
        if is_main:
            params_io.save_params(output_dir / "checkpoints" / f"model.{epoch:02d}.npz", flat)
        if val_loss < best_val:
            best_val = val_loss
            best_params = flat
            if is_main:
                params_io.save_params(best_ckpt, best_params)

        if is_main:
            for cb in callbacks:
                cb(epoch, model, {"loss": train_loss}, {"loss": val_loss})

        lr, reduced = lr_plateau.step(val_loss, lr)
        if reduced:
            set_learning_rate(optimizer, lr)
            log(f"  reducing learning rate to {lr:.2e}")
        stop = early_stop.step(val_loss)

        if is_main:
            save_train_state(
                state_path,
                model,
                optimizer,
                {
                    "epoch": epoch,
                    "best_val": float(best_val),
                    "lr": float(lr),
                    "lr_plateau": lr_plateau.state(),
                    "early_stop": early_stop.state(),
                },
            )

        if stop:
            log(f"  early stopping at epoch {epoch}")
            break

    return best_params
