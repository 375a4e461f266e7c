"""Plain reference of the Basic Pitch training step (the published
`basic_pitch/train.py` defaults), on `reference/nmp.py`'s model.

One step on a batch: train-mode forward (batch norm on the batch's mean
and biased variance), the three heads' smoothed binary cross-entropy
(label smoothing 0.2, probabilities clipped to [1e-7, 1 - 1e-7], mean over
frequency, time and batch, each example weighted by its presence weight),
their sum, the gradients by autograd, Adam (lr 1e-3, betas 0.9 / 0.999,
eps 1e-8, bias-corrected), then every conv kernel's output channels
scaled to unit L2 norm, then the batch-norm moving averages at momentum
0.99 with the step's batch statistics.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from reference.nmp import BN_NAMES, CONV_NAMES, Reference

LABEL_SMOOTHING = 0.2
EPS = 1e-7
LR, BETA1, BETA2, ADAM_EPS = 1e-3, 0.9, 0.999, 1e-8
BN_MOMENTUM = 0.99
HEADS = ("contour", "note", "onset")
BINS = {"onset": 88, "note": 88, "contour": 264}


def trainable(name: str) -> bool:
    return not (name.endswith("/mean") or name.endswith("/var"))


def dense_batch(batch: Dict, device, dtype) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A host batch (int16 audio, flat COO targets with sentinel padding,
    weights) -> (audio, dense targets, weights) on ``device``."""
    audio = torch.as_tensor(batch["audio"], device=device)
    audio = audio.to(dtype) / 32768.0 if audio.dtype == torch.int16 else audio.to(dtype)
    targets = {}
    for head in HEADS:
        sp = batch["targets_sparse"][head]
        cells = 172 * BINS[head]
        flat = np.zeros((sp["idx"].shape[0], cells + 1), np.float64)
        np.put_along_axis(flat, sp["idx"].astype(np.int64), sp["val"].astype(np.float64), axis=1)
        targets[head] = torch.tensor(flat[:, :cells].reshape(-1, 172, BINS[head]), dtype=dtype, device=device)
    weights = {h: torch.as_tensor(batch["weights"][h], device=device).to(dtype) for h in HEADS}
    return audio, targets, weights


def loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor], weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    total = 0.0
    for head in HEADS:
        y = targets[head] * (1.0 - LABEL_SMOOTHING) + 0.5 * LABEL_SMOOTHING
        p = torch.clamp(outputs[head], EPS, 1.0 - EPS)
        bce = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
        total = total + torch.mean(torch.mean(bce, dim=(1, 2)) * weights[head])
    return total


class Trainer:
    """Follows the program's first steps from the same initial weights."""

    def __init__(self, init: Dict[str, torch.Tensor], device, dtype=torch.float64):
        self.model = Reference(device, dtype)
        self.params = {k: v.detach().to(device=device, dtype=dtype).clone() for k, v in init.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items() if trainable(k)}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items() if trainable(k)}
        self.t = 0
        self.device, self.dtype = device, dtype

    def step(self, batch: Dict) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One step; returns (loss, gradients)."""
        audio, targets, weights = dense_batch(batch, self.device, self.dtype)
        leaves = {k: v.clone().requires_grad_(True) for k, v in self.params.items() if trainable(k)}
        p = {**self.params, **leaves}
        outputs, stats = self.model.forward(p, audio, train=True)
        value = loss(outputs, targets, weights)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        self.t += 1
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k] = BETA1 * self.m[k] + (1 - BETA1) * g
                self.v[k] = BETA2 * self.v[k] + (1 - BETA2) * g * g
                m_hat = self.m[k] / (1 - BETA1**self.t)
                v_hat = self.v[k] / (1 - BETA2**self.t)
                self.params[k] = self.params[k] - LR * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
            for name in CONV_NAMES:
                w = self.params[f"{name}/w"]  # HWIO
                norm = torch.sqrt(torch.sum(w * w, dim=(0, 1, 2), keepdim=True))
                self.params[f"{name}/w"] = w / torch.clamp(norm, min=1e-12)
            for name in BN_NAMES:
                mean, var = stats[name]
                self.params[f"{name}/mean"] = BN_MOMENTUM * self.params[f"{name}/mean"] + (1 - BN_MOMENTUM) * mean
                self.params[f"{name}/var"] = BN_MOMENTUM * self.params[f"{name}/var"] + (1 - BN_MOMENTUM) * var
        return float(value.detach()), grads


def follow(init: Dict[str, torch.Tensor], batches: List[Dict], device, dtype=torch.float64):
    """(losses, first gradients, parameters after the last step) of the
    steps on ``batches``, all as float64 numpy."""
    trainer = Trainer(init, device, dtype)
    losses, first = [], None
    for batch in batches:
        value, grads = trainer.step(batch)
        losses.append(value)
        if first is None:
            first = {k: g.double().cpu().numpy() for k, g in grads.items()}
    return losses, first, {k: v.double().cpu().numpy() for k, v in trainer.params.items()}
