"""Training losses for the NMP model.

PyTorch counterpart of `basic_pitch_tpu/train/losses.py`: smoothed binary
cross-entropy per head (Keras ``binary_crossentropy(label_smoothing=s)``,
probabilities clipped to [1e-7, 1 - 1e-7], averaged over the frequency
axis), an optional class-balanced variant for the sparse onset head, and
per-example presence weights from the data loader. Computed in float32.

Over several processes (``all_sum``, `parallel/distributed.all_sum`) each
process returns its share of the loss of the global batch: the shares sum
to the loss one process would compute on the whole batch, because every
divisor (the global batch size, the pooled onset loss's cell counts, the
mean sample weight) is summed over the processes first.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

DEFAULT_LABEL_SMOOTHING = 0.2
DEFAULT_POSITIVE_WEIGHT = 0.5
_EPS = 1e-7  # Keras clips probabilities to [eps, 1-eps]


def _bce_elementwise(y_true: torch.Tensor, y_pred: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    y_true = y_true * (1.0 - label_smoothing) + 0.5 * label_smoothing
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))


def transcription_loss(
    y_true: torch.Tensor, y_pred: torch.Tensor, label_smoothing: float = DEFAULT_LABEL_SMOOTHING
) -> torch.Tensor:
    """Smoothed BCE averaged over the trailing (frequency) axis. Returns
    (..., time)."""
    return torch.mean(_bce_elementwise(y_true, y_pred, label_smoothing), dim=-1)


def weighted_transcription_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    label_smoothing: float = DEFAULT_LABEL_SMOOTHING,
    positive_weight: float = DEFAULT_POSITIVE_WEIGHT,
    all_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Class-balanced BCE: the means over exactly-zero and nonzero target
    cells, combined with weight ``positive_weight``. Returns a scalar (this
    process's share, with the cells counted over every process, when
    ``all_sum`` is given)."""
    elementwise = _bce_elementwise(y_true, y_pred, label_smoothing)
    negative_mask = (y_true == 0).to(elementwise.dtype)
    positive_mask = 1.0 - negative_mask
    counts = torch.stack([torch.sum(negative_mask), torch.sum(positive_mask)])
    if all_sum is not None:
        counts = all_sum(counts)
    n_neg, n_pos = torch.clamp(counts, min=1.0).unbind()
    bce_negative = torch.sum(elementwise * negative_mask) / n_neg
    bce_positive = torch.sum(elementwise * positive_mask) / n_pos
    return (1.0 - positive_weight) * bce_negative + positive_weight * bce_positive


def total_loss(
    outputs: Dict[str, torch.Tensor],
    targets: Dict[str, torch.Tensor],
    sample_weights: Optional[Dict[str, torch.Tensor]] = None,
    label_smoothing: float = DEFAULT_LABEL_SMOOTHING,
    weighted_onset: bool = False,
    positive_weight: float = DEFAULT_POSITIVE_WEIGHT,
    no_contours: bool = False,
    all_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss over the contour, note and onset heads.

    Each head's per-example loss is scaled by that example's presence weight
    (0 where the dataset lacks the annotation) and averaged over the batch.
    With ``no_contours`` the contour head is left out: its output is then a
    relu'd hidden activation, not a posteriorgram.

    The class-balanced onset loss keeps the reference's quirk: it pools every
    cell of the batch, so weight-0 examples still enter the pooled means, and
    the sample weights reduce to one scalar, their mean.

    With ``all_sum`` (a sum over processes) the values are this process's
    shares of the global batch's losses.

    Returns:
        (scalar total, dict of per-head scalars).
    """
    heads = ("note", "onset") if no_contours else ("contour", "note", "onset")
    if all_sum is not None:
        probe = outputs[heads[0]]
        global_batch = all_sum(probe.new_tensor(float(probe.shape[0])))
    per_head = {}
    for head in heads:
        y_true, y_pred = targets[head], outputs[head]
        if head == "onset" and weighted_onset:
            head_loss = weighted_transcription_loss(y_true, y_pred, label_smoothing, positive_weight, all_sum)
            if sample_weights is not None:
                w = sample_weights[head]
                head_loss = head_loss * (torch.mean(w) if all_sum is None else all_sum(torch.sum(w)) / global_batch)
        else:
            per_example = torch.mean(transcription_loss(y_true, y_pred, label_smoothing), dim=-1)  # (batch,)
            if sample_weights is not None:
                per_example = per_example * sample_weights[head]
            head_loss = torch.mean(per_example) if all_sum is None else torch.sum(per_example) / global_batch
        per_head[head] = head_loss
    total = sum(per_head.values())
    return total, per_head
