"""The shipped ICASSP-2022 checkpoint and the weight conversion between the
JAX package's flat layout and the port's `NMP`.

``assets/nmp_icassp2022.npz`` is a byte-identical copy of the JAX package's
checkpoint: a flat archive with ``/``-joined keys (``contour_conv/w``) in the
JAX layout, HWIO convolution kernels, {gamma, beta, mean, var} batch-norm
dicts and, for a model trained with a learnable filterbank, ``cqt_kernels``.
It is read with numpy alone. `from_jax_params` carries any such flat dict
into an `NMP` state dict, `to_jax_params` carries one back, and
`save_params` writes the archive `basic_pitch_tpu.models.params.load_params`
reads, so checkpoints go both ways between the packages.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from basic_pitch_torch.models import nmp
from basic_pitch_torch.models.nmp import BN_NAMES, CONV_NAMES

PathLike = Union[str, pathlib.Path]

ASSETS_DIR = pathlib.Path(__file__).resolve().parent.parent / "assets"
ICASSP_2022_WEIGHTS_PATH = ASSETS_DIR / "nmp_icassp2022.npz"

# JAX batch-norm field -> torch.nn.BatchNorm2d state name
BN_FIELDS = {"gamma": "weight", "beta": "bias", "mean": "running_mean", "var": "running_var"}
CQT_KEY = "cqt_kernels"  # the learnable filterbank, (n_fft, 2 * n_filters)
CQT_STATE = "cqt.kernel_matrix"


def load_flat(path: PathLike = ICASSP_2022_WEIGHTS_PATH) -> Dict[str, np.ndarray]:
    """The checkpoint as a flat {"layer/field": array} dict (JAX layout)."""
    with np.load(path) as archive:
        return {k: archive[k] for k in archive.files}


def save_params(path: PathLike, flat: Mapping[str, np.ndarray]) -> None:
    """Write a flat JAX-layout dict as the JAX package's ``.npz`` archive."""
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested {"layer": {"field": array}} tree as the flat
    {"layer/field": array} dict, in the tree's own order (the JAX package's
    `flatten_params`)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, prefix=f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.asarray(value)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """The flat dict as the nested tree of numpy arrays the format writers
    walk."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return tree


def flat_params(source: "Union[Mapping[str, Any], nmp.NMP]") -> Dict[str, np.ndarray]:
    """The flat JAX-layout dict of an `NMP` (`to_jax_params` of its state),
    of a flat dict, or of a nested tree."""
    if isinstance(source, nmp.NMP):
        return to_jax_params(source.state_dict())
    return flatten_params(source)


def config_from_params(flat: Mapping[str, np.ndarray]) -> nmp.ModelConfig:
    """The `ModelConfig` a flat checkpoint was built with, read from its
    keys and kernel shapes: the harmonic count and filter widths from the
    conv kernels, ``trainable_cqt`` from a ``cqt_kernels`` entry, and
    ``no_contours`` from a note conv that reads the contour channels. With
    one contour filter the two note-head layouts have the same shapes; such
    a checkpoint is taken as contours on."""
    contour = np.shape(flat["contour_conv/w"])  # (h, w, in, out)
    note_in = np.shape(flat["note_conv/w"])[2]
    return nmp.ModelConfig(
        n_harmonics=int(contour[2]),
        n_filters_contour=int(contour[3]),
        n_filters_notes=int(np.shape(flat["note_conv/w"])[3]),
        n_filters_onsets=int(np.shape(flat["onset_conv/w"])[3]),
        no_contours=note_in != 1,
        trainable_cqt=CQT_KEY in flat,
    )


def from_jax_params(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX-layout parameters -> an `NMP` state dict.

    Convolution kernels go from HWIO to OIHW; batch-norm dicts become
    `BatchNorm2d` weight/bias/running stats; ``cqt_kernels`` becomes the
    trainable bank. Values are copied exactly.
    """
    state: Dict[str, torch.Tensor] = {}
    if CQT_KEY in flat:
        state[CQT_STATE] = torch.from_numpy(np.array(flat[CQT_KEY], np.float32))
    for name in CONV_NAMES:
        w = np.asarray(flat[f"{name}/w"], np.float32)
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(flat[f"{name}/b"], np.float32).copy())
    for name in BN_NAMES:
        for jax_field, torch_field in BN_FIELDS.items():
            value = np.asarray(flat[f"{name}/{jax_field}"], np.float32).copy()
            state[f"{name}.{torch_field}"] = torch.from_numpy(value)
        state[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state


def to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """An `NMP` state dict -> flat JAX-layout numpy parameters (host copies):
    OIHW kernels to HWIO, batch-norm buffers to mean/var, and the trainable
    bank, where the model has one, to ``cqt_kernels``."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    flat: Dict[str, np.ndarray] = {}
    if CQT_STATE in state:
        flat[CQT_KEY] = host(state[CQT_STATE])
    for name in CONV_NAMES:
        flat[f"{name}/w"] = np.ascontiguousarray(host(state[f"{name}.weight"]).transpose(2, 3, 1, 0))
        flat[f"{name}/b"] = host(state[f"{name}.bias"])
    for name in BN_NAMES:
        for jax_field, torch_field in BN_FIELDS.items():
            flat[f"{name}/{jax_field}"] = host(state[f"{name}.{torch_field}"])
    return flat


def model_from_flat(flat: Mapping[str, np.ndarray], config: Optional[nmp.ModelConfig] = None) -> nmp.NMP:
    """An eval-mode `NMP` on the CPU holding a flat checkpoint, built with the
    checkpoint's own `ModelConfig` unless one is given."""
    model = nmp.NMP(config or config_from_params(flat))
    model.load_state_dict(from_jax_params(flat))
    return model
