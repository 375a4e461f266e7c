"""The shipped ICASSP-2022 checkpoint and the weight conversion into the port.

``assets/nmp_icassp2022.npz`` is a byte-identical copy of the JAX package's
checkpoint: a flat archive with ``/``-joined keys (``contour_conv/w``) in the
JAX layout, HWIO convolution kernels and {gamma, beta, mean, var} batch-norm
dicts. It is read with numpy alone; `from_jax_params` carries any such flat
dict into an `NMP` state dict.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Union

import numpy as np
import torch

PathLike = Union[str, pathlib.Path]

ASSETS_DIR = pathlib.Path(__file__).resolve().parent.parent / "assets"
ICASSP_2022_WEIGHTS_PATH = ASSETS_DIR / "nmp_icassp2022.npz"

CONV_NAMES = ("contour_conv", "contour_out", "note_conv", "note_out", "onset_conv", "onset_out")
BN_NAMES = ("bn_cqt", "bn_contour", "bn_onset")
# JAX batch-norm field -> torch.nn.BatchNorm2d state name
BN_FIELDS = {"gamma": "weight", "beta": "bias", "mean": "running_mean", "var": "running_var"}


def load_flat(path: PathLike = ICASSP_2022_WEIGHTS_PATH) -> Dict[str, np.ndarray]:
    """The checkpoint as a flat {"layer/field": array} dict (JAX layout)."""
    with np.load(path) as archive:
        return {k: archive[k] for k in archive.files}


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX-layout parameters -> an `NMP` state dict.

    Convolution kernels go from HWIO to OIHW; batch-norm dicts become
    `BatchNorm2d` weight/bias/running stats. Values are copied exactly.
    """
    state: Dict[str, torch.Tensor] = {}
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
