"""TensorFlow-side export: SavedModel + TFLite artifacts for NMP checkpoints.

A copy of `basic_pitch_tpu/models/tf_export.py` that takes the port's
parameters: the flat {"layer/field": array} dict, or an `nmp.NMP` (turned
into that dict with `params.to_jax_params`). Of the port, only this module
imports tensorflow, and only the export CLI's SavedModel/TFLite branch
imports this module.

The reference ships its checkpoint as a TF SavedModel and `nmp.tflite`
(its `basic_pitch/saved_models/icassp_2022/`, loaded by its
`inference.py:78-117`) so transcription runs under stock TensorFlow servers
and on-device TFLite interpreters. This module is the training-side inverse
for models trained here: it requires tensorflow only at export time (the
CLI gates on the ImportError), and the artifacts it writes are consumed by
runtimes with no PyTorch anywhere.

Design:
  * ONE pure-TF forward (builtin ops only — conv1d/conv2d, gather, pad,
    reduce, where) drives both exports, so the SavedModel serves under any
    TF and the TFLite conversion needs no flex/select ops. It is a re-
    expression of the NMP forward in TF's NHWC idiom, not a trace.
  * The checkpoint variables are the UNFOLDED canonical parameter tree,
    stored under reference-Keras-style names (`layer_with_weights-K/kernel/
    .ATTRIBUTES/VARIABLE_VALUE` …) so the TF-free reader
    (`models/savedmodel.py`) round-trips the exported directory bit-exactly
    and TF-side tooling sees an ordinary object-graph checkpoint.
  * Batch norms are folded into their convs IN-GRAPH from those variables
    (same math as `onnx_export._fold_bn`); the TFLite converter constant-
    folds the fold, which reproduces the reference artifact's shape: fused
    conv weights + a scalar MUL/ADD pair for the post-CQT BN, named with
    the `batch_normalization/FusedBatchNormV3` marker the port's
    `models/tflite_import.py` (and the reference's own tflite) carry.

The exported SavedModel is callable like the reference's
(`model(x) -> {"contour", "note", "onset"}`, x float32 (batch, 43844, 1))
and carries a `serving_default` signature with input name `input_2`.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import tensorflow as tf

from basic_pitch_torch import constants
from basic_pitch_torch.models import nmp
from basic_pitch_torch.models.onnx_export import ParamSource, _tree_and_config, reflect_pad_indices
from basic_pitch_torch.ops import cqt as cqt_ops
from basic_pitch_torch.ops.harmonic import harmonic_shifts

_BN_MARKER = "model/batch_normalization/FusedBatchNormV3"


# slot -> (role layout) written to the checkpoint; order fixes the
# layer_with_weights-K numbering (readers match by shape, not K)
_SLOT_ORDER = (
    "bn_cqt",
    "contour_conv",
    "bn_contour",
    "contour_out",
    "note_conv",
    "note_out",
    "onset_conv",
    "bn_onset",
    "onset_out",
)


def _conv_child(leaf: Dict[str, np.ndarray]) -> tf.Module:
    child = tf.Module()
    child.kernel = tf.Variable(np.asarray(leaf["w"], np.float32), name="kernel")
    child.bias = tf.Variable(np.asarray(leaf["b"], np.float32), name="bias")
    return child


def _bn_child(leaf: Dict[str, np.ndarray]) -> tf.Module:
    child = tf.Module()
    child.gamma = tf.Variable(np.asarray(leaf["gamma"], np.float32), name="gamma")
    child.beta = tf.Variable(np.asarray(leaf["beta"], np.float32), name="beta")
    child.moving_mean = tf.Variable(np.asarray(leaf["mean"], np.float32), name="moving_mean")
    child.moving_variance = tf.Variable(np.asarray(leaf["var"], np.float32), name="moving_variance")
    return child


class NmpTfModule(tf.Module):
    """The NMP forward as a TF module over reference-named variables."""

    def __init__(self, params: ParamSource, config: Optional[nmp.ModelConfig] = None):
        super().__init__(name="nmp")
        params, config = _tree_and_config(params, config)
        if config.no_contours:
            raise ValueError("TF export requires the full (contours) topology")
        self._config = config
        kernels = nmp.cqt_kernels_for(config.n_harmonics)
        if kernels.downsample_factor != 1:
            raise ValueError("TF export assumes the no-early-downsample NMP geometry")
        self._kernels = kernels

        self._slots: Dict[str, tf.Module] = {}
        for i, slot in enumerate(_SLOT_ORDER):
            child = (_bn_child if slot.startswith("bn_") else _conv_child)(params[slot])
            # reference-Keras checkpoint keys: layer_with_weights-K/<role>/...
            setattr(self, f"layer_with_weights-{i}", child)
            self._slots[slot] = child

        # CQT analysis bank: fixed constants unless the checkpoint carries a
        # trained bank (a trainable_cqt checkpoint), mirroring onnx_export
        km = params.get("cqt_kernels")
        km = kernels.top_octave_kernels.T if km is None else np.asarray(km, np.float32)
        # TF conv1d filters are (width, in, out): (n_fft, 1, 2*n_filters)
        self._bank = tf.constant(np.ascontiguousarray(km.astype(np.float32))[:, None, :])
        self._dec = tf.constant(kernels.lowpass.astype(np.float32)[:, None, None])
        norm = (kernels.length_norm * float(kernels.downsample_factor)).astype(np.float32)
        self._norm2 = tf.constant((norm * norm)[None, None, :])

    # ---- folded conv weights, computed in-graph from the variables ----

    def _folded(self, slot: str, fold: str | None) -> Tuple[tf.Tensor, tf.Tensor]:
        w, b = self._slots[slot].kernel, self._slots[slot].bias
        if fold is None:
            return w, b
        bn = self._slots[fold]
        scale = bn.gamma * tf.math.rsqrt(bn.moving_variance + nmp.BN_EPSILON)
        # HWIO: scale broadcasts over the output-channel (last) axis
        return w * scale, bn.beta + (b - bn.moving_mean) * scale

    def _head(self, slot: str, x: tf.Tensor, strides=(1, 1), fold: str | None = None) -> tf.Tensor:
        w, b = self._folded(slot, fold)
        y = tf.nn.conv2d(x, w, strides=[1, strides[0], strides[1], 1], padding="SAME")
        return y + b

    # ---- forward ----

    @tf.function(
        input_signature=[
            tf.TensorSpec([None, constants.AUDIO_N_SAMPLES, 1], tf.float32, name="input_2")
        ]
    )
    def __call__(self, input_2: tf.Tensor) -> Dict[str, tf.Tensor]:
        k = self._kernels
        sig = input_2  # (b, n_samples, 1) NWC
        hop = k.cascade_hop
        length = constants.AUDIO_N_SAMPLES
        dec_pad = (int(self._dec.shape[0]) - 1) // 2

        octaves = []  # top octave first: (b, n_frames, 2*n_filters)
        for octave in range(k.n_octaves):
            if octave > 0:
                hop //= 2
                sig = tf.pad(sig, [[0, 0], [dec_pad, dec_pad], [0, 0]])
                sig = tf.nn.conv1d(sig, self._dec, stride=2, padding="VALID")
                length = cqt_ops.decimated_length(length)
            refl = tf.constant(
                reflect_pad_indices(length, k.n_fft // 2).astype(np.int32)
            )
            padded = tf.gather(sig, refl, axis=1)
            octaves.append(tf.nn.conv1d(padded, self._bank, stride=hop, padding="VALID"))

        nf = k.n_filters
        # low octave first on the bin axis, crop to the top n_bins, magnitude
        real = tf.concat([o[:, :, :nf] for o in octaves[::-1]], axis=2)
        imag = tf.concat([o[:, :, nf:] for o in octaves[::-1]], axis=2)
        total = k.n_octaves * nf
        real = real[:, :, total - k.n_bins :]
        imag = imag[:, :, total - k.n_bins :]
        power = (real * real + imag * imag) * self._norm2
        mag = tf.sqrt(power)  # (b, frames, n_bins)

        # normalized log power ([0,1] per example) — ops/spectral.normalized_log
        log_power = tf.math.log(mag * mag + np.float32(1e-10)) * np.float32(
            10.0 / np.log(10.0)
        )
        lp_min = tf.reduce_min(log_power, axis=[1, 2], keepdims=True)
        offset = log_power - lp_min
        offset_max = tf.reduce_max(offset, axis=[1, 2], keepdims=True)
        normalized = tf.where(
            offset_max > 0.0, tf.math.divide_no_nan(offset, offset_max), 0.0
        )

        # post-CQT batch norm as a scalar mul/add pair; the op names carry
        # the FusedBatchNormV3 marker models/tflite_import.py keys on
        bn = self._slots["bn_cqt"]
        scale = bn.gamma * tf.math.rsqrt(bn.moving_variance + nmp.BN_EPSILON)
        eff_scale = tf.reshape(scale, [], name=f"{_BN_MARKER}/mul")
        eff_bias = tf.reshape(
            bn.beta - bn.moving_mean * scale, [], name=f"{_BN_MARKER}/add"
        )
        x = normalized * eff_scale + eff_bias  # (b, frames, n_bins)

        # harmonic stacking straight into NHWC: one freq slice per harmonic
        n_out = constants.N_FREQ_BINS_CONTOURS
        channels = []
        for shift in harmonic_shifts(
            constants.CONTOURS_BINS_PER_SEMITONE, self._config.harmonics
        ):
            lo, hi = max(shift, 0), min(k.n_bins, n_out + shift)
            ch = x[:, :, lo:hi]
            pad_front = max(-shift, 0)
            pad_back = n_out - pad_front - (hi - lo)
            if pad_front or pad_back:
                ch = tf.pad(ch, [[0, 0], [0, 0], [pad_front, pad_back]])
            channels.append(ch[..., None])
        stack = tf.concat(channels, axis=3)  # (b, frames, 264, n_harmonics)

        # heads — same dataflow as nmp.forward (reference models.py:241-318)
        c = tf.nn.relu(self._head("contour_conv", stack, fold="bn_contour"))
        contour_pre = tf.sigmoid(self._head("contour_out", c))  # (b, t, 264, 1)

        n = tf.nn.relu(self._head("note_conv", contour_pre, strides=(1, 3)))
        note_pre = tf.sigmoid(self._head("note_out", n))  # (b, t, 88, 1)

        o = tf.nn.relu(self._head("onset_conv", stack, strides=(1, 3), fold="bn_onset"))
        o = tf.concat([note_pre, o], axis=3)  # note-pre first — nmp.forward
        onset_pre = tf.sigmoid(self._head("onset_out", o))

        return {
            "contour": tf.squeeze(contour_pre, axis=3),
            "note": tf.squeeze(note_pre, axis=3),
            "onset": tf.squeeze(onset_pre, axis=3),
        }


def export_savedmodel(
    params: ParamSource, out_dir: "str | pathlib.Path", config: Optional[nmp.ModelConfig] = None
) -> None:
    """Write `params` (flat dict or `nmp.NMP`) as a TF SavedModel directory
    callable like the reference's (its `inference.py:78-94, 160-162`)."""
    module = NmpTfModule(params, config)
    concrete = module.__call__.get_concrete_function()
    tf.saved_model.save(
        module, str(out_dir), signatures={"serving_default": concrete}
    )


def export_tflite(
    params: ParamSource, path: "str | pathlib.Path", config: Optional[nmp.ModelConfig] = None
) -> None:
    """Write `params` (flat dict or `nmp.NMP`) as `nmp.tflite` (builtin ops
    only — no flex delegate), loadable by the reference's tflite consumer
    (its `inference.py:112-117`) and by the runtime-free importer
    (`models/tflite_import.py`)."""
    module = NmpTfModule(params, config)
    concrete = module.__call__.get_concrete_function()
    converter = tf.lite.TFLiteConverter.from_concrete_functions([concrete], module)
    flat = converter.convert()
    pathlib.Path(path).write_bytes(flat)
