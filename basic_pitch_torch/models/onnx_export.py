"""Runtime-free ONNX export of an NMP checkpoint.

A copy of `basic_pitch_tpu/models/onnx_export.py` (the port imports nothing
of the JAX package) that takes the port's parameters: the flat
{"layer/field": array} dict, or an `nmp.NMP` (turned into that dict with
`params.to_jax_params`). For the same parameters it writes the same bytes as
the JAX writer (`tests/test_torch_onnx_export.py`): the batch-norm fold is
float64 numpy in both, and the producer and graph names are the JAX
writer's.

The reference ships its checkpoint as `nmp.onnx` so models run anywhere
onnxruntime does (its `basic_pitch/inference.py:129-136,168-182`); this
module writes the same deployable artifact for models trained here, without
onnx, onnxruntime, or protobuf installed: the port's own wire-format
primitives (`data/proto.py`) emit a complete, runnable ModelProto whose
graph computes the full forward pass — CQT cascade, normalized log, batch
norm, harmonic stacking, and the six head convs — from audio to
posteriorgrams.

Drop-in compatibility with the reference's ONNX consumer surface:
  - input  `serving_default_input_2:0`  (batch, 43844, 1) float32
  - outputs `StatefulPartitionedCall:0/1/2` = contour/note/onset, the exact
    names + order the reference's `Model.predict` requests
    (its `inference.py:168-182`)
  - batch-norm folded into the conv kernels/biases and the post-CQT BN
    emitted as a scalar Mul/Add pair — the same normalization tf2onnx
    applies, which is also what the readers (`models/onnx_import.py`)
    expect structurally.

Graph design notes (ONNX-native, not a trace of the model):
  - The CQT's reflect padding can exceed the signal length at the bottom
    octaves (pad 256 on a 171-sample signal), which ONNX `Pad(reflect)`
    does not support — each octave's centering is a `Gather` with a
    precomputed multi-bounce reflection index vector instead.
  - Framing + analysis bank collapse into ONE stride-`hop` Conv per octave
    (kernel = the L1-normalized complex bank, real rows then imag rows);
    the imag negation of the analysis convention is dropped because only
    the magnitude is consumed.
  - The anti-alias decimators are stride-2 Convs with their symmetric zero
    padding expressed in the Conv `pads` attribute.

The exported file round-trips through `models/onnx_import.load_nmp_onnx`
and executes under the port's torch evaluator (`models/onnx_eval.py`) and
onnxruntime alike.
"""

from __future__ import annotations

import io
import pathlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from basic_pitch_torch import constants
from basic_pitch_torch.data.proto import _length_delimited, _tag, encode_varint
from basic_pitch_torch.models import nmp
from basic_pitch_torch.models import params as params_io
from basic_pitch_torch.ops import cqt as cqt_ops
from basic_pitch_torch.ops.harmonic import harmonic_shifts

OPSET = 15
IR_VERSION = 8

# the JAX writer's producer and graph name: both packages write the same bytes
PRODUCER = b"basic_pitch_tpu"

INPUT_NAME = "serving_default_input_2:0"
OUTPUT_NAMES = {  # inference.py:168-182 requests these by name
    "contour": "StatefulPartitionedCall:0",
    "note": "StatefulPartitionedCall:1",
    "onset": "StatefulPartitionedCall:2",
}

# onnx TensorProto.DataType
_FLOAT = 1
_INT64 = 7

# AttributeProto.AttributeType
_ATTR_FLOAT = 1
_ATTR_INT = 2
_ATTR_STRING = 3
_ATTR_INTS = 7


# --- proto emission ----------------------------------------------------------


def _tensor_proto(name: str, array: np.ndarray) -> bytes:
    array = np.asarray(array)
    if array.dtype == np.float32:
        enum = _FLOAT
    elif array.dtype == np.int64:
        enum = _INT64
    else:
        raise ValueError(f"unsupported initializer dtype {array.dtype}")
    body = b"".join(_tag(1, 0) + encode_varint(int(d)) for d in array.shape)
    body += _tag(2, 0) + encode_varint(enum)
    body += _length_delimited(8, name.encode())
    body += _length_delimited(9, array.astype(array.dtype.newbyteorder("<")).tobytes())
    return body


def _attr(name: str, value: Any) -> bytes:
    body = _length_delimited(1, name.encode())
    if isinstance(value, str):
        body += _length_delimited(4, value.encode())
        body += _tag(20, 0) + encode_varint(_ATTR_STRING)
    elif isinstance(value, float):
        import struct

        body += _tag(2, 5) + struct.pack("<f", value)
        body += _tag(20, 0) + encode_varint(_ATTR_FLOAT)
    elif isinstance(value, int):
        body += _tag(3, 0) + encode_varint(value & ((1 << 64) - 1))
        body += _tag(20, 0) + encode_varint(_ATTR_INT)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        packed = b"".join(encode_varint(v & ((1 << 64) - 1)) for v in value)
        body += _length_delimited(8, packed)
        body += _tag(20, 0) + encode_varint(_ATTR_INTS)
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return body


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str], **attrs: Any) -> bytes:
    body = b"".join(_length_delimited(1, i.encode()) for i in inputs)
    body += b"".join(_length_delimited(2, o.encode()) for o in outputs)
    body += _length_delimited(3, f"{op}_{outputs[0]}".encode())
    body += _length_delimited(4, op.encode())
    body += b"".join(_length_delimited(5, _attr(k, v)) for k, v in attrs.items())
    return body


def _value_info(name: str, shape: Sequence) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _length_delimited(1, _length_delimited(2, d.encode()))
        else:
            dims += _length_delimited(1, _tag(1, 0) + encode_varint(int(d)))
    tensor_type = _tag(1, 0) + encode_varint(_FLOAT)
    tensor_type += _length_delimited(2, dims)
    type_proto = _length_delimited(1, tensor_type)
    return _length_delimited(1, name.encode()) + _length_delimited(2, type_proto)


class _GraphBuilder:
    """Accumulates nodes + initializers; hands out unique tensor names."""

    def __init__(self) -> None:
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, hint: str, array: np.ndarray, name: Optional[str] = None) -> str:
        name = name or self.name(hint)
        self.initializers.append(_tensor_proto(name, array))
        return name

    def op(
        self, op: str, inputs: Sequence[str], out: Optional[str] = None, **attrs: object
    ) -> str:
        out = out or self.name(op.lower())
        self.nodes.append(_node(op, inputs, [out], **attrs))
        return out


# --- reflection indices ------------------------------------------------------


def reflect_pad_indices(length: int, pad: int) -> np.ndarray:
    """Source indices of numpy-style 'reflect' padding by `pad` on both
    sides — multi-bounce when pad >= length (jnp.pad semantics, which the
    bottom CQT octaves rely on)."""
    idx = np.arange(-pad, length + pad, dtype=np.int64)
    if length == 1:
        return np.zeros_like(idx)
    period = 2 * (length - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= length, period - idx, idx)


# --- BN folding --------------------------------------------------------------


def _fold_bn(w: np.ndarray, b: np.ndarray, bn: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Fold an eval-mode batch norm into the preceding conv (HWIO weights).

    BN(conv(x) + b) == conv_scaled(x) + b_fused with
    scale = gamma * rsqrt(var + eps) applied per output channel.
    """
    scale = np.asarray(bn["gamma"], np.float64) / np.sqrt(
        np.asarray(bn["var"], np.float64) + nmp.BN_EPSILON
    )
    w64 = np.asarray(w, np.float64) * scale  # broadcasts over the last (O) axis
    b64 = np.asarray(bn["beta"], np.float64) + (np.asarray(b, np.float64) - np.asarray(bn["mean"], np.float64)) * scale
    return w64.astype(np.float32), b64.astype(np.float32)


def _conv_init(g: _GraphBuilder, slot: str, w_hwio: np.ndarray, b: np.ndarray) -> Tuple[str, str]:
    """Register a conv kernel (HWIO -> OIHW) + bias as initializers."""
    w_oihw = np.ascontiguousarray(np.transpose(np.asarray(w_hwio, np.float32), (3, 2, 0, 1)))
    return g.const(f"{slot}/kernel", w_oihw), g.const(f"{slot}/bias", b.astype(np.float32))


def _same_pads_2d(
    in_hw: Tuple[int, int], k_hw: Tuple[int, int], strides: Tuple[int, int]
) -> List[int]:
    """TF-SAME padding as the ONNX Conv `pads` attribute [hb, wb, he, we]."""
    pads_begin, pads_end = [], []
    for size, k, s in zip(in_hw, k_hw, strides):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads_begin.append(total // 2)
        pads_end.append(total - total // 2)
    return [pads_begin[0], pads_begin[1], pads_end[0], pads_end[1]]


# --- the graph ---------------------------------------------------------------


ParamSource = Union[Mapping[str, Any], nmp.NMP]


def _tree_and_config(
    source: ParamSource, config: Optional[nmp.ModelConfig]
) -> Tuple[Dict[str, Any], nmp.ModelConfig]:
    """The nested numpy tree the graph builders walk, and the `ModelConfig`:
    the one given, else the module's own or the checkpoint's."""
    flat = params_io.flat_params(source)
    if config is None:
        config = source.config if isinstance(source, nmp.NMP) else params_io.config_from_params(flat)
    return params_io.unflatten_params(flat), config


def build_nmp_graph(
    params: ParamSource,
    config: Optional[nmp.ModelConfig] = None,
) -> Tuple[bytes, bytes]:
    """Build the GraphProto body for a full NMP forward pass.

    Returns (graph_bytes, docstring) — callers normally use `export_onnx`.
    """
    params, config = _tree_and_config(params, config)
    if config.no_contours:
        raise ValueError("ONNX export requires the full (contours) topology")
    g = _GraphBuilder()
    kernels = nmp.cqt_kernels_for(config.n_harmonics)

    n_samples = constants.AUDIO_N_SAMPLES
    n_frames = cqt_ops.cqt_frame_count(n_samples, kernels.cascade_hop)
    if kernels.downsample_factor != 1:
        raise ValueError("ONNX export assumes the no-early-downsample NMP geometry")

    # (b, 43844, 1) -> (b, 1, 43844)  [NCW]
    sig = g.op("Transpose", [INPUT_NAME], perm=[0, 2, 1])

    # analysis bank: (n_fft, 2*nf) columns real|imag -> Conv kernel (2nf, 1, n_fft)
    km = params.get("cqt_kernels")
    km = kernels.top_octave_kernels.T if km is None else np.asarray(km, np.float32)
    bank = np.ascontiguousarray(km.T.astype(np.float32)[:, None, :])  # (2nf, 1, n_fft)
    bank_name = g.const("cqt/analysis_bank", bank)
    dec_taps = kernels.lowpass.astype(np.float32)[None, None, :]  # (1, 1, 256)
    dec_name = g.const("cqt/decimator", dec_taps)

    octaves = []  # top octave first: (b, 2nf, n_frames) complex parts stacked
    hop = kernels.cascade_hop
    length = n_samples
    for octave in range(kernels.n_octaves):
        if octave > 0:
            hop //= 2
            sig = g.op(
                "Conv", [sig, dec_name], strides=[2],
                pads=[(dec_taps.shape[-1] - 1) // 2] * 2,
            )
            length = cqt_ops.decimated_length(length)
        refl = g.const(
            f"cqt/reflect_idx_{octave}",
            reflect_pad_indices(length, kernels.n_fft // 2),
        )
        padded = g.op("Gather", [sig, refl], axis=2)
        octaves.append(g.op("Conv", [padded, bank_name], strides=[hop], pads=[0, 0]))

    nf = kernels.n_filters
    # low octave first, crop to the top n_bins, then magnitude
    reals = [g.op("Slice", [o, g.const("s", np.array([0], np.int64)),
                            g.const("e", np.array([nf], np.int64)),
                            g.const("a", np.array([1], np.int64))]) for o in octaves[::-1]]
    imags = [g.op("Slice", [o, g.const("s", np.array([nf], np.int64)),
                            g.const("e", np.array([2 * nf], np.int64)),
                            g.const("a", np.array([1], np.int64))]) for o in octaves[::-1]]
    real = g.op("Concat", reals, axis=1)  # (b, n_oct*nf, frames)
    imag = g.op("Concat", imags, axis=1)
    total_bins = kernels.n_octaves * nf
    crop_s = g.const("crop_s", np.array([total_bins - kernels.n_bins], np.int64))
    crop_e = g.const("crop_e", np.array([total_bins], np.int64))
    crop_a = g.const("crop_a", np.array([1], np.int64))
    real = g.op("Slice", [real, crop_s, crop_e, crop_a])
    imag = g.op("Slice", [imag, crop_s, crop_e, crop_a])
    power = g.op(
        "Add", [g.op("Mul", [real, real]), g.op("Mul", [imag, imag])]
    )  # |CQT|^2, (b, n_bins, frames)
    norm = (kernels.length_norm * float(kernels.downsample_factor)).astype(np.float32)
    norm2 = g.const("cqt/length_norm_sq", (norm * norm)[None, :, None])
    power = g.op("Mul", [power, norm2])
    mag = g.op("Sqrt", [power])
    mag = g.op("Transpose", [mag], perm=[0, 2, 1])  # (b, frames, n_bins)

    # normalized log power ([0,1] per example) — ops/spectral.normalized_log
    pow2 = g.op("Mul", [mag, mag])
    eps = g.const("nl/eps", np.float32(1e-10).reshape(()))
    log_power = g.op("Log", [g.op("Add", [pow2, eps])])
    scale10 = g.const("nl/db_scale", np.float32(10.0 / np.log(10.0)).reshape(()))
    log_power = g.op("Mul", [log_power, scale10])
    lp_min = g.op("ReduceMin", [log_power], axes=[1, 2], keepdims=1)
    offset = g.op("Sub", [log_power, lp_min])
    offset_max = g.op("ReduceMax", [offset], axes=[1, 2], keepdims=1)
    zero = g.const("nl/zero", np.float32(0.0).reshape(()))
    positive = g.op("Greater", [offset_max, zero])
    normalized = g.op("Where", [positive, g.op("Div", [offset, offset_max]), zero])

    # post-CQT batch norm as the scalar Mul/Add pair tf2onnx emits — the
    # names carry the FusedBatchNormV3 marker the repo's importer keys on
    bn = params["bn_cqt"]
    eff_scale = np.float64(bn["gamma"][0]) / np.sqrt(np.float64(bn["var"][0]) + nmp.BN_EPSILON)
    eff_bias = np.float64(bn["beta"][0]) - np.float64(bn["mean"][0]) * eff_scale
    mul_c = g.const(
        "m", np.float32(eff_scale).reshape(()),
        name="model/batch_normalization/FusedBatchNormV3/mul",
    )
    add_c = g.const(
        "a", np.float32(eff_bias).reshape(()),
        name="model/batch_normalization/FusedBatchNormV3/add",
    )
    x = g.op("Add", [g.op("Mul", [normalized, mul_c]), add_c])  # (b, frames, n_bins)

    # harmonic stacking straight into NCHW: each harmonic is a freq slice
    # (+ zero pad), unsqueezed to (b, 1, frames, 264) and concatenated on C
    n_out = constants.N_FREQ_BINS_CONTOURS
    n_bins = kernels.n_bins
    channels = []
    unsq_axes = g.const("hs/axes", np.array([1], np.int64))
    for shift in harmonic_shifts(constants.CONTOURS_BINS_PER_SEMITONE, config.harmonics):
        lo, hi = max(shift, 0), min(n_bins, n_out + shift)
        ch = g.op(
            "Slice",
            [x, g.const("s", np.array([lo], np.int64)),
             g.const("e", np.array([hi], np.int64)),
             g.const("a", np.array([2], np.int64))],
        )
        pad_front = max(-shift, 0)
        pad_back = n_out - pad_front - (hi - lo)
        if pad_front or pad_back:
            pads = g.const("p", np.array([0, 0, pad_front, 0, 0, pad_back], np.int64))
            ch = g.op("Pad", [ch, pads], mode="constant")
        channels.append(g.op("Unsqueeze", [ch, unsq_axes]))
    stack = g.op("Concat", channels, axis=1)  # (b, nh, frames, 264)

    # --- heads (NCHW convs, BN folded) ---
    nh = len(config.harmonics)

    def conv(slot: str, inp: str, in_hw, strides=(1, 1), fold: Optional[str] = None) -> str:
        w, b = params[slot]["w"], params[slot]["b"]
        if fold is not None:
            w, b = _fold_bn(w, b, params[fold])
        kname, bname = _conv_init(g, slot, w, b)
        kh, kw = np.asarray(w).shape[:2]
        return g.op(
            "Conv", [inp, kname, bname],
            strides=list(strides),
            pads=_same_pads_2d(in_hw, (kh, kw), strides),
        )

    c = g.op("Relu", [conv("contour_conv", stack, (n_frames, n_out), fold="bn_contour")])
    contour_pre = g.op("Sigmoid", [conv("contour_out", c, (n_frames, n_out))])  # (b,1,t,264)

    n = g.op("Relu", [conv("note_conv", contour_pre, (n_frames, n_out), strides=(1, 3))])
    n_freq = -(-n_out // 3)
    note_pre = g.op("Sigmoid", [conv("note_out", n, (n_frames, n_freq))])  # (b,1,t,88)

    o = g.op("Relu", [conv("onset_conv", stack, (n_frames, n_out), strides=(1, 3), fold="bn_onset")])
    o = g.op("Concat", [note_pre, o], axis=1)  # note-pre first — nmp.forward
    onset_pre = g.op("Sigmoid", [conv("onset_out", o, (n_frames, n_freq))])

    sq_axes = g.const("out/axes", np.array([1], np.int64))
    g.op("Squeeze", [contour_pre, sq_axes], out=OUTPUT_NAMES["contour"])
    g.op("Squeeze", [note_pre, sq_axes], out=OUTPUT_NAMES["note"])
    g.op("Squeeze", [onset_pre, sq_axes], out=OUTPUT_NAMES["onset"])

    graph = b"".join(_length_delimited(1, n) for n in g.nodes)
    graph += _length_delimited(2, PRODUCER)
    graph += b"".join(_length_delimited(5, i) for i in g.initializers)
    graph += _length_delimited(11, _value_info(INPUT_NAME, ["batch", n_samples, 1]))
    for head, width in (("contour", n_out), ("note", n_freq), ("onset", n_freq)):
        graph += _length_delimited(
            12, _value_info(OUTPUT_NAMES[head], ["batch", n_frames, width])
        )
    return graph, b""


def export_onnx(
    params: ParamSource, path: "str | pathlib.Path", config: Optional[nmp.ModelConfig] = None
) -> None:
    """Write `params` (flat dict or `nmp.NMP`) as a runnable `nmp.onnx`
    (see module docstring)."""
    graph, _ = build_nmp_graph(params, config)
    buf = io.BytesIO()
    buf.write(_tag(1, 0) + encode_varint(IR_VERSION))
    buf.write(_length_delimited(2, PRODUCER))
    buf.write(_length_delimited(3, b"1.0"))
    buf.write(_length_delimited(7, graph))
    buf.write(_length_delimited(8, _tag(2, 0) + encode_varint(OPSET)))
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
