"""Runtime-free weight import from the reference's ONNX serialization.

A copy of `basic_pitch_tpu/models/onnx_import.py` (pinned by
`tests/test_torch_params.py`) whose `load_nmp_onnx` returns the flat
{"layer/field": array} dict that `models.params.model_from_flat` takes.

The reference ships the ICASSP-2022 checkpoint as `nmp.onnx` (its
`basic_pitch/inference.py:129-136` loads it through onnxruntime). This module reads the same file WITHOUT onnxruntime or any
protobuf library: the repo's own wire-format walker (`data/proto.py`)
parses the ModelProto, and the NMP parameter tree is reconstructed from
the graph's initializers.

The tf2onnx export is *batch-norm folded*: each Conv2D that the Keras
model followed with a BatchNormalization has the BN's scale multiplied
into its kernel and a single fused bias vector
(``y = conv_scaled(x) + b_fused`` ≡ ``BN(conv(x) + b)``). The importer
therefore emits identity batch-norm parameters for those slots
(gamma=1, beta=0, mean=0, var=1-eps) and stores the fused bias on the
conv — functionally identical to the reference graph, which is what
onnxruntime executes too. The standalone post-CQT BatchNormalization
(no preceding conv) is folded by tf2onnx into a Mul/Add pair; those two
scalars are recovered as (gamma, beta) with mean=0, var=1-eps.

Identification is structural, not name-table-driven: conv kernels are
matched by their unique OIHW shapes, and each conv's bias is simply the
third input of the ``Conv`` node that consumes the kernel (tf2onnx fuses
BiasAdd into the Conv op). The Mul-vs-Add roles of the post-CQT scalars
come from the op type of the consuming node. Verified end-to-end: parameters
loaded here reproduce the golden vocadito posteriorgrams within the
same 1e-4 tolerance as the canonical checkpoint
(tests/test_model_formats.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from basic_pitch_torch.data import proto
from basic_pitch_torch.models import nmp
from basic_pitch_torch.models import params as params_io

# ONNX field numbers (onnx.proto):
#   ModelProto.graph = 7
#   GraphProto.node = 1, GraphProto.initializer = 5
#   NodeProto.input = 1, NodeProto.op_type = 4
#   TensorProto.dims = 1, .data_type = 2, .float_data = 4, .name = 8, .raw_data = 9
_FLOAT = 1  # TensorProto.DataType.FLOAT

# Conv kernel OIHW shape -> (our param name, expects fused BN after it).
# Shapes are unique across the NMP graph (reference models.py:241-318).
_CONV_BY_SHAPE: Dict[Tuple[int, ...], Tuple[str, bool]] = {
    (8, 8, 3, 39): ("contour_conv", True),   # + batch_normalization (8)
    (1, 8, 5, 5): ("contour_out", False),    # "contours-reduced"
    (32, 1, 7, 7): ("note_conv", False),
    (1, 32, 7, 3): ("note_out", False),
    (32, 8, 5, 5): ("onset_conv", True),     # + batch_normalization (32)
    (1, 33, 3, 3): ("onset_out", False),
}


class OnnxFormatError(ValueError):
    """The file is not the expected NMP ONNX serialization."""


def _fields(buf: bytes) -> List[Tuple[int, int, object]]:
    return list(proto.iter_fields(buf))


def _tensor(buf: bytes) -> Tuple[str, Tuple[int, ...], np.ndarray]:
    """Decode an onnx.TensorProto into (name, dims, float32 array) or
    (name, dims, None) for non-float tensors."""
    dims: List[int] = []
    dtype = None
    name = ""
    raw = b""
    floats: List[bytes] = []
    for field, wire, value in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(int(value))
        elif field == 2 and wire == 0:
            dtype = int(value)
        elif field == 8:
            name = value.decode()
        elif field == 9:
            raw += value
        elif field == 4 and wire == 2:
            # packed floats: onnx.proto declares `repeated float float_data
            # = 4 [packed = true]`, so standard encoders emit one
            # length-delimited buffer of little-endian f32s
            floats.append(value)
        elif field == 4 and wire == 5:
            floats.append(value)  # unpacked encoder: one fixed32 per element
    if dtype != _FLOAT:
        return name, tuple(dims), None
    if raw:
        arr = np.frombuffer(raw, dtype="<f4")
    else:
        arr = np.frombuffer(b"".join(floats), dtype="<f4")
    return name, tuple(dims), arr.reshape(tuple(dims)).astype(np.float32)


_identity_bn = nmp.identity_bn_stats  # shared (models/nmp.py)


def looks_like_onnx(path: "str | pathlib.Path") -> bool:
    import pathlib

    p = pathlib.Path(path)
    if not p.is_file():
        return False
    if p.suffix == ".onnx":
        return True
    with p.open("rb") as fh:
        head = fh.read(64)
    # ModelProto begins with ir_version (field 1, varint): tag byte 0x08.
    # Many protobufs share that first byte, so also require a graph field
    # (field 7, length-delimited: tag byte 0x3a) somewhere in the head —
    # cheap enough and keeps non-ONNX protobufs out of the ONNX reader.
    return head[:1] == b"\x08" and b"\x3a" in head


def load_nmp_onnx(path: "str | pathlib.Path") -> Dict[str, np.ndarray]:
    """Read the reference `nmp.onnx` into the flat parameter dict.

    Returns the keys of `params.load_flat()`; batch-norm slots after
    BN-folded convs are identity (see module docstring).
    """
    data = open(path, "rb").read()
    graph = None
    for field, _wire, value in _fields(data):
        if field == 7:
            graph = value
    if graph is None:
        raise OnnxFormatError(f"{path}: no GraphProto in ModelProto")

    initializers: Dict[str, np.ndarray] = {}
    consumers: Dict[str, List[Tuple[str, Tuple[str, ...], int]]] = {}
    for field, _wire, value in _fields(graph):
        if field == 5:
            name, _dims, arr = _tensor(value)
            if arr is not None:
                initializers[name] = arr
        elif field == 1:
            op_type, inputs = "", []
            for nfield, _nwire, nvalue in _fields(value):
                if nfield == 1:
                    inputs.append(nvalue.decode())
                elif nfield == 4:
                    op_type = nvalue.decode()
            for idx, inp in enumerate(inputs):
                consumers.setdefault(inp, []).append((op_type, tuple(inputs), idx))

    params: Dict = {}

    # --- conv layers: kernel by unique shape, bias = the consuming Conv
    # node's third input (tf2onnx fuses BiasAdd into Conv) -------------------
    for name, arr in initializers.items():
        target = _CONV_BY_SHAPE.get(arr.shape)
        if target is None:
            continue
        slot, _fused = target
        uses = [c for c in consumers.get(name, []) if c[0] == "Conv" and c[2] == 1]
        if not uses:
            raise OnnxFormatError(f"{path}: kernel {name} {arr.shape} feeds no Conv node")
        conv_inputs = uses[0][1]
        if len(conv_inputs) < 3 or conv_inputs[2] not in initializers:
            raise OnnxFormatError(f"{path}: Conv for {slot} has no bias initializer input")
        bias = initializers[conv_inputs[2]]
        if bias.ndim != 1 or bias.shape[0] != arr.shape[0]:
            raise OnnxFormatError(f"{path}: bias shape {bias.shape} mismatches {slot}")
        if slot in params:
            raise OnnxFormatError(f"{path}: duplicate conv shape for {slot}")
        # OIHW -> HWIO
        params[slot] = {
            "w": np.ascontiguousarray(arr.transpose(2, 3, 1, 0)),
            "b": bias,
        }

    missing = [s for s, _ in _CONV_BY_SHAPE.values() if s not in params]
    if missing:
        raise OnnxFormatError(f"{path}: missing conv layers {missing}")

    # --- folded batch norms -> identity; post-CQT BN from the Mul/Add pair --
    params["bn_contour"] = _identity_bn(params["contour_conv"]["b"].shape[0])
    params["bn_onset"] = _identity_bn(params["onset_conv"]["b"].shape[0])

    gamma = beta = None
    for name, arr in initializers.items():
        if "batch_normalization/FusedBatchNormV3" not in name or arr.size != 1:
            continue
        ops = {c[0] for c in consumers.get(name, [])}
        if "Mul" in ops:
            gamma = arr.reshape(1)
        elif "Add" in ops:
            beta = arr.reshape(1)
    if gamma is None or beta is None:
        raise OnnxFormatError(f"{path}: post-CQT BatchNormalization Mul/Add pair not found")
    params["bn_cqt"] = {
        "gamma": gamma.astype(np.float32),
        "beta": beta.astype(np.float32),
        "mean": np.zeros(1, np.float32),
        "var": np.full(1, 1.0 - nmp.BN_EPSILON, np.float32),
    }
    return params_io.flatten_params(params)
