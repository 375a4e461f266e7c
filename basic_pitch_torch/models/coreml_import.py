"""Runtime-free weight import from the reference's CoreML serialization.

A copy of `basic_pitch_tpu/models/coreml_import.py` (pinned by
`tests/test_torch_params.py`) whose `load_nmp_coreml` returns the flat
{"layer/field": array} dict that `models.params.model_from_flat` takes.

The reference ships the ICASSP-2022 checkpoint as `nmp.mlpackage` and loads
it with coremltools (its `basic_pitch/inference.py:96-100`).
This module reads the same package WITHOUT coremltools: the repo's
protobuf walker (`data/proto.py`) decodes the ML Program (MILSpec) inside
`model.mlmodel`, and the tensors referenced from `weights/weight.bin` are
read directly from coremltools' blob-storage format (64-byte-aligned
records of ``{u32 0xDEADBEEF sentinel, u32 dtype, u64 size, u64 data
offset}``).

The coremltools converter folds the two conv-adjacent batch norms into
their convs (fused weight/bias, like the ONNX and TFLite exports), but
keeps the standalone post-CQT BatchNormalization as a real ``batch_norm``
MIL op — so this importer recovers genuine (gamma, beta, mean, variance)
for `bn_cqt` and emits identity batch norms for the folded slots.

Identification is structural: MIL ``conv`` ops name their weight and bias
constants directly in the op's input bindings; the six NMP head convs are
told apart from the 26 CQT-cascade convs by their unique OIHW element
counts. Verified end-to-end against the golden posteriorgrams in
tests/test_model_formats.py.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from basic_pitch_torch.data import proto
from basic_pitch_torch.models import nmp
from basic_pitch_torch.models import params as params_io

# element count -> (our param slot, OIHW shape). Counts are unique across
# the NMP graph, including the CQT-cascade convs (9216/256-element kernels).
_CONV_BY_SIZE: Dict[int, Tuple[str, Tuple[int, ...]]] = {
    7488: ("contour_conv", (8, 8, 3, 39)),
    200: ("contour_out", (1, 8, 5, 5)),
    1568: ("note_conv", (32, 1, 7, 7)),
    672: ("note_out", (1, 32, 7, 3)),
    6400: ("onset_conv", (32, 8, 5, 5)),
    297: ("onset_out", (1, 33, 3, 3)),
}

_BLOB_SENTINEL = 0xDEADBEEF
_BLOB_DTYPE_F32 = 2


class CoremlFormatError(ValueError):
    """The file is not the expected NMP CoreML serialization."""


def _fields(buf: bytes) -> List[Tuple[int, int, object]]:
    return list(proto.iter_fields(buf))


def _one(buf: bytes, field: int) -> Optional[bytes]:
    out = None
    for f, _w, v in _fields(buf):
        if f == field:
            out = v
    return out


def looks_like_mlpackage(path: "str | pathlib.Path") -> bool:
    p = pathlib.Path(path)
    return (p / "Data" / "com.apple.CoreML").is_dir() or p.suffix == ".mlmodel"


def _locate(path) -> Tuple[pathlib.Path, pathlib.Path]:
    """Resolve (model.mlmodel, weight.bin) from a .mlpackage dir or .mlmodel."""
    p = pathlib.Path(path)
    if p.is_dir():
        model = p / "Data" / "com.apple.CoreML" / "model.mlmodel"
        weights = p / "Data" / "com.apple.CoreML" / "weights" / "weight.bin"
    else:
        model = p
        weights = p.parent / "weights" / "weight.bin"
    if not model.is_file():
        raise CoremlFormatError(f"{path}: no model.mlmodel found")
    return model, weights


class _BlobFile:
    def __init__(self, path: pathlib.Path):
        if not path.is_file():
            raise CoremlFormatError(f"{path}: weight blob file missing")
        self.data = path.read_bytes()

    def read_f32(self, meta_offset: int) -> np.ndarray:
        sentinel, dtype = struct.unpack_from("<II", self.data, meta_offset)
        size, data_offset = struct.unpack_from("<QQ", self.data, meta_offset + 8)
        if sentinel != _BLOB_SENTINEL:
            raise CoremlFormatError(f"bad blob sentinel at {meta_offset}")
        if dtype != _BLOB_DTYPE_F32:
            raise CoremlFormatError(f"unsupported blob dtype {dtype} at {meta_offset}")
        return np.frombuffer(self.data, "<f4", count=size // 4, offset=data_offset).copy()


def _decode_value(value: bytes, blobs: Optional[_BlobFile]) -> Optional[np.ndarray]:
    """MILSpec.Value -> flat float32 array (None for non-float values)."""
    immediate = blob_ref = None
    for f, _w, v in _fields(value):
        if f == 3:
            immediate = v
        elif f == 5:
            blob_ref = v
    if blob_ref is not None:
        if blobs is None:
            raise CoremlFormatError("value references weight.bin but it is missing")
        offset_bytes = _one(blob_ref, 2)
        offset = offset_bytes if isinstance(offset_bytes, int) else 0
        return blobs.read_f32(offset)
    if immediate is None:
        return None
    tensor = _one(immediate, 1)  # ImmediateValue.tensor
    if tensor is None:
        return None
    floats = _one(tensor, 1)  # TensorValue.floats -> RepeatedFloats
    if floats is None:
        return None
    out: List[float] = []
    for f, w, v in _fields(floats):  # RepeatedFloats.values (packed or not)
        if f != 1:
            continue
        if w == 2:
            out.extend(np.frombuffer(v, "<f4"))
        elif w == 5:
            out.append(struct.unpack("<f", v)[0])
    return np.asarray(out, np.float32)


def _parse_op(op: bytes) -> Tuple[str, Dict[str, str], Dict[str, bytes]]:
    """Operation -> (type, {input_name: bound const/op name}, {attr: Value})."""
    op_type = ""
    inputs: Dict[str, str] = {}
    attrs: Dict[str, bytes] = {}
    outputs: List[str] = []
    for f, _w, v in _fields(op):
        if f == 1:
            op_type = v.decode()
        elif f == 2:  # map<string, Argument>
            key = arg = None
            for ef, _ew, ev in _fields(v):
                if ef == 1:
                    key = ev.decode()
                elif ef == 2:
                    arg = ev
            if key is None or arg is None:
                continue
            for bf, _bw, bv in _fields(arg):  # Argument.arguments (Binding)
                if bf != 1:
                    continue
                name = _one(bv, 1)  # Binding.name
                if isinstance(name, bytes):
                    inputs[key] = name.decode()
        elif f == 3:  # outputs: NamedValueType.name = 1
            name = _one(v, 1)
            if isinstance(name, bytes):
                outputs.append(name.decode())
        elif f == 5:  # attributes map<string, Value>
            key = val = None
            for ef, _ew, ev in _fields(v):
                if ef == 1:
                    key = ev.decode()
                elif ef == 2:
                    val = ev
            if key is not None and val is not None:
                attrs[key] = val
    attrs["__outputs__"] = b"\x00".join(o.encode() for o in outputs)
    return op_type, inputs, attrs


_identity_bn = nmp.identity_bn_stats  # shared (models/nmp.py)


def load_nmp_coreml(path: "str | pathlib.Path") -> Dict[str, np.ndarray]:
    """Read the reference `nmp.mlpackage` into the flat parameter dict.

    Returns the keys of `params.load_flat()`; the two
    converter-folded batch-norm slots are identity (see module docstring),
    while `bn_cqt` carries the true stored statistics from the MIL batch_norm op.
    """
    model_path, weights_path = _locate(path)
    blobs = _BlobFile(weights_path) if weights_path.is_file() else None
    data = model_path.read_bytes()

    program = _one(data, 502)  # Model.mlProgram
    if program is None:
        raise CoremlFormatError(f"{path}: not an ML Program model")

    # Program.functions -> Function.block_specializations -> Block.operations
    ops: List[bytes] = []
    for f, _w, v in _fields(program):
        if f != 2:
            continue
        fn = _one(v, 2)  # map entry value: Function
        if fn is None:
            continue
        for ff, _fw, fv in _fields(fn):
            if ff != 3:
                continue
            block = _one(fv, 2)  # map entry value: Block
            if block is None:
                continue
            for bf, _bw, bv in _fields(block):
                if bf == 3:
                    ops.append(bv)

    consts: Dict[str, np.ndarray] = {}
    convs: List[Dict[str, str]] = []
    batch_norms: List[Dict[str, str]] = []
    for op in ops:
        op_type, inputs, attrs = _parse_op(op)
        if op_type == "const":
            val = attrs.get("val")
            outputs = attrs["__outputs__"].decode().split("\x00")
            if val is not None and outputs and outputs[0]:
                arr = _decode_value(val, blobs)
                if arr is not None:
                    consts[outputs[0]] = arr
        elif op_type == "conv":
            convs.append(inputs)
        elif op_type == "batch_norm":
            batch_norms.append(inputs)

    params: Dict = {}
    for conv in convs:
        weight = consts.get(conv.get("weight", ""))
        if weight is None:
            continue
        target = _CONV_BY_SIZE.get(weight.size)
        if target is None:
            continue  # CQT-cascade conv
        slot, oihw = target
        bias = consts.get(conv.get("bias", ""))
        if bias is None or bias.size != oihw[0]:
            raise CoremlFormatError(f"{path}: bad bias for {slot}")
        if slot in params:
            raise CoremlFormatError(f"{path}: duplicate conv size for {slot}")
        params[slot] = {
            # OIHW -> HWIO
            "w": np.ascontiguousarray(weight.reshape(oihw).transpose(2, 3, 1, 0)),
            "b": bias.astype(np.float32),
        }

    missing = [s for s, _ in _CONV_BY_SIZE.values() if s not in params]
    if missing:
        raise CoremlFormatError(f"{path}: missing conv layers {missing}")

    if len(batch_norms) != 1:
        raise CoremlFormatError(
            f"{path}: expected exactly one standalone batch_norm, found {len(batch_norms)}"
        )
    bn = batch_norms[0]
    stats = {}
    for ours, theirs in (("gamma", "gamma"), ("beta", "beta"), ("mean", "mean"), ("var", "variance")):
        arr = consts.get(bn.get(theirs, ""))
        if arr is None:
            raise CoremlFormatError(f"{path}: batch_norm is missing {theirs}")
        stats[ours] = arr.reshape(-1).astype(np.float32)
    eps_arr = consts.get(bn.get("epsilon", ""))
    if eps_arr is not None and eps_arr.size == 1:
        # our _batch_norm adds BN_EPSILON to the stored variance; absorb any
        # difference between the serialized epsilon and ours into var
        stats["var"] = stats["var"] + (float(eps_arr[0]) - nmp.BN_EPSILON)
    params["bn_cqt"] = stats
    params["bn_contour"] = _identity_bn(params["contour_conv"]["b"].shape[0])
    params["bn_onset"] = _identity_bn(params["onset_conv"]["b"].shape[0])
    return params_io.flatten_params(params)
