"""Runtime-free weight import from the reference's TFLite serialization.

A copy of `basic_pitch_tpu/models/tflite_import.py` (pinned by
`tests/test_torch_params.py`) whose `load_nmp_tflite` returns the flat
{"layer/field": array} dict that `models.params.model_from_flat` takes.

The reference ships the ICASSP-2022 checkpoint as `nmp.tflite` and loads it
with the tflite-runtime interpreter (its `basic_pitch/inference.py:112-117`). This module reads the same file WITHOUT any TFLite
or flatbuffers dependency: a ~70-line flatbuffer walker decodes just the
tables the TFLite schema stores weights in (Model -> SubGraph -> Tensor /
Operator / Buffer).

Like the ONNX export (see `onnx_import.py`), the TFLite converter folds
batch norms: conv kernels arrive pre-scaled with a fused bias, and the
standalone post-CQT BatchNormalization becomes a scalar MUL/ADD pair. The
importer reconstructs the same functionally-identical parameter tree:
fused biases on the convs, identity batch-norm slots, and the post-CQT
(gamma, beta) recovered from the MUL/ADD constants.

Identification is structural: CONV_2D operators carry their filter as
input 1 (OHWI layout) and bias as input 2; the six NMP conv filters are
matched by their unique shapes. Only the post-CQT scalar pair is matched
by tensor name (`batch_normalization/FusedBatchNormV3`), disambiguated
by the consuming op (MUL -> gamma, ADD -> beta) exactly as in the ONNX
path. Verified end-to-end against the golden posteriorgrams in
tests/test_model_formats.py.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from basic_pitch_torch.models import nmp
from basic_pitch_torch.models import params as params_io

_TFLITE_MAGIC = b"TFL3"
_FLOAT32 = 0
_BUILTIN_ADD = 0
_BUILTIN_CONV_2D = 3
_BUILTIN_MUL = 18

# OHWI filter shape -> our param slot (shapes unique; reference models.py)
_CONV_BY_SHAPE: Dict[Tuple[int, ...], str] = {
    (8, 3, 39, 8): "contour_conv",
    (1, 5, 5, 8): "contour_out",
    (32, 7, 7, 1): "note_conv",
    (1, 7, 3, 32): "note_out",
    (32, 5, 5, 8): "onset_conv",
    (1, 3, 3, 33): "onset_out",
}


class TfliteFormatError(ValueError):
    """The file is not the expected NMP TFLite serialization."""


class _FlatBuffer:
    """Minimal flatbuffer reader: tables, vtables, vectors, strings."""

    def __init__(self, data: bytes):
        self.d = data

    def u16(self, p: int) -> int:
        return struct.unpack_from("<H", self.d, p)[0]

    def i32(self, p: int) -> int:
        return struct.unpack_from("<i", self.d, p)[0]

    def u32(self, p: int) -> int:
        return struct.unpack_from("<I", self.d, p)[0]

    def indirect(self, p: int) -> int:
        return p + self.u32(p)

    def root(self) -> int:
        return self.indirect(0)

    def field(self, table: int, fid: int) -> Optional[int]:
        """Absolute position of field `fid` in `table`, or None if absent."""
        vtable = table - self.i32(table)
        slot = 4 + 2 * fid
        if slot + 2 > self.u16(vtable):
            return None
        off = self.u16(vtable + slot)
        return table + off if off else None

    def vector(self, p: int) -> Tuple[int, int]:
        """(length, base) of the vector whose offset field is at p."""
        v = self.indirect(p)
        return self.u32(v), v + 4

    def table_vector(self, table: int, fid: int) -> List[int]:
        p = self.field(table, fid)
        if p is None:
            return []
        n, base = self.vector(p)
        return [self.indirect(base + 4 * i) for i in range(n)]

    def i32_vector(self, table: int, fid: int) -> List[int]:
        p = self.field(table, fid)
        if p is None:
            return []
        n, base = self.vector(p)
        return [self.i32(base + 4 * i) for i in range(n)]

    def string(self, table: int, fid: int) -> str:
        p = self.field(table, fid)
        if p is None:
            return ""
        n, base = self.vector(p)
        return self.d[base : base + n].decode("utf-8", "replace")

    def scalar_u32(self, table: int, fid: int, default: int = 0) -> int:
        p = self.field(table, fid)
        return self.u32(p) if p is not None else default

    def scalar_u8(self, table: int, fid: int, default: int = 0) -> int:
        p = self.field(table, fid)
        return self.d[p] if p is not None else default

    def scalar_i8(self, table: int, fid: int, default: int = 0) -> int:
        p = self.field(table, fid)
        return struct.unpack_from("<b", self.d, p)[0] if p is not None else default


def looks_like_tflite(path: "str | pathlib.Path") -> bool:
    import pathlib

    p = pathlib.Path(path)
    if not p.is_file():
        return False
    head = p.open("rb").read(8)
    return head[4:8] == _TFLITE_MAGIC


_identity_bn = nmp.identity_bn_stats  # shared (models/nmp.py)


def load_nmp_tflite(path: "str | pathlib.Path") -> Dict[str, np.ndarray]:
    """Read the reference `nmp.tflite` into the flat parameter dict.

    Returns the keys of `params.load_flat()`; batch-norm slots after
    converter-folded convs are identity (see module docstring).
    """
    data = open(path, "rb").read()
    if data[4:8] != _TFLITE_MAGIC:
        raise TfliteFormatError(f"{path}: missing TFL3 magic")
    fb = _FlatBuffer(data)
    model = fb.root()

    # Model: operator_codes=1, subgraphs=2, buffers=4
    opcodes: List[int] = []
    for oc in fb.table_vector(model, 1):
        # OperatorCode: deprecated_builtin_code=0 (int8), builtin_code=3 (int32)
        p3 = fb.field(oc, 3)
        opcodes.append(fb.i32(p3) if p3 is not None else fb.scalar_i8(oc, 0))

    buffers: List[bytes] = []
    for b in fb.table_vector(model, 4):
        p = fb.field(b, 0)
        if p is None:
            buffers.append(b"")
        else:
            n, base = fb.vector(p)
            buffers.append(data[base : base + n])

    subgraphs = fb.table_vector(model, 2)
    if not subgraphs:
        raise TfliteFormatError(f"{path}: no subgraphs")
    sg = subgraphs[0]

    # SubGraph: tensors=0, operators=3 — Tensor: shape=0, type=1, buffer=2, name=3
    tensors: List[Tuple[Tuple[int, ...], int, str, bytes]] = []
    for t in fb.table_vector(sg, 0):
        shape = tuple(fb.i32_vector(t, 0))
        ttype = fb.scalar_u8(t, 1, _FLOAT32)
        buf = fb.scalar_u32(t, 2, 0)
        name = fb.string(t, 3)
        raw = buffers[buf] if buf < len(buffers) else b""
        tensors.append((shape, ttype, name, raw))

    def const_f32(idx: int) -> Optional[np.ndarray]:
        if not 0 <= idx < len(tensors):
            return None
        shape, ttype, _name, raw = tensors[idx]
        if ttype != _FLOAT32 or not raw:
            return None
        return np.frombuffer(raw, "<f4").reshape(shape or (1,)).astype(np.float32)

    params: Dict = {}
    gamma = beta = None
    for op in fb.table_vector(sg, 3):
        # Operator: opcode_index=0, inputs=1
        code = opcodes[fb.scalar_u32(op, 0, 0)]
        inputs = fb.i32_vector(op, 1)
        if code == _BUILTIN_CONV_2D and len(inputs) >= 3:
            filt = const_f32(inputs[1])
            if filt is None:
                continue
            slot = _CONV_BY_SHAPE.get(filt.shape)
            if slot is None:
                continue  # a CQT-cascade conv, not a model head
            bias = const_f32(inputs[2])
            if bias is None or bias.shape != (filt.shape[0],):
                raise TfliteFormatError(f"{path}: bad bias for {slot}")
            if slot in params:
                raise TfliteFormatError(f"{path}: duplicate conv shape for {slot}")
            # OHWI -> HWIO
            params[slot] = {
                "w": np.ascontiguousarray(filt.transpose(1, 2, 3, 0)),
                "b": bias,
            }
        elif code in (_BUILTIN_MUL, _BUILTIN_ADD):
            for idx in inputs:
                arr = const_f32(idx)
                if arr is None or arr.size != 1:
                    continue
                name = tensors[idx][2]
                if "batch_normalization/FusedBatchNormV3" not in name:
                    continue
                if code == _BUILTIN_MUL:
                    gamma = arr.reshape(1)
                else:
                    beta = arr.reshape(1)

    missing = [s for s in _CONV_BY_SHAPE.values() if s not in params]
    if missing:
        raise TfliteFormatError(f"{path}: missing conv layers {missing}")
    if gamma is None or beta is None:
        raise TfliteFormatError(f"{path}: post-CQT BatchNormalization MUL/ADD pair not found")

    params["bn_contour"] = _identity_bn(params["contour_conv"]["b"].shape[0])
    params["bn_onset"] = _identity_bn(params["onset_conv"]["b"].shape[0])
    params["bn_cqt"] = {
        "gamma": gamma,
        "beta": beta,
        "mean": np.zeros(1, np.float32),
        "var": np.full(1, 1.0 - nmp.BN_EPSILON, np.float32),
    }
    return params_io.flatten_params(params)
