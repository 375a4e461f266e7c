"""Minimal protobuf wire-format codec for tf.train.Example and TensorProto.

A copy of `basic_pitch_tpu/data/proto.py` (the port imports nothing of the
JAX package; `tests/test_torch_params.py` pins it equal). The framework
reads and writes the reference's TFRecord schema
(the reference's `basic_pitch/data/tf_example_serialization.py:59-75`)
WITHOUT a TensorFlow dependency: this module implements just enough of the
protobuf wire format (varints, length-delimited fields, packed repeated
scalars) to encode/decode `tf.train.Example` messages and the serialized
`TensorProto` blobs the schema nests inside them. Byte-compatibility with TF
is covered by tests that round-trip against tensorflow when it is available.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

# --- varint / wire primitives ------------------------------------------------


def encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = data[pos]
        result |= (byte & 0x7F) << shift
        pos += 1
        if not byte & 0x80:
            return result, pos
        shift += 7


def _tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def _length_delimited(field_number: int, payload: bytes) -> bytes:
    return _tag(field_number, 2) + encode_varint(len(payload)) + payload


def iter_fields(data: bytes) -> "Iterator[Tuple[int, int, Union[int, bytes]]]":
    """Yield (field_number, wire_type, value) tuples from a message body.

    Length-delimited values are returned as bytes; varints as ints; fixed
    32/64-bit values as raw 4/8 bytes.
    """
    pos = 0
    while pos < len(data):
        key, pos = decode_varint(data, pos)
        field_number, wire_type = key >> 3, key & 7
        if wire_type == 0:  # varint
            value, pos = decode_varint(data, pos)
        elif wire_type == 2:  # length-delimited
            length, pos = decode_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire_type == 5:  # fixed32
            value = data[pos : pos + 4]
            pos += 4
        elif wire_type == 1:  # fixed64
            value = data[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_number, wire_type, value


# --- TensorProto (the subset tf.io.serialize_tensor emits) -------------------

DT_FLOAT = 1
DT_INT32 = 3
DT_STRING = 7
DT_INT64 = 9

_DTYPE_TO_ENUM = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64,
}
_ENUM_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ENUM.items()}


def encode_tensor(array: np.ndarray) -> bytes:
    """Equivalent of tf.io.serialize_tensor for numeric arrays."""
    array = np.asarray(array)
    enum = _DTYPE_TO_ENUM.get(array.dtype)
    if enum is None:
        raise ValueError(f"unsupported tensor dtype {array.dtype}")
    shape_body = b"".join(
        _length_delimited(2, _tag(1, 0) + encode_varint(dim)) for dim in array.shape
    )
    body = _tag(1, 0) + encode_varint(enum)  # dtype
    body += _length_delimited(2, shape_body)  # shape
    body += _length_delimited(4, array.astype(array.dtype.newbyteorder("<")).tobytes())
    return body


def decode_tensor(data: bytes) -> np.ndarray:
    dtype_enum = None
    shape: List[int] = []
    content = b""
    for field, _, value in iter_fields(data):
        if field == 1:
            dtype_enum = value
        elif field == 2:
            for dim_field, _, dim_value in iter_fields(value):
                if dim_field == 2:  # Dim message
                    for inner_field, _, inner_value in iter_fields(dim_value):
                        if inner_field == 1:
                            shape.append(_from_signed_varint(inner_value))
        elif field == 4:
            content = value
    if dtype_enum is None:
        raise ValueError("TensorProto missing dtype")
    dtype = _ENUM_TO_DTYPE[dtype_enum]
    array = np.frombuffer(content, dtype=dtype.newbyteorder("<")).astype(dtype)
    return array.reshape(shape)


def _from_signed_varint(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


# --- tf.train.Example --------------------------------------------------------

FeatureValue = Union[bytes, List[bytes], List[int], List[float], np.ndarray]


def _encode_feature(value: FeatureValue) -> bytes:
    """Encode one tf.train.Feature (bytes_list=1 / float_list=2 / int64_list=3)."""
    if isinstance(value, bytes):
        value = [value]
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if not isinstance(value, list):
        value = [value]
    if all(isinstance(v, bytes) for v in value):
        body = b"".join(_length_delimited(1, v) for v in value)
        return _length_delimited(1, body)
    if all(isinstance(v, (int, np.integer)) for v in value):
        packed = b"".join(encode_varint(v & ((1 << 64) - 1)) for v in value)
        return _length_delimited(3, _length_delimited(1, packed))
    if all(isinstance(v, (float, np.floating)) for v in value):
        packed = struct.pack(f"<{len(value)}f", *value)
        return _length_delimited(2, _length_delimited(1, packed))
    raise ValueError(f"cannot infer feature type for {value!r}")


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize a tf.train.Example with the given feature map."""
    entries = b""
    for name in sorted(features):
        entry = _length_delimited(1, name.encode("utf-8")) + _length_delimited(
            2, _encode_feature(features[name])
        )
        entries += _length_delimited(1, entry)
    return _length_delimited(1, entries)  # Example.features


def decode_example(data: bytes) -> Dict[str, Union[List[bytes], np.ndarray]]:
    """Parse a serialized tf.train.Example into {name: value-list} where
    bytes lists stay lists and numeric lists become numpy arrays."""
    out: Dict[str, Union[List[bytes], np.ndarray]] = {}
    for field, _, features_body in iter_fields(data):
        if field != 1:
            continue
        for entry_field, _, entry in iter_fields(features_body):
            if entry_field != 1:
                continue
            name = None
            feature_body = b""
            for map_field, _, map_value in iter_fields(entry):
                if map_field == 1:
                    name = map_value.decode("utf-8")
                elif map_field == 2:
                    feature_body = map_value
            if name is None:
                continue
            for kind, _, kind_body in iter_fields(feature_body):
                if kind == 1:  # BytesList
                    out[name] = [v for f, _, v in iter_fields(kind_body) if f == 1]
                elif kind == 2:  # FloatList (packed or repeated)
                    values: List[float] = []
                    for f, wt, v in iter_fields(kind_body):
                        if f != 1:
                            continue
                        if wt == 2:
                            values.extend(np.frombuffer(v, dtype="<f4").tolist())
                        else:
                            values.append(struct.unpack("<f", v)[0])
                    out[name] = np.asarray(values, np.float32)
                elif kind == 3:  # Int64List
                    ints: List[int] = []
                    for f, wt, v in iter_fields(kind_body):
                        if f != 1:
                            continue
                        if wt == 2:
                            pos = 0
                            while pos < len(v):
                                value, pos = decode_varint(v, pos)
                                ints.append(_from_signed_varint(value))
                        else:
                            ints.append(_from_signed_varint(v))
                    out[name] = np.asarray(ints, np.int64)
    return out
