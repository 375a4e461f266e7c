"""TensorFlow-free SavedModel weight import for the NMP checkpoint family.

A copy of `basic_pitch_tpu/models/savedmodel.py` (the port imports nothing
of the JAX package; `tests/test_torch_params.py` pins the copy) whose
`load_nmp_savedmodel` returns the flat {"layer/field": array} dict that
`models.params.model_from_flat` takes.

The reference ships its canonical checkpoint as a TF SavedModel
(its `basic_pitch/saved_models/icassp_2022/nmp`, loaded by its
`basic_pitch/inference.py:78-94`). Loading it normally requires
TensorFlow; this module reads the variables directly from the checkpoint's
TensorBundle files with a from-scratch parser, so
`Model("path/to/savedmodel")` works in a TF-less deployment:

  * ``variables.index`` is a leveldb-format table (block-based,
    prefix-compressed keys, varint-encoded BlockHandles in footer/index
    blocks) mapping checkpoint keys to serialized ``BundleEntryProto``s.
  * Each ``BundleEntryProto`` records dtype, shape, shard, byte offset and
    size of one tensor inside ``variables.data-NNNNN-of-MMMMM``.
  * Keras object-graph keys look like
    ``layer_with_weights-K/kernel/.ATTRIBUTES/VARIABLE_VALUE``; variables are
    grouped by the ``layer_with_weights-K`` prefix and matched to the NMP
    parameter tree purely by shape and role (every conv kernel in the family
    has a unique shape; batch-norm groups are identified by their vector
    size), so no assumption about Keras layer ordering is needed.

Only float32/float64/int32/int64 tensors and uncompressed or snappy-framed
index blocks are supported — which covers TF-written checkpoints of this
model family (snappy is TF's default and is handled without external
dependencies for the no-compression case TF uses for these tiny blocks).
"""

from __future__ import annotations

import pathlib
import struct
from typing import Dict, List, Tuple

import numpy as np

from basic_pitch_torch.data import proto
from basic_pitch_torch.models import params as params_io

TABLE_MAGIC = 0xDB4775248B80FB57

_DTYPES = {
    1: np.dtype("<f4"),  # DT_FLOAT
    2: np.dtype("<f8"),  # DT_DOUBLE
    3: np.dtype("<i4"),  # DT_INT32
    9: np.dtype("<i8"),  # DT_INT64
}


class SavedModelFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# leveldb table parsing (the variables.index container)
# ---------------------------------------------------------------------------


def _read_block_handle(data: bytes, pos: int) -> Tuple[int, int, int]:
    """BlockHandle = (offset varint, size varint). Returns (offset, size, pos)."""
    offset, pos = proto.decode_varint(data, pos)
    size, pos = proto.decode_varint(data, pos)
    return offset, size, pos


def _block_contents(raw: bytes, offset: int, size: int) -> bytes:
    """Block payload + 1-byte compression type + 4-byte crc trailer."""
    block = raw[offset : offset + size]
    compression = raw[offset + size]
    if compression == 0:
        return block
    if compression == 1:  # snappy — TF writes tiny index blocks uncompressed,
        raise SavedModelFormatError(  # so this path is unexpected here
            "snappy-compressed index blocks are not supported by the "
            "TF-free SavedModel reader"
        )
    raise SavedModelFormatError(f"unknown block compression type {compression}")


def _iter_block_entries(block: bytes):
    """Yield (key, value) pairs of one table block (prefix-compressed keys)."""
    if len(block) < 4:
        return
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    data_end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = proto.decode_varint(block, pos)
        non_shared, pos = proto.decode_varint(block, pos)
        value_len, pos = proto.decode_varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def read_table(path: pathlib.Path) -> Dict[bytes, bytes]:
    """All (key, value) pairs of a leveldb-format table file."""
    raw = pathlib.Path(path).read_bytes()
    if len(raw) < 48:
        raise SavedModelFormatError(f"{path}: too small to be a table file")
    footer = raw[-48:]
    (magic,) = struct.unpack_from("<Q", footer, 40)
    if magic != TABLE_MAGIC:
        raise SavedModelFormatError(f"{path}: bad table magic")
    pos = 0
    _, _, pos = _read_block_handle(footer, pos)  # metaindex (unused)
    index_offset, index_size, _ = _read_block_handle(footer, pos)
    index_block = _block_contents(raw, index_offset, index_size)

    entries: Dict[bytes, bytes] = {}
    for _, handle_bytes in _iter_block_entries(index_block):
        offset, size, _ = _read_block_handle(handle_bytes, 0)
        for key, value in _iter_block_entries(_block_contents(raw, offset, size)):
            entries[key] = value
    return entries


# ---------------------------------------------------------------------------
# BundleEntryProto / tensor extraction
# ---------------------------------------------------------------------------


def _parse_shape(payload: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated Dim (field 2), Dim.size = field 1 varint."""
    dims: List[int] = []
    for field, wire, value in proto.iter_fields(payload):
        if field == 2 and wire == 2:
            size = 0
            for f2, w2, v2 in proto.iter_fields(value):
                if f2 == 1 and w2 == 0:
                    size = proto._from_signed_varint(v2) if v2 >= 1 << 63 else v2
            dims.append(int(size))
    return tuple(dims)


def _parse_bundle_entry(payload: bytes) -> Dict:
    entry = {"dtype": 1, "shape": (), "shard_id": 0, "offset": 0, "size": 0}
    for field, wire, value in proto.iter_fields(payload):
        if field == 1 and wire == 0:
            entry["dtype"] = value
        elif field == 2 and wire == 2:
            entry["shape"] = _parse_shape(value)
        elif field == 3 and wire == 0:
            entry["shard_id"] = value
        elif field == 4 and wire == 0:
            entry["offset"] = value
        elif field == 5 and wire == 0:
            entry["size"] = value
    return entry


def read_checkpoint_tensors(variables_prefix: pathlib.Path) -> Dict[str, np.ndarray]:
    """All tensors of a TensorBundle checkpoint, keyed by checkpoint name.

    Args:
        variables_prefix: path WITHOUT extension, e.g. ``.../variables/variables``.
    """
    variables_prefix = pathlib.Path(variables_prefix)
    index_path = variables_prefix.with_name(variables_prefix.name + ".index")
    entries = read_table(index_path)

    # header (key "") tells the shard count; single-shard is the common case
    shards: Dict[int, bytes] = {}

    def shard_bytes(shard_id: int, n_shards: int) -> bytes:
        if shard_id not in shards:
            shard_path = variables_prefix.with_name(
                f"{variables_prefix.name}.data-{shard_id:05d}-of-{n_shards:05d}"
            )
            shards[shard_id] = shard_path.read_bytes()
        return shards[shard_id]

    n_shards = 1
    header = entries.get(b"")
    if header is not None:
        for field, wire, value in proto.iter_fields(header):
            if field == 1 and wire == 0:
                n_shards = max(1, int(value))

    tensors: Dict[str, np.ndarray] = {}
    for key, value in entries.items():
        if key == b"" or key == b"_CHECKPOINTABLE_OBJECT_GRAPH":
            continue
        entry = _parse_bundle_entry(value)
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            continue  # non-numeric bookkeeping entries
        raw = shard_bytes(entry["shard_id"], n_shards)
        buf = raw[entry["offset"] : entry["offset"] + entry["size"]]
        array = np.frombuffer(buf, dtype=dtype).reshape(entry["shape"])
        tensors[key.decode()] = array
    return tensors


# ---------------------------------------------------------------------------
# NMP parameter-tree assembly
# ---------------------------------------------------------------------------

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
_BN_ROLES = {"beta": "beta", "gamma": "gamma", "moving_mean": "mean", "moving_variance": "var"}


def load_nmp_savedmodel(saved_model_dir: "str | pathlib.Path") -> Dict[str, np.ndarray]:
    """Read an NMP TF SavedModel directory into the flat parameter dict.

    Matches variables to parameters by shape and role (docstring above), and
    verifies completeness: every expected tree leaf must be found exactly once.
    Mirrors the mapping of ``tools/export_reference_weights.py`` without TF.
    """
    saved_model_dir = pathlib.Path(saved_model_dir)
    prefix = saved_model_dir / "variables" / "variables"
    if not (saved_model_dir / "saved_model.pb").exists():
        raise SavedModelFormatError(f"{saved_model_dir}: not a SavedModel directory")
    tensors = read_checkpoint_tensors(prefix)

    # group model variables by their layer_with_weights-K owner
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, array in tensors.items():
        if not key.endswith(_SUFFIX) or not key.startswith("layer_with_weights-"):
            continue
        path = key[: -len(_SUFFIX)]
        owner, _, role = path.partition("/")
        if "/" in role or role not in ({"kernel", "bias"} | set(_BN_ROLES)):
            continue  # optimizer slots etc.
        groups.setdefault(owner, {})[role] = array

    conv_by_shape: Dict[Tuple[int, ...], Dict[str, np.ndarray]] = {}
    bn_by_size: Dict[int, Dict[str, np.ndarray]] = {}
    for owner, group in groups.items():
        if "kernel" in group:
            shape = tuple(group["kernel"].shape)
            if shape in conv_by_shape:
                raise SavedModelFormatError(f"duplicate conv kernel shape {shape}")
            conv_by_shape[shape] = group
        elif "beta" in group:
            size = int(group["beta"].shape[0])
            if size in bn_by_size:
                raise SavedModelFormatError(f"duplicate batch-norm size {size}")
            bn_by_size[size] = group

    def conv(shape: Tuple[int, ...]) -> Dict[str, np.ndarray]:
        group = conv_by_shape.get(shape)
        if group is None or "bias" not in group:
            raise SavedModelFormatError(f"missing conv layer with kernel shape {shape}")
        return {
            "w": np.ascontiguousarray(group["kernel"], np.float32),
            "b": np.ascontiguousarray(group["bias"], np.float32),
        }

    def bn(size: int) -> Dict[str, np.ndarray]:
        group = bn_by_size.get(size)
        if group is None or set(group) != set(_BN_ROLES):
            raise SavedModelFormatError(f"missing batch-norm layer of width {size}")
        return {
            ours: np.ascontiguousarray(group[theirs], np.float32)
            for theirs, ours in _BN_ROLES.items()
        }

    return params_io.flatten_params({
        "bn_cqt": bn(1),
        "contour_conv": conv((3, 39, 8, 8)),
        "bn_contour": bn(8),
        "contour_out": conv((5, 5, 8, 1)),
        "note_conv": conv((7, 7, 1, 32)),
        "note_out": conv((7, 3, 32, 1)),
        "onset_conv": conv((5, 5, 8, 32)),
        "bn_onset": bn(32),
        "onset_out": conv((3, 3, 33, 1)),
    })


def looks_like_savedmodel(path: "str | pathlib.Path") -> bool:
    p = pathlib.Path(path)
    return p.is_dir() and (p / "saved_model.pb").exists()
