"""TFRecord container format: framing + masked CRC32C, no TF dependency.

Record layout (little-endian):
    uint64 length
    uint32 masked_crc32c(length)
    bytes  data[length]
    uint32 masked_crc32c(data)

Files written here are readable by TensorFlow's TFRecordDataset and vice
versa. A copy of `basic_pitch_tpu/data/tfrecord.py`: the checksum is the
native library's slice-by-8 CRC32C when it is built (`native.crc32c`),
else the table-driven loop; `tests/test_torch_params.py` pins both equal to
the JAX package's result.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Iterator, Union

import numpy as np

PathLike = Union[str, pathlib.Path]

_CRC32C_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli); native slice-by-8 when the library is built."""
    from basic_pitch_torch import native

    fast = native.crc32c(data)
    if fast is not None:
        return fast
    return crc32c_table(data)


def crc32c_table(data: bytes) -> int:
    """CRC-32C, one table lookup per byte: the plain version."""
    crc = 0xFFFFFFFF
    table = _TABLE
    for byte in data:
        crc = (crc >> 8) ^ int(table[(crc ^ byte) & 0xFF])
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset CRC mask."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    def __init__(self, path: PathLike):
        self._fh = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", masked_crc(header)))
        self._fh.write(record)
        self._fh.write(struct.pack("<I", masked_crc(record)))

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(path: PathLike, verify: bool = False) -> Iterator[bytes]:
    """Iterate raw records. With verify=True, checks both CRCs."""
    with open(path, "rb") as fh:
        while True:
            header = fh.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            header_crc_raw = fh.read(4)
            record = fh.read(length)
            record_crc_raw = fh.read(4)
            # validate read sizes BEFORE unpacking: a file cut mid-record
            # must raise the truncation IOError, not struct.error
            if len(header_crc_raw) < 4 or len(record) < length or len(record_crc_raw) < 4:
                raise IOError(f"truncated record in {path}")
            (header_crc,) = struct.unpack("<I", header_crc_raw)
            (record_crc,) = struct.unpack("<I", record_crc_raw)
            if verify:
                if masked_crc(header) != header_crc:
                    raise IOError(f"corrupt length CRC in {path}")
                if masked_crc(record) != record_crc:
                    raise IOError(f"corrupt record CRC in {path}")
            yield record
