"""The native host library: WAV decode with mixdown, pure decimation and
CRC32C in C++ (`csrc/bp_native.cpp`), bound with ctypes.

PyTorch counterpart of `basic_pitch_tpu/native/__init__.py`, with its rules:
the library is built with g++ at first use (by `_build.py`, into
``basic_pitch_torch/build/``), each entry point returns None when the
library is unavailable or the input is one it does not claim, and the
caller then takes its numpy path, which stays the plain version. When the
library cannot be built, that is logged once at WARNING; `available()`
says whether it was. `calls` counts the calls the library served, per
entry point, so a run can show that none took the numpy path.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

# calls served natively in this process, per entry point
calls: Dict[str, int] = {"decode_pcm_mono": 0, "resample_poly": 0, "crc32c": 0}


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32, u32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32
    ptr = ctypes.c_void_p
    for name in ("decode_pcm16_mono", "decode_pcm24_mono", "decode_pcm32_mono", "decode_float32_mono"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, i64, i32, ptr]
        fn.restype = None
    lib.resample_poly_f32.argtypes = [ptr, i64, i32, i32, ptr, i32, ptr, i64]
    lib.resample_poly_f32.restype = None
    lib.resample_down_f32.argtypes = [ptr, i64, i32, ptr, i32, ptr, i64]
    lib.resample_down_f32.restype = None
    lib.crc32c.argtypes = [ptr, i64]
    lib.crc32c.restype = u32


def load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None when it cannot be built
    (logged once at WARNING, and not retried in this process)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    from basic_pitch_torch import _build

    with _lock:
        if _lib is None and _error is None:
            try:
                lib = _build.load("bp_native")
                _bind(lib)
                _lib = lib
            except (RuntimeError, OSError, AttributeError) as exc:
                _error = str(exc)
                logger.warning("native host library unavailable, using the numpy paths: %s", exc)
    return _lib


def available() -> bool:
    return load() is not None


def _count(name: str) -> None:
    with _lock:
        calls[name] += 1


def _as_ptr(array: np.ndarray) -> ctypes.c_void_p:
    return array.ctypes.data_as(ctypes.c_void_p)


def decode_pcm_mono(payload: bytes, bits: int, is_float: bool, n_channels: int) -> Optional[np.ndarray]:
    """Interleaved PCM (16/24/32-bit) or IEEE float32 payload -> float32
    mono (channel mean), or None when the library is unavailable or the
    format is not one of those."""
    if is_float and bits != 32:
        return None
    if is_float:
        itemsize, name = 4, "decode_float32_mono"
    elif bits in (16, 24, 32):
        itemsize, name = bits // 8, f"decode_pcm{bits}_mono"
    else:
        return None
    if n_channels < 1:
        return None
    lib = load()
    if lib is None:
        return None
    n_frames = len(payload) // (itemsize * n_channels)
    out = np.empty(n_frames, np.float32)
    if n_frames:
        raw = np.frombuffer(payload, dtype=np.uint8, count=n_frames * itemsize * n_channels)
        getattr(lib, name)(_as_ptr(raw), n_frames, n_channels, _as_ptr(out))
    _count("decode_pcm_mono")
    return out


def resample_poly(x: np.ndarray, up: int, down: int, taps: np.ndarray, n_out: int) -> Optional[np.ndarray]:
    """Polyphase resampling with symmetric odd-length ``taps``, equal to
    scipy's ``resample_poly(x, up, down, window=taps)``. Only pure
    decimation (``up == 1``) is claimed; any other ratio returns None and
    stays on scipy, whose tap alignment for ``up > 1`` this code does not
    reproduce."""
    if up != 1:
        return None
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    taps = np.ascontiguousarray(taps, np.float64)
    out = np.empty(n_out, np.float32)
    lib.resample_down_f32(_as_ptr(x), len(x), down, _as_ptr(taps), len(taps), _as_ptr(out), n_out)
    _count("resample_poly")
    return out


def crc32c(data: bytes) -> Optional[int]:
    """CRC-32C (Castagnoli), slice-by-8; None when the library is
    unavailable."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(0, np.uint8)
    crc = int(lib.crc32c(_as_ptr(buf), len(data)))
    _count("crc32c")
    return crc
