"""Host-side audio I/O: WAV decoding and sample-rate conversion.

A copy of the parts of `basic_pitch_tpu/utils/audio.py` that the port's
transcriber needs (the port imports nothing of the JAX package): a RIFF/WAVE
reader for PCM 8/16/24/32-bit and IEEE-float payloads, channel mixdown, and
a Kaiser-windowed polyphase resampler (scipy's `resample_poly`).
"""

from __future__ import annotations

import pathlib
import struct
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, pathlib.Path]

_RIFF = b"RIFF"
_WAVE = b"WAVE"
_FMT = b"fmt "
_DATA = b"data"

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFormatError(ValueError):
    pass


def read_wav(path: PathLike) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to float32 samples in [-1, 1].

    Returns:
        (samples, sample_rate) where samples has shape (n_frames, n_channels).
    """
    with open(path, "rb") as fh:
        raw = fh.read()
    return read_wav_bytes(raw, name=str(path))


def read_wav_bytes(raw: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """Decode in-memory WAV bytes (same contract as `read_wav`)."""
    header = _parse_wav_header(raw)
    if header is None:
        if len(raw) < 12 or raw[:4] != _RIFF or raw[8:12] != _WAVE:
            raise WavFormatError(f"{name} is not a RIFF/WAVE file")
        raise WavFormatError(f"{name}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, bits, data = header

    if audio_format == WAVE_FORMAT_PCM:
        if bits == 8:
            x = (raw_to_np(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = raw_to_np(data, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(data[: len(data) - len(data) % 3], dtype=np.uint8).reshape(-1, 3)
            as32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = raw_to_np(data, np.int32).astype(np.float32) / float(1 << 31)
        else:
            raise WavFormatError(f"unsupported PCM bit depth {bits}")
    elif audio_format == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = raw_to_np(data, np.float32).astype(np.float32)
        elif bits == 64:
            x = raw_to_np(data, np.float64).astype(np.float32)
        else:
            raise WavFormatError(f"unsupported float bit depth {bits}")
    else:
        raise WavFormatError(f"unsupported WAV format tag 0x{audio_format:04x}")

    if n_channels < 1:
        raise WavFormatError("channel count must be >= 1")
    n_frames = x.shape[0] // n_channels
    x = x[: n_frames * n_channels].reshape(n_frames, n_channels)
    return x, sample_rate


def raw_to_np(data: bytes, dtype: type) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    usable = len(data) - len(data) % itemsize
    return np.frombuffer(data[:usable], dtype=dtype)


def _parse_wav_header(raw: bytes):
    """(format, channels, rate, bits, payload) or None when not plain WAV."""
    if len(raw) < 12 or raw[:4] != _RIFF or raw[8:12] != _WAVE:
        return None
    fmt = data = None
    pos = 12
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == _FMT:
            fmt = body
        elif chunk_id == _DATA:
            data = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or data is None or len(fmt) < 16:
        return None
    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_format == WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        (audio_format,) = struct.unpack_from("<H", fmt, 24)
    return audio_format, n_channels, sample_rate, bits, data


def to_mono(samples: np.ndarray) -> np.ndarray:
    """Mix down (n_frames, n_channels) to (n_frames,) by channel mean."""
    if samples.ndim == 1:
        return samples
    if samples.shape[1] == 1:
        return samples[:, 0]
    return samples.mean(axis=1).astype(np.float32)


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """High-quality polyphase resampling of a mono float signal.

    Rational-ratio polyphase FIR with a Kaiser-windowed sinc prototype
    (beta=14.77, 64 zero crossings per phase), ceil(len * ratio) output
    samples. The JAX package takes a native C++ path for pure decimation;
    this copy always uses scipy, whose float64 result agrees to float32
    rounding.
    """
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    from math import gcd

    from scipy.signal import firwin, resample_poly

    g = gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    half_len = 64 * max(up, down)
    taps = firwin(2 * half_len + 1, min(1.0 / up, 1.0 / down), window=("kaiser", 14.77))
    y = resample_poly(np.asarray(x, dtype=np.float64), up, down, window=taps)
    n_out = int(np.ceil(len(x) * sr_out / sr_in))
    if len(y) < n_out:
        y = np.pad(y, (0, n_out - len(y)))
    return y[:n_out].astype(np.float32)
