"""Host-side audio I/O: WAV decode/encode, file loading and sample-rate
conversion.

A copy of `basic_pitch_tpu/utils/audio.py` (the port imports nothing of the
JAX package): a RIFF/WAVE reader for PCM 8/16/24/32-bit and IEEE-float
payloads, a PCM16 writer, channel mixdown, a Kaiser-windowed polyphase
resampler (scipy's `resample_poly`) and an ffmpeg fallback for other
containers. As in the JAX package, `read_wav_mono` (fused decode and
mixdown) and pure decimation in `resample` take the native host library
(`basic_pitch_torch/native.py`) when it is built, and the numpy and scipy
paths otherwise. `tests/test_torch_params.py` pins the copies equal.
"""

from __future__ import annotations

import contextlib
import pathlib
import shutil
import struct
import subprocess
import tempfile
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


def write_wav(path: "PathLike | object", samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples (clipped to [-1, 1]) as 16-bit PCM.

    ``path`` may be a filesystem path or any binary file-like object."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    payload = pcm.tobytes()
    n_channels = x.shape[1]
    byte_rate = sample_rate * n_channels * 2
    block_align = n_channels * 2
    ctx = contextlib.nullcontext(path) if hasattr(path, "write") else open(path, "wb")
    with ctx as fh:
        fh.write(_RIFF)
        fh.write(struct.pack("<I", 36 + len(payload)))
        fh.write(_WAVE)
        fh.write(_FMT)
        fh.write(struct.pack("<IHHIIHH", 16, WAVE_FORMAT_PCM, n_channels, sample_rate, byte_rate, block_align, 16))
        fh.write(_DATA)
        fh.write(struct.pack("<I", len(payload)))
        fh.write(payload)


def read_wav_mono(path: PathLike) -> Tuple[np.ndarray, int]:
    """Decode a WAV straight to float32 mono, through the native library's
    fused decode and mixdown when it is built."""
    with open(path, "rb") as fh:
        raw = fh.read()
    header = _parse_wav_header(raw)
    if header is not None:
        audio_format, n_channels, sample_rate, bits, payload = header
        # only formats the native decoder implements; anything else goes
        # through the validating decoder, which raises WavFormatError
        if n_channels >= 1 and audio_format in (WAVE_FORMAT_PCM, WAVE_FORMAT_IEEE_FLOAT):
            from basic_pitch_torch import native

            decoded = native.decode_pcm_mono(payload, bits, audio_format == WAVE_FORMAT_IEEE_FLOAT, n_channels)
            if decoded is not None:
                return decoded, sample_rate
    samples, sample_rate = read_wav_bytes(raw, name=str(path))
    return to_mono(samples), sample_rate


def read_wav_pcm16_mono(
    path: PathLike, rates: Tuple[int, ...] = (22050, 44100)
) -> "Tuple[np.ndarray, int] | None":
    """Raw int16 mono samples when the file is PCM16 mono at a given rate.

    Returns (int16 samples, sample_rate), or None when the file is not
    losslessly int16-transportable as-is (non-PCM16, multi-channel, or an
    off-list rate); callers fall back to the float decode path. The int16
    payload dequantized as x/32768 (as the transcriber does on the device)
    is bit-identical to `read_wav`'s float output.
    """
    with open(path, "rb") as fh:
        raw = fh.read()
    header = _parse_wav_header(raw)
    if header is None:
        return None
    audio_format, n_channels, sample_rate, bits, payload = header
    if audio_format != WAVE_FORMAT_PCM or bits != 16 or n_channels != 1:
        return None
    if sample_rate not in rates:
        return None
    return raw_to_np(payload, np.int16), sample_rate


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
    samples. Pure decimation takes the native library when it is built
    (`native.resample_poly`), as the JAX package does; scipy otherwise.
    """
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    from math import gcd

    from scipy.signal import firwin, resample_poly

    g = gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    half_len = 64 * max(up, down)
    taps = firwin(2 * half_len + 1, min(1.0 / up, 1.0 / down), window=("kaiser", 14.77))
    if up == 1:
        from basic_pitch_torch import native

        fast = native.resample_poly(np.asarray(x, np.float32), up, down, taps, int(np.ceil(len(x) / down)))
        if fast is not None:
            return fast
    y = resample_poly(np.asarray(x, dtype=np.float64), up, down, window=taps)
    n_out = int(np.ceil(len(x) * sr_out / sr_in))
    if len(y) < n_out:
        y = np.pad(y, (0, n_out - len(y)))
    return y[:n_out].astype(np.float32)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def decode_with_ffmpeg(path: PathLike) -> Tuple[np.ndarray, int]:
    """Decode any container ffmpeg can open to (samples (n, ch), sample_rate)."""
    if not ffmpeg_available():
        raise WavFormatError(
            f"{path}: not a RIFF/WAVE file and ffmpeg is not available to "
            "transcode it — install ffmpeg or supply WAV input"
        )
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-i", str(path), tmp.name],
            check=True,
        )
        return read_wav(tmp.name)


def _is_wav(path: PathLike) -> bool:
    try:
        with open(path, "rb") as fh:
            head = fh.read(12)
    except OSError:
        return False
    return len(head) >= 12 and head[:4] == _RIFF and head[8:12] == _WAVE


def load_audio(path: PathLike, sample_rate: int, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode an audio file, mix to mono, and resample to `sample_rate`.

    WAV goes through the reader above; any other container (mp3/flac/ogg/...)
    is transcoded via ffmpeg, as is a RIFF file whose codec the reader does
    not parse (ADPCM, A-law/mu-law, ...).
    """
    if _is_wav(path):
        try:
            y, sr = read_wav_mono(path) if mono else read_wav(path)
        except WavFormatError:
            y, sr = decode_with_ffmpeg(path)
            if mono:
                y = to_mono(y)
    else:
        y, sr = decode_with_ffmpeg(path)
        if mono:
            y = to_mono(y)
    y = resample(y, sr, sample_rate)
    return np.ascontiguousarray(y, dtype=np.float32), sample_rate
