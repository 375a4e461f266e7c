"""PyTorch port, the native host library (`basic_pitch_torch/native.py`,
`csrc/bp_native.cpp`) against the JAX package's (`basic_pitch_tpu.native`,
built here by g++ from its own source) and against the port's numpy paths.

Every entry point is bit-equal to the JAX library. Against the numpy
paths: mono WAV decode at 16/24/32-bit PCM and float32, 16/24-bit and float
stereo mixdown, decimation and the CRC are bit-equal; a 32-bit stereo or any
3-channel mean is rounded in other steps on the two paths (the numpy path
converts to float32, then takes a float32 mean; the native one sums in
float64 or scales by the reciprocal), so it is held to one float32 ulp of
full scale (2**-23) absolute. `read_wav_mono`
and `resample(..., 44100, 22050)` give the JAX package's bytes, and the
CRC-32C check value is 0xE3069283. Without the library every caller takes
its numpy path, and that is logged once at WARNING.
"""

import logging
import pathlib
import struct

import numpy as np
import pytest

from basic_pitch_torch import _build
from basic_pitch_torch import native as t_native
from basic_pitch_torch.data import tfrecord as t_tfrecord
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_tpu import native as j_native
from basic_pitch_tpu.utils import audio as j_audio

REPO = pathlib.Path(__file__).resolve().parent.parent
FORMATS = [(16, False), (24, False), (32, False), (32, True)]


def _payload(bits, is_float, n_frames, n_channels, seed):
    """Seeded interleaved payload, full scale, extremes included."""
    rng = np.random.RandomState(seed)
    n = n_frames * n_channels
    if is_float:
        return (rng.rand(n) * 2.2 - 1.1).astype("<f4").tobytes()
    if bits == 24:
        v = rng.randint(-(1 << 23), 1 << 23, n)
        v[:2] = (-(1 << 23), (1 << 23) - 1)
        return (v & 0xFFFFFF).astype("<u4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    info = np.iinfo(f"int{bits}")
    v = rng.randint(info.min, info.max, n, dtype=np.int64)
    v[:2] = (info.min, info.max)
    return v.astype(f"<i{bits // 8}").tobytes()


def _wav_bytes(payload, bits, is_float, n_channels, rate=44100):
    fmt = struct.pack("<HHIIHH", 3 if is_float else 1, n_channels, rate, rate * n_channels * bits // 8,
                      n_channels * bits // 8, bits)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)) + b"WAVE" + b"fmt "
            + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(payload)) + payload)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert t_native.available() and j_native.available()


def test_source_copies_the_jax_entry_points():
    """csrc/bp_native.cpp holds the JAX library's code up to the end of its
    CRC (the packer after it is csrc/pcm_pack.cpp); only comments differ."""

    def code(text):
        return [" ".join(line.split("//", 1)[0].split()) for line in text.splitlines() if line.split("//", 1)[0].strip()]

    j_code = code((REPO / "basic_pitch_tpu" / "native" / "bp_native.cpp").read_text())
    t_code = code((REPO / "basic_pitch_torch" / "csrc" / "bp_native.cpp").read_text())
    end = j_code.index("return crc ^ 0xFFFFFFFFu;") + 2
    assert t_code == j_code[:end] + ["}"]
    assert t_native.calls.keys() == {"decode_pcm_mono", "resample_poly", "crc32c"}


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("bits,is_float", FORMATS)
def test_decode_is_the_jax_librarys_and_the_numpy_paths(bits, is_float, channels):
    payload = _payload(bits, is_float, 4099, channels, seed=bits + channels)
    before = t_native.calls["decode_pcm_mono"]
    got = t_native.decode_pcm_mono(payload, bits, is_float, channels)
    assert t_native.calls["decode_pcm_mono"] == before + 1
    assert got.dtype == np.float32 and got.shape == (4099,)
    np.testing.assert_array_equal(got, j_native.decode_pcm_mono(payload, bits, is_float, channels))
    samples, _ = t_audio.read_wav_bytes(_wav_bytes(payload, bits, is_float, channels))
    plain = t_audio.to_mono(samples)
    if channels == 1 or (channels == 2 and (bits < 32 or is_float)):
        np.testing.assert_array_equal(got, plain)
    else:  # the two paths round a 32-bit or 3-channel mean in other steps
        np.testing.assert_allclose(got, plain, rtol=0, atol=2.0**-23)


def test_decode_declines_what_it_does_not_implement():
    assert t_native.decode_pcm_mono(b"\x00" * 16, 8, False, 1) is None
    assert t_native.decode_pcm_mono(b"\x00" * 16, 64, True, 1) is None
    assert t_native.decode_pcm_mono(b"\x00" * 16, 16, False, 0) is None
    assert t_native.decode_pcm_mono(b"", 16, False, 2).shape == (0,)


@pytest.mark.parametrize("bits,is_float", FORMATS)
def test_read_wav_mono_gives_the_jax_bytes(tmp_path, bits, is_float):
    path = tmp_path / "a.wav"
    path.write_bytes(_wav_bytes(_payload(bits, is_float, 5000, 2, seed=7), bits, is_float, 2))
    before = t_native.calls["decode_pcm_mono"]
    got, sr = t_audio.read_wav_mono(path)
    ref, sr_j = j_audio.read_wav_mono(path)
    assert sr == sr_j == 44100 and t_native.calls["decode_pcm_mono"] == before + 1
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("rates", [(44100, 22050), (48000, 16000), (88200, 22050)])
def test_decimation_is_the_jax_librarys_and_scipys(rates, monkeypatch):
    rng = np.random.RandomState(sum(rates))
    x = (rng.randn(rates[0] * 2 + 37) * 0.3).astype(np.float32)
    before = t_native.calls["resample_poly"]
    got = t_audio.resample(x, *rates)
    assert t_native.calls["resample_poly"] == before + 1
    assert got.tobytes() == j_audio.resample(x, *rates).tobytes()
    monkeypatch.setattr(t_native, "resample_poly", lambda *a: None)  # the scipy path
    assert got.tobytes() == t_audio.resample(x, *rates).tobytes()


def test_resample_claims_only_pure_decimation():
    taps = np.ones(5) / 5
    assert t_native.resample_poly(np.zeros(10, np.float32), 2, 3, taps, 7) is None
    before = t_native.calls["resample_poly"]
    x = np.random.RandomState(0).randn(100).astype(np.float32)
    np.testing.assert_array_equal(
        t_native.resample_poly(x, 1, 2, taps, 50), j_native.resample_poly(x, 1, 2, taps, 50)
    )
    assert t_native.calls["resample_poly"] == before + 1
    # the general-ratio kernel is in the library as in JAX's, unclaimed
    lib = t_native.load()
    out = np.empty(7, np.float32)
    lib.resample_poly_f32(t_native._as_ptr(x), 10, 2, 3, t_native._as_ptr(np.ascontiguousarray(taps)), 5,
                          t_native._as_ptr(out), 7)
    ref = np.empty(7, np.float32)
    j_native.load().resample_poly_f32(j_native._as_ptr(x), 10, 2, 3, j_native._as_ptr(np.ascontiguousarray(taps)), 5,
                                      j_native._as_ptr(ref), 7)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 4099, 1 << 16])
def test_crc32c_is_the_jax_librarys_and_the_table_loop(n):
    data = np.random.RandomState(n).bytes(n)
    before = t_native.calls["crc32c"]
    got = t_tfrecord.crc32c(data)
    assert t_native.calls["crc32c"] == before + 1
    assert got == j_native.crc32c(data) == t_tfrecord.crc32c_table(data)


def test_crc32c_check_value():
    assert t_native.crc32c(b"123456789") == t_tfrecord.crc32c(b"123456789") == 0xE3069283


def test_without_the_library_every_caller_takes_its_numpy_path(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_error", None)

    def no_compiler(name):
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(_build, "load", no_compiler)
    with caplog.at_level(logging.WARNING, logger="basic_pitch_torch.native"):
        assert not t_native.available()
        assert not t_native.available()
    assert [r.levelno for r in caplog.records] == [logging.WARNING]
    assert "numpy paths" in caplog.records[0].getMessage()
    calls = dict(t_native.calls)
    assert t_tfrecord.crc32c(b"123456789") == 0xE3069283
    x = np.random.RandomState(1).randn(999).astype(np.float32)
    y = t_audio.resample(x, 44100, 22050)
    path = tmp_path / "b.wav"
    t_audio.write_wav(path, x * 0.5, 22050)
    mono, _ = t_audio.read_wav_mono(path)
    assert t_native.calls == calls
    monkeypatch.undo()
    assert t_native.available()
    assert y.tobytes() == t_audio.resample(x, 44100, 22050).tobytes()
    assert mono.tobytes() == t_audio.read_wav_mono(path)[0].tobytes()
