"""PyTorch port, the lossless PCM16 codec (`ops/pcmcodec.py`): the host
packer byte for byte against the JAX package's, the plain decode bit for bit
against the JAX package's decode and against pcm / 32768, and the codec
transcriber against the raw one, on the CPU. The CUDA kernel's fixed-order
arithmetic is emulated here in its own order (`_kernel_order_decode`); the
kernel itself is held against the plain decode in
`tests/test_torch_kernel_cuda.py` and `chip_smoke.py`.

The signals are those of tests/test_pcmcodec.py.
"""

import numpy as np
import pytest
import torch

from basic_pitch_torch import _build
from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.ops import pcmcodec as t_codec
from basic_pitch_tpu.ops import pcmcodec as j_codec
import torch_codec_cases as cases
from torch_port_helpers import SR, one_torch_thread, to_pcm16, tone_mix  # noqa: F401

CPU = torch.device("cpu")


def _signals():
    rng = np.random.RandomState(7)
    sine = (np.sin(np.arange(60000) * 0.07) * 18000).astype(np.int16)
    return {
        "random": (rng.randn(50000) * 4000).clip(-32768, 32767).astype(np.int16),
        "extremes": np.tile(np.array([-32768, 32767, 0, -1], np.int16), 300),
        "silence": np.zeros(4096, np.int16),
        "sine": sine,
        "mixed": np.concatenate([np.zeros(1000, np.int16), sine[:3000],
                                 (rng.randn(2000) * 30000).clip(-32768, 32767).astype(np.int16)]),
        "tiny": np.array([5], np.int16),
        "exact_blocks": (rng.randn(256 * 3) * 900).astype(np.int16),
    }


def _lpc_signals():
    rng = np.random.RandomState(13)
    t = np.arange(60000)
    sigs = dict(_signals())
    sigs["two_sines"] = (np.sin(t * 0.031) * 12000 + np.sin(t * 0.173) * 9000).astype(np.int16)
    sigs["clipped_loud"] = np.clip(np.sin(t[:30000] * 0.011) * 60000, -32768, 32767).astype(np.int16)
    sigs["hf_tonal"] = (np.sin(t[:20000] * 2.9) * 30000).astype(np.int16)
    sigs["fullscale_noise"] = rng.randint(-32768, 32768, 25000).astype(np.int16)
    return sigs


def _fuzz():
    """The adversarial LPC fuzz of tests/test_pcmcodec.py: clipped tones,
    full-scale alternation, steps, chirps."""
    rng = np.random.RandomState(99)
    for trial in range(12):
        n = int(rng.randint(300, 20000))
        kind = trial % 4
        if kind == 0:
            x = np.clip(np.sin(np.arange(n) * rng.uniform(0.005, 0.4)) * 50000, -32768, 32767)
        elif kind == 1:
            x = np.where(rng.randn(n) > 0, 32767, -32768)
        elif kind == 2:
            x = np.sin(np.arange(n) * 0.07) * 15000
            x[rng.randint(0, n, 5)] = 32767
        else:
            ph = np.cumsum(np.linspace(0.001, 1.2, n))
            x = np.sin(ph) * rng.uniform(1000, 32000)
        yield trial, x.astype(np.int16)


PACK_MODES = [{"order": 1}, {"order": 2}, {"order": 3}, {"mode": "lpc"}, {"mode": "fixed"}, {}]


def _assert_same_packed(a, b, msg):
    np.testing.assert_array_equal(a.words, b.words, err_msg=msg)
    assert a.words.dtype == b.words.dtype == np.uint32
    np.testing.assert_array_equal(a.heads, b.heads, err_msg=msg)
    assert (a.n_samples, a.nb, a.order, a.mode) == (b.n_samples, b.nb, b.order, b.mode), msg
    assert len(a.groups) == len(b.groups), msg
    for ga, gb in zip(a.groups, b.groups):
        assert ga[:3] == gb[:3], msg
        np.testing.assert_array_equal(ga[3], gb[3], err_msg=msg)
    if a.coeffs is not None:
        np.testing.assert_array_equal(a.coeffs, b.coeffs, err_msg=msg)
        np.testing.assert_array_equal(a.shifts, b.shifts, err_msg=msg)
    assert a.packed_bytes == b.packed_bytes, msg


@pytest.mark.parametrize("kw", PACK_MODES, ids=str)
def test_pack_is_byte_identical_to_jax(kw):
    """The native packers are built with the JAX package's flags, so even the
    float LPC analysis rounds the same way."""
    assert t_codec.available() and j_codec.available()
    for name, pcm in _lpc_signals().items():
        _assert_same_packed(t_codec.pack(pcm, **kw), j_codec.pack(pcm, **kw), f"{name} {kw}")


@pytest.mark.parametrize("order", [1, 2, 3])
def test_numpy_and_native_packers_agree(order):
    for name, pcm in _signals().items():
        padded = np.ascontiguousarray(np.pad(pcm, (0, (-len(pcm)) % t_codec.BLOCK)))
        w_n, t_n, c_n, i_n, h_n = t_codec._native_pack(padded, order)
        w_p, t_p, c_p, i_p, h_p = t_codec.pack_numpy(padded, order)
        assert t_n == t_p, name
        np.testing.assert_array_equal(w_n[:t_n], w_p[:t_p], err_msg=name)
        np.testing.assert_array_equal(c_n, c_p, err_msg=name)
        np.testing.assert_array_equal(i_n, i_p, err_msg=name)
        np.testing.assert_array_equal(h_n, h_p, err_msg=name)
        assert t_codec._native_choose_order(padded) == t_codec.choose_order_numpy(padded), name


def test_numpy_and_native_lpc_agree():
    for name, pcm in _lpc_signals().items():
        padded = np.ascontiguousarray(np.pad(pcm, (0, (-len(pcm)) % t_codec.BLOCK)))
        coeffs, shifts, bits = t_codec.lpc_analyze_numpy(padded)
        w_n, t_n, c_n, i_n, h_n = t_codec._native_lpc_pack(padded, coeffs, shifts)
        w_p, t_p, c_p, i_p, h_p = t_codec.pack_numpy_lpc(padded, coeffs, shifts)
        assert t_n == t_p, name
        np.testing.assert_array_equal(w_n[:t_n], w_p[:t_p], err_msg=name)
        np.testing.assert_array_equal(c_n, c_p, err_msg=name)
        np.testing.assert_array_equal(i_n, i_p, err_msg=name)
        np.testing.assert_array_equal(h_n, h_p, err_msg=name)
        n_coeffs, _, n_bits = t_codec._native_lpc_analyze(padded)
        assert np.abs(n_coeffs.astype(np.int64)).sum(axis=1).max() <= 32767 and n_bits > 0
        np.testing.assert_array_equal(t_codec.fixed_costs_numpy(padded), t_codec._native_fixed_costs(padded), err_msg=name)


def test_wire_is_deterministic():
    for name, pcm in _lpc_signals().items():
        for mode in (None, "fixed"):
            a, b = t_codec.pack(pcm, mode=mode), t_codec.pack(pcm, mode=mode)
            np.testing.assert_array_equal(a.words, b.words, err_msg=name)
            wa, la = t_codec.to_wire(a)
            wb, lb = t_codec.to_wire(b)
            assert la == lb and np.array_equal(wa, wb), name


@pytest.mark.parametrize("kw", PACK_MODES, ids=str)
def test_plain_decode_bit_exact_against_jax_and_pcm(kw):
    for name, pcm in _lpc_signals().items():
        packed = t_codec.pack(pcm, **kw)
        out = t_codec.decode_to_device(packed, device="cpu").numpy()
        np.testing.assert_array_equal(out, pcm.astype(np.float32) / np.float32(32768.0), err_msg=f"{name} {kw}")
        ref = np.asarray(j_codec.decode_to_device(j_codec.pack(pcm, **kw)))
        np.testing.assert_array_equal(out, ref, err_msg=f"{name} {kw}")


def test_adversarial_lpc_fuzz_bit_exact():
    for trial, pcm in _fuzz():
        for mode in (None, "lpc", "fixed"):
            packed = t_codec.pack(pcm, mode=mode)
            out = t_codec.decode_to_device(packed, device="cpu").numpy()
            ref = np.asarray(j_codec.decode_to_device(j_codec.pack(pcm, mode=mode)))
            np.testing.assert_array_equal(out, pcm.astype(np.float32) / np.float32(32768.0), err_msg=f"{trial} {mode}")
            np.testing.assert_array_equal(out, ref, err_msg=f"{trial} {mode}")


def test_jax_packed_pieces_decode_in_the_port():
    """One wire format: a piece packed by the JAX package decodes here."""
    for name, pcm in _lpc_signals().items():
        out = t_codec.decode_to_device(j_codec.pack(pcm), len(pcm), "cpu").numpy()
        np.testing.assert_array_equal(out, pcm.astype(np.float32) / np.float32(32768.0), err_msg=name)


def test_numpy_fallback_roundtrip(monkeypatch):
    for fn in ("_native_pack", "_native_lpc_pack"):
        monkeypatch.setattr(t_codec, fn, lambda *a, **k: None)
    for fn in ("_native_choose_order", "_native_fixed_costs", "_native_lpc_analyze"):
        monkeypatch.setattr(t_codec, fn, lambda *a, **k: None)
    for name in ("mixed", "two_sines", "extremes", "clipped_loud"):
        pcm = _lpc_signals()[name]
        for mode in (None, "lpc"):
            out = t_codec.encode_decode(pcm, device="cpu").numpy() if mode is None else \
                t_codec.decode_to_device(t_codec.pack(pcm, mode=mode), device="cpu").numpy()
            np.testing.assert_array_equal(out, pcm.astype(np.float32) / np.float32(32768.0), err_msg=name)


def test_wire_holds_what_packed_bytes_counts():
    packed = t_codec.pack(_lpc_signals()["two_sines"], mode="lpc")
    wire, layout = t_codec.to_wire(packed)
    table = 16 * len(packed.groups)
    assert packed.packed_bytes + table <= layout.nbytes == len(wire) <= packed.packed_bytes + table + 16 * 6
    assert all(off % 16 == 0 for off in layout[4:10])


def test_decode_validates_inputs():
    packed = t_codec.pack(_signals()["sine"])
    wire, layout = t_codec.to_wire(packed)
    w = torch.from_numpy(wire)
    with pytest.raises(ValueError, match="n_out"):
        t_codec.decode_wire(w, layout, layout.nb * t_codec.BLOCK + 1)
    with pytest.raises(ValueError, match="uint8"):
        t_codec.decode_wire(w.view(torch.int16), layout, 10)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_codec.decode_wire(torch.empty(len(wire), dtype=torch.uint8, device="meta"), layout, 10)
    with pytest.raises(ValueError, match="order"):
        t_codec.pack(np.zeros(512, np.int16), order=4)
    with pytest.raises(ValueError, match="int16"):
        t_codec.pack(np.zeros(512, np.float32))


def test_decode_without_a_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_codec.decode_to_device(t_codec.pack(_signals()["sine"]))


def _codec_and_raw(pcm, sr):
    raw = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", pcm_transport="raw")
    codec = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", pcm_transport="codec")
    ev_raw, ev_codec = raw.transcribe(pcm, sr), codec.transcribe(pcm, sr)
    post_raw, post_codec = raw.posteriorgrams(pcm, sr), codec.posteriorgrams(pcm, sr)
    codec.close()
    return raw, codec, ev_raw, ev_codec, post_raw, post_codec


@pytest.mark.parametrize(
    "sr,seconds,level",
    [
        pytest.param(SR, 4.5, 0.05, id=f"{SR}"),
        pytest.param(2 * SR, 4.5, 0.05, id=f"{2 * SR}"),
        pytest.param(SR, 5.0, 0.5, id=f"{SR}-loud"),
        pytest.param(2 * SR, 5.0, 0.5, id=f"{2 * SR}-loud"),
    ],
)
def test_codec_transcriber_equals_raw(sr, seconds, level):
    """int16 at 22.05 and 44.1 kHz: the decoded pieces are the exact samples
    the raw path scales on the device, so posteriorgrams and events are
    identical; the codec ships fewer bytes. A quiet 4.5 s mix packs smaller
    on its content alone; a loud mix's full pieces do not, and at 5 s the
    codec gains only on the last piece, whose last window covers zeros past
    the recording's end."""
    rng = np.random.RandomState(3)
    noise = 0.002 * level * rng.randn(int(seconds * sr)).astype(np.float32)
    pcm = to_pcm16(tone_mix(sr, seconds=seconds, seed=1) * level + noise)
    raw, codec, ev_raw, ev_codec, post_raw, post_codec = _codec_and_raw(pcm, sr)
    assert ev_codec == ev_raw and len(ev_raw) >= 3
    for key in post_raw:
        np.testing.assert_array_equal(post_codec[key], post_raw[key])
    assert codec.piece_upload_bytes["default"] < raw.piece_upload_bytes["default"]
    assert raw.pcm_transport == "raw" and codec.pcm_transport == "codec"


def test_incompressible_pieces_go_raw():
    """A piece whose packed form is not smaller crosses raw, as in the JAX
    package, and is counted at its raw size."""
    pcm = np.random.RandomState(0).randint(-32768, 32768, 3 * SR).astype(np.int16)
    raw, codec, ev_raw, ev_codec, _, _ = _codec_and_raw(pcm, SR)
    assert ev_codec == ev_raw
    assert codec.piece_upload_bytes == raw.piece_upload_bytes


def test_forced_codec_raises_when_the_packer_cannot_build(monkeypatch):
    """No silent fallback to raw: "codec" needs its packer (and, on a GPU,
    its kernel) at construction; "auto" resolves to raw without it."""
    monkeypatch.setattr(t_codec, "_packer_error", None)
    real_load = _build.load

    def load(name):
        if name == "pcm_pack":
            raise RuntimeError("g++ not found")
        return real_load(name)

    monkeypatch.setattr(_build, "load", load)
    with pytest.raises(RuntimeError, match="packer is unavailable"):
        t_pipeline.StreamingTranscriber(windows_per_chunk=1, device="cpu", pcm_transport="codec")
    assert not t_codec.available()
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=1, device="cpu", pcm_transport="auto")
    assert not tr._codec_enabled(np.dtype(np.int16))
    monkeypatch.setattr(t_codec, "_packer_error", None)


# --------------------------------------------------------------------------
# the CUDA kernel's fixed-order arithmetic, emulated on the CPU
# --------------------------------------------------------------------------


def _kernel_order_decode(packed, n_out):
    """`csrc/pcm_decode.cu`'s fixed-order decode in its own order, in int32:
    lane l of a block's warp holds samples 8l .. 8l+7, reads its residuals
    from the row's words through a 64-bit bit reservoir starting at bit
    max(8l - order, 0) * k (lane 0 holds the heads' zero-history differences
    first), then `order` passes of a two-level prefix sum: 8 in registers,
    the lane totals by a Hillis-Steele warp scan, the exclusive carry added
    back."""
    order, nb = packed.order, packed.nb
    words = np.concatenate([packed.words, np.zeros(4, np.uint32)]).astype(np.uint64)
    lane = np.arange(32)
    s = np.zeros((nb, 32, 8), np.int64)
    for k, word_off, n_rows, gidx in packed.groups:
        bit = np.maximum(8 * lane - order, 0) * k
        p = word_off + np.arange(n_rows)[:, None] * t_codec.words_per_block(k, order) + (bit >> 5)[None, :]
        sh = np.broadcast_to((bit & 31).astype(np.uint64), p.shape)
        buf = ((words[p + 1] << np.uint64(32)) | words[p]) >> sh
        have = 64 - sh.astype(np.int64)
        p = p + 2
        vals = np.zeros((n_rows, 32, 8), np.int64)
        for i in range(8):
            take = np.broadcast_to((lane > 0) | (i >= order), p.shape)  # lane 0 holds the heads first
            raw = (buf & np.uint64(0xFFFFFFFF)).astype(np.int64)
            buf = np.where(take, buf >> np.uint64(k), buf)
            have = np.where(take, have - k, have)
            refill = take & (have < 32)
            buf = np.where(refill, buf | (words[p] << np.maximum(have, 0).astype(np.uint64)), buf)
            p = np.where(refill, p + 1, p)
            have = np.where(refill, have + 32, have)
            v = raw & ((1 << k) - 1)
            vals[:, :, i] = v - ((v & (1 << (k - 1))) << 1)
        s[gidx[:n_rows]] = vals
    h = packed.heads.astype(np.int64)
    # Delta^order of the block with zero history: `order` cumsums of it
    # give the heads back
    binom = {1: [1], 2: [1, -2], 3: [1, -3, 3]}[order]
    for i in range(order):
        s[:, 0, i] = sum(binom[j] * h[:, i - j] for j in range(i + 1))
    v = torch.from_numpy(s.astype(np.int32))
    for _ in range(order):
        v = torch.cumsum(v, dim=2, dtype=torch.int32)
        total = v[:, :, 7].clone()
        for d in (1, 2, 4, 8, 16):
            up = torch.zeros_like(total)
            up[:, d:] = total[:, :-d]
            total = total + up
        v = v + (total - v[:, :, 7])[:, :, None]
    return (v.reshape(-1)[:n_out].to(torch.float32) * (1.0 / 32768.0)).numpy()


def _scan_case(name, order):
    """(pcm, packed) of a named case at a fixed order."""
    if name == "every k of KSET":
        pcm, widths = cases.ladder(order, [2] * len(t_codec.KSET), seed=order)
        return pcm, cases.pack_with_widths(pcm, widths, order)
    if name == "extremes":
        pcm = _signals()["extremes"]
    elif name == "full-scale alternation":
        pcm = np.tile(np.array([-32768, 32767], np.int16), 3000)
    else:
        n = int(name.split()[1])
        pcm = (np.sin(np.arange(n) * 0.031) * 12000 + np.random.RandomState(n).randn(n) * 300).astype(np.int16)
    return pcm, t_codec.pack(pcm, order=order)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("name", ["every k of KSET", "extremes", "full-scale alternation", "length 1",
                                  "length 255", "length 256", "length 257", "length 44100"])
def test_kernel_scan_order_is_bit_exact(name, order):
    """The kernel's decode order (bit reservoir, 8 residuals a lane, warp
    carry, `order` passes) equals `decode_plain`, the JAX package's decode
    and pcm / 32768 bit for bit."""
    pcm, packed = _scan_case(name, order)
    assert packed.order == order
    if name == "every k of KSET":
        assert sorted(g[0] for g in packed.groups) == sorted(t_codec.KSET)
    out = _kernel_order_decode(packed, len(pcm))
    wire, layout = t_codec.to_wire(packed)
    np.testing.assert_array_equal(out, t_codec.decode_plain(torch.from_numpy(wire), layout, len(pcm)).numpy())
    np.testing.assert_array_equal(out, pcm.astype(np.float32) / np.float32(32768.0))
    j_packed = j_codec.PackedPCM(packed.words, packed.groups, packed.heads, packed.n_samples, packed.nb, packed.order)
    np.testing.assert_array_equal(out, np.asarray(j_codec.decode_to_device(j_packed, len(pcm))))


def test_tiling_cases_decode_exactly():
    """The card's tiling cases (`tests/torch_codec_cases.py`: one block,
    groups of one to three rows, block counts off 32, group starts off 16
    bytes) are valid wires: the plain decode and the JAX package's give
    pcm / 32768 bit for bit, and the fixed-order ones decode so in the
    kernel's order too."""
    for name, pcm, packed in cases.tiling_cases():
        wire, layout = t_codec.to_wire(packed)
        out = t_codec.decode_plain(torch.from_numpy(wire), layout, len(pcm)).numpy()
        np.testing.assert_array_equal(out, pcm.astype(np.float32) / np.float32(32768.0), err_msg=name)
        j_packed = j_codec.PackedPCM(packed.words, packed.groups, packed.heads, packed.n_samples, packed.nb,
                                     packed.order, packed.coeffs, packed.shifts)
        np.testing.assert_array_equal(out, np.asarray(j_codec.decode_to_device(j_packed, len(pcm))), err_msg=name)
        if packed.mode == "fixed":
            np.testing.assert_array_equal(_kernel_order_decode(packed, len(pcm)), out, err_msg=name)
