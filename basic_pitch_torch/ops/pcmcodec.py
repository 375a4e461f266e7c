"""Lossless PCM16 transport codec: packed on host threads, decoded on the device.

PyTorch counterpart of `basic_pitch_tpu/ops/pcmcodec.py`, with the same
wire format, so a piece packed by either package decodes in both:

- 256-sample blocks; one fixed-predictor order (1..3, FLAC-style) chosen
  per piece by exact payload cost, or per-block LPC of order 8 when it beats
  the best fixed order by `_LPC_MARGIN`; each block's first `order` samples
  ship verbatim in `heads` (int16, the integration constants), the other
  256 - order as k-bit two's-complement residuals, k the smallest width in
  `KSET` that covers the block's residual range (k = 19 always suffices).
- Blocks are grouped by k; each group's rows lie consecutively in one u32
  buffer (KSET order, every row 32-bit aligned). `idx` maps stream rows back
  to block positions, padded per group to a power-of-two row bucket with the
  dummy block `nb`; the words buffer is zero-padded to cover the buckets and
  quantized to its top `_WORDS_SIG_BITS` bits (`_quantize_words`).

The host half (`pack`) runs the native packer `csrc/pcm_pack.cpp` (built with
g++ at first use, `available()`), or the numpy packers here, which are its
oracle. The device half, `decode_to_device(packed, n_out, device)`, ships the
piece as one byte buffer (`to_wire`: a group table, then the words, idx,
heads, coeffs and shifts) and reconstructs float32 samples equal to
``pcm.astype(float32) / 32768`` bit for bit (`decode_wire`): on a CUDA tensor
with the hand-written kernel `csrc/pcm_decode.cu`, on a CPU tensor with
`decode_plain`, the vectorized port of the JAX package's unpack and integrate
programs. Anything else raises; the kernel never falls back. `launches`
counts kernel launches.

Everything is integer arithmetic: the LPC quantizer keeps sum|c| <= 32767, so
the decoder's int32 prediction accumulator stays under 2^30 and its
recurrence reproduces the encoder's predictions exactly.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

BLOCK = 256
# Descending = stream layout order. 19 bits covers the order-3 residual of
# int16 (|Δ³x| < 2^18); 18 covers Δ², 17 covers Δ¹.
KSET: Tuple[int, ...] = tuple(range(19, 1, -1))
_MIN_BUCKET = 8
_MERGE_MIN_ROWS = 64  # groups below this merge into the next wider width
_ORDERS = (1, 2, 3)  # FLAC-style fixed-predictor orders; best chosen per piece

# LPC mode: per-block adaptive prediction. Coefficients are quantized so
# sum|c| <= 32767, which bounds the decoder's int32 accumulator. The wire is
# self-describing (reconstruction uses the shipped coefficients), so float
# analysis differences between analyzers change the ratio, never the result.
LPC_ORDER = 8
_LPC_MAX_SHIFT = 14
# LPC must beat the best fixed order's exact bit cost by this factor to be
# chosen (the JAX package's margin; it keeps near-ties on the cheaper
# integrate-only decode).
_LPC_MARGIN = 0.97
_WORDS_SIG_BITS = 5

# kernel launches made by `decode_wire` in this process
launches = 0


def payload_len(order: int) -> int:
    """Residual samples per block: the first `order` samples ship verbatim."""
    return BLOCK - order


def words_per_block(k: int, order: int) -> int:
    return (payload_len(order) * k + 31) // 32


@dataclass
class PackedPCM:
    """One packed piece: exact-size u32 payload + per-group placement."""

    words: np.ndarray  # (total_words,) uint32, all groups back to back
    groups: List[Tuple[int, int, int, np.ndarray]]  # (k, word_off, n_rows, idx)
    heads: np.ndarray  # (nb, order) int16 — per-block integration constants
    n_samples: int
    nb: int
    order: int = 2  # predictor order: fixed 1..3, or LPC_ORDER in lpc mode
    # lpc mode only: per-block quantized predictor (nb, order) int16 and the
    # per-block coefficient scale (nb,) int8 — None in fixed mode
    coeffs: Optional[np.ndarray] = None
    shifts: Optional[np.ndarray] = None

    @property
    def mode(self) -> str:
        return "lpc" if self.coeffs is not None else "fixed"

    @property
    def packed_bytes(self) -> int:
        extra = 0
        if self.coeffs is not None:
            extra = self.coeffs.nbytes + self.shifts.nbytes
        return self.words.nbytes + self.heads.nbytes + extra + sum(g[3].nbytes for g in self.groups)


# --------------------------------------------------------------------------
# the native packer (csrc/pcm_pack.cpp)
# --------------------------------------------------------------------------

_kset_arr = np.asarray(KSET, np.int32)
_packer_lock = threading.Lock()
_packer_error: Optional[str] = None


def packer() -> ctypes.CDLL:
    """The native packer, built with g++ at first use; raises RuntimeError
    when it cannot be built (the failure is remembered for the process)."""
    global _packer_error
    from basic_pitch_torch import _build

    with _packer_lock:
        if _packer_error is not None:
            raise RuntimeError(f"the native PCM packer is unavailable: {_packer_error}")
        try:
            lib = _build.load("pcm_pack")
        except (RuntimeError, OSError) as exc:
            _packer_error = str(exc)
            raise RuntimeError(f"the native PCM packer is unavailable: {exc}") from exc
    i64, i32, ptr = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    lib.pack_pcm16_residual.argtypes = [ptr, i64, i32, ptr, i32, ptr, i64, ptr, ptr, ptr]
    lib.pack_pcm16_residual.restype = i64
    lib.residual_order_costs.argtypes = [ptr, i64, ptr]
    lib.residual_order_costs.restype = None
    lib.lpc_analyze_pcm16.argtypes = [ptr, i64, i32, ptr, ptr]
    lib.lpc_analyze_pcm16.restype = i64
    lib.pack_pcm16_lpc.argtypes = [ptr, i64, i32, ptr, ptr, ptr, i32, ptr, i64, ptr, ptr, ptr]
    lib.pack_pcm16_lpc.restype = i64
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    try:
        return packer()
    except RuntimeError:
        return None


def available() -> bool:
    """True when the native packer builds (the numpy packers are too slow for
    the throughput path; the transport policy picks raw without it)."""
    return _lib() is not None


def _ptr(array: np.ndarray) -> ctypes.c_void_p:
    return array.ctypes.data_as(ctypes.c_void_p)


# --------------------------------------------------------------------------
# host-side packing (the JAX package's packers, unchanged)
# --------------------------------------------------------------------------


def _native_choose_order(pcm: np.ndarray) -> Optional[int]:
    bits = _native_fixed_costs(pcm)
    return None if bits is None else _ORDERS[int(np.argmin(bits))]


def _signed_widths(residuals: np.ndarray) -> np.ndarray:
    """Per-block minimal signed two's-complement width (min 2 bits)."""
    maxabs = np.abs(residuals).max(axis=1)
    return np.maximum(2, np.ceil(np.log2(np.maximum(maxabs, 1) + 1)).astype(np.int64) + 1)


def choose_order_numpy(pcm: np.ndarray) -> int:
    """Cheapest fixed-predictor order by exact per-block signed widths."""
    return _ORDERS[int(np.argmin(fixed_costs_numpy(pcm)))]


def _native_pack(pcm: np.ndarray, order: int):
    lib = _lib()
    if lib is None:
        return None
    nb = len(pcm) // BLOCK
    cap = nb * words_per_block(KSET[0], order) + 4
    words = np.empty(cap, np.uint32)
    idx = np.empty(nb, np.int32)
    heads = np.empty((nb, order), np.int16)
    counts = np.empty(len(KSET), np.int64)
    total = lib.pack_pcm16_residual(
        _ptr(pcm), ctypes.c_int64(len(pcm)), ctypes.c_int32(order), _ptr(_kset_arr),
        ctypes.c_int32(len(KSET)), _ptr(words), ctypes.c_int64(cap), _ptr(idx), _ptr(heads), _ptr(counts),
    )
    if total < 0:
        return None
    return words, int(total), counts, idx, heads


def pack_numpy(pcm: np.ndarray, order: int) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]:
    """Pure-numpy reference packer (same wire format as the native one)."""
    nb = len(pcm) // BLOCK
    x = pcm.astype(np.int32).reshape(nb, BLOCK)
    r = np.diff(x, n=order, axis=1)
    heads = np.ascontiguousarray(x[:, :order].astype(np.int16))
    words, total, counts, idx = _pack_from_residuals(r, order)
    return words, total, counts, idx, heads


def _pack_from_residuals(r: np.ndarray, order: int):
    """Group residual rows by signed width and bit-pack (shared by the fixed
    and LPC numpy packers; mirrors the native pack_core layout exactly)."""
    nb = r.shape[0]
    pay = payload_len(order)
    need = _signed_widths(r)
    ks = np.sort(_kset_arr)
    cls_sorted = ks[np.searchsorted(ks, need)]  # smallest KSET width >= need
    order_of = {k: j for j, k in enumerate(KSET)}
    cls = np.asarray([order_of[int(c)] for c in cls_sorted], np.int64)

    counts = np.bincount(cls, minlength=len(KSET)).astype(np.int64)
    # merge sparse groups into the nearest wider POPULATED width (as the
    # native packer does)
    for j in range(len(KSET) - 1, 0, -1):
        if 0 < counts[j] < _MERGE_MIN_ROWS:
            populated = np.nonzero(counts[:j] > 0)[0]
            if len(populated) == 0:
                continue  # widest populated group: keep as-is
            dst = int(populated[-1])
            cls[cls == j] = dst
            counts[dst] += counts[j]
            counts[j] = 0
    total = int(sum(counts[j] * words_per_block(KSET[j], order) for j in range(len(KSET))))
    words = np.zeros(total + 4, np.uint32)
    idx = np.empty(nb, np.int32)

    word_off = row_off = 0
    words64 = np.zeros(total + 4, np.uint64)
    for j, k in enumerate(KSET):
        rows = np.nonzero(cls == j)[0]
        if len(rows) == 0:
            continue
        wpb = words_per_block(k, order)
        idx[row_off : row_off + len(rows)] = rows
        vals = (r[rows].astype(np.int64) & ((1 << k) - 1)).astype(np.uint64)
        pos = np.arange(pay, dtype=np.int64) * k
        w = (pos >> 5) + word_off + np.arange(len(rows))[:, None] * wpb
        sh = (pos & 31).astype(np.uint64)
        v64 = vals << sh[None, :]
        np.add.at(words64, w, v64 & 0xFFFFFFFF)
        np.add.at(words64, w + 1, v64 >> np.uint64(32))
        word_off += len(rows) * wpb
        row_off += len(rows)
    words[:] = (words64 & 0xFFFFFFFF).astype(np.uint32)
    return words, total, counts, idx


def _lpc_residuals(x_blocks: np.ndarray, coeffs: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """Exact integer LPC residuals: r[n] = x[n] - ((sum_j c_j*x[n-j]) >> s)."""
    p = coeffs.shape[1]
    x64 = x_blocks.astype(np.int64)
    acc = np.zeros((x_blocks.shape[0], BLOCK - p), np.int64)
    for j in range(1, p + 1):
        acc += coeffs[:, j - 1].astype(np.int64)[:, None] * x64[:, p - j : BLOCK - j]
    pred = acc >> shifts.astype(np.int64)[:, None]  # arithmetic (floor) shift
    return (x64[:, p:] - pred).astype(np.int32)


def lpc_analyze_numpy(pcm: np.ndarray, p: int = LPC_ORDER) -> "tuple[np.ndarray, np.ndarray, int]":
    """Per-block LPC analysis: (coeffs (nb,p) int16, shifts (nb,) int8, bits).

    Autocorrelation + vectorized Levinson-Durbin per 256-sample block, then
    quantization under the sum|c| <= 32767 contract. Blocks whose exact
    residual would exceed the 19-bit ladder cap fall back to an order-1
    predictor (c=[1,0,...], shift 0). `bits` is the exact payload cost plus
    the per-block header (16p heads + 16p coeffs + 8 shift).
    """
    nb = len(pcm) // BLOCK
    x = pcm.astype(np.float64).reshape(nb, BLOCK)
    xi = pcm.astype(np.int32).reshape(nb, BLOCK)
    ac = np.empty((nb, p + 1))
    for lag in range(p + 1):
        ac[:, lag] = np.einsum("ij,ij->i", x[:, lag:], x[:, : BLOCK - lag])
    ac[:, 0] = ac[:, 0] * (1.0 + 1e-10) + 1e-10  # ridge: never singular

    # Levinson-Durbin over all blocks at once; a block that goes unstable
    # freezes at its lower-order coefficients
    a = np.zeros((nb, p))
    err = ac[:, 0].copy()
    alive = err > 0
    safe_err = np.where(err > 0, err, 1.0)
    for m in range(1, p + 1):
        acc = ac[:, m].copy()
        for j in range(1, m):
            acc = acc - a[:, j - 1] * ac[:, m - j]
        k = acc / safe_err
        ok = alive & np.isfinite(k) & (np.abs(k) < 1.0)
        k = np.where(ok, k, 0.0)
        new_a = a.copy()
        if m > 1:
            new_a[:, : m - 1] = a[:, : m - 1] - k[:, None] * a[:, m - 2 :: -1]
        new_a[:, m - 1] = k
        a = np.where(ok[:, None], new_a, a)
        err = np.where(ok, err * (1.0 - k * k), err)
        alive = ok & (err > 0)
        safe_err = np.where(err > 0, err, 1.0)

    # quantize: largest shift <= _LPC_MAX_SHIFT with sum|c| <= 32767
    asum = np.abs(a).sum(axis=1)
    with np.errstate(divide="ignore"):
        s = np.floor(np.log2(32767.0 / np.maximum(asum, 1e-300)))
    s = np.clip(np.where(np.isfinite(s), s, _LPC_MAX_SHIFT), 0, _LPC_MAX_SHIFT)
    s = s.astype(np.int64)

    def quant(shift):
        c = np.rint(a * np.power(2.0, shift)[:, None])
        return np.clip(c, -32768, 32767).astype(np.int16)

    c = quant(s)
    for _ in range(_LPC_MAX_SHIFT + 1):
        over = (np.abs(c.astype(np.int64)).sum(axis=1) > 32767) & (s > 0)
        if not over.any():
            break
        s = np.where(over, s - 1, s)
        c = np.where(over[:, None], quant(s), c)

    fallback = np.zeros(p, np.int16)
    fallback[0] = 1
    bad = np.abs(c.astype(np.int64)).sum(axis=1) > 32767  # degenerate at s=0
    if bad.any():
        c[bad] = fallback
        s[bad] = 0
    r = _lpc_residuals(xi, c, s)
    need = _signed_widths(r)
    overcap = need > KSET[0]
    if overcap.any():  # exceeds the ladder: order-1 inside the LPC frame
        c[overcap] = fallback
        s[overcap] = 0
        r = _lpc_residuals(xi, c, s)
        need = _signed_widths(r)
    bits = int((need * (BLOCK - p)).sum()) + nb * (16 * p + 16 * p + 8)
    return np.ascontiguousarray(c), s.astype(np.int8), bits


def pack_numpy_lpc(
    pcm: np.ndarray, coeffs: np.ndarray, shifts: np.ndarray
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]:
    """Pure-numpy LPC packer (same wire format as the native pack_pcm16_lpc)."""
    p = coeffs.shape[1]
    nb = len(pcm) // BLOCK
    xi = pcm.astype(np.int32).reshape(nb, BLOCK)
    r = _lpc_residuals(xi, coeffs, shifts)
    heads = np.ascontiguousarray(xi[:, :p].astype(np.int16))
    words, total, counts, idx = _pack_from_residuals(r, p)
    return words, total, counts, idx, heads


def _native_lpc_analyze(pcm: np.ndarray, p: int = LPC_ORDER):
    lib = _lib()
    if lib is None:
        return None
    nb = len(pcm) // BLOCK
    coeffs = np.empty((nb, p), np.int16)
    shifts = np.empty(nb, np.int8)
    bits = lib.lpc_analyze_pcm16(_ptr(pcm), ctypes.c_int64(len(pcm)), ctypes.c_int32(p), _ptr(coeffs), _ptr(shifts))
    if bits < 0:
        return None
    return coeffs, shifts, int(bits)


def _native_lpc_pack(pcm: np.ndarray, coeffs: np.ndarray, shifts: np.ndarray):
    lib = _lib()
    if lib is None:
        return None
    p = coeffs.shape[1]
    nb = len(pcm) // BLOCK
    cap = nb * words_per_block(KSET[0], p) + 4
    words = np.empty(cap, np.uint32)
    idx = np.empty(nb, np.int32)
    heads = np.empty((nb, p), np.int16)
    counts = np.empty(len(KSET), np.int64)
    total = lib.pack_pcm16_lpc(
        _ptr(pcm), ctypes.c_int64(len(pcm)), ctypes.c_int32(p), _ptr(coeffs), _ptr(shifts),
        _ptr(_kset_arr), ctypes.c_int32(len(KSET)), _ptr(words), ctypes.c_int64(cap),
        _ptr(idx), _ptr(heads), _ptr(counts),
    )
    if total < 0:
        return None
    return words, int(total), counts, idx, heads


def _native_fixed_costs(pcm: np.ndarray) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    bits = np.empty(3, np.int64)
    lib.residual_order_costs(_ptr(pcm), ctypes.c_int64(len(pcm)), _ptr(bits))
    return bits


def fixed_costs_numpy(pcm: np.ndarray) -> np.ndarray:
    """Exact per-order payload+head bit costs for the fixed predictors."""
    nb = len(pcm) // BLOCK
    x = pcm[: nb * BLOCK].astype(np.int32).reshape(nb, BLOCK)
    bits = np.empty(3, np.int64)
    for i, order in enumerate(_ORDERS):
        need = _signed_widths(np.diff(x, n=order, axis=1))
        bits[i] = int((need * payload_len(order)).sum()) + 16 * order * nb
    return bits


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _quantize_words(n: int) -> int:
    """Round a words length up so only its top `_WORDS_SIG_BITS` bits are set
    (at most 3.1% more wire bytes; the JAX package's transfer-shape rule)."""
    if n <= (1 << _WORDS_SIG_BITS):
        return max(n, 1)
    quantum = 1 << (n.bit_length() - _WORDS_SIG_BITS)
    return -(-n // quantum) * quantum


def pack(pcm: np.ndarray, order: Optional[int] = None, mode: Optional[str] = None) -> PackedPCM:
    """int16 PCM -> PackedPCM (native packer when available, numpy otherwise).

    Input length is padded up to a whole number of blocks with zeros. With
    everything defaulted, the predictor is chosen per piece by exact packed
    bit cost: the cheapest fixed order (1..3), or per-block LPC (``mode=
    "lpc"``) when it beats the best fixed order by >= `_LPC_MARGIN`.
    Passing ``order`` pins a fixed order; passing ``mode`` pins the mode.
    """
    if pcm.dtype != np.int16 or pcm.ndim != 1:
        raise ValueError(f"pack takes 1-D int16 PCM, got {pcm.dtype} {pcm.shape}")
    if order is not None and order not in _ORDERS:
        raise ValueError(f"order must be one of {_ORDERS}, got {order}")
    if mode not in (None, "fixed", "lpc"):
        raise ValueError(f"mode must be None|'fixed'|'lpc', got {mode!r}")
    if order is not None and mode == "lpc":
        raise ValueError("order pins a FIXED predictor; do not combine with mode='lpc'")
    n = len(pcm)
    nb = -(-n // BLOCK)
    if nb * BLOCK != n:
        padded = np.zeros(nb * BLOCK, np.int16)
        padded[:n] = pcm
        pcm = padded
    pcm = np.ascontiguousarray(pcm)

    analysis = None
    if order is not None:
        mode = "fixed"
    elif mode == "lpc" or mode is None:
        analysis = _native_lpc_analyze(pcm)
        if analysis is None:
            analysis = lpc_analyze_numpy(pcm)
        if mode is None:
            fixed_bits = _native_fixed_costs(pcm)
            if fixed_bits is None:
                fixed_bits = fixed_costs_numpy(pcm)
            mode = "lpc" if analysis[2] < _LPC_MARGIN * int(fixed_bits.min()) else "fixed"

    coeffs = shifts = None
    if mode == "lpc":
        coeffs, shifts, _ = analysis
        packed = _native_lpc_pack(pcm, coeffs, shifts)
        if packed is None:
            packed = pack_numpy_lpc(pcm, coeffs, shifts)
        order = LPC_ORDER
    else:
        if order is None:
            order = _native_choose_order(pcm)
            if order is None:
                order = choose_order_numpy(pcm)
        packed = _native_pack(pcm, order)
        if packed is None:
            packed = pack_numpy(pcm, order)
    words, total, counts, idx, heads = packed

    groups: List[Tuple[int, int, int, np.ndarray]] = []
    word_off = row_off = 0
    needed = total
    for j, k in enumerate(KSET):
        rows = int(counts[j])
        if rows:
            bucket = _bucket(rows)
            gidx = np.full(bucket, nb, np.int32)
            gidx[:rows] = idx[row_off : row_off + rows]
            groups.append((k, word_off, rows, gidx))
            # the words cover the bucket-padded over-read of every group
            needed = max(needed, word_off + bucket * words_per_block(k, order))
        word_off += rows * words_per_block(k, order)
        row_off += rows
    needed = _quantize_words(needed)
    # the native packers allocate with np.empty: zero the slack between the
    # real payload and the quantized length so the wire is deterministic
    words[total : min(needed, len(words))] = 0
    if needed > len(words):
        words = np.concatenate([words, np.zeros(needed - len(words), np.uint32)])
    return PackedPCM(words[:needed], groups, heads, n, nb, order, coeffs, shifts)


# --------------------------------------------------------------------------
# the wire: one byte buffer per piece, one host->device copy
# --------------------------------------------------------------------------


class WireLayout(NamedTuple):
    """Where each part of a packed piece lies in its wire buffer (byte
    offsets, 16-byte aligned) and the piece's geometry."""

    nb: int
    order: int
    lpc: bool
    n_groups: int
    groups_off: int  # int32 (n_groups, 4): k, word_off, first stream row, first idx slot
    words_off: int  # uint32 words
    idx_off: int  # int32 bucket-padded idx of every group, back to back
    heads_off: int  # int16 (nb, order)
    coeffs_off: int  # int16 (nb, order), lpc only
    shifts_off: int  # int8 (nb,), lpc only
    n_words: int
    n_idx: int
    nbytes: int


def _align(n: int) -> int:
    return -(-n // 16) * 16


def to_wire(packed: PackedPCM) -> Tuple[np.ndarray, WireLayout]:
    """The piece as one uint8 buffer: a table of its groups, then exactly the
    arrays `PackedPCM.packed_bytes` counts."""
    table = np.zeros((len(packed.groups), 4), np.int32)
    row = slot = 0
    for g, (k, word_off, n_rows, gidx) in enumerate(packed.groups):
        table[g] = (k, word_off, row, slot)
        row += n_rows
        slot += len(gidx)
    idx = np.concatenate([g[3] for g in packed.groups]) if packed.groups else np.zeros(0, np.int32)
    lpc = packed.coeffs is not None
    parts = [table, packed.words, idx, packed.heads]
    if lpc:
        parts += [packed.coeffs, packed.shifts]
    offsets = []
    off = 0
    for part in parts:
        offsets.append(off)
        off = _align(off + part.nbytes)
    wire = np.zeros(off, np.uint8)
    for o, part in zip(offsets, parts):
        wire[o : o + part.nbytes] = np.ascontiguousarray(part).reshape(-1).view(np.uint8)
    offsets += [0, 0] if not lpc else []
    layout = WireLayout(
        packed.nb, packed.order, lpc, len(packed.groups), *offsets, len(packed.words), len(idx), off
    )
    return wire, layout


def _wire_views(wire: torch.Tensor, layout: WireLayout):
    def view(off: int, count: int, dtype: torch.dtype) -> torch.Tensor:
        size = torch.empty((), dtype=dtype).element_size()
        return wire[off : off + count * size].view(dtype)

    nb, order = layout.nb, layout.order
    table = view(layout.groups_off, 4 * layout.n_groups, torch.int32).reshape(layout.n_groups, 4)
    words = view(layout.words_off, layout.n_words, torch.int32)
    idx = view(layout.idx_off, layout.n_idx, torch.int32)
    heads = view(layout.heads_off, nb * order, torch.int16).reshape(nb, order)
    coeffs = shifts = None
    if layout.lpc:
        coeffs = view(layout.coeffs_off, nb * order, torch.int16).reshape(nb, order)
        shifts = view(layout.shifts_off, nb, torch.int8)
    return table, words, idx, heads, coeffs, shifts


# --------------------------------------------------------------------------
# device half
# --------------------------------------------------------------------------


def decode_plain(wire: torch.Tensor, layout: WireLayout, n_out: int) -> torch.Tensor:
    """The decode in plain PyTorch, on ``wire``'s device: the JAX package's
    `_unpack_scatter_fn` (static column shifts per k, sign extension, a
    scatter by idx), then `_finish_fn` (``order`` integer cumsums) or
    `_finish_lpc_fn` (the recurrence x[n] = r[n] + ((sum_j c_j x[n-j]) >>
    s), one vectorized step per sample), and the rescale to float32."""
    table, words, idx, heads, coeffs, shifts = _wire_views(wire, layout)
    nb, order = layout.nb, layout.order
    pay = payload_len(order)
    words = words.to(torch.int64) & 0xFFFFFFFF  # the u32 words, unsigned
    buf = torch.zeros((nb, pay), dtype=torch.int64, device=wire.device)
    rows_end = [int(r) for r in table[1:, 2].tolist()] + [nb]
    for (k, word_off, row0, slot0), row1 in zip(table.tolist(), rows_end):
        n_rows = row1 - row0
        wpb = words_per_block(k, order)
        stream = words[word_off : word_off + n_rows * wpb].reshape(n_rows, wpb)
        pos = torch.arange(pay, device=wire.device) * k
        cols0 = pos >> 5
        cols1 = torch.clamp(cols0 + 1, max=wpb - 1)
        sh = pos & 31
        w0 = stream[:, cols0]
        w1 = stream[:, cols1] & ((1 << sh) - 1)  # the bits that spill into the next word
        v = ((w0 >> sh) | (w1 << (32 - sh))) & ((1 << k) - 1)
        r = v - ((v & (1 << (k - 1))) << 1)  # two's-complement sign extension
        buf[idx[slot0 : slot0 + n_rows].long()] = r
    h = heads.to(torch.int64)
    if layout.lpc:
        c = coeffs.to(torch.int64)
        s = shifts.to(torch.int64)
        state = [h[:, j] for j in range(order)]  # x[n-p] .. x[n-1]
        xs = []
        for n in range(pay):
            acc = c[:, 0] * state[order - 1]
            for j in range(1, order):
                acc = acc + c[:, j] * state[order - 1 - j]
            x = buf[:, n] + torch.bitwise_right_shift(acc, s)
            state = state[1:] + [x]
            xs.append(x)
        xs = torch.stack(xs, dim=1)
    elif order == 1:
        xs = h[:, :1] + torch.cumsum(buf, dim=1)
    elif order == 2:
        dx = (h[:, 1] - h[:, 0])[:, None] + torch.cumsum(buf, dim=1)
        xs = h[:, 1:2] + torch.cumsum(dx, dim=1)
    else:
        d2 = (h[:, 2] - 2 * h[:, 1] + h[:, 0])[:, None] + torch.cumsum(buf, dim=1)
        dx = (h[:, 2] - h[:, 1])[:, None] + torch.cumsum(d2, dim=1)
        xs = h[:, 2:3] + torch.cumsum(dx, dim=1)
    x = torch.cat([h, xs], dim=1).reshape(-1)[:n_out]
    return x.to(torch.float32) * (1.0 / 32768.0)


def kernel() -> ctypes.CDLL:
    """The decode kernel's library, built with nvcc at first use; raises
    when it cannot be built."""
    from basic_pitch_torch import _build

    lib = _build.load("pcm_decode")
    fn = lib.pcm_decode_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def decode_wire(wire: torch.Tensor, layout: WireLayout, n_out: int) -> torch.Tensor:
    """float32 (n_out,) samples of a wire buffer already on its device: the
    CUDA kernel for a CUDA tensor, `decode_plain` for a CPU tensor."""
    global launches
    if not 0 <= n_out <= layout.nb * BLOCK:
        raise ValueError(f"n_out {n_out} must lie in 0 .. {layout.nb * BLOCK}")
    if wire.dtype != torch.uint8 or wire.ndim != 1 or wire.numel() < layout.nbytes:
        raise ValueError(f"wire must be a 1-D uint8 tensor of >= {layout.nbytes} bytes")
    if wire.device.type == "cpu":
        return decode_plain(wire, layout, n_out)
    if wire.device.type != "cuda":
        raise ValueError(f"decode_wire takes CPU or CUDA tensors, got {wire.device}")
    if layout.lpc and layout.order != LPC_ORDER:
        raise ValueError(f"the kernel decodes LPC of order {LPC_ORDER}, got {layout.order}")
    if not wire.is_contiguous() or wire.data_ptr() % 16:
        raise ValueError("wire must be contiguous and 16-byte aligned")
    if layout.nbytes >= 2**31 or layout.nb * BLOCK >= 2**31:
        raise ValueError("the kernel takes pieces under 2**31 bytes and samples")
    lib = kernel()
    out = torch.empty(n_out, dtype=torch.float32, device=wire.device)
    if layout.nb == 0 or n_out == 0:
        return out
    with torch.cuda.device(wire.device):
        stream = torch.cuda.current_stream(wire.device).cuda_stream
        err = lib.pcm_decode_launch(
            wire.data_ptr(), layout.groups_off, layout.n_groups, layout.words_off, layout.idx_off,
            layout.heads_off, layout.coeffs_off, layout.shifts_off, layout.nb, layout.order,
            1 if layout.lpc else 0, n_out, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"pcm_decode kernel launch failed: cudaError_t {err}")
    launches += 1
    return out


def decode_to_device(
    packed: PackedPCM, n_out: Optional[int] = None, device: "str | torch.device | None" = None
) -> torch.Tensor:
    """Upload a PackedPCM and reconstruct float32 samples on ``device`` ("cuda"
    when None, which raises without a GPU), equal to
    ``pcm.astype(float32) / 32768`` bit for bit. Nothing here waits for the
    device."""
    from basic_pitch_torch.pipeline import resolve_device

    dev = resolve_device(device)
    wire, layout = to_wire(packed)
    host = torch.from_numpy(wire)
    # one copy, asynchronous from pinned memory (the caching host allocator
    # keeps the pinned block until the copy has landed)
    on_dev = host if dev.type == "cpu" else host.pin_memory().to(dev, non_blocking=True)
    return decode_wire(on_dev, layout, packed.n_samples if n_out is None else n_out)


def encode_decode(pcm: np.ndarray, device: "str | torch.device | None" = None) -> torch.Tensor:
    """pack + decode_to_device in one call."""
    return decode_to_device(pack(pcm), device=device)
