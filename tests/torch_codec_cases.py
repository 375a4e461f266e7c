"""Pieces for the PCM codec's decode (`basic_pitch_torch/ops/pcmcodec.py`)
that put group edges, CTA edges and unaligned spans where the CUDA kernel
tiles its rows, shared by the CPU tests, the card's tests and
`chip_smoke.py`. Not a test module: pytest collects nothing here.

The kernel takes 32 consecutive stream rows per CTA and stages their words
as one span. `pcmcodec.pack` merges groups under 64 rows, so its wires
rarely put a group edge inside a CTA; `pack_with_widths` builds a wire of
the same format with each block in the group its caller names, so groups of
one to three rows, and group starts off a 16-byte boundary, can be made on
purpose.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from basic_pitch_torch.ops import pcmcodec


def _pack_rows(r: np.ndarray, k: int, order: int) -> np.ndarray:
    """Rows of residuals (n, 256 - order) as back-to-back k-bit rows of u32
    words, each row 32-bit aligned (the packers' layout)."""
    wpb = pcmcodec.words_per_block(k, order)
    n = r.shape[0]
    vals = (r.astype(np.int64) & ((1 << k) - 1)).astype(np.uint64)
    pos = np.arange(r.shape[1], dtype=np.int64) * k
    w = (pos >> 5)[None, :] + np.arange(n)[:, None] * wpb
    v64 = vals << (pos & 31).astype(np.uint64)[None, :]
    acc = np.zeros(n * wpb + 1, np.uint64)
    np.add.at(acc, w, v64 & np.uint64(0xFFFFFFFF))
    np.add.at(acc, w + 1, v64 >> np.uint64(32))
    return (acc[: n * wpb] & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def pack_with_widths(pcm: np.ndarray, widths: np.ndarray, order: int = 1, lpc: bool = False) -> pcmcodec.PackedPCM:
    """A PackedPCM of ``pcm`` (padded to whole blocks) in which block b lies
    in the group of width ``widths[b]`` (a width of KSET; a block that needs
    more goes to the smallest width that holds it), with no merging of small
    groups: fixed order ``order``, or LPC of order 8 with the numpy
    analyzer's coefficients. Groups, bucket-padded idx and the quantized
    words follow `pcmcodec.pack`."""
    n = len(pcm)
    nb = -(-n // pcmcodec.BLOCK)
    x = np.zeros(nb * pcmcodec.BLOCK, np.int16)
    x[:n] = pcm
    xi = x.astype(np.int32).reshape(nb, pcmcodec.BLOCK)
    coeffs = shifts = None
    if lpc:
        coeffs, shifts, _ = pcmcodec.lpc_analyze_numpy(x)
        r = pcmcodec._lpc_residuals(xi, coeffs, shifts)
        order = pcmcodec.LPC_ORDER
    else:
        r = np.diff(xi, n=order, axis=1)
    heads = np.ascontiguousarray(xi[:, :order].astype(np.int16))
    ks = np.sort(np.asarray(pcmcodec.KSET))
    need = pcmcodec._signed_widths(r)
    widths = ks[np.searchsorted(ks, np.maximum(np.asarray(widths), need))]
    groups: List[Tuple[int, int, int, np.ndarray]] = []
    parts = []
    word_off = needed = 0
    for k in pcmcodec.KSET:
        rows = np.nonzero(widths == k)[0]
        if not len(rows):
            continue
        wpb = pcmcodec.words_per_block(k, order)
        parts.append(_pack_rows(r[rows], k, order))
        bucket = pcmcodec._bucket(len(rows))
        gidx = np.full(bucket, nb, np.int32)
        gidx[: len(rows)] = rows
        groups.append((k, word_off, len(rows), gidx))
        needed = max(needed, word_off + bucket * wpb)
        word_off += len(rows) * wpb
    words = np.zeros(pcmcodec._quantize_words(max(needed, word_off)), np.uint32)
    words[:word_off] = np.concatenate(parts)
    return pcmcodec.PackedPCM(words, groups, heads, n, nb, order, coeffs, shifts)


def alternation(order: int, k: int, blocks: int = 1, sign: int = 1) -> np.ndarray:
    """int16 blocks alternating +a, -a, the largest a whose order-`order`
    residuals (+-2**order * a) fit in k bits."""
    a = min(((1 << (k - 1)) - 1) >> order, 32767)
    return np.tile(np.array([sign * a, -sign * a], np.int16), pcmcodec.BLOCK * blocks // 2)


def ladder(order: int, rows_per_width: "list[int]", seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A piece whose blocks take every width of KSET, ``rows_per_width[j]``
    blocks of width KSET[j], in a seeded shuffled order (so each group's idx
    is scattered); returns (pcm, widths)."""
    rng = np.random.RandomState(seed)
    widths = np.repeat(np.asarray(pcmcodec.KSET), rows_per_width)
    widths = widths[rng.permutation(len(widths))]
    pcm = np.concatenate([alternation(order, int(k), sign=int(rng.choice([-1, 1]))) for k in widths])
    return pcm, widths


def tiling_cases() -> List[Tuple[str, np.ndarray, pcmcodec.PackedPCM]]:
    """(name, pcm, packed) for the kernel's tiling: a piece of one block; a
    ladder of every width with groups of one to three rows, so group edges
    fall inside a CTA's 32 rows; block counts that are not a multiple of
    32; group starts off a 16-byte boundary of the words. Every order and
    LPC."""
    rng = np.random.RandomState(5)
    cases = []
    one_block = (rng.randn(pcmcodec.BLOCK) * 3000).astype(np.int16)
    for kw in ({"order": 1}, {"order": 2}, {"order": 3}, {"mode": "lpc"}):
        cases.append((f"one block {kw}", one_block, pcmcodec.pack(one_block, **kw)))
        cases.append((f"one short block {kw}", one_block[:200], pcmcodec.pack(one_block[:200], **kw)))
    small = [1 + j % 3 for j in range(len(pcmcodec.KSET))]  # 36 blocks: 1, 2, 3, 1, ...
    for order in (1, 2, 3):
        pcm, widths = ladder(order, small, seed=order)
        cases.append((f"ladder of 1-3 row groups, order {order}", pcm, pack_with_widths(pcm, widths, order)))
        pcm, widths = ladder(order, [4 + j % 5 for j in range(len(pcmcodec.KSET))], seed=10 + order)
        cut = len(pcm) - 77  # the last block short
        cases.append((f"ladder, {len(widths)} blocks, order {order}", pcm[:cut],
                      pack_with_widths(pcm[:cut], widths, order)))
    n = 64 * pcmcodec.BLOCK
    tones = (np.sin(np.arange(n) * 0.05) * 9000 + rng.randn(n) * 40).astype(np.int16)
    widths = np.asarray(pcmcodec.KSET)[rng.randint(0, len(pcmcodec.KSET), 45)]
    cases.append(("lpc ladder, 45 blocks", tones[: 45 * pcmcodec.BLOCK],
                  pack_with_widths(tones[: 45 * pcmcodec.BLOCK], widths, lpc=True)))
    for nb in (33, 45, 63):
        cases.append((f"{nb} blocks", tones[: nb * pcmcodec.BLOCK - 3], pcmcodec.pack(tones[: nb * pcmcodec.BLOCK - 3])))
    # order 3 at k >= 11 and order 2 at k >= 16 have an odd number of words
    # a row, so a group after one with an odd row count starts off 16 bytes
    for order, ks in ((3, (11, 13, 19)), (2, (16, 17, 19))):
        widths = np.repeat(np.asarray(ks), (3, 5, 7))
        pcm = np.concatenate([alternation(order, int(k)) for k in widths])
        packed = pack_with_widths(pcm, widths, order)
        assert any(g[1] % 4 for g in packed.groups), "no group start off a 16-byte boundary"
        cases.append((f"unaligned group starts, order {order}", pcm, packed))
    return cases
