"""One query per row and head against a cache of keys and values: the
attention of an MT3 decode step, over its self-attention cache and over
its encoder's cross-attention keys and values.

It replaces no TPU kernel: the JAX package runs no seq2seq model. It was
added because a decode step's attention is a product of one query with a
cache that only grows, which a matmul library runs as batched
matrix-vector products, two of them with a softmax between, each reading
or writing (rows, heads, length) scores through device memory. Here one
program of the Triton kernel `_mt3_cache_attention` takes one (row, head):
it streams the cache's keys and values once, in blocks of ``BLOCK_T``
positions up to a length it reads from device memory, with an online
softmax, and writes 64 outputs. It is bound by
the bytes of the cache it reads (K and V, float32: 2 x length x 64 x 4
bytes per row and head), so its bound on the card is those bytes at the
HBM rate. Products and sums are float32 on the CUDA cores (no `tl.dot`,
so no TF32).

`cache_attention` launches the kernel for a CUDA tensor and takes the
plain version, `cache_attention_plain`, for a CPU tensor; `LAUNCHES`
counts the wrapper's launches (a CUDA graph's replays relaunch the kernel
without the wrapper, and count nothing).
"""

from __future__ import annotations

import functools

import torch

BLOCK_T = 64  # cache positions a program loads at a time
LAUNCHES = 0


def cache_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v per row and head over the cache's first ``length``
    positions (a one-element integer tensor, at least 1), with no scaling:
    q (n, H, D), k and v (n, H, T, D) (any strides) -> (n, H, D)."""
    scores = torch.einsum("nhd,nhtd->nht", q, k)
    past = torch.arange(k.shape[2], device=k.device) >= length
    return torch.einsum("nht,nhtd->nhd", torch.softmax(scores.masked_fill(past, float("-inf")), -1), v)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _mt3_cache_attention(
        q_ptr, k_ptr, v_ptr, o_ptr, len_ptr,
        sq_n, sq_h, sk_n, sk_h, sk_t, sv_n, sv_h, sv_t, so_n, so_h,
        D: tl.constexpr, BLOCK: tl.constexpr,
    ):
        row = tl.program_id(0).to(tl.int64)
        head = tl.program_id(1).to(tl.int64)
        d = tl.arange(0, D)
        length = tl.load(len_ptr).to(tl.int32)
        q = tl.load(q_ptr + row * sq_n + head * sq_h + d)
        k_base = k_ptr + row * sk_n + head * sk_h
        v_base = v_ptr + row * sv_n + head * sv_h
        m = -float("inf")
        total = 0.0
        acc = tl.zeros([D], dtype=tl.float32)
        for start in range(0, length, BLOCK):
            t = start + tl.arange(0, BLOCK)
            live = t < length
            kb = tl.load(k_base + t[:, None] * sk_t + d[None, :], mask=live[:, None], other=0.0)
            s = tl.where(live, tl.sum(kb * q[None, :], axis=1), -float("inf"))
            m_new = tl.maximum(m, tl.max(s, axis=0))
            scale = tl.exp(m - m_new)
            p = tl.exp(s - m_new)
            total = total * scale + tl.sum(p, axis=0)
            vb = tl.load(v_base + t[:, None] * sv_t + d[None, :], mask=live[:, None], other=0.0)
            acc = acc * scale + tl.sum(p[:, None] * vb, axis=0)
            m = m_new
        tl.store(o_ptr + row * so_n + head * so_h + d, acc / total)

    return _mt3_cache_attention


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v for q (n, H, D) and k, v (n, H, T, D) whose last
    dimension is contiguous, over the first ``length`` positions of the
    cache (a one-element integer tensor on the same device, 1 to T, read by
    the kernel: no host value, so a CUDA graph can hold the launch): the
    Triton kernel on a CUDA tensor, the plain version on the CPU."""
    if not q.is_cuda:
        return cache_attention_plain(q, k, v, length)
    global LAUNCHES
    n, h, d = q.shape
    t = k.shape[2]
    if k.shape != (n, h, t, d) or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)} / {tuple(v.shape)} do not fit queries {tuple(q.shape)}")
    if q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError("cache_attention takes float32")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1 or t < 1 or d & (d - 1):
        raise ValueError("cache_attention needs a contiguous head dimension of a power-of-two size and a non-empty cache")
    if length.numel() != 1 or length.dtype not in (torch.int32, torch.int64) or length.device != q.device:
        raise ValueError("cache_attention takes the length as a one-element integer tensor on the queries' device")
    out = torch.empty((n, h, d), dtype=torch.float32, device=q.device)
    if n:
        _kernel()[(n, h)](
            q, k, v, out, length,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            D=d, BLOCK=BLOCK_T, num_warps=4,
        )
        LAUNCHES += 1
    return out
