"""MT3's yardstick: operation and byte counts worked from shapes alone, at
the published widths (T5.1.1-small: 8 + 8 layers, width 512, 6 heads of
64, MLP 1024; 256 frames of 512 mel bins; logits over the 1 408 padded
rows), so that no change to the program can move them.

- `frontend_flops`: the matmuls of one segment's front end: the 160/441
  polyphase resampler (497 taps per 16 kHz output) and the mel weighting
  (1 025 linear bins to 512 per frame). The FFT and the elementwise work
  are left out.
- `encoder_flops`: the input projection and 8 layers of self-attention
  and MLP on 256 positions.
- `cross_kv_flops`: every decoder layer's cross-attention keys and values
  of one segment, computed once.
- `decode_step_flops(t)`: one token at step t (the self-attention cache
  holds t + 1 positions): 8 layers of projections, attention over the
  cache and the 256 encoder positions, MLP, and the logits.
- `segment_flops(n)`: a segment that emits n tokens, all of the above.
- `cache_attention_bytes(n)`: the least bytes the decode steps' attention
  reads for a segment of n tokens: at step t the row's self-attention keys
  and values at length t + 1, and its cross-attention keys and values, in
  every layer, float32, each read once.

The card's peaks are `pb/yardstick.py`'s `peak`.
"""

from __future__ import annotations

from pb.yardstick import peak  # noqa: F401  (the card's peaks, for the readers)

D_MODEL = 512
INNER = 6 * 64  # heads x head width
D_MLP = 1024
ENC_LAYERS = 8
DEC_LAYERS = 8
FRAMES = 256
N_MELS = 512
LINEAR_BINS = 1025
VOCAB_ROWS = 1408
SEGMENT_SAMPLES = 32768  # 16 kHz samples of one segment
POLY_TAPS = 497  # resampler inputs per output block
FLOAT_BYTES = 4

# per position: the q, k, v and output projections, and the gated MLP
_ATTN_PROJ = 2 * (D_MODEL * 3 * INNER + INNER * D_MODEL)
_MLP = 2 * (D_MODEL * 2 * D_MLP + D_MLP * D_MODEL)


def frontend_flops() -> int:
    return 2 * POLY_TAPS * SEGMENT_SAMPLES + 2 * FRAMES * LINEAR_BINS * N_MELS


def encoder_flops() -> int:
    per_layer = FRAMES * (_ATTN_PROJ + _MLP + 2 * 2 * FRAMES * INNER)
    return 2 * FRAMES * N_MELS * D_MODEL + ENC_LAYERS * per_layer


def cross_kv_flops() -> int:
    return DEC_LAYERS * FRAMES * 2 * D_MODEL * 2 * INNER


def decode_step_flops(t: int) -> int:
    """One token at step t (t = 0 for the first)."""
    per_layer = (
        _ATTN_PROJ  # self q, k, v, o
        + 2 * 2 * (t + 1) * INNER  # q k^T and p v over the cache
        + 2 * (D_MODEL * INNER + INNER * D_MODEL)  # cross q, o
        + 2 * 2 * FRAMES * INNER  # over the encoder positions
        + _MLP
    )
    return DEC_LAYERS * per_layer + 2 * D_MODEL * VOCAB_ROWS


def decode_flops(n: int) -> int:
    """The n decode steps of one segment (closed form of the sum)."""
    fixed = decode_step_flops(0) - DEC_LAYERS * 2 * 2 * INNER
    return n * fixed + DEC_LAYERS * 2 * 2 * INNER * n * (n + 1) // 2


def segment_flops(n: int) -> int:
    return frontend_flops() + encoder_flops() + cross_kv_flops() + decode_flops(n)


def cache_attention_bytes(n: int) -> int:
    kv = 2 * INNER * FLOAT_BYTES  # one position's key and value, all heads
    return DEC_LAYERS * kv * (n * (n + 1) // 2 + n * FRAMES)
