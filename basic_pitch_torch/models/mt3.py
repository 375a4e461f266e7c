"""MT3's network, T5.1.1-small (Gardner et al., ICLR 2022; `mt3/gin/model.gin`
and `mt3/network.py`), with a cached greedy decoder.

    encoder: mel (frames, n_mels) -> dense -> + sinusoids -> layers of
      x += Attn(RMS(x)); x += MLP(RMS(x)) -> RMS
    decoder: embed(token) + sinusoid(position) -> layers of causal
      self-attention, cross-attention on the encoder output and the MLP,
      each pre-norm with a residual -> RMS -> untied logits

RMS(x) = x / sqrt(mean(x^2) + eps) * g. Attention is softmax(q k^T) v over
``n_heads`` heads of ``d_head``, with no 1/sqrt(d_head) (T5X folds it into
the query's initialisation, as `init_params` does); the MLP is
(gelu_tanh(x W0) * x W1) W2; nothing has a bias. The published sizes are
`Mt3Config`'s defaults: 8 + 8 layers, width 512, 6 heads of 64, MLP 1024,
256 frames of 512 mel bins, up to 1024 tokens. Weights are float32 and
every product runs with TF32 off (the transcriber sets the flags).

The vocabulary is PAD 0, EOS 1, UNK 2, then MT3's event codec
(`decode/mt3_codec.py`): 1 391 ids; the embedding and logit rows are
padded to ``vocab_padded`` (1 408, a multiple of 128), and the padding is
never chosen. Decoding starts from PAD.

`MT3.greedy` decodes a batch of segments at once. The rows are sorted by
the most tokens each may emit (``caps``), so at step t the rows still
decoding are a prefix of the batch: the step runs on that prefix, rounded
up to `ROW_BUCKET` rows, and a row whose count is reached leaves the
step's work with its bucket. A row with a token budget has EOS masked and
emits exactly its cap; any other row stops after its first EOS, which the
loop finds every `EOS_CHECK_STEPS` steps (until then such a row is
computed and ignored). The cross-attention keys and values are computed
once per batch (`cross_kv`) and the self-attention cache holds every row's
keys and values, both in buffers the model keeps, read by
`ops/cache_attention.py`. The cache holds the positions the largest cap
needs, rounded up to `POSITION_BUCKET`: it grows when a batch needs more
and never shrinks, so batches of like lengths share one set of buffers. A step reads no host value (its position lives
on the device), so on a GPU each step is the replay of a CUDA graph, one
per bucket, captured before the first decode that needs it: Python's
launches do not pace the loop.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from basic_pitch_torch.decode.mt3_codec import EOS, PAD, VOCAB
from basic_pitch_torch.ops.cache_attention import cache_attention
from basic_pitch_torch.utils import profiling

EOS_CHECK_STEPS = 16  # steps between looks for rows that have all emitted EOS
ROW_BUCKET = 16  # a decode step's rows are a multiple of this: one CUDA graph per multiple
POSITION_BUCKET = 64  # the self-attention cache's positions are a multiple of this


@dataclasses.dataclass(frozen=True)
class Mt3Config:
    """The network's and the front end's sizes; the defaults are MT3's."""

    n_enc_layers: int = 8
    n_dec_layers: int = 8
    d_model: int = 512
    n_heads: int = 6
    d_head: int = 64
    d_mlp: int = 1024
    norm_eps: float = 1e-6
    vocab_padded: int = 1408
    max_tokens: int = 1024
    sample_rate: int = 16000
    frames: int = 256
    hop: int = 128
    n_fft: int = 2048
    n_mels: int = 512
    f_min: float = 20.0
    f_max: float = 8000.0
    log_floor: float = 1e-5
    drum_note_s: float = 0.01

    @property
    def segment_samples(self) -> int:
        return self.frames * self.hop

    @classmethod
    def from_dict(cls, d: Dict) -> "Mt3Config":
        """The fields of ``d`` that name one of the config's (others ignored)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def param_specs(cfg: Mt3Config) -> List[tuple]:
    """(name, shape, std) in the order the weights are drawn; std None is a
    norm scale of ones. T5X's initialisers: variance 1/fan_in, the query's
    divided by d_head, the embedding's 1."""
    d, inner, m = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.d_mlp
    fan = {d: d ** -0.5, inner: inner ** -0.5, m: m ** -0.5}
    specs = [("encoder/input", (cfg.n_mels, d), cfg.n_mels ** -0.5)]

    def block(prefix: str, kinds: Sequence[str]) -> None:
        for kind in kinds:
            specs.append((f"{prefix}/{kind}_norm", (d,), None))
            if kind == "mlp":
                specs.extend([(f"{prefix}/mlp/wi0", (d, m), fan[d]), (f"{prefix}/mlp/wi1", (d, m), fan[d]),
                              (f"{prefix}/mlp/wo", (m, d), fan[m])])
            else:
                specs.extend([(f"{prefix}/{kind}/q", (d, inner), fan[d] * cfg.d_head ** -0.5),
                              (f"{prefix}/{kind}/k", (d, inner), fan[d]), (f"{prefix}/{kind}/v", (d, inner), fan[d]),
                              (f"{prefix}/{kind}/o", (inner, d), fan[inner])])

    for i in range(cfg.n_enc_layers):
        block(f"encoder/{i}", ("attn", "mlp"))
    specs += [("encoder/norm", (d,), None), ("decoder/embed", (cfg.vocab_padded, d), 1.0)]
    for i in range(cfg.n_dec_layers):
        block(f"decoder/{i}", ("self", "cross", "mlp"))
    specs += [("decoder/norm", (d,), None), ("decoder/logits", (d, cfg.vocab_padded), fan[d])]
    return specs


def init_params(cfg: Mt3Config, seed: int, device: "str | torch.device") -> Dict[str, torch.Tensor]:
    """Seeded float32 weights drawn on ``device`` by one generator, in
    `param_specs` order."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {
        name: torch.ones(shape, device=device) if std is None
        else torch.randn(shape, generator=gen, device=device) * std
        for name, shape, std in param_specs(cfg)
    }


def sinusoids(n: int, d: int) -> np.ndarray:
    """(n, d) float32: sin in the first d/2 features, cos in the rest, the
    inverse timescales geometric from 1 to 1e-4."""
    half = d // 2
    angle = np.arange(n)[:, None] * np.exp(-np.log(1e4) * np.arange(half) / (half - 1))[None]
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=1).astype(np.float32)


@dataclasses.dataclass
class Decoded:
    """A batch's greedy output, rows in the order given to `MT3.greedy`."""

    tokens: List[np.ndarray]  # each row's emitted ids (its EOS included)
    logits: Dict[int, np.ndarray]  # row -> (n_tokens, VOCAB) float32, EOS unmasked
    steps: int  # decode steps run
    rows_run: int  # rows the steps computed, summed over the steps


class MT3:
    """The network's weights on one device, fused for the decode step, and
    its encoder and cached decoder."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Mt3Config, device: torch.device):
        self.cfg = cfg
        self.device = device

        def w(name: str) -> torch.Tensor:
            return torch.as_tensor(params[name], dtype=torch.float32).to(device)

        def cat(*names: str) -> torch.Tensor:
            return torch.cat([w(n) for n in names], dim=1).contiguous()

        self.enc_in = w("encoder/input")
        self.enc_layers = [
            {
                "attn_norm": w(f"{p}/attn_norm"), "qkv": cat(f"{p}/attn/q", f"{p}/attn/k", f"{p}/attn/v"),
                "o": w(f"{p}/attn/o"), "mlp_norm": w(f"{p}/mlp_norm"),
                "wi": cat(f"{p}/mlp/wi0", f"{p}/mlp/wi1"), "wo": w(f"{p}/mlp/wo"),
            }
            for p in (f"encoder/{i}" for i in range(cfg.n_enc_layers))
        ]
        self.enc_norm = w("encoder/norm")
        self.embed = w("decoder/embed")
        self.dec_layers = [
            {
                "self_norm": w(f"{p}/self_norm"), "qkv": cat(f"{p}/self/q", f"{p}/self/k", f"{p}/self/v"),
                "o": w(f"{p}/self/o"), "cross_norm": w(f"{p}/cross_norm"), "cross_q": w(f"{p}/cross/q"),
                "cross_kv": cat(f"{p}/cross/k", f"{p}/cross/v"), "cross_o": w(f"{p}/cross/o"),
                "mlp_norm": w(f"{p}/mlp_norm"), "wi": cat(f"{p}/mlp/wi0", f"{p}/mlp/wi1"), "wo": w(f"{p}/mlp/wo"),
            }
            for p in (f"decoder/{i}" for i in range(cfg.n_dec_layers))
        ]
        self.dec_norm = w("decoder/norm")
        self.logits_w = w("decoder/logits")
        self.enc_pos = torch.from_numpy(sinusoids(cfg.frames, cfg.d_model)).to(device)
        self.dec_pos = torch.from_numpy(sinusoids(cfg.max_tokens, cfg.d_model)).to(device)
        self._state: Optional[Dict[str, torch.Tensor]] = None  # the decode's buffers (`_buffers`)
        self._graphs: Dict[tuple, "torch.cuda.CUDAGraph"] = {}
        self._pool = None  # the graphs' shared memory pool

    def _drop_graphs(self, keeping_only: bool = False) -> None:
        """Drop the captured graphs (with ``keeping_only``, those that keep
        logits). When none is left their pool goes too: the allocator
        releases a pool no graph holds, and capturing into its handle again
        fails."""
        for key in [key for key in self._graphs if key[1] or not keeping_only]:
            del self._graphs[key]
        if not self._graphs:
            self._pool = None

    def _rms(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, (x.shape[-1],), g, self.cfg.norm_eps)

    def _mlp(self, x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x + MLP(RMS(x)) for (n, d_model) rows, the residual added in the
        last product."""
        u = self._rms(x, layer["mlp_norm"]) @ layer["wi"]
        m = self.cfg.d_mlp
        return torch.addmm(x, F.gelu(u[:, :m], approximate="tanh") * u[:, m:], layer["wo"])

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, frames, n_mels) -> (B, frames, d_model)."""
        cfg = self.cfg
        b, s, _ = mel.shape
        h, dh = cfg.n_heads, cfg.d_head
        x = mel @ self.enc_in + self.enc_pos[:s]
        for layer in self.enc_layers:
            qkv = (self._rms(x, layer["attn_norm"]) @ layer["qkv"]).view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
            attn = torch.softmax(qkv[0] @ qkv[1].transpose(2, 3), dim=-1) @ qkv[2]
            x = x + attn.transpose(1, 2).reshape(b, s, h * dh) @ layer["o"]
            x = self._mlp(x.view(b * s, -1), layer).view(b, s, -1)
        return self._rms(x, self.enc_norm)

    def _buffers(self, rows: int) -> Dict[str, torch.Tensor]:
        """The decode's buffers for at least ``rows`` rows, made (zeroed) or
        made larger on demand; graphs captured on smaller ones go. The
        self-attention cache is made by `_positions`."""
        cfg = self.cfg
        rows = -(-max(rows, 1) // ROW_BUCKET) * ROW_BUCKET
        st = self._state
        if st is None or st["rows"] < rows:
            dev, h, dh = self.device, cfg.n_heads, cfg.d_head
            self._state = st = None  # the old buffers go before the new ones are made
            self._drop_graphs()
            st = self._state = {
                "rows": rows,
                "positions": 0,
                "cross": torch.zeros((cfg.n_dec_layers, 2, rows, h, cfg.frames, dh), device=dev),
                "cross_len": torch.tensor([cfg.frames], device=dev),
                "tok": torch.zeros(rows, dtype=torch.long, device=dev),
                "caps": torch.zeros(rows, dtype=torch.long, device=dev),
                "eos_bias": torch.zeros(rows, device=dev),
                "done": torch.zeros(rows, dtype=torch.bool, device=dev),
                "lengths": torch.zeros(rows, dtype=torch.long, device=dev),
                "t": torch.zeros(1, dtype=torch.long, device=dev),
            }
        return st

    def _positions(self, n: int) -> None:
        """Make the self-attention cache and the tokens' buffer hold at
        least ``n`` positions, rounded up to `POSITION_BUCKET` (at most
        ``max_tokens``): grown on demand, never shrunk; graphs captured on
        smaller ones go."""
        cfg, st = self.cfg, self._state
        n = min(cfg.max_tokens, -(-max(n, 1) // POSITION_BUCKET) * POSITION_BUCKET)
        if st["positions"] < n:
            rows, dev = st["rows"], self.device
            st.pop("cache", None)
            self._drop_graphs()
            st["cache"] = torch.zeros((cfg.n_dec_layers, 2, rows, cfg.n_heads, n, cfg.d_head), device=dev)
            st["tokens"] = torch.zeros((rows, n), dtype=torch.long, device=dev)
            st["positions"] = n

    def cache_bytes(self) -> Dict[str, int]:
        """The bytes the decode's caches hold now: the self-attention
        cache (``self_kv``, at ``positions`` positions a row) and the
        cross-attention keys and values (``cross_kv``), for ``rows`` rows."""
        st = self._state or {}
        return {
            "rows": st.get("rows", 0), "positions": st.get("positions", 0),
            "self_kv": st["cache"].nbytes if "cache" in st else 0,
            "cross_kv": st["cross"].nbytes if "cross" in st else 0,
        }

    @torch.inference_mode()
    def cross_kv(self, encoded: torch.Tensor) -> None:
        """Compute every decoder layer's cross-attention keys and values of a
        batch, (layers, 2, B, heads, frames, d_head), into the decode's
        buffers: `greedy` decodes this batch."""
        cfg = self.cfg
        b, s, _ = encoded.shape
        cross = self._buffers(b)["cross"]
        for i, layer in enumerate(self.dec_layers):
            cross[i, :, :b] = (encoded @ layer["cross_kv"]).view(b, s, 2, cfg.n_heads, cfg.d_head).permute(2, 0, 3, 1, 4)

    def _step(self, n: int, keep: bool) -> None:
        """One decode step of the buffers' first ``n`` rows at the step held
        on the device (``t``), in place: no host value enters it, so a CUDA
        graph can replay it."""
        cfg, st = self.cfg, self._state
        h, dh, inner = cfg.n_heads, cfg.d_head, cfg.n_heads * cfg.d_head
        t = st["t"]
        length = t + 1
        x = self.embed[st["tok"][:n]] + self.dec_pos.index_select(0, t)
        for i, layer in enumerate(self.dec_layers):
            k_cache, v_cache = st["cache"][i, 0, :n], st["cache"][i, 1, :n]
            qkv = (self._rms(x, layer["self_norm"]) @ layer["qkv"]).view(n, 3, h, dh)
            k_cache.index_copy_(2, t, qkv[:, 1].unsqueeze(2))
            v_cache.index_copy_(2, t, qkv[:, 2].unsqueeze(2))
            a = cache_attention(qkv[:, 0], k_cache, v_cache, length)
            x = torch.addmm(x, a.reshape(n, inner), layer["o"])
            q = (self._rms(x, layer["cross_norm"]) @ layer["cross_q"]).view(n, h, dh)
            a = cache_attention(q, st["cross"][i, 0, :n], st["cross"][i, 1, :n], st["cross_len"])
            x = torch.addmm(x, a.reshape(n, inner), layer["cross_o"])
            x = self._mlp(x, layer)
        logits = (self._rms(x, self.dec_norm) @ self.logits_w)[:, :VOCAB]
        if keep:
            st["history"][:n].index_copy_(1, t, logits.unsqueeze(1))
        logits[:, EOS] += st["eos_bias"][:n]
        tok = logits.argmax(-1)
        st["tokens"][:n].index_copy_(1, t, tok.unsqueeze(1))
        st["tok"][:n] = tok
        st["lengths"][:n] += ~st["done"][:n] & (st["caps"][:n] > t)
        st["done"][:n] |= tok == EOS
        t += 1

    def _graph(self, n: int, keep: bool) -> "torch.cuda.CUDAGraph":
        """The CUDA graph of `_step` on ``n`` rows, captured at first use
        (two warm-up steps at positions 0 and 1 first, which move the
        decode's state: capture before a decode starts)."""
        key = (n, keep)
        if key not in self._graphs:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._state["t"].zero_()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._step(n, keep)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                self._step(n, keep)
            self._graphs[key] = graph
        return self._graphs[key]

    @torch.inference_mode()
    def greedy(self, caps: Sequence[int], budgeted: Sequence[bool], keep: Sequence[int] = ()) -> Decoded:
        """Greedy decoding of the batch `cross_kv` set, its rows sorted by
        ``caps``, largest first. Row i emits at most caps[i] tokens; with
        budgeted[i] its EOS is masked and it emits exactly caps[i]. The
        logits of the rows in ``keep`` are returned too. At step t the step
        runs the rows with caps[i] > t, rounded up to `ROW_BUCKET` (the rows
        past them compute and are ignored); on a GPU each step is a CUDA
        graph replay, one graph per row count."""
        cfg = self.cfg
        caps = [int(c) for c in caps]
        if any(a < b for a, b in zip(caps, caps[1:])):
            raise ValueError("greedy takes rows sorted by caps, largest first")
        if caps and caps[0] > cfg.max_tokens:
            raise ValueError(f"a cap of {caps[0]} tokens is past the {cfg.max_tokens} positions")
        st = self._state
        b = len(caps)
        if st is None or st["rows"] < b:
            raise ValueError("greedy decodes the batch of the last cross_kv, which had fewer rows")
        steps = caps[0] if b else 0
        neg_caps = [-c for c in caps]  # ascending, for bisect

        def rows_at(t: int) -> int:
            live = bisect.bisect_left(neg_caps, -t)  # rows with caps > t
            return min(st["rows"], -(-live // ROW_BUCKET) * ROW_BUCKET)

        keep = sorted(int(i) for i in keep)
        self._positions(steps)
        if keep:  # the kept rows' logits, only for this decode
            st["history"] = torch.zeros((st["rows"], st["positions"], VOCAB), device=self.device)
        graphs = self.device.type == "cuda"
        if graphs:  # capture what this decode needs before its state is set
            for n in sorted({rows_at(t) for t in range(steps)}):
                self._graph(n, bool(keep))
        pad = st["rows"] - b
        st["caps"].copy_(torch.tensor(caps + [0] * pad))
        st["eos_bias"].copy_(torch.tensor([float("-inf") if m else 0.0 for m in budgeted] + [0.0] * pad))
        st["tok"].fill_(PAD)
        st["done"].zero_()
        st["lengths"].zero_()
        st["t"].zero_()
        watch = not all(budgeted)  # rows that stop at their EOS
        rows_run = run = 0
        for t in range(steps):
            n = rows_at(t)
            # a span per step: a profiler links each replay's kernels to it
            # (without one, every kernel of every replay links to the one
            # span around the loop, and reading the trace takes minutes)
            with profiling.span("bp.mt3.step"):
                if graphs:
                    self._graph(n, bool(keep)).replay()
                else:
                    self._step(n, bool(keep))
            rows_run += n
            run += 1
            if watch and (t + 1) % EOS_CHECK_STEPS == 0:
                nxt = bisect.bisect_left(neg_caps, -(t + 1))
                if nxt == 0 or bool(st["done"][:nxt].all()):
                    break
        lengths = st["lengths"][:b].tolist()
        tokens = st["tokens"][:b, :steps].cpu().numpy()
        kept = None
        if keep:  # the history and the graphs that write it go
            kept = st.pop("history")[keep, :steps].cpu().numpy()
            self._drop_graphs(keeping_only=True)
        return Decoded(
            tokens=[tokens[i, : lengths[i]].copy() for i in range(b)],
            logits={r: kept[j, : lengths[r]].copy() for j, r in enumerate(keep)},
            steps=run,
            rows_run=rows_run,
        )
