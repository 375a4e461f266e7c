"""Plain reference of MT3 (Gardner et al., ICLR 2022; github.com/magenta/mt3)
in PyTorch, for float32 and float64.

It imports nothing of the program under test. Every matrix product runs
with TF32 off (``tf32=True`` turns it on, for the benchmark's control). No
kernels, no cache, no packing: the greedy loop recomputes the whole decoder
forward pass for every token. Rows of a batch are independent.

The network is T5.1.1-small as `mt3/gin/model.gin` and `mt3/network.py`
set it:

    mel (256 frames, 512 bins) -> dense 512 -> 512, plus sinusoidal
      positions (sin in the first half of the features, cos in the second;
      inverse timescales geometric from 1 to 1e-4)
    -> 8 encoder layers: x += Attn(RMS(x)); x += MLP(RMS(x)) -> RMS
    decoder: token embedding plus the same positions
    -> 8 decoder layers: causal self-attention, cross-attention on the
       encoder output, MLP, each pre-norm with a residual -> RMS
    -> untied dense to the vocabulary

    RMS(x) = x / sqrt(mean(x^2) + 1e-6) * g; attention has 6 heads of 64,
    softmax(q k^T) v with no 1/sqrt(64) (T5X folds it into Wq's
    initialisation, and `init_params` does the same); MLP
    (gelu_tanh(x W0) * x W1) W2, 512 -> 1024 -> 512; no bias anywhere.

The front end: 16 kHz audio, cut into segments of 256 frames x hop 128 =
32 768 samples (zero after the recording); per segment a periodic Hann
STFT of 2048 points (frames start every 128 samples, zeros past the
segment's end: `tf.signal.stft(pad_end=True)`), the magnitude, an HTK-mel
matrix of 512 bands over 20-8000 Hz as `tf.signal.linear_to_mel_weight_matrix`
builds it, then log(max(mel, 1e-5)).

The vocabulary: PAD 0, EOS 1, UNK 2, then MT3's event codec in its order:
shift 0..1000 (10 ms steps, absolute within the segment), pitch 0..127,
velocity 0..1, tie, program 0..127, drum 0..127: 1 391 ids. Decoding
starts from PAD.

Departures from MT3, each deliberate:

- 44.1 kHz audio goes to 16 kHz through `scipy.signal.resample_poly(x,
  160, 441)` with scipy's default Kaiser filter; MT3 loads audio through
  librosa.
- The embedding and logit rows are padded from 1 391 to 1 408 (a multiple
  of 128); the padding rows are never chosen. MT3's vocabulary also holds
  100 unused extra ids, left out here.
- Weights are drawn from a seed (`init_params`), T5X's initialisers in
  form: normal with variance 1/fan_in, the query's divided by 64, the
  embedding's variance 1, norm scales 1. No checkpoint is read.
- A segment's events are placed on the 10 ms grid by their offset from the
  segment's start (`round((t - start) * 100)`); MT3 counts the 10 ms steps
  between frame times. A note belongs to the segment its onset (offset)
  falls in; a note whose onset lies in an earlier segment and whose offset
  in this one or later is tied into it.
- Drums become notes of ``drum_note_s`` (MT3: 10 ms); programs are
  reported per event, drums as 128.
- A segment's state (program 0, velocity 100) starts afresh; notes still
  open at a recording's end are closed there; a segment that ends inside
  its tie section leaves every open note open.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD, EOS, UNK = 0, 1, 2
N_SPECIAL = 3
STEPS_PER_SECOND = 100
MAX_SHIFT_STEPS = 1000
N_PITCHES = 128
N_VELOCITY_BINS = 1
N_PROGRAMS = 128
# (event type, number of values), in the codec's order
EVENT_RANGES = (
    ("shift", MAX_SHIFT_STEPS + 1),
    ("pitch", N_PITCHES),
    ("velocity", N_VELOCITY_BINS + 1),
    ("tie", 1),
    ("program", N_PROGRAMS),
    ("drum", N_PITCHES),
)
FIRST_ID = {}
_offset = N_SPECIAL
for _name, _n in EVENT_RANGES:
    FIRST_ID[_name] = _offset
    _offset += _n
VOCAB = _offset  # 1 391
MAX_VELOCITY = 127
DEFAULT_VELOCITY = 100
DRUM_PROGRAM = 128
MIN_NOTE_S = 0.01


@dataclasses.dataclass(frozen=True)
class Config:
    """MT3's published sizes (T5.1.1-small and its spectrogram)."""

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

    @property
    def segment_s(self) -> float:
        return self.segment_samples / self.sample_rate

    @classmethod
    def from_dict(cls, d: Dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """TF32 on or off for matmuls and cuDNN inside the block, restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------


def to_16k(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """int16 (scaled by 1/32768) or float audio at 44.1 or 16 kHz -> float64
    at 16 kHz."""
    from scipy.signal import resample_poly

    x = audio.astype(np.float64) / 32768.0 if audio.dtype == np.int16 else audio.astype(np.float64)
    if sample_rate == 16000:
        return x
    if sample_rate != 44100:
        raise ValueError(f"expected 44100 or 16000 Hz, got {sample_rate}")
    return resample_poly(x, 160, 441)


def segments(x16: np.ndarray, cfg: Config) -> np.ndarray:
    """(n_segments, segment_samples) of 16 kHz audio, zeros after its end;
    at least one segment."""
    n = cfg.segment_samples
    count = max(1, -(-len(x16) // n))
    out = np.zeros((count, n), np.float64)
    out.reshape(-1)[: len(x16)] = x16
    return out


def mel_matrix(cfg: Config) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels): `tf.signal.linear_to_mel_weight_matrix`'s
    triangles on the HTK mel scale, the DC bin zero."""

    def to_mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    n_bins = cfg.n_fft // 2 + 1
    freqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_bins)[1:]
    mel = to_mel(freqs)[:, None]
    edges = np.linspace(to_mel(cfg.f_min), to_mel(cfg.f_max), cfg.n_mels + 2)
    lower, center, upper = edges[:-2][None], edges[1:-1][None], edges[2:][None]
    weights = np.maximum(0.0, np.minimum((mel - lower) / (center - lower), (upper - mel) / (upper - center)))
    return np.concatenate([np.zeros((1, cfg.n_mels)), weights])


def log_mel(segs: torch.Tensor, cfg: Config, tf32: bool = False) -> torch.Tensor:
    """(B, segment_samples) -> (B, frames, n_mels) log-mel magnitudes."""
    n = segs.shape[1]
    padded = F.pad(segs, (0, cfg.n_fft - cfg.hop))
    frames = padded.unfold(1, cfg.n_fft, cfg.hop)[:, : -(-n // cfg.hop)]
    k = torch.arange(cfg.n_fft, dtype=torch.float64, device=segs.device)
    hann = (0.5 - 0.5 * torch.cos(2 * math.pi * k / cfg.n_fft)).to(segs.dtype)
    mag = torch.fft.rfft(frames * hann, n=cfg.n_fft).abs()
    weights = torch.from_numpy(mel_matrix(cfg)).to(segs.device, segs.dtype)
    with matmul_precision(tf32):
        mel = mag @ weights
    return torch.log(torch.clamp(mel, min=cfg.log_floor))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def param_specs(cfg: Config) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """(name, shape, standard deviation) in the order of the draws; None is
    a norm scale of ones (not drawn)."""
    d, inner, m = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.d_mlp

    def attention(prefix):
        return [
            (f"{prefix}/q", (d, inner), (1.0 / d) ** 0.5 / cfg.d_head ** 0.5),
            (f"{prefix}/k", (d, inner), (1.0 / d) ** 0.5),
            (f"{prefix}/v", (d, inner), (1.0 / d) ** 0.5),
            (f"{prefix}/o", (inner, d), (1.0 / inner) ** 0.5),
        ]

    def mlp(prefix):
        return [
            (f"{prefix}/wi0", (d, m), (1.0 / d) ** 0.5),
            (f"{prefix}/wi1", (d, m), (1.0 / d) ** 0.5),
            (f"{prefix}/wo", (m, d), (1.0 / m) ** 0.5),
        ]

    specs = [("encoder/input", (cfg.n_mels, d), (1.0 / cfg.n_mels) ** 0.5)]
    for i in range(cfg.n_enc_layers):
        p = f"encoder/{i}"
        specs += [(f"{p}/attn_norm", (d,), None)] + attention(f"{p}/attn")
        specs += [(f"{p}/mlp_norm", (d,), None)] + mlp(f"{p}/mlp")
    specs += [("encoder/norm", (d,), None), ("decoder/embed", (cfg.vocab_padded, d), 1.0)]
    for i in range(cfg.n_dec_layers):
        p = f"decoder/{i}"
        specs += [(f"{p}/self_norm", (d,), None)] + attention(f"{p}/self")
        specs += [(f"{p}/cross_norm", (d,), None)] + attention(f"{p}/cross")
        specs += [(f"{p}/mlp_norm", (d,), None)] + mlp(f"{p}/mlp")
    specs += [("decoder/norm", (d,), None), ("decoder/logits", (d, cfg.vocab_padded), (1.0 / d) ** 0.5)]
    return specs


def init_params(cfg: Config, seed: int, device, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """The seeded weights: each drawn in float32 on ``device`` from one
    generator in `param_specs` order, then cast to ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, shape, std in param_specs(cfg):
        if std is None:
            w = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std
        out[name] = w.to(dtype)
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def positions(n: int, d: int, dtype, device) -> torch.Tensor:
    """(n, d) sinusoids: sin in the first d/2 features, cos in the rest,
    inverse timescales exp(-i ln(1e4) / (d/2 - 1))."""
    half = d // 2
    inv = np.exp(np.arange(half) * -np.log(1e4) / (half - 1))
    angle = np.arange(n)[:, None] * inv[None]
    return torch.from_numpy(np.concatenate([np.sin(angle), np.cos(angle)], 1)).to(device, dtype)


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def attention(params, prefix: str, x: torch.Tensor, memory: torch.Tensor, cfg: Config, causal: bool) -> torch.Tensor:
    """(B, T, d) queries over (B, S, d) memory; no scaling of the logits."""
    b, t, _ = x.shape
    s = memory.shape[1]
    h, dh = cfg.n_heads, cfg.d_head
    q = (x @ params[f"{prefix}/q"]).view(b, t, h, dh).transpose(1, 2)
    k = (memory @ params[f"{prefix}/k"]).view(b, s, h, dh).transpose(1, 2)
    v = (memory @ params[f"{prefix}/v"]).view(b, s, h, dh).transpose(1, 2)
    logits = q @ k.transpose(2, 3)
    if causal:
        mask = torch.ones(t, s, dtype=torch.bool, device=x.device).triu(1)
        logits = logits.masked_fill(mask, float("-inf"))
    out = torch.softmax(logits, -1) @ v
    return out.transpose(1, 2).reshape(b, t, h * dh) @ params[f"{prefix}/o"]


def mlp(params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    gate = F.gelu(x @ params[f"{prefix}/wi0"], approximate="tanh")
    return (gate * (x @ params[f"{prefix}/wi1"])) @ params[f"{prefix}/wo"]


def encode(params, mel: torch.Tensor, cfg: Config, tf32: bool = False) -> torch.Tensor:
    """(B, frames, n_mels) -> (B, frames, d_model)."""
    with matmul_precision(tf32):
        x = mel @ params["encoder/input"] + positions(mel.shape[1], cfg.d_model, mel.dtype, mel.device)
        for i in range(cfg.n_enc_layers):
            p = f"encoder/{i}"
            h = rms(x, params[f"{p}/attn_norm"], cfg.norm_eps)
            x = x + attention(params, f"{p}/attn", h, h, cfg, causal=False)
            x = x + mlp(params, f"{p}/mlp", rms(x, params[f"{p}/mlp_norm"], cfg.norm_eps))
        return rms(x, params["encoder/norm"], cfg.norm_eps)


def decode_logits(params, encoded: torch.Tensor, inputs: torch.Tensor, cfg: Config, tf32: bool = False) -> torch.Tensor:
    """The full decoder forward pass, no cache: (B, T) input ids (PAD first)
    -> (B, T, VOCAB) logits, position i predicting the token after input i."""
    with matmul_precision(tf32):
        x = params["decoder/embed"][inputs] + positions(inputs.shape[1], cfg.d_model, encoded.dtype, encoded.device)
        for i in range(cfg.n_dec_layers):
            p = f"decoder/{i}"
            h = rms(x, params[f"{p}/self_norm"], cfg.norm_eps)
            x = x + attention(params, f"{p}/self", h, h, cfg, causal=True)
            h = rms(x, params[f"{p}/cross_norm"], cfg.norm_eps)
            x = x + attention(params, f"{p}/cross", h, encoded, cfg, causal=False)
            x = x + mlp(params, f"{p}/mlp", rms(x, params[f"{p}/mlp_norm"], cfg.norm_eps))
        x = rms(x, params["decoder/norm"], cfg.norm_eps)
        return (x @ params["decoder/logits"])[..., :VOCAB]


def teacher_inputs(tokens: Sequence[int], device) -> torch.Tensor:
    """The decoder inputs that predict ``tokens``: PAD, then all but the last."""
    return torch.tensor([PAD] + list(tokens[:-1]), dtype=torch.long, device=device)


def greedy(
    params, encoded: torch.Tensor, caps: Sequence[int], budgeted: Sequence[bool], cfg: Config, tf32: bool = False
) -> Tuple[List[List[int]], List[torch.Tensor]]:
    """Greedy decoding by full recomputation. Row i emits at most caps[i]
    tokens; a budgeted row has EOS masked and emits exactly caps[i], any
    other stops after its first EOS. Returns each row's tokens and its
    (n_tokens, VOCAB) logits, EOS unmasked."""
    b = encoded.shape[0]
    steps = max(caps, default=0)
    inputs = torch.full((b, 1), PAD, dtype=torch.long, device=encoded.device)
    masked = torch.tensor(list(budgeted), dtype=torch.bool, device=encoded.device)
    logits_steps = []
    for _ in range(steps):
        logits = decode_logits(params, encoded, inputs, cfg, tf32)[:, -1]
        logits_steps.append(logits)
        choose = logits.clone()
        choose[masked, EOS] = float("-inf")
        inputs = torch.cat([inputs, choose.argmax(-1, keepdim=True)], 1)
    emitted = inputs[:, 1:].tolist()
    tokens, logits_out = [], []
    for i in range(b):
        row = emitted[i][: caps[i]]
        if not budgeted[i] and EOS in row:
            row = row[: row.index(EOS) + 1]
        tokens.append(row)
        logits_out.append(torch.stack([s[i] for s in logits_steps[: len(row)]]) if row else encoded.new_zeros((0, VOCAB)))
    return tokens, logits_out


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def token(kind: str, value: int = 0) -> int:
    return FIRST_ID[kind] + int(value)


def event_of(tok: int) -> Tuple[str, int]:
    """(event type, value) of a codec id; ("special", id) for PAD, EOS, UNK
    and the padding rows."""
    for name, n in EVENT_RANGES:
        if FIRST_ID[name] <= tok < FIRST_ID[name] + n:
            return name, tok - FIRST_ID[name]
    return "special", tok


def velocity_bin(velocity: int) -> int:
    return 0 if velocity == 0 else math.ceil(N_VELOCITY_BINS * velocity / MAX_VELOCITY)


def bin_velocity(bin_: int) -> int:
    return 0 if bin_ == 0 else int(MAX_VELOCITY * bin_ / N_VELOCITY_BINS)


def segment_of(t: float, cfg: Config) -> int:
    return int(math.floor(t / cfg.segment_s))


def step_in(t: float, k: int, cfg: Config) -> int:
    return min(MAX_SHIFT_STEPS, max(0, int(round((t - k * cfg.segment_s) * STEPS_PER_SECOND))))


def notes_to_tokens(notes: Sequence[Tuple], k: int, cfg: Config) -> List[int]:
    """MT3's targets for segment ``k``: the tie section, then the segment's
    events run-length encoded with absolute shifts and state changes
    (program, velocity) left out where they repeat. ``notes`` are (onset s,
    offset s, pitch, velocity, program, is_drum); drums have no offset."""
    tied = sorted(
        (pitch, program)
        for onset, offset, pitch, velocity, program, drum in notes
        if not drum and segment_of(onset, cfg) < k <= segment_of(offset, cfg)
    )
    events = []
    for onset, offset, pitch, velocity, program, drum in notes:
        if segment_of(onset, cfg) == k:
            events.append((step_in(onset, k, cfg), drum, program, velocity, pitch))
        if not drum and segment_of(offset, cfg) == k:
            events.append((step_in(offset, k, cfg), drum, program, 0, pitch))
    out: List[int] = []
    state = {"program": None, "velocity": None}

    def change(kind: str, value: int) -> bool:
        if state[kind] == value:
            return False
        state[kind] = value
        return True

    for pitch, program in tied:
        if change("program", program):
            out.append(token("program", program))
        out.append(token("pitch", pitch))
    out.append(token("tie"))
    at = 0
    for step, drum, program, velocity, pitch in sorted(events):
        parts = [] if drum else [("program", program)]
        parts.append(("velocity", velocity_bin(velocity)))
        parts = [(kind, value) for kind, value in parts if change(kind, value)]
        parts.append(("drum", pitch) if drum else ("pitch", pitch))
        if step != at:
            out.append(token("shift", step))
            at = step
        out += [token(kind, value) for kind, value in parts]
    return out


def tokens_to_events(segment_tokens: Sequence[Sequence[int]], duration_s: float, cfg: Config) -> Tuple[List[tuple], List[int]]:
    """One recording's segments of tokens -> (events, programs): events are
    (start s, end s, pitch, velocity / 127, None), sorted, and programs the
    MIDI program of each (128 for a drum). Ids that cannot stand where they
    are (a PAD or UNK, an offset of a note not sounding, a velocity in a tie
    section, a drum at velocity 0) are skipped; a segment ends at its first EOS."""
    active: Dict[Tuple[int, int], Tuple[float, int]] = {}
    notes: List[Tuple[float, float, int, int, int]] = []

    def close(key, end):
        onset, velocity = active.pop(key)
        notes.append((onset, max(end, onset + MIN_NOTE_S), key[0], velocity, key[1]))

    for k, toks in enumerate(segment_tokens):
        start = k * cfg.segment_samples / cfg.sample_rate
        program, velocity = 0, DEFAULT_VELOCITY
        steps, time = 0, start
        in_tie, tied = True, set()
        for tok in toks:
            if tok == EOS:
                break
            kind, value = event_of(int(tok))
            if kind == "shift":
                steps += value
                time = start + steps / STEPS_PER_SECOND
                continue
            steps = 0
            if kind == "program":
                program = value
            elif in_tie:
                if kind == "pitch" and (value, program) in active:
                    tied.add((value, program))
                elif kind == "tie":
                    for key in [key for key in active if key not in tied]:
                        close(key, start)
                    in_tie = False
            elif kind == "velocity":
                velocity = bin_velocity(value)
            elif kind == "pitch":
                key = (value, program)
                if key in active:
                    close(key, time)
                if velocity > 0:
                    active[key] = (time, velocity)
            elif kind == "drum" and velocity > 0:
                notes.append((time, time + cfg.drum_note_s, value, velocity, DRUM_PROGRAM))
    for key in list(active):
        close(key, duration_s)
    notes.sort(key=lambda n: (n[0], n[1], n[2], n[4]))
    return [(s, e, p, v / MAX_VELOCITY, None) for s, e, p, v, _ in notes], [n[4] for n in notes]
