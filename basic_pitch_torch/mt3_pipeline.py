"""Batch transcription with MT3: raw PCM to note events through a seq2seq
model that writes notes as tokens.

A call's recordings are uploaded piece by piece through the port's shared
piece upload (`ops/upload.py`: one pinned buffer, raw int16 or the lossless
codec, as ``pcm_transport`` and its probe decide), and per piece, on the
device:

    int16 or float32 PCM at 44.1 kHz -> 16 kHz (`resample_160_441`, the
      160/441 polyphase filter of `scipy.signal.resample_poly` as one block
      matmul), zeros after the recording's end
    -> segments of 2.048 s (256 frames x hop 128), each its own log-mel
       (`ops/logmel.py`): (segments, 256, 512)

16 kHz input skips the resampler. The segments of all the call's
recordings are then packed, in order, into batches of at most
``segments_per_call``; per batch one encoder call, one cross-attention
key/value projection, and one greedy loop with a KV cache (`models/mt3.py`),
whose rows are the segments sorted by the most tokens each may emit. The
tokens come back to the host once per batch, and each recording's segments
are read back into events (`decode/mt3_codec.py`), ties carried across its
segments.

``token_budgets`` give, per recording, each segment's token count: EOS is
masked until that many tokens are out, and the segment stops there (a
generation library's ``min_new_tokens`` with a per-row ``max_new_tokens``);
without them a segment stops after its first EOS or ``max_new_tokens``.

While a profiler runs (`utils/profiling.py`), a call records
``bp.mt3.frontend`` per piece (upload, resample, log-mel),
``bp.mt3.encode`` (encoder and cross keys and values) and
``bp.mt3.decode`` (the greedy loop and the tokens' copy to the host) per
batch with ``bp.mt3.step`` per decode step inside it, and
``bp.mt3.detokenize`` per recording; and the counters
``mt3.segments``, ``mt3.decode_steps``, ``mt3.tokens_emitted`` and
``mt3.token_rows_run`` (per step, the rows the step computed).

Numerics are float32 with TF32 off, the port's rule: the constructor sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from basic_pitch_torch.decode import mt3_codec
from basic_pitch_torch.device import resolve_device
from basic_pitch_torch.models import mt3
from basic_pitch_torch.ops import logmel
from basic_pitch_torch.ops import pcmcodec
from basic_pitch_torch.ops import resample as resample_ops
from basic_pitch_torch.ops import transport
from basic_pitch_torch.ops import upload as upload_ops
from basic_pitch_torch.utils import profiling

PIECE_SEGMENTS = 60  # segments one upload covers (at most)


class Mt3Transcriber:
    """MT3 transcription of many recordings at once on one device.

    Args:
        weights: a seed (int) for `models.mt3.init_params`, drawn on the
            device, or a dict of the weights by their `param_specs` names.
        config: the network's and the front end's sizes (MT3's by default).
        device: "cuda" (the default; raises without a GPU) or "cpu".
        segments_per_call: the most segments one decode batch holds.
        max_new_tokens: the most tokens a segment emits (MT3's 1024).
        pcm_transport: "codec", "raw" or "auto" (the probe of
            `ops/transport.py`), as `pipeline.StreamingTranscriber` takes it.

    ``piece_upload_bytes`` counts the bytes of pieces that crossed the link
    (under "default").
    """

    def __init__(
        self,
        weights: "Union[int, Dict[str, torch.Tensor]]" = 0,
        config: Optional[mt3.Mt3Config] = None,
        *,
        device: "str | torch.device | None" = None,
        segments_per_call: int = 256,
        max_new_tokens: int = 1024,
        pcm_transport: str = "auto",
    ):
        self.device = resolve_device(device)
        self.cfg = config or mt3.Mt3Config()
        self.segments_per_call = int(segments_per_call)
        if self.segments_per_call < 1:
            raise ValueError("segments_per_call must be >= 1")
        self.max_new_tokens = int(max_new_tokens)
        if not 0 <= self.max_new_tokens <= self.cfg.max_tokens:
            raise ValueError(f"max_new_tokens must lie in [0, {self.cfg.max_tokens}], got {max_new_tokens}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.pcm_transport = transport.check_mode(pcm_transport)
        if self.pcm_transport == "codec":
            pcmcodec.packer()
            if self.device.type == "cuda":
                pcmcodec.kernel()
        elif self.pcm_transport == "auto":
            transport.resolve("auto", device=self.device)
        params = mt3.init_params(self.cfg, weights, self.device) if isinstance(weights, int) else weights
        self.model = mt3.MT3(params, self.cfg, self.device)
        cfg = self.cfg
        self._poly = torch.from_numpy(resample_ops.poly_matrix()).to(self.device)
        self._window = torch.from_numpy(logmel.hann(cfg.n_fft)).to(self.device)
        self._mel = torch.from_numpy(logmel.mel_weights(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max)).to(self.device)
        # a piece starts on a whole block of the resampler's 160 outputs
        align = resample_ops.POLY_UP // math.gcd(cfg.segment_samples, resample_ops.POLY_UP)
        self.piece_segments = max(align, PIECE_SEGMENTS // align * align)
        self._uploader = upload_ops.PieceUploader([self.device])
        self.piece_upload_bytes = self._uploader.piece_upload_bytes

    def close(self) -> None:
        """Release the pinned upload buffer and the packer threads."""
        self._uploader.close()

    def n_segments(self, n_samples: int, sample_rate: int) -> int:
        """Segments a recording of ``n_samples`` at ``sample_rate`` is cut into."""
        return max(1, -(-self._length_16k(n_samples, sample_rate) // self.cfg.segment_samples))

    def _length_16k(self, n_samples: int, sample_rate: int) -> int:
        if sample_rate == 44100:
            return resample_ops.poly_output_length(n_samples)
        if sample_rate == self.cfg.sample_rate:
            return n_samples
        raise ValueError(f"expected 44100 or {self.cfg.sample_rate} Hz, got {sample_rate}")

    @torch.inference_mode()
    def features(self, audio: np.ndarray, sample_rate: int) -> torch.Tensor:
        """One recording's (segments, frames, n_mels) log-mel on the device."""
        cfg = self.cfg
        if audio.dtype != np.int16:
            audio = np.ascontiguousarray(audio, dtype=np.float32)
        if audio.ndim != 1:
            raise ValueError(f"expected mono 1-D audio, got shape {audio.shape}")
        is_44k = sample_rate == 44100
        n16 = self._length_16k(len(audio), sample_rate)
        seg = cfg.segment_samples
        n_seg = self.n_segments(len(audio), sample_rate)
        out = torch.empty((n_seg, cfg.frames, cfg.n_mels), device=self.device)
        rows = []
        for s0 in range(0, n_seg, self.piece_segments):
            k = min(self.piece_segments, n_seg - s0)
            if is_44k:
                blocks = -(-k * seg // resample_ops.POLY_UP)
                lo = resample_ops.POLY_DOWN * (s0 * seg // resample_ops.POLY_UP) - resample_ops.POLY_HALO
                hi = lo + resample_ops.POLY_DOWN * blocks + 2 * resample_ops.POLY_HALO
            else:
                blocks, lo, hi = 0, s0 * seg, (s0 + k) * seg
            rows.append((s0, k, blocks, upload_ops.padded_slice(audio, lo, hi)))
        codec = upload_ops.use_codec(self.pcm_transport, audio.dtype, self.device)
        pool = self._uploader.packer_threads() if codec else None
        packed = [None if pool is None else pool.submit(upload_ops.pack_wire, row) for *_, row in rows]
        for (s0, k, blocks, row), future in zip(rows, packed):
            with profiling.span("bp.mt3.frontend"):
                x = self._uploader.upload_piece(row, None if future is None else future.result(), self.device, "default")
                y = resample_ops.resample_160_441(x, blocks, self._poly)[: k * seg] if is_44k else x
                valid = n16 - s0 * seg
                if valid < k * seg:
                    y = torch.cat([y[:valid], y.new_zeros(k * seg - valid)])
                out[s0 : s0 + k] = logmel.log_mel(y.view(k, seg), self._window, self._mel, cfg.hop, cfg.log_floor)
                profiling.count("mt3.segments", k)
        return out

    @torch.inference_mode()
    def transcribe_batch(
        self,
        recordings: "Sequence[Tuple[np.ndarray, int]]",
        token_budgets: "Optional[Sequence[Optional[Sequence[int]]]]" = None,
        return_model_outputs: bool = False,
        return_logits: "Sequence[int]" = (),
    ) -> list:
        """Transcribe (audio, sample_rate) recordings, 44.1 or 16 kHz mono.

        Each result is a list of events (start s, end s, MIDI pitch,
        amplitude, None). With ``return_model_outputs`` it is (events,
        {"tokens": each segment's ids, "programs": each event's program});
        the recordings whose indices are in ``return_logits`` also get
        "logits" (per segment, (tokens, 1 391) float32, one row per emitted
        token, EOS unmasked), "mel" and "encoded" (per segment, the
        encoder's input and output). ``token_budgets`` holds, per
        recording, None or one token count per segment."""
        cfg = self.cfg
        limit = self.max_new_tokens
        if token_budgets is not None and len(token_budgets) != len(recordings):
            raise ValueError("token_budgets needs one entry per recording")
        keep = set(int(i) for i in return_logits)
        mels, caps, budgeted, owner = [], [], [], []
        for i, (audio, sample_rate) in enumerate(recordings):
            mel = self.features(audio, sample_rate)
            budget = None if token_budgets is None else token_budgets[i]
            if budget is not None and len(budget) != len(mel):
                raise ValueError(f"recording {i} has {len(mel)} segments and {len(budget)} token budgets")
            mels.append(mel)
            caps += [limit] * len(mel) if budget is None else [min(int(b), limit) for b in budget]
            budgeted += [budget is not None] * len(mel)
            owner += [i] * len(mel)
        every = torch.cat(mels) if mels else torch.empty((0, cfg.frames, cfg.n_mels), device=self.device)
        tokens: List[np.ndarray] = [np.zeros(0, np.int64)] * len(owner)
        logits: Dict[int, np.ndarray] = {}
        encoded: Dict[int, torch.Tensor] = {}
        for b0 in range(0, len(owner), self.segments_per_call):
            rows = sorted(range(b0, min(b0 + self.segments_per_call, len(owner))), key=lambda r: -caps[r])
            with profiling.span("bp.mt3.encode"):
                enc = self.model.encode(every[torch.tensor(rows, device=self.device)])
                self.model.cross_kv(enc)
            keep_pos = [j for j, r in enumerate(rows) if owner[r] in keep]
            with profiling.span("bp.mt3.decode"):
                out = self.model.greedy([caps[r] for r in rows], [budgeted[r] for r in rows], keep_pos)
            profiling.count("mt3.decode_steps", out.steps)
            profiling.count("mt3.token_rows_run", out.rows_run)
            profiling.count("mt3.tokens_emitted", sum(len(t) for t in out.tokens))
            for j, r in enumerate(rows):
                tokens[r] = out.tokens[j]
                if j in out.logits:
                    logits[r] = out.logits[j]
                    encoded[r] = enc[j]
        results = []
        first = 0
        for i, (audio, sample_rate) in enumerate(recordings):
            n = len(mels[i])
            segs = tokens[first : first + n]
            with profiling.span("bp.mt3.detokenize"):
                events, programs = mt3_codec.tokens_to_events(
                    segs, len(audio) / sample_rate, cfg.segment_samples, cfg.sample_rate, cfg.drum_note_s
                )
            if not return_model_outputs:
                results.append(events)
            else:
                outputs = {"tokens": segs, "programs": programs}
                if i in keep:
                    outputs["logits"] = [logits[r] for r in range(first, first + n)]
                    outputs["mel"] = mels[i].cpu().numpy()
                    outputs["encoded"] = torch.stack([encoded[r] for r in range(first, first + n)]).cpu().numpy()
                results.append((events, outputs))
            first += n
        return results
