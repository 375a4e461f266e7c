"""Chunked transcription on one device: raw PCM to note events.

PyTorch counterpart of `basic_pitch_tpu/pipeline.py` on one device. A
recording is processed in chunks of W model windows; per chunk, on the
device:

    raw PCM piece (float32, or int16 scaled by 1/32768 on the device)
      -> anti-aliased decimation to 22.05 kHz when the input is 44.1 kHz
      -> unfold into W overlapping 43 844-sample windows
      -> NMP model (CQT -> harmonic stack -> conv heads)
      -> 15-frame overlap trim per window, windows folded into time
      -> per-frame bend matrix

then, once per recording, the greedy note decode (the CUDA kernel of
`decode/greedy_kernel.py` on a GPU, its plain version on the CPU) and the
per-note bend gather. Only the note count, then count-sized note buffers,
cross back to the host, where events are assembled. A decode that
overflows its buffers falls back to the host decoder (`decode/notes.py`) on
the posteriorgrams, and `host_fallbacks` counts it.

Numerics are float32 throughout: the constructor sets
``torch.backends.cudnn.allow_tf32 = False`` (cuDNN's default is True) and
``torch.backends.cuda.matmul.allow_tf32 = False``, because reduced-precision
products flip a few percent of decoded notes on dense material.
"""

from __future__ import annotations

import pathlib
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from basic_pitch_torch import constants
from basic_pitch_torch.decode import device as device_decode
from basic_pitch_torch.decode import greedy_kernel
from basic_pitch_torch.decode import notes as host_decode
from basic_pitch_torch.models import nmp
from basic_pitch_torch.models import params as params_io
from basic_pitch_torch.ops import resample as resample_ops
from basic_pitch_torch.utils import audio as audio_io

HOP = constants.WINDOW_HOP_SAMPLES  # 36164
OVERLAP = constants.OVERLAP_LENGTH_SAMPLES  # 7680
WINDOW = constants.AUDIO_N_SAMPLES  # 43844
TRIM = constants.N_OVERLAPPING_FRAMES // 2  # 15
FRAMES_PER_WINDOW = constants.N_FRAMES_PER_WINDOW_TRIMMED  # 142
_DEC_HALO = 128  # left context the 257-tap decimator needs


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` means the GPU, and raises when there is none; the CPU is
    used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def unfold_windows(piece: torch.Tensor, w: int) -> torch.Tensor:
    """(w*HOP + OVERLAP,) audio -> (w, WINDOW) overlapping model windows;
    window i is piece[i*HOP : i*HOP + WINDOW] (a strided view)."""
    return piece.unfold(0, WINDOW, HOP)[:w]


def _padded_slice(x: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """x[lo:hi] with zero padding for out-of-range indices (a view when
    the slice is interior)."""
    if 0 <= lo and hi <= len(x):
        return x[lo:hi]
    out = np.zeros(hi - lo, dtype=x.dtype)
    src_lo, src_hi = max(lo, 0), min(hi, len(x))
    if src_hi > src_lo:
        out[src_lo - lo : src_hi - lo] = x[src_lo:src_hi]
    return out


class DecodeOptions(NamedTuple):
    """The decode settings of one `transcribe` call, with its defaults."""

    onset_threshold: float = 0.5
    frame_threshold: float = 0.3
    min_note_length: int = 11
    min_freq: Optional[float] = None
    max_freq: Optional[float] = None
    infer_onsets: bool = True
    melodia_trick: bool = True
    include_pitch_bends: bool = True


class StreamingTranscriber:
    """Chunked transcription of recordings to note events on one device.

    Args:
        model_or_params: checkpoint path (the shipped ICASSP-2022 weights by
            default), a flat JAX-layout parameter dict ({"layer/field":
            array}), or an `nmp.NMP` module.
        windows_per_chunk: W, the window batch per model call.
        device: "cuda" (the default, which raises when there is no GPU) or
            "cpu".

    Attributes read by callers: ``w``, ``decode_backend`` ("kernel" on
    cuda, "plain" on cpu), ``pcm_transport`` ("raw"), and
    ``host_fallbacks``, the count of decodes that overflowed to the host.
    """

    def __init__(
        self,
        model_or_params: "Union[str, pathlib.Path, Dict[str, np.ndarray], nmp.NMP]" = params_io.ICASSP_2022_WEIGHTS_PATH,
        windows_per_chunk: int = 128,
        device: "str | torch.device | None" = None,
    ):
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if isinstance(model_or_params, nmp.NMP):
            model = model_or_params
        else:
            flat = model_or_params if isinstance(model_or_params, dict) else params_io.load_flat(model_or_params)
            model = nmp.NMP()
            model.load_state_dict(params_io.from_jax_params(flat))
        self.model = model.to(self.device).eval()
        self.w = int(windows_per_chunk)
        if self.w < 1:
            raise ValueError("windows_per_chunk must be >= 1")
        self.chunk_len = HOP * self.w + OVERLAP  # samples @22.05k per chunk
        on_gpu = self.device.type == "cuda"
        self.decode_backend = "kernel" if on_gpu else "plain"
        self.pcm_transport = "raw"
        self.host_fallbacks = 0
        self._dec2 = torch.from_numpy(resample_ops.decimate2_matrix()).to(self.device)
        # one pinned host buffer for uploads, copied on a side stream so the
        # next piece's upload overlaps the current chunk's compute
        self._pinned: Optional[torch.Tensor] = None
        self._upload_done: Optional[torch.cuda.Event] = None
        self._copy_stream = torch.cuda.Stream(self.device) if on_gpu else None

    def close(self) -> None:
        """Release the pinned upload buffer (idempotent)."""
        if self._upload_done is not None:
            self._upload_done.synchronize()
        self._pinned = None
        self._upload_done = None

    def __enter__(self) -> "StreamingTranscriber":
        return self

    def __exit__(self, *exc: object) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------------

    def _geometry(self, audio: np.ndarray, sample_rate: int):
        """(audio as float32 or int16, is_44k, n_chunks, n_frames)."""
        if audio.dtype != np.int16:
            audio = np.ascontiguousarray(audio, dtype=np.float32)
        if audio.ndim != 1:
            raise ValueError(f"expected mono 1-D audio, got shape {audio.shape}")
        if sample_rate == constants.AUDIO_SAMPLE_RATE:
            is_44k = False
            original_length = len(audio)
        elif sample_rate == 2 * constants.AUDIO_SAMPLE_RATE:
            is_44k = True
            original_length = resample_ops.decimate2_output_length(len(audio))
        else:
            raise ValueError(f"expected 22050 or 44100 Hz, got {sample_rate}")
        pad_front = OVERLAP // 2
        n_windows = max(1, -(-(original_length + pad_front) // HOP))
        n_chunks = -(-n_windows // self.w)
        n_frames = int(original_length / HOP * FRAMES_PER_WINDOW)
        return audio, is_44k, n_chunks, n_frames

    def _pieces(self, audio: np.ndarray, is_44k: bool, n_chunks: int):
        """Host-side chunk pieces (views where possible, zero-padded edges);
        a 44.1 kHz piece carries the decimator's halo on both sides."""
        pad_front = OVERLAP // 2
        if is_44k:
            piece_len = 2 * self.chunk_len + 2 * _DEC_HALO
            for c in range(n_chunks):
                lo = 2 * (c * self.w * HOP - pad_front) - _DEC_HALO
                yield _padded_slice(audio, lo, lo + piece_len)
        else:
            for c in range(n_chunks):
                lo = c * self.w * HOP - pad_front
                yield _padded_slice(audio, lo, lo + self.chunk_len)

    def _upload(self, piece: np.ndarray) -> torch.Tensor:
        """Ship one raw piece (float32 or int16) to the device."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.array(piece))
        dtype = torch.int16 if piece.dtype == np.int16 else torch.float32
        if self._upload_done is not None:
            self._upload_done.synchronize()  # the pinned buffer is free again
        if self._pinned is None or self._pinned.numel() < piece.nbytes:
            self._pinned = torch.empty(piece.nbytes, dtype=torch.uint8, pin_memory=True)
        host = self._pinned[: piece.nbytes].view(dtype)
        host.numpy()[:] = piece
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            self._upload_done = torch.cuda.Event()
            self._upload_done.record(self._copy_stream)
        compute.wait_event(self._upload_done)
        dev.record_stream(compute)
        return dev

    @torch.inference_mode()
    def _forward(self, audio: np.ndarray, sample_rate: int):
        """Upload and run every chunk. Returns (device dict of (n_chunks*W*142,
        F) "note", "onset", "contour" and int8 "bends", n_frames, n_chunks)."""
        audio, is_44k, n_chunks, n_frames = self._geometry(audio, sample_rate)
        chunks = []
        for piece in self._pieces(audio, is_44k, n_chunks):
            x = self._upload(piece)
            if x.dtype == torch.int16:
                x = x.to(torch.float32) * (1.0 / 32768.0)
            if is_44k:
                x = resample_ops.decimate2(x, halo=True, n_out=self.chunk_len, matrix=self._dec2)
            out = self.model(unfold_windows(x, self.w))
            out = {
                k: v[:, TRIM : v.shape[1] - TRIM].reshape(self.w * FRAMES_PER_WINDOW, v.shape[2])
                for k, v in out.items()
            }
            # the bend matrix is frame-local: per chunk keeps its (frames, 88,
            # 51) gather bounded whatever the recording's length
            out["bends"] = device_decode.bend_matrix(out["contour"])
            chunks.append(out)
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}, n_frames, n_chunks

    def decode_inputs(
        self, out: Dict[str, torch.Tensor], n_frames: int, n_chunks: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Pad chunk outputs to the pow2 chunk bucket and silence frames past
        the recording. Returns (note, onset, bends, max_notes floor for the
        bucket)."""
        bucket = 1 << max(0, (n_chunks - 1).bit_length())
        cap = bucket * self.w * FRAMES_PER_WINDOW

        def pad(x: torch.Tensor) -> torch.Tensor:
            return torch.cat([x, x.new_zeros((cap - x.shape[0], x.shape[1]))]) if x.shape[0] < cap else x

        note, onset, bends = pad(out["note"]), pad(out["onset"]), pad(out["bends"])
        # frames past the recording come from zero-padded audio, where the
        # model still emits nonzero activations
        valid = (torch.arange(cap, device=note.device)[:, None] < n_frames).to(note.dtype)
        # note capacity: 1 note per 8 frames of the bucket
        return note * valid, onset * valid, bends, cap // 8

    @torch.inference_mode()
    def _dispatch(
        self, audio: np.ndarray, sample_rate: int, options: DecodeOptions, max_notes: int, keep_outputs: bool = False
    ) -> dict:
        """Enqueue uploads, chunk programs and the decode for one recording;
        nothing waits for the device."""
        out, n_frames, n_chunks = self._forward(audio, sample_rate)
        return self._decode_dispatch(out, n_frames, n_chunks, options, max_notes, keep_outputs)

    @torch.inference_mode()
    def _decode_dispatch(
        self,
        out: Dict[str, torch.Tensor],
        n_frames: int,
        n_chunks: int,
        options: DecodeOptions,
        max_notes: int,
        keep_outputs: bool = False,
    ) -> dict:
        """Enqueue the decode of one recording's chunk outputs (`_forward`'s
        dict) and return its ticket for `_collect_many`."""
        freq_mask = None
        if options.min_freq is not None or options.max_freq is not None:
            mask = np.ones(constants.N_FREQ_BINS_NOTES, np.float32)
            if options.min_freq is not None:
                mask[: int(np.round(host_decode.hz_to_midi(options.min_freq) - host_decode.MIDI_PITCH_OFFSET))] = 0
            if options.max_freq is not None:
                mask[int(np.round(host_decode.hz_to_midi(options.max_freq) - host_decode.MIDI_PITCH_OFFSET)) :] = 0
            freq_mask = torch.from_numpy(mask).to(self.device)
        note, onset, bends_all, notes_floor = self.decode_inputs(out, n_frames, n_chunks)
        max_notes = max(max_notes, notes_floor)
        decoded = greedy_kernel.decode_greedy(
            note,
            onset,
            options.onset_threshold,
            options.frame_threshold,
            options.min_note_length,
            freq_mask=freq_mask,
            infer_onsets=options.infer_onsets,
            melodia_trick=options.melodia_trick,
            max_notes=max_notes,
            # every above-threshold scrap costs a melodia iteration, so the
            # safety cap grows with the frame count
            max_melodia_iters=2 * max_notes + 2 * note.shape[0],
            valid_frames=n_frames,
        )
        bends_inline = device_decode.gather_note_bends(bends_all, decoded) if options.include_pitch_bends else None
        return {
            "n_frames": n_frames,
            "decoded_dev": decoded,
            "bends_inline_dev": bends_inline,
            "bends_all_dev": bends_all,
            "outputs_dev": {k: out[k] for k in ("note", "onset", "contour")},
            "keep_outputs": keep_outputs,
            "options": options,
        }

    # minimum shrunk note capacity fetched to the host
    _SHRINK_MIN_NOTES = 1024

    @classmethod
    def _shrink_bucket(cls, n_notes: int, capacity: int) -> int:
        """Pow2 fetch bucket for `n_notes` valid slots (or `capacity` when
        shrinking wouldn't reduce the transfer)."""
        out_cap = cls._SHRINK_MIN_NOTES
        while out_cap < n_notes:
            out_cap *= 2
        return out_cap if out_cap < capacity else capacity

    def _collect_many(self, tickets: list) -> list:
        """Fetch every ticket's note count in one transfer, then its
        count-bucketed buffers, and assemble events."""
        if not tickets:
            return []
        metas = torch.stack(
            [torch.stack([t["decoded_dev"].n_notes, t["decoded_dev"].overflow.to(torch.int32)]) for t in tickets]
        ).cpu().tolist()
        results = []
        for ticket, (n_notes, overflow) in zip(tickets, metas):
            decoded_dev = ticket["decoded_dev"]
            if overflow:
                results.append(self._assemble(ticket, None, None))
                continue
            out_cap = self._shrink_bucket(n_notes, decoded_dev.starts.shape[0])
            decoded = device_decode.DecodedNotes(
                *(field[:out_cap].cpu() for field in decoded_dev[:4]),
                n_notes=torch.tensor(n_notes, dtype=torch.int32),
                overflow=torch.tensor(False),
            )
            bends = ticket["bends_inline_dev"]
            bends = bends[:out_cap].cpu().numpy() if bends is not None else None
            results.append(self._assemble(ticket, decoded, bends))
        return results

    def _assemble(self, ticket: dict, decoded: Optional[device_decode.DecodedNotes], bends_inline: Optional[np.ndarray]):
        """Host-side event assembly; `decoded` None means the device decode
        overflowed and the host decoder runs on the posteriorgrams."""
        opts = ticket["options"]
        n_frames = ticket["n_frames"]
        model_output = None
        if decoded is None or ticket["keep_outputs"]:
            model_output = {k: v[:n_frames].cpu().numpy() for k, v in ticket["outputs_dev"].items()}

        if decoded is None:  # pathological density: host fallback
            self.host_fallbacks += 1
            config = host_decode.DecodeConfig(
                onset_threshold=opts.onset_threshold,
                frame_threshold=opts.frame_threshold,
                min_note_length=opts.min_note_length,
                infer_onsets=opts.infer_onsets,
                min_freq=opts.min_freq,
                max_freq=opts.max_freq,
                melodia_trick=opts.melodia_trick,
            )
            frame_notes = host_decode.decode_note_events(model_output["note"], model_output["onset"], config)
            if opts.include_pitch_bends:
                events_f = host_decode.extract_pitch_bends(model_output["contour"], frame_notes)
            else:
                events_f = [(s, e, p, a, None) for s, e, p, a in frame_notes]
        elif opts.include_pitch_bends:
            events_f = device_decode.notes_to_events_packed(decoded, bends_inline, ticket["bends_all_dev"])
        else:
            events_f = device_decode.notes_to_events(decoded)

        times = host_decode.model_frames_to_time(n_frames)
        events = [
            (float(times[s]), float(times[min(e, n_frames - 1)]), p, a, b)
            for s, e, p, a, b in events_f
        ]
        if ticket["keep_outputs"]:
            return events, model_output
        return events

    # ------------------------------------------------------------------

    def posteriorgrams(self, audio: np.ndarray, sample_rate: int) -> Dict[str, np.ndarray]:
        """Mono float32 or int16 samples at 22050 or 44100 Hz -> {"note",
        "onset", "contour"} matrices with `inference.unwrap_output`'s frame
        count."""
        out, n_frames, _ = self._forward(audio, sample_rate)
        return {k: out[k][:n_frames].cpu().numpy() for k in ("note", "onset", "contour")}

    def transcribe(
        self,
        audio: np.ndarray,
        sample_rate: int,
        onset_threshold: float = 0.5,
        frame_threshold: float = 0.3,
        min_note_length: int = 11,
        min_freq: Optional[float] = None,
        max_freq: Optional[float] = None,
        infer_onsets: bool = True,
        melodia_trick: bool = True,
        include_pitch_bends: bool = True,
        max_notes: int = 16384,
    ) -> "list[tuple]":
        """Raw samples -> second-domain note events (start, end, pitch,
        amplitude, bends), decoded on the device."""
        options = DecodeOptions(
            onset_threshold, frame_threshold, min_note_length, min_freq, max_freq,
            infer_onsets, melodia_trick, include_pitch_bends,
        )
        ticket = self._dispatch(audio, sample_rate, options, max_notes)
        return self._collect_many([ticket])[0]

    def transcribe_batch(
        self,
        recordings: "list[tuple[np.ndarray, int]]",
        onset_threshold: float = 0.5,
        frame_threshold: float = 0.3,
        min_note_length: int = 11,
        min_freq: Optional[float] = None,
        max_freq: Optional[float] = None,
        infer_onsets: bool = True,
        melodia_trick: bool = True,
        include_pitch_bends: bool = True,
        max_notes: int = 16384,
        return_model_outputs: bool = False,
    ) -> list:
        """Transcribe many (audio, sample_rate) recordings; every recording is
        enqueued before the first result is fetched. With
        ``return_model_outputs`` each result is (events, {"note", "onset",
        "contour"})."""
        options = DecodeOptions(
            onset_threshold, frame_threshold, min_note_length, min_freq, max_freq,
            infer_onsets, melodia_trick, include_pitch_bends,
        )
        tickets = [self._dispatch(audio, sr, options, max_notes, return_model_outputs) for audio, sr in recordings]
        return self._collect_many(tickets)

    def transcribe_file(self, audio_path: "str | pathlib.Path") -> Dict[str, np.ndarray]:
        """Posteriorgrams of a WAV file; 44.1 and 22.05 kHz go to the device
        as they are, other rates are resampled on the host first."""
        samples, sr = audio_io.read_wav(audio_path)
        mono = audio_io.to_mono(samples)
        if sr in (constants.AUDIO_SAMPLE_RATE, 2 * constants.AUDIO_SAMPLE_RATE):
            return self.posteriorgrams(mono, sr)
        mono = audio_io.resample(mono, sr, constants.AUDIO_SAMPLE_RATE)
        return self.posteriorgrams(mono, constants.AUDIO_SAMPLE_RATE)
