"""Incremental (live) transcription sessions over the device pipeline.

A copy of `basic_pitch_tpu/streaming.py` (the port imports nothing of the
JAX package), logic for logic; only the imports differ.
`tests/test_torch_streaming.py` holds it to emit exactly the JAX session's
events on the same scripted decodes. PCM arrives continuously, note events
leave with bounded latency:

    session = StreamingSession(transcriber)
    for block in microphone():          # any block size, any cadence
        for event in session.feed(block):
            ...                         # finalized (start, end, pitch, amp, bends)
    tail = session.close()

The session re-decodes a sliding audio window with the same device pipeline
as offline transcription (`pipeline.StreamingTranscriber.transcribe`, whose
note decode is the greedy-decode CUDA kernel on the card). Events are
finalized once they end at least ``lookahead_seconds`` before the newest
sample, so re-decodes with more right-context can no longer change them;
un-ended (pending) notes stay in the window until they finish, which keeps
their onsets in context. Worst-case emission delay is ``segment_seconds``
(decode cadence) + ``lookahead_seconds`` + one pipeline round trip.

Decode semantics are segment-local by construction: the dB normalization,
inferred-onset rescaling and melodia iteration see the sliding window, not
the whole recording, which is identical to offline output whenever the
window covers the surrounding material (the tests pin this on gapped
melodies). Notes longer than ``max_context_seconds`` survive the window
sliding past their onset: the pending-note key is clamped to the trim cut so
the re-decoded window-edge onset still matches, and the event is emitted
with the onset recorded when the note was first observed (its end,
amplitude and bends come from the final decode, which saw only the tail).
The policy constants below were set by the JAX package's streaming-parity
measurements (`STREAM_PARITY.json`); they are not measurements of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from basic_pitch_torch import constants

Event = Tuple[float, float, int, float, Optional[list]]

_TRIM_GUARD_S = 0.5  # context kept behind the oldest pending onset
# a pending note whose onset was trimmed out re-decodes with its onset at
# the window edge, registered a frame or two in (measured ~0.023 s); the
# clamped key accepts onsets up to this far past the cut
_CLAMP_MATCH_S = 0.25
# flushes an un-matched pending note survives before being force-emitted:
# grace so a momentary amplitude dip at the window edge (the decode briefly
# not reporting the note) doesn't end the note early — next flush it
# re-matches its carried record. The grace is a TIME budget (seconds),
# converted to flushes per session, so aggressive short segments get the
# same real-time grace as the default setting (the round-4 worst case was
# segment 1 s / lookahead 0.5 s on real vocals: 19 notes dropped after a
# single 1 s grace flush — STREAM_PARITY.json).
_PENDING_GRACE_S = 2.0
# a pending note that exhausts its grace is EMITTED with its last observed
# end (the decode that created it saw a real note; silently losing it cost
# recall) — `stats["pending_force_emitted"]` keeps the failure observable.


@dataclasses.dataclass
class _PendingNote:
    """An un-ended note carried across flushes.

    ``match_onset_s`` is where the note appears in the CURRENT window
    (clamped to the trim cut when the window slid past its onset);
    ``orig_onset_s`` is what finally gets emitted. ``misses`` counts
    consecutive flushes whose decode did not report the note. ``end_s`` /
    ``amplitude`` / ``bends`` snapshot the note's most recent sighting so
    an exhausted-grace note can still be emitted instead of lost.
    """

    match_onset_s: float
    pitch: int
    orig_onset_s: float
    end_s: float
    amplitude: float
    bends: Optional[list]
    clamped: bool = False
    misses: int = 0
    # flush decodes that reported this note (a claim inherits the claimed
    # record's count + 1): grace-exhausted records with a single sighting
    # are dropped, not force-emitted — measured on real vocals, one-flush
    # sightings the decode never confirms are window-edge hallucinations
    # (12 of 13 force-emits at the aggressive setting had no offline
    # counterpart), while real notes are re-reported and accumulate
    sightings: int = 1


class StreamingSession:
    """Stateful incremental transcription over one StreamingTranscriber.

    Feed mono PCM (float32 in [-1, 1] or int16) at 22.05 or 44.1 kHz in
    blocks of any size; collect finalized note events (absolute times in
    seconds since the start of the stream, `inference.predict`'s tuple
    format). Sessions are cheap — the heavy state (executables, params)
    lives in the shared transcriber; concurrent sessions may share one.

    Not thread-safe; drive each session from one thread.
    """

    def __init__(
        self,
        transcriber,
        sample_rate: int = constants.AUDIO_SAMPLE_RATE,
        segment_seconds: float = 2.0,
        lookahead_seconds: float = 1.0,
        max_context_seconds: float = 12.0,
        dedup_tolerance_s: float = 0.04,
        transcribe_fn=None,
        **decode_params,
    ):
        """``transcribe_fn(audio, sample_rate, **decode_params) -> events``
        overrides ``transcriber.transcribe`` — e.g. the HTTP server routes
        flushes through its micro-batcher so concurrent streams share
        device dispatches (serve.py)."""
        # trims land on the model's window-hop grid so a sliding decode
        # re-windows the stream into the SAME 43844-sample windows offline
        # decoding would use: interior posteriorgrams are then bit-identical
        # and decode differences are confined to the window's edges (which
        # the finalized-horizon logic owns)
        if sample_rate == constants.AUDIO_SAMPLE_RATE:
            self._align = constants.WINDOW_HOP_SAMPLES
        elif sample_rate == 2 * constants.AUDIO_SAMPLE_RATE:
            self._align = 2 * constants.WINDOW_HOP_SAMPLES
        else:
            raise ValueError(f"expected 22050 or 44100 Hz, got {sample_rate}")
        if lookahead_seconds < 0 or segment_seconds <= 0:
            raise ValueError("segment_seconds must be > 0, lookahead_seconds >= 0")
        if max_context_seconds < segment_seconds + lookahead_seconds:
            raise ValueError(
                "max_context_seconds must cover segment + lookahead "
                f"({segment_seconds + lookahead_seconds:.1f}s)"
            )
        self.transcriber = transcriber
        self._transcribe_fn = (
            transcribe_fn
            if transcribe_fn is not None
            else transcriber.transcribe
        )
        self.sample_rate = sample_rate
        self.segment_seconds = float(segment_seconds)
        self.lookahead_seconds = float(lookahead_seconds)
        self.max_context_seconds = float(max_context_seconds)
        self.dedup_tolerance_s = float(dedup_tolerance_s)
        self.decode_params = decode_params
        # grace is a time budget: short segments flush more often, so they
        # get proportionally more grace FLUSHES before a pending note is
        # force-emitted (see _PENDING_GRACE_S)
        self._grace_flushes = max(1, int(np.ceil(_PENDING_GRACE_S / self.segment_seconds)))

        self._buf: List[np.ndarray] = []
        self._buf_start = 0  # absolute sample index of the buffer head
        self._n_fed = 0  # absolute samples fed so far
        self._flushed_upto = 0  # absolute samples decoded by the last flush
        self._dtype: Optional[np.dtype] = None
        self._closed = False
        # finalized horizon: events ending before this were emittable at the
        # previous flush; onsets older than it must match an emitted or
        # pending note, or they are window-edge artifacts and are dropped
        self._finalized_s = 0.0
        self._emitted_keys: List[Tuple[float, int]] = []  # (onset_s, pitch)
        # (onset_s, end_s, pitch) of emitted notes: offline decode NEVER
        # overlaps same-pitch notes (a note is a maximal run of active
        # frames per pitch), so any later event overlapping an emitted
        # same-pitch span is a sliding-window re-decode of that note
        self._emitted_spans: List[Tuple[float, float, int]] = []
        # spans of single-sighting records dropped as hallucinations: if a
        # later decode re-finds one (so it WAS real), the re-find is let
        # back through the finalized-horizon artifact filter and emitted
        self._dropped_spans: List[Tuple[float, float, int]] = []
        self._pending: List[_PendingNote] = []  # un-ended notes (see _PendingNote)
        self.stats: Dict[str, float] = {
            "flushes": 0,
            "decoded_audio_s": 0.0,
            "events": 0,
            # pending notes no decode re-reported within the grace budget,
            # emitted with their last observed end instead of lost —
            # nonzero means the live path emitted from a stale sighting
            # (observable imprecision, no longer a lost note)
            "pending_force_emitted": 0,
            # grace-exhausted records the decode reported exactly ONCE and
            # never confirmed: measured window-edge hallucinations, dropped
            # (also counts the defensive no-usable-end case)
            "pending_dropped": 0,
            # grace-exhausted records a fresher overlapping sighting of the
            # same note already carried — suppressed instead of duplicated
            "pending_superseded": 0,
        }

    # ------------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def feed(self, samples: np.ndarray) -> List[Event]:
        """Buffer a block; decode and return newly finalized events when at
        least ``segment_seconds`` of new audio accumulated (else [])."""
        if self._closed:
            raise RuntimeError("StreamingSession is closed")
        samples = np.asarray(samples)
        if samples.ndim != 1:
            raise ValueError("feed() wants mono 1-D samples")
        if samples.dtype not in (np.float32, np.int16):
            if np.issubdtype(samples.dtype, np.floating):
                samples = samples.astype(np.float32)
            else:
                raise ValueError(f"unsupported dtype {samples.dtype}")
        if self._dtype is None:
            self._dtype = samples.dtype
        elif samples.dtype != self._dtype:
            raise ValueError(
                f"stream dtype changed from {self._dtype} to {samples.dtype}"
            )
        if len(samples):
            self._buf.append(samples)
            self._n_fed += len(samples)
        pending_new = self._n_fed - self._flushed_upto
        if pending_new >= int(self.segment_seconds * self.sample_rate):
            return self._flush(final=False)
        return []

    def close(self) -> List[Event]:
        """Decode everything outstanding and return the final events."""
        if self._closed:
            return []
        self._closed = True
        if self._n_fed == self._flushed_upto == 0:
            return []
        out = self._flush(final=True)
        self._buf = []
        return out

    # ------------------------------------------------------------------

    def _flush(self, final: bool) -> List[Event]:
        sr = self.sample_rate
        audio = (
            self._buf[0] if len(self._buf) == 1 else np.concatenate(self._buf)
        )
        self._buf = [audio]
        if not len(audio):
            return []
        base_s = self._buf_start / sr
        end_s = self._n_fed / sr
        events = self._transcribe_fn(audio, sr, **self.decode_params)
        self.stats["flushes"] += 1
        self.stats["decoded_audio_s"] += len(audio) / sr
        self._flushed_upto = self._n_fed

        emit_before = end_s if final else max(end_s - self.lookahead_seconds, 0.0)
        tol = self.dedup_tolerance_s
        out: List[Event] = []
        new_pending: List[_PendingNote] = []
        unmatched = list(self._pending)  # records not yet claimed this flush

        def covered(onset, offset, spans, pitch) -> bool:
            """True when a same-pitch span holds the MAJORITY of
            [onset, offset]: offline decode never overlaps same-pitch notes,
            so an event mostly inside an already-carried span is a sliding
            re-decode of that note, not a new one. Majority (not mere
            touching) so a re-articulation abutting the previous note's
            slightly-stale end survives."""
            need = max(tol, 0.5 * (offset - onset))
            return any(
                p == pitch and min(offset, e) - max(onset, s) >= need
                for s, e, p in spans
            )

        def matches_emitted(onset, offset, pitch):
            if any(
                p == pitch and abs(k - onset) <= tol for k, p in self._emitted_keys
            ):
                return True
            # the re-decode jittered the onset past the key tolerance but
            # the event lies mostly inside an emitted same-pitch span: the
            # SAME note re-seen (the round-5 precision hole — force-emit +
            # jittered re-find each produced an event)
            return covered(onset, offset, self._emitted_spans, pitch)

        def take_pending(onset, pitch) -> Optional[_PendingNote]:
            """Claim the matching pending record, consuming it: each record
            feeds at most one event per flush (a split decode or a new
            same-pitch onset near the cut must not all inherit the same
            orig_onset). Among candidates the earliest original onset wins —
            that's the true continuation; later ones are new notes."""
            candidates = [
                rec
                for rec in unmatched
                if rec.pitch == pitch
                and (
                    abs(onset - rec.match_onset_s) <= tol
                    or (
                        rec.clamped
                        and -tol <= onset - rec.match_onset_s <= _CLAMP_MATCH_S
                    )
                )
            ]
            if not candidates:
                return None
            best = min(candidates, key=lambda rec: rec.orig_onset_s)
            unmatched.remove(best)
            return best

        for start, end, pitch, amplitude, bends in events:
            onset, offset = start + base_s, end + base_s
            if matches_emitted(onset, offset, pitch):
                continue  # already final in an earlier flush
            pending = take_pending(onset, pitch)
            if (
                pending is None
                and onset < self._finalized_s - tol
                and not covered(onset, offset, self._dropped_spans, pitch)
            ):
                # starts inside the already-finalized region yet never seen
                # before: a window-edge artifact of the sliding re-decode
                # (unless it re-finds a span dropped as a hallucination —
                # the decode confirming it means the note was real)
                continue
            # a note first seen before trimming slid past its onset keeps
            # that original onset; its end/amplitude/bends come from the
            # final decode (which saw only the tail)
            orig_onset = pending.orig_onset_s if pending is not None else onset
            if offset <= emit_before:
                out.append((orig_onset, offset, pitch, amplitude, bends))
                self._emitted_keys.append((onset, pitch))
                self._emitted_spans.append((orig_onset, offset, pitch))
            else:
                new_pending.append(
                    _PendingNote(
                        onset,
                        pitch,
                        orig_onset,
                        offset,
                        amplitude,
                        bends,
                        sightings=(pending.sightings + 1) if pending else 1,
                    )
                )

        # pending notes no event claimed: the decode momentarily failed to
        # report them (e.g. an amplitude dip at the window edge). Carry them
        # within the grace budget so the note isn't silently lost; once
        # exhausted (or at the final flush), EMIT corroborated records
        # (>= 2 sightings) with their last observed end — the decode saw a
        # real note more than once, and losing it entirely was the round-4
        # aggressive-setting recall hole (STREAM_PARITY worst case). Records
        # with a SINGLE sighting the decode never confirmed are dropped:
        # measured on real vocals, they are short window-edge hallucinations
        # the offline decode never reports (emitting them cost precision,
        # 0.9455 -> 0.9086). Both outcomes stay observable in self.stats.
        def superseded(rec: _PendingNote) -> bool:
            """A fresher sighting of the same note already carries it: an
            event emitted this flush, a new pending record, or an earlier
            emitted span that covers the majority of the record's interval.
            Force-emitting on top of it would duplicate the note."""
            spans = (
                [(s, e, p) for s, e, p, _a, _b in out]
                + [(p.orig_onset_s, p.end_s, p.pitch) for p in new_pending]
                + self._emitted_spans
            )
            return covered(rec.orig_onset_s, rec.end_s, spans, rec.pitch)

        for rec in unmatched:
            if not final and rec.misses < self._grace_flushes:
                rec.misses += 1
                new_pending.append(rec)
            elif superseded(rec):
                self.stats["pending_superseded"] += 1
            elif rec.sightings >= 2 and rec.end_s > rec.orig_onset_s:
                out.append(
                    (rec.orig_onset_s, rec.end_s, rec.pitch, rec.amplitude, rec.bends)
                )
                self._emitted_keys.append((rec.match_onset_s, rec.pitch))
                self._emitted_spans.append((rec.orig_onset_s, rec.end_s, rec.pitch))
                self.stats["pending_force_emitted"] += 1
            else:
                if rec.end_s > rec.orig_onset_s:
                    self._dropped_spans.append(
                        (rec.orig_onset_s, rec.end_s, rec.pitch)
                    )
                self.stats["pending_dropped"] += 1

        self._pending = new_pending
        self._finalized_s = max(self._finalized_s, emit_before)
        self.stats["events"] += len(out)
        if not final:
            self._trim(end_s)
        out.sort()
        return out

    def _trim(self, end_s: float) -> None:
        """Drop buffered audio no future decode needs: keep from the oldest
        pending onset (minus a guard) or the finalized horizon, hard-capped
        at ``max_context_seconds``; the cut lands on the frame grid so event
        times from later decodes stay comparable to earlier ones."""
        keep_from_s = self._finalized_s
        if self._pending:
            keep_from_s = min(
                keep_from_s, min(rec.match_onset_s for rec in self._pending)
            )
        keep_from_s -= _TRIM_GUARD_S
        keep_from_s = max(keep_from_s, end_s - self.max_context_seconds, 0.0)
        cut = int(keep_from_s * self.sample_rate)
        cut -= cut % self._align
        if cut <= self._buf_start:
            return
        drop = cut - self._buf_start
        audio = self._buf[0]
        self._buf = [audio[drop:]]
        self._buf_start = cut
        # pending notes whose onset just slid out of the window re-decode
        # with their onset AT the window edge: clamp the match key to the
        # cut so the next flush still recognizes them (max_context cap)
        cut_s = cut / self.sample_rate
        for rec in self._pending:
            if rec.match_onset_s < cut_s:
                rec.match_onset_s = cut_s
                rec.clamped = True
        # emitted keys/spans older than the window can never collide again
        floor = self._buf_start / self.sample_rate - 1.0
        if len(self._emitted_keys) > 256:
            self._emitted_keys = [
                (k, p) for k, p in self._emitted_keys if k >= floor
            ]
        if len(self._emitted_spans) > 256:
            self._emitted_spans = [
                (s, e, p) for s, e, p in self._emitted_spans if e >= floor
            ]
        if len(self._dropped_spans) > 256:
            self._dropped_spans = [
                (s, e, p) for s, e, p in self._dropped_spans if e >= floor
            ]
