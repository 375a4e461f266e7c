"""Note events -> MIDI objects, plus sonification helpers.

A copy of `basic_pitch_tpu/decode/export.py` (the port imports nothing of
the JAX package), built on the port's own host decoder (`decode/notes.py`),
MIDI writer (`utils/midi.py`) and WAV writer (`utils/audio.py`).
"""

from __future__ import annotations

import pathlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from basic_pitch_torch import constants
from basic_pitch_torch.decode import notes as note_decode
from basic_pitch_torch.utils import audio as audio_io
from basic_pitch_torch.utils import midi as midi_io

MIDI_VELOCITY_SCALE = 127
SONIFY_FS = 3000

NoteEvent = note_decode.NoteEvent


def drop_overlapping_pitch_bends(events: List[NoteEvent]) -> List[NoteEvent]:
    """Remove pitch bends from any notes that overlap in time with another
    note. MIDI pitch bends are per-channel, so simultaneous notes would all
    bend together.

    A note keeps its bends iff it overlaps no other note; with events sorted
    by start this is "the next start is at or after my end, and no earlier
    note's end reaches past my start".
    """
    # sort by an explicit key: the 5th tuple element is `list | None`, so a
    # bare sorted(events) would raise TypeError on (start, end, pitch, amp) ties
    events = sorted(events, key=lambda e: (e[0], e[1], e[2], e[3]))
    n = len(events)
    if n <= 1:
        return events
    starts = np.array([e[0] for e in events])
    ends = np.array([e[1] for e in events])
    prev_max_end = np.concatenate([[-np.inf], np.maximum.accumulate(ends)[:-1]])
    next_start = np.concatenate([starts[1:], [np.inf]])
    isolated = (next_start >= ends) & (prev_max_end <= starts)
    return [
        e if keep else e[:-1] + (None,)
        for e, keep in zip(events, isolated)
    ]


def note_events_to_midi(
    events: List[NoteEvent],
    multiple_pitch_bends: bool = False,
    midi_tempo: float = 120,
) -> midi_io.MidiFile:
    """Build a MidiFile from second-domain note events.

    When multiple_pitch_bends is True, each pitch gets its own instrument so
    overlapping notes can bend independently; otherwise overlapping notes
    lose their bends.
    """
    if not multiple_pitch_bends:
        events = drop_overlapping_pitch_bends(events)

    instruments: Dict[int, midi_io.Instrument] = defaultdict(
        lambda: midi_io.Instrument(program=midi_io.ELECTRIC_PIANO_1)
    )
    for start, end, pitch, amplitude, bends in events:
        velocity = int(np.round(MIDI_VELOCITY_SCALE * amplitude))
        instrument = instruments[pitch if multiple_pitch_bends else 0]
        if velocity > 0:
            instrument.notes.append(
                midi_io.Note(
                    start=float(start),
                    end=float(end),
                    pitch=int(pitch),
                    velocity=velocity,
                )
            )
        # a velocity-0 note is omitted, but its pitch-bend events still go to
        # the channel (they alter the channel's bend state either way)
        if not bends:
            continue
        bend_times = np.linspace(start, end, len(bends))
        ticks = np.round(
            np.asarray(bends) * note_decode.PITCH_BEND_TICKS_PER_CONTOUR_BIN
        ).astype(int)
        ticks = np.clip(ticks, -note_decode.N_PITCH_BEND_TICKS, note_decode.N_PITCH_BEND_TICKS - 1)
        for t, v in zip(bend_times, ticks):
            instrument.pitch_bends.append(midi_io.PitchBend(time=float(t), value=int(v)))

    midi = midi_io.MidiFile(tempo=midi_tempo)
    midi.instruments.extend(instruments.values())
    return midi


def model_output_to_notes(
    output: Dict[str, np.ndarray],
    onset_thresh: float,
    frame_thresh: float,
    infer_onsets: bool = True,
    min_note_len: int = 11,
    min_freq: Optional[float] = None,
    max_freq: Optional[float] = None,
    include_pitch_bends: bool = True,
    multiple_pitch_bends: bool = False,
    melodia_trick: bool = True,
    midi_tempo: float = 120,
) -> Tuple[midi_io.MidiFile, List[NoteEvent]]:
    """Full posteriorgram -> (MidiFile, note events in seconds), decoded on
    the host."""
    config = note_decode.DecodeConfig(
        onset_threshold=onset_thresh,
        frame_threshold=frame_thresh,
        min_note_length=min_note_len,
        infer_onsets=infer_onsets,
        min_freq=min_freq,
        max_freq=max_freq,
        melodia_trick=melodia_trick,
    )
    frame_notes = note_decode.decode_note_events(output["note"], output["onset"], config)
    if include_pitch_bends:
        with_bends = note_decode.extract_pitch_bends(output["contour"], frame_notes)
    else:
        with_bends = [(s, e, p, a, None) for s, e, p, a in frame_notes]

    times = note_decode.model_frames_to_time(output["contour"].shape[0])
    events = [
        (float(times[s]), float(times[e]), int(p), float(a), b) for s, e, p, a, b in with_bends
    ]
    return note_events_to_midi(events, multiple_pitch_bends, midi_tempo), events


def sonify_midi(
    midi: midi_io.MidiFile, save_path: Union[str, pathlib.Path], sr: int = 44100
) -> None:
    """Render a MidiFile to a WAV file."""
    audio_io.write_wav(save_path, midi.synthesize(sr), sr)


def sonify_salience(
    gram: np.ndarray,
    semitone_resolution: int,
    save_path: Optional[str] = None,
    thresh: float = 0.2,
) -> Tuple[np.ndarray, int]:
    """Sonify a (n_freqs, n_times) salience matrix with additive sines.

    Frequencies follow the log-spaced CQT grid; values below `thresh` are
    muted. Renders at a low internal rate for speed, then resamples to
    44.1 kHz when saving.
    """
    freqs = constants.ANNOTATIONS_BASE_FREQUENCY * 2.0 ** (
        np.arange(gram.shape[0]) / (12.0 * semitone_resolution)
    )
    keep = freqs < SONIFY_FS / 2
    gram = np.where(gram < thresh, 0.0, gram)[keep]
    freqs = freqs[keep]

    hop_seconds = (constants.AUDIO_N_SAMPLES / constants.ANNOT_N_FRAMES) / constants.AUDIO_SAMPLE_RATE
    n_samples = int(np.ceil(gram.shape[1] * hop_seconds * SONIFY_FS))
    t = np.arange(n_samples) / SONIFY_FS
    frame_of_sample = np.minimum((t / hop_seconds).astype(int), gram.shape[1] - 1)

    y = np.zeros(n_samples, dtype=np.float64)
    for k, f in enumerate(freqs):
        amps = gram[k]
        if not np.any(amps):
            continue
        y += amps[frame_of_sample] * np.sin(2 * np.pi * f * t)
    peak = np.abs(y).max()
    if peak > 0:
        y = y / peak * 0.8
    y = y.astype(np.float32)

    if save_path:
        audio_io.write_wav(save_path, audio_io.resample(y, SONIFY_FS, 44100), 44100)
    return y, SONIFY_FS
