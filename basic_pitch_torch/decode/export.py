"""Note events -> MIDI objects.

A copy of `note_events_to_midi` and `drop_overlapping_pitch_bends` from
`basic_pitch_tpu/decode/export.py` (the port imports nothing of the JAX
package), built on the port's own MIDI writer (`utils/midi.py`).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from basic_pitch_torch.decode import notes as note_decode
from basic_pitch_torch.utils import midi as midi_io

MIDI_VELOCITY_SCALE = 127

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
