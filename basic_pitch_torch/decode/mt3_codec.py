"""MT3's event codec, read back: a recording's segments of tokens to note
events.

The vocabulary after PAD 0, EOS 1 and UNK 2 is MT3's codec in its order
(`mt3/vocabularies.py`): shift 0..1000 (10 ms steps since the segment's
start), pitch 0..127, velocity bins 0..1, tie, program 0..127, drum
0..127. Within a segment, shifts in a row add up and the next other token
sets the time to the segment's start plus that many steps; program and
velocity tokens set a state that the following pitches take (velocity 0
ends a note, any other starts one at velocity 127 per bin). Each segment
opens with its tie section: program and pitch tokens naming the notes that
carry over from the segment before, closed by the tie token, at which every
sounding note not named there ends at the segment's start. A drum token
makes a note of ``drum_note_s``. A note that starts while the same pitch
and program sound ends the sounding one first; every note lasts at least
`MIN_NOTE_S`; notes still sounding at the recording's end end there.
Tokens that cannot stand where they are (PAD, UNK, an offset of a note not
sounding, a velocity or drum in a tie section, a tie outside one, a drum at
velocity 0) are skipped, and a segment ends at its first EOS. A segment's
program (0) and velocity (100, MT3's default) start afresh.

Events are the port's `NoteEvent` tuples, (start s, end s, MIDI pitch,
amplitude = velocity / 127, None), sorted by start, end, pitch and
program, with each event's program beside them (128 for a drum).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PAD, EOS, UNK = 0, 1, 2
SHIFT = 3  # first id of each event type
N_SHIFTS = 1001
PITCH = SHIFT + N_SHIFTS
VELOCITY = PITCH + 128
N_VELOCITIES = 2
TIE = VELOCITY + N_VELOCITIES
PROGRAM = TIE + 1
DRUM = PROGRAM + 128
VOCAB = DRUM + 128  # 1 391
STEPS_PER_SECOND = 100
MAX_VELOCITY = 127
DEFAULT_VELOCITY = 100
DRUM_PROGRAM = 128
MIN_NOTE_S = 0.01


class _Notes:
    """Sounding notes by (pitch, program) and the finished ones."""

    def __init__(self) -> None:
        self.sounding: Dict[Tuple[int, int], Tuple[float, int]] = {}
        self.done: List[Tuple[float, float, int, int, int]] = []  # start, end, pitch, velocity, program

    def end(self, key: Tuple[int, int], t: float) -> None:
        start, velocity = self.sounding.pop(key)
        self.done.append((start, max(t, start + MIN_NOTE_S), key[0], velocity, key[1]))


def tokens_to_events(
    segment_tokens: Sequence[Sequence[int]], duration_s: float, segment_samples: int, sample_rate: int, drum_note_s: float
) -> Tuple[List[tuple], List[int]]:
    """One recording's segments of ids, in order -> (events, programs)."""
    notes = _Notes()
    for k, toks in enumerate(segment_tokens):
        start = k * segment_samples / sample_rate
        program, velocity = 0, DEFAULT_VELOCITY
        steps, now = 0, start
        tie_section, tied = True, set()
        for tok in toks:
            tok = int(tok)
            if tok == EOS:
                break
            if SHIFT <= tok < PITCH:
                steps += tok - SHIFT
                now = start + steps / STEPS_PER_SECOND
                continue
            steps = 0
            if PROGRAM <= tok < DRUM:
                program = tok - PROGRAM
            elif tie_section:
                key = (tok - PITCH, program)
                if PITCH <= tok < VELOCITY and key in notes.sounding:
                    tied.add(key)
                elif tok == TIE:
                    for held in [held for held in notes.sounding if held not in tied]:
                        notes.end(held, start)
                    tie_section = False
            elif VELOCITY <= tok < TIE:
                velocity = (tok - VELOCITY) * MAX_VELOCITY // (N_VELOCITIES - 1)
            elif PITCH <= tok < VELOCITY:
                key = (tok - PITCH, program)
                if key in notes.sounding:
                    notes.end(key, now)
                if velocity:
                    notes.sounding[key] = (now, velocity)
            elif DRUM <= tok < VOCAB and velocity:
                notes.done.append((now, now + drum_note_s, tok - DRUM, velocity, DRUM_PROGRAM))
    for key in list(notes.sounding):
        notes.end(key, duration_s)
    done = sorted(notes.done, key=lambda n: (n[0], n[1], n[2], n[4]))
    return [(s, e, p, v / MAX_VELOCITY, None) for s, e, p, v, _ in done], [n[4] for n in done]
