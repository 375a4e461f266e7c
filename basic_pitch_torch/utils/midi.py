"""Dependency-free MIDI: data model and Standard MIDI File writer.

A copy of `basic_pitch_tpu/utils/midi.py` (the port imports nothing of the
JAX package): a note/pitch-bend event model, a format-1 SMF serializer
(tempo track + one track per instrument). `tests/test_torch_params.py`
pins the written bytes equal.
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct
from typing import List, Union

import numpy as np

PathLike = Union[str, pathlib.Path]

DEFAULT_RESOLUTION = 220  # ticks per quarter note
ELECTRIC_PIANO_1 = 4  # General MIDI program number (0-based)


@dataclasses.dataclass
class Note:
    start: float  # seconds
    end: float
    pitch: int  # MIDI note number
    velocity: int  # 1-127


@dataclasses.dataclass
class PitchBend:
    time: float  # seconds
    value: int  # -8192 .. 8191 (14-bit, 0 = no bend)


@dataclasses.dataclass
class Instrument:
    program: int = 0
    name: str = ""
    notes: List[Note] = dataclasses.field(default_factory=list)
    pitch_bends: List[PitchBend] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MidiFile:
    instruments: List[Instrument] = dataclasses.field(default_factory=list)
    tempo: float = 120.0  # BPM, constant
    resolution: int = DEFAULT_RESOLUTION

    # --- serialization ----------------------------------------------------

    def _seconds_to_ticks(self, seconds: float) -> int:
        return max(0, int(round(seconds * self.resolution * self.tempo / 60.0)))

    # the 15 melodic channels, cycled per instrument slot — matches
    # pretty_midi's writer, which never assigns channel 9 (GM percussion)
    # and never lets two of the first 15 instruments share a channel
    _MELODIC_CHANNELS = tuple(c for c in range(16) if c != 9)

    def write(self, path: PathLike) -> None:
        """Serialize as a format-1 Standard MIDI File.

        ``path`` may also be an open binary file object (e.g. BytesIO — the
        HTTP server streams MIDI without touching disk)."""
        tracks = [self._tempo_track()]
        for channel_slot, instrument in enumerate(self.instruments):
            channel = self._MELODIC_CHANNELS[channel_slot % len(self._MELODIC_CHANNELS)]
            tracks.append(self._instrument_track(instrument, channel))

        def _emit(fh) -> None:
            fh.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), self.resolution))
            for track in tracks:
                fh.write(b"MTrk" + struct.pack(">I", len(track)) + track)

        if hasattr(path, "write"):
            _emit(path)
        else:
            with open(path, "wb") as fh:
                _emit(fh)

    def _tempo_track(self) -> bytes:
        microseconds_per_quarter = int(round(60_000_000 / self.tempo))
        out = bytearray()
        out += _vlq(0) + bytes([0xFF, 0x51, 0x03]) + microseconds_per_quarter.to_bytes(3, "big")
        out += _vlq(0) + bytes([0xFF, 0x2F, 0x00])  # end of track
        return bytes(out)

    def _instrument_track(self, instrument: Instrument, channel: int) -> bytes:
        events = []  # (tick, order, message bytes)
        events.append((0, 0, bytes([0xC0 | channel, instrument.program & 0x7F])))
        for bend in instrument.pitch_bends:
            u14 = int(np.clip(bend.value, -8192, 8191)) + 8192
            events.append(
                (
                    self._seconds_to_ticks(bend.time),
                    1,
                    bytes([0xE0 | channel, u14 & 0x7F, (u14 >> 7) & 0x7F]),
                )
            )
        for note in instrument.notes:
            pitch = int(np.clip(note.pitch, 0, 127))
            velocity = int(np.clip(note.velocity, 1, 127))
            on_tick = self._seconds_to_ticks(note.start)
            off_tick = max(self._seconds_to_ticks(note.end), on_tick + 1)
            # note-offs sort before note-ons at the same tick so zero-gap
            # retriggers of the same pitch stay well-formed
            events.append((on_tick, 3, bytes([0x90 | channel, pitch, velocity])))
            events.append((off_tick, 2, bytes([0x80 | channel, pitch, 0])))

        events.sort(key=lambda e: (e[0], e[1]))
        out = bytearray()
        last_tick = 0
        for tick, _, message in events:
            out += _vlq(tick - last_tick) + message
            last_tick = tick
        out += _vlq(0) + bytes([0xFF, 0x2F, 0x00])
        return bytes(out)


def _vlq(value: int) -> bytes:
    """MIDI variable-length quantity encoding."""
    if value < 0:
        raise ValueError("negative delta time")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(chunks))
