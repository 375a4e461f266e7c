"""Dependency-free MIDI: data model, Standard MIDI File writer and reader,
sine synth.

A copy of `basic_pitch_tpu/utils/midi.py` (the port imports nothing of the
JAX package): a note/pitch-bend event model, a format-1 SMF serializer
(tempo track + one track per instrument), an SMF parser, and an
additive-sine synthesizer for sonification output.
`tests/test_torch_params.py` pins the written bytes, the parse and the
rendering equal.
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

    # --- sonification -----------------------------------------------------

    def synthesize(self, sample_rate: int = 44100, amplitude: float = 0.2) -> np.ndarray:
        """Additive sine rendering with per-note pitch-bend tracking and
        short cosine fades to avoid clicks."""
        end_time = max(
            (n.end for inst in self.instruments for n in inst.notes), default=0.0
        )
        n_samples = int(np.ceil((end_time + 0.05) * sample_rate))
        y = np.zeros(n_samples, dtype=np.float64)
        fade = int(0.01 * sample_rate)

        for instrument in self.instruments:
            bend_times = np.array([b.time for b in instrument.pitch_bends])
            bend_vals = np.array([b.value for b in instrument.pitch_bends])
            order = np.argsort(bend_times) if len(bend_times) else None
            if order is not None:
                bend_times, bend_vals = bend_times[order], bend_vals[order]
            for note in instrument.notes:
                i0 = int(round(note.start * sample_rate))
                i1 = min(int(round(note.end * sample_rate)), n_samples)
                if i1 <= i0:
                    continue
                t = np.arange(i1 - i0) / sample_rate
                freq = 440.0 * 2.0 ** ((note.pitch - 69) / 12.0)
                if order is not None and len(bend_times):
                    # piecewise-constant bend in semitones (8192 ticks = 2 semi)
                    times = note.start + t
                    idx = np.searchsorted(bend_times, times, side="right") - 1
                    semis = np.where(idx >= 0, bend_vals[np.clip(idx, 0, None)] / 4096.0, 0.0)
                    inst_freq = freq * 2.0 ** (semis / 12.0)
                    phase = 2 * np.pi * np.cumsum(inst_freq) / sample_rate
                else:
                    phase = 2 * np.pi * freq * t
                tone = np.sin(phase) * (note.velocity / 127.0) * amplitude
                ramp = min(fade, len(tone) // 2)
                if ramp > 0:
                    window = 0.5 * (1 - np.cos(np.linspace(0, np.pi, ramp)))
                    tone[:ramp] *= window
                    tone[-ramp:] *= window[::-1]
                y[i0:i1] += tone

        peak = np.abs(y).max()
        if peak > 1.0:
            y /= peak
        return y.astype(np.float32)


def read_midi(path: PathLike) -> MidiFile:
    """Parse a Standard MIDI File (formats 0/1) into the event model.

    Handles running status, tempo changes (building a tick->seconds map),
    note-on velocity 0 as note-off, program changes, and pitch bends.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path} is not a MIDI file")
    (_, fmt, n_tracks, division) = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")

    # parse all tracks into (tick, order, kind, payload) events
    tempo_changes = [(0, 500000)]  # (tick, usec per quarter)
    tracks_events = []
    pos = 14
    for _ in range(n_tracks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track header")
        (length,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 8 + length
        events = []
        tick = 0
        cursor = 0
        running = None
        while cursor < len(body):
            delta = 0
            while True:
                byte = body[cursor]
                cursor += 1
                delta = (delta << 7) | (byte & 0x7F)
                if not byte & 0x80:
                    break
            tick += delta
            status = body[cursor]
            if status & 0x80:
                cursor += 1
                if status < 0xF0:
                    running = status
            else:
                status = running
            if status is None:
                raise ValueError("running status without prior status byte")
            if status == 0xFF:  # meta
                meta_type = body[cursor]
                cursor += 1
                mlen = 0
                while True:
                    byte = body[cursor]
                    cursor += 1
                    mlen = (mlen << 7) | (byte & 0x7F)
                    if not byte & 0x80:
                        break
                payload = body[cursor : cursor + mlen]
                cursor += mlen
                if meta_type == 0x51 and mlen == 3:
                    tempo_changes.append((tick, int.from_bytes(payload, "big")))
            elif status in (0xF0, 0xF7):  # sysex
                slen = 0
                while True:
                    byte = body[cursor]
                    cursor += 1
                    slen = (slen << 7) | (byte & 0x7F)
                    if not byte & 0x80:
                        break
                cursor += slen
            else:
                kind = status & 0xF0
                channel = status & 0x0F
                if kind in (0xC0, 0xD0):  # program change / channel pressure
                    value = body[cursor]
                    cursor += 1
                    events.append((tick, kind, channel, value, 0))
                else:
                    a, b = body[cursor], body[cursor + 1]
                    cursor += 2
                    events.append((tick, kind, channel, a, b))
        tracks_events.append(events)

    # tick -> seconds map from the merged tempo track
    tempo_changes.sort()
    boundaries = []  # (tick, seconds_at_tick, usec_per_quarter)
    seconds = 0.0
    last_tick, last_tempo = 0, 500000
    for tick, tempo in tempo_changes:
        seconds += (tick - last_tick) * last_tempo / (1e6 * division)
        boundaries.append((tick, seconds, tempo))
        last_tick, last_tempo = tick, tempo

    def tick_to_seconds(tick: int) -> float:
        lo = 0
        for btick, bsec, btempo in boundaries:
            if btick <= tick:
                lo_tick, lo_sec, lo_tempo = btick, bsec, btempo
            else:
                break
        return lo_sec + (tick - lo_tick) * lo_tempo / (1e6 * division)

    midi = MidiFile(resolution=division)
    if len(tempo_changes) > 1:
        midi.tempo = 60000000.0 / tempo_changes[1][1]
    for events in tracks_events:
        if not any(kind in (0x90, 0x80) for _, kind, *_ in events):
            continue
        instrument = Instrument()
        active = {}  # (channel, pitch) -> (start_tick, velocity)
        for tick, kind, channel, a, b in events:
            if kind == 0xC0:
                instrument.program = a
            elif kind == 0xE0:
                value = ((b << 7) | a) - 8192
                instrument.pitch_bends.append(PitchBend(time=tick_to_seconds(tick), value=value))
            elif kind == 0x90 and b > 0:
                active.setdefault((channel, a), []).append((tick, b))
            elif kind == 0x80 or (kind == 0x90 and b == 0):
                stack = active.get((channel, a))
                if stack:
                    start_tick, velocity = stack.pop(0)
                    instrument.notes.append(
                        Note(
                            start=tick_to_seconds(start_tick),
                            end=tick_to_seconds(tick),
                            pitch=a,
                            velocity=velocity,
                        )
                    )
        instrument.notes.sort(key=lambda n: (n.start, n.pitch))
        midi.instruments.append(instrument)
    return midi


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
