"""MAESTRO dataset builder.

A copy of `basic_pitch_tpu/data/datasets/maestro.py`. Corpus layout: the
official archive with ``maestro-v*.json`` at the root listing
per-performance audio/MIDI paths and the official split. Notes come from
the ground-truth MIDI (parsed with the port's own SMF reader) and serve as
note, onset, AND contour targets, as the reference's pretty_midi path does.
Tracks of 15 minutes or longer are rejected.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
from typing import Dict, List, Optional

import numpy as np

from basic_pitch_torch.data import commandline, pipeline
from basic_pitch_torch.data.datasets import base
from basic_pitch_torch.utils import midi as midi_io

DATASET_NAME = "maestro"
MAX_DURATION_SECONDS = 15 * 60


class MaestroBuilder:
    def __init__(self, source: str):
        self.source = pathlib.Path(source)
        self._index: Optional[Dict[str, dict]] = None

    @property
    def index(self) -> Dict[str, dict]:
        if self._index is None:
            candidates = sorted(self.source.glob("maestro-v*.json"))
            if not candidates:
                raise FileNotFoundError(f"no maestro-v*.json under {self.source}")
            with open(candidates[-1]) as fh:
                raw = json.load(fh)
            records = raw if isinstance(raw, list) else _columnar_to_records(raw)
            self._index = {
                str(pathlib.Path(r["midi_filename"]).stem): r for r in records
            }
        return self._index

    def track_ids(self) -> List[str]:
        return sorted(self.index)

    def input_data(self) -> "list[tuple[str, str]]":
        # official split assignment (`maestro.py:166-170`)
        return [(tid, rec["split"]) for tid, rec in sorted(self.index.items())]

    def filter_invalid(self, track_id: str) -> Optional[str]:
        record = self.index.get(track_id)
        if record is None:
            return "unknown track"
        if float(record.get("duration", 0.0)) >= MAX_DURATION_SECONDS:
            return "longer than 15 minutes"
        audio = self.source / record["audio_filename"]
        if not audio.exists():
            return "missing audio"
        if audio.suffix.lower() != ".wav" and not base.ffmpeg_available():
            return f"cannot decode {audio.suffix} without ffmpeg"
        if not (self.source / record["midi_filename"]).exists():
            return "missing midi"
        return None

    def to_examples(self, track_ids: List[str]) -> List[bytes]:
        out = []
        for track_id in track_ids:
            record = self.index[track_id]
            midi = midi_io.read_midi(self.source / record["midi_filename"])
            notes = [n for inst in midi.instruments for n in inst.notes]
            if not notes:
                continue
            intervals = np.asarray([(n.start, n.end) for n in notes])
            pitches = base.midi_to_hz([n.pitch for n in notes])
            amplitudes = np.asarray([n.velocity / 127.0 for n in notes])
            wav_bytes, duration = base.transcode_to_model_rate(
                self.source / record["audio_filename"]
            )
            out.append(
                base.build_example(
                    track_id,
                    DATASET_NAME,
                    wav_bytes,
                    duration,
                    intervals,
                    pitches,
                    None,
                    None,
                    note_amplitudes=amplitudes,
                    contours_from_notes=True,
                )
            )
        return out


def _columnar_to_records(raw: dict) -> List[dict]:
    """maestro v3 json is columnar: {field: {index: value}}."""
    fields = list(raw)
    keys = sorted(raw[fields[0]], key=int)
    return [{f: raw[f][k] for f in fields} for k in keys]


def main(args: argparse.Namespace) -> None:
    commandline.maybe_fetch(args, DATASET_NAME)
    builder = MaestroBuilder(args.source)
    pipeline.run(
        DATASET_NAME,
        builder.input_data(),
        builder.to_examples,
        builder.filter_invalid,
        args.destination,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        timestamped=args.timestamped == "true",
        num_tasks=args.num_tasks,
        task_index=args.task_index,
    )


def build_parser(parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    parser = parser or argparse.ArgumentParser(description=__doc__)
    commandline.add_default(parser, DATASET_NAME)
    return parser


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(build_parser().parse_args())
