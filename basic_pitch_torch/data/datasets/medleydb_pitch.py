"""MedleyDB-Pitch dataset builder (monophonic pitch tracking subset).

A copy of `basic_pitch_tpu/data/datasets/medleydb_pitch.py`. Corpus layout:
    <source>/audio/<track_id>.wav
    <source>/pitch/<track_id>.csv      (time,frequency rows)
    <source>/notes_pyin/<track_id>.csv (optional pyin notes: start,duration,midi)

Pitch tracks become contour targets; pyin note events (when present) become
note/onset targets, the reference's pairing through mirdata. Splits are
random percentage assignments.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
from typing import List, Optional, Tuple

import numpy as np

from basic_pitch_torch.data import commandline, pipeline
from basic_pitch_torch.data.datasets import base
from basic_pitch_torch.data.datasets.ikala import parse_notes_csv

DATASET_NAME = "medleydb_pitch"


def _paths(source: str, track_id: str):
    src = pathlib.Path(source)
    return (
        src / "audio" / f"{track_id}.wav",
        src / "pitch" / f"{track_id}.csv",
        src / "notes_pyin" / f"{track_id}.csv",
    )


def parse_pitch_csv(path: "str | pathlib.Path") -> Tuple[np.ndarray, np.ndarray]:
    times, freqs = [], []
    for line in open(path):
        parts = line.strip().split(",")
        if len(parts) < 2:
            continue
        try:
            t, f = float(parts[0]), float(parts[1])
        except ValueError:
            continue
        times.append(t)
        freqs.append(f)
    return np.asarray(times), np.asarray(freqs)


class MedleyDBPitchBuilder:
    def __init__(self, source: str):
        self.source = source

    def track_ids(self) -> List[str]:
        audio_dir = pathlib.Path(self.source) / "audio"
        return sorted(p.stem for p in audio_dir.glob("*.wav"))

    def filter_invalid(self, track_id: str) -> Optional[str]:
        wav, pitch, _ = _paths(self.source, track_id)
        if not wav.exists():
            return "missing audio"
        if not pitch.exists():
            return "missing pitch annotation"
        return None

    def to_examples(self, track_ids: List[str]) -> List[bytes]:
        out = []
        for track_id in track_ids:
            wav, pitch, notes_csv = _paths(self.source, track_id)
            contour_times, contour_freqs = parse_pitch_csv(pitch)
            if notes_csv.exists():
                intervals, pitches = parse_notes_csv(notes_csv)
            else:
                intervals, pitches = np.zeros((0, 2)), np.zeros(0)
            wav_bytes, duration = base.transcode_to_model_rate(wav)
            out.append(
                base.build_example(
                    track_id,
                    DATASET_NAME,
                    wav_bytes,
                    duration,
                    intervals,
                    pitches,
                    contour_times,
                    contour_freqs,
                )
            )
        return out


def main(args: argparse.Namespace) -> None:
    commandline.maybe_fetch(args, DATASET_NAME)
    builder = MedleyDBPitchBuilder(args.source)
    input_data = pipeline.assign_percentage_splits(
        builder.track_ids(), args.train_percent, args.validation_percent, args.split_seed
    )
    pipeline.run(
        DATASET_NAME,
        input_data,
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
    commandline.add_split(parser)
    return parser


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(build_parser().parse_args())
