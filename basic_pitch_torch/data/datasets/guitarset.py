"""GuitarSet dataset builder.

A copy of `basic_pitch_tpu/data/datasets/guitarset.py`. Corpus layout (as
distributed):
    <source>/audio_mono-mic/<track_id>_mic.wav
    <source>/annotation/<track_id>.jams

Per track: six per-string ``note_midi`` annotations merge into the note
target; six ``pitch_contour`` annotations merge into the multi-f0 contour
target, the note/multif0 pairing the reference builds through mirdata.
Splits are random percentage assignments. JAMS files are plain JSON and
parsed directly (`parse_jams`, which `cli/eval.py` also reads references
with).
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
from typing import List, Optional

import numpy as np

from basic_pitch_torch.data import commandline, pipeline
from basic_pitch_torch.data.datasets import base

DATASET_NAME = "guitarset"


def _paths(source: str, track_id: str):
    src = pathlib.Path(source)
    return (
        src / "audio_mono-mic" / f"{track_id}_mic.wav",
        src / "annotation" / f"{track_id}.jams",
    )


def parse_jams(jams_path: "str | pathlib.Path") -> dict:
    """Extract merged note events and pitch contours from a JAMS file."""
    with open(jams_path) as fh:
        jam = json.load(fh)
    intervals, pitches_midi = [], []
    contour_times, contour_freqs = [], []
    for annotation in jam.get("annotations", []):
        namespace = annotation.get("namespace")
        if namespace == "note_midi":
            for obs in annotation.get("data", []):
                intervals.append((obs["time"], obs["time"] + obs["duration"]))
                pitches_midi.append(obs["value"])
        elif namespace == "pitch_contour":
            for obs in annotation.get("data", []):
                value = obs["value"]
                freq = value.get("frequency", 0.0) if isinstance(value, dict) else value
                voiced = value.get("voiced", True) if isinstance(value, dict) else True
                if voiced and freq and freq > 0:
                    contour_times.append(obs["time"])
                    contour_freqs.append(freq)
    return {
        "intervals": np.asarray(intervals, np.float64).reshape(-1, 2),
        "pitches_hz": base.midi_to_hz(pitches_midi) if pitches_midi else np.zeros(0),
        "contour_times": np.asarray(contour_times, np.float64),
        "contour_freqs": np.asarray(contour_freqs, np.float64),
    }


class GuitarSetBuilder:
    def __init__(self, source: str):
        self.source = source

    def track_ids(self) -> List[str]:
        audio_dir = pathlib.Path(self.source) / "audio_mono-mic"
        return sorted(p.name[: -len("_mic.wav")] for p in audio_dir.glob("*_mic.wav"))

    def filter_invalid(self, track_id: str) -> Optional[str]:
        wav, jams = _paths(self.source, track_id)
        if not wav.exists():
            return "missing audio"
        if not jams.exists():
            return "missing annotation"
        return None

    def to_examples(self, track_ids: List[str]) -> List[bytes]:
        out = []
        for track_id in track_ids:
            wav, jams = _paths(self.source, track_id)
            parsed = parse_jams(jams)
            wav_bytes, duration = base.transcode_to_model_rate(wav)
            out.append(
                base.build_example(
                    track_id,
                    DATASET_NAME,
                    wav_bytes,
                    duration,
                    parsed["intervals"],
                    parsed["pitches_hz"],
                    parsed["contour_times"],
                    parsed["contour_freqs"],
                )
            )
        return out


def main(args: argparse.Namespace) -> None:
    commandline.maybe_fetch(args, DATASET_NAME)
    builder = GuitarSetBuilder(args.source)
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
