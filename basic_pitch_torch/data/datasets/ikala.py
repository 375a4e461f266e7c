"""iKala dataset builder (singing voice).

A copy of `basic_pitch_tpu/data/datasets/ikala.py`. Corpus layout:
    <source>/Wavfile/<track_id>.wav   (stereo: ch0 instrumental, ch1 vocal)
    <source>/PitchLabel/<track_id>.pv (frame-level vocal pitch, MIDI numbers,
                                       one value per 32 ms hop)
    <source>/notes_pyin/<track_id>.csv (optional pyin note events:
                                        start,duration,midi)

Only the VOCAL channel is kept, pv pitch tracks become contour targets, and
pyin notes (when present) become note/onset targets; otherwise the example
carries empty note annotations with shape (0, 0). iKala has no test split:
tracks are assigned train/validation only, as in the reference.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import random
from typing import List, Optional, Tuple

import numpy as np

from basic_pitch_torch.data import commandline, pipeline
from basic_pitch_torch.data.datasets import base

DATASET_NAME = "ikala"
PV_HOP_SECONDS = 0.032


def _paths(source: str, track_id: str):
    src = pathlib.Path(source)
    return (
        src / "Wavfile" / f"{track_id}.wav",
        src / "PitchLabel" / f"{track_id}.pv",
        src / "notes_pyin" / f"{track_id}.csv",
    )


def parse_pv(path: "str | pathlib.Path") -> Tuple[np.ndarray, np.ndarray]:
    """pv file -> (times, freqs_hz); zero entries are unvoiced."""
    pitch_midi = np.array(
        [float(line.strip()) for line in open(path) if line.strip()], np.float64
    )
    times = np.arange(len(pitch_midi)) * PV_HOP_SECONDS
    freqs = np.where(pitch_midi > 0, base.midi_to_hz(pitch_midi), 0.0)
    return times, freqs


def parse_notes_csv(path: "str | pathlib.Path") -> Tuple[np.ndarray, np.ndarray]:
    """start,duration,midi csv -> (intervals, pitches_hz)."""
    rows = []
    for line in open(path):
        parts = line.strip().split(",")
        if len(parts) < 3:
            continue
        try:
            start, duration, midi = float(parts[0]), float(parts[1]), float(parts[2])
        except ValueError:
            continue  # header
        rows.append((start, start + duration, midi))
    if not rows:
        return np.zeros((0, 2)), np.zeros(0)
    arr = np.asarray(rows)
    return arr[:, :2], base.midi_to_hz(arr[:, 2])


class IkalaBuilder:
    def __init__(self, source: str):
        self.source = source

    def track_ids(self) -> List[str]:
        wav_dir = pathlib.Path(self.source) / "Wavfile"
        return sorted(p.stem for p in wav_dir.glob("*.wav"))

    def input_data(
        self, train_percent: float = 0.9, seed: Optional[int] = None
    ) -> "list[tuple[str, str]]":
        """train/validation only — iKala defines no test split."""
        ids = self.track_ids()
        rng = random.Random(seed)
        rng.shuffle(ids)
        cut = int(len(ids) * train_percent)
        return [(tid, "train" if i < cut else "validation") for i, tid in enumerate(ids)]

    def filter_invalid(self, track_id: str) -> Optional[str]:
        wav, pv, _ = _paths(self.source, track_id)
        if not wav.exists():
            return "missing audio"
        if not pv.exists():
            return "missing pitch label"
        return None

    def to_examples(self, track_ids: List[str]) -> List[bytes]:
        out = []
        for track_id in track_ids:
            wav, pv, notes_csv = _paths(self.source, track_id)
            contour_times, contour_freqs = parse_pv(pv)
            if notes_csv.exists():
                intervals, pitches = parse_notes_csv(notes_csv)
            else:
                intervals, pitches = np.zeros((0, 2)), np.zeros(0)
            wav_bytes, duration = base.transcode_to_model_rate(wav, channel=1)
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
    if (
        getattr(args, "validation_percent", None) is not None
        and abs(args.validation_percent - (1.0 - args.train_percent)) > 1e-9
    ):
        import warnings

        warnings.warn(
            "iKala has no test split: everything past --train-percent is "
            "validation, so --validation-percent="
            f"{args.validation_percent} is ignored "
            f"(effective validation share: {1.0 - args.train_percent:.3f})",
            stacklevel=1,
        )
    commandline.maybe_fetch(args, DATASET_NAME)
    builder = IkalaBuilder(args.source)
    pipeline.run(
        DATASET_NAME,
        # reference semantics (`ikala.py:151,172`): only train_percent is
        # consulted — everything past the cut is validation (iKala has no
        # test split, so --validation-percent is implied by the remainder)
        builder.input_data(args.train_percent, args.split_seed),
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
    # iKala has no test split: validation is whatever --train-percent leaves,
    # so let main() detect an explicitly-passed --validation-percent and warn
    parser.set_defaults(validation_percent=None)
    return parser


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(build_parser().parse_args())
