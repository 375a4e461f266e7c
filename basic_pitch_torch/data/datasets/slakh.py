"""Slakh2100 dataset builder (per-stem tracks).

A copy of `basic_pitch_tpu/data/datasets/slakh.py`. Corpus layout:
``<source>/<split-dir-or-flat>/Track?????/`` directories each holding
``metadata.yaml``, ``MIDI/<stem>.mid``, and ``stems/<stem>.{wav,flac}``.
One training example per non-drum stem with at least one note, with the
reference's filters: the "omitted" split is skipped, drum stems are
skipped, and empty-note stems are skipped. MIDI stems provide note+contour
targets (contours from notes, like MAESTRO). ``yaml`` is imported only
when a corpus is discovered.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from basic_pitch_torch.data import commandline, pipeline
from basic_pitch_torch.data.datasets import base
from basic_pitch_torch.utils import midi as midi_io

DATASET_NAME = "slakh"
SPLIT_DIRS = {"train": "train", "validation": "validation", "test": "test", "omitted": "omitted"}


class SlakhBuilder:
    def __init__(self, source: str):
        self.source = pathlib.Path(source)
        self._tracks: Optional[Dict[str, dict]] = None

    def _discover(self) -> Dict[str, dict]:
        """stem-track-id -> {track_dir, stem, split, metadata}"""
        if self._tracks is not None:
            return self._tracks
        import yaml

        tracks: Dict[str, dict] = {}
        for track_dir in sorted(self.source.rglob("Track*")):
            if not track_dir.is_dir():
                continue
            meta_path = track_dir / "metadata.yaml"
            if not meta_path.exists():
                continue
            with open(meta_path) as fh:
                metadata = yaml.safe_load(fh) or {}
            split = _split_of(track_dir.relative_to(self.source))
            for stem_name, stem_meta in (metadata.get("stems") or {}).items():
                track_id = f"{track_dir.name}-{stem_name}"
                tracks[track_id] = {
                    "dir": track_dir,
                    "stem": stem_name,
                    "split": split,
                    "meta": stem_meta or {},
                }
        self._tracks = tracks
        return tracks

    def input_data(self) -> List[Tuple[str, str]]:
        return [(tid, info["split"]) for tid, info in sorted(self._discover().items())]

    def _stem_paths(self, info: dict):
        midi = info["dir"] / "MIDI" / f"{info['stem']}.mid"
        for ext in (".wav", ".flac"):
            audio = info["dir"] / "stems" / f"{info['stem']}{ext}"
            if audio.exists():
                return midi, audio
        return midi, None

    def filter_invalid(self, track_id: str) -> Optional[str]:
        info = self._discover().get(track_id)
        if info is None:
            return "unknown track"
        if info["split"] == "omitted":
            return "omitted split"
        if info["meta"].get("is_drum"):
            return "drum stem"
        midi, audio = self._stem_paths(info)
        if audio is None:
            return "missing audio"
        if audio.suffix.lower() != ".wav" and not base.ffmpeg_available():
            return f"cannot decode {audio.suffix} without ffmpeg"
        if not midi.exists():
            return "missing midi"
        # note-emptiness is NOT checked here: it needs a full SMF parse, and
        # the filter runs serially in the parent process for every stem —
        # to_examples (parallel, and parsing the MIDI anyway) skips empty
        # stems, so deferring keeps the pool effective on 20k+ stem corpora
        return None

    def to_examples(self, track_ids: List[str]) -> List[bytes]:
        out = []
        for track_id in track_ids:
            info = self._discover()[track_id]
            midi_path, audio_path = self._stem_paths(info)
            notes = _stem_notes(midi_path)
            if not notes:
                continue
            intervals = np.asarray([(n.start, n.end) for n in notes])
            pitches = base.midi_to_hz([n.pitch for n in notes])
            amplitudes = np.asarray([n.velocity / 127.0 for n in notes])
            wav_bytes, duration = base.transcode_to_model_rate(audio_path)
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


def _split_of(track_dir: pathlib.Path) -> str:
    """Split from the track path RELATIVE to the corpus root — an absolute
    path could match a split name in an ancestor directory of the corpus
    (e.g. source=/data/test/slakh2100 classifying everything as test)."""
    for part in track_dir.parts:
        if part in SPLIT_DIRS:
            return SPLIT_DIRS[part]
    return "train"


def _stem_notes(midi_path: pathlib.Path):
    if not midi_path.exists():
        return []
    midi = midi_io.read_midi(midi_path)
    return [n for inst in midi.instruments for n in inst.notes]


def main(args: argparse.Namespace) -> None:
    commandline.maybe_fetch(args, DATASET_NAME)
    builder = SlakhBuilder(args.source)
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
