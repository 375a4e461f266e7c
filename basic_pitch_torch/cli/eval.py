"""``basic-pitch-torch-eval``: note-transcription evaluation CLI.

The flags and report of `basic_pitch_tpu/cli/eval.py` (``basic-pitch-eval``),
plus ``--device`` (``cuda`` by default, as the port's other CLIs; ``cpu``
only when asked for, and without a GPU the default raises):

    # score a transcription against ground truth
    basic-pitch-torch-eval estimated.mid reference.jams

    # transcribe audio on the card, then score it
    basic-pitch-torch-eval performance.wav reference.mid

    # corpus mode: pair files by stem across two directories
    basic-pitch-torch-eval est_dir/ ref_dir/

Inputs on either side may be MIDI (.mid/.midi, the port's SMF reader in
utils/midi.py), note-event CSV (the schema ``basic-pitch-torch`` writes:
start_time_s,end_time_s,pitch_midi,velocity,...), or JAMS (.jams with
note_midi annotations, as GuitarSet ships). An estimated-side audio file
(.wav) is transcribed first through `inference.predict` on ``--device``
(windowed, decoded on the host, as the JAX CLI does). Metrics follow
mir_eval.transcription semantics (utils/eval.py): maximum bipartite
matching with onset within ``--onset-tolerance`` s and pitch within
``--pitch-tolerance`` cents; the onset+offset criterion additionally
requires offsets within ``--offset-ratio`` of the reference duration
(>= ``--offset-min-tolerance`` s).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional

from basic_pitch_torch.utils.eval import Note, events_to_notes, precision_recall_f1

MIDI_SUFFIXES = {".mid", ".midi"}
AUDIO_SUFFIXES = {".wav", ".wave"}


def midi_notes(path: pathlib.Path) -> List[Note]:
    from basic_pitch_torch.utils import midi as midi_io

    mf = midi_io.read_midi(path)
    notes = [
        (float(n.start), float(n.end), int(n.pitch))
        for inst in mf.instruments
        for n in inst.notes
    ]
    return sorted(notes)


def csv_notes(path: pathlib.Path) -> List[Note]:
    """Parse the note-event CSV `basic-pitch` writes (reference schema)."""
    notes: List[Note] = []
    with open(path) as fh:
        header = fh.readline().strip().split(",")
        if header[:3] != ["start_time_s", "end_time_s", "pitch_midi"]:
            raise ValueError(
                f"{path}: expected a basic-pitch note-events CSV "
                "(start_time_s,end_time_s,pitch_midi,...)"
            )
        for line in fh:
            line = line.strip()
            if not line:
                continue
            cols = line.split(",")
            notes.append((float(cols[0]), float(cols[1]), int(float(cols[2]))))
    return sorted(notes)


def jams_notes(path: pathlib.Path) -> List[Note]:
    """note_midi annotations from a JAMS file (e.g. GuitarSet ground truth)."""
    from basic_pitch_torch.data.datasets.guitarset import parse_jams
    from basic_pitch_torch.decode.notes import hz_to_midi

    parsed = parse_jams(path)
    notes = [
        (float(start), float(end), int(round(hz_to_midi(hz))))
        for (start, end), hz in zip(parsed["intervals"], parsed["pitches_hz"])
    ]
    return sorted(notes)


def transcribed_notes(path: pathlib.Path, ns: argparse.Namespace) -> List[Note]:
    from basic_pitch_torch import inference

    _, _, events = inference.predict(
        str(path),
        onset_threshold=ns.onset_threshold,
        frame_threshold=ns.frame_threshold,
        minimum_note_length=ns.minimum_note_length,
        minimum_frequency=ns.minimum_frequency,
        maximum_frequency=ns.maximum_frequency,
        melodia_trick=not ns.no_melodia,
        device=ns.device,
    )
    return sorted(events_to_notes(events))


def load_notes(path: pathlib.Path, ns: argparse.Namespace, side: str) -> List[Note]:
    suffix = path.suffix.lower()
    if suffix in MIDI_SUFFIXES:
        return midi_notes(path)
    if suffix == ".csv":
        return csv_notes(path)
    if suffix == ".jams":
        return jams_notes(path)
    if suffix in AUDIO_SUFFIXES:
        if side != "estimated":
            raise ValueError(
                f"{path}: audio is only accepted on the estimated side "
                "(the reference side must be ground-truth notes)"
            )
        return transcribed_notes(path, ns)
    raise ValueError(f"{path}: unsupported input type {suffix!r} (mid|csv|jams|wav)")


def _pair_directories(est_dir: pathlib.Path, ref_dir: pathlib.Path):
    """Match files across directories by stem (est stem may carry the
    `_basic_pitch` suffix the predict CLI appends)."""

    def stem_key(p: pathlib.Path) -> str:
        stem = p.stem
        return stem[: -len("_basic_pitch")] if stem.endswith("_basic_pitch") else stem

    suffixes = MIDI_SUFFIXES | AUDIO_SUFFIXES | {".csv", ".jams"}
    ref_by_stem = {}
    for p in sorted(ref_dir.iterdir()):
        if p.suffix.lower() in (MIDI_SUFFIXES | {".csv", ".jams"}):
            ref_by_stem.setdefault(stem_key(p), p)
    pairs, unmatched = [], []
    for p in sorted(est_dir.iterdir()):
        if p.suffix.lower() not in suffixes:
            continue
        ref = ref_by_stem.get(stem_key(p))
        if ref is None:
            unmatched.append(p.name)
        else:
            pairs.append((p, ref))
    return pairs, unmatched


def score_pair(
    est: List[Note], ref: List[Note], ns: argparse.Namespace
) -> Dict[str, Dict]:
    onset_only = precision_recall_f1(
        ref,
        est,
        onset_tolerance=ns.onset_tolerance,
        pitch_tolerance=ns.pitch_tolerance,
    )
    with_offset = precision_recall_f1(
        ref,
        est,
        onset_tolerance=ns.onset_tolerance,
        pitch_tolerance=ns.pitch_tolerance,
        offset_ratio=ns.offset_ratio,
        offset_min_tolerance=ns.offset_min_tolerance,
    )
    return {"onset": onset_only, "onset_offset": with_offset}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Score note transcriptions (note-level precision/recall/F1, "
        "mir_eval.transcription semantics).",
    )
    parser.add_argument(
        "estimated",
        help="estimated notes: .mid/.csv, audio (.wav — transcribed first), "
        "or a directory of them",
    )
    parser.add_argument(
        "reference",
        help="ground-truth notes: .mid/.csv/.jams, or a directory of them",
    )
    parser.add_argument("--onset-tolerance", type=float, default=0.05, help="seconds")
    parser.add_argument("--pitch-tolerance", type=float, default=50.0, help="cents")
    parser.add_argument(
        "--offset-ratio", type=float, default=0.2,
        help="offset criterion: |offset diff| <= ratio * reference duration",
    )
    parser.add_argument("--offset-min-tolerance", type=float, default=0.05)
    parser.add_argument("--json", dest="json_out", metavar="PATH", default=None,
                        help="also write the full report as JSON")
    # transcription knobs (used only when the estimated side is audio)
    parser.add_argument("--onset-threshold", type=float, default=0.5)
    parser.add_argument("--frame-threshold", type=float, default=0.3)
    parser.add_argument("--minimum-note-length", type=float, default=127.7,
                        help="milliseconds, like the predict CLI")
    parser.add_argument("--minimum-frequency", type=float, default=None)
    parser.add_argument("--maximum-frequency", type=float, default=None)
    parser.add_argument("--no-melodia", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where an audio input is transcribed (default cuda; fails without a GPU)")
    return parser


def _fmt(metrics: Dict[str, float]) -> str:
    return (
        f"P {metrics['precision']:.4f}  R {metrics['recall']:.4f}  "
        f"F1 {metrics['f1']:.4f}  ({metrics['n_matched']}/{metrics['n_reference']} "
        f"ref, {metrics['n_estimated']} est)"
    )


def main(args: Optional[List[str]] = None) -> int:
    ns = build_parser().parse_args(args)
    from basic_pitch_torch import pipeline

    # without a GPU, --device cuda raises here, before anything runs
    ns.device = pipeline.resolve_device(ns.device)
    est_path = pathlib.Path(ns.estimated)
    ref_path = pathlib.Path(ns.reference)
    for p in (est_path, ref_path):
        if not p.exists():
            print(f"error: {p} does not exist", file=sys.stderr)
            return 2

    if est_path.is_dir() != ref_path.is_dir():
        print("error: estimated and reference must both be files or both be "
              "directories", file=sys.stderr)
        return 2

    report: Dict = {
        "criteria": {
            "onset_tolerance_s": ns.onset_tolerance,
            "pitch_tolerance_cents": ns.pitch_tolerance,
            "offset_ratio": ns.offset_ratio,
            "offset_min_tolerance_s": ns.offset_min_tolerance,
        },
        "per_file": [],
    }

    if est_path.is_dir():
        pairs, unmatched = _pair_directories(est_path, ref_path)
        if unmatched:
            print(f"warning: no reference for {len(unmatched)} file(s): "
                  f"{', '.join(unmatched[:5])}{'...' if len(unmatched) > 5 else ''}",
                  file=sys.stderr)
        if not pairs:
            print("error: no matching (estimated, reference) pairs", file=sys.stderr)
            return 2
    else:
        pairs = [(est_path, ref_path)]

    totals = {
        crit: {"n_matched": 0, "n_reference": 0, "n_estimated": 0}
        for crit in ("onset", "onset_offset")
    }
    for est_file, ref_file in pairs:
        est_notes = load_notes(est_file, ns, "estimated")
        ref_notes = load_notes(ref_file, ns, "reference")
        scores = score_pair(est_notes, ref_notes, ns)
        report["per_file"].append(
            {"estimated": str(est_file), "reference": str(ref_file), **scores}
        )
        for crit in totals:
            for key in totals[crit]:
                totals[crit][key] += scores[crit][key]
        if len(pairs) > 1:
            print(f"{est_file.name}: onset {_fmt(scores['onset'])}")

    # micro-averaged aggregate (pooled counts), the corpus-level number
    aggregate = {}
    for crit, t in totals.items():
        precision = t["n_matched"] / t["n_estimated"] if t["n_estimated"] else 0.0
        recall = t["n_matched"] / t["n_reference"] if t["n_reference"] else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall) > 0
            else 0.0
        )
        aggregate[crit] = {"precision": precision, "recall": recall, "f1": f1, **t}
    report["aggregate"] = aggregate

    label = "aggregate" if len(pairs) > 1 else "score"
    print(f"{label} (onset+pitch):        {_fmt(aggregate['onset'])}")
    print(f"{label} (onset+pitch+offset): {_fmt(aggregate['onset_offset'])}")

    if ns.json_out:
        pathlib.Path(ns.json_out).write_text(json.dumps(report, indent=2) + "\n")
        print(f"report written to {ns.json_out}")
    return 0


def console_entry_point() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    console_entry_point()
