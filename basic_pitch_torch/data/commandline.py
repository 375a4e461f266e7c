"""Shared command-line flags for dataset builders.

A copy of `basic_pitch_tpu/data/commandline.py` (the reference's ETL flag
surface minus the Beam/Dataflow runner plumbing; the local pipeline
parallelizes with a process pool instead). One deliberate difference: the
default destination is ``~/data/basic_pitch_torch/<dataset>``. The shards
are the same format.
"""

from __future__ import annotations

import argparse
import pathlib


def add_default(parser: argparse.ArgumentParser, dataset_name: str) -> None:
    default_source = str(pathlib.Path.home() / "mir_datasets" / dataset_name)
    default_destination = str(pathlib.Path.home() / "data" / "basic_pitch_torch" / dataset_name)
    parser.add_argument(
        "--source",
        default=default_source,
        type=str,
        help="Source directory for the raw dataset. Defaults to local ~/mir_datasets folder.",
    )
    parser.add_argument(
        "--destination",
        default=default_destination,
        type=str,
        help="Output directory for TFRecord shards.",
    )
    parser.add_argument(
        "--num-workers", type=int, default=0, help="Process-pool size (0 = in-process)."
    )
    parser.add_argument(
        "--timestamped",
        default="true",
        choices=["true", "false"],
        help="If true, output goes under <destination>/<timestamp>/<dataset>.",
    )
    parser.add_argument("--batch-size", default=5, type=int, help="Tracks per TFRecord shard batch.")
    parser.add_argument(
        "--num-tasks",
        type=int,
        default=1,
        help=(
            "Cross-host partitioning: total number of build tasks. Each task "
            "converts the disjoint subset of tracks whose stable hash lands on "
            "its --task-index; N tasks on N hosts against a shared destination "
            "are jointly complete (requires --timestamped false)."
        ),
    )
    parser.add_argument(
        "--task-index",
        type=int,
        default=0,
        help="This task's index in [0, --num-tasks). Builds are resumable: "
        "rerunning skips shards recorded in the per-task manifest.",
    )
    parser.add_argument(
        "--fetch",
        action="store_true",
        help=(
            "Download the remote corpus into --source before building "
            "(resumable, checksum-verified; see basic_pitch_torch.data.fetch)."
        ),
    )


def maybe_fetch(args: argparse.Namespace, dataset_name: str) -> None:
    """Run the acquisition step when --fetch was passed (shared by builders)."""
    if getattr(args, "fetch", False):
        from basic_pitch_torch.data import fetch

        fetch.fetch_dataset(dataset_name, args.source)


def add_split(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--train-percent", type=float, default=0.8, help="Percentage of tracks for training."
    )
    parser.add_argument(
        "--validation-percent", type=float, default=0.1, help="Percentage of tracks for validation."
    )
    parser.add_argument(
        "--split-seed", type=int, default=None, help="Seed for the random split assignment."
    )
