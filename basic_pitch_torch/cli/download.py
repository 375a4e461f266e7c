"""``basic-pitch-torch-download`` command-line interface: build training datasets.

A copy of `basic_pitch_tpu/cli/download.py` (``bp-download``): two-stage
argparse with a dataset dispatch table, as the reference's downloader has.
Each subcommand converts a locally available corpus into the TFRecord
layout the port's loader reads (<destination>/<dataset>/splits/<split>/
*.tfrecord); with ``--fetch`` the remote corpus is first downloaded into
``--source`` (resumable transfers, md5 verification,
`basic_pitch_torch.data.fetch`). Host-only: it touches no device.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def _dispatch_table():
    from basic_pitch_torch.data.datasets import (
        guitarset,
        ikala,
        maestro,
        medleydb_pitch,
        slakh,
    )

    return {
        "guitarset": (guitarset.build_parser, guitarset.main),
        "ikala": (ikala.build_parser, ikala.main),
        "maestro": (maestro.build_parser, maestro.main),
        "medleydb_pitch": (medleydb_pitch.build_parser, medleydb_pitch.main),
        "slakh": (slakh.build_parser, slakh.main),
    }


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    table = _dispatch_table()
    parser = argparse.ArgumentParser(
        description="Build training datasets (TFRecord shards) from local MIR corpora."
    )
    parser.add_argument("dataset", choices=sorted(table), help="dataset to build")
    args, remaining = parser.parse_known_args(argv)

    build_parser, run = table[args.dataset]
    sub = build_parser()
    run(sub.parse_args(remaining))


if __name__ == "__main__":
    main()
