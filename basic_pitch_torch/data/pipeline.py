"""Generic dataset-building pipeline: track ids -> sharded TFRecords.

A copy of `basic_pitch_tpu/data/pipeline.py`, writing through the port's
`data/tfrecord.py`. The reference's Beam stages (filter invalid tracks,
batch, convert to serialized examples, write per-split TFRecord shards +
an index) run on commodity hosts with two orthogonal axes of scale:

* **within a host**: a multiprocessing pool (``num_workers``) transcodes
  track batches in parallel;
* **across hosts**: deterministic task partitioning (``num_tasks`` /
  ``task_index``). Each task owns the tracks whose stable content hash
  (crc32 of the track id) lands on its index, so N tasks started on N
  machines against a shared filesystem produce disjoint, jointly-complete
  shard sets with no coordination service.

Builds are **resumable and idempotent**: every completed shard is recorded
in a per-task manifest (``manifest-t{task:03d}.jsonl``; shard files are
written to a temp name and atomically renamed first), so a killed build
rerun with the same arguments skips finished shards and re-converts only
what's missing. A per-task ``_COMPLETE-t{task:03d}.json`` marker records
the finished totals; `is_complete()` answers whether all N tasks are done.

A dataset builder supplies two callables (see `datasets/`):
  * ``filter_invalid(track_id) -> Optional[reason]`` — drop bad tracks;
  * ``to_examples(track_ids) -> list[bytes]`` — serialized tf.train.Examples.
"""

from __future__ import annotations

import csv
import json
import logging
import multiprocessing
import os
import pathlib
import random
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from basic_pitch_torch.data import tfrecord

logger = logging.getLogger(__name__)

Splits = Dict[str, List[str]]  # split name -> track ids


def assign_percentage_splits(
    track_ids: Sequence[str],
    train_percent: float,
    validation_percent: float,
    seed: Optional[int] = None,
) -> List[Tuple[str, str]]:
    """Shuffled percentage split assignment (test = remainder), mirroring
    `create_input_data` (`datasets/guitarset.py:126-151`)."""
    assert train_percent + validation_percent < 1.0, "Don't over allocate the data!"
    ids = list(track_ids)
    rng = random.Random(seed)
    rng.shuffle(ids)
    n = len(ids)
    out = []
    for i, track_id in enumerate(ids):
        if i < n * train_percent:
            split = "train"
        elif i < n * (train_percent + validation_percent):
            split = "validation"
        else:
            split = "test"
        out.append((track_id, split))
    return out


def task_of(track_id: str, num_tasks: int) -> int:
    """Stable task assignment: crc32 of the track id mod num_tasks.

    Content-addressed (no dependence on enumeration order), so every task
    computes the same partition independently and the union over task
    indices is exactly the full id set."""
    return zlib.crc32(track_id.encode("utf-8")) % num_tasks


def _batched(ids: Sequence[str], batch_size: int) -> List[List[str]]:
    return [list(ids[i : i + batch_size]) for i in range(0, len(ids), batch_size)]


class _Manifest:
    """Append-only per-task record of completed shards (resume state).

    One JSON line per finished shard: {"split", "shard", "tracks",
    "examples", "path"}. Appends are flushed+fsynced after the shard file's
    atomic rename, so a crash can lose at most the in-flight shard — whose
    temp file the rerun simply overwrites."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self.done: Dict[Tuple[str, int], dict] = {}
        if path.exists():
            for line in path.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                self.done[(entry["split"], entry["shard"])] = entry
        self._fh = open(path, "a")

    def has(self, split: str, shard: int) -> bool:
        return (split, shard) in self.done

    def record(self, split: str, shard: int, tracks: List[str], examples: int, path: str) -> None:
        entry = {
            "split": split,
            "shard": shard,
            "tracks": tracks,
            "examples": examples,
            "path": path,
        }
        self.done[(split, shard)] = entry
        self._fh.write(json.dumps(entry) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()


def write_split(
    to_examples: Callable[[List[str]], List[bytes]],
    track_ids: Sequence[str],
    destination: pathlib.Path,
    batch_size: int,
    pool: Optional[multiprocessing.pool.Pool],
    task_index: int = 0,
    manifest: Optional[_Manifest] = None,
    split_name: str = "",
) -> int:
    """Write one split's shards for one task; skips manifest-completed ones.

    Shard files are ``t{task:03d}-{i:05d}.tfrecord`` (task-disjoint names,
    so concurrent tasks never collide on a shared filesystem), written to a
    ``.tmp-t{task}`` temp name and atomically renamed."""
    destination.mkdir(parents=True, exist_ok=True)
    batches = _batched(list(track_ids), batch_size)
    todo = [
        (i, batch)
        for i, batch in enumerate(batches)
        if manifest is None or not manifest.has(split_name, i)
    ]
    skipped = len(batches) - len(todo)
    if skipped:
        logger.info(
            "%s: resume — %d/%d shards already complete", split_name, skipped, len(batches)
        )
    # stream results: each batch holds full WAV bytes, so materializing every
    # shard of a large split at once (pool.map / list comprehension) costs
    # tens of GB on MAESTRO-sized corpora; imap keeps one window in flight
    if pool is not None:
        results = pool.imap(to_examples, [batch for _, batch in todo])
    else:
        results = (to_examples(batch) for _, batch in todo)
    written = sum(
        e["examples"]
        for e in (manifest.done.values() if manifest is not None else [])
        if e["split"] == split_name
    )
    for (i, batch), records in zip(todo, results):
        path = destination / f"t{task_index:03d}-{i:05d}.tfrecord"
        if records:
            tmp = destination / f"{path.name}.tmp-t{task_index}"
            with tfrecord.TFRecordWriter(tmp) as writer:
                for record in records:
                    writer.write(record)
            os.replace(tmp, path)  # atomic: readers never see partial shards
            written += len(records)
        if manifest is not None:
            manifest.record(split_name, i, batch, len(records), str(path))
    return written


def run(
    name: str,
    input_data: List[Tuple[str, str]],
    to_examples: Callable[[List[str]], List[bytes]],
    filter_invalid: Callable[[str], Optional[str]],
    destination: str,
    batch_size: int = 5,
    num_workers: int = 0,
    timestamped: bool = True,
    num_tasks: int = 1,
    task_index: int = 0,
) -> pathlib.Path:
    """Build one dataset (this task's partition of it): filter -> per-split
    shards + index.csv + manifest + completion marker.

    Multi-host builds: start one process per task with the SAME arguments
    except ``task_index`` (0..num_tasks-1) and a shared ``destination``;
    partitions are disjoint and jointly complete (`task_of`). Reruns resume
    from the manifest. Returns the dataset's output directory.
    """
    if not 0 <= task_index < num_tasks:
        raise ValueError(f"task_index {task_index} out of range for {num_tasks} tasks")
    if timestamped and num_tasks > 1:
        raise ValueError(
            "multi-task builds need a shared destination: pass timestamped=False "
            "(tasks started at different times would otherwise write to "
            "different <timestamp>/ directories)"
        )
    base = pathlib.Path(destination)
    if timestamped:
        base = base / str(int(time.time()))
    dataset_dir = base / name
    dataset_dir.mkdir(parents=True, exist_ok=True)

    splits: Splits = {}
    dropped = []
    mine = 0
    for track_id, split in input_data:
        reason = filter_invalid(track_id)
        if reason:
            dropped.append((track_id, reason))
            continue
        splits.setdefault(split, []).append(track_id)
    for track_id, reason in dropped:
        logger.info("dropping %s: %s", track_id, reason)

    # index.csv covers the FULL dataset (all tasks) and is a deterministic
    # function of input_data, so every task writes identical content; the
    # temp+rename makes concurrent writers safe on a shared filesystem
    index_tmp = dataset_dir / f".index.csv.tmp-t{task_index}"
    with open(index_tmp, "w", newline="") as fh:
        writer = csv.writer(fh)
        for split, ids in sorted(splits.items()):
            for track_id in ids:
                writer.writerow([split, track_id])
    os.replace(index_tmp, dataset_dir / "index.csv")

    if num_tasks > 1:
        splits = {
            split: [t for t in ids if task_of(t, num_tasks) == task_index]
            for split, ids in splits.items()
        }

    manifest = _Manifest(dataset_dir / f"manifest-t{task_index:03d}.jsonl")
    totals: Dict[str, int] = {}
    pool = multiprocessing.Pool(num_workers) if num_workers > 0 else None
    try:
        for split, ids in sorted(splits.items()):
            count = write_split(
                to_examples,
                ids,
                dataset_dir / "splits" / split,
                batch_size,
                pool,
                task_index=task_index,
                manifest=manifest,
                split_name=split,
            )
            totals[split] = count
            mine += len(ids)
            logger.info(
                "%s/%s (task %d/%d): wrote %d examples from %d tracks",
                name, split, task_index, num_tasks, count, len(ids),
            )
    finally:
        if pool is not None:
            pool.close()
            pool.join()
        manifest.close()

    marker_tmp = dataset_dir / f"._COMPLETE.tmp-t{task_index}"
    marker_tmp.write_text(
        json.dumps(
            {
                "task_index": task_index,
                "num_tasks": num_tasks,
                "tracks": mine,
                "examples_per_split": totals,
            },
            indent=2,
        )
        + "\n"
    )
    os.replace(marker_tmp, dataset_dir / f"_COMPLETE-t{task_index:03d}.json")
    return dataset_dir


def is_complete(dataset_dir: "str | pathlib.Path", num_tasks: int) -> bool:
    """True when every task of an N-task build has written its marker."""
    d = pathlib.Path(dataset_dir)
    return all((d / f"_COMPLETE-t{i:03d}.json").exists() for i in range(num_tasks))
