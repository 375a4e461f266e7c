"""Training-data ingest: weighted multi-dataset sampling -> windowed batches.

A copy of `basic_pitch_tpu/data/loader.py` (the port imports nothing of the
JAX package): for the same directory and seed it yields bit-identical
batches (`tests/test_torch_loader.py`), and `tests/test_torch_params.py`
pins its constants. A numpy/thread implementation of the reference's
tf.data pipeline, producing batches shaped for the train step
(`basic_pitch_torch/train/loop.py`):

    {"audio": (B, 43844) f32,
     "targets": {"onset"/"note": (B, 172, 88), "contour": (B, 172, 264)},
     "weights": {head: (B,)}}

Semantics preserved:
  * train file order: per-dataset shuffle, then weighted random dataset
    choice without replacement until the first dataset runs dry
    (`_train_file_generator` `:268-279`);
  * validation: round-robin across datasets (`:282-293`);
  * per-head presence weights with zero-filled missing targets (`:522-588`);
  * 20 random 2-second windows per track, all-silent windows dropped
    (`:591-729`); validation windows use deterministic per-(track, index)
    seeds — a deliberate improvement over the reference's per-index-only
    seeding, which gives every track the same relative window offsets;
  * optional pairs-mixing augmentation: mean audio / max labels / min
    weights (`:296-321`);
  * example-level shuffle buffer, infinite repeat, cached validation batches.
"""

from __future__ import annotations

import glob
import os
import queue
import random
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from basic_pitch_torch import constants
from basic_pitch_torch.data import serialization, tfrecord

N_SAMPLES_PER_TRACK = 20

Batch = Dict[str, object]


def _dataset_files(
    datasets_base_path: str,
    dataset_name: str,
    split: str,
    num_shards: int = 1,
    shard_index: int = 0,
) -> List[str]:
    """Shard files for one split; with num_shards > 1 keep only this
    host's stable-hash partition (multi-host training: each process feeds
    its own disjoint file subset).

    The dataset's directory is ``dataset_name`` as the trainer names it
    ("GuitarSet", "MedleyDB-Pitch", ...) or, where no such directory
    exists, the name the ETL builders write ("guitarset",
    "medleydb_pitch", ...), so shards built by ``basic-pitch-torch-download``
    train as they are. The JAX loader reads only the first, and finds no
    ETL-built shard on a case-sensitive filesystem."""
    dataset_dir = os.path.join(datasets_base_path, dataset_name)
    built_dir = os.path.join(datasets_base_path, dataset_name.lower().replace("-", "_"))
    if not os.path.isdir(dataset_dir) and os.path.isdir(built_dir):
        dataset_dir = built_dir
    pattern = os.path.join(dataset_dir, "splits", split, "*tfrecord")
    files = sorted(glob.glob(pattern))
    if num_shards > 1:
        files = [
            f
            for f in files
            if zlib.crc32(os.path.basename(f).encode()) % num_shards == shard_index
        ]
    return files


def train_file_order(
    file_dict: Dict[str, List[str]], weights: np.ndarray, rng: random.Random
) -> Iterator[str]:
    """Weighted interleave without replacement; stops when any dataset dries up."""
    pools = {k: list(v) for k, v in file_dict.items()}
    keys = list(pools)
    for k in keys:
        rng.shuffle(pools[k])
    weights = np.asarray(weights, np.float64)
    weights = weights / weights.sum()
    while all(pools.values()):
        key = rng.choices(keys, weights=weights)[0]
        yield pools[key].pop()


def validation_file_order(file_dict: Dict[str, List[str]]) -> Iterator[str]:
    """Round-robin across datasets until all are exhausted."""
    pools = {k: list(v) for k, v in file_dict.items()}
    while any(pools.values()):
        for k in pools:
            if pools[k]:
                yield pools[k].pop()


def _sample_weights(example: serialization.ParsedExample):
    """Presence weights + zero-fill of missing targets (`:522-588`)."""
    onsets, contours, notes = example.onsets, example.contours, example.notes
    time_size = max(onsets.shape[0], contours.shape[0], notes.shape[0])
    onset_w = float(onsets.shape[0] != 0)
    contour_w = float(contours.shape[0] != 0)
    note_w = float(notes.shape[0] != 0)
    if onsets.shape[0] == 0:
        onsets = np.zeros((time_size, constants.N_FREQ_BINS_NOTES), np.float32)
    if contours.shape[0] == 0:
        contours = np.zeros((time_size, constants.N_FREQ_BINS_CONTOURS), np.float32)
    if notes.shape[0] == 0:
        notes = np.zeros((time_size, constants.N_FREQ_BINS_NOTES), np.float32)
    return onsets, contours, notes, onset_w, contour_w, note_w


def _extract_window(audio, onsets, contours, notes, t_start: float):
    """Fixed-length window at time t_start (`trim_time`/`extract_window`)."""
    a0 = int(round(constants.AUDIO_SAMPLE_RATE * t_start))
    audio_w = audio[a0 : a0 + constants.AUDIO_N_SAMPLES]
    f0 = int(round(constants.ANNOTATIONS_FPS * t_start))
    onsets_w = onsets[f0 : f0 + constants.ANNOT_N_FRAMES]
    contours_w = contours[f0 : f0 + constants.ANNOT_N_FRAMES]
    notes_w = notes[f0 : f0 + constants.ANNOT_N_FRAMES]
    if (
        len(audio_w) < constants.AUDIO_N_SAMPLES
        or onsets_w.shape[0] < constants.ANNOT_N_FRAMES
        or contours_w.shape[0] < constants.ANNOT_N_FRAMES
        or notes_w.shape[0] < constants.ANNOT_N_FRAMES
    ):
        return None  # mirrors the reference's ignore_errors failsafe
    return audio_w, onsets_w, contours_w, notes_w


_HEAD_TO_SER = {"onset": "onsets", "contour": "contours", "note": "notes"}
_HEAD_BINS = {
    "onset": constants.N_FREQ_BINS_NOTES,
    "note": constants.N_FREQ_BINS_NOTES,
    "contour": constants.N_FREQ_BINS_CONTOURS,
}


def _prep_track_coo(example: serialization.ParsedExample):
    """Track-level COO prepared for window slicing.

    Per head: t-major sorted, last-write-deduped (the dense scatter keeps
    the last duplicate), zero-value-filtered (t, f, val) arrays — exactly
    the entries ``np.nonzero`` of the densified raster yields, in the same
    row-major order, so the COO window path collates bit-identically to
    the dense path without ever building rasters.
    """
    heads = {}
    shapes = {}
    for head, ser in _HEAD_TO_SER.items():
        idx, val, shape = example.sparse_head(ser)
        shapes[head] = shape
        bins = _HEAD_BINS[head]
        if val.size:
            flat = idx[:, 0].astype(np.int64) * bins + idx[:, 1]
            order = np.argsort(flat, kind="stable")
            flat, v = flat[order], val[order]
            keep = np.ones(len(flat), bool)
            keep[:-1] = flat[1:] != flat[:-1]
            keep &= v != 0  # np.nonzero of the raster skips stored zeros
            flat, v = flat[keep], v[keep]
            heads[head] = (flat // bins, (flat % bins).astype(np.int32), v)
        else:
            heads[head] = (
                np.zeros(0, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32)
            )
    return heads, shapes


def _iter_track_windows_coo(
    example: serialization.ParsedExample,
    n_samples_per_track: int,
    deterministic: bool,
    rng: np.random.RandomState,
):
    """COO-mode twin of `iter_track_windows`: same RNG draws, same
    validity/silent decisions (annotation activations are non-negative, so
    the dense path's ``mean() == 0`` silent test equals "no nonzero entry
    in the window"), but targets stay sparse — no raster fill, no dense
    window slices, no re-sparsification at collate. Items carry
    ``targets_coo[head] = (flat_window_idx int32, values f32)``.
    """
    coo, shapes = _prep_track_coo(example)
    time_size = max(s[0] for s in shapes.values())
    # window frame budget: present heads bound by their raster length,
    # absent heads by the zeros(time_size) fill (`_sample_weights`)
    frame_bound = min(
        (s[0] if s[0] != 0 else time_size) for s in shapes.values()
    )
    weights = {
        head: float(shapes[head][0] != 0) for head in _HEAD_TO_SER
    }
    n_sec = len(example.audio) / constants.AUDIO_SAMPLE_RATE
    max_start = n_sec - constants.AUDIO_N_SAMPLES / constants.AUDIO_SAMPLE_RATE
    if max_start <= 0:
        return
    track_seed = zlib.crc32(str(example.file_id).encode()) & 0x7FFFFFFF
    for i in range(n_samples_per_track):
        local = np.random.RandomState((track_seed + i) & 0x7FFFFFFF) if deterministic else rng
        t_start = local.uniform(0.0, max_start)
        a0 = int(round(constants.AUDIO_SAMPLE_RATE * t_start))
        audio_w = example.audio[a0 : a0 + constants.AUDIO_N_SAMPLES]
        f0 = int(round(constants.ANNOTATIONS_FPS * t_start))
        if (
            len(audio_w) < constants.AUDIO_N_SAMPLES
            or f0 + constants.ANNOT_N_FRAMES > frame_bound
        ):
            continue
        spans = {}
        for head, (t, f, v) in coo.items():
            lo = np.searchsorted(t, f0, "left")
            hi = np.searchsorted(t, f0 + constants.ANNOT_N_FRAMES, "left")
            spans[head] = (lo, hi)
        if (
            spans["contour"][0] == spans["contour"][1]
            and spans["note"][0] == spans["note"][1]
        ):
            continue  # all-silent (`is_not_all_silent_annotations`)
        targets_coo = {}
        for head, (t, f, v) in coo.items():
            lo, hi = spans[head]
            flat = (
                (t[lo:hi] - f0) * _HEAD_BINS[head] + f[lo:hi]
            ).astype(np.int32)
            targets_coo[head] = (flat, v[lo:hi])
        yield {
            "audio": audio_w.astype(np.float32),
            "targets_coo": targets_coo,
            "weights": dict(weights),
        }


def iter_track_windows(
    example: serialization.ParsedExample,
    n_samples_per_track: int,
    deterministic: bool,
    rng: np.random.RandomState,
    coo: bool = False,
) -> "Iterator[dict]":
    """Random 2-second windows of one track, silent ones dropped."""
    if coo:
        yield from _iter_track_windows_coo(
            example, n_samples_per_track, deterministic, rng
        )
        return
    onsets, contours, notes, ow, cw, nw = _sample_weights(example)
    n_sec = len(example.audio) / constants.AUDIO_SAMPLE_RATE
    max_start = n_sec - constants.AUDIO_N_SAMPLES / constants.AUDIO_SAMPLE_RATE
    if max_start <= 0:
        return
    # deterministic (validation) seeding is per (track, window-index), so
    # different tracks sample different offsets — seeding on the index alone
    # would give every track the same relative window positions
    track_seed = zlib.crc32(str(example.file_id).encode()) & 0x7FFFFFFF
    for i in range(n_samples_per_track):
        local = np.random.RandomState((track_seed + i) & 0x7FFFFFFF) if deterministic else rng
        t_start = local.uniform(0.0, max_start)
        window = _extract_window(example.audio, onsets, contours, notes, t_start)
        if window is None:
            continue
        audio_w, onsets_w, contours_w, notes_w = window
        if contours_w.mean() == 0 and notes_w.mean() == 0:
            continue  # all-silent (`is_not_all_silent_annotations`)
        yield {
            "audio": audio_w.astype(np.float32),
            "targets": {"onset": onsets_w, "contour": contours_w, "note": notes_w},
            "weights": {"onset": ow, "contour": cw, "note": nw},
        }


def _combine_pair(a: Dict, b: Dict) -> Dict:
    """Pairs-mixing augmentation (`combine_transcription_examples`)."""
    return {
        "audio": (a["audio"] + b["audio"]) / 2.0,
        "targets": {
            k: np.maximum(a["targets"][k], b["targets"][k]) for k in a["targets"]
        },
        "weights": {k: min(a["weights"][k], b["weights"][k]) for k in a["weights"]},
    }


def example_stream(
    split: str,
    datasets_base_path: str,
    datasets: Sequence[str],
    dataset_sampling_frequency: Sequence[float],
    n_samples_per_track: int = N_SAMPLES_PER_TRACK,
    pairs: bool = False,
    seed: Optional[int] = None,
    num_shards: int = 1,
    shard_index: int = 0,
    parse_workers: int = 1,
    coo: bool = False,
) -> Iterator[Dict]:
    """One pass over the split: every file once, windows per track.

    ``num_shards``/``shard_index`` restrict the pass to this host's file
    partition (disjoint across indices, jointly complete).
    ``parse_workers > 1`` parses records on a small thread pool (the heavy
    numpy work — proto walk, WAV decode, sparse densify — releases the GIL);
    order is preserved, so window extraction consumes the shared rng in the
    same sequence and the stream stays deterministic for a fixed seed.
    ``coo=True`` yields sparse-target items (`_iter_track_windows_coo`) —
    the `device_targets` fast path; incompatible with ``pairs`` (mixing
    needs dense windows)."""
    if coo and pairs:
        raise ValueError("coo window items do not support pairs mixing")
    if split == "validation":
        pairs = False
        if n_samples_per_track != 1:
            n_samples_per_track = 5

    file_dict = {
        name: _dataset_files(datasets_base_path, name, split, num_shards, shard_index)
        for name in datasets
    }
    missing = [k for k, v in file_dict.items() if not v]
    if missing:
        raise FileNotFoundError(
            f"no tfrecords found for {missing} under {datasets_base_path}"
            + (f" (shard {shard_index}/{num_shards})" if num_shards > 1 else "")
        )
    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)

    if split == "train":
        order = train_file_order(file_dict, np.asarray(dataset_sampling_frequency), rng)
    else:
        order = validation_file_order(file_dict)

    def records() -> Iterator[bytes]:
        for path in order:
            yield from tfrecord.read_tfrecords(path)

    def safe_parse(record: bytes):
        try:
            return serialization.parse_transcription_example(record)
        except Exception:
            return None  # corrupt example failsafe (`:364`)

    if parse_workers > 1:
        parsed = _parallel_map(records(), safe_parse, parse_workers)
    else:
        parsed = map(safe_parse, records())

    pending_pair: Optional[Dict] = None
    for example in parsed:
        if example is None:
            continue
        if all(
            example.head_shape(h)[0] == 0 for h in ("notes", "onsets", "contours")
        ):
            continue
        for item in iter_track_windows(
            example, n_samples_per_track, deterministic=(split != "train"),
            rng=nprng, coo=coo,
        ):
            if pairs:
                if pending_pair is None:
                    pending_pair = item
                else:
                    yield _combine_pair(pending_pair, item)
                    pending_pair = None
                # unpaired examples also flow through, like the
                # reference's choose_from_datasets alternation
                yield item
            else:
                yield item


def _parallel_map(items: Iterator, fn, workers: int, ahead: int = 16) -> Iterator:
    """Order-preserving parallel map with bounded in-flight work."""
    import collections
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        futures = collections.deque()
        for item in items:
            futures.append(pool.submit(fn, item))
            if len(futures) >= ahead:
                yield futures.popleft().result()
        while futures:
            yield futures.popleft().result()


def _shuffled(stream: Iterator[Dict], buffer_size: int, rng: random.Random) -> Iterator[Dict]:
    buffer: List[Dict] = []
    for item in stream:
        if len(buffer) < buffer_size:
            buffer.append(item)
            continue
        idx = rng.randrange(buffer_size)
        yield buffer[idx]
        buffer[idx] = item
    rng.shuffle(buffer)
    yield from buffer


def _batch_lists(stream: Iterator[Dict], batch_size: int) -> Iterator[List[Dict]]:
    items: List[Dict] = []
    for item in stream:
        items.append(item)
        if len(items) == batch_size:
            yield items
            items = []


def _batched(
    stream: Iterator[Dict],
    batch_size: int,
    device_targets: bool = False,
    collate_workers: int = 1,
) -> Iterator[Batch]:
    """Collate item lists into batches; ``collate_workers > 1`` runs the
    collate on an order-preserving thread pool. On a GIL build it is a
    slight pessimization (the numpy ops are too small to release the GIL
    usefully), so the default stays 1; the knob exists for free-threaded or
    larger-batch deployments."""
    collate = _collate_device if device_targets else _collate
    lists = _batch_lists(stream, batch_size)
    if collate_workers > 1:
        yield from _parallel_map(lists, collate, collate_workers, ahead=4)
    else:
        yield from map(collate, lists)


def _collate(items: List[Dict]) -> Batch:
    return {
        "audio": np.stack([it["audio"] for it in items]),
        "targets": {
            k: np.stack([it["targets"][k] for it in items])
            for k in ("onset", "contour", "note")
        },
        "weights": {
            k: np.asarray([it["weights"][k] for it in items], np.float32)
            for k in ("onset", "contour", "note")
        },
    }


# per-head sparse-target capacity floors, the JAX package's (whose compiled
# train step is keyed by the cap triple, so caps stay stable across
# batches): floors sized for dense real annotations (synthetic-guitar
# maxima: onset <128, note <2048, contour <2048) serve a whole corpus at
# one shape; denser material ratchets a head to the next pow2.
_SPARSE_CAP_FLOORS = {"onset": 512, "note": 2048, "contour": 4096}


def _sparse_head(head: str, mats: List[np.ndarray]) -> Dict[str, np.ndarray]:
    """Dense (T, bins) windows -> batched flat COO at a pow2 nnz bucket.

    Flat index = t * bins + f (int32); padding slots carry the out-of-range
    sentinel T * bins so the device scatter (mode="drop") ignores them. Coords
    within a window are unique (np.nonzero of a dense matrix), so a plain
    scatter-set reproduces the dense matrix bit-exactly.

    One batched np.nonzero over the stacked windows: per-window nonzero
    calls were the loader's measured hot spot (~29 ms per 64-window batch
    in 192 small GIL-bound calls); the batched sweep is one big pass and
    yields the identical row-major ordering per window.
    """
    frames, bins = mats[0].shape
    stacked = np.stack(mats)  # (B, T, bins)
    bs, ts, fs = np.nonzero(stacked)
    flat = ts.astype(np.int32) * np.int32(bins) + fs.astype(np.int32)
    vals = stacked[bs, ts, fs].astype(np.float32)
    counts = np.bincount(bs, minlength=len(mats))
    cap = _SPARSE_CAP_FLOORS[head]
    while cap < int(counts.max(initial=0)):
        cap *= 2
    idx = np.full((len(mats), cap), frames * bins, np.int32)
    val = np.zeros((len(mats), cap), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    pos = np.arange(len(bs)) - starts[bs]
    idx[bs, pos] = flat
    val[bs, pos] = vals
    return {"idx": idx, "val": val}


def _collate_coo_head(head: str, entries: List) -> Dict[str, np.ndarray]:
    """Window COO (flat idx, val) pairs -> the batched (B, cap) wire form
    `_sparse_head` produces from dense windows — same pow2-cap ratchet,
    same sentinel padding, bit-identical contents (the window COO already
    carries np.nonzero's order/dedupe semantics, `_prep_track_coo`)."""
    bins = _HEAD_BINS[head]
    counts = np.fromiter((e[0].size for e in entries), np.int64, len(entries))
    cap = _SPARSE_CAP_FLOORS[head]
    while cap < int(counts.max(initial=0)):
        cap *= 2
    sentinel = constants.ANNOT_N_FRAMES * bins
    idx = np.full((len(entries), cap), sentinel, np.int32)
    val = np.zeros((len(entries), cap), np.float32)
    for i, (flat, v) in enumerate(entries):
        idx[i, : flat.size] = flat
        val[i, : v.size] = v
    return {"idx": idx, "val": val}


_audio_transport_warned = False


def _audio_transport(stack: np.ndarray) -> np.ndarray:
    """Ship audio as int16 when x == round(x*32768)/32768 holds bit-exactly
    for the whole batch (true whenever the source was 22.05 kHz mono PCM16,
    e.g. every corpus the ETL writes); otherwise keep float32. The train step
    dequantizes by the same /32768, so the device sees identical floats.

    All-f32 arithmetic: PCM16-derived samples are exactly k/32768, so
    k = x * 32768 is exact in f32 and rint introduces no rounding ambiguity.

    The check is all-or-nothing per batch (a batch has one audio dtype):
    any non-PCM16 window — notably EVERY pairs-mixed window, since the mean
    of two int16 samples is a k/65536 that is usually not a k/32768 —
    downgrades the whole batch to float32. Exactness always wins over the
    2x byte saving; the first downgrade logs so the loss is visible.
    """
    pcm = np.rint(stack * np.float32(32768.0))
    if (
        pcm.min() >= -32768
        and pcm.max() <= 32767
        and np.array_equal(pcm * np.float32(1.0 / 32768.0), stack)
    ):
        return pcm.astype(np.int16)
    global _audio_transport_warned
    if not _audio_transport_warned:
        _audio_transport_warned = True
        import logging

        logging.getLogger(__name__).info(
            "device_targets: batch audio is not bit-exactly PCM16 "
            "(pairs mixing or non-PCM sources); shipping float32 audio "
            "(targets still ride the sparse transport)"
        )
    return stack


def _collate_device(items: List[Dict]) -> Batch:
    """Device-rasterized batch: int16 audio (when exact) + sparse targets.

    The dense (B, 172, 88/264) float32 target tensors dominate a dense
    batch's bytes (~480 KB/window) while carrying a few hundred nonzeros;
    shipping flat COO triples and rasterizing on the device in the train
    step (train/loop.materialize_batch) cuts host->device traffic ~4x.
    Exactness contract: the materialized batch equals `_collate`'s
    bit-for-bit (tests/test_torch_train.py).

    Items may carry dense ``targets`` (re-sparsified here) or the loader
    fast path's ``targets_coo`` (already window COO — just batched)."""
    if "targets_coo" in items[0]:
        targets = {
            k: _collate_coo_head(k, [it["targets_coo"][k] for it in items])
            for k in ("onset", "contour", "note")
        }
    else:
        targets = {
            k: _sparse_head(k, [it["targets"][k] for it in items])
            for k in ("onset", "contour", "note")
        }
    return {
        "audio": _audio_transport(np.stack([it["audio"] for it in items])),
        "targets_sparse": targets,
        "weights": {
            k: np.asarray([it["weights"][k] for it in items], np.float32)
            for k in ("onset", "contour", "note")
        },
    }


def _prefetch(iterator: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Background-thread prefetching (the AUTOTUNE analogue).

    Worker exceptions re-raise in the consumer — a bad source path or a
    corrupt record must surface as its real error, not as a silent
    end-of-stream."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
            q.put(exc)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def prepare_datasets(
    datasets_base_path: str,
    training_shuffle_buffer_size: int,
    batch_size: int,
    validation_steps: int,
    datasets_to_use: Sequence[str],
    dataset_sampling_frequency: Sequence[float],
    pairs: bool = False,
    seed: Optional[int] = None,
    device_targets: bool = False,
    num_shards: int = 1,
    shard_index: int = 0,
    parse_workers: int = 1,
    collate_workers: int = 1,
) -> tuple:
    """(infinite train iterator, infinite cached validation iterator) —
    the reference's `prepare_datasets` contract (`:42-108`).

    device_targets=True ships sparse-COO targets + int16 audio for in-graph
    rasterization (see `_collate_device`).

    Multi-process training: pass the process count as ``num_shards`` and
    the process index as ``shard_index``; ``batch_size`` stays the GLOBAL
    batch size — each process reads only its disjoint file partition and
    yields batches of ``batch_size / num_shards`` items (the train CLI
    passes them with ``--num-processes`` / ``--process-id``).
    Validation stays unsharded and host-global (identical cached batches
    on every host) so the early-stop/LR-plateau decisions agree across
    processes."""
    import itertools

    from basic_pitch_torch.utils import hostmem

    # collate/stack/pack allocate tens of MB per batch; without this the
    # deployment microVM re-faults every page at ~100 MB/s (utils/hostmem)
    hostmem.tune_host_allocator()

    if num_shards > 1 and batch_size % num_shards:
        raise ValueError(
            f"global batch {batch_size} does not divide across {num_shards} hosts"
        )
    train_batch_size = batch_size // num_shards if num_shards > 1 else batch_size

    def train_epochs() -> Iterator[Dict]:
        epoch = 0
        while True:
            yield from example_stream(
                "train",
                datasets_base_path,
                datasets_to_use,
                dataset_sampling_frequency,
                pairs=pairs,
                seed=None if seed is None else seed + epoch,
                num_shards=num_shards,
                shard_index=shard_index,
                parse_workers=parse_workers,
                coo=device_targets and not pairs,
            )
            epoch += 1

    rng = random.Random(seed)
    train_stream: Iterator[Dict] = train_epochs()
    if training_shuffle_buffer_size > 0:
        train_stream = _shuffled(train_stream, training_shuffle_buffer_size, rng)
    train_iter = _prefetch(
        _batched(train_stream, train_batch_size, device_targets, collate_workers)
    )

    # validation: materialize `validation_steps` batches once, cycle forever
    def val_batches():
        cached: List[Batch] = []
        source = _batched(_cycle_stream(), batch_size, device_targets)
        for _ in range(validation_steps):
            cached.append(next(source))
        return cached

    def _cycle_stream():
        while True:
            yield from example_stream(
                "validation", datasets_base_path, datasets_to_use,
                dataset_sampling_frequency, coo=device_targets,
            )

    val_iter = itertools.cycle(val_batches())
    return train_iter, val_iter
