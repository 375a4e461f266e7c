"""``basic-pitch-torch-train`` command-line interface: train the NMP model.

The flags of `basic_pitch_tpu/cli/train.py` (the reference trainer's,
the reference's `basic_pitch/train.py:171-288`: per-dataset booleans from
DATASET_SAMPLING_FREQUENCY with normalized sampling weights), plus
``--device`` (``cuda`` by default; ``cpu`` only when asked for). Each
process trains on one device. With ``--num-processes N`` (N > 1), N
processes train data-parallel (`parallel/distributed.py`: NCCL on GPUs,
gloo on the CPU), each started with its ``--process-id`` and the same
``--coordinator host:port`` (or MASTER_ADDR / MASTER_PORT in the
environment); each reads its own part of the training files and a 1/N
slice of every global ``--batch-size``, and only process 0 writes
checkpoints and logs. A CUDA process takes the card of its LOCAL_RANK
(else its process id) modulo the cards it sees. ``--no-data-parallel``
changes nothing: the PyTorch idiom is one process per device, so there is
nothing to shard within a process.

Each run writes into ``<output>/<UTC timestamp>/``: ``model.best.npz``,
``checkpoints/model.NN.npz`` (the JAX package's flat layout) and
``train_state.pt``. A run whose output directory already holds a run with a
train state continues the newest such run instead of starting a new one, so
rerunning the command with a larger ``--epochs`` resumes.
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
from datetime import datetime, timezone
from typing import List, Optional

import numpy as np

from basic_pitch_torch import constants


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train the NMP transcription model with PyTorch on an NVIDIA GPU.")
    parser.add_argument("--source", required=True, help="directory containing <dataset>/splits/<split>/*.tfrecord")
    parser.add_argument("--output", required=True, help="directory for checkpoints and tensorboard logs")
    parser.add_argument("-e", "--epochs", type=int, default=500, help="number of training epochs")
    parser.add_argument("-b", "--batch-size", type=int, default=16, help="global batch size")
    parser.add_argument("-l", "--learning-rate", type=float, default=0.001, help="Adam learning rate")
    parser.add_argument("--steps-per-epoch", type=int, default=100, help="training batches per epoch")
    parser.add_argument("-v", "--validation-steps", type=int, default=10,
                        help="validation batches per validation run (positive integer)")
    parser.add_argument("-z", "--training-shuffle-buffer-size", type=int, default=100,
                        help="training dataset shuffle buffer size")
    parser.add_argument("--size-evaluation-callback-datasets", type=int, default=4,
                        help="number of examples used by the visualization callback (0 turns it off; "
                             "it needs tensorboardX)")
    for dataset in constants.DATASET_SAMPLING_FREQUENCY:
        parser.add_argument(
            f"--{dataset.lower()}",
            action="store_true",
            default=False,
            help=f"use the {dataset} dataset in training",
        )
    parser.add_argument("--no-sonify", action="store_true", help="exclude sonifications from tensorboard")
    parser.add_argument("--no-contours", action="store_true", help="train without supervising the contour head")
    parser.add_argument(
        "--trainable-cqt",
        action="store_true",
        help="learn the CQT filterbank alongside the convs (kernels stay L1-normalized per bin)",
    )
    parser.add_argument("--weighted-onset-loss", action="store_true",
                        help="use a class-balanced loss for onsets")
    parser.add_argument("--positive-onset-weight", type=float, default=0.5,
                        help="positive-class onset weight (with --weighted-onset-loss)")
    parser.add_argument("--no-device-targets", dest="device_targets", action="store_false",
                        help="ship dense float32 target tensors instead of the sparse-COO + int16 "
                             "batches rasterized on the device (identical training, more "
                             "host->device bytes)")
    parser.add_argument("--no-data-parallel", dest="data_parallel", action="store_false",
                        help="disable sharding the batch across devices (training runs on one device)")
    parser.add_argument("--coordinator", default="",
                        help="multi-process training: coordinator address host:port "
                             "(empty: MASTER_ADDR / MASTER_PORT from the environment)")
    parser.add_argument("--num-processes", type=int, default=1,
                        help="multi-process training: total number of processes")
    parser.add_argument("--process-id", type=int, default=0,
                        help="multi-process training: this process's id in [0, --num-processes)")
    parser.add_argument("--parse-workers", type=int, default=2,
                        help="loader record-parse threads (order-preserving; "
                             "deterministic for a fixed seed)")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="optimizer steps taken per loader group (stacked batches, one upload)")
    parser.add_argument("--train-precision", default="highest",
                        choices=("highest", "high", "default"),
                        help="numerics of the TRAINING step (evaluation and inference stay float32): "
                             "'highest' float32 with TF32 off, 'high' TF32 for cuBLAS and cuDNN, "
                             "'default' bf16 autocast of the matmuls and convs")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where training runs (default cuda; fails without a GPU)")
    return parser


def run_directory(output: str) -> pathlib.Path:
    """The newest run under ``output`` that holds a train state (to resume
    it), else a new ``<output>/<UTC timestamp>`` directory."""
    from basic_pitch_torch.train.loop import TRAIN_STATE_NAME

    runs = sorted(p.parent for p in pathlib.Path(output).glob(f"*/{TRAIN_STATE_NAME}"))
    if runs:
        return runs[-1]
    return pathlib.Path(output) / datetime.now(timezone.utc).strftime("%Y%m%d-%H%M")


def train(
    source: str,
    output: str,
    batch_size: int,
    shuffle_size: int,
    learning_rate: float,
    epochs: int,
    steps_per_epoch: int,
    validation_steps: int,
    size_evaluation_callback_datasets: int,
    datasets_to_use: List[str],
    dataset_sampling_frequency: np.ndarray,
    no_sonify: bool,
    no_contours: bool,
    weighted_onset_loss: bool,
    positive_onset_weight: float,
    trainable_cqt: bool = False,
    device_targets: bool = True,
    parse_workers: int = 2,
    steps_per_dispatch: int = 1,
    train_precision: str = "highest",
    device: str = "cuda",
    coordinator: str = "",
    num_processes: int = 1,
    process_id: int = 0,
) -> pathlib.Path:
    """Build datasets, model and callbacks, then run the fit loop on this
    process's device, data-parallel over ``num_processes`` processes when
    there are several. Returns the run directory."""
    from basic_pitch_torch.parallel import distributed
    from basic_pitch_torch.pipeline import resolve_device

    dev = resolve_device(device)  # before any work: no GPU and no --device cpu raises here
    if num_processes > 1:
        if batch_size % num_processes:  # not assert: survives -O
            raise ValueError(f"batch size {batch_size} must divide across {num_processes} processes")
        if steps_per_dispatch > 1:
            raise ValueError("--steps-per-dispatch is single-process (multi-process runs feed per-step batches)")
        if dev.type == "cuda":
            import torch

            local_rank = int(os.environ.get("LOCAL_RANK", process_id))
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        distributed.initialize(coordinator or None, num_processes, process_id, device=dev)
    try:
        from basic_pitch_torch.data import loader
        from basic_pitch_torch.models import nmp
        from basic_pitch_torch.train import loop as train_loop

        logging.info("source directory: %s", source)
        logging.info("output directory: %s", output)
        logging.info("device: %s (process %d of %d)", dev, process_id, num_processes)
        logging.info(
            "batch_size=%d shuffle_size=%d lr=%g epochs=%d steps/epoch=%d val_steps=%d",
            batch_size, shuffle_size, learning_rate, epochs, steps_per_epoch, validation_steps,
        )
        logging.info("datasets: %s, weights: %s", datasets_to_use, dataset_sampling_frequency)

        model_config = nmp.ModelConfig(no_contours=no_contours, trainable_cqt=trainable_cqt)
        train_iter, val_iter = loader.prepare_datasets(
            source,
            shuffle_size,
            batch_size,
            validation_steps,
            datasets_to_use,
            dataset_sampling_frequency,
            device_targets=device_targets,
            num_shards=num_processes,
            shard_index=process_id,
            parse_workers=parse_workers,
        )
        if steps_per_dispatch > 1:
            train_iter = train_loop.grouped_batches(train_iter, steps_per_dispatch)

        run_dir = run_directory(output)
        callbacks = []
        if size_evaluation_callback_datasets > 0 and process_id == 0:  # only process 0 logs
            from basic_pitch_torch.train.visualize import VisualizeCallback

            # restart the stream when a pass over the split completes, so the
            # callback keeps getting batches for the whole run
            def _cycling(split: str, seed: Optional[int] = None):
                while True:
                    empty = True
                    for item in loader.example_stream(
                        split, source, datasets_to_use, dataset_sampling_frequency,
                        n_samples_per_track=1, seed=seed,
                    ):
                        empty = False
                        yield item
                    if empty:
                        return  # empty split: don't spin forever

            viz_batch = min(size_evaluation_callback_datasets, 4)
            callbacks.append(
                VisualizeCallback(
                    loader._prefetch(loader._batched(_cycling("train", seed=0), viz_batch), 1),
                    loader._prefetch(loader._batched(_cycling("validation"), viz_batch), 1),
                    os.path.join(run_dir, "tensorboard"),
                    sonify=not no_sonify,
                    contours=not no_contours,
                )
            )

        config = train_loop.TrainConfig(
            learning_rate=learning_rate,
            precision=train_precision,
            weighted_onset_loss=weighted_onset_loss,
            positive_onset_weight=positive_onset_weight,
            steps_per_epoch=steps_per_epoch,
            validation_steps=validation_steps,
            epochs=epochs,
        )
        train_loop.fit(
            train_iter,
            val_iter,
            run_dir,
            config=config,
            model_config=model_config,
            callbacks=tuple(callbacks),
            log=logging.info,
            device=dev,
        )
        return run_dir
    finally:
        if num_processes > 1:
            distributed.shutdown()


def main(argv: Optional[List[str]] = None) -> pathlib.Path:
    parser = build_parser()
    args = parser.parse_args(argv)
    datasets_flagged = [
        dataset
        for dataset in constants.DATASET_SAMPLING_FREQUENCY
        if getattr(args, dataset.lower().replace("-", "_"))
    ]
    if not datasets_flagged:
        parser.error("select at least one dataset (e.g. --guitarset)")
    weights = np.array([constants.DATASET_SAMPLING_FREQUENCY[d] for d in datasets_flagged], np.float64)
    weights /= weights.sum()

    logging.basicConfig(level=logging.INFO)
    return train(
        args.source,
        args.output,
        args.batch_size,
        args.training_shuffle_buffer_size,
        args.learning_rate,
        args.epochs,
        args.steps_per_epoch,
        args.validation_steps,
        args.size_evaluation_callback_datasets,
        datasets_flagged,
        weights,
        args.no_sonify,
        args.no_contours,
        args.weighted_onset_loss,
        args.positive_onset_weight,
        args.trainable_cqt,
        args.device_targets,
        args.parse_workers,
        args.steps_per_dispatch,
        args.train_precision,
        args.device,
        args.coordinator,
        args.num_processes,
        args.process_id,
    )


if __name__ == "__main__":
    main()
