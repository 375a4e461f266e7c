"""PyTorch port, the training-data loader (`basic_pitch_torch/data`)
against the JAX package's on the same synthetic corpus.

For one directory and one seed, the port's loader yields batches bit-equal
to the JAX loader's: with and without ``device_targets``, with one and two
parse workers, for the train stream and the cached validation batches. The
corpus is written with the port's `serialization` and `TFRecordWriter`, and
the JAX writer gives the same bytes.
"""

import io

import numpy as np
import pytest

from basic_pitch_torch.data import loader as t_loader
from basic_pitch_torch.data import serialization as t_ser
from basic_pitch_torch.data import tfrecord as t_tfrecord
from basic_pitch_tpu.data import loader as j_loader
from basic_pitch_tpu.data import serialization as j_ser
from basic_pitch_tpu.data import tfrecord as j_tfrecord
from torch_train_data import annotations, tone_track, write_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("corpus")
    write_corpus(base, "GuitarSet", n_train=3, n_validation=2, seconds=4.0, seed=1)
    write_corpus(base, "MAESTRO", n_train=2, n_validation=1, seconds=3.0, seed=2)
    return base


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _assert_batches_equal(a[key], b[key])
        else:
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("device_targets", [False, True])
@pytest.mark.parametrize("parse_workers", [1, 2])
def test_batches_bit_equal_to_jax(corpus, device_targets, parse_workers):
    kw = dict(
        datasets_base_path=str(corpus),
        training_shuffle_buffer_size=8,
        batch_size=3,
        validation_steps=2,
        datasets_to_use=["GuitarSet", "MAESTRO"],
        dataset_sampling_frequency=np.array([0.5, 0.5]),
        seed=4,
        device_targets=device_targets,
        parse_workers=parse_workers,
    )
    t_train, t_val = t_loader.prepare_datasets(**kw)
    j_train, j_val = j_loader.prepare_datasets(**kw)
    for _ in range(6):  # past one pass over the train files
        a, b = next(t_train), next(j_train)
        _assert_batches_equal(a, b)
        if device_targets:
            assert "targets_sparse" in a and a["audio"].dtype == np.int16
    for _ in range(3):
        _assert_batches_equal(next(t_val), next(j_val))


def test_example_streams_equal_jax_with_pairs(corpus):
    kw = dict(datasets=["GuitarSet"], dataset_sampling_frequency=[1.0], seed=3)
    for pairs in (False, True):
        a = list(t_loader.example_stream("train", str(corpus), pairs=pairs, **kw))
        b = list(j_loader.example_stream("train", str(corpus), pairs=pairs, **kw))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            _assert_batches_equal(x, y)


def test_missing_dataset_raises(corpus):
    with pytest.raises(FileNotFoundError, match="iKala"):
        next(t_loader.example_stream("train", str(corpus), ["iKala"], [1.0]))


def test_corpus_records_equal_the_jax_writers_bytes(tmp_path):
    """The port's example encoder and TFRecord writer give the JAX
    package's bytes, and each package parses the other's record alike."""
    from basic_pitch_torch.utils import audio as audio_io

    y, notes = tone_track(2.0, seed=5)
    buf = io.BytesIO()
    audio_io.write_wav(buf, y, 22050)
    ann = annotations(notes, 172)
    kw = dict(
        notes_indices=ann["notes"][0], notes_values=ann["notes"][1],
        onsets_indices=ann["onsets"][0], onsets_values=ann["onsets"][1],
        contours_indices=ann["contours"][0], contours_values=ann["contours"][1],
        notes_onsets_shape=(172, 88), contours_shape=(172, 264),
    )
    records = [mod.to_transcription_example("t-0", "GuitarSet", buf.getvalue(), **kw) for mod in (t_ser, j_ser)]
    assert records[0] == records[1]
    for mod, path in ((t_tfrecord, tmp_path / "t.tfrecord"), (j_tfrecord, tmp_path / "j.tfrecord")):
        with mod.TFRecordWriter(path) as writer:
            writer.write(records[0])
    assert (tmp_path / "t.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()
    assert list(t_tfrecord.read_tfrecords(tmp_path / "j.tfrecord", verify=True)) == records[:1]
    a = t_ser.parse_transcription_example(records[0])
    b = j_ser.parse_transcription_example(records[0])
    np.testing.assert_array_equal(a.audio, b.audio)
    for head in ("notes", "onsets", "contours"):
        np.testing.assert_array_equal(getattr(a, head), getattr(b, head))
        assert a.head_shape(head) == b.head_shape(head)
