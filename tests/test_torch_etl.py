"""PyTorch port: the ETL (`basic_pitch_torch/data/{annotations,pipeline}.py`,
`data/datasets/*`, ``basic-pitch-torch-download``) held against the JAX
package's on the same synthetic corpora.

The corpora are those of `tests/test_etl.py` (sine WAVs at 44.1 kHz, MIDI
from the port's own writer, hand-rolled jams/pv/csv/yaml annotations). A
builder's records are bytes (a 22.05 kHz PCM16 WAV inside a serialized
example), so the port's records are compared byte for byte with the JAX
builder's, not after parsing; `pipeline.run`'s shards, ``index.csv``,
manifest and completion marker are compared with JAX's too.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401

from basic_pitch_torch import constants
from basic_pitch_torch.cli import download as t_download
from basic_pitch_torch.data import annotations, pipeline, serialization, tfrecord
from basic_pitch_torch.data.datasets import base, guitarset, ikala, maestro, medleydb_pitch, slakh
from basic_pitch_torch.utils import audio as audio_io
from basic_pitch_torch.utils import midi as midi_io
from basic_pitch_tpu.cli import download as j_download
from basic_pitch_tpu.data import annotations as j_annotations
from basic_pitch_tpu.data import pipeline as j_pipeline
from basic_pitch_tpu.data.datasets import guitarset as j_guitarset
from basic_pitch_tpu.data.datasets import ikala as j_ikala
from basic_pitch_tpu.data.datasets import maestro as j_maestro
from basic_pitch_tpu.data.datasets import medleydb_pitch as j_medleydb_pitch
from basic_pitch_tpu.data.datasets import slakh as j_slakh


def _sine_wav(path, seconds=3.0, freq=220.0, sr=44100, stereo=False, seed=0):
    """A sine over a seeded noise floor (so the resampler's rounding shows
    in every sample of the 22.05 kHz PCM16 the builders write)."""
    t = np.arange(int(seconds * sr)) / sr
    y = 0.4 * np.sin(2 * np.pi * freq * t) + 0.02 * np.random.RandomState(seed).randn(len(t))
    y = y.astype(np.float32)
    audio_io.write_wav(path, np.stack([y, 0.5 * y], 1) if stereo else y, sr)


def _two_note_midi(path):
    m = midi_io.MidiFile(tempo=120)
    inst = midi_io.Instrument()
    inst.notes.append(midi_io.Note(0.25, 1.0, 60, 100))
    inst.notes.append(midi_io.Note(1.25, 2.0, 64, 90))
    m.instruments.append(inst)
    m.write(path)


def _jams(path, notes, contours):
    jam = {
        "annotations": [
            {
                "namespace": "note_midi",
                "data": [
                    {"time": s, "duration": e - s, "value": midi, "confidence": None}
                    for s, e, midi in notes
                ],
            },
            {
                "namespace": "pitch_contour",
                "data": [
                    {"time": t, "duration": 0.0, "value": {"frequency": f, "index": 0, "voiced": f > 0}}
                    for t, f in contours
                ],
            },
        ]
    }
    path.write_text(json.dumps(jam))


# --- synthetic corpora, one per builder ---------------------------------------


def guitarset_corpus(root: pathlib.Path, n: int = 3, seconds: float = 3.0) -> None:
    (root / "audio_mono-mic").mkdir(parents=True)
    (root / "annotation").mkdir()
    for i in range(n):
        tid = f"0{i}_Rock{i}"
        _sine_wav(root / "audio_mono-mic" / f"{tid}_mic.wav", seconds=seconds, freq=220.0 * (1 + i / 4), seed=i)
        _jams(
            root / "annotation" / f"{tid}.jams",
            notes=[(0.5, 1.5, 57.0 + i), (1.6, 2.4, 60.0 + i)],
            contours=[(0.5, 261.6), (0.6, 262.0), (0.7, 0.0)] + [(t / 50, 220.0 * (1 + i / 4)) for t in range(40, 120)],
        )
    # a track without its annotation: filtered out
    _sine_wav(root / "audio_mono-mic" / "09_Orphan_mic.wav", seconds=1.0)


def maestro_corpus(root: pathlib.Path) -> None:
    (root / "2020").mkdir(parents=True)
    _sine_wav(root / "2020" / "perf.wav", seconds=3.0)
    _two_note_midi(root / "2020" / "perf.midi")
    _sine_wav(root / "2020" / "perf2.wav", seconds=2.5, freq=330.0, seed=1)
    _two_note_midi(root / "2020" / "perf2.midi")
    index = [
        {"midi_filename": "2020/perf.midi", "audio_filename": "2020/perf.wav", "split": "train", "duration": 3.0},
        {"midi_filename": "2020/perf2.midi", "audio_filename": "2020/perf2.wav", "split": "validation", "duration": 2.5},
        {"midi_filename": "2020/long.midi", "audio_filename": "2020/long.wav", "split": "train", "duration": 1000.0},
    ]
    (root / "maestro-v2.0.0.json").write_text(json.dumps(index))


def slakh_corpus(root: pathlib.Path) -> None:
    import yaml

    for split, track in (("train", "Track00001"), ("validation", "Track00002")):
        d = root / split / track
        (d / "stems").mkdir(parents=True)
        (d / "MIDI").mkdir()
        for stem in ("S00", "S01"):
            _sine_wav(d / "stems" / f"{stem}.wav", seed=int(track[-1]))
            _two_note_midi(d / "MIDI" / f"{stem}.mid")
        (d / "metadata.yaml").write_text(
            yaml.safe_dump({"stems": {"S00": {"is_drum": False}, "S01": {"is_drum": True}}})
        )


def ikala_corpus(root: pathlib.Path) -> None:
    (root / "Wavfile").mkdir(parents=True)
    (root / "PitchLabel").mkdir()
    (root / "notes_pyin").mkdir()
    for i, tid in enumerate(("10001_chorus", "10002_verse")):
        _sine_wav(root / "Wavfile" / f"{tid}.wav", stereo=True, seed=i)
        pv = "\n".join(["0.0"] * 10 + [f"{69.0 + i}"] * 20 + ["0.0"] * 10)
        (root / "PitchLabel" / f"{tid}.pv").write_text(pv)
    (root / "notes_pyin" / "10002_verse.csv").write_text("start,duration,midi\n0.3,0.6,70\n1.0,0.5,72\n")


def medleydb_corpus(root: pathlib.Path) -> None:
    (root / "audio").mkdir(parents=True)
    (root / "pitch").mkdir()
    (root / "notes_pyin").mkdir()
    for i, tid in enumerate(("Flute1", "Voice2")):
        _sine_wav(root / "audio" / f"{tid}.wav", freq=440.0, seed=i)
        (root / "pitch" / f"{tid}.csv").write_text("\n".join(f"{t/100:.3f},{440.0 * (1 + i)}" for t in range(50)))
    (root / "notes_pyin" / "Voice2.csv").write_text("0.1,0.4,81\n")


BUILDERS = {
    "guitarset": (guitarset_corpus, guitarset.GuitarSetBuilder, j_guitarset.GuitarSetBuilder),
    "maestro": (maestro_corpus, maestro.MaestroBuilder, j_maestro.MaestroBuilder),
    "slakh": (slakh_corpus, slakh.SlakhBuilder, j_slakh.SlakhBuilder),
    "ikala": (ikala_corpus, ikala.IkalaBuilder, j_ikala.IkalaBuilder),
    "medleydb_pitch": (medleydb_corpus, medleydb_pitch.MedleyDBPitchBuilder, j_medleydb_pitch.MedleyDBPitchBuilder),
}


def _input_data(name, builder):
    if name in ("maestro", "slakh"):
        return builder.input_data()
    if name == "ikala":
        return builder.input_data(0.5, seed=0)
    return pipeline.assign_percentage_splits(builder.track_ids(), 0.6, 0.3, seed=0)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_records_equal_jax_bytes(name, tmp_path):
    make, t_cls, j_cls = BUILDERS[name]
    make(tmp_path)
    t_builder, j_builder = t_cls(str(tmp_path)), j_cls(str(tmp_path))
    input_data = _input_data(name, t_builder)
    assert input_data == _input_data(name, j_builder)
    ids = [tid for tid, _ in input_data]
    assert [t_builder.filter_invalid(t) for t in ids] == [j_builder.filter_invalid(t) for t in ids]
    valid = [t for t in ids if t_builder.filter_invalid(t) is None]
    assert valid
    records = t_builder.to_examples(valid)
    assert records
    assert records == j_builder.to_examples(valid)  # bytes, not parsed values
    for record in records:
        parsed = serialization.parse_transcription_example(record)
        assert parsed.source == name
        assert parsed.contours.sum() > 0


# --- the builder cases of tests/test_etl.py on the port ----------------------


def test_notes_to_sparse_basic():
    grid = annotations.time_grid_for_duration(2.0)
    idx, vals = annotations.notes_to_sparse(
        np.array([[0.5, 1.0]]), np.array([440.0]), grid, constants.FREQ_BINS_NOTES
    )
    frames = [i[0] for i in idx]
    assert {i[1] for i in idx} == {48}
    fps = constants.ANNOTATIONS_FPS
    assert min(frames) == int(np.ceil(0.5 * fps))
    assert max(frames) == int(np.ceil(1.0 * fps)) - 1
    assert all(v == 1.0 for v in vals)


def test_notes_to_sparse_onsets_only():
    grid = annotations.time_grid_for_duration(2.0)
    idx, _ = annotations.notes_to_sparse(
        np.array([[0.5, 1.0]]), np.array([440.0]), grid, constants.FREQ_BINS_NOTES,
        onsets_only=True,
    )
    assert len(idx) == 1


def test_f0_to_sparse_drops_unvoiced():
    grid = annotations.time_grid_for_duration(1.0)
    idx, _ = annotations.f0_to_sparse(np.array([0.1, 0.2, 0.3]), np.array([440.0, 0.0, 880.0]), grid,
                                      constants.FREQ_BINS_CONTOURS)
    assert len(idx) == 2
    assert {i[1] for i in idx} == {144, 180}


def test_hz_to_bin_out_of_range():
    bins = annotations.hz_to_bin(np.array([1.0, 27.5, 50000.0]), constants.FREQ_BINS_NOTES)
    assert bins[0] == -1 and bins[1] == 0 and bins[2] == -1


@pytest.mark.parametrize("seed", range(4))
def test_annotations_equal_jax(seed):
    rng = np.random.RandomState(seed)
    duration = float(rng.uniform(2.0, 8.0))
    grid = annotations.time_grid_for_duration(duration)
    np.testing.assert_array_equal(grid, j_annotations.time_grid_for_duration(duration))
    starts = rng.uniform(-0.2, duration, 20)
    intervals = np.stack([starts, starts + rng.uniform(0.0, 1.5, 20)], 1)
    pitches = 440.0 * 2 ** ((rng.uniform(10, 120, 20) - 69) / 12)
    amps = rng.rand(20)
    for grid_hz in (constants.FREQ_BINS_NOTES, constants.FREQ_BINS_CONTOURS):
        np.testing.assert_array_equal(annotations.hz_to_bin(pitches, grid_hz), j_annotations.hz_to_bin(pitches, grid_hz))
        for onsets_only in (False, True):
            assert annotations.notes_to_sparse(intervals, pitches, grid, grid_hz, amps, onsets_only) == \
                j_annotations.notes_to_sparse(intervals, pitches, grid, grid_hz, amps, onsets_only)
    times = np.sort(rng.uniform(0, duration + 0.5, 200))
    freqs = np.where(rng.rand(200) < 0.2, 0.0, 100 + 900 * rng.rand(200))
    conf = rng.rand(200)
    assert annotations.f0_to_sparse(times, freqs, grid, constants.FREQ_BINS_CONTOURS, conf) == \
        j_annotations.f0_to_sparse(times, freqs, grid, constants.FREQ_BINS_CONTOURS, conf)


def test_guitarset_builder(tmp_path):
    guitarset_corpus(tmp_path, n=1)
    builder = guitarset.GuitarSetBuilder(str(tmp_path))
    assert builder.track_ids() == ["00_Rock0", "09_Orphan"]
    assert builder.filter_invalid("00_Rock0") is None
    assert builder.filter_invalid("09_Orphan") == "missing annotation"
    parsed = serialization.parse_transcription_example(builder.to_examples(["00_Rock0"])[0])
    assert parsed.source == "guitarset"
    assert parsed.notes.shape[1] == 88 and parsed.notes.sum() > 0
    assert parsed.onsets.sum() == 2.0
    assert parsed.contours.shape[1] == 264 and parsed.contours.sum() > 2.0


def test_maestro_builder(tmp_path):
    maestro_corpus(tmp_path)
    builder = maestro.MaestroBuilder(str(tmp_path))
    assert builder.filter_invalid("perf") is None
    assert builder.filter_invalid("long") == "longer than 15 minutes"
    parsed = serialization.parse_transcription_example(builder.to_examples(["perf"])[0])
    assert parsed.notes.sum() > 0 and parsed.contours.sum() > 0
    assert parsed.onsets.sum() == pytest.approx(100 / 127 + 90 / 127, abs=1e-5)  # velocity-scaled


def test_slakh_builder(tmp_path):
    slakh_corpus(tmp_path)
    builder = slakh.SlakhBuilder(str(tmp_path))
    assert dict(builder.input_data()) == {
        "Track00001-S00": "train", "Track00001-S01": "train",
        "Track00002-S00": "validation", "Track00002-S01": "validation",
    }
    assert builder.filter_invalid("Track00001-S00") is None
    assert builder.filter_invalid("Track00001-S01") == "drum stem"
    parsed = serialization.parse_transcription_example(builder.to_examples(["Track00001-S00"])[0])
    assert parsed.source == "slakh" and parsed.notes.sum() > 0


def test_ikala_builder(tmp_path):
    ikala_corpus(tmp_path)
    builder = ikala.IkalaBuilder(str(tmp_path))
    assert builder.filter_invalid("10001_chorus") is None
    assert {s for _, s in builder.input_data(train_percent=0.9, seed=1)} <= {"train", "validation"}
    no_notes, with_notes = (serialization.parse_transcription_example(r)
                            for r in builder.to_examples(["10001_chorus", "10002_verse"]))
    assert no_notes.notes.shape == (0, 0)  # no pyin notes -> empty with (0,0) shape
    assert no_notes.contours.sum() > 0
    assert with_notes.notes.sum() > 0


def test_medleydb_pitch_builder(tmp_path):
    medleydb_corpus(tmp_path)
    builder = medleydb_pitch.MedleyDBPitchBuilder(str(tmp_path))
    assert builder.filter_invalid("Flute1") is None
    parsed = serialization.parse_transcription_example(builder.to_examples(["Flute1"])[0])
    assert parsed.contours.sum() > 0


def test_slakh_split_ignores_source_prefix(tmp_path):
    root = tmp_path / "test" / "slakh2100"
    for split, track in (("train", "Track00001"), ("validation", "Track00002")):
        d = root / split / track
        d.mkdir(parents=True)
        (d / "metadata.yaml").write_text("stems:\n  S00:\n    is_drum: false\n")
    splits = dict(slakh.SlakhBuilder(str(root)).input_data())
    assert splits["Track00001-S00"] == "train"
    assert splits["Track00002-S00"] == "validation"


def test_ikala_split_honors_train_percent(tmp_path):
    wav_dir = tmp_path / "Wavfile"
    wav_dir.mkdir()
    for i in range(10):
        (wav_dir / f"{10000+i}_track.wav").write_bytes(b"")
    data = ikala.IkalaBuilder(str(tmp_path)).input_data(0.6, seed=0)
    counts = {}
    for _, split in data:
        counts[split] = counts.get(split, 0) + 1
    assert counts == {"train": 6, "validation": 4}
    assert data == j_ikala.IkalaBuilder(str(tmp_path)).input_data(0.6, seed=0)


def test_midi_to_hz_and_transcode_equal_jax(tmp_path):
    from basic_pitch_tpu.data.datasets import base as j_base

    np.testing.assert_array_equal(base.midi_to_hz([21, 60.5, 108]), j_base.midi_to_hz([21, 60.5, 108]))
    for sr, stereo in ((44100, False), (48000, True), (22050, False)):
        path = tmp_path / f"a{sr}.wav"
        _sine_wav(path, seconds=1.3, sr=sr, stereo=stereo)
        for channel in (None, 1):
            assert base.transcode_to_model_rate(path, channel) == j_base.transcode_to_model_rate(path, channel)


# --- the pipeline skeleton ----------------------------------------------------


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_assign_percentage_splits_equal_jax(seed):
    ids = [f"t{i}" for i in range(100)]
    data = pipeline.assign_percentage_splits(ids, 0.8, 0.1, seed=seed)
    counts = {}
    for _, split in data:
        counts[split] = counts.get(split, 0) + 1
    assert counts == {"train": 80, "validation": 10, "test": 10}
    if seed is not None:
        assert data == j_pipeline.assign_percentage_splits(ids, 0.8, 0.1, seed=seed)
    with pytest.raises(AssertionError):
        pipeline.assign_percentage_splits(["a"], 0.9, 0.2)


def test_task_of_equal_jax():
    ids = [f"track-{i:03d}" for i in range(200)]
    for n in (1, 2, 3, 7):
        assert [pipeline.task_of(t, n) for t in ids] == [j_pipeline.task_of(t, n) for t in ids]


def test_pipeline_run_filters_and_writes(tmp_path):
    def to_examples(ids):
        return [f"example-{i}".encode() for i in ids]

    def filter_invalid(track_id):
        return "bad" if track_id == "t-bad" else None

    out_dir = pipeline.run(
        "toy", [("t1", "train"), ("t-bad", "train"), ("t2", "validation")],
        to_examples, filter_invalid, str(tmp_path), timestamped=False,
    )
    train_files = list((out_dir / "splits" / "train").glob("*.tfrecord"))
    assert len(train_files) == 1
    assert list(tfrecord.read_tfrecords(train_files[0])) == [b"example-t1"]
    assert (out_dir / "index.csv").read_text().count("t-bad") == 0


def _toy_tracks(n=20):
    return [(f"track-{i:02d}", "train" if i % 3 else "validation") for i in range(n)]


def _toy_to_examples(ids):
    return [f"example-{i}".encode() for i in ids]


def _read_all(out_dir, split):
    records = []
    for path in sorted((out_dir / "splits" / split).glob("*.tfrecord")):
        records.extend(tfrecord.read_tfrecords(path))
    return records


def test_pipeline_tasks_are_disjoint_and_jointly_complete(tmp_path):
    input_data = _toy_tracks()
    single = pipeline.run("toy", input_data, _toy_to_examples, lambda t: None,
                          str(tmp_path / "single"), batch_size=3, timestamped=False)
    outs = [
        pipeline.run("toy", input_data, _toy_to_examples, lambda t: None, str(tmp_path / "sharded"),
                     batch_size=3, timestamped=False, num_tasks=2, task_index=task)
        for task in range(2)
    ]
    assert outs[0] == outs[1]
    out_dir = outs[0]
    assert pipeline.is_complete(out_dir, 2)
    assert not pipeline.is_complete(out_dir, 3)
    for split in ("train", "validation"):
        assert sorted(_read_all(out_dir, split)) == sorted(_read_all(single, split))
        assert list((out_dir / "splits" / split).glob("t000-*.tfrecord"))
        assert list((out_dir / "splits" / split).glob("t001-*.tfrecord"))
    assert len((out_dir / "index.csv").read_text().splitlines()) == len(input_data)
    ids = [t for t, _ in input_data]
    assert {t for t in ids if pipeline.task_of(t, 2) == 0} | {t for t in ids if pipeline.task_of(t, 2) == 1} == set(ids)


def test_pipeline_resume_skips_completed_shards(tmp_path):
    input_data = _toy_tracks(12)
    calls = []

    def counting_to_examples(ids):
        calls.append(list(ids))
        return _toy_to_examples(ids)

    class Boom(RuntimeError):
        pass

    def failing_to_examples(ids):
        if len(calls) >= 2:  # die after two shards
            raise Boom()
        return counting_to_examples(ids)

    dest = str(tmp_path / "resumable")
    with pytest.raises(Boom):
        pipeline.run("toy", input_data, failing_to_examples, lambda t: None, dest, batch_size=3, timestamped=False)
    assert len(calls) == 2
    out_dir = pipeline.run("toy", input_data, counting_to_examples, lambda t: None, dest, batch_size=3,
                           timestamped=False)
    total_shards = sum(-(-len([1 for _, s in input_data if s == split]) // 3) for split in ("train", "validation"))
    assert len(calls) - 2 == total_shards - 2
    assert pipeline.is_complete(out_dir, 1)
    fresh = pipeline.run("toy", input_data, _toy_to_examples, lambda t: None, str(tmp_path / "fresh"),
                         batch_size=3, timestamped=False)
    for split in ("train", "validation"):
        assert sorted(_read_all(out_dir, split)) == sorted(_read_all(fresh, split))


def test_pipeline_multitask_rejects_timestamped(tmp_path):
    with pytest.raises(ValueError, match="timestamped"):
        pipeline.run("toy", _toy_tracks(4), _toy_to_examples, lambda t: None, str(tmp_path),
                     num_tasks=2, task_index=0)
    with pytest.raises(ValueError, match="out of range"):
        pipeline.run("toy", _toy_tracks(4), _toy_to_examples, lambda t: None, str(tmp_path),
                     num_tasks=2, task_index=2, timestamped=False)


def test_timestamped_destination(tmp_path):
    out = pipeline.run("toy", _toy_tracks(3), _toy_to_examples, lambda t: None, str(tmp_path))
    assert out.name == "toy" and out.parent.parent == tmp_path and out.parent.name.isdigit()


def _tree(out_dir: pathlib.Path) -> dict:
    """Every file of a built dataset: name -> bytes, with the destination in
    manifest paths made relative (the two builds write to two places)."""
    files = {}
    for p in sorted(out_dir.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            if p.name.startswith("manifest-"):
                data = data.replace(str(out_dir).encode(), b"<out>")
            files[p.relative_to(out_dir).as_posix()] = data
    return files


@pytest.mark.parametrize("num_tasks, num_workers", [(1, 0), (2, 0), (1, 2)])
def test_pipeline_run_equals_jax(tmp_path, num_tasks, num_workers):
    """The port's `pipeline.run` over the GuitarSet builder writes the JAX
    pipeline's shards, ``index.csv``, manifests and completion markers."""
    guitarset_corpus(tmp_path / "corpus", n=5, seconds=1.5)
    source = str(tmp_path / "corpus")
    outs = {}
    for name, pipe, cls in (("torch", pipeline, guitarset.GuitarSetBuilder),
                            ("jax", j_pipeline, j_guitarset.GuitarSetBuilder)):
        builder = cls(source)
        input_data = pipe.assign_percentage_splits(builder.track_ids(), 0.5, 0.3, seed=3)
        for task in range(num_tasks):
            out = pipe.run("guitarset", input_data, builder.to_examples, builder.filter_invalid,
                           str(tmp_path / name), batch_size=2, num_workers=num_workers, timestamped=False,
                           num_tasks=num_tasks, task_index=task)
        outs[name] = _tree(out)
    assert outs["torch"] == outs["jax"]
    assert sum(name.endswith(".tfrecord") for name in outs["torch"]) >= 3
    assert len(outs["torch"]["index.csv"].splitlines()) == 5  # the orphan is dropped


def test_download_cli_equals_jax(tmp_path, monkeypatch):
    """``basic-pitch-torch-download guitarset`` against ``bp-download
    guitarset`` on one corpus: the same built tree."""
    guitarset_corpus(tmp_path / "corpus", n=3, seconds=1.5)
    common = ["guitarset", "--source", str(tmp_path / "corpus"), "--timestamped", "false", "--split-seed", "1",
              "--batch-size", "2"]
    t_download.main(common + ["--destination", str(tmp_path / "torch")])
    monkeypatch.setattr(sys, "argv", ["bp-download", *common, "--destination", str(tmp_path / "jax")])
    j_download.main()
    got, want = _tree(tmp_path / "torch" / "guitarset"), _tree(tmp_path / "jax" / "guitarset")
    assert got == want
    assert any(name.startswith("splits/train/") for name in got)


def test_built_dataset_feeds_loader(tmp_path):
    """End to end: builder -> pipeline.run -> the port's training loader."""
    from basic_pitch_torch.data import loader

    corpus = tmp_path / "corpus"
    (corpus / "audio_mono-mic").mkdir(parents=True)
    (corpus / "annotation").mkdir()
    for i in range(4):
        tid = f"0{i}_Funk1"
        _sine_wav(corpus / "audio_mono-mic" / f"{tid}_mic.wav", seconds=4.0)
        _jams(corpus / "annotation" / f"{tid}.jams", notes=[(0.2, 3.0, 57.0)],
              contours=[(t / 50, 220.0) for t in range(150)])
    builder = guitarset.GuitarSetBuilder(str(corpus))
    input_data = [(tid, "train" if i < 3 else "validation") for i, tid in enumerate(builder.track_ids())]
    dest = tmp_path / "out"
    pipeline.run("guitarset", input_data, builder.to_examples, builder.filter_invalid, str(dest), timestamped=False)
    item = next(loader.example_stream("train", str(dest), ["guitarset"], [1.0], seed=0))
    assert item["audio"].shape == (constants.AUDIO_N_SAMPLES,)
    assert item["weights"]["note"] == 1.0
    assert item["targets"]["note"].sum() > 0


def test_train_cli_reads_built_shards(tmp_path):
    """Shards that ``basic-pitch-torch-download guitarset`` builds train
    through ``basic-pitch-torch-train --guitarset`` as they are. The trainer
    names the dataset "GuitarSet" and the builder writes "guitarset": the
    JAX loader finds none of the built shards on a case-sensitive
    filesystem (a fault of the JAX package, which is not edited); the
    port's loader falls back to the builder's name."""
    from basic_pitch_torch.cli import train as t_train
    from basic_pitch_torch.data import loader as t_loader
    from basic_pitch_tpu.data import loader as j_loader

    guitarset_corpus(tmp_path / "corpus", n=3, seconds=3.0)
    built = tmp_path / "built"
    # a seeded split: the orphan track takes part in the random assignment
    # and is dropped after it, so an unseeded split leaves the validation
    # split empty whenever the orphan draws its one slot
    t_download.main(["guitarset", "--source", str(tmp_path / "corpus"), "--destination", str(built),
                     "--timestamped", "false", "--train-percent", "0.6", "--validation-percent", "0.3",
                     "--split-seed", "1"])
    assert list((built / "guitarset" / "splits" / "validation").glob("*.tfrecord"))
    shards = sorted(str(p) for p in (built / "guitarset" / "splits" / "train").glob("*.tfrecord"))
    assert shards
    assert j_loader._dataset_files(str(built), "GuitarSet", "train") == []
    assert t_loader._dataset_files(str(built), "GuitarSet", "train") == shards
    assert t_loader._dataset_files(str(built), "guitarset", "train") == shards
    run_dir = t_train.main(["--source", str(built), "--output", str(tmp_path / "out"), "--guitarset", "-e", "1",
                            "--steps-per-epoch", "1", "-v", "1", "-b", "2", "--size-evaluation-callback-datasets",
                            "0", "--parse-workers", "1", "--device", "cpu"])
    assert (run_dir / "checkpoints" / "model.00.npz").exists()
    assert (run_dir / "model.best.npz").exists()
