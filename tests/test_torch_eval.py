"""PyTorch port: note-F1 evaluation (`basic_pitch_torch/utils/eval.py`) and
the ``basic-pitch-torch-eval`` CLI, held against the JAX package's
`utils/eval.py` and ``basic-pitch-eval`` on the same inputs.

The CLI cases are those of `tests/test_eval_cli.py`: each runs through both
CLIs, and the port's JSON report must equal the JAX report. Transcribe
mode runs on a WAV that the port's `utils/midi` synthesizes (the JAX test's
vocadito clip is not in the repository), on the CPU, with the port's
transcription compared to the JAX package's by the one-flip rule.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch_port_helpers import assert_events_agree, one_torch_thread  # noqa: F401

from basic_pitch_torch.cli import eval as t_eval_cli
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_torch.utils import eval as t_eval
from basic_pitch_torch.utils import midi as t_midi
from basic_pitch_tpu.cli import eval as j_eval_cli
from basic_pitch_tpu.utils import eval as j_eval

NOTES = [
    (0.50, 1.00, 60),
    (1.20, 1.70, 64),
    (2.00, 2.60, 67),
    (3.10, 3.50, 72),
]


def write_midi(path: pathlib.Path, notes) -> None:
    inst = t_midi.Instrument(program=4)
    for start, end, pitch in notes:
        inst.notes.append(t_midi.Note(start=start, end=end, pitch=pitch, velocity=90))
    mf = t_midi.MidiFile()
    mf.instruments.append(inst)
    mf.write(path)


def write_csv(path: pathlib.Path, notes) -> None:
    lines = ["start_time_s,end_time_s,pitch_midi,velocity,pitch_bend"]
    lines += [f"{s},{e},{p},90" for s, e, p in notes]
    path.write_text("\n".join(lines) + "\n")


def write_jams(path: pathlib.Path, notes) -> None:
    data = [
        {"time": s, "duration": e - s, "value": float(p), "confidence": 1.0}
        for s, e, p in notes
    ]
    jam = {"annotations": [{"namespace": "note_midi", "data": data}]}
    path.write_text(json.dumps(jam))


def run(args, device="cpu"):
    return t_eval_cli.main([str(a) for a in args] + ["--device", device])


def reports(tmp_path, args, capsys):
    """Both CLIs on the same inputs: (port report, JAX report, port stdout,
    JAX stdout)."""
    t_json, j_json = tmp_path / "torch.json", tmp_path / "jax.json"
    assert run([*args, "--json", t_json]) == 0
    t_out = capsys.readouterr().out
    assert j_eval_cli.main([str(a) for a in args] + ["--json", str(j_json)]) == 0
    j_out = capsys.readouterr().out
    return json.loads(t_json.read_text()), json.loads(j_json.read_text()), t_out, j_out


# --- utils/eval against JAX ---------------------------------------------------


def random_notes(rng: np.random.RandomState, n: int):
    starts = np.sort(rng.uniform(0.0, 10.0, n))
    return [(float(s), float(s + rng.uniform(0.05, 1.0)), int(rng.randint(50, 60))) for s in starts]


def jitter(rng: np.random.RandomState, notes):
    """An estimate near ``notes``: onsets and offsets moved by up to 80 ms,
    some pitches off by a semitone, some notes dropped, some added."""
    out = []
    for s, e, p in notes:
        if rng.rand() < 0.15:
            continue
        d = rng.uniform(-0.08, 0.08)
        out.append((s + d, e + rng.uniform(-0.3, 0.3) * (e - s), p + int(rng.rand() < 0.1)))
    return out + random_notes(rng, rng.randint(0, 5))


@pytest.mark.parametrize("offset_ratio", [None, 0.2])
@pytest.mark.parametrize("seed", range(6))
def test_match_notes_and_scores_equal_jax(seed, offset_ratio):
    rng = np.random.RandomState(seed)
    ref = random_notes(rng, 10 + 10 * seed)
    est = jitter(rng, ref)
    kw = {} if offset_ratio is None else {"offset_ratio": offset_ratio}
    assert t_eval.match_notes(ref, est, **kw) == j_eval.match_notes(ref, est, **kw)
    got = t_eval.precision_recall_f1(ref, est, **kw)
    assert got == j_eval.precision_recall_f1(ref, est, **kw)
    if offset_ratio is None:
        assert got["n_matched"] > 0


def test_events_to_notes_equal_jax():
    events = [(0.1, 0.5, 60, 0.8, None), (np.float32(1.25), np.float64(2.0), np.int64(64), 0.3, [1, 2])]
    assert t_eval.events_to_notes(events) == j_eval.events_to_notes(events)


def test_eval_f1():
    """A copy of `tests/test_train.py::test_eval_f1` on the port."""
    ref = [(0.0, 1.0, 60), (1.0, 2.0, 64), (2.0, 3.0, 67)]
    est = [(0.01, 1.1, 60), (1.04, 2.2, 64), (2.5, 3.0, 67)]  # last onset too late
    m = t_eval.precision_recall_f1(ref, est)
    assert m["n_matched"] == 2
    assert m["precision"] == pytest.approx(2 / 3)
    assert m["recall"] == pytest.approx(2 / 3)
    # pitch off by a semitone -> no match
    m2 = t_eval.precision_recall_f1([(0.0, 1.0, 60)], [(0.0, 1.0, 61)])
    assert m2["n_matched"] == 0
    # offset criterion
    m3 = t_eval.precision_recall_f1([(0.0, 1.0, 60)], [(0.0, 1.6, 60)], offset_ratio=0.2)
    assert m3["n_matched"] == 0
    m4 = t_eval.precision_recall_f1([(0.0, 1.0, 60)], [(0.0, 1.1, 60)], offset_ratio=0.2)
    assert m4["n_matched"] == 1
    # empty edge cases
    assert t_eval.precision_recall_f1([], [])["f1"] == 0.0


def test_profiling_timers():
    """A copy of `tests/test_train.py::test_profiling_timers` on the port."""
    from basic_pitch_torch.utils.profiling import Timers

    timers = Timers()
    with timers("a"):
        pass
    with timers("a"):
        pass
    with timers("b"):
        pass
    rows = {name: count for name, _, count in timers.summary()}
    assert rows == {"a": 2, "b": 1}
    assert "a" in timers.report()


# --- the CLI cases of tests/test_eval_cli.py, port against JAX ----------------


def test_identical_midi_scores_one(tmp_path, capsys):
    est, ref = tmp_path / "est.mid", tmp_path / "ref.mid"
    write_midi(est, NOTES)
    write_midi(ref, NOTES)
    got, want, t_out, j_out = reports(tmp_path, [est, ref], capsys)
    assert got == want
    assert "F1 1.0000" in t_out
    assert t_out.splitlines()[:2] == j_out.splitlines()[:2]


@pytest.mark.parametrize("ref_writer, suffix", [(write_midi, ".mid"), (write_csv, ".csv"), (write_jams, ".jams")])
@pytest.mark.parametrize("est_writer, est_suffix", [(write_midi, ".mid"), (write_csv, ".csv"), (write_jams, ".jams")])
def test_reference_formats(tmp_path, capsys, ref_writer, suffix, est_writer, est_suffix):
    est, ref = tmp_path / ("est" + est_suffix), tmp_path / ("ref" + suffix)
    est_writer(est, NOTES[:3] + [(5.0, 5.4, 80)])
    ref_writer(ref, NOTES)
    got, want, _, _ = reports(tmp_path, [est, ref], capsys)
    assert got == want
    assert got["aggregate"]["onset"]["n_matched"] == 3


def test_partial_match_and_json_report(tmp_path, capsys):
    # estimate misses one note and adds a spurious one: P=R=3/4
    est_notes = NOTES[:3] + [(5.0, 5.4, 80)]
    est, ref = tmp_path / "est.mid", tmp_path / "ref.mid"
    write_midi(est, est_notes)
    write_midi(ref, NOTES)
    got, want, _, _ = reports(tmp_path, [est, ref], capsys)
    assert got == want
    onset = got["aggregate"]["onset"]
    assert onset["n_matched"] == 3
    assert onset["precision"] == pytest.approx(0.75)
    assert onset["recall"] == pytest.approx(0.75)
    assert onset["f1"] == pytest.approx(0.75)


def test_offset_criterion_is_stricter(tmp_path, capsys):
    est_notes = [(s, e + 2.0, p) for s, e, p in NOTES]
    est, ref = tmp_path / "est.mid", tmp_path / "ref.mid"
    write_midi(est, est_notes)
    write_midi(ref, NOTES)
    got, want, _, _ = reports(tmp_path, [est, ref, "--offset-ratio", "0.3", "--onset-tolerance", "0.04"], capsys)
    assert got == want
    assert got["aggregate"]["onset"]["f1"] == pytest.approx(1.0)
    assert got["aggregate"]["onset_offset"]["f1"] == 0.0
    assert got["criteria"]["offset_ratio"] == 0.3


def test_directory_mode_micro_average(tmp_path, capsys):
    est_dir, ref_dir = tmp_path / "est", tmp_path / "ref"
    est_dir.mkdir()
    ref_dir.mkdir()
    write_midi(est_dir / "a_basic_pitch.mid", NOTES)
    write_midi(ref_dir / "a.mid", NOTES)
    write_midi(est_dir / "b_basic_pitch.mid", NOTES[:2])
    write_jams(ref_dir / "b.jams", NOTES)
    write_csv(est_dir / "c.csv", NOTES[1:])
    write_csv(ref_dir / "c.csv", NOTES)
    write_midi(est_dir / "orphan.mid", NOTES)  # no reference -> warned, skipped
    t_json, j_json = tmp_path / "torch.json", tmp_path / "jax.json"
    assert run([est_dir, ref_dir, "--json", t_json]) == 0
    captured = capsys.readouterr()
    assert "no reference for 1 file(s)" in captured.err
    assert j_eval_cli.main([str(est_dir), str(ref_dir), "--json", str(j_json)]) == 0
    j_captured = capsys.readouterr()
    got, want = json.loads(t_json.read_text()), json.loads(j_json.read_text())
    assert got == want
    assert captured.out.splitlines()[-3:-1] == j_captured.out.splitlines()[-3:-1]
    onset = got["aggregate"]["onset"]
    assert (onset["n_matched"], onset["n_reference"], onset["n_estimated"]) == (9, 12, 9)
    assert len(got["per_file"]) == 3


def test_error_paths(tmp_path, capsys):
    est, ref = tmp_path / "est.mid", tmp_path / "ref.mid"
    write_midi(est, NOTES)
    assert run([est, tmp_path / "missing.mid"]) == 2
    write_midi(ref, NOTES)
    assert run([est, tmp_path]) == 2  # file vs directory mismatch
    empty_a, empty_b = tmp_path / "ea", tmp_path / "eb"
    empty_a.mkdir()
    empty_b.mkdir()
    assert run([empty_a, empty_b]) == 2  # no pairs
    bad = tmp_path / "bad.txt"
    bad.write_text("nope")
    with pytest.raises(ValueError, match="unsupported input type"):
        run([bad, ref])
    wav = tmp_path / "ref.wav"
    wav.write_bytes(b"RIFF")
    with pytest.raises(ValueError, match="estimated side"):
        run([est, wav])
    bad_csv = tmp_path / "bad.csv"
    bad_csv.write_text("a,b,c\n")
    with pytest.raises(ValueError, match="note-events CSV"):
        run([bad_csv, ref])


def test_default_device_needs_a_gpu(tmp_path, monkeypatch):
    """The CLI runs on the card by default: with no GPU it raises unless
    given ``--device cpu``."""
    est, ref = tmp_path / "est.mid", tmp_path / "ref.mid"
    write_midi(est, NOTES)
    write_midi(ref, NOTES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_eval_cli.main([str(est), str(ref)])
    assert t_eval_cli.main([str(est), str(ref), "--device", "cpu"]) == 0


# --- transcribe mode on a synthesized WAV ------------------------------------


@pytest.fixture(scope="module")
def synthesized(tmp_path_factory):
    """A 4.5 s WAV the port's MIDI synthesizer renders from NOTES (over a
    seeded noise floor), its ground-truth MIDI, and the port's transcription
    of it on the CPU written as MIDI."""
    from basic_pitch_torch import inference
    from basic_pitch_torch.decode import export

    d = tmp_path_factory.mktemp("synth")
    truth = d / "truth.mid"
    write_midi(truth, NOTES)
    audio = t_midi.read_midi(truth).synthesize(sample_rate=22050, amplitude=0.3)
    n = int(4.5 * 22050)
    audio = np.pad(audio, (0, max(0, n - len(audio))))[:n]
    audio = audio + 0.01 * np.random.RandomState(0).randn(n)
    wav = d / "synth.wav"
    t_audio.write_wav(wav, audio, 22050)
    _, _, events = inference.predict(str(wav), device="cpu")
    transcribed = d / "synth_transcribed.mid"
    export.note_events_to_midi(events).write(transcribed)
    return wav, truth, transcribed, events


def test_transcribe_mode_self_consistency(synthesized, capsys):
    """Audio estimated side: the port transcribes the WAV and scores it
    against the MIDI written from its own transcription: F1 = 1."""
    wav, _, transcribed, events = synthesized
    assert events
    assert run([wav, transcribed]) == 0
    out = capsys.readouterr().out
    assert "score (onset+pitch):        P 1.0000  R 1.0000  F1 1.0000" in out


def test_transcribe_mode_matches_jax(synthesized, tmp_path, capsys):
    """The port's transcription of the WAV scored against the ground truth
    equals the JAX package's score, or differs by the one-flip rule (one
    threshold crossing may move one note)."""
    from basic_pitch_tpu import inference as j_inference

    wav, truth, _, events = synthesized
    _, _, j_events = j_inference.predict(str(wav))
    assert_events_agree(events, j_events)
    got, want, _, _ = reports(tmp_path, [wav, truth], capsys)
    for crit in ("onset", "onset_offset"):
        g, w = got["aggregate"][crit], want["aggregate"][crit]
        if sorted(t_eval.events_to_notes(events)) == sorted(j_eval.events_to_notes(j_events)):
            assert g == w
        assert g["n_reference"] == w["n_reference"] == len(NOTES)
        assert abs(g["n_matched"] - w["n_matched"]) <= 1
        assert abs(g["n_estimated"] - w["n_estimated"]) <= 1
    assert got["aggregate"]["onset"]["recall"] >= 0.75
