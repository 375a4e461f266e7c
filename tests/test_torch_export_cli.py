"""PyTorch port: `basic-pitch-torch-export` and the predict CLI's
`--model-serialization`, on the CPU.

The export CLI writes, re-imports and verifies each format, and behaves as
the JAX package's without tensorflow: formats not named skip the TF formats
with its message, a TF format named exits 2. The predict CLI, told
`--model-serialization onnx` with `BASIC_PITCH_SAVED_MODELS` pointed at an
exported nmp.onnx, transcribes as the npz checkpoint does (the one-flip
rule).
"""

import csv
import sys

import pytest
import torch

from basic_pitch_torch.cli import export as export_cli
from basic_pitch_torch.cli import predict as predict_cli
from basic_pitch_torch.models import onnx_export
from basic_pitch_torch.models import params as t_params
from basic_pitch_torch.utils import audio as audio_io
from torch_port_helpers import SR, assert_events_agree, one_torch_thread, tone_mix  # noqa: F401

SKIP_MESSAGE = "savedmodel/tflite export needs tensorflow; skipping {} (onnx export is runtime-free)"


def test_writes_and_verifies_onnx(tmp_path, capsys):
    assert export_cli.main([str(tmp_path), "--format", "onnx", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "onnx: round-trip max deviation" in out and f"wrote {tmp_path / 'nmp.onnx'}" in out
    onnx_export.export_onnx(t_params.load_flat(), tmp_path / "direct.onnx")
    assert (tmp_path / "nmp.onnx").read_bytes() == (tmp_path / "direct.onnx").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["direct.onnx", "nmp.onnx"]


def test_writes_every_format_with_tensorflow(tmp_path, capsys):
    pytest.importorskip("tensorflow")
    assert export_cli.main([str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for label in ("onnx", "savedmodel", "tflite"):
        assert f"{label}: round-trip max deviation" in out
    assert (tmp_path / "nmp.onnx").is_file()
    assert (tmp_path / "nmp" / "saved_model.pb").is_file()
    assert (tmp_path / "nmp.tflite").is_file()


def test_checkpoint_in_any_format(tmp_path):
    """--checkpoint takes what `Model` sniffs: an exported ONNX file goes
    out again as ONNX and verifies against itself."""
    first, second = tmp_path / "a", tmp_path / "b"
    assert export_cli.main([str(first), "--format", "onnx", "--device", "cpu"]) == 0
    assert export_cli.main([str(second), "--checkpoint", str(first / "nmp.onnx"), "--format", "onnx", "--device", "cpu"]) == 0
    assert (second / "nmp.onnx").is_file()


@pytest.fixture
def no_tensorflow(monkeypatch):
    """`import tensorflow` fails, as on a machine without it."""
    import basic_pitch_torch.models

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.delitem(sys.modules, "basic_pitch_torch.models.tf_export", raising=False)
    monkeypatch.delattr(basic_pitch_torch.models, "tf_export", raising=False)


@pytest.mark.parametrize("fmt", ["savedmodel", "tflite"])
def test_named_tf_format_without_tensorflow_exits_2(tmp_path, capsys, no_tensorflow, fmt):
    assert export_cli.main([str(tmp_path), "--format", fmt, "--device", "cpu"]) == 2
    assert SKIP_MESSAGE.format([fmt]) in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []


def test_default_formats_without_tensorflow_skip_tf(tmp_path, capsys, no_tensorflow):
    assert export_cli.main([str(tmp_path), "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert SKIP_MESSAGE.format(["savedmodel", "tflite"]) in captured.err
    assert [p.name for p in tmp_path.iterdir()] == ["nmp.onnx"]


def test_cuda_device_without_a_gpu_raises_before_writing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main([str(tmp_path / "out"), "--format", "onnx"])
    assert not (tmp_path / "out").exists()


def test_predict_cli_model_serialization_onnx(tmp_path, monkeypatch, capsys):
    """`basic-pitch-torch --model-serialization onnx` transcribes a short
    synthesized clip as the npz checkpoint does; without a locatable
    nmp.onnx it fails naming BASIC_PITCH_SAVED_MODELS."""
    models = tmp_path / "saved_models"
    models.mkdir()
    assert export_cli.main([str(models), "--format", "onnx", "--device", "cpu", "--no-verify"]) == 0
    wav = tmp_path / "clip.wav"
    audio_io.write_wav(wav, tone_mix(seconds=4.0, seed=31), SR)
    events = {}
    for name, flags in (("onnx", ["--model-serialization", "onnx"]), ("npz", [])):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.setenv("BASIC_PITCH_SAVED_MODELS", str(models))
        predict_cli.main([str(out), str(wav), "--device", "cpu", "--save-note-events", "--no-save-midi", *flags])
        assert "Done" in capsys.readouterr().out
        with open(out / "clip_basic_pitch.csv") as fh:
            rows = list(csv.reader(fh))[1:]
        events[name] = [(float(r[0]), float(r[1]), int(r[2])) for r in rows]
    assert events["npz"]
    assert_events_agree(events["onnx"], events["npz"])
    monkeypatch.setenv("BASIC_PITCH_SAVED_MODELS", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="BASIC_PITCH_SAVED_MODELS"):
        predict_cli.main([str(tmp_path / "npz"), str(wav), "--device", "cpu", "--model-serialization", "tflite"])
