"""PyTorch port, the train CLI (`basic_pitch_torch/cli/train.py`).

Its parser carries every flag of the JAX train CLI, with the same
destinations, types, choices and defaults, plus ``--device``. One epoch of
one step runs on ``--device cpu`` and writes JAX-layout checkpoints that the
JAX package loads; rerunning with more epochs resumes; without
``--device cpu`` and with no GPU it raises; the multi-process flags need a
coordinator for several processes (`tests/test_torch_distributed.py` trains
two).
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from basic_pitch_torch.cli import train as t_train
from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_tpu.cli import train as j_train
from basic_pitch_tpu.models import params as j_params
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_train_data import write_corpus


class _Captured(Exception):
    pass


def _jax_parser(monkeypatch):
    """The JAX CLI builds its parser inside `console_entry_point`: stop it
    at `parse_args` and keep the parser."""
    seen = {}

    def capture(self, *args, **kwargs):
        seen["parser"] = self
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured):
        j_train.console_entry_point()
    monkeypatch.undo()
    return seen["parser"]


def _actions(parser):
    return {
        a.dest: (tuple(a.option_strings), a.nargs, a.const, a.type, a.choices, a.required, a.default)
        for a in parser._actions
        if a.dest != "help"
    }


def test_parser_carries_every_jax_flag_and_device(monkeypatch):
    port, jax = _actions(t_train.build_parser()), _actions(_jax_parser(monkeypatch))
    assert set(port) == set(jax) | {"device"}
    for dest, spec in jax.items():
        assert port[dest] == spec, dest
    assert port["device"][0] == ("--device",) and port["device"][4] == ["cuda", "cpu"] and port["device"][6] == "cuda"


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("source"), "GuitarSet", n_train=2, n_validation=1, seconds=4.0, seed=3)


def _args(source, output, epochs, *extra):
    return ["--source", str(source), "--output", str(output), "--guitarset", "-e", str(epochs),
            "--steps-per-epoch", "1", "-v", "1", "-b", "2", "--size-evaluation-callback-datasets", "0",
            "--parse-workers", "1", *extra]


def test_one_epoch_on_the_cpu_then_resume(source, tmp_path, caplog):
    """One epoch of one full-width step, then a rerun with two epochs
    resumes the same run at epoch 1; the checkpoints load in JAX
    `params.load_params` and in the port with the default config."""
    out = tmp_path / "out"
    run_dir = t_train.main(_args(source, out, 1, "--device", "cpu", "--no-data-parallel"))
    assert run_dir.parent == out
    for name in ("model.best.npz", "checkpoints/model.00.npz", "train_state.pt"):
        assert (run_dir / name).exists(), name
    loaded = j_params.flatten_params(j_params.load_params(run_dir / "model.best.npz"))
    flat = t_params.load_flat(run_dir / "model.best.npz")
    assert set(loaded) == set(flat) and len(flat) == 24
    assert t_params.config_from_params(flat) == t_nmp.DEFAULT_CONFIG
    caplog.clear()
    with caplog.at_level("INFO"):
        again = t_train.main(_args(source, out, 2, "--device", "cpu"))
    assert again == run_dir
    messages = [r.getMessage() for r in caplog.records]
    assert any("resumed" in m and "at epoch 1" in m for m in messages)
    assert [m.split(":")[0] for m in messages if m.startswith("epoch ")] == ["epoch 1"]
    assert (run_dir / "checkpoints" / "model.01.npz").exists()


def test_trainable_cqt_no_contours_checkpoint(source, tmp_path):
    run_dir = t_train.main(_args(source, tmp_path, 1, "--device", "cpu", "--trainable-cqt", "--no-contours",
                                 "--no-device-targets", "--train-precision", "default", "--weighted-onset-loss"))
    flat = t_params.load_flat(run_dir / "model.best.npz")
    config = t_params.config_from_params(flat)
    assert config.trainable_cqt and config.no_contours
    assert np.isfinite(np.concatenate([v.ravel() for v in flat.values()])).all()


def test_needs_a_gpu_unless_told_cpu(source, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(_args(source, tmp_path / "out", 1))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("flags", [["--num-processes", "2"], ["--coordinator", "localhost:1234"]])
def test_multi_process_flags_name_the_parallel_slice(source, tmp_path, flags, monkeypatch):
    """The multi-process flags are the parallel slice's
    (`parallel/distributed.py`, `tests/test_torch_distributed.py` runs two
    processes): several processes without a coordinator address (nor
    MASTER_ADDR / MASTER_PORT) raise before any work; a coordinator for one
    process is a no-op, as in JAX, and the run trains on its own."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    if "--num-processes" in flags:
        with pytest.raises(ValueError, match="coordinator address"):
            t_train.main(_args(source, tmp_path, 1, "--device", "cpu", *flags))
        assert not (tmp_path / "out").exists()
    else:
        run_dir = t_train.main(_args(source, tmp_path / "out", 1, "--device", "cpu", *flags))
        assert (run_dir / "checkpoints" / "model.00.npz").exists()


def test_needs_a_dataset(tmp_path, capsys):
    with pytest.raises(SystemExit):
        t_train.main(["--source", str(tmp_path), "--output", str(tmp_path), "--device", "cpu"])
    assert "select at least one dataset" in capsys.readouterr().err


def test_help_and_console_script():
    proc = subprocess.run(
        [sys.executable, "-m", "basic_pitch_torch.cli.train", "--help"],
        capture_output=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr.decode()[-500:]
    assert b"--device" in proc.stdout and b"--train-precision" in proc.stdout
    import tomllib

    with open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["basic-pitch-torch-train"] == "basic_pitch_torch.cli.train:main"
