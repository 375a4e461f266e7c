"""PyTorch port, the command-line interfaces (`basic_pitch_torch/cli`).

Each parser takes the JAX parser's flags, with the same defaults, choices
and destinations, minus the flags whose machinery the port has not ported
or does not need, plus ``--device``. The predict CLI runs end to end on
the CPU in both modes, and every CLI refuses to start without a GPU unless
told ``--device cpu``.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from basic_pitch_torch.cli import predict as t_predict
from basic_pitch_torch.cli import serve as t_serve
from basic_pitch_torch.cli import stream as t_stream
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_torch.utils import midi as midi_io
from basic_pitch_tpu.cli import predict as j_predict
from basic_pitch_tpu.cli import serve as j_serve
from basic_pitch_tpu.cli import stream as j_stream
from torch_port_helpers import SR, melody, one_torch_thread  # noqa: F401

# flags of the JAX parsers that the port leaves out, and why
LEFT_OUT = {
    "predict": set(),
    "serve": {"decode_backend"},  # the device fixes the decoder
    "stream": set(),
}
PARSERS = {"predict": (t_predict, j_predict), "serve": (t_serve, j_serve), "stream": (t_stream, j_stream)}
PORT_MODULES = ("basic_pitch_torch.cli.predict", "basic_pitch_torch.cli.serve", "basic_pitch_torch.cli.stream",
                "basic_pitch_torch.cli.export")
SUBPROCESS_ENV = dict(os.environ, OMP_NUM_THREADS="1")  # one intra-op thread, as in-process below


def _actions(parser):
    return {
        a.dest: (tuple(a.option_strings), a.nargs, a.const, a.type, a.choices, a.required)
        for a in parser._actions
        if a.dest != "help"
    }


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_flags_match_jax(name):
    port, jax = (m.build_parser() for m in PARSERS[name])
    p_actions, j_actions = _actions(port), _actions(jax)
    assert set(p_actions) == (set(j_actions) - LEFT_OUT[name]) | {"device"}
    for dest in set(p_actions) - {"device"}:
        assert p_actions[dest] == j_actions[dest], dest
        if dest != "model_path":  # each package ships its own copy of the weights
            assert _defaults(port)[dest] == _defaults(jax)[dest], dest
    assert p_actions["device"][0] == ("--device",) and p_actions["device"][4] == ["cuda", "cpu"]
    assert _defaults(port)["device"] == "cuda"


def test_model_path_defaults_to_the_ports_weights():
    from basic_pitch_torch.models.params import ICASSP_2022_WEIGHTS_PATH

    assert _defaults(t_predict.build_parser())["model_path"] == str(ICASSP_2022_WEIGHTS_PATH)
    assert _defaults(t_serve.build_parser())["model_path"] == str(ICASSP_2022_WEIGHTS_PATH)


@pytest.mark.parametrize("module", PORT_MODULES)
def test_help(module):
    proc = subprocess.run([sys.executable, "-m", module, "--help"], capture_output=True, timeout=120, env=SUBPROCESS_ENV)
    assert proc.returncode == 0, proc.stderr.decode()[-500:]
    assert b"usage" in proc.stdout.lower() and b"--device" in proc.stdout


def _melody_wav(path, midis=(60, 64, 67, 72)):
    y = melody(midis)
    t_audio.write_wav(path, y + 0.01 * np.random.RandomState(0).randn(len(y)), SR)


def test_predict_cli_end_to_end_on_the_cpu(tmp_path):
    """Both modes in a subprocess, as a user runs them: the windowed path
    (model, then host decode) and --streaming (transcriber, device decode)
    write their artifacts, and their notes agree."""
    wav = tmp_path / "melody.wav"
    _melody_wav(wav)
    outs = {}
    for mode, extra in (("windowed", []), ("streaming", ["--streaming", "--save-model-outputs"])):
        out = tmp_path / mode
        out.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", "basic_pitch_torch.cli.predict", str(out), str(wav), "--device", "cpu",
             "--save-note-events", *extra],
            capture_output=True, text=True, timeout=300, env=SUBPROCESS_ENV,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "Done" in proc.stdout, proc.stdout[-2000:]
        outs[mode] = out
    assert {p.name for p in outs["windowed"].iterdir()} == {"melody_basic_pitch.mid", "melody_basic_pitch.csv"}
    assert {p.suffix for p in outs["streaming"].iterdir()} == {".mid", ".csv", ".npz"}
    notes = {
        mode: sorted((round(n.start, 1), n.pitch) for i in midi_io.read_midi(out / "melody_basic_pitch.mid").instruments for n in i.notes)
        for mode, out in outs.items()
    }
    assert len(notes["windowed"]) >= 4
    assert notes["windowed"] == notes["streaming"]
    assert {p for _, p in notes["windowed"]} >= {60, 64, 67, 72}


def test_predict_cli_refusals(tmp_path, monkeypatch, capsys):
    wav = tmp_path / "melody.wav"
    _melody_wav(wav, midis=(60,))
    with pytest.raises(SystemExit):
        t_predict.main([str(tmp_path), str(wav), "--streaming", "--debug-file", str(tmp_path / "d.json")])
    assert "--debug-file" in capsys.readouterr().err
    with pytest.raises(ValueError, match="does not exist"):
        t_predict.main([str(tmp_path / "missing"), str(wav), "--device", "cpu"])
    # an existing output is refused with a message, not a crash
    (tmp_path / "melody_basic_pitch.mid").write_bytes(b"")
    t_predict.main([str(tmp_path), str(wav), "--device", "cpu"])
    assert "already exists" in capsys.readouterr().out


def test_clis_need_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    wav = tmp_path / "melody.wav"
    _melody_wav(wav, midis=(60,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_predict.main([str(tmp_path), str(wav)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_stream.main([], stdin=io.BytesIO(b""), stdout=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--port", "0", "--warmup", ""])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["melody.wav"]


def test_serve_warm_transcribes_each_length():
    calls = []

    class Recorder:
        def transcribe(self, audio, sr):
            calls.append((audio.dtype, len(audio), sr))

    t_serve._warm(Recorder(), "1, 2.5,,")
    assert calls == [(np.int16, SR, SR), (np.int16, int(2.5 * SR), SR)]


@pytest.mark.parametrize(
    "argv,transport,head",
    [([], "auto", "highest"), (["--pcm-transport", "codec", "--head-precision", "high"], "codec", "high"),
     (["--pcm-transport", "raw", "--head-precision", "default"], "raw", "default")],
)
def test_serve_cli_passes_transport_and_head_precision(monkeypatch, argv, transport, head):
    """--pcm-transport and --head-precision reach the transcriber (the JAX
    server's flags, choices and defaults; tests/test_serve.py:197)."""
    from basic_pitch_torch import pipeline, serve

    seen = {}

    class Transcriber:
        device, decode_backend = "cpu", "plain"

        def __init__(self, model_path, **kwargs):
            seen.update(kwargs)
            self.pcm_transport, self.head_precision = kwargs["pcm_transport"], kwargs["head_precision"]

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            seen["closed"] = True

    monkeypatch.setattr(pipeline, "StreamingTranscriber", Transcriber)
    monkeypatch.setattr(serve, "TranscriptionService", lambda tr, **kw: type("S", (), {"close": lambda self: None})())
    monkeypatch.setattr(serve, "make_server", lambda *a, **kw: Server())
    ns = t_serve.build_parser().parse_args(["--port", "0", *argv])
    assert (ns.pcm_transport, ns.head_precision) == (transport, head)
    t_serve.main(["--port", "0", "--warmup", "", "--device", "cpu", *argv])
    assert seen["pcm_transport"] == transport and seen["head_precision"] == head and seen["closed"]
    with pytest.raises(SystemExit):
        t_serve.build_parser().parse_args(["--pcm-transport", "zip"])
