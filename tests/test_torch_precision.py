"""PyTorch port, the model stage's precision settings (`precision`,
`head_precision`, `nmp.precision_scope`) on the CPU.

"highest" is held against the JAX package at HIGHEST. "high" (TF32) and
"default" (bf16 autocast) are not compared with JAX: on XLA:CPU the JAX
package's HIGH and DEFAULT both compute in float32, and TF32 does nothing
on the CPU, so they are held to their own contracts here (flags scoped to
their stage and restored, bf16 outputs within a stated bound) and measured
on the card by `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_tpu import constants
from basic_pitch_tpu.models import nmp as j_nmp
from torch_port_helpers import one_torch_thread  # noqa: F401

SETTINGS = [
    ("highest", None),
    ("highest", "highest"),
    ("highest", "high"),
    ("highest", "default"),
    ("high", None),
    ("default", None),
    ("default", "highest"),
]


@pytest.fixture(scope="module")
def model():
    m = t_nmp.NMP()
    m.load_state_dict(t_params.from_jax_params(t_params.load_flat()))
    return m


def _audio(n: int = 2, seed: int = 7) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(constants.AUDIO_N_SAMPLES) / constants.AUDIO_SAMPLE_RATE
    tones = [0.3 * np.sin(2 * np.pi * f0 * t) * np.exp(-0.5 * t) for f0 in (220.0, 523.25)[:n]]
    return (np.stack(tones) + 0.05 * rng.randn(n, len(t))).astype(np.float32)


@pytest.mark.parametrize("head_precision", [None, "highest"])
def test_highest_matches_jax_highest(model, nmp_params, head_precision):
    audio = _audio()
    ref, _ = j_nmp.forward(
        nmp_params, jnp.asarray(audio), precision=jax.lax.Precision.HIGHEST,
        head_precision=None if head_precision is None else jax.lax.Precision.HIGHEST,
    )
    with torch.inference_mode():
        out = model(torch.from_numpy(audio), precision="highest", head_precision=head_precision)
    for head in ("note", "onset", "contour"):
        np.testing.assert_allclose(out[head].numpy(), np.asarray(ref[head]), atol=1e-4, rtol=0, err_msg=head)


def test_bf16_heads_within_bound_of_highest(model):
    """bf16 autocast on the six head convs alone: float32 outputs within 1e-2
    of "highest" (3.6e-3 measured on this input); the front end, in float32,
    is the same, so "high" heads equal "highest" exactly on the CPU, where
    TF32 does nothing."""
    audio = torch.from_numpy(_audio())
    with torch.inference_mode():
        base = model(audio)
        bf16 = model(audio, head_precision="default")
        tf32 = model(audio, head_precision="high")
    for head in ("note", "onset", "contour"):
        assert bf16[head].dtype == torch.float32
        diff = float((bf16[head] - base[head]).abs().max())
        assert 0 < diff < 1e-2, (head, diff)
        assert torch.equal(tf32[head], base[head]), head


@pytest.mark.parametrize("precision,head_precision", SETTINGS)
@pytest.mark.parametrize("before", [False, True])
def test_flags_scoped_to_their_stage_and_restored(model, monkeypatch, precision, head_precision, before):
    """The CQT sees the front end's TF32 flags and the heads see theirs
    (a TF32 head scope never leaks into the CQT, nor a float32 one into the
    heads); after the call the process-wide flags are what they were."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before)
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            seen.setdefault(name, (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                                   torch.is_autocast_enabled("cpu")))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(model.cqt, "forward", spy("cqt", model.cqt.forward))
    monkeypatch.setattr(model.onset_out, "forward", spy("heads", model.onset_out.forward))
    with torch.inference_mode():
        out = model(torch.from_numpy(_audio(1)), precision=precision, head_precision=head_precision)
    head = precision if head_precision is None else head_precision
    assert seen["cqt"] == ((precision == "high",) * 2 + (precision == "default",))
    assert seen["heads"] == ((head == "high",) * 2 + (head == "default",))
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (before, before)
    assert not torch.is_autocast_enabled("cpu")
    assert all(v.dtype == torch.float32 for v in out.values())


@pytest.mark.parametrize("bad", ["HIGHEST", "fp8", "tf32"])
def test_bad_precision_names_raise(model, bad):
    audio = torch.from_numpy(_audio(1))
    with pytest.raises(ValueError, match="precision must be one of"):
        model(audio, precision=bad)
    with pytest.raises(ValueError, match="precision must be one of"):
        model(audio, head_precision=bad)
    for kw in ({"precision": bad}, {"head_precision": bad}):
        with pytest.raises(ValueError, match="precision must be one of"):
            t_pipeline.StreamingTranscriber(windows_per_chunk=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="conv_impl"):
        t_pipeline.StreamingTranscriber(windows_per_chunk=1, device="cpu", conv_impl="nope")


def test_transcriber_settings_reach_the_model(monkeypatch):
    """The transcriber hands its settings to every model call and leaves the
    TF32 flags off."""
    tr = t_pipeline.StreamingTranscriber(
        windows_per_chunk=1, device="cpu", precision="high", head_precision="default", conv_impl="mxu:24"
    )
    calls = []
    real = t_nmp.NMP.forward

    def spy(self, audio, precision="highest", head_precision=None, conv_impl="conv"):
        calls.append((precision, head_precision, conv_impl))
        return real(self, audio, precision, head_precision, conv_impl)

    monkeypatch.setattr(t_nmp.NMP, "forward", spy)
    out = tr.posteriorgrams(_audio(1)[0], constants.AUDIO_SAMPLE_RATE)
    assert calls and set(calls) == {("high", "default", "mxu:24")}
    assert all(np.isfinite(v).all() for v in out.values())
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
