"""PyTorch port, NMP model at full width against the goldens and JAX."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_tpu import constants
from basic_pitch_tpu.models import nmp as j_nmp

GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(scope="module")
def model():
    m = t_nmp.NMP()
    m.load_state_dict(t_params.from_jax_params(t_params.load_flat()))
    return m


def _run(model, audio):
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(torch.from_numpy(audio)).items()}


def test_output_shapes(model):
    out = _run(model, np.zeros((2, constants.AUDIO_N_SAMPLES), np.float32))
    assert out["note"].shape == (2, 172, 88)
    assert out["onset"].shape == (2, 172, 88)
    assert out["contour"].shape == (2, 172, 264)


@pytest.mark.parametrize("head", ["note", "onset", "contour"])
def test_matches_reference_golden(model, head):
    """The 1e-4 of tests/test_model.py's golden check."""
    golden = np.load(GOLDENS / "random_windows.npz")
    out = _run(model, golden["audio"])
    np.testing.assert_allclose(out[head], golden[head], atol=1e-4, rtol=0, err_msg=head)


def test_matches_jax_predict_fn(model, nmp_params):
    """A tone mix over a noise floor. Without the floor, CQT bins far below
    the tones' level carry float32 rounding of the tones themselves, which
    the dB normalisation amplifies past 1e-4 in either implementation."""
    rng = np.random.RandomState(12)
    t = np.arange(constants.AUDIO_N_SAMPLES) / constants.AUDIO_SAMPLE_RATE
    audio = np.stack([
        0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(2 * np.pi * 330.0 * t),
        0.2 * np.sin(2 * np.pi * 523.25 * t) * np.exp(-t),
    ]) + 0.05 * rng.randn(2, len(t))
    audio = audio.astype(np.float32)
    ref = jax.jit(j_nmp.predict_fn)(nmp_params, jnp.asarray(audio))
    out = _run(model, audio)
    for head in ("note", "onset", "contour"):
        np.testing.assert_allclose(out[head], np.asarray(ref[head]), atol=1e-4, rtol=0, err_msg=head)


@pytest.mark.parametrize("size,kernel,stride", [(264, 7, 3), (264, 5, 3), (172, 7, 1), (264, 39, 1), (10, 4, 1)])
def test_same_padding_matches_tf(size, kernel, stride):
    """Output length ceil(size / stride); an odd total pad puts the extra
    element after."""
    before, after = t_nmp._same_pad(size, kernel, stride)
    out = (size + before + after - kernel) // stride + 1
    assert out == -(-size // stride)
    assert after - before in (0, 1)
