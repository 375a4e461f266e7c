"""PyTorch port, front-end ops: CQT, decimation, dB normalisation and
harmonic stacking against the goldens and the JAX package on the CPU."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_pitch_torch.ops import cqt as t_cqt
from basic_pitch_torch.ops import harmonic as t_harmonic
from basic_pitch_torch.ops import resample as t_resample
from basic_pitch_torch.ops import spectral as t_spectral
from basic_pitch_tpu.ops import cqt as j_cqt
from basic_pitch_tpu.ops import harmonic as j_harmonic
from basic_pitch_tpu.ops import resample as j_resample
from basic_pitch_tpu.ops import spectral as j_spectral

GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDENS / "random_windows.npz")


def test_cqt_matches_golden(golden):
    """The tolerance of tests/test_cqt.py's golden check."""
    kernels = t_cqt.build_cqt_kernels()
    mag = t_cqt.cqt_magnitude(kernels, torch.from_numpy(golden["audio"]))
    np.testing.assert_allclose(mag.numpy(), golden["cqt"], atol=2e-6, rtol=0)


@pytest.mark.parametrize(
    "geometry,atol",
    [
        ({}, 2e-6),
        # the early pre-decimation adds a stride-32 FIR stage; 5e-6 is the
        # tolerance tests/test_cqt.py holds this geometry to
        (dict(sr=22050, hop_length=512, fmin=32.70, n_bins=48, bins_per_octave=24), 5e-6),
    ],
    ids=["nmp", "early-downsample"],
)
def test_cqt_matches_jax(geometry, atol):
    rng = np.random.RandomState(3)
    audio = (rng.randn(2, 8192) * 0.2).astype(np.float32)
    mine = t_cqt.cqt_magnitude(t_cqt.build_cqt_kernels(**geometry), torch.from_numpy(audio)).numpy()
    ref = np.asarray(j_cqt.cqt_magnitude(j_cqt.build_cqt_kernels(**geometry), jnp.asarray(audio)))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("length", [1000, 999, 43844])
def test_decimate2_matches_jax(length):
    x = (np.random.RandomState(length).randn(2, length) * 0.3).astype(np.float32)
    mine = t_resample.decimate2(torch.from_numpy(x)).numpy()
    ref = np.asarray(j_resample.decimate2(jnp.asarray(x)))
    assert mine.shape == ref.shape == (2, -(-length // 2))
    np.testing.assert_allclose(mine, ref, atol=1e-6, rtol=0)


def test_decimate2_halo_matches_jax():
    x = (np.random.RandomState(1).randn(2 * 3000 + 256) * 0.3).astype(np.float32)
    mine = t_resample.decimate2(torch.from_numpy(x), halo=True, n_out=3000).numpy()
    ref = np.asarray(j_resample.decimate2(jnp.asarray(x), halo=True, n_out=3000))
    assert mine.shape == ref.shape == (3000,)
    np.testing.assert_allclose(mine, ref, atol=1e-6, rtol=0)


def test_normalized_log_matches_jax():
    rng = np.random.RandomState(6)
    mag = np.abs(rng.randn(3, 172, 309)).astype(np.float32)
    mag[1] = 0.0  # an all-silent example takes the max == 0 branch
    mine = t_spectral.normalized_log(torch.from_numpy(mag)).numpy()
    ref = np.asarray(j_spectral.normalized_log(jnp.asarray(mag)))
    np.testing.assert_allclose(mine, ref, atol=1e-6, rtol=0)
    assert (mine[1] == 0).all()


def test_harmonic_stack_matches_jax():
    x = np.random.RandomState(7).rand(2, 20, 309, 1).astype(np.float32)
    harmonics = (0.5, 1, 2, 3, 4, 5, 6, 7)
    mine = t_harmonic.harmonic_stack(torch.from_numpy(x), 3, harmonics, 264).numpy()
    ref = np.asarray(j_harmonic.harmonic_stack(jnp.asarray(x), 3, harmonics, 264))
    assert mine.shape == ref.shape == (2, 20, 264, 8)
    np.testing.assert_allclose(mine, ref, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        t_harmonic.harmonic_stack(torch.zeros(2, 3, 4), 3, harmonics, 264)


def test_jax_runs_on_cpu():
    assert jax.devices()[0].platform == "cpu"
