"""PyTorch port, the head convs' lowerings (`nmp.conv_impl`): im2col and the
frequency-blocked Toeplitz matmul against the plain convolution, and the
model under each lowering against the JAX package's `nmp.forward` with the
same lowering, on the CPU.

Integer-valued inputs make float32 arithmetic exact, so any difference
between two lowerings of one conv is an indexing fault, not rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_tpu import constants
from basic_pitch_tpu.models import nmp as j_nmp
from torch_port_helpers import one_torch_thread  # noqa: F401

# the six head-conv geometries (kh, kw, cin, cout, strides, freq)
GEOMETRIES = [
    ("contour_conv", 3, 39, 8, 8, (1, 1), 264),
    ("contour_out", 5, 5, 8, 1, (1, 1), 264),
    ("note_conv", 7, 7, 1, 32, (1, 3), 264),
    ("note_out", 7, 3, 32, 1, (1, 1), 88),
    ("onset_conv", 5, 5, 8, 32, (1, 3), 264),
    ("onset_out", 3, 3, 33, 1, (1, 1), 88),
]
IMPLS = ["conv", "im2col", "toeplitz:88", "toeplitz:24", "mxu:24"]


def _int_case(kh, kw, cin, cout, st, f, t=20, b=2, seed=0):
    """An integer-valued conv and input, NCHW/OIHW."""
    rng = np.random.default_rng(seed)
    conv = t_nmp.SameConv2d(cin, cout, (kh, kw), stride=st)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.integers(-3, 4, (cout, cin, kh, kw)).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.integers(-3, 4, (cout,)).astype(np.float32)))
    x = torch.from_numpy(rng.integers(-3, 4, (b, cin, t, f)).astype(np.float32))
    return conv, x


@pytest.mark.parametrize("name,kh,kw,cin,cout,st,f", GEOMETRIES)
def test_im2col_exact(name, kh, kw, cin, cout, st, f):
    conv, x = _int_case(kh, kw, cin, cout, st, f)
    with torch.no_grad():
        ref, got = conv(x), t_nmp.conv2d_im2col(x, conv)
    assert ref.shape == got.shape
    assert float((ref - got).abs().max()) == 0.0


@pytest.mark.parametrize("name,kh,kw,cin,cout,st,f", [g for g in GEOMETRIES if g[5] == (1, 1)])
@pytest.mark.parametrize("fb", [None, 24, 44, 88])
def test_toeplitz_exact(name, kh, kw, cin, cout, st, f, fb):
    if fb is not None and f % fb:
        pytest.skip(f"{fb} does not divide {f}")
    conv, x = _int_case(kh, kw, cin, cout, st, f)
    with torch.no_grad():
        ref, got = conv(x), t_nmp.conv2d_toeplitz(x, conv, fb=fb)
    assert ref.shape == got.shape
    assert float((ref - got).abs().max()) == 0.0


@pytest.mark.parametrize("name,kh,kw,cin,cout,st,f", GEOMETRIES)
def test_lowerings_match_jax_layouts(name, kh, kw, cin, cout, st, f):
    """The port's NCHW lowerings give the JAX package's NHWC results,
    including the stride-(1, 3) convs, whose extra SAME column goes on the
    right in both."""
    conv, x = _int_case(kh, kw, cin, cout, st, f, seed=3)
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    wj = jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy())
    bj = jnp.asarray(conv.bias.detach().numpy())
    ref = np.asarray(j_nmp._conv2d_im2col(xj, wj, bj, st, jax.lax.Precision.HIGHEST))
    with torch.no_grad():
        got = t_nmp.conv2d_im2col(x, conv).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    if st == (1, 1):
        ref = np.asarray(j_nmp._conv2d_toeplitz(xj, wj, bj, st, jax.lax.Precision.HIGHEST, fb=24 if f % 24 == 0 else None))
        with torch.no_grad():
            got = t_nmp.conv2d_toeplitz(x, conv, fb=24 if f % 24 == 0 else None).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, ref)


def test_im2col_big_conv_falls_back(monkeypatch):
    """Convs whose patches would exceed the memory guard run the plain conv."""
    conv, x = _int_case(3, 39, 8, 8, (1, 1), 264, t=4)
    calls = []
    monkeypatch.setattr(torch.nn.functional, "unfold", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(t_nmp, "_IM2COL_MAX_PATCH_ELEMS", 1)
    with torch.no_grad():
        got = t_nmp.conv2d_im2col(x, conv)
        ref = conv(x)
    assert not calls
    assert float((ref - got).abs().max()) == 0.0


@pytest.fixture(scope="module")
def models(nmp_params):
    model = t_nmp.NMP()
    model.load_state_dict(t_params.from_jax_params(t_params.load_flat()))
    return model, nmp_params


def _noisy_tones(n: int = 2, seed: int = 7) -> np.ndarray:
    """Tones over a noise floor (no near-silent CQT bins, whose float32
    rounding the dB normalisation amplifies)."""
    rng = np.random.RandomState(seed)
    t = np.arange(constants.AUDIO_N_SAMPLES) / constants.AUDIO_SAMPLE_RATE
    tones = [0.3 * np.sin(2 * np.pi * f0 * t) * np.exp(-0.5 * t) for f0 in (220.0, 523.25, 311.1)[:n]]
    return (np.stack(tones) + 0.05 * rng.randn(n, len(t))).astype(np.float32)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax_per_conv_impl(models, impl):
    """The port's forward under each lowering against JAX `nmp.forward`
    with the same lowering, at the 1e-4 of tests/test_model.py."""
    model, params = models
    audio = _noisy_tones()
    ref, _ = j_nmp.forward(params, jnp.asarray(audio), conv_impl=impl)
    with torch.inference_mode():
        out = model(torch.from_numpy(audio), conv_impl=impl)
    for head in ("note", "onset", "contour"):
        np.testing.assert_allclose(out[head].numpy(), np.asarray(ref[head]), atol=1e-4, rtol=0, err_msg=f"{impl} {head}")


@pytest.mark.parametrize("impl", IMPLS[1:])
def test_forward_lowerings_agree_with_conv(models, impl):
    """Every lowering stays within float rounding of the cuDNN/oneDNN conv
    (the 2e-5 of tests/test_conv_layouts.py)."""
    model, _ = models
    audio = torch.from_numpy(_noisy_tones(1, seed=8))
    with torch.inference_mode():
        base = model(audio)
        out = model(audio, conv_impl=impl)
    for head in ("note", "onset", "contour"):
        assert float((out[head] - base[head]).abs().max()) < 2e-5, (impl, head)


@pytest.mark.parametrize(
    "conv_impl,message",
    [("nope", "conv_impl must be"), ("conv:8", "takes no :arg"), ("im2col:8", "takes no :arg"), ("toeplitz:x", "invalid literal")],
)
def test_conv_impl_validation(conv_impl, message):
    with pytest.raises(ValueError, match=message):
        t_nmp.resolve_conv_impl(conv_impl)
    with pytest.raises(ValueError, match=message):
        j_nmp._resolve_conv_impl(conv_impl)


def test_toeplitz_block_size_validation():
    conv, x = _int_case(3, 39, 8, 8, (1, 1), 264, t=4)
    with pytest.raises(ValueError, match="must divide the frequency axis"):
        t_nmp.conv2d_toeplitz(x, conv, fb=23)
    strided, xs = _int_case(5, 5, 8, 32, (1, 3), 264, t=4)
    with pytest.raises(ValueError, match="stride-1 only"):
        t_nmp.conv2d_toeplitz(xs, strided)
    with pytest.raises(ValueError, match=">= 1"):
        t_nmp.resolve_conv_impl("mxu:0")
