"""Parameters, audio and JAX-written files shared by the port's model-format
tests (`tests/test_torch_{formats,onnx_export,tf_export,export_cli}.py`).
Not a test module: pytest collects nothing here."""

import numpy as np

# the fold re-associates (gamma/sigma)*w products (tests/test_model_formats.py)
FOLD_ATOL = 1e-5
HEADS = ("note", "onset", "contour")


def fresh_jax_params() -> dict:
    """A fresh JAX init with non-trivial batch-norm statistics, so that a
    writer's fold is really tested (the edits of tests/test_export.py)."""
    import jax
    import jax.numpy as jnp

    from basic_pitch_tpu.models import nmp

    params = nmp.init_params(jax.random.PRNGKey(1))
    params["bn_contour"]["mean"] = jnp.full((8,), 0.3)
    params["bn_contour"]["var"] = jnp.full((8,), 2.0)
    params["bn_onset"]["gamma"] = jnp.full((32,), 1.5)
    params["bn_cqt"]["beta"] = jnp.full((1,), -0.2)
    return params


def noise_audio(n: int, seed: int) -> np.ndarray:
    """Seeded noise windows, (n, 43844) float32: no near-silent CQT bins,
    whose float32 rounding the dB normalisation would amplify."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 43844)) * 0.1).astype(np.float32)


def torch_forward(flat: dict, audio: np.ndarray) -> dict:
    """The port's NMP built from a flat dict, on the CPU, as numpy."""
    import torch

    from basic_pitch_torch.models import params as t_params

    model = t_params.model_from_flat(flat)
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(torch.from_numpy(audio)).items()}


def max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[h]) - np.asarray(b[h])).max()) for h in HEADS)


def assert_flat_equal(got: dict, want: dict) -> None:
    """Same keys, dtypes, shapes and bits."""
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
