"""PyTorch port, the training path (`basic_pitch_torch/train`, the model in
train mode) against the JAX package on the CPU.

Narrow models (2 harmonics, 4/4/4 filters) at batch 2, plus one full-width
step from the shipped weights. Inputs are seeded numpy; every tolerance is
stated where it is used. Gradients are compared per parameter tensor,
relative to that tensor's largest gradient. Float32 rounding in a window's
quietest CQT bin moves the whole window through the dB normalisation, and
the gradients of the layers that read the normalised CQT (the CQT bank, its
batch norm, the first contour and onset convs) are sums with heavy
cancellation: the port in float32 against itself in float64 differs there
by up to 8.5e-4 of the tensor's largest gradient (narrow, trainable bank;
`test_gradient_tolerances_cover_float32_error` holds the tolerances to at
least twice that error), so two float32 implementations are held to 5e-3
there and to 1e-3 elsewhere. The biases in front of a batch norm
have a gradient that is zero in exact arithmetic; their float32 residue is
held to an absolute bound instead.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from basic_pitch_torch.data import loader as t_loader
from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import params as t_params
from basic_pitch_torch.train import loop as t_loop
from basic_pitch_torch.train import losses as t_losses
from basic_pitch_tpu import constants
from basic_pitch_tpu.data import loader as j_loader
from basic_pitch_tpu.models import nmp as j_nmp
from basic_pitch_tpu.models import params as j_params
from basic_pitch_tpu.train import loop as j_loop
from basic_pitch_tpu.train import losses as j_losses
from torch_port_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
NARROW = dict(n_harmonics=2, n_filters_contour=4, n_filters_notes=4, n_filters_onsets=4)
CONFIGS = {
    "default": NARROW,
    "no_contours": dict(NARROW, no_contours=True),
    "trainable_cqt": dict(NARROW, trainable_cqt=True),
}
GRAD_RTOL = 1e-3  # of each tensor's largest gradient
FRONTEND_GRAD_RTOL = 5e-3  # the layers that read the normalised CQT
FRONTEND = ("cqt_kernels", "bn_cqt/gamma", "bn_cqt/beta", "contour_conv/w", "onset_conv/w")
PRE_BN_BIAS_ATOL = 1e-6  # biases in front of a batch norm: zero gradient in exact arithmetic
PRE_BN_BIASES = ("contour_conv/b", "onset_conv/b")


def _jax_flat(config_name, seed=0):
    """Seeded JAX-initialised parameters as a flat numpy dict; a trainable
    bank is perturbed away from the analytic one so that loading it shows."""
    params = j_nmp.init_params(jax.random.PRNGKey(seed), j_nmp.ModelConfig(**CONFIGS[config_name]))
    flat = {k: np.array(v) for k, v in j_params.flatten_params(jax.device_get(params)).items()}
    if "cqt_kernels" in flat:
        rng = np.random.RandomState(seed)
        flat["cqt_kernels"] = (flat["cqt_kernels"] * (1 + 0.05 * rng.randn(*flat["cqt_kernels"].shape))).astype(np.float32)
    return flat


def _batch(seed, b=2):
    """Noise audio (every CQT bin well above float32 rounding of the loud
    ones) and sparse-looking targets, with one example lacking contours."""
    rng = np.random.RandomState(seed)
    weights = {k: np.ones(b, np.float32) for k in ("contour", "note", "onset")}
    weights["contour"][-1] = 0.0
    return {
        "audio": (rng.randn(b, constants.AUDIO_N_SAMPLES) * 0.1).astype(np.float32),
        "targets": {
            "contour": (rng.rand(b, 172, 264) > 0.9).astype(np.float32),
            "note": (rng.rand(b, 172, 88) > 0.9).astype(np.float32),
            "onset": (rng.rand(b, 172, 88) > 0.97).astype(np.float32),
        },
        "weights": weights,
    }


def _jax_tree(flat):
    return j_params.unflatten_params(flat)


def _grads_as_flat(model):
    """The port's gradients in the flat JAX layout (zeros where a parameter
    got none, e.g. the unused contour_out of a no_contours model)."""
    state = dict(model.state_dict())
    for name, p in model.named_parameters():
        state[name] = p.grad if p.grad is not None else torch.zeros_like(p)
    return t_params.to_jax_params(state)


def _assert_grads_close(port, ref):
    for key, g_ref in ref.items():
        if key.endswith(("/mean", "/var")):
            continue
        err = float(np.abs(port[key] - g_ref).max())
        if key in PRE_BN_BIASES:
            assert err <= PRE_BN_BIAS_ATOL, (key, err)
        else:
            rtol = FRONTEND_GRAD_RTOL if key in FRONTEND else GRAD_RTOL
            assert err <= rtol * float(np.abs(g_ref).max()), (key, err / float(np.abs(g_ref).max()))


def _jax_loss_fn(config, batch, train=True):
    def loss_fn(p):
        out, stats = j_nmp.forward(p, jnp.asarray(batch["audio"]), config, train=train)
        total, per_head = j_losses.total_loss(
            out, batch["targets"], batch["weights"], no_contours=config.no_contours
        )
        return total, (out, stats)

    return loss_fn


@pytest.fixture(scope="module")
def jax_reference():
    """Per config: the JAX loss, gradients, outputs and batch stats of one
    train-mode step on `_batch(0)` (one compile per config)."""
    refs = {}
    batch = _batch(0)
    for name, kw in CONFIGS.items():
        config = j_nmp.ModelConfig(**kw)
        flat = _jax_flat(name)
        (loss, (out, stats)), grads = jax.jit(jax.value_and_grad(_jax_loss_fn(config, batch), has_aux=True))(
            _jax_tree(flat)
        )
        refs[name] = {
            "flat": flat,
            "loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in j_params.flatten_params(jax.device_get(grads)).items()},
            "out": {k: np.asarray(v) for k, v in out.items()},
            "stats": {k: tuple(np.asarray(x) for x in v) for k, v in stats.items()},
            "tree": _jax_tree(flat),
            "config": config,
        }
    return refs


def _port_step_inputs(name, ref):
    model = t_params.model_from_flat(ref["flat"])
    assert model.config == t_nmp.ModelConfig(**CONFIGS[name])
    batch, _ = t_loop.upload_batch(_batch(0), CPU)
    return model, batch


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "smoothing,weighted,weights,no_contours",
    [
        (0.2, False, True, False),
        (0.0, False, False, False),
        (0.2, True, True, False),
        (0.1, True, False, False),
        (0.2, False, True, True),
        (0.2, True, True, True),
    ],
)
def test_losses_match_jax(smoothing, weighted, weights, no_contours):
    """Every loss and option at 1e-6 relative; predictions include values
    past the 1e-7 clip."""
    rng = np.random.RandomState(int(smoothing * 10) + 2 * weighted + 4 * weights)
    b = 3
    outputs = {
        "contour": rng.rand(b, 172, 264).astype(np.float32),
        "note": rng.rand(b, 172, 88).astype(np.float32),
        "onset": rng.rand(b, 172, 88).astype(np.float32),
    }
    outputs["onset"][0, :5, 0] = [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5]
    targets = {k: (rng.rand(*v.shape) > 0.9).astype(np.float32) * rng.rand(*v.shape).astype(np.float32) for k, v in outputs.items()}
    w = {k: rng.randint(0, 2, b).astype(np.float32) for k in outputs} if weights else None
    kw = dict(label_smoothing=smoothing, weighted_onset=weighted, positive_weight=0.3, no_contours=no_contours)
    j_total, j_heads = j_losses.total_loss(
        {k: jnp.asarray(v) for k, v in outputs.items()}, targets, w, **kw
    )
    t_total, t_heads = t_losses.total_loss(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()},
        {k: torch.from_numpy(v) for k, v in w.items()} if w else None,
        **kw,
    )
    assert set(t_heads) == set(j_heads)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=1e-6)
    for head in j_heads:
        np.testing.assert_allclose(float(t_heads[head]), float(j_heads[head]), rtol=1e-6, atol=1e-12, err_msg=head)
    y, p = targets["note"], outputs["note"]
    np.testing.assert_allclose(
        t_losses.transcription_loss(torch.from_numpy(y), torch.from_numpy(p), smoothing).numpy(),
        np.asarray(j_losses.transcription_loss(jnp.asarray(y), jnp.asarray(p), smoothing)),
        rtol=1e-6,
    )


# ---------------------------------------------------------------------------
# the model in train mode, one step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_forward_matches_jax(name, jax_reference):
    """Train-mode outputs within 1e-4 (the repo's model tolerance; the
    quiet-bin effect) and the BN batch stats within 1e-5 relative."""
    ref = jax_reference[name]
    model, batch = _port_step_inputs(name, ref)
    with torch.no_grad():
        out, stats = model.forward_and_stats(batch["audio"], train=True)
    for key in ("onset", "note", "contour"):
        assert out[key].shape == ref["out"][key].shape, key
        np.testing.assert_allclose(out[key].numpy(), ref["out"][key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert set(stats) == set(ref["stats"]) == {"bn_cqt", "bn_contour", "bn_onset"}
    for layer, (mean, var) in stats.items():
        np.testing.assert_allclose(mean.numpy(), ref["stats"][layer][0], rtol=1e-5, atol=1e-6, err_msg=layer)
        np.testing.assert_allclose(var.numpy(), ref["stats"][layer][1], rtol=1e-5, atol=1e-6, err_msg=layer)
    # eval mode is untouched by a train-mode call: the moving stats did not move
    np.testing.assert_array_equal(model.bn_onset.running_mean.numpy(), ref["flat"]["bn_onset/mean"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_jax(name, jax_reference):
    """(a) The loss within 1e-5 relative and every gradient within 1e-3 of
    its tensor's largest, against `jax.value_and_grad` of the JAX loss."""
    ref = jax_reference[name]
    model, batch = _port_step_inputs(name, ref)
    total, _, _ = t_loop.loss_and_stats(model, batch, t_loop.TrainConfig())
    total.backward()
    np.testing.assert_allclose(float(total.detach()), ref["loss"], rtol=1e-5)
    grads = _grads_as_flat(model)
    assert set(grads) == set(k for k in ref["grads"])
    _assert_grads_close(grads, ref["grads"])
    if name == "trainable_cqt":
        assert np.abs(grads["cqt_kernels"]).max() > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_update_given_jax_gradients_matches_jax(name, jax_reference):
    """(b) Given JAX's gradients and batch stats, two updates (the JAX
    gradients, then a seeded second set, so Adam's moments differ from its
    sign-like first step) through the port's Adam + unit norm + BN update
    equal the tail of `train_step_body` (optax adam, the JAX constraint and
    moving averages) at 1e-6."""
    ref = jax_reference[name]
    config = j_loop.TrainConfig(learning_rate=3e-3)
    rng = np.random.RandomState(1)
    second = {k: (rng.randn(*g.shape) * np.abs(g).max()).astype(np.float32) for k, g in ref["grads"].items()}
    steps = [ref["grads"], second]

    optimizer = j_loop.make_optimizer(config)
    params = ref["tree"]
    opt_state = optimizer.init(params)
    stats = {k: tuple(jnp.asarray(x) for x in v) for k, v in ref["stats"].items()}
    for grads in steps:
        updates, opt_state = optimizer.update(_jax_tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        params = j_nmp.apply_unit_norm_constraint(params)
        params = j_loop._update_bn_stats(params, stats, config.bn_momentum)
    expected = {k: np.asarray(v) for k, v in j_params.flatten_params(jax.device_get(params)).items()}

    model = t_params.model_from_flat(ref["flat"])
    t_config = t_loop.TrainConfig(learning_rate=3e-3)
    opt = t_loop.make_optimizer(model, t_config)
    t_stats = {k: tuple(torch.tensor(x) for x in v) for k, v in ref["stats"].items()}
    for grads in steps:
        single = t_params.from_jax_params({**ref["flat"], **grads})
        for pname, p in model.named_parameters():
            p.grad = single[pname].clone()
        t_loop.apply_update(model, opt, t_stats, t_config)
    got = t_params.to_jax_params(model.state_dict())
    assert set(got) == set(expected)
    for key in expected:
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_gradient_tolerances_cover_float32_error(jax_reference):
    """The tolerances above are at least twice float32's own error: the
    port in float32 against itself in float64 (same constants, same batch),
    on the trainable-bank model, where the frontend is least well
    conditioned."""
    ref = jax_reference["trainable_cqt"]
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = t_params.model_from_flat(ref["flat"]).to(dtype)
        batch, _ = t_loop.upload_batch(_batch(0), CPU)
        batch = {k: ({h: v.to(dtype) for h, v in x.items()} if isinstance(x, dict) else x.to(dtype)) for k, x in batch.items()}
        total, _, _ = t_loop.loss_and_stats(model, batch, t_loop.TrainConfig())
        total.backward()
        grads[dtype] = {n: p.grad.double() for n, p in model.named_parameters()}
    frontend = {"cqt.kernel_matrix", "bn_cqt.weight", "bn_cqt.bias", "contour_conv.weight", "onset_conv.weight"}
    errors = {}
    for name, g64 in grads[torch.float64].items():
        if name in ("contour_conv.bias", "onset_conv.bias"):  # zero in exact arithmetic
            continue
        errors[name] = float((grads[torch.float32][name] - g64).abs().max() / g64.abs().max())
        assert errors[name] <= (FRONTEND_GRAD_RTOL if name in frontend else GRAD_RTOL) / 2, (name, errors[name])
    assert max(errors[n] for n in frontend) > 1e-4  # the frontend really is ill-conditioned


def test_full_width_step_matches_jax(nmp_params):
    """One full-width step from the shipped weights at batch 2: the loss
    within 1e-5 relative and every gradient within 1e-3 of its tensor's
    largest."""
    batch = _batch(3)
    (loss, _), grads = jax.jit(jax.value_and_grad(_jax_loss_fn(j_nmp.DEFAULT_CONFIG, batch), has_aux=True))(nmp_params)
    model = t_params.model_from_flat(t_params.load_flat())
    assert model.config == t_nmp.DEFAULT_CONFIG
    tb, _ = t_loop.upload_batch(batch, CPU)
    total, _, _ = t_loop.loss_and_stats(model, tb, t_loop.TrainConfig())
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss), rtol=1e-5)
    _assert_grads_close(
        _grads_as_flat(model), {k: np.asarray(v) for k, v in j_params.flatten_params(jax.device_get(grads)).items()}
    )


def test_eval_step_matches_jax(jax_reference):
    """Eval-mode batch norm (moving stats), float32: the validation losses
    within 1e-5 relative of the JAX eval step."""
    ref = jax_reference["default"]
    batch = _batch(4)
    j_metrics = j_loop.build_eval_step(j_loop.TrainConfig(), ref["config"])(ref["tree"], batch)
    model = t_params.model_from_flat(ref["flat"])
    tb, _ = t_loop.upload_batch(batch, CPU)
    t_metrics = t_loop.eval_step(model, tb, t_loop.TrainConfig())
    assert set(t_metrics) == set(j_metrics)
    for key in j_metrics:
        np.testing.assert_allclose(float(t_metrics[key]), float(j_metrics[key]), rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# init and constraint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_follows_variance_scaling(name):
    """Keras VarianceScaling(2, fan_avg, uniform): every kernel inside its
    limit with the uniform's spread; zero biases, identity batch norm, the
    analytic bank; the same generator seed gives the same model."""
    config = t_nmp.ModelConfig(**CONFIGS[name])
    model = t_nmp.init_params(t_nmp.NMP(config), torch.Generator().manual_seed(5))
    j_flat = _jax_flat(name)
    for layer in t_nmp.CONV_NAMES:
        w = getattr(model, layer).weight.detach().numpy()
        assert w.transpose(2, 3, 1, 0).shape == j_flat[f"{layer}/w"].shape, layer
        cout, cin, kh, kw = w.shape
        limit = np.sqrt(3.0 * 2.0 / ((cin * kh * kw + cout * kh * kw) / 2.0))
        assert np.abs(w).max() <= limit
        if w.size >= 100:
            assert 0.5 * limit < np.abs(w).max() and abs(w.std() - limit / np.sqrt(3)) < 0.25 * limit, layer
        assert not getattr(model, layer).bias.detach().any()
    for layer in t_nmp.BN_NAMES:
        bn = getattr(model, layer)
        assert (bn.weight == 1).all() and (bn.bias == 0).all() and (bn.running_mean == 0).all() and (bn.running_var == 1).all()
    if config.trainable_cqt:
        np.testing.assert_array_equal(
            model.cqt.kernel_matrix.detach().numpy(), j_nmp.cqt_kernels_for(2).top_octave_kernels.T
        )
    again = t_nmp.init_params(t_nmp.NMP(config), torch.Generator().manual_seed(5))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["no_contours", "trainable_cqt"])
def test_unit_norm_constraint_matches_jax(name):
    rng = np.random.RandomState(7)
    flat = {k: (v * (1 + rng.rand(*v.shape))).astype(np.float32) for k, v in _jax_flat(name).items()}
    expected = j_params.flatten_params(jax.device_get(j_nmp.apply_unit_norm_constraint(_jax_tree(flat))))
    model = t_params.model_from_flat(flat)
    t_nmp.apply_unit_norm_constraint(model)
    got = t_params.to_jax_params(model.state_dict())
    for key, value in expected.items():
        np.testing.assert_allclose(got[key], np.asarray(value), rtol=1e-6, atol=1e-7, err_msg=key)


# ---------------------------------------------------------------------------
# batches: sparse materialization, wire trim, stacking
# ---------------------------------------------------------------------------


def _annotation_like_windows(rng, n=3, pcm16_audio=True):
    """Window dicts with sparse targets of a few hundred nonzeros each."""

    def sparse(bins, nnz):
        m = np.zeros((172, bins), np.float32)
        m[rng.randint(0, 172, nnz), rng.randint(0, bins, nnz)] = rng.rand(nnz).astype(np.float32) * 0.9 + 0.1
        return m

    windows = []
    for _ in range(n):
        pcm = rng.randint(-32768, 32768, constants.AUDIO_N_SAMPLES)
        audio = pcm.astype(np.float32) / 32768.0 if pcm16_audio else rng.randn(constants.AUDIO_N_SAMPLES).astype(np.float32)
        windows.append({
            "audio": audio.astype(np.float32),
            "targets": {"onset": sparse(88, rng.randint(1, 40)), "note": sparse(88, rng.randint(50, 400)),
                        "contour": sparse(264, rng.randint(100, 900))},
            "weights": {k: 1.0 for k in ("onset", "note", "contour")},
        })
    return windows


@pytest.mark.parametrize("trim", [False, True])
def test_materialize_sparse_equals_dense_and_jax(trim):
    """A sparse batch (int16 audio, COO targets) materialized on the device
    equals the dense collate bit for bit, and JAX's `materialize_batch`;
    wire-trimmed targets re-pad to the cap on upload, unchanged."""
    windows = _annotation_like_windows(np.random.RandomState(3))
    dense = t_loader._collate(windows)
    sparse = t_loader._collate_device(windows)
    assert sparse["audio"].dtype == np.int16
    wire = t_loop._trim_sparse_for_wire(sparse) if trim else sparse
    if trim:
        for head, sp in wire["targets_sparse"].items():
            assert sp["idx"].shape[1] < sparse["targets_sparse"][head]["idx"].shape[1]
    assert t_loop.needs_upload(wire)
    dev, nbytes = t_loop.upload_batch(wire, CPU)
    assert not t_loop.needs_upload(dev)
    assert nbytes == sum(x.nbytes for x in t_loop._leaves(wire) if isinstance(x, np.ndarray))
    for head, sp in dev["targets_sparse"].items():
        assert sp["idx"].shape == sparse["targets_sparse"][head]["idx"].shape
    mat = t_loop.materialize_batch(dev)
    j_mat = jax.jit(j_loop.materialize_batch)(jax.tree_util.tree_map(jnp.asarray, j_loader._collate_device(windows)))
    np.testing.assert_array_equal(mat["audio"].numpy(), dense["audio"])
    np.testing.assert_array_equal(mat["audio"].numpy(), np.asarray(j_mat["audio"]))
    for head in ("onset", "note", "contour"):
        np.testing.assert_array_equal(mat["targets"][head].numpy(), dense["targets"][head])
        np.testing.assert_array_equal(mat["targets"][head].numpy(), np.asarray(j_mat["targets"][head]))
        np.testing.assert_array_equal(mat["weights"][head].numpy(), dense["weights"][head])
    # a dense float32 batch passes through untouched
    plain, _ = t_loop.upload_batch(dense, CPU)
    assert t_loop.materialize_batch(plain) is plain


def test_wire_trim_matches_jax():
    windows = _annotation_like_windows(np.random.RandomState(8), n=2)
    sparse = t_loader._collate_device(windows)
    a, b = t_loop._trim_sparse_for_wire(sparse), j_loop._trim_sparse_for_wire(sparse)
    for head in b["targets_sparse"]:
        for field in ("idx", "val"):
            np.testing.assert_array_equal(a["targets_sparse"][head][field], b["targets_sparse"][head][field])
        assert a["targets_sparse"][head]["cap"] == b["targets_sparse"][head]["cap"]


def test_stack_and_group_batches_match_jax():
    rng = np.random.RandomState(2)
    batches = [t_loop._trim_sparse_for_wire(t_loader._collate_device(_annotation_like_windows(rng, n=2))) for _ in range(3)]
    a, b = t_loop.stack_batches(batches), j_loop.stack_batches(batches)
    assert t_loop.is_stacked(a) and not t_loop.is_stacked(batches[0])
    np.testing.assert_array_equal(a["audio"], b["audio"])
    for head in b["targets_sparse"]:
        assert a["targets_sparse"][head].keys() == b["targets_sparse"][head].keys()
        for field in ("idx", "val"):
            np.testing.assert_array_equal(a["targets_sparse"][head][field], b["targets_sparse"][head][field])
    groups = list(t_loop.grouped_batches(iter(batches + batches[:1]), 2))
    assert len(groups) == 2 and groups[0]["audio"].shape[:2] == (2, 2)


@pytest.mark.parametrize("sparse", [False, True])
def test_multi_step_equals_sequential_steps(sparse):
    """k steps over a stacked batch in one call equal k sequential steps
    (same losses, same parameters, same Adam state), bit for bit."""
    rng = np.random.RandomState(0)
    windows = [_annotation_like_windows(rng, n=2) for _ in range(3)]
    collate = t_loader._collate_device if sparse else t_loader._collate
    batches = [collate(w) for w in windows]
    config = t_loop.TrainConfig(learning_rate=1e-3)
    flat = _jax_flat("default")

    seq_model = t_params.model_from_flat(flat)
    seq_opt = t_loop.make_optimizer(seq_model, config)
    seq_losses = [float(t_loop.train_step(seq_model, seq_opt, t_loop.upload_batch(b, CPU)[0], config)["loss"]) for b in batches]

    multi_model = t_params.model_from_flat(flat)
    multi_opt = t_loop.make_optimizer(multi_model, config)
    stacked, _ = t_loop.upload_batch(t_loop.stack_batches(batches), CPU)
    metrics = t_loop.multi_step(multi_model, multi_opt, stacked, config)
    assert metrics["loss"].shape == (3,)
    np.testing.assert_array_equal(metrics["loss"].numpy(), np.asarray(seq_losses, np.float32))
    for (ka, a), (kb, b) in zip(seq_model.state_dict().items(), multi_model.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    for state_a, state_b in zip(seq_opt.state.values(), multi_opt.state.values()):
        for key in state_a:
            assert torch.equal(state_a[key], state_b[key]), key


def _walk_windows(rng, n=3):
    """Windows of compressible PCM16 (a random walk; uniform noise rightly
    stays raw), as tests/test_train.py's codec test makes them."""
    windows = _annotation_like_windows(rng, n=n)
    for w in windows:
        walk = np.cumsum(rng.randint(-300, 300, constants.AUDIO_N_SAMPLES))
        w["audio"] = np.clip(walk, -32768, 32767).astype(np.int16).astype(np.float32) / np.float32(32768.0)
    return windows


def test_codec_batch_equals_raw_batch_and_jax():
    """`pack_batch_audio` + `upload_batch` on the codec: the device batch
    equals the raw path's bit for bit, the sparse targets ride wire-trimmed,
    the bytes counted are the packed ones, and the JAX package packs the same
    batch to the same wire (tests/test_train.py:405-437 there)."""
    windows = _walk_windows(np.random.RandomState(5))
    dense = t_loader._collate(windows)
    device = t_loader._collate_device(windows)
    packed = t_loop.pack_batch_audio(device, pcm_transport="codec")
    assert "audio_packed" in packed and "audio" not in packed and t_loop.needs_upload(packed)
    ref = j_loop.pack_batch_audio(device, pcm_transport="codec")
    np.testing.assert_array_equal(packed["audio_packed"][0].words, ref["audio_packed"][0].words)
    assert packed["audio_packed"][1] == ref["audio_packed"][1]
    for head, sp in packed["targets_sparse"].items():
        assert sp["idx"].shape[1] <= device["targets_sparse"][head]["idx"].shape[1]
    dev_batch, nbytes = t_loop.upload_batch(packed, CPU)
    expected = packed["audio_packed"][0].packed_bytes + sum(
        x.nbytes for k, v in packed.items() if k != "audio_packed" for x in t_loop._leaves(v) if isinstance(x, np.ndarray)
    )
    assert nbytes == expected and nbytes < 0.6 * sum(x.nbytes for x in t_loop._leaves(device))
    mat = t_loop.materialize_batch(dev_batch)
    raw = t_loop.materialize_batch(t_loop.upload_batch(device, CPU)[0])
    assert mat["audio"].dtype == torch.float32 and torch.equal(mat["audio"], raw["audio"])
    np.testing.assert_array_equal(mat["audio"].numpy(), dense["audio"])
    for head in ("onset", "note", "contour"):
        assert torch.equal(mat["targets"][head], raw["targets"][head])
    # "raw" passes the audio through; "auto" measures (raw on this CPU, where
    # a host copy is far cheaper than packing)
    assert "audio" in t_loop.pack_batch_audio(device, pcm_transport="raw")
    with pytest.raises(ValueError, match="pcm_transport"):
        t_loop.pack_batch_audio(device, pcm_transport="zip")
    wired = list(t_loop.packed_batches(iter([device, device]), "codec", CPU))
    assert len(wired) == 2 and all("audio_packed" in b for b in wired)


def test_train_step_on_codec_batch_equals_raw():
    """A step on the codec batch equals one on the raw batch bit for bit, and
    a stacked group packs after stacking (tests/test_train.py:559 there)."""
    rng = np.random.RandomState(6)
    batches = [t_loader._collate_device(_walk_windows(rng, n=2)) for _ in range(2)]
    config = t_loop.TrainConfig(learning_rate=1e-3)
    flat = _jax_flat("default")
    results = []
    for wire in (batches[0], t_loop.pack_batch_audio(batches[0], "codec")):
        model = t_params.model_from_flat(flat)
        loss = t_loop.train_step(model, t_loop.make_optimizer(model, config), t_loop.upload_batch(wire, CPU)[0], config)["loss"]
        results.append((float(loss), model.state_dict()))
    assert results[0][0] == results[1][0]
    for key, value in results[0][1].items():
        assert torch.equal(value, results[1][1][key]), key

    stacked = t_loop.pack_batch_audio(t_loop.stack_batches(batches), "codec")
    assert t_loop.is_stacked(stacked) and stacked["audio_packed"][1][0] == 2
    with pytest.raises(ValueError, match="stack before"):
        t_loop.stack_batches([t_loop.pack_batch_audio(b, "codec") for b in batches])
    seq_model = t_params.model_from_flat(flat)
    seq_opt = t_loop.make_optimizer(seq_model, config)
    seq = [float(t_loop.train_step(seq_model, seq_opt, t_loop.upload_batch(b, CPU)[0], config)["loss"]) for b in batches]
    model = t_params.model_from_flat(flat)
    metrics = t_loop.multi_step(model, t_loop.make_optimizer(model, config), t_loop.upload_batch(stacked, CPU)[0], config)
    np.testing.assert_array_equal(metrics["loss"].numpy(), np.asarray(seq, np.float32))


# ---------------------------------------------------------------------------
# schedulers, precision, state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedulers_follow_jax(seed):
    """ReduceLROnPlateau and EarlyStopping against the JAX classes on seeded
    loss sequences (plateaus, sub-min_delta wobbles, improvements)."""
    rng = np.random.RandomState(seed)
    seq = np.round(np.cumsum(rng.choice([-0.1, 0.0, 0.00005, 0.02], size=60)) + 5.0, 6)
    kw = dict(factor=0.5, patience=int(rng.randint(1, 5)), min_delta=1e-4, cooldown=int(rng.randint(0, 3)), min_lr=1e-5)
    tp, jp = t_loop.ReduceLROnPlateau(**kw), j_loop.ReduceLROnPlateau(**kw)
    te, je = t_loop.EarlyStopping(patience=4), j_loop.EarlyStopping(patience=4)
    lr_t = lr_j = 1e-3
    for v in seq:
        (lr_t, rt), (lr_j, rj) = tp.step(float(v), lr_t), jp.step(float(v), lr_j)
        assert (lr_t, rt) == (lr_j, rj)
        assert te.step(float(v)) == je.step(float(v))
        assert tp.state() == jp.state() and te.state() == je.state()
    restored = t_loop.ReduceLROnPlateau(**kw)
    restored.load_state(tp.state())
    assert restored.state() == tp.state()


@pytest.mark.parametrize("precision", t_loop.TRAIN_PRECISIONS)
def test_precision_knob_runs_lowers_loss_and_restores_tf32(precision, monkeypatch):
    """Each precision runs four steps on one batch and lowers the loss; the
    TF32 flags come back as they were (pinned off by the transcriber, left
    on when the caller had them on)."""
    batch, _ = t_loop.upload_batch(_batch(5), CPU)
    config = t_loop.TrainConfig(learning_rate=5e-3, precision=precision)
    model = t_nmp.init_params(t_nmp.NMP(t_nmp.ModelConfig(**NARROW)), torch.Generator().manual_seed(0))
    opt = t_loop.make_optimizer(model, config)
    for before in (False, True):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before)
        seen = []

        def spy(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return real(*args, **kwargs)

        real = t_loop.loss_and_stats
        monkeypatch.setattr(t_loop, "loss_and_stats", spy)
        losses = [float(t_loop.train_step(model, opt, batch, config)["loss"]) for _ in range(2)]
        monkeypatch.setattr(t_loop, "loss_and_stats", real)
        assert seen == [(precision == "high",) * 2] * 2
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (before, before)
        assert all(np.isfinite(losses))
        if not before:
            first = losses[0]
    assert losses[-1] < first
    with pytest.raises(ValueError, match="precision"):
        t_loop.train_step(model, opt, batch, dataclasses.replace(config, precision="fp8"))


def test_train_state_round_trips_exactly(tmp_path):
    """`save_train_state` then `restore_train_state` into fresh objects
    gives the same parameters, BN stats, Adam moments and steps, LR and
    bookkeeping, bit for bit."""
    config = t_loop.TrainConfig(learning_rate=2e-3)
    model = t_params.model_from_flat(_jax_flat("trainable_cqt"))
    opt = t_loop.make_optimizer(model, config)
    batch, _ = t_loop.upload_batch(_batch(6), CPU)
    for _ in range(2):
        t_loop.train_step(model, opt, batch, config)
    t_loop.set_learning_rate(opt, 5e-4)
    extra = {"epoch": 3, "best_val": 0.5, "lr": 5e-4, "lr_plateau": {"best": 0.5, "wait": 1, "cooldown_counter": 0},
             "early_stop": {"best": 0.5, "wait": 2}}
    t_loop.save_train_state(tmp_path / "state.pt", model, opt, extra)
    fresh = t_params.model_from_flat(_jax_flat("trainable_cqt", seed=1))
    fresh_opt = t_loop.make_optimizer(fresh, config)
    assert t_loop.restore_train_state(tmp_path / "state.pt", fresh, fresh_opt) == extra
    for (ka, a), (kb, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    assert fresh_opt.param_groups[0]["lr"] == 5e-4
    for a, b in zip(opt.state.values(), fresh_opt.state.values()):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key
    assert not (tmp_path / "state.pt.tmp").exists()


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


def _fit_batches(n, seed):
    rng = np.random.RandomState(seed)
    return [t_loader._collate_device(_annotation_like_windows(rng, n=2)) for _ in range(n)]


def test_fit_checkpoints_load_in_jax(tmp_path):
    """`fit` writes per-epoch and best checkpoints in the JAX layout: they
    load in JAX `params.load_params`, and JAX `predict_fn` on them equals
    the port's forward within 1e-4 (the repo's model tolerance)."""
    config = t_loop.TrainConfig(epochs=2, steps_per_epoch=2, validation_steps=1, learning_rate=1e-3)
    model_config = t_nmp.ModelConfig(**dict(NARROW, trainable_cqt=True))
    val = _fit_batches(1, seed=9)
    logs = []
    best = t_loop.fit(iter(_fit_batches(4, seed=1)), itertools.cycle(val), tmp_path, config=config,
                      model_config=model_config, log=logs.append, device="cpu")
    assert len([line for line in logs if line.startswith("epoch ")]) == 2
    for path in (tmp_path / "model.best.npz", tmp_path / "checkpoints" / "model.00.npz", tmp_path / "checkpoints" / "model.01.npz"):
        assert path.exists()
    loaded = j_params.load_params(tmp_path / "model.best.npz")
    assert set(j_params.flatten_params(loaded)) == set(best)
    audio = _batch(7)["audio"]
    ref = j_nmp.predict_fn(loaded, jnp.asarray(audio), j_nmp.ModelConfig(**dict(NARROW, trainable_cqt=True)))
    model = t_params.model_from_flat(t_params.load_flat(tmp_path / "model.best.npz"))
    assert model.config == model_config
    with torch.no_grad():
        out = model(torch.from_numpy(audio))
    for head in ("note", "onset", "contour"):
        np.testing.assert_allclose(out[head].numpy(), np.asarray(ref[head]), atol=1e-4, rtol=0, err_msg=head)
    # and a JAX checkpoint loads in the port: the JAX-initialised weights round-trip
    j_params.save_params(tmp_path / "jax.npz", _jax_tree(_jax_flat("no_contours")))
    flat = t_params.load_flat(tmp_path / "jax.npz")
    assert t_params.config_from_params(flat) == t_nmp.ModelConfig(**CONFIGS["no_contours"])
    again = t_params.to_jax_params(t_params.model_from_flat(flat).state_dict())
    for key, value in flat.items():
        np.testing.assert_array_equal(again[key], value, err_msg=key)


def test_fit_resume_continues_exactly(tmp_path):
    """A run cut after epoch 1 and resumed equals the uninterrupted run bit
    for bit (parameters, Adam moments, LR, scheduler state): the resume
    starts at the next epoch, and an LR cut made before the cut carries
    over. Zero-weight batches pin the loss, so the plateau cuts the LR."""
    batches = _fit_batches(6, seed=2)
    for b in batches[2:]:
        b["weights"] = {k: np.zeros_like(v) for k, v in b["weights"].items()}
    val = _fit_batches(1, seed=3)
    val[0]["weights"] = {k: np.zeros_like(v) for k, v in val[0]["weights"].items()}
    config = t_loop.TrainConfig(epochs=3, steps_per_epoch=2, validation_steps=1, lr_patience=1, early_stop_patience=10)
    model_config = t_nmp.ModelConfig(**NARROW)

    whole, logs_whole = tmp_path / "whole", []
    t_loop.fit(iter(batches), itertools.cycle(val), whole, config=config, model_config=model_config,
               log=logs_whole.append, device="cpu")
    cut, logs_cut = tmp_path / "cut", []
    t_loop.fit(iter(batches[:4]), itertools.cycle(val), cut, config=dataclasses.replace(config, epochs=2),
               model_config=model_config, log=logs_cut.append, device="cpu")
    logs_resumed = []
    t_loop.fit(iter(batches[4:]), itertools.cycle(val), cut, config=config, model_config=model_config,
               log=logs_resumed.append, device="cpu")
    assert any("resumed" in line and "at epoch 2" in line for line in logs_resumed)
    assert [line.split(":")[0] for line in logs_resumed if line.startswith("epoch ")] == ["epoch 2"]
    assert any("reducing learning rate" in line for line in logs_whole + logs_cut)
    a = t_params.load_flat(whole / "checkpoints" / "model.02.npz")
    b = t_params.load_flat(cut / "checkpoints" / "model.02.npz")
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    whole_state = torch.load(whole / t_loop.TRAIN_STATE_NAME, weights_only=True)
    cut_state = torch.load(cut / t_loop.TRAIN_STATE_NAME, weights_only=True)
    assert whole_state["extra"] == cut_state["extra"]
    assert whole_state["opt_state"]["param_groups"] == cut_state["opt_state"]["param_groups"]
    for sa, sb in zip(whole_state["opt_state"]["state"].values(), cut_state["opt_state"]["state"].values()):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    # the epoch lines agree too (time aside)
    strip = [line.split(" (")[0] for line in logs_whole if line.startswith("epoch ")]
    assert strip == [line.split(" (")[0] for line in logs_cut + logs_resumed if line.startswith("epoch ")]


def test_fit_grouped_batches_and_no_gpu(tmp_path, monkeypatch):
    """`fit` takes a `grouped_batches` stream (k steps per call, the epoch's
    step count intact); with no GPU and no device named it raises."""
    config = t_loop.TrainConfig(epochs=1, steps_per_epoch=4, validation_steps=1)
    logs = []
    t_loop.fit(t_loop.grouped_batches(iter(_fit_batches(4, seed=4)), 2), itertools.cycle(_fit_batches(1, seed=5)),
               tmp_path / "run", config=config, model_config=t_nmp.ModelConfig(**NARROW), log=logs.append, device="cpu")
    assert (tmp_path / "run" / "checkpoints" / "model.00.npz").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_loop.fit(iter([]), iter([]), tmp_path / "gpu", config=config)
    assert not (tmp_path / "gpu").exists()


def test_visualize_callback_writes_events(tmp_path):
    from basic_pitch_torch.train.visualize import VisualizeCallback

    def viz_iter():
        while True:
            yield _batch(8)

    model = t_nmp.init_params(t_nmp.NMP(t_nmp.ModelConfig(**NARROW)), torch.Generator().manual_seed(0))
    cb = VisualizeCallback(viz_iter(), viz_iter(), str(tmp_path), sonify=True)
    cb(0, model, {"loss": 1.0}, {"loss": 2.0})
    cb.close()
    files = list(tmp_path.glob("events.out.tfevents.*"))
    assert files and files[0].stat().st_size > 1000


def test_visualize_callback_needs_tensorboardx(monkeypatch):
    import builtins

    from basic_pitch_torch.train.visualize import VisualizeCallback

    real_import = builtins.__import__

    def no_tensorboardx(name, *args, **kwargs):
        if name.startswith("tensorboardX"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboardx)
    with pytest.raises(ImportError, match="tensorboardX is required"):
        VisualizeCallback(iter([]), iter([]), "unused")
