"""PyTorch port: the ONNX writer and the torch evaluator, against the JAX
package's writer, readers and numpy evaluator.

For the same parameters the port's writer must write the JAX writer's bytes
(the batch-norm fold is float64 numpy in both), from the shipped weights and
from a fresh init with non-trivial batch-norm statistics. Re-imported
through either package's reader, the posteriorgrams stay within 2e-6 of the
source's (tests/test_export.py's gate), and the torch evaluator runs the
exported graph within 1e-4 of the JAX evaluator and of the port's `NMP`.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from basic_pitch_torch.models import nmp as t_nmp
from basic_pitch_torch.models import onnx_eval as t_eval
from basic_pitch_torch.models import onnx_export as t_export
from basic_pitch_torch.models import onnx_import as t_import
from basic_pitch_torch.models import params as t_params
from basic_pitch_tpu.models import nmp as j_nmp
from basic_pitch_tpu.models import onnx_eval as j_eval
from basic_pitch_tpu.models import onnx_export as j_export
from basic_pitch_tpu.models import onnx_import as j_import
from basic_pitch_tpu.models import params as j_params
from torch_format_helpers import HEADS, fresh_jax_params, max_diff, noise_audio, torch_forward
from torch_port_helpers import one_torch_thread  # noqa: F401

SOURCES = ("shipped", "fresh")


@pytest.fixture(scope="module")
def jax_trees(nmp_params):
    return {"shipped": nmp_params, "fresh": fresh_jax_params()}


@pytest.fixture(scope="module")
def flats(jax_trees):
    return {k: j_params.flatten_params(v) for k, v in jax_trees.items()}


@pytest.fixture(scope="module")
def exported(tmp_path_factory, flats):
    """source -> the port's nmp.onnx of it."""
    out = {}
    for source, flat in flats.items():
        out[source] = tmp_path_factory.mktemp(f"port-{source}") / "nmp.onnx"
        t_export.export_onnx(flat, out[source])
    return out


@pytest.fixture(scope="module")
def audio():
    return noise_audio(2, seed=3)


@pytest.mark.parametrize("source", SOURCES)
def test_export_is_byte_identical_to_jax(tmp_path, jax_trees, flats, exported, source):
    """The JAX writer on the JAX tree, the port's on the flat dict and on an
    `NMP` holding it: the same bytes."""
    j_export.export_onnx(jax_trees[source], tmp_path / "jax.onnx")
    t_export.export_onnx(t_params.model_from_flat(flats[source]), tmp_path / "module.onnx")
    want = (tmp_path / "jax.onnx").read_bytes()
    assert exported[source].read_bytes() == want
    assert (tmp_path / "module.onnx").read_bytes() == want
    assert len(want) > 800_000


@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("source", SOURCES)
def test_reimport_posteriorgram_parity(jax_trees, flats, exported, audio, source, reader):
    """export -> re-import through either reader -> within 2e-6 of the
    source (tests/test_export.py:46-54, :78-97)."""
    if reader == "port":
        got = torch_forward(t_import.load_nmp_onnx(exported[source]), audio)
        want = torch_forward(flats[source], audio)
    else:
        got = j_nmp.predict_fn(j_import.load_nmp_onnx(exported[source]), jnp.asarray(audio))
        want = j_nmp.predict_fn(jax_trees[source], jnp.asarray(audio))
    assert max_diff(got, want) <= 2e-6


def test_exported_io_names_match_reference_consumer(exported):
    """The reference's consumer (its inference.py:168-182) requests these
    exact names."""
    for graph in (t_eval.OnnxGraph(exported["shipped"]), j_eval.OnnxGraph(exported["shipped"])):
        assert graph.input_names == ["serving_default_input_2:0"]
        assert set(graph.output_names) == {
            "StatefulPartitionedCall:0",
            "StatefulPartitionedCall:1",
            "StatefulPartitionedCall:2",
        }


def test_torch_evaluator_parses_as_jax(exported):
    t_graph, j_graph = t_eval.OnnxGraph(exported["fresh"]), j_eval.OnnxGraph(exported["fresh"])
    assert [(n.op, n.inputs, n.outputs, n.attrs) for n in t_graph.nodes] == [
        (n.op, n.inputs, n.outputs, n.attrs) for n in j_graph.nodes
    ]
    assert set(t_graph.initializers) == set(j_graph.initializers)
    for name, arr in j_graph.initializers.items():
        assert t_graph.initializers[name].dtype == arr.dtype
        np.testing.assert_array_equal(t_graph.initializers[name], arr)


@pytest.mark.parametrize(
    "length,pad", [(171, 256), (343, 256), (5, 2), (4, 9), (1, 3), (43844, 256)]
)
def test_reflect_indices_match_numpy(length, pad):
    x = np.arange(length, dtype=np.float64)
    np.testing.assert_array_equal(x[t_export.reflect_pad_indices(length, pad)], np.pad(x, pad, mode="reflect"))
    np.testing.assert_array_equal(t_export.reflect_pad_indices(length, pad), j_export.reflect_pad_indices(length, pad))


@pytest.mark.parametrize("source", SOURCES)
def test_torch_evaluator_runs_the_exported_graph(flats, exported, audio, source):
    """The graph itself (CQT cascade included) on the CPU: within 1e-4 of
    the JAX numpy evaluator on the same file and audio, and of the port's
    NMP (the JAX bound, tests/test_export.py:56-64)."""
    got = {k: v.numpy() for k, v in t_eval.run_model(exported[source], audio, device="cpu").items()}
    assert got["contour"].shape == (2, 172, 264)
    assert got["note"].shape == got["onset"].shape == (2, 172, 88)
    assert max_diff(got, j_eval.run_model(exported[source], audio)) < 1e-4
    assert max_diff(got, torch_forward(flats[source], audio)) < 1e-4


def test_torch_evaluator_on_silence_is_finite(exported):
    """A silent window's normalized log divides 0 by 0; the graph's Where
    masks it, as in the JAX evaluator."""
    silent = np.zeros((1, 43844), np.float32)
    got = t_eval.run_model(t_eval.OnnxGraph(exported["shipped"]), silent, device="cpu")
    want = j_eval.run_model(exported["shipped"], silent)
    for head in HEADS:
        assert bool(got[head].isfinite().all())
        np.testing.assert_allclose(got[head].numpy(), want[head], atol=1e-4, rtol=0, err_msg=head)


def test_export_refuses_what_the_jax_writer_refuses(tmp_path):
    config = t_nmp.ModelConfig(no_contours=True)
    flat = t_params.to_jax_params(t_nmp.NMP(config).state_dict())
    with pytest.raises(ValueError, match="contours"):
        t_export.export_onnx(flat, tmp_path / "x.onnx")
    with pytest.raises(ValueError, match="contours"):
        t_export.export_onnx(t_nmp.NMP(config), tmp_path / "x.onnx")
