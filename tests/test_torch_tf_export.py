"""PyTorch port: SavedModel and TFLite export (`models/tf_export.py`),
against the JAX package's exports of the same parameters.

The port's SavedModel and TFLite files, read by the JAX package's readers,
must give what those readers give on the JAX exports; the SavedModel holds
the unfolded parameters bit for bit, and the TFLite interpreter on the
port's file runs within 1e-4 of the port's forward. Skipped as a whole
where tensorflow does not import, as tests/test_tf_export.py is.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from basic_pitch_torch.models import params as t_params  # noqa: E402
from basic_pitch_torch.models import savedmodel as t_sm  # noqa: E402
from basic_pitch_torch.models import tf_export as t_tf  # noqa: E402
from basic_pitch_torch.models import tflite_import as t_tflite  # noqa: E402
from basic_pitch_tpu.models import params as j_params  # noqa: E402
from basic_pitch_tpu.models import savedmodel as j_sm  # noqa: E402
from basic_pitch_tpu.models import tf_export as j_tf  # noqa: E402
from basic_pitch_tpu.models import tflite_import as j_tflite  # noqa: E402
from torch_format_helpers import (  # noqa: E402
    HEADS, assert_flat_equal, fresh_jax_params, max_diff, noise_audio, torch_forward,
)
from torch_port_helpers import one_torch_thread  # noqa: E402, F401

SOURCES = ("shipped", "fresh")
OUTPUT_NAMES = {"contour": "StatefulPartitionedCall:0", "note": "StatefulPartitionedCall:1", "onset": "StatefulPartitionedCall:2"}


@pytest.fixture(scope="module")
def jax_trees(nmp_params):
    return {"shipped": nmp_params, "fresh": fresh_jax_params()}


@pytest.fixture(scope="module")
def files(tmp_path_factory, jax_trees):
    """(package, format, source) -> the exported file, each written once."""
    out = {}
    for source, tree in jax_trees.items():
        flat = j_params.flatten_params(tree)
        for package, module, params in (("port", t_tf, flat), ("jax", j_tf, tree)):
            d = tmp_path_factory.mktemp(f"{package}-{source}")
            out[(package, "savedmodel", source)] = d / "nmp"
            module.export_savedmodel(params, d / "nmp")
            out[(package, "tflite", source)] = d / "nmp.tflite"
            module.export_tflite(params, d / "nmp.tflite")
    return out


@pytest.fixture(scope="module")
def audio():
    return noise_audio(2, seed=3)


def test_tables_match_jax():
    assert t_tf._BN_MARKER == j_tf._BN_MARKER
    assert t_tf._SLOT_ORDER == j_tf._SLOT_ORDER


@pytest.mark.parametrize("source", SOURCES)
def test_savedmodel_reads_as_the_jax_export(files, jax_trees, source):
    """Read by the JAX reader, the port's SavedModel equals the JAX
    SavedModel, and both hold the source parameters bit for bit (also
    through the port's reader)."""
    port, jax_file = files[("port", "savedmodel", source)], files[("jax", "savedmodel", source)]
    got = j_params.flatten_params(j_sm.load_nmp_savedmodel(port))
    assert_flat_equal(got, j_params.flatten_params(j_sm.load_nmp_savedmodel(jax_file)))
    assert_flat_equal(t_sm.load_nmp_savedmodel(port), got)
    source_flat = {k: np.asarray(v, np.float32) for k, v in j_params.flatten_params(jax_trees[source]).items()}
    assert_flat_equal(got, source_flat)
    assert t_sm.looks_like_savedmodel(port)


@pytest.mark.parametrize("source", SOURCES)
def test_tflite_reads_as_the_jax_export(files, source):
    port, jax_file = files[("port", "tflite", source)], files[("jax", "tflite", source)]
    got = j_params.flatten_params(j_tflite.load_nmp_tflite(port))
    assert_flat_equal(got, j_params.flatten_params(j_tflite.load_nmp_tflite(jax_file)))
    assert_flat_equal(t_tflite.load_nmp_tflite(port), got)


@pytest.mark.parametrize("source", SOURCES)
def test_tflite_roundtrip_forward(files, jax_trees, audio, source):
    """tests/test_tf_export.py:81-92 and :126-160: the re-imported folded
    weights against the unfolded source, 2e-6 for the shipped weights and
    4e-6 for the fresh init's real statistics."""
    flat = j_params.flatten_params(jax_trees[source])
    got = torch_forward(t_tflite.load_nmp_tflite(files[("port", "tflite", source)]), audio)
    assert max_diff(got, torch_forward(flat, audio)) <= (2e-6 if source == "shipped" else 4e-6)


def test_tflite_interpreter_matches_port_forward(files, audio):
    """Builtin ops only: the stock interpreter runs the port's file (no flex
    delegate), with the reference's output names, within 1e-4 of the port's
    forward."""
    interp = tf.lite.Interpreter(str(files[("port", "tflite", "shipped")]))
    inp = interp.get_input_details()[0]
    interp.resize_tensor_input(inp["index"], (audio.shape[0], 43844, 1))
    interp.allocate_tensors()
    interp.set_tensor(inp["index"], audio[..., None])
    interp.invoke()
    outs = {d["name"]: interp.get_tensor(d["index"]) for d in interp.get_output_details()}
    assert set(outs) == set(OUTPUT_NAMES.values())
    want = torch_forward(t_params.load_flat(), audio)
    assert max_diff({h: outs[OUTPUT_NAMES[h]] for h in HEADS}, want) < 1e-4


def test_savedmodel_loads_and_calls_like_reference(files, audio):
    """The reference consumer calls the loaded object and reads a
    {contour, note, onset} dict (its inference.py:160-162)."""
    loaded = tf.saved_model.load(str(files[("port", "savedmodel", "shipped")]))
    out = loaded(audio[..., None])
    assert set(out) == set(HEADS)
    assert "serving_default" in loaded.signatures
    assert max_diff({h: out[h].numpy() for h in HEADS}, torch_forward(t_params.load_flat(), audio)) < 1e-4


def test_export_takes_a_module(tmp_path, files):
    """An `NMP` exports as its flat dict does."""
    module = t_params.model_from_flat(t_params.load_flat())
    t_tf.export_tflite(module, tmp_path / "nmp.tflite")
    assert (tmp_path / "nmp.tflite").read_bytes() == files[("port", "tflite", "shipped")].read_bytes()
