"""PyTorch port: the model-format readers, `inference.Model`'s sniffing, the
model-path selector and the readers' error paths, against the JAX package.

ONNX files come from the JAX writer, SavedModel and TFLite files from the
JAX `tf_export` (where tensorflow imports), written once per module from the
shipped weights and from a fresh init with non-trivial batch-norm
statistics. The port's reader must return `flatten_params` of the JAX
reader's tree bit for bit; its `NMP` on those params must match JAX's
forward at the port's model tolerance (1e-4) and the unfolded checkpoint's
forward within FOLD_ATOL. No `.mlpackage` is in the repository, so CoreML
is held by a synthetic ML Program that both readers parse, and by its error
paths.
"""

import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import basic_pitch_torch as t_root
import basic_pitch_tpu as j_root
from basic_pitch_torch import inference as t_inference
from basic_pitch_torch.data import proto as t_proto
from basic_pitch_torch.models import coreml_import as t_coreml
from basic_pitch_torch.models import onnx_export as t_onnx_export
from basic_pitch_torch.models import onnx_import as t_onnx
from basic_pitch_torch.models import params as t_params
from basic_pitch_torch.models import savedmodel as t_sm
from basic_pitch_torch.models import tflite_import as t_tflite
from basic_pitch_tpu.models import coreml_import as j_coreml
from basic_pitch_tpu.models import nmp as j_nmp
from basic_pitch_tpu.models import onnx_export as j_onnx_export
from basic_pitch_tpu.models import onnx_import as j_onnx
from basic_pitch_tpu.models import params as j_params
from basic_pitch_tpu.models import savedmodel as j_sm
from basic_pitch_tpu.models import tflite_import as j_tflite
from torch_format_helpers import FOLD_ATOL, HEADS, assert_flat_equal, fresh_jax_params, max_diff, noise_audio, torch_forward
from torch_port_helpers import SR, assert_events_agree, one_torch_thread, tone_mix  # noqa: F401

FORMATS = ("onnx", "savedmodel", "tflite")
FILENAMES = {"onnx": "nmp.onnx", "savedmodel": "nmp", "tflite": "nmp.tflite"}
J_READERS = {"onnx": j_onnx.load_nmp_onnx, "savedmodel": j_sm.load_nmp_savedmodel, "tflite": j_tflite.load_nmp_tflite}
T_READERS = {"onnx": t_onnx.load_nmp_onnx, "savedmodel": t_sm.load_nmp_savedmodel, "tflite": t_tflite.load_nmp_tflite}


@pytest.fixture(scope="module")
def sources(nmp_params):
    return {"shipped": nmp_params, "fresh": fresh_jax_params()}


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory, sources):
    """(format, source) -> a file the JAX package wrote, made on first use."""
    made = {}

    def get(fmt, source):
        if (fmt, source) not in made:
            path = tmp_path_factory.mktemp(f"{fmt}-{source}") / FILENAMES[fmt]
            if fmt == "onnx":
                j_onnx_export.export_onnx(sources[source], path)
            else:
                pytest.importorskip("tensorflow")
                from basic_pitch_tpu.models import tf_export

                writer = tf_export.export_savedmodel if fmt == "savedmodel" else tf_export.export_tflite
                writer(sources[source], path)
            made[(fmt, source)] = path
        return made[(fmt, source)]

    return get


@pytest.fixture(scope="module")
def jax_forward():
    return jax.jit(j_nmp.predict_fn)


@pytest.mark.parametrize("source", ["shipped", "fresh"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_reader_equals_jax_reader(jax_file, fmt, source):
    path = jax_file(fmt, source)
    assert_flat_equal(T_READERS[fmt](path), j_params.flatten_params(J_READERS[fmt](path)))


@pytest.mark.parametrize("source", ["shipped", "fresh"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_forward_matches_jax_and_unfolded_model(jax_file, jax_forward, sources, fmt, source):
    path = jax_file(fmt, source)
    audio = noise_audio(2, seed=7)
    got = torch_forward(T_READERS[fmt](path), audio)
    want = jax_forward(J_READERS[fmt](path), jnp.asarray(audio))
    for head in HEADS:
        np.testing.assert_allclose(got[head], np.asarray(want[head]), atol=1e-4, rtol=0, err_msg=head)
    unfolded = torch_forward(j_params.flatten_params(sources[source]), audio)
    assert max_diff(got, unfolded) <= FOLD_ATOL


@pytest.mark.parametrize("fmt", FORMATS + ("npz",))
def test_model_sniffs_each_format_with_golden_parity(jax_file, fmt):
    import pathlib

    path = t_params.ICASSP_2022_WEIGHTS_PATH if fmt == "npz" else jax_file(fmt, "shipped")
    model = t_inference.Model(path, device="cpu")
    want = t_params.load_flat(path) if fmt == "npz" else T_READERS[fmt](path)
    assert_flat_equal(t_params.flat_params(model.module), want)
    golden = np.load(pathlib.Path(__file__).parent / "goldens" / "random_windows.npz")
    out = model.predict(golden["audio"])
    for head in HEADS:
        np.testing.assert_allclose(out[head], golden[head], atol=1e-4, rtol=0, err_msg=head)


@pytest.mark.parametrize("fmt", FORMATS)
def test_sniffing_reads_content_not_names(jax_file, tmp_path, fmt):
    """A file renamed without its suffix is still read as its format (the
    SavedModel directory by its saved_model.pb, TFLite by its magic, ONNX
    by the ModelProto head), as in the JAX package."""
    src = jax_file(fmt, "shipped")
    dst = tmp_path / "exported"
    (shutil.copytree if fmt == "savedmodel" else shutil.copyfile)(src, dst)
    model = t_inference.Model(dst, device="cpu")
    assert_flat_equal(t_params.flat_params(model.module), T_READERS[fmt](src))
    from basic_pitch_tpu import inference as j_inference

    assert_flat_equal(t_inference.Model._load_checkpoint(dst), j_params.flatten_params(j_inference.Model._load_checkpoint(dst)))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from basic_pitch_torch.utils import audio as audio_io

    path = tmp_path_factory.mktemp("clip") / "tones.wav"
    audio_io.write_wav(path, tone_mix(seconds=4.0, seed=21), SR)
    return path


@pytest.mark.parametrize("entry", ["run_inference", "predict", "predict_and_save", "predict_and_save_streaming"])
def test_entry_points_read_every_format(jax_file, clip, tmp_path, entry):
    """Each entry point that takes a model path reads an ONNX file: its
    posteriorgrams within FOLD_ATOL of the npz model's and its events by the
    one-flip rule."""
    onnx_path = jax_file("onnx", "shipped")
    npz = t_params.ICASSP_2022_WEIGHTS_PATH
    if entry == "run_inference":
        got = t_inference.run_inference(clip, onnx_path, device="cpu")
        want = t_inference.run_inference(clip, npz, device="cpu")
        assert max_diff(got, want) <= FOLD_ATOL
        return
    if entry == "predict":
        got_out, _, got = t_inference.predict(clip, onnx_path, device="cpu")
        want_out, _, want = t_inference.predict(clip, npz, device="cpu")
        assert max_diff(got_out, want_out) <= FOLD_ATOL
        assert want
        assert_events_agree(got, want)
        return
    events = {}
    for name, path in (("onnx", onnx_path), ("npz", npz)):
        out = tmp_path / name
        out.mkdir()
        if entry == "predict_and_save":
            t_inference.predict_and_save([clip], out, False, False, True, True, path, device="cpu")
        else:
            t_inference.predict_and_save_streaming([clip], out, False, False, True, True, path, windows_per_chunk=4, device="cpu")
        rows = (out / "tones_basic_pitch.csv").read_text().splitlines()[1:]
        events[name] = [(float(r.split(",")[0]), float(r.split(",")[1]), int(r.split(",")[2])) for r in rows]
        outputs = np.load(out / "tones_basic_pitch.npz", allow_pickle=True)["basic_pitch_model_output"].item()
        events[name + "_out"] = outputs
    assert events["npz"]
    assert_events_agree(events["onnx"], events["npz"])
    assert max_diff(events["onnx_out"], events["npz_out"]) <= FOLD_ATOL


@pytest.mark.parametrize(
    "name,match", [("nmp.tflite", "TFL3 magic"), ("nmp.onnx", "GraphProto|ModelProto|Conv"), ("nmp.mlpackage", "model.mlmodel")]
)
def test_corrupt_files_raise_per_format_errors(tmp_path, name, match):
    """tests/test_savedmodel.py's corrupt-file cases: the port raises the
    JAX package's per-format error."""
    from basic_pitch_tpu import inference as j_inference

    path = tmp_path / name
    if name.endswith(".mlpackage"):
        path.mkdir()
    else:
        path.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match=match) as got:
        t_inference.Model(path, device="cpu")
    with pytest.raises(ValueError) as want:
        j_inference.Model._load_checkpoint(path)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_non_savedmodel_dir_rejected(tmp_path):
    with pytest.raises(t_sm.SavedModelFormatError, match="not a SavedModel"):
        t_sm.load_nmp_savedmodel(tmp_path)
    assert not t_sm.looks_like_savedmodel(tmp_path)
    (tmp_path / "variables").mkdir()
    (tmp_path / "variables" / "variables.index").write_bytes(b"\x00" * 64)
    (tmp_path / "saved_model.pb").write_bytes(b"")
    with pytest.raises(t_sm.SavedModelFormatError, match="bad table magic"):
        t_sm.load_nmp_savedmodel(tmp_path)


def test_build_model_path_resolves_formats(monkeypatch, tmp_path):
    """`BASIC_PITCH_SAVED_MODELS` pointed at a directory holding the port's
    exported nmp.onnx: onnx resolves there, the formats it lacks raise, and
    tf is the bundled npz; the JAX selector answers the same."""
    t_onnx_export.export_onnx(t_params.load_flat(), tmp_path / "nmp.onnx")
    monkeypatch.setenv("BASIC_PITCH_SAVED_MODELS", str(tmp_path))
    for root in (t_root, j_root):
        assert root.build_icassp_2022_model_path(root.FilenameSuffix.onnx) == tmp_path / "nmp.onnx"
        for missing in (root.FilenameSuffix.tflite, root.FilenameSuffix.coreml):
            with pytest.raises(FileNotFoundError, match="BASIC_PITCH_SAVED_MODELS"):
                root.build_icassp_2022_model_path(missing)
    tf_path = t_root.build_icassp_2022_model_path(t_root.FilenameSuffix.tf)
    assert tf_path == t_params.ICASSP_2022_WEIGHTS_PATH and tf_path.exists()
    assert tf_path.read_bytes() == j_root.build_icassp_2022_model_path(j_root.FilenameSuffix.tf).read_bytes()
    model = t_inference.Model(t_root.build_icassp_2022_model_path(t_root.FilenameSuffix.onnx), device="cpu")
    assert_flat_equal(t_params.flat_params(model.module), t_onnx.load_nmp_onnx(tmp_path / "nmp.onnx"))


def test_build_model_path_errors_without_reference(monkeypatch):
    monkeypatch.delenv("BASIC_PITCH_SAVED_MODELS", raising=False)
    monkeypatch.setattr(t_root, "_reference_saved_models_dir", lambda: None)
    with pytest.raises(FileNotFoundError, match="BASIC_PITCH_SAVED_MODELS"):
        t_root.build_icassp_2022_model_path(t_root.FilenameSuffix.onnx)


def test_onnx_tensor_parses_packed_float_data():
    """float_data is `[packed = true]` in onnx.proto: one length-delimited
    buffer (wire type 2) or per-element fixed32 records must both decode."""
    values = [1.5, -2.25, 3.0, 0.125]
    payload = b"".join(struct.pack("<f", v) for v in values)
    common = (
        t_proto._tag(1, 0) + t_proto.encode_varint(2)
        + t_proto._tag(1, 0) + t_proto.encode_varint(2)
        + t_proto._tag(2, 0) + t_proto.encode_varint(1)
        + t_proto._length_delimited(8, b"w")
    )
    packed = common + t_proto._length_delimited(4, payload)
    unpacked = common + b"".join(t_proto._tag(4, 5) + struct.pack("<f", v) for v in values)
    for buf in (packed, unpacked):
        name, dims, arr = t_onnx._tensor(buf)
        assert name == "w" and dims == (2, 2)
        np.testing.assert_array_equal(arr, np.asarray(values, np.float32).reshape(2, 2))
        assert j_onnx._tensor(buf)[:2] == (name, dims)


# --- CoreML: a synthetic ML Program and the error paths ---------------------


def _ld(field, payload):
    return t_proto._length_delimited(field, payload)


def _map_entry(field, key, value):
    return _ld(field, _ld(1, key.encode()) + _ld(2, value))


def _const(name, value):
    """A MIL const op whose Value is a blob reference (int offset) or an
    immediate packed float tensor (array)."""
    if isinstance(value, int):
        val = _ld(5, _ld(1, b"@model_path/weights/weight.bin") + t_proto._tag(2, 0) + t_proto.encode_varint(value))
    else:
        floats = _ld(1, np.asarray(value, "<f4").tobytes())
        val = _ld(3, _ld(1, _ld(1, floats)))
    return _ld(1, b"const") + _ld(3, _ld(1, name.encode())) + _map_entry(5, "val", val)


def _op(op_type, bindings):
    body = _ld(1, op_type.encode())
    for key, name in bindings.items():
        body += _map_entry(2, key, _ld(1, _ld(1, name.encode())))
    return body


def write_mlpackage(root, flat):
    """An .mlpackage whose ML Program holds the six head convs (weights in
    weight.bin, biases immediate) and the post-CQT batch_norm with a
    serialized epsilon, in the coremltools layout the readers parse."""
    data = root / "Data" / "com.apple.CoreML"
    (data / "weights").mkdir(parents=True)
    blob, ops = bytearray(64), []
    for slot, oihw in t_coreml._CONV_BY_SIZE.values():
        w = np.ascontiguousarray(flat[f"{slot}/w"].transpose(3, 2, 0, 1), "<f4")
        assert w.shape == oihw
        meta = len(blob)
        payload = meta + 64
        blob += struct.pack("<IIQQ", t_coreml._BLOB_SENTINEL, t_coreml._BLOB_DTYPE_F32, w.nbytes, payload) + bytes(40)
        blob += w.tobytes() + bytes(-w.nbytes % 64)
        ops += [_const(f"{slot}_w", meta), _const(f"{slot}_b", flat[f"{slot}/b"])]
        ops.append(_op("conv", {"x": "in", "weight": f"{slot}_w", "bias": f"{slot}_b"}))
    for field in ("gamma", "beta", "mean"):
        ops.append(_const(f"bn_{field}", flat[f"bn_cqt/{field}"]))
    ops.append(_const("bn_variance", flat["bn_cqt/var"] + np.float32(2e-3)))
    ops.append(_const("bn_eps", np.array([3e-3], np.float32)))
    ops.append(_op("batch_norm", {"x": "in", "gamma": "bn_gamma", "beta": "bn_beta", "mean": "bn_mean", "variance": "bn_variance", "epsilon": "bn_eps"}))
    block = b"".join(_ld(3, op) for op in ops)
    function = _map_entry(3, "CoreML5", block)
    program = _map_entry(2, "main", function)
    (data / "model.mlmodel").write_bytes(t_proto._tag(1, 0) + t_proto.encode_varint(8) + _ld(502, program))
    (data / "weights" / "weight.bin").write_bytes(bytes(blob))


def test_coreml_reader_equals_jax_reader_on_a_synthetic_program(tmp_path, nmp_params):
    flat = j_params.flatten_params(nmp_params)
    root = tmp_path / "nmp.mlpackage"
    write_mlpackage(root, flat)
    for path in (root, root / "Data" / "com.apple.CoreML" / "model.mlmodel"):
        got = t_coreml.load_nmp_coreml(path)
        assert_flat_equal(got, j_params.flatten_params(j_coreml.load_nmp_coreml(path)))
        assert t_coreml.looks_like_mlpackage(path) == j_coreml.looks_like_mlpackage(path)
    for slot, _ in t_coreml._CONV_BY_SIZE.values():
        np.testing.assert_array_equal(got[f"{slot}/w"], flat[f"{slot}/w"])
        np.testing.assert_array_equal(got[f"{slot}/b"], flat[f"{slot}/b"])
    model = t_inference.Model(root, device="cpu")  # sniffed by its Data/com.apple.CoreML
    assert_flat_equal(t_params.flat_params(model.module), got)


def _coreml_cases(tmp_path):
    empty = tmp_path / "empty.mlpackage"
    empty.mkdir()
    not_program = tmp_path / "plain.mlmodel"
    not_program.write_bytes(t_proto._tag(1, 0) + t_proto.encode_varint(4))
    no_convs = tmp_path / "noconv" / "model.mlmodel"
    no_convs.parent.mkdir()
    no_convs.write_bytes(_ld(502, _map_entry(2, "main", _map_entry(3, "CoreML5", _ld(3, _const("c", np.ones(3)))))))
    bad_blob = tmp_path / "badblob.mlpackage"
    flat = t_params.load_flat()
    write_mlpackage(bad_blob, flat)
    weights = bad_blob / "Data" / "com.apple.CoreML" / "weights" / "weight.bin"
    raw = bytearray(weights.read_bytes())
    raw[64:68] = b"\x00\x00\x00\x00"
    weights.write_bytes(bytes(raw))
    no_blob = tmp_path / "noblob.mlpackage"
    write_mlpackage(no_blob, flat)
    (no_blob / "Data" / "com.apple.CoreML" / "weights" / "weight.bin").unlink()
    return {
        "empty-package": (empty, "no model.mlmodel"),
        "not-an-ml-program": (not_program, "not an ML Program"),
        "no-head-convs": (no_convs, "missing conv layers"),
        "bad-blob-sentinel": (bad_blob, "bad blob sentinel"),
        "missing-weight-bin": (no_blob, "weight.bin but it is missing"),
    }


@pytest.mark.parametrize("case", ["empty-package", "not-an-ml-program", "no-head-convs", "bad-blob-sentinel", "missing-weight-bin"])
def test_coreml_error_paths_match_jax(tmp_path, case):
    path, match = _coreml_cases(tmp_path)[case]
    with pytest.raises(t_coreml.CoremlFormatError, match=match) as got:
        t_coreml.load_nmp_coreml(path)
    with pytest.raises(j_coreml.CoremlFormatError) as want:
        j_coreml.load_nmp_coreml(path)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
