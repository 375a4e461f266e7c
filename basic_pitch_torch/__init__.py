"""PyTorch/CUDA port of basic_pitch_tpu: audio to posteriorgrams to note
events on an NVIDIA GPU.

The port imports nothing of the JAX package. Its entry point is
`basic_pitch_torch.pipeline.StreamingTranscriber`, which runs on ``cuda``
unless the caller passes ``device="cpu"``. Importing this package root
loads neither torch nor tensorflow: it holds the version and the
reference's model-path selector.
"""

__version__ = "0.1.0"

import enum
import os
import pathlib

# the shipped checkpoint (`models.params.ICASSP_2022_WEIGHTS_PATH`), named
# here without importing torch
ICASSP_2022_MODEL_PATH = pathlib.Path(__file__).resolve().parent / "assets" / "nmp_icassp2022.npz"


class FilenameSuffix(enum.Enum):
    """The reference's serialization selector (its `__init__.py:74-88`).

    Every reference serialization loads through `inference.Model`'s own
    format readers (`models/{savedmodel,onnx_import,tflite_import,
    coreml_import}.py`), no runtime of the format needed. ``tf`` resolves to
    the bundled flat-npz weights (the TF SavedModel's variables); the other
    suffixes resolve to a reference `saved_models/icassp_2022` directory
    when one can be found (see `build_icassp_2022_model_path`).
    """

    tf = "nmp"
    coreml = "nmp.mlpackage"
    tflite = "nmp.tflite"
    onnx = "nmp.onnx"


def _reference_saved_models_dir() -> "pathlib.Path | None":
    """Locate a reference basic-pitch `saved_models/icassp_2022` directory.

    Checks `BASIC_PITCH_SAVED_MODELS`, then an installed `basic_pitch`
    package. Returns None when neither exists.
    """
    env = os.environ.get("BASIC_PITCH_SAVED_MODELS")
    if env and pathlib.Path(env).is_dir():
        return pathlib.Path(env)
    try:
        import basic_pitch  # the reference package, if installed

        candidate = pathlib.Path(basic_pitch.__file__).parent / "saved_models" / "icassp_2022"
        if candidate.is_dir():
            return candidate
    except Exception:
        # the reference package imports TensorFlow on import; beyond
        # ImportError it can raise OSError (native libs) or RuntimeError:
        # any failure here just means "no reference checkout available"
        pass
    return None


def build_icassp_2022_model_path(suffix: FilenameSuffix) -> pathlib.Path:
    """Reference-compatible model-path resolution (its `__init__.py:91-95`).

    ``tf`` always resolves (bundled weights). The coreml/tflite/onnx
    serializations resolve to the reference package's shipped artifact when
    one can be found; all four load through `inference.Model`'s own format
    readers.
    """
    if suffix is FilenameSuffix.tf:
        return pathlib.Path(ICASSP_2022_MODEL_PATH)
    ref_dir = _reference_saved_models_dir()
    if ref_dir is not None:
        candidate = ref_dir / suffix.value
        if candidate.exists():
            return candidate
    raise FileNotFoundError(
        f"🚨 no {suffix.name} serialization of the ICASSP-2022 checkpoint is "
        "bundled with this package (only the npz weights are). Point "
        "BASIC_PITCH_SAVED_MODELS at a reference saved_models/icassp_2022 "
        f"directory, or pass any {suffix.value} path straight to "
        "Model(): its format readers load all four reference "
        "serializations without the matching runtime."
    )
