"""``basic-pitch-torch-export``: write a checkpoint in deployable formats.

The port's counterpart of `basic_pitch_tpu/cli/export.py`, with its flags
plus ``--device`` (``cuda`` by default; ``cpu`` only when asked for), where
the re-import check runs the port's `NMP`:

    # the shipped ICASSP-2022 checkpoint, all exportable formats
    basic-pitch-torch-export out_dir/

    # a checkpoint you trained (flat npz, or any format Model() sniffs)
    basic-pitch-torch-export out_dir/ --checkpoint runs/model.best.npz

    # only specific formats, checked on the CPU
    basic-pitch-torch-export out_dir/ --format onnx --device cpu

Formats:
  onnx        nmp.onnx — runtime-free writer (models/onnx_export.py); loads
              in onnxruntime and in the port's and the JAX package's
              readers, reference-compatible I/O names.
  savedmodel  nmp/ — TF SavedModel directory; requires tensorflow at
              export time (models/tf_export.py).
  tflite      nmp.tflite — requires tensorflow at export time.

Every export is verified before the CLI reports success: the artifact is
re-imported through the port's own readers and the posteriorgrams of the
port's NMP on --device (TF32 off) are compared against the source
checkpoint's (--verify-tolerance, default 2e-6 for weight round-trips).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

if TYPE_CHECKING:
    import torch

ALL_FORMATS = ("onnx", "savedmodel", "tflite")


def _verify(
    params: Dict[str, np.ndarray],
    reimported: Dict[str, np.ndarray],
    tolerance: float,
    label: str,
    device: "torch.device",
) -> float:
    """Max posteriorgram deviation between source and re-imported params,
    both run as the port's NMP on ``device`` in float32 with TF32 off."""
    import torch

    from basic_pitch_torch.models import nmp
    from basic_pitch_torch.models import params as params_io

    rng = np.random.default_rng(0)
    audio = torch.as_tensor(rng.standard_normal((1, 43844)) * 0.1, dtype=torch.float32, device=device)
    with torch.inference_mode(), nmp.precision_scope("highest"):
        want = params_io.model_from_flat(params).to(device).eval()(audio)
        got = params_io.model_from_flat(reimported).to(device).eval()(audio)
        worst = max(float((want[h] - got[h]).abs().max()) for h in ("note", "onset", "contour"))
    if worst > tolerance:
        raise SystemExit(f"{label}: round-trip deviation {worst:.3g} exceeds {tolerance:.3g}")
    return worst


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "basic-pitch-torch-export",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("output_dir", type=pathlib.Path, help="directory for the artifacts")
    parser.add_argument(
        "--checkpoint",
        default=None,
        help="checkpoint to export: flat .npz (models/params.py) or any format "
        "the port's Model() loader sniffs; default = the shipped ICASSP-2022 weights",
    )
    parser.add_argument(
        "--format",
        dest="formats",
        action="append",
        choices=ALL_FORMATS,
        help="repeatable; default = every format whose toolchain is available",
    )
    parser.add_argument(
        "--verify-tolerance",
        type=float,
        default=2e-6,
        help="max allowed posteriorgram deviation after re-importing the artifact",
    )
    parser.add_argument(
        "--no-verify", action="store_true", help="skip the re-import verification pass"
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the re-import check runs the model (default cuda; fails without a GPU)",
    )
    args = parser.parse_args(argv)

    from basic_pitch_torch import inference, pipeline
    from basic_pitch_torch.models import params as params_io

    # without a GPU, --device cuda raises here, before anything is written
    device = None if args.no_verify else pipeline.resolve_device(args.device)
    if args.checkpoint is None:
        params = params_io.load_flat()
    else:
        params = inference.Model._load_checkpoint(args.checkpoint)

    formats = args.formats or list(ALL_FORMATS)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    wrote = []

    def check(reimported: Dict[str, np.ndarray], tolerance: float, label: str) -> None:
        if not args.no_verify:
            worst = _verify(params, reimported, tolerance, label, device)
            print(f"{label}: round-trip max deviation {worst:.3g}")

    if "onnx" in formats:
        from basic_pitch_torch.models import onnx_export, onnx_import

        out = args.output_dir / "nmp.onnx"
        onnx_export.export_onnx(params, out)
        check(onnx_import.load_nmp_onnx(out), args.verify_tolerance, "onnx")
        wrote.append(out)

    tf_formats = [f for f in formats if f in ("savedmodel", "tflite")]
    if tf_formats:
        try:
            from basic_pitch_torch.models import tf_export
        except ImportError:
            tf_export = None
        if tf_export is None:
            print(
                "savedmodel/tflite export needs tensorflow; skipping "
                f"{tf_formats} (onnx export is runtime-free)",
                file=sys.stderr,
            )
            if args.formats:  # explicitly requested -> this is an error
                return 2
        else:
            if "savedmodel" in tf_formats:
                from basic_pitch_torch.models import savedmodel as savedmodel_import

                out = args.output_dir / "nmp"
                tf_export.export_savedmodel(params, out)
                check(savedmodel_import.load_nmp_savedmodel(out), args.verify_tolerance, "savedmodel")
                wrote.append(out)
            if "tflite" in tf_formats:
                from basic_pitch_torch.models import tflite_import

                out = args.output_dir / "nmp.tflite"
                tf_export.export_tflite(params, out)
                # TFLite folding is fp32 arithmetic on the weights; allow
                # a proportionally looser bound than raw weight copies
                check(tflite_import.load_nmp_tflite(out), max(args.verify_tolerance, 2e-6), "tflite")
                wrote.append(out)

    for path in wrote:
        print(f"wrote {path}")
    return 0


def console_entry_point() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    console_entry_point()
