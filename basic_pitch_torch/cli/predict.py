"""``basic-pitch-torch`` command-line interface: audio files to MIDI.

The flags of `basic_pitch_tpu/cli/predict.py`, plus ``--device`` (``cuda``
by default; ``cpu`` only when asked for). ``--model-path`` takes any
serialization `inference.Model` sniffs; ``--model-serialization`` picks the
ICASSP-2022 checkpoint in one of the reference's serializations
(`basic_pitch_torch.build_icassp_2022_model_path`).
"""

from __future__ import annotations

import argparse
import pathlib
import traceback
from typing import List, Optional

from basic_pitch_torch.models.params import ICASSP_2022_WEIGHTS_PATH


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Predict MIDI from audio with the PyTorch basic-pitch model on an NVIDIA GPU."
    )
    parser.add_argument("output_dir", type=str, help="directory for output files")
    parser.add_argument("audio_paths", type=str, nargs="+", help="audio files to transcribe")
    parser.add_argument(
        "--model-path",
        type=str,
        default=str(ICASSP_2022_WEIGHTS_PATH),
        help="checkpoint to use: a flat-npz parameter archive, a TF SavedModel "
        "directory, an .onnx, a .tflite or a CoreML .mlpackage (each read without "
        "its runtime)",
    )
    parser.add_argument(
        "--model-serialization",
        type=str,
        choices=["tf", "coreml", "tflite", "onnx"],
        help="If used, --model-path is ignored and the checkpoint for this "
        "serialization is resolved instead ('tf' = the bundled npz weights; "
        "coreml/tflite/onnx resolve through BASIC_PITCH_SAVED_MODELS or an "
        "installed reference basic_pitch). Every format loads through the "
        "port's own readers",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the model and the note decode run (default cuda; fails without a GPU)",
    )
    parser.add_argument(
        "--streaming",
        action="store_true",
        help="batched path: every input file through one StreamingTranscriber, "
        "with the note decode on the device",
    )
    parser.add_argument("--save-midi", action="store_true", default=True, help=argparse.SUPPRESS)
    parser.add_argument("--no-save-midi", dest="save_midi", action="store_false", help="do not save midi")
    parser.add_argument("--sonify-midi", action="store_true", help="render the MIDI to a WAV file")
    parser.add_argument("--save-model-outputs", action="store_true", help="save posteriorgrams as NPZ")
    parser.add_argument("--save-note-events", action="store_true", help="save note events as CSV")
    parser.add_argument("--onset-threshold", type=float, default=0.5,
                        help="onset activation threshold in [0, 1]; higher = fewer notes")
    parser.add_argument("--frame-threshold", type=float, default=0.3,
                        help="frame activation threshold in [0, 1]; higher = shorter notes")
    parser.add_argument("--minimum-note-length", type=float, default=127.70,
                        help="minimum note length in milliseconds")
    parser.add_argument("--minimum-frequency", type=float, default=None, help="minimum output frequency (Hz)")
    parser.add_argument("--maximum-frequency", type=float, default=None, help="maximum output frequency (Hz)")
    parser.add_argument("--multiple-pitch-bends", action="store_true",
                        help="allow overlapping notes to have independent pitch bends (one instrument per pitch)")
    parser.add_argument("--no-melodia", dest="melodia_trick", action="store_false",
                        help="disable the melodia residual-energy post-processing")
    parser.add_argument("--sonification-samplerate", type=int, default=44100,
                        help="sample rate for MIDI sonification")
    parser.add_argument("--midi-tempo", type=float, default=120, help="MIDI file tempo (BPM)")
    parser.add_argument("--debug-file", type=pathlib.Path, default=None,
                        help="dump intermediate inference data to this JSON file")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.streaming and args.debug_file:
        parser.error("--debug-file is only supported without --streaming")

    from basic_pitch_torch import FilenameSuffix, build_icassp_2022_model_path
    from basic_pitch_torch import inference, pipeline

    model_path = args.model_path
    if args.model_serialization:
        model_path = build_icassp_2022_model_path(FilenameSuffix[args.model_serialization])

    inference.verify_output_dir(args.output_dir)
    for audio_path in args.audio_paths:
        inference.verify_input_path(audio_path)
    # without a GPU, --device cuda raises here, before anything runs
    device = pipeline.resolve_device(args.device)

    print(
        "\n✨✨✨✨✨✨✨✨✨✨✨\n"
        "✨ basic-pitch-torch ✨\n"
        "✨✨✨✨✨✨✨✨✨✨✨\n"
    )

    # IOError prints its message; anything else prints a banner and the
    # traceback, never a bare crash
    try:
        if args.streaming:
            inference.predict_and_save_streaming(
                args.audio_paths,
                args.output_dir,
                args.save_midi,
                args.sonify_midi,
                args.save_model_outputs,
                args.save_note_events,
                model_path,
                args.onset_threshold,
                args.frame_threshold,
                args.minimum_note_length,
                args.minimum_frequency,
                args.maximum_frequency,
                args.multiple_pitch_bends,
                args.melodia_trick,
                args.sonification_samplerate,
                args.midi_tempo,
                device=device,
            )
        else:
            inference.predict_and_save(
                args.audio_paths,
                args.output_dir,
                args.save_midi,
                args.sonify_midi,
                args.save_model_outputs,
                args.save_note_events,
                model_path,
                args.onset_threshold,
                args.frame_threshold,
                args.minimum_note_length,
                args.minimum_frequency,
                args.maximum_frequency,
                args.multiple_pitch_bends,
                args.melodia_trick,
                args.debug_file,
                args.sonification_samplerate,
                args.midi_tempo,
                device=device,
            )
        print("\n✨ Done ✨\n")
    except IOError as ioe:
        print(ioe)
    except Exception as e:
        print("🚨 Something went wrong 😔 - see the traceback below for details.")
        print("")
        print(e)
        print(traceback.format_exc())


if __name__ == "__main__":
    main()
