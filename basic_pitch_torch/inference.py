"""Inference orchestration: audio file -> posteriorgrams -> MIDI.

PyTorch counterpart of `basic_pitch_tpu/inference.py`: ``Model``,
``window_audio_file``, ``unwrap_output``, ``run_inference``, ``predict``,
``predict_and_save``, ``predict_and_save_streaming``, ``build_output_path``,
``OutputExtensions``.

Two paths, as in the JAX package:
  * ``predict`` / ``predict_and_save`` (windowed): a file's windows run
    through the model in power-of-two batch buckets (at most 128 windows per
    call) on the device; the posteriorgrams come back to the host, where the
    host decoder (`decode/export.model_output_to_notes`) makes the notes.
    No hand kernel runs on this path.
  * ``predict_and_save_streaming``: every file through one
    `pipeline.StreamingTranscriber.transcribe_batch`, whose note decode is
    the greedy-decode CUDA kernel on the card.

Every entry point runs on ``cuda`` unless given ``device="cpu"``; with no
GPU and no device named, it raises.
"""

from __future__ import annotations

import csv
import enum
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from basic_pitch_torch import constants
from basic_pitch_torch import pipeline
from basic_pitch_torch.decode import export as decode_export
from basic_pitch_torch.models import nmp
from basic_pitch_torch.models import params as params_io
from basic_pitch_torch.utils import audio as audio_io
from basic_pitch_torch.utils.printing import (
    failed_to_save,
    file_saved_confirmation,
    generating_file_message,
)

PathLike = Union[str, pathlib.Path]
Device = Union[str, torch.device, None]

DEFAULT_ONSET_THRESHOLD = 0.5
DEFAULT_FRAME_THRESHOLD = 0.3
DEFAULT_MINIMUM_NOTE_LENGTH_MS = 127.7
DEFAULT_MIDI_TEMPO = 120
DEFAULT_MINIMUM_MIDI_TEMPO = DEFAULT_MIDI_TEMPO
DEFAULT_SONIFICATION_SAMPLERATE = 44100
DEFAULT_OVERLAPPING_FRAMES = constants.N_OVERLAPPING_FRAMES
DEFAULT_MIDI_VELOCITY_SCALE = 127

_MAX_DEVICE_BATCH = 128  # windows per model call


class Model:
    """The NMP model on one device, with batched prediction over windows.

    Args:
        model_or_path: a flat-npz checkpoint path (the shipped ICASSP-2022
            weights by default), a flat JAX-layout parameter dict
            ({"layer/field": array}), or an `nmp.NMP` module. A checkpoint
            builds the `NMP` of its own `ModelConfig`
            (`params.config_from_params`).
        device: "cuda" (the default, which raises when there is no GPU) or
            "cpu".

    A path may hold any of the reference's serializations: a TF SavedModel
    directory, a CoreML ``.mlpackage`` / ``.mlmodel``, a ``.tflite``, an
    ``.onnx`` or the flat npz. `_load_checkpoint` sniffs them in the JAX
    package's order and reads each with its own runtime-free reader
    (`models/{savedmodel,coreml_import,tflite_import,onnx_import}.py`); a
    file that is not the expected serialization raises that reader's
    ``ValueError``. Numerics are float32: TF32 is switched off as in
    `pipeline.StreamingTranscriber`.
    """

    def __init__(
        self,
        model_or_path: "Union[PathLike, Dict[str, np.ndarray], nmp.NMP]" = params_io.ICASSP_2022_WEIGHTS_PATH,
        device: Device = None,
    ):
        self.device = pipeline.resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if isinstance(model_or_path, nmp.NMP):
            module = model_or_path
        elif isinstance(model_or_path, (dict, str, pathlib.Path)):
            flat = model_or_path if isinstance(model_or_path, dict) else self._load_checkpoint(model_or_path)
            module = params_io.model_from_flat(flat)
        else:
            raise ValueError(
                f"cannot load model from {model_or_path!r}: expected a checkpoint "
                "path (.npz, SavedModel, CoreML, TFLite or ONNX), a flat parameter "
                "dict or an nmp.NMP module"
            )
        self.module = module.to(self.device).eval()

    @staticmethod
    def _load_checkpoint(path: PathLike) -> Dict[str, np.ndarray]:
        """Format-sniffing loader over the four reference serializations and
        the flat npz, in the order of the JAX package's `Model`: SavedModel
        directory, CoreML, TFLite, ONNX, npz."""
        from basic_pitch_torch.models import coreml_import, onnx_import, savedmodel, tflite_import

        p = pathlib.Path(path)
        suffix = p.suffix.lower()
        if savedmodel.looks_like_savedmodel(p):
            return savedmodel.load_nmp_savedmodel(p)
        if suffix in (".mlpackage", ".mlmodel") or coreml_import.looks_like_mlpackage(p):
            return coreml_import.load_nmp_coreml(p)
        if suffix == ".tflite" or tflite_import.looks_like_tflite(p):
            return tflite_import.load_nmp_tflite(p)
        if suffix == ".onnx" or onnx_import.looks_like_onnx(p):
            return onnx_import.load_nmp_onnx(p)
        return params_io.load_flat(p)

    def predict(self, audio_windows: np.ndarray) -> Dict[str, np.ndarray]:
        """Run the model over (n_windows, AUDIO_N_SAMPLES [, 1]) audio.

        Pads each batch of at most 128 windows up to a power-of-two bucket,
        runs it on the device, and trims. Returns numpy arrays keyed
        "note" / "onset" / "contour".
        """
        x = np.asarray(audio_windows, dtype=np.float32)
        if x.ndim == 3:  # tolerate the reference's trailing channel dim
            x = x[..., 0]
        if x.ndim == 1:
            x = x[None]
        n = x.shape[0]
        if n == 0:  # zero windows: empty posteriorgrams, correct frame/bin dims
            t = constants.ANNOT_N_FRAMES
            return {
                "note": np.zeros((0, t, constants.N_FREQ_BINS_NOTES), np.float32),
                "onset": np.zeros((0, t, constants.N_FREQ_BINS_NOTES), np.float32),
                "contour": np.zeros((0, t, constants.N_FREQ_BINS_CONTOURS), np.float32),
            }

        chunks: List[Dict[str, np.ndarray]] = []
        with torch.inference_mode():
            for start in range(0, n, _MAX_DEVICE_BATCH):
                chunk = x[start : start + _MAX_DEVICE_BATCH]
                bucket = _bucket_size(chunk.shape[0])
                padded = np.pad(chunk, ((0, bucket - chunk.shape[0]), (0, 0)))
                out = self.module(torch.from_numpy(padded).to(self.device))
                chunks.append({k: v[: chunk.shape[0]].cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def _bucket_size(n: int) -> int:
    """Smallest power of two >= n (capped at _MAX_DEVICE_BATCH)."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return min(bucket, _MAX_DEVICE_BATCH)


def _as_model(model_or_model_path: "Union[Model, PathLike]", device: Device) -> Model:
    """A `Model` as given, or one loaded on `device`. A `Model` runs on its
    own device; naming another one is an error."""
    if not isinstance(model_or_model_path, Model):
        return Model(model_or_model_path, device=device)
    if device is not None and pipeline.resolve_device(device) != model_or_model_path.device:
        raise ValueError(f"the model is on {model_or_model_path.device}, not on {device}")
    return model_or_model_path


def window_audio_file(
    audio: np.ndarray, hop_size: int
) -> Tuple[np.ndarray, List[Dict[str, float]]]:
    """Slice (pre-padded) audio into fixed AUDIO_N_SAMPLES windows.

    Returns the stacked windows (n_windows, AUDIO_N_SAMPLES) and their
    start/end times in seconds.
    """
    n_windows = max(1, -(-len(audio) // hop_size))
    padded_len = hop_size * (n_windows - 1) + constants.AUDIO_N_SAMPLES
    padded = np.pad(audio, (0, max(0, padded_len - len(audio))))
    idx = hop_size * np.arange(n_windows)[:, None] + np.arange(constants.AUDIO_N_SAMPLES)[None, :]
    windows = padded[idx]
    times = [
        {
            "start": float(i * hop_size) / constants.AUDIO_SAMPLE_RATE,
            "end": float(i * hop_size + constants.AUDIO_N_SAMPLES) / constants.AUDIO_SAMPLE_RATE,
        }
        for i in range(n_windows)
    ]
    return windows.astype(np.float32), times


def get_audio_input(
    audio_path: PathLike, overlap_len: int, hop_size: int
) -> Tuple[np.ndarray, List[Dict[str, float]], int]:
    """Load audio (mono, 22050 Hz), pre-pad half an overlap, window it.

    Returns (windows, window_times, original_length_samples).
    """
    if overlap_len % 2 != 0:
        raise ValueError(f"overlap_length must be even, got {overlap_len}")
    audio, _ = audio_io.load_audio(audio_path, constants.AUDIO_SAMPLE_RATE)
    original_length = len(audio)
    audio = np.concatenate([np.zeros(overlap_len // 2, dtype=np.float32), audio])
    windows, times = window_audio_file(audio, hop_size)
    return windows, times, original_length


def unwrap_output(
    output: np.ndarray,
    audio_original_length: int,
    n_overlapping_frames: int,
    hop_size: Optional[int] = None,
) -> np.ndarray:
    """Overlap-trim windowed outputs back into one (n_times, n_freqs) matrix.

    Drops half the overlapping frames from each edge of every window,
    concatenates along time, and trims to the expected total length.
    """
    if output.ndim != 3:
        raise ValueError(f"expected (n_windows, n_frames, n_freqs), got {output.shape}")
    if hop_size is None:
        hop_size = constants.AUDIO_N_SAMPLES - n_overlapping_frames * constants.FFT_HOP
    n_olap = n_overlapping_frames // 2
    if n_olap > 0:
        output = output[:, n_olap:-n_olap, :]
    n_windows, n_frames, n_freqs = output.shape
    unwrapped = output.reshape(n_windows * n_frames, n_freqs)
    n_expected_windows = audio_original_length / hop_size
    frames_per_window = constants.AUDIO_WINDOW_LENGTH * constants.ANNOTATIONS_FPS - n_overlapping_frames
    return unwrapped[: int(n_expected_windows * frames_per_window), :]


def run_inference(
    audio_path: PathLike,
    model_or_model_path: Union[Model, PathLike],
    debug_file: Optional[pathlib.Path] = None,
    device: Device = None,
) -> Dict[str, np.ndarray]:
    """File -> full-length posteriorgrams."""
    model = _as_model(model_or_model_path, device)

    n_overlapping_frames = DEFAULT_OVERLAPPING_FRAMES
    overlap_len = n_overlapping_frames * constants.FFT_HOP
    hop_size = constants.AUDIO_N_SAMPLES - overlap_len

    windows, _, original_length = get_audio_input(audio_path, overlap_len, hop_size)
    raw = model.predict(windows)
    unwrapped = {
        k: unwrap_output(raw[k], original_length, n_overlapping_frames, hop_size) for k in raw
    }

    if debug_file:
        with open(debug_file, "w") as fh:
            json.dump(
                {
                    # only the last (1, samples, 1) window, as the reference
                    # dumps its loop variable after the window loop
                    "audio_windowed": windows[-1:, :, None].tolist(),
                    "audio_original_length": original_length,
                    "hop_size_samples": hop_size,
                    "overlap_length_samples": overlap_len,
                    "unwrapped_output": {k: v.tolist() for k, v in unwrapped.items()},
                },
                fh,
            )
    return unwrapped


class OutputExtensions(enum.Enum):
    MIDI = "mid"
    MODEL_OUTPUT_NPZ = "npz"
    MIDI_SONIFICATION = "wav"
    NOTE_EVENTS = "csv"


def verify_input_path(audio_path: PathLike) -> None:
    path = pathlib.Path(audio_path)
    if not path.exists():
        raise ValueError(f"🚨 {audio_path} does not exist.")
    if not path.is_file():
        raise ValueError(f"🚨 {audio_path} is not a file path.")


def verify_output_dir(output_dir: PathLike) -> None:
    path = pathlib.Path(output_dir)
    if not path.exists():
        raise ValueError(f"🚨 {output_dir} does not exist.")
    if not path.is_dir():
        raise ValueError(f"🚨 {output_dir} is not a directory.")


def build_output_path(
    audio_path: PathLike, output_directory: PathLike, output_type: OutputExtensions
) -> pathlib.Path:
    """Derive <output_dir>/<stem>_basic_pitch.<ext>, refusing collisions."""
    output_directory = pathlib.Path(output_directory)
    basename = pathlib.Path(str(audio_path)).stem
    output_path = output_directory / f"{basename}_basic_pitch.{output_type.value}"
    generating_file_message(output_type.name)
    if output_path.exists():
        raise IOError(
            f"  🚨 {output_path} already exists and would be overwritten. "
            f"Skipping output files for {audio_path}."
        )
    return output_path


def save_note_events(
    note_events: List[Tuple[float, float, int, float, Optional[List[int]]]],
    save_path: PathLike,
) -> None:
    """CSV export with velocity scaling."""
    with open(save_path, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter=",")
        writer.writerow(["start_time_s", "end_time_s", "pitch_midi", "velocity", "pitch_bend"])
        for start_time, end_time, pitch, amplitude, bends in note_events:
            row = [start_time, end_time, pitch, int(np.round(DEFAULT_MIDI_VELOCITY_SCALE * amplitude))]
            if bends:
                row.extend(bends)
            writer.writerow(row)


def _min_note_frames(minimum_note_length_ms: float) -> int:
    return int(np.round(minimum_note_length_ms / 1000 * (constants.AUDIO_SAMPLE_RATE / constants.FFT_HOP)))


def predict(
    audio_path: PathLike,
    model_or_model_path: Union[Model, PathLike] = params_io.ICASSP_2022_WEIGHTS_PATH,
    onset_threshold: float = DEFAULT_ONSET_THRESHOLD,
    frame_threshold: float = DEFAULT_FRAME_THRESHOLD,
    minimum_note_length: float = DEFAULT_MINIMUM_NOTE_LENGTH_MS,
    minimum_frequency: Optional[float] = None,
    maximum_frequency: Optional[float] = None,
    multiple_pitch_bends: bool = False,
    melodia_trick: bool = True,
    debug_file: Optional[pathlib.Path] = None,
    midi_tempo: float = DEFAULT_MIDI_TEMPO,
    device: Device = None,
) -> "Tuple[Dict[str, np.ndarray], object, list]":
    """Transcribe one audio file: the model on the device, then the host
    decoder. Returns (model_output, MidiFile, note_events)."""
    print(f"Predicting MIDI for {audio_path}...")

    model_output = run_inference(audio_path, model_or_model_path, debug_file, device)
    min_note_len = _min_note_frames(minimum_note_length)
    midi_data, note_events = decode_export.model_output_to_notes(
        model_output,
        onset_thresh=onset_threshold,
        frame_thresh=frame_threshold,
        min_note_len=min_note_len,
        min_freq=minimum_frequency,
        max_freq=maximum_frequency,
        multiple_pitch_bends=multiple_pitch_bends,
        melodia_trick=melodia_trick,
        midi_tempo=midi_tempo,
    )

    if debug_file:
        with open(debug_file) as fh:
            debug_data = json.load(fh)
        with open(debug_file, "w") as fh:
            json.dump(
                {
                    **debug_data,
                    "min_note_length": min_note_len,
                    "onset_thresh": onset_threshold,
                    "frame_thresh": frame_threshold,
                    "estimated_notes": [
                        (
                            float(s),
                            float(e),
                            int(p),
                            float(a),
                            [int(b) for b in bends] if bends else None,
                        )
                        for s, e, p, a, bends in note_events
                    ],
                },
                fh,
            )

    return model_output, midi_data, note_events


def predict_and_save(
    audio_path_list: Sequence[PathLike],
    output_directory: PathLike,
    save_midi: bool,
    sonify_midi: bool,
    save_model_outputs: bool,
    save_notes: bool,
    model_or_model_path: Union[Model, PathLike] = params_io.ICASSP_2022_WEIGHTS_PATH,
    onset_threshold: float = DEFAULT_ONSET_THRESHOLD,
    frame_threshold: float = DEFAULT_FRAME_THRESHOLD,
    minimum_note_length: float = DEFAULT_MINIMUM_NOTE_LENGTH_MS,
    minimum_frequency: Optional[float] = None,
    maximum_frequency: Optional[float] = None,
    multiple_pitch_bends: bool = False,
    melodia_trick: bool = True,
    debug_file: Optional[pathlib.Path] = None,
    sonification_samplerate: int = DEFAULT_SONIFICATION_SAMPLERATE,
    midi_tempo: float = DEFAULT_MIDI_TEMPO,
    device: Device = None,
) -> None:
    """Transcribe files and write the selected artifacts. Loads the model
    once for the whole batch."""
    model = _as_model(model_or_model_path, device)
    for audio_path in audio_path_list:
        print("")
        model_output, midi_data, note_events = predict(
            pathlib.Path(audio_path),
            model,
            onset_threshold,
            frame_threshold,
            minimum_note_length,
            minimum_frequency,
            maximum_frequency,
            multiple_pitch_bends,
            melodia_trick,
            debug_file,
            midi_tempo,
        )

        _write_artifacts(
            audio_path,
            output_directory,
            model_output,
            midi_data,
            note_events,
            save_midi,
            sonify_midi,
            save_model_outputs,
            save_notes,
            sonification_samplerate,
        )


def _write_artifacts(
    audio_path: PathLike,
    output_directory: PathLike,
    model_output,
    midi_data,
    note_events,
    save_midi: bool,
    sonify_midi: bool,
    save_model_outputs: bool,
    save_notes: bool,
    sonification_samplerate: int,
) -> None:
    """Write the selected artifact set for one transcribed file."""
    if save_model_outputs:
        output_path = build_output_path(audio_path, output_directory, OutputExtensions.MODEL_OUTPUT_NPZ)
        try:
            np.savez(output_path, basic_pitch_model_output=model_output)
            file_saved_confirmation(OutputExtensions.MODEL_OUTPUT_NPZ.name, output_path)
        except Exception:
            failed_to_save(OutputExtensions.MODEL_OUTPUT_NPZ.name, output_path)
            raise

    if save_midi:
        output_path = build_output_path(audio_path, output_directory, OutputExtensions.MIDI)
        try:
            midi_data.write(output_path)
            file_saved_confirmation(OutputExtensions.MIDI.name, output_path)
        except Exception:
            failed_to_save(OutputExtensions.MIDI.name, output_path)
            raise

    if sonify_midi:
        output_path = build_output_path(audio_path, output_directory, OutputExtensions.MIDI_SONIFICATION)
        try:
            decode_export.sonify_midi(midi_data, output_path, sr=sonification_samplerate)
            file_saved_confirmation(OutputExtensions.MIDI_SONIFICATION.name, output_path)
        except Exception:
            failed_to_save(OutputExtensions.MIDI_SONIFICATION.name, output_path)
            raise

    if save_notes:
        output_path = build_output_path(audio_path, output_directory, OutputExtensions.NOTE_EVENTS)
        try:
            save_note_events(note_events, output_path)
            file_saved_confirmation(OutputExtensions.NOTE_EVENTS.name, output_path)
        except Exception:
            failed_to_save(OutputExtensions.NOTE_EVENTS.name, output_path)
            raise


def predict_and_save_streaming(
    audio_path_list: Sequence[PathLike],
    output_directory: PathLike,
    save_midi: bool,
    sonify_midi: bool,
    save_model_outputs: bool,
    save_notes: bool,
    model_or_model_path: Union[Model, PathLike] = params_io.ICASSP_2022_WEIGHTS_PATH,
    onset_threshold: float = DEFAULT_ONSET_THRESHOLD,
    frame_threshold: float = DEFAULT_FRAME_THRESHOLD,
    minimum_note_length: float = DEFAULT_MINIMUM_NOTE_LENGTH_MS,
    minimum_frequency: Optional[float] = None,
    maximum_frequency: Optional[float] = None,
    multiple_pitch_bends: bool = False,
    melodia_trick: bool = True,
    sonification_samplerate: int = DEFAULT_SONIFICATION_SAMPLERATE,
    midi_tempo: float = DEFAULT_MIDI_TEMPO,
    windows_per_chunk: int = 128,
    device: Device = None,
) -> None:
    """Batched path: all files through one `StreamingTranscriber`.

    Same artifacts as `predict_and_save`, but every recording's uploads,
    model chunks and device decodes (the greedy-decode kernel on the card)
    are enqueued before anything is collected, in groups of 16 files. PCM16
    mono WAVs at 22.05/44.1 kHz go up as int16; other files are decoded and
    resampled on the host. Posteriorgrams for the NPZ ride the same fetch:
    the model runs once per file.
    """
    model = _as_model(model_or_model_path, device)
    transcriber = pipeline.StreamingTranscriber(
        model.module,
        windows_per_chunk=windows_per_chunk,
        device=model.device,
        # measured per process: the codec where the link is the wall, one
        # pinned copy where it is not; events are identical either way
        pcm_transport="auto",
    )

    min_note_len = _min_note_frames(minimum_note_length)
    # decoded audio of one group is freed before the next group loads
    group = 16
    results = []
    with transcriber:
        for start in range(0, len(audio_path_list), group):
            recordings = []
            for audio_path in audio_path_list[start : start + group]:
                pcm = None
                if audio_io._is_wav(audio_path):
                    pcm = audio_io.read_wav_pcm16_mono(audio_path)
                if pcm is None:  # not int16 mono at a model rate: float path
                    recordings.append(audio_io.load_audio(audio_path, constants.AUDIO_SAMPLE_RATE))
                else:
                    recordings.append(pcm)
            results.extend(
                transcriber.transcribe_batch(
                    recordings,
                    onset_threshold=onset_threshold,
                    frame_threshold=frame_threshold,
                    min_note_length=min_note_len,
                    min_freq=minimum_frequency,
                    max_freq=maximum_frequency,
                    melodia_trick=melodia_trick,
                    include_pitch_bends=True,
                    return_model_outputs=save_model_outputs,
                )
            )

    for audio_path, result in zip(audio_path_list, results):
        if save_model_outputs:
            note_events, model_output = result
        else:
            note_events, model_output = result, None
        print(f"\nPredicting MIDI for {audio_path}...")
        midi_data = decode_export.note_events_to_midi(
            note_events, multiple_pitch_bends, midi_tempo
        )
        _write_artifacts(
            audio_path,
            output_directory,
            model_output,
            midi_data,
            note_events,
            save_midi,
            sonify_midi,
            save_model_outputs,
            save_notes,
            sonification_samplerate,
        )
