"""Shared machinery for dataset builders.

A copy of `basic_pitch_tpu/data/datasets/base.py` on the port's
`data/serialization.py` and `utils/audio.py`. Each builder turns one
locally-available MIR corpus into the framework's TFRecord schema. The
common steps (transcode audio to 22.05 kHz mono PCM16, rasterize
note/contour annotations onto the training grids, assemble the serialized
example) live here; the per-dataset modules only know their corpus layout
and annotation formats. Other containers than WAV are transcoded through
ffmpeg when the binary is available.
"""

from __future__ import annotations

import pathlib
import tempfile
from typing import Optional, Tuple

import numpy as np

from basic_pitch_torch import constants
from basic_pitch_torch.data import annotations, serialization
from basic_pitch_torch.utils import audio as audio_io

PathLike = str


def midi_to_hz(pitch_midi: "np.ndarray | float") -> np.ndarray:
    return 440.0 * 2.0 ** ((np.asarray(pitch_midi, np.float64) - 69.0) / 12.0)


# re-exported for the dataset builders; the implementation lives with the
# audio codec it gates
ffmpeg_available = audio_io.ffmpeg_available


def load_any_audio(path: PathLike, channel: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Decode WAV natively; other formats via ffmpeg if present.

    Args:
        channel: if given, keep only this 0-based channel (the iKala vocal
            channel trick, `datasets/ikala.py:93`); otherwise mix to mono.
    """
    path = str(path)
    if path.lower().endswith(".wav"):
        samples, sr = audio_io.read_wav(path)
    else:
        if not ffmpeg_available():
            raise RuntimeError(f"need ffmpeg to decode {path}")
        samples, sr = audio_io.decode_with_ffmpeg(path)
    if channel is not None:
        mono = samples[:, min(channel, samples.shape[1] - 1)]
    else:
        mono = audio_io.to_mono(samples)
    return mono.astype(np.float32), sr


def transcode_to_model_rate(path: PathLike, channel: Optional[int] = None) -> Tuple[bytes, float]:
    """Audio file -> (22.05 kHz mono PCM16 WAV bytes, duration seconds)."""
    mono, sr = load_any_audio(path, channel)
    resampled = audio_io.resample(mono, sr, constants.AUDIO_SAMPLE_RATE)
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        audio_io.write_wav(tmp.name, resampled, constants.AUDIO_SAMPLE_RATE)
        wav_bytes = pathlib.Path(tmp.name).read_bytes()
    return wav_bytes, len(resampled) / constants.AUDIO_SAMPLE_RATE


def build_example(
    track_id: str,
    source: str,
    wav_bytes: bytes,
    duration: float,
    note_intervals: Optional[np.ndarray],  # (n, 2) seconds
    note_pitches_hz: Optional[np.ndarray],  # (n,)
    contour_times: Optional[np.ndarray],  # frame-level pitch track
    contour_freqs_hz: Optional[np.ndarray],
    note_amplitudes: Optional[np.ndarray] = None,
    contours_from_notes: bool = False,
) -> bytes:
    """Assemble one serialized training example.

    With ``contours_from_notes`` the note events double as contour
    annotations on the 3x grid (the MAESTRO convention,
    `datasets/maestro.py:140-146`).
    """
    time_grid = annotations.time_grid_for_duration(duration)
    n_frames = len(time_grid)

    if note_intervals is not None and len(note_intervals):
        notes_idx, notes_val = annotations.notes_to_sparse(
            note_intervals, note_pitches_hz, time_grid, constants.FREQ_BINS_NOTES,
            amplitudes=note_amplitudes,
        )
        onsets_idx, onsets_val = annotations.notes_to_sparse(
            note_intervals, note_pitches_hz, time_grid, constants.FREQ_BINS_NOTES,
            amplitudes=note_amplitudes, onsets_only=True,
        )
        notes_shape = (n_frames, constants.N_FREQ_BINS_NOTES)
    else:
        notes_idx, notes_val, onsets_idx, onsets_val = [], [], [], []
        notes_shape = (0, 0)

    if contours_from_notes and note_intervals is not None and len(note_intervals):
        contours_idx, contours_val = annotations.notes_to_sparse(
            note_intervals, note_pitches_hz, time_grid, constants.FREQ_BINS_CONTOURS,
            amplitudes=note_amplitudes,
        )
        contours_shape = (n_frames, constants.N_FREQ_BINS_CONTOURS)
    elif contour_times is not None and len(contour_times):
        contours_idx, contours_val = annotations.f0_to_sparse(
            contour_times, contour_freqs_hz, time_grid, constants.FREQ_BINS_CONTOURS
        )
        contours_shape = (n_frames, constants.N_FREQ_BINS_CONTOURS)
    else:
        contours_idx, contours_val = [], []
        contours_shape = (0, 0)

    return serialization.to_transcription_example(
        track_id,
        source,
        wav_bytes,
        notes_indices=notes_idx,
        notes_values=notes_val,
        onsets_indices=onsets_idx,
        onsets_values=onsets_val,
        contours_indices=contours_idx,
        contours_values=contours_val,
        notes_onsets_shape=notes_shape,
        contours_shape=contours_shape,
    )
