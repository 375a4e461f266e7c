"""Signal geometry constants of the PyTorch port.

A copy of `basic_pitch_tpu/constants.py`, so that the port imports nothing
of the JAX package; `tests/test_torch_params.py` pins every value equal.
Every number downstream of the spectral front-end derives from the four
primitives (sample rate, hop, window seconds, base frequency).
"""

from __future__ import annotations

import enum

import numpy as np

SEMITONES_PER_OCTAVE = 12

# --- primitives -------------------------------------------------------------
AUDIO_SAMPLE_RATE = 22050  # Hz; all model input audio is resampled to this
FFT_HOP = 256  # samples between adjacent analysis frames
AUDIO_WINDOW_LENGTH = 2  # seconds of audio per model window
ANNOTATIONS_BASE_FREQUENCY = 27.5  # Hz (A0, lowest piano key)
ANNOTATIONS_N_SEMITONES = 88  # piano key count
AUDIO_N_CHANNELS = 1

# --- derived geometry --------------------------------------------------------
NOTES_BINS_PER_SEMITONE = 1
CONTOURS_BINS_PER_SEMITONE = 3
N_FREQ_BINS_NOTES = ANNOTATIONS_N_SEMITONES * NOTES_BINS_PER_SEMITONE  # 88
N_FREQ_BINS_CONTOURS = ANNOTATIONS_N_SEMITONES * CONTOURS_BINS_PER_SEMITONE  # 264

ANNOTATIONS_FPS = AUDIO_SAMPLE_RATE // FFT_HOP  # 86 frames / second
ANNOTATION_HOP = 1.0 / ANNOTATIONS_FPS

# frames of model output per 2-second window
ANNOT_N_FRAMES = ANNOTATIONS_FPS * AUDIO_WINDOW_LENGTH  # 172

# samples of audio per model window: two seconds minus one hop, so that a
# window yields exactly ANNOT_N_FRAMES output frames
AUDIO_N_SAMPLES = AUDIO_SAMPLE_RATE * AUDIO_WINDOW_LENGTH - FFT_HOP  # 43844

# --- inference windowing ------------------------------------------------------
# adjacent inference windows overlap by this many output frames; half the
# overlap is trimmed from each side of every window at reassembly
N_OVERLAPPING_FRAMES = 30
OVERLAP_LENGTH_SAMPLES = N_OVERLAPPING_FRAMES * FFT_HOP  # 7680
WINDOW_HOP_SAMPLES = AUDIO_N_SAMPLES - OVERLAP_LENGTH_SAMPLES  # 36164
N_FRAMES_PER_WINDOW_TRIMMED = ANNOT_N_FRAMES - N_OVERLAPPING_FRAMES  # 142

# --- training dataset mix ------------------------------------------------------
DATASET_SAMPLING_FREQUENCY = {
    "MAESTRO": 5,
    "GuitarSet": 2,
    "MedleyDB-Pitch": 2,
    "iKala": 2,
    "slakh": 2,
}


def _freq_bins(bins_per_semitone: int, base_frequency: float, n_semitones: int) -> np.ndarray:
    """Log-spaced center frequencies for an equal-tempered bin grid."""
    step = 2.0 ** (1.0 / (SEMITONES_PER_OCTAVE * bins_per_semitone))
    return base_frequency * step ** np.arange(bins_per_semitone * n_semitones)


FREQ_BINS_NOTES = _freq_bins(NOTES_BINS_PER_SEMITONE, ANNOTATIONS_BASE_FREQUENCY, ANNOTATIONS_N_SEMITONES)
FREQ_BINS_CONTOURS = _freq_bins(CONTOURS_BINS_PER_SEMITONE, ANNOTATIONS_BASE_FREQUENCY, ANNOTATIONS_N_SEMITONES)


class Split(enum.Enum):
    train = "train"
    validation = "validation"
    test = "test"
