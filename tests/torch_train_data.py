"""Seeded synthetic training corpora for the port's training tests and
`chip_smoke.py`: 22.05 kHz PCM16 tone mixes over a noise floor, with their
note, onset and contour annotations, written with the port's own
`serialization` and `TFRecordWriter` as
``<base>/<dataset>/splits/<split>/<i>.tfrecord`` (the layout the loader
globs). Not a test module: pytest collects nothing here.
"""

import io
import pathlib
from typing import List, Tuple

import numpy as np

SR = 22050
FPS = 86  # annotation frames per second (constants.ANNOTATIONS_FPS)
LOWEST_MIDI = 21


def tone_track(seconds: float, seed: int, noise: float = 0.05) -> Tuple[np.ndarray, List[Tuple[float, float, int]]]:
    """A seeded mix of two voices of harmonic tones (0.3-1.0 s each) over a
    noise floor. Returns (float32 audio in [-1, 1), [(onset s, offset s,
    MIDI pitch)])."""
    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    y = noise * rng.randn(n)
    notes = []
    for _ in range(2):
        t = float(rng.uniform(0.05, 0.4))
        while t < seconds - 0.5:
            midi = int(rng.randint(40, 84))
            dur = float(rng.uniform(0.3, 1.0))
            f0 = 440.0 * 2 ** ((midi - 69) / 12)
            i0, i1 = int(t * SR), min(n, int((t + dur) * SR))
            tt = np.arange(i1 - i0) / SR
            env = np.exp(-2.0 * tt) * np.minimum(1.0, tt / 0.01)
            y[i0:i1] += 0.2 * env * (np.sin(2 * np.pi * f0 * tt) + 0.3 * np.sin(4 * np.pi * f0 * tt))
            notes.append((t, min(t + dur, seconds), midi))
            t += float(rng.uniform(0.3, 0.8))
    return np.clip(y, -0.99, 0.99).astype(np.float32), notes


def annotations(notes: List[Tuple[float, float, int]], n_frames: int) -> dict:
    """Note, onset and contour rasters of a note list as the sparse
    (indices, values) pairs the serialized schema holds."""
    note = np.zeros((n_frames, 88), np.float32)
    onset = np.zeros((n_frames, 88), np.float32)
    contour = np.zeros((n_frames, 264), np.float32)
    for t0, t1, midi in notes:
        p = midi - LOWEST_MIDI
        f0, f1 = int(round(t0 * FPS)), min(n_frames, int(round(t1 * FPS)))
        note[f0:f1, p] = 1.0
        onset[f0, p] = 1.0
        contour[f0:f1, 3 * p + 1] = 1.0
        contour[f0:f1, 3 * p] = contour[f0:f1, 3 * p + 2] = 0.5

    def sparse(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        t, f = np.nonzero(m)
        return np.stack([t, f], axis=1).astype(np.int64), m[t, f]

    return {"notes": sparse(note), "onsets": sparse(onset), "contours": sparse(contour)}


def write_corpus(
    base: "str | pathlib.Path",
    name: str = "GuitarSet",
    n_train: int = 8,
    n_validation: int = 2,
    seconds: float = 10.0,
    seed: int = 0,
) -> pathlib.Path:
    """Write one dataset of tone-mix tracks, one track per tfrecord file.
    Returns ``base``."""
    from basic_pitch_torch.data import serialization, tfrecord
    from basic_pitch_torch.utils import audio as audio_io

    base = pathlib.Path(base)
    for split, count in (("train", n_train), ("validation", n_validation)):
        split_dir = base / name / "splits" / split
        split_dir.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            track_seed = seed * 1000 + (0 if split == "train" else 500) + i
            y, notes = tone_track(seconds, track_seed)
            buf = io.BytesIO()
            audio_io.write_wav(buf, y, SR)
            n_frames = int(seconds * FPS)
            ann = annotations(notes, n_frames)
            record = serialization.to_transcription_example(
                f"{name}-{split}-{i}",
                name,
                buf.getvalue(),
                notes_indices=ann["notes"][0],
                notes_values=ann["notes"][1],
                onsets_indices=ann["onsets"][0],
                onsets_values=ann["onsets"][1],
                contours_indices=ann["contours"][0],
                contours_values=ann["contours"][1],
                notes_onsets_shape=(n_frames, 88),
                contours_shape=(n_frames, 264),
            )
            with tfrecord.TFRecordWriter(split_dir / f"{i}.tfrecord") as writer:
                writer.write(record)
    return base
