"""Transcription-example schema: build + parse the reference's TFRecord rows.

Schema (11 features, the reference's `basic_pitch/data/
tf_example_serialization.py:59-75`): file_id, source, raw WAV bytes, sparse
notes/onsets/contours as serialized-tensor (int64 indices, float32 values)
pairs, and two dense int64 shapes. Sparse matrices share the time axis;
contours have 3x the frequency resolution. A copy of
`basic_pitch_tpu/data/serialization.py` that reads WAV through the port's
`utils/audio`; `tests/test_torch_params.py` pins it equal.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from basic_pitch_torch import constants
from basic_pitch_torch.data import proto
from basic_pitch_torch.utils import audio as audio_io

FEATURE_NAMES = (
    "file_id",
    "source",
    "audio_wav",
    "notes_indices",
    "notes_values",
    "onsets_indices",
    "onsets_values",
    "contours_indices",
    "contours_values",
    "notes_onsets_shape",
    "contours_shape",
)


def to_transcription_example(
    file_id: str,
    source: str,
    encoded_wav: bytes,
    notes_indices: Sequence[Tuple[int, int]],
    notes_values: Sequence[float],
    onsets_indices: Sequence[Tuple[int, int]],
    onsets_values: Sequence[float],
    contours_indices: Sequence[Tuple[int, int]],
    contours_values: Sequence[float],
    notes_onsets_shape: Tuple[int, int],
    contours_shape: Tuple[int, int],
) -> bytes:
    """Serialize one training example (returns tf.train.Example bytes)."""
    return proto.encode_example(
        {
            "file_id": file_id.encode("utf-8"),
            "source": source.encode("utf-8"),
            "audio_wav": encoded_wav,
            "notes_indices": proto.encode_tensor(np.asarray(notes_indices, np.int64)),
            "notes_values": proto.encode_tensor(np.asarray(notes_values, np.float32)),
            "onsets_indices": proto.encode_tensor(np.asarray(onsets_indices, np.int64)),
            "onsets_values": proto.encode_tensor(np.asarray(onsets_values, np.float32)),
            "contours_indices": proto.encode_tensor(np.asarray(contours_indices, np.int64)),
            "contours_values": proto.encode_tensor(np.asarray(contours_values, np.float32)),
            "notes_onsets_shape": proto.encode_tensor(np.asarray(notes_onsets_shape, np.int64)),
            "contours_shape": proto.encode_tensor(np.asarray(contours_shape, np.int64)),
        }
    )


def to_transcription_example_from_file(
    file_id: str,
    source: str,
    audio_wav_file_path: str,
    **sparse_annotations: "np.ndarray | Sequence",
) -> bytes:
    """File-path variant asserting the WAV is 22.05 kHz mono, like the
    reference's sox probe (`tf_example_serialization.py:104-105`)."""
    samples, sample_rate = audio_io.read_wav(audio_wav_file_path)
    assert sample_rate == constants.AUDIO_SAMPLE_RATE, f"wav must be {constants.AUDIO_SAMPLE_RATE} Hz"
    assert samples.shape[1] == constants.AUDIO_N_CHANNELS, "wav must be mono"
    with open(audio_wav_file_path, "rb") as fh:
        encoded = fh.read()
    return to_transcription_example(file_id, source, encoded, **sparse_annotations)


class ParsedExample:
    """One parsed example: mono audio + per-head annotation rasters.

    Annotations arrive from the TFRecord in sparse COO form ((N, 2)
    (frame, bin) indices + values + dense shape). When built via
    `from_sparse`, that form is RETAINED and the dense `.notes` /
    `.onsets` / `.contours` rasters are materialized lazily on first
    access — the training fast path (`loader.iter_track_windows` in COO
    mode) windows the sparse form directly and never pays the raster
    fill, which on a page-fault-bound host is most of the parse cost.
    The dense constructor stays for callers that already hold rasters.
    """

    _HEADS = ("notes", "onsets", "contours")

    def __init__(
        self,
        file_id: str,
        source: str,
        audio: np.ndarray,  # (n_samples,) float32 mono 22.05 kHz
        notes: Optional[np.ndarray] = None,  # (n_frames, 88) or (0, 0)
        onsets: Optional[np.ndarray] = None,
        contours: Optional[np.ndarray] = None,  # (n_frames, 264)
    ):
        self.file_id = file_id
        self.source = source
        self.audio = audio
        self._dense: Dict[str, np.ndarray] = {}
        for name, mat in (("notes", notes), ("onsets", onsets), ("contours", contours)):
            if mat is not None:
                self._dense[name] = mat
        self._sparse: Optional[Dict[str, tuple]] = None

    @classmethod
    def from_sparse(
        cls,
        file_id: str,
        source: str,
        audio: np.ndarray,
        heads: Dict[str, tuple],  # name -> (indices, values, shape arrays)
    ) -> "ParsedExample":
        ex = cls(file_id, source, audio)
        norm = {}
        for name in cls._HEADS:
            idx, val, shape = heads[name]
            if val.size == 0 or shape.size != 2:
                # the densify convention: absent/empty annotations are (0, 0)
                norm[name] = (
                    np.zeros((0, 2), np.int32),
                    np.zeros((0,), np.float32),
                    (0, 0),
                )
            else:
                norm[name] = (
                    idx.reshape(-1, 2).astype(np.int32, copy=False),
                    val.astype(np.float32, copy=False),
                    tuple(int(s) for s in shape),
                )
        ex._sparse = norm
        return ex

    def head_shape(self, name: str) -> tuple:
        """Dense raster shape of one head without materializing it."""
        if name in self._dense:
            return tuple(self._dense[name].shape)
        assert self._sparse is not None
        return self._sparse[name][2]

    def sparse_head(self, name: str) -> tuple:
        """(indices (N,2) int32, values (N,) f32, shape) for one head.

        Derived by `np.nonzero` when only the dense raster exists, so both
        construction routes expose the same interface.
        """
        if self._sparse is not None:
            return self._sparse[name]
        mat = self._dense[name]
        ts, fs = np.nonzero(mat)
        idx = np.stack([ts, fs], axis=1).astype(np.int32)
        return idx, mat[ts, fs].astype(np.float32), tuple(mat.shape)

    def _head_dense(self, name: str) -> np.ndarray:
        if name not in self._dense:
            assert self._sparse is not None, f"head {name} never provided"
            idx, val, shape = self._sparse[name]
            self._dense[name] = _densify_normalized(idx, val, shape)
        return self._dense[name]

    @property
    def notes(self) -> np.ndarray:
        return self._head_dense("notes")

    @property
    def onsets(self) -> np.ndarray:
        return self._head_dense("onsets")

    @property
    def contours(self) -> np.ndarray:
        return self._head_dense("contours")


def _densify_normalized(idx: np.ndarray, val: np.ndarray, shape: tuple) -> np.ndarray:
    dense = np.zeros(shape, np.float32)
    if val.size:
        dense[idx[:, 0].astype(np.int64), idx[:, 1].astype(np.int64)] = val
    return dense


def _densify(indices: np.ndarray, values: np.ndarray, shape: np.ndarray) -> np.ndarray:
    """Sparse COO -> dense float32; empty annotations stay size 0."""
    if values.size == 0 or shape.size != 2:
        return np.zeros((0, 0), np.float32)
    dense = np.zeros(tuple(int(s) for s in shape), np.float32)
    idx = indices.reshape(-1, 2).astype(np.int64)
    dense[idx[:, 0], idx[:, 1]] = values
    return dense


def parse_transcription_example(record: bytes) -> ParsedExample:
    """Decode one serialized example into dense matrices + mono audio.

    Mirrors the reference's parse -> sparse2dense -> wav decode -> mixdown
    chain (`tf_example_deserialization.py:368-499`)."""
    features = proto.decode_example(record)
    file_id = features["file_id"][0].decode("utf-8")
    source = features["source"][0].decode("utf-8")

    wav_bytes = features["audio_wav"][0]
    samples, sample_rate = audio_io.read_wav_bytes(wav_bytes)
    if sample_rate != constants.AUDIO_SAMPLE_RATE:
        raise ValueError(f"audio sample rate {sample_rate} is inconsistent")
    audio = audio_io.to_mono(samples)

    def tensor(name):
        return proto.decode_tensor(features[name][0])

    return ParsedExample.from_sparse(
        file_id,
        source,
        audio,
        {
            "notes": (tensor("notes_indices"), tensor("notes_values"), tensor("notes_onsets_shape")),
            "onsets": (tensor("onsets_indices"), tensor("onsets_values"), tensor("notes_onsets_shape")),
            "contours": (tensor("contours_indices"), tensor("contours_values"), tensor("contours_shape")),
        },
    )
