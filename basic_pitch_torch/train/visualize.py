"""TensorBoard visualization during training.

PyTorch counterpart of `basic_pitch_tpu/train/visualize.py` (the
reference's `VisualizeCallback` + `visualize_transcription`,
`basic_pitch/callbacks.py:29-77`, `visualize.py:67-237` there):
each epoch, one batch from the train and validation visualization sets goes
through the model and is logged as audio players, input-CQT images, target
and predicted posteriorgram images, sonified note/onset outputs, and
scalar loss/max statistics. Writes with tensorboardX, imported when the
callback is built.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from basic_pitch_torch import constants
from basic_pitch_torch.decode import export as decode_export
from basic_pitch_torch.models import nmp


def _to_image(matrix: np.ndarray) -> np.ndarray:
    """(time, freq) activation -> (3, freq, time) float image, low bin at
    the bottom."""
    m = np.asarray(matrix, np.float32).T[::-1]
    peak = m.max()
    if peak > 0:
        m = m / peak
    return np.repeat(m[None], 3, axis=0)


class VisualizeCallback:
    """`fit` callback logging transcription summaries each epoch; called as
    ``cb(epoch, model, train_metrics, val_metrics)``."""

    def __init__(
        self,
        train_viz_iter: Iterator,
        validation_viz_iter: Iterator,
        tensorboard_log_dir: str,
        sonify: bool = True,
        contours: bool = True,
    ):
        try:
            from tensorboardX import SummaryWriter
        except ImportError as exc:
            raise ImportError("tensorboardX is required for VisualizeCallback") from exc

        self.writer = SummaryWriter(tensorboard_log_dir)
        self.train_iter = train_viz_iter
        self.validation_iter = validation_viz_iter
        self.sonify = sonify
        self.contours = contours

    def _add_audio(self, tag: str, samples: np.ndarray, step: int, sample_rate: int) -> None:
        """add_audio with a fallback WAV encoder (tensorboardX's own encoder
        requires the optional soundfile package)."""
        try:
            self.writer.add_audio(tag, samples, step, sample_rate=sample_rate)
            return
        except Exception:
            pass
        try:
            import io

            from tensorboardX.proto.summary_pb2 import Summary

            from basic_pitch_torch.utils import audio as audio_io

            buf = io.BytesIO()
            audio_io.write_wav(buf, np.asarray(samples, np.float32), sample_rate)
            encoded = buf.getvalue()
            audio = Summary.Audio(
                sample_rate=sample_rate,
                num_channels=1,
                length_frames=len(samples),
                encoded_audio_string=encoded,
                content_type="audio/wav",
            )
            self.writer._get_file_writer().add_summary(Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)
        except Exception:
            pass  # audio logging is best-effort

    def __call__(self, epoch: int, model: nmp.NMP, train_metrics: Dict, val_metrics: Dict) -> None:
        for name, metrics in (("train", train_metrics), ("validation", val_metrics)):
            for key, value in metrics.items():
                self.writer.add_scalar(f"{name}/{key}", float(value), epoch)
        for stage, iterator in (("train", self.train_iter), ("validation", self.validation_iter)):
            try:
                batch = next(iterator)
            except StopIteration:
                continue
            self._log_batch(stage, batch, model, epoch)
        self.writer.flush()

    @torch.no_grad()
    def _log_batch(self, stage: str, batch: Dict, model: nmp.NMP, epoch: int) -> None:
        audio = np.asarray(batch["audio"])[:2]
        targets = {k: np.asarray(v)[:2] for k, v in batch["targets"].items()}
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(next(model.parameters()).device)
        outputs = {k: v.cpu().numpy() for k, v in model.forward_and_stats(x, train=False)[0].items()}
        stacked = model.frontend(x, train=False)[0].cpu().numpy()  # (b, harmonics, t, 264)

        for i in range(audio.shape[0]):
            tag = f"{stage}/{i}"
            self._add_audio(f"{tag}/audio", audio[i], epoch, constants.AUDIO_SAMPLE_RATE)
            self.writer.add_image(f"{tag}/input-cqt", _to_image(stacked[i, 0]), epoch)
            heads = ("onset", "note", "contour") if self.contours else ("onset", "note")
            for head in heads:
                self.writer.add_image(f"{tag}/{head}/target", _to_image(targets[head][i]), epoch)
                self.writer.add_image(f"{tag}/{head}/output", _to_image(outputs[head][i]), epoch)
                self.writer.add_scalar(f"{tag}/{head}/max-output", float(outputs[head][i].max()), epoch)
            if self.sonify:
                for head in ("onset", "note"):
                    y, fs = decode_export.sonify_salience(outputs[head][i].T, 1)
                    if y.size:
                        self._add_audio(f"{tag}/{head}/sonified", y, epoch, fs)

    def close(self) -> None:
        self.writer.close()
