"""NMP ("Notes, Multipitch, Onsets") transcription network.

PyTorch counterpart of `basic_pitch_tpu/models/nmp.py` for any
`ModelConfig` (the default: 8 harmonics, 8 contour filters, 32 note
filters, 32 onset filters, contours on):

    audio (b, 43844) -> CQT (b, 172, 309) -> NormalizedLog -> BatchNorm
      -> HarmonicStack([0.5, 1..7], crop 264) -> (b, 8, 172, 264)
      contour head: Conv(8, 3x39) -> BN -> ReLU -> Conv(1, 5x5, sigmoid)
      note head:    Conv(32, 7x7, stride (1,3)) -> ReLU -> Conv(1, 7x3, sigmoid)
      onset head:   Conv(32, 5x5, stride (1,3)) -> BN -> ReLU
                    -> concat(note_pre) -> Conv(1, 3x3, sigmoid)

With ``no_contours`` the note head reads the relu'd contour-conv channels
and the "contour" output is that hidden activation. Inside, activations are
NCHW with H = time and W = frequency; the outputs keep the JAX package's
(batch, time, freq) layout. Convolutions use TensorFlow's SAME padding,
written out explicitly because `nn.Conv2d(padding="same")` rejects
stride > 1: when the total pad is odd, the extra row or column goes after
(bottom or right).

Batch norm has Keras semantics (`BatchNorm`): eval normalises with the
moving statistics; train normalises with the biased batch statistics and
returns them, and the training loop folds them into the moving averages
after the optimizer step. No module updates its own statistics.

Two controls of the JAX package's `nmp.forward` steer the model stage:
``precision`` for the front end (the CQT's matmuls) and ``head_precision``
for the six head convs, each one of `PRECISIONS` (`precision_scope`), and
``conv_impl``, the heads' lowering: cuDNN convolutions ("conv"), im2col
patches and one matmul ("im2col"), a frequency-blocked Toeplitz matmul for
the contour conv ("toeplitz[:fb]"), or both ("mxu[:fb]"). The lowerings
are plain PyTorch matmuls; on the TPU they traded lane fill of its matrix
unit against extra work, on the card each is a question to measure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from basic_pitch_torch import constants
from basic_pitch_torch.ops import cqt as cqt_ops
from basic_pitch_torch.ops.harmonic import harmonic_stack
from basic_pitch_torch.ops.spectral import normalized_log

BN_EPSILON = 1e-3  # Keras BatchNormalization default
BN_MOMENTUM = 0.99  # Keras: new = 0.99 * old + 0.01 * batch


def identity_bn_stats(width: int) -> Dict[str, np.ndarray]:
    """Batch-norm parameters that are exactly the identity in eval mode:
    rsqrt(var + eps) == 1 when var = 1 - eps. The serialized-model readers
    use them for the slots a format folds into the preceding conv."""
    return {
        "gamma": np.ones(width, np.float32),
        "beta": np.zeros(width, np.float32),
        "mean": np.zeros(width, np.float32),
        "var": np.full(width, 1.0 - BN_EPSILON, np.float32),
    }

CONV_NAMES = ("contour_conv", "contour_out", "note_conv", "note_out", "onset_conv", "onset_out")
BN_NAMES = ("bn_cqt", "bn_contour", "bn_onset")

# maximum CQT semitone count representable below Nyquist
MAX_N_SEMITONES = int(
    np.floor(12.0 * np.log2(0.5 * constants.AUDIO_SAMPLE_RATE / constants.ANNOTATIONS_BASE_FREQUENCY))
)

BatchStats = Optional[Tuple[torch.Tensor, torch.Tensor]]


def n_semitones_for_harmonics(n_harmonics: int) -> int:
    """Extra semitones of CQT needed so the top harmonic is still visible."""
    return min(
        int(np.ceil(12.0 * np.log2(n_harmonics)) + constants.ANNOTATIONS_N_SEMITONES),
        MAX_N_SEMITONES,
    )


def default_harmonics(n_harmonics: int) -> Tuple[float, ...]:
    if n_harmonics > 1:
        return (0.5,) + tuple(float(h) for h in range(1, n_harmonics))
    return (1.0,)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static hyperparameters of an NMP model (the JAX package's
    `ModelConfig`). ``trainable_cqt`` makes the CQT's top-octave bank a
    parameter, L1-renormalised per bin after every optimizer step by
    `apply_unit_norm_constraint`."""

    n_harmonics: int = 8
    n_filters_contour: int = 8
    n_filters_notes: int = 32
    n_filters_onsets: int = 32
    no_contours: bool = False
    trainable_cqt: bool = False

    @property
    def harmonics(self) -> Tuple[float, ...]:
        return default_harmonics(self.n_harmonics)


DEFAULT_CONFIG = ModelConfig()


@functools.lru_cache(maxsize=8)
def cqt_kernels_for(n_harmonics: int) -> cqt_ops.CQTKernels:
    """The CQT geometry of a model with ``n_harmonics`` (36 bins per octave;
    309 bins at the default 8)."""
    return cqt_ops.build_cqt_kernels(
        sr=constants.AUDIO_SAMPLE_RATE,
        hop_length=constants.FFT_HOP,
        fmin=constants.ANNOTATIONS_BASE_FREQUENCY,
        n_bins=n_semitones_for_harmonics(n_harmonics) * constants.CONTOURS_BINS_PER_SEMITONE,
        bins_per_octave=12 * constants.CONTOURS_BINS_PER_SEMITONE,
    )


PRECISIONS = ("highest", "high", "default")


@contextlib.contextmanager
def precision_scope(precision: str, device_type: Optional[str] = None) -> Iterator[None]:
    """The numerics of one stage: "highest" is float32 with TF32 off, "high"
    lets cuBLAS and cuDNN use TF32, "default" runs the matmuls and convs
    under bf16 autocast on ``device_type`` (batch norm and the model's
    outputs stay float32). With ``device_type`` None only the TF32 flags
    are set: the training step's scope, which also covers the backward
    pass. The process-wide TF32 flags are restored on exit, so a scope never
    leaks into the stage after it (the transcriber keeps them off)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "high"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if device_type is None:
            yield
        else:
            with torch.autocast(device_type, dtype=torch.bfloat16, enabled=precision == "default"):
                yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow SAME padding (before, after) of one spatial dimension."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
    top, bottom = _same_pad(x.shape[2], kernel[0], stride[0])
    left, right = _same_pad(x.shape[3], kernel[1], stride[1])
    return F.pad(x, (left, right, top, bottom))


class SameConv2d(nn.Conv2d):
    """`nn.Conv2d` with TensorFlow SAME padding for any stride."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int], stride: Tuple[int, int] = (1, 1)):
        super().__init__(cin, cout, kernel, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_pad_same(x, self.kernel_size, self.stride))


# Memory guard of the im2col lowering (the JAX package's value): a conv
# whose patches would hold more elements than this runs the plain lowering
# (the contour conv's 936-wide patches at a 128-window chunk would be
# 5.4e9 elements, 21.8 GB in float32).
_IM2COL_MAX_PATCH_ELEMS = 800_000_000


def conv2d_im2col(x: torch.Tensor, conv: SameConv2d) -> torch.Tensor:
    """SAME conv as explicit padding, `F.unfold` patches (channel-major: cin
    slowest, then kh, then kw, the order of `conv_general_dilated_patches`)
    and one matmul against the (cout, cin*kh*kw) weight matrix."""
    (kh, kw), stride = conv.kernel_size, conv.stride
    bsz, cin, h, w = x.shape
    ho, wo = -(-h // stride[0]), -(-w // stride[1])
    k = cin * kh * kw
    if bsz * ho * wo * k > _IM2COL_MAX_PATCH_ELEMS:
        return conv(x)
    patches = F.unfold(_pad_same(x, (kh, kw), stride), (kh, kw), stride=stride)  # (b, k, ho*wo)
    y = torch.matmul(conv.weight.reshape(conv.out_channels, k), patches)  # (b, cout, ho*wo)
    return y.reshape(bsz, conv.out_channels, ho, wo) + conv.bias.view(1, -1, 1, 1)


def conv2d_toeplitz(x: torch.Tensor, conv: SameConv2d, fb: Optional[int] = None) -> torch.Tensor:
    """SAME stride-1 conv as a frequency-blocked block-Toeplitz matmul (the
    JAX package's `_conv2d_toeplitz`): a block of ``fb`` frequency bins
    moves from the matmul's rows into its columns, so the product is
    (b*t*nblocks, kh*(fb+kw-1)*cin) x (.., fb*cout), at (fb+kw-1)/kw times
    the conv's multiply-adds (the band's zeros). Computed channel-last, as
    in the JAX package, and returned NCHW."""
    if tuple(conv.stride) != (1, 1):
        raise ValueError("toeplitz path is stride-1 only")
    kh, kw = conv.kernel_size
    cout, cin = conv.out_channels, conv.in_channels
    bsz, _, t, f = x.shape
    if fb is None or fb >= f:
        fb = f
    if f % fb:
        raise ValueError(f"block size {fb} must divide the frequency axis {f}")
    nb = f // fb
    pt0, pf0 = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pf0, kw - 1 - pf0, pt0, kh - 1 - pt0))  # (b, t+kh-1, f+kw-1, cin)
    fslab = fb + kw - 1
    cols = fslab * cin
    # banded per-block weight: row fo of the block holds w at columns
    # [fo*cin, fo*cin + kw*cin); one matrix serves every block (built by the
    # pad-and-reshape Toeplitz trick: rows of cols + cin, flattened, trimmed)
    w = conv.weight.permute(2, 3, 1, 0).reshape(kh, kw * cin, cout)  # HWIO rows
    wrows = w.new_zeros((kh, fb, cols + cin, cout))
    wrows[:, :, : kw * cin, :] = w[:, None, :, :]
    wmat = wrows.reshape(kh, fb * (cols + cin), cout)[:, : fb * cols, :].reshape(kh, fb, cols, cout)
    wmat = wmat.permute(0, 2, 1, 3).reshape(kh * cols, fb * cout)
    xf = xp.reshape(bsz, t + kh - 1, (f + kw - 1) * cin)
    rows = torch.cat(
        [
            torch.cat([xf[:, dt : dt + t, j * fb * cin : j * fb * cin + cols] for dt in range(kh)], dim=-1)
            for j in range(nb)
        ],
        dim=1,
    )  # (b, nb*t, kh*cols), block-major
    y = torch.matmul(rows.reshape(bsz * nb * t, kh * cols), wmat)
    y = y.reshape(bsz, nb, t, fb, cout).permute(0, 4, 2, 1, 3).reshape(bsz, cout, t, f)
    return y + conv.bias.view(1, -1, 1, 1)


ConvFn = Callable[[torch.Tensor, SameConv2d], torch.Tensor]


def _plain_conv(x: torch.Tensor, conv: SameConv2d) -> torch.Tensor:
    return conv(x)


def resolve_conv_impl(conv_impl: str) -> Tuple[ConvFn, ConvFn]:
    """conv_impl -> (lowering of the five other head convs, lowering of
    contour_conv), with the JAX package's grammar and errors:

    "conv"          cuDNN convolutions everywhere.
    "im2col"        patches + one matmul for every head conv whose patches
                    fit `_IM2COL_MAX_PATCH_ELEMS`, the plain conv otherwise.
    "toeplitz[:fb]" the Toeplitz matmul for contour_conv (stride 1, fb a
                    divisor of 264, default 24), plain convs elsewhere.
    "mxu[:fb]"      the Toeplitz contour_conv and im2col elsewhere.
    """
    name, _, arg = conv_impl.partition(":")
    if arg and name not in ("toeplitz", "mxu"):
        raise ValueError(f"conv_impl {name!r} takes no :arg (got {conv_impl!r})")
    if name == "conv":
        return _plain_conv, _plain_conv
    if name == "im2col":
        return conv2d_im2col, conv2d_im2col
    if name in ("toeplitz", "mxu"):
        fb = int(arg) if arg else 24
        if fb < 1:
            raise ValueError(f"conv_impl block size must be >= 1, got {conv_impl!r}")
        toe = functools.partial(conv2d_toeplitz, fb=fb)
        return (conv2d_im2col if name == "mxu" else _plain_conv), toe
    raise ValueError(f"conv_impl must be conv|im2col|toeplitz[:fb]|mxu[:fb], got {conv_impl!r}")


class BatchNorm(nn.BatchNorm2d):
    """Keras batch norm over NCHW (eps 1e-3), in float32 whatever the input
    (bf16 under autocast). ``train=False`` normalises with the moving
    statistics. ``train=True`` normalises with the batch mean and the
    *biased* batch variance (`jnp.var`), and returns them detached for the
    loop's moving-average update; the buffers are never touched here
    (`nn.BatchNorm2d`'s own update uses the unbiased variance and the other
    momentum convention)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPSILON)

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, BatchStats]:  # type: ignore[override]
        x = x.to(self.weight.dtype)
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
            return y, None
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(var + self.eps)
        y = (x - mean.view(shape)) * inv.view(shape) * self.weight.view(shape) + self.bias.view(shape)
        return y, (mean.detach(), var.detach())


class NMP(nn.Module):
    """The NMP model of one `ModelConfig`; load weights with
    `models.params.model_from_flat` (or `from_jax_params`)."""

    def __init__(self, config: ModelConfig = DEFAULT_CONFIG):
        super().__init__()
        self.config = config
        self.cqt = cqt_ops.CQT(cqt_kernels_for(config.n_harmonics), trainable=config.trainable_cqt)
        nh = len(config.harmonics)
        fc, fn, fo = config.n_filters_contour, config.n_filters_notes, config.n_filters_onsets
        self.bn_cqt = BatchNorm(1)
        self.contour_conv = SameConv2d(nh, fc, (3, 39))
        self.bn_contour = BatchNorm(fc)
        self.contour_out = SameConv2d(fc, 1, (5, 5))
        self.note_conv = SameConv2d(fc if config.no_contours else 1, fn, (7, 7), stride=(1, 3))
        self.note_out = SameConv2d(fn, 1, (7, 3))
        self.onset_conv = SameConv2d(nh, fo, (5, 5), stride=(1, 3))
        self.bn_onset = BatchNorm(fo)
        self.onset_out = SameConv2d(fo + 1, 1, (3, 3))
        self.eval()

    def frontend(
        self, audio: torch.Tensor, train: bool = False, precision: str = "highest"
    ) -> Tuple[torch.Tensor, Dict[str, BatchStats]]:
        """(b, AUDIO_N_SAMPLES) -> (harmonically stacked, normalized CQT,
        NCHW (b, n_harmonics, n_frames, 264), float32; {"bn_cqt": batch
        stats}), the CQT under ``precision``."""
        with precision_scope(precision, audio.device.type):
            x = normalized_log(self.cqt(audio).float()).unsqueeze(1)  # (b, 1, t, n_bins)
        x, stats = self.bn_cqt(x, train)
        stacked = harmonic_stack(
            x.permute(0, 2, 3, 1),
            constants.CONTOURS_BINS_PER_SEMITONE,
            self.config.harmonics,
            constants.N_FREQ_BINS_CONTOURS,
        )  # (b, t, 264, h)
        return stacked.permute(0, 3, 1, 2).contiguous(), {"bn_cqt": stats}

    def forward_and_stats(
        self,
        audio: torch.Tensor,
        train: bool,
        precision: str = "highest",
        head_precision: Optional[str] = None,
        conv_impl: str = "conv",
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, BatchStats]]:
        """The JAX package's `nmp.forward`: (b, 43844) float32 at 22050 Hz ->
        ({"onset": (b,t,88), "contour": (b,t,264), "note": (b,t,88)}, float32,
        batch stats per BN layer, None in eval). With ``no_contours``
        "contour" is the (b, t, 264 * n_filters_contour) hidden activation,
        frequency-major as the JAX package's channel-last reshape gives it.
        ``precision`` steers the CQT and, unless ``head_precision`` is given,
        the heads (`precision_scope`); ``conv_impl`` picks the heads'
        lowering (`resolve_conv_impl`)."""
        conv, conv_contour = resolve_conv_impl(conv_impl)
        x, stats = self.frontend(audio, train, precision)

        with precision_scope(precision if head_precision is None else head_precision, audio.device.type):
            c, stats["bn_contour"] = self.bn_contour(conv_contour(x, self.contour_conv), train)
            c = torch.relu(c)
            if self.config.no_contours:
                contour = c.permute(0, 2, 3, 1).reshape(c.shape[0], c.shape[2], -1)
                note_in = c
            else:
                note_in = torch.sigmoid(conv(c, self.contour_out))  # (b, 1, t, 264)
                contour = note_in[:, 0]

            n = torch.relu(conv(note_in, self.note_conv))
            n_pre = torch.sigmoid(conv(n, self.note_out))  # (b, 1, t, 88)

            o, stats["bn_onset"] = self.bn_onset(conv(x, self.onset_conv), train)
            o = torch.cat([n_pre, torch.relu(o)], dim=1)  # note-pre first, then the onset stack
            onset = torch.sigmoid(conv(o, self.onset_out))

        outputs = {"onset": onset[:, 0], "contour": contour, "note": n_pre[:, 0]}
        return {k: v.float() for k, v in outputs.items()}, stats

    def forward(
        self,
        audio: torch.Tensor,
        precision: str = "highest",
        head_precision: Optional[str] = None,
        conv_impl: str = "conv",
    ) -> Dict[str, torch.Tensor]:
        """Posteriorgrams, with batch statistics in train mode and the moving
        ones in eval mode (the default)."""
        return self.forward_and_stats(audio, self.training, precision, head_precision, conv_impl)[0]


@torch.no_grad()
def init_params(model: NMP, generator: torch.Generator) -> NMP:
    """Reset ``model`` to the reference's initialization (`models.py:149`):
    conv kernels from Keras `VarianceScaling(2, fan_avg, uniform)` drawn with
    ``generator`` (a CPU `torch.Generator`), zero biases, identity batch
    norm, and, with ``trainable_cqt``, the analytic CQT bank."""
    for name in CONV_NAMES:
        conv = getattr(model, name)
        cout, cin, kh, kw = conv.weight.shape
        fan_in, fan_out = cin * kh * kw, cout * kh * kw
        limit = math.sqrt(3.0 * 2.0 / ((fan_in + fan_out) / 2.0))
        w = torch.empty(conv.weight.shape, dtype=torch.float32).uniform_(-limit, limit, generator=generator)
        conv.weight.copy_(w)
        conv.bias.zero_()
    for name in BN_NAMES:
        getattr(model, name).reset_parameters()  # gamma 1, beta 0, mean 0, var 1
    if model.config.trainable_cqt:
        bank = cqt_kernels_for(model.config.n_harmonics).top_octave_kernels.T
        model.cqt.kernel_matrix.copy_(torch.from_numpy(np.ascontiguousarray(bank)))
    return model


@torch.no_grad()
def apply_unit_norm_constraint(model: NMP) -> None:
    """In place, after each optimizer step (`models.py:153`): L2-normalise
    every conv kernel's output channel over (in, h, w), and, with a trainable
    CQT bank, L1-normalise each bin's complex kernel (the invariant the
    analytic bank is built with)."""
    for name in CONV_NAMES:
        w = getattr(model, name).weight  # (out, in, h, w)
        denom = torch.sqrt(torch.sum(torch.square(w), dim=(1, 2, 3), keepdim=True))
        w.div_(torch.clamp(denom, min=1e-12))
    if model.config.trainable_cqt:
        km = model.cqt.kernel_matrix  # (n_fft, 2*n_filters): real columns then imag
        n_filters = km.shape[1] // 2
        mag = torch.sqrt(torch.square(km[:, :n_filters]) + torch.square(km[:, n_filters:]))
        l1 = torch.clamp(torch.sum(mag, dim=0, keepdim=True), min=1e-12)
        km.div_(torch.cat([l1, l1], dim=1))
