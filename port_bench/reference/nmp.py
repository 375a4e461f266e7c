"""Plain reference of the Basic Pitch NMP model (ICASSP 2022) in PyTorch.

Written from the published model's description, in any float dtype
(float64 by default; the control runs it in float32 with TF32 on), with
nothing of the program under test: no kernels, no chunking, no batching
beyond blocks of windows. It reads the checkpoint (`.npz`, JAX layout:
conv kernels HWIO) as a raw file and works every filter out itself.

    audio -> (44.1 kHz only) decimation by two, a 257-tap Kaiser halfband
      FIR (beta 14.77) centred on input sample 2m, zero outside the
      recording
    -> 2 s windows of 43 844 samples every 36 164, the first starting
       3 840 samples before the recording
    -> CQT: 309 bins, 36 per octave from 27.5 Hz, hop 256, in 9 octaves;
       the top octave's 36 complex kernels (Hann-windowed, L1-normalised,
       centred in 256 samples) run on each octave's signal, reflect-padded
       by 128, and each lower octave's signal is the one above lowpassed
       (256-tap frequency-sampled FIR) and decimated by two; magnitudes
       scaled by sqrt(kernel length at the bin's frequency)
    -> power in dB, shifted by its minimum and divided by its maximum per
       window -> batch norm -> 8 harmonics (0.5, 1..7) stacked as channels,
       264 bins kept
    -> contour head: conv 8x(3x39) -> BN -> ReLU -> conv 1x(5x5) -> sigmoid
       note head: conv 32x(7x7, stride 1x3) -> ReLU -> conv 1x(7x3) ->
       sigmoid; onset head: conv 32x(5x5, stride 1x3) -> BN -> ReLU,
       concatenated after the note output -> conv 1x(3x3) -> sigmoid
       (TensorFlow SAME padding, the odd pad after)
    -> 15 frames trimmed off each side of each window, windows end to end,
       cut to the recording's frame count.

Batch norm in train mode normalises with the batch mean and the biased
batch variance (Keras); in eval mode with the moving statistics.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SR = 22050
HOP = 256
WINDOW = 43844
WINDOW_HOP = 36164
PAD_FRONT = 3840
TRIM = 15
FRAMES = 172
N_BINS = 309
BINS_PER_OCTAVE = 36
FMIN = 27.5
N_OCTAVES = 9
HARMONICS = (0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0)
CONTOUR_BINS = 264
BN_EPS = 1e-3
CONV_NAMES = ("contour_conv", "contour_out", "note_conv", "note_out", "onset_conv", "onset_out")
BN_NAMES = ("bn_cqt", "bn_contour", "bn_onset")
STRIDES = {"note_conv": (1, 3), "onset_conv": (1, 3)}


def decimator_taps() -> np.ndarray:
    from scipy.signal import firwin

    return firwin(257, 0.5, window=("kaiser", 14.77))


def octave_lowpass() -> np.ndarray:
    from scipy.signal import firwin2

    tb = 0.001
    return firwin2(256, [0.0, 0.5 / (1 + tb), 0.5 * (1 + tb), 1.0], [1.0, 1.0, 0.0, 0.0])


def cqt_kernels() -> Tuple[np.ndarray, np.ndarray]:
    """(top-octave complex kernels (36, 256), per-bin length norm (309,))."""
    q = 1.0 / (2.0 ** (1.0 / BINS_PER_OCTAVE) - 1.0)
    fmin_top = FMIN * 2.0 ** (N_OCTAVES - 1)
    remainder = N_BINS % BINS_PER_OCTAVE
    fmax_top = fmin_top * 2.0 ** (((remainder or BINS_PER_OCTAVE) - 1) / BINS_PER_OCTAVE)
    fmin_top = fmax_top / 2.0 ** (1.0 - 1.0 / BINS_PER_OCTAVE)
    n_fft = int(2 ** np.ceil(np.log2(np.ceil(q * SR / fmin_top))))
    freqs = fmin_top * 2.0 ** (np.arange(BINS_PER_OCTAVE) / BINS_PER_OCTAVE)
    kernels = np.zeros((BINS_PER_OCTAVE, n_fft), np.complex128)
    for k, freq in enumerate(freqs):
        length = int(np.ceil(q * SR / freq))
        start = int(np.ceil(n_fft / 2.0 - length / 2.0)) - (length % 2)
        n = np.arange(length) - (length + 1) // 2
        hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(length) / length)
        sig = hann * np.exp(2j * np.pi * freq * n / SR) / length
        kernels[k, start : start + length] = sig / np.abs(sig).sum()
    all_freqs = FMIN * 2.0 ** (np.arange(N_BINS) / BINS_PER_OCTAVE)
    return kernels, np.sqrt(np.ceil(q * SR / all_freqs))


def load_weights(path: str, device, dtype) -> Dict[str, torch.Tensor]:
    """The checkpoint's arrays as tensors, conv kernels HWIO."""
    with np.load(path) as z:
        return {k: torch.tensor(z[k], dtype=dtype, device=device) for k in z.files}


class Reference:
    """The model's filters on one device in one dtype, and its forward."""

    def __init__(self, device, dtype=torch.float64):
        self.device, self.dtype = device, dtype
        kern, norm = cqt_kernels()
        both = np.concatenate([kern.real, kern.imag])  # (72, 256)
        self.cqt_bank = torch.tensor(both[:, None, :], dtype=dtype, device=device)
        self.cqt_norm = torch.tensor(norm, dtype=dtype, device=device)
        self.lowpass = torch.tensor(octave_lowpass()[None, None, :], dtype=dtype, device=device)
        self.dec_taps = torch.tensor(decimator_taps()[None, None, :], dtype=dtype, device=device)

    # -- audio to windows ---------------------------------------------------

    def to_22k(self, audio: torch.Tensor, sample_rate: int, length: int) -> torch.Tensor:
        """The 22.05 kHz signal at indices -PAD_FRONT .. length - PAD_FRONT - 1:
        y[m] = sum_j h[j] x[2m + j - 128] at 44.1 kHz, x itself at 22.05 kHz,
        zero outside the recording."""
        x = audio.to(self.dtype)
        if sample_rate == 2 * SR:
            lead = 2 * PAD_FRONT + 128
            need = 2 * length + 256
            z = F.pad(x, (lead, max(0, need - lead - x.shape[0])))[:need]
            return F.conv1d(z[None, None], self.dec_taps, stride=2)[0, 0, :length]
        if sample_rate != SR:
            raise ValueError(f"expected 22050 or 44100 Hz, got {sample_rate}")
        return F.pad(x, (PAD_FRONT, max(0, length - PAD_FRONT - x.shape[0])))[:length]

    @staticmethod
    def geometry(n_samples: int, sample_rate: int) -> Tuple[int, int]:
        """(windows, valid frames) of a recording."""
        length = -(-n_samples // 2) if sample_rate == 2 * SR else n_samples
        n_windows = max(1, -(-(length + PAD_FRONT) // WINDOW_HOP))
        return n_windows, int(length / WINDOW_HOP * (FRAMES - 2 * TRIM))

    # -- the model ----------------------------------------------------------

    def _decimate(self, x: torch.Tensor) -> torch.Tensor:
        n_out = (x.shape[-1] - 2) // 2 + 1
        z = F.pad(x, (127, 2 * n_out + 256))
        return F.conv1d(z[:, None], self.lowpass, stride=2)[:, 0, :n_out]

    def cqt(self, audio: torch.Tensor) -> torch.Tensor:
        """(b, 43 844) -> (b, 172, 309) magnitudes, low bin first."""
        octaves = []
        x, hop = audio, HOP
        for octave in range(N_OCTAVES):
            if octave > 0:
                x = self._decimate(x)
                hop //= 2
            padded = F.pad(x[:, None], (128, 128), mode="reflect")
            both = F.conv1d(padded, self.cqt_bank, stride=hop)[:, :, :FRAMES]  # (b, 72, 172)
            octaves.append(torch.sqrt(both[:, :36] ** 2 + both[:, 36:] ** 2))
        full = torch.cat(octaves[::-1], dim=1)[:, -N_BINS:] * self.cqt_norm[None, :, None]
        return full.transpose(1, 2)

    @staticmethod
    def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride=(1, 1)) -> torch.Tensor:
        kh, kw = w.shape[0], w.shape[1]
        pads = []
        for size, k, s in ((x.shape[3], kw, stride[1]), (x.shape[2], kh, stride[0])):
            total = max((math.ceil(size / s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), w.permute(3, 2, 0, 1), b, stride=stride)

    @staticmethod
    def _bn(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, train: bool):
        shape = (1, -1, 1, 1)
        if train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        else:
            mean, var = p[f"{name}/mean"], p[f"{name}/var"]
        y = (x - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
        y = y * p[f"{name}/gamma"].view(shape) + p[f"{name}/beta"].view(shape)
        return y, (mean.detach(), var.detach()) if train else None

    def forward(self, p: Dict[str, torch.Tensor], audio: torch.Tensor, train: bool = False):
        """(b, 43 844) at 22.05 kHz -> ({"note", "onset": (b, 172, 88),
        "contour": (b, 172, 264)}, {bn name: (mean, var)} in train mode)."""
        power = self.cqt(audio) ** 2
        db = 10.0 * torch.log10(power + 1e-10)
        offset = db - torch.amin(db, dim=(1, 2), keepdim=True)
        top = torch.amax(offset, dim=(1, 2), keepdim=True)
        x = torch.where(top > 0, offset / top, torch.zeros_like(offset))[:, None]  # (b, 1, t, 309)
        stats = {}
        x, stats["bn_cqt"] = self._bn(x, p, "bn_cqt", train)
        channels = []
        for h in HARMONICS:
            shift = int(round(BINS_PER_OCTAVE * math.log2(h)))
            if shift > 0:
                channels.append(F.pad(x[..., shift:], (0, shift)))
            elif shift < 0:
                channels.append(F.pad(x[..., :shift], (-shift, 0)))
            else:
                channels.append(x)
        x = torch.cat(channels, dim=1)[..., :CONTOUR_BINS]  # (b, 8, t, 264)

        def conv(name, inp):
            return self._conv(inp, p[f"{name}/w"], p[f"{name}/b"], STRIDES.get(name, (1, 1)))

        c, stats["bn_contour"] = self._bn(conv("contour_conv", x), p, "bn_contour", train)
        contour = torch.sigmoid(conv("contour_out", torch.relu(c)))
        note = torch.sigmoid(conv("note_out", torch.relu(conv("note_conv", contour))))
        o, stats["bn_onset"] = self._bn(conv("onset_conv", x), p, "bn_onset", train)
        onset = torch.sigmoid(conv("onset_out", torch.cat([note, torch.relu(o)], dim=1)))
        return {"note": note[:, 0], "onset": onset[:, 0], "contour": contour[:, 0]}, stats

    @torch.no_grad()
    def posteriorgrams(
        self, p: Dict[str, torch.Tensor], audio: np.ndarray, sample_rate: int, block: int = 32
    ) -> Dict[str, np.ndarray]:
        """A whole recording (int16 scaled by 1/32768, or float) -> its
        (frames, bins) note, onset and contour posteriorgrams, as float64."""
        n_windows, n_frames = self.geometry(len(audio), sample_rate)
        x = torch.as_tensor(audio, device=self.device)
        if x.dtype == torch.int16:
            x = x.to(self.dtype) / 32768.0
        y = self.to_22k(x, sample_rate, n_windows * WINDOW_HOP + WINDOW - WINDOW_HOP)
        pieces = {"note": [], "onset": [], "contour": []}
        for lo in range(0, n_windows, block):
            hi = min(n_windows, lo + block)
            windows = y.unfold(0, WINDOW, WINDOW_HOP)[lo:hi]
            out, _ = self.forward(p, windows)
            for k, v in out.items():
                pieces[k].append(v[:, TRIM : FRAMES - TRIM].reshape(-1, v.shape[-1]).double().cpu())
        return {k: torch.cat(v)[:n_frames].numpy() for k, v in pieces.items()}
