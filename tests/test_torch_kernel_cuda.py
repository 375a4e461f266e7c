"""PyTorch port, the CUDA greedy-decode kernel against its plain version.

Needs an NVIDIA GPU and nvcc; every test here is marked `cuda` and skips
without a card. It imports no JAX, so on the GPU machine it runs without
the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from basic_pitch_torch.decode import device as t_device
from basic_pitch_torch.decode import greedy_kernel
from torch_decode_cases import DEFAULTS, adversarial_cases


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fuzz(seed, n_frames, p_frames=3, p_onsets=5):
    rng = np.random.RandomState(seed)
    frames = (rng.rand(n_frames, 88) ** p_frames).astype(np.float32)
    onsets = (rng.rand(n_frames, 88) ** p_onsets).astype(np.float32)
    return frames, onsets


@pytest.mark.cuda
@pytest.mark.parametrize(
    "seed,n_frames,kw",
    [
        (0, 300, {}),
        (7, 1500, {}),
        (3, 300, dict(melodia_trick=False)),
        (8, 300, dict(onset_thresh=0.3, frame_thresh=0.15)),
        (5, 300, dict(max_notes=40)),
        (9, 400, dict(valid_frames=333)),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, seed, n_frames, kw):
    frames, onsets = _fuzz(seed, n_frames)
    args = dict(onset_thresh=0.5, frame_thresh=0.3, min_note_len=5, max_notes=8192, max_melodia_iters=32768)
    args.update(kw)
    f = torch.from_numpy(frames).to(cuda_device)
    o = torch.from_numpy(onsets).to(cuda_device)
    before = greedy_kernel.launches
    out = greedy_kernel.decode_greedy(f, o, **args)
    torch.cuda.synchronize()
    assert greedy_kernel.launches == before + 1
    ref = t_device.decode_plain(f, o, **args)
    n = int(ref.n_notes)
    assert int(out.n_notes) == n and bool(out.overflow) == bool(ref.overflow)
    for field in ("starts", "ends", "pitches"):
        np.testing.assert_array_equal(getattr(out, field)[:n].cpu().numpy(), getattr(ref, field)[:n].cpu().numpy())
    np.testing.assert_allclose(out.amplitudes[:n].cpu().numpy(), ref.amplitudes[:n].cpu().numpy(), atol=2e-6, rtol=0)


ADVERSARIAL = {name: (frames, onsets, kw) for name, frames, onsets, kw in adversarial_cases()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_cases_on_card(cuda_device, case):
    """Notes walked or seeded in one batch whose zeroing meets each other's
    frames, ties, and caps reached mid-batch: the kernel's in-order commit
    must give exactly the plain decoder's notes."""
    frames, onsets, kw = ADVERSARIAL[case]
    args = dict(DEFAULTS, **kw)
    f = torch.from_numpy(frames).to(cuda_device)
    o = torch.from_numpy(onsets).to(cuda_device)
    out = greedy_kernel.decode_greedy(f, o, **args)
    ref = t_device.decode_plain(f, o, **args)
    n = int(ref.n_notes)
    assert n > 0 and int(out.n_notes) == n and bool(out.overflow) == bool(ref.overflow)
    for field in ("starts", "ends", "pitches"):
        np.testing.assert_array_equal(getattr(out, field)[:n].cpu().numpy(), getattr(ref, field)[:n].cpu().numpy())
    np.testing.assert_allclose(out.amplitudes[:n].cpu().numpy(), ref.amplitudes[:n].cpu().numpy(), atol=2e-6, rtol=0)


@pytest.mark.cuda
def test_long_notes_cross_chunks_on_card(cuda_device):
    """Walks across several 1024-frame chunks, forward and backward."""
    frames = np.zeros((3100, 88), np.float32)
    onsets = np.zeros((3100, 88), np.float32)
    frames[10:2050, 40] = 0.9
    onsets[9:12, 40] = (0.2, 0.9, 0.2)
    frames[100:3000, 60] = 0.5
    frames[2500, 60] = 0.95
    f, o = torch.from_numpy(frames).to(cuda_device), torch.from_numpy(onsets).to(cuda_device)
    out = greedy_kernel.decode_greedy(f, o, 0.5, 0.3, 5)
    ref = t_device.decode_plain(f, o, 0.5, 0.3, 5)
    assert int(out.n_notes) == int(ref.n_notes) == 2
    for field in ("starts", "ends", "pitches"):
        np.testing.assert_array_equal(getattr(out, field)[:2].cpu().numpy(), getattr(ref, field)[:2].cpu().numpy())
    np.testing.assert_allclose(out.amplitudes[:2].cpu().numpy(), ref.amplitudes[:2].cpu().numpy(), atol=2e-6, rtol=0)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    f = torch.zeros((300, 88), device=cuda_device)
    with pytest.raises(ValueError):
        greedy_kernel.decode_greedy(f.double(), f.double(), 0.5, 0.3, 5)
    with pytest.raises(ValueError):
        greedy_kernel.decode_greedy(f[:, :80], f[:, :80], 0.5, 0.3, 5)
    with pytest.raises(ValueError):
        greedy_kernel.decode_greedy(f, f.cpu(), 0.5, 0.3, 5)
