"""PyTorch port, greedy note decode against the JAX decoders.

`decode_plain` (the CPU path, and the twin the CUDA kernel is held against)
must reproduce JAX `device.decode`: starts, ends and pitches exactly,
amplitudes within 2e-6 (their sums run in another order), `n_notes` and
`overflow` equal. The fuzz cases mirror tests/test_pallas_decode.py. The
kernel itself is checked on the card by tests/test_torch_kernel_cuda.py
and by chip_smoke.py.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from basic_pitch_torch.decode import device as t_device
from basic_pitch_torch.decode import greedy_kernel
from basic_pitch_tpu.decode import device as j_device
from basic_pitch_tpu.decode import pallas_kernel
from basic_pitch_tpu.inference import unwrap_output

GOLDENS = pathlib.Path(__file__).parent / "goldens"


def _assert_same(ref, out, expect_overflow=None):
    n1, n2 = int(ref.n_notes), int(out.n_notes)
    assert n1 == n2, (n1, n2)
    assert bool(ref.overflow) == bool(out.overflow)
    if expect_overflow is not None:
        assert bool(out.overflow) == expect_overflow
    for field in ("starts", "ends", "pitches"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, field)[:n1]), getattr(out, field)[:n1].numpy(), err_msg=field
        )
    np.testing.assert_allclose(
        np.asarray(ref.amplitudes[:n1]), out.amplitudes[:n1].numpy(), atol=2e-6, rtol=0
    )
    return n1


def _compare(frames, onsets, melodia, max_notes=2048, onset_t=0.5, frame_t=0.3, min_len=5,
             max_iters=None, valid_frames=None, expect_overflow=None):
    max_iters = 4 * max_notes if max_iters is None else max_iters
    ref = jax.jit(
        lambda f, o: j_device.decode(
            f, o, onset_t, frame_t, min_len, None, True, melodia,
            max_notes=max_notes, max_melodia_iters=max_iters, valid_frames=valid_frames,
        )
    )(frames, onsets)
    out = t_device.decode_plain(
        torch.from_numpy(frames), torch.from_numpy(onsets), onset_t, frame_t, min_len,
        melodia_trick=melodia, max_notes=max_notes, max_melodia_iters=max_iters,
        valid_frames=valid_frames,
    )
    return _assert_same(ref, out, expect_overflow)


def _fuzz(seed, n_frames, p_frames=3, p_onsets=5):
    rng = np.random.RandomState(seed)
    frames = (rng.rand(n_frames, 88) ** p_frames).astype(np.float32)
    onsets = (rng.rand(n_frames, 88) ** p_onsets).astype(np.float32)
    return frames, onsets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_parity_with_melodia(seed):
    frames, onsets = _fuzz(seed, 300)
    assert _compare(frames, onsets, melodia=True, max_notes=8192) > 100


def test_onset_stage_only():
    frames, onsets = _fuzz(3, 300)
    assert _compare(frames, onsets, melodia=False) > 10


def test_multi_slab_timeline():
    frames, onsets = _fuzz(7, 1500)
    _compare(frames, onsets, melodia=True, max_notes=8192)


def test_dense_low_thresholds():
    frames, onsets = _fuzz(8, 300, 2, 4)
    _compare(frames, onsets, melodia=True, onset_t=0.3, frame_t=0.15, max_notes=8192)


def test_padded_tail_is_ignored():
    """valid_frames shorter than the arrays decodes as if they ended there."""
    frames, onsets = _fuzz(9, 400)
    _compare(frames, onsets, melodia=True, valid_frames=333, max_notes=8192)


def test_candidate_capacity_scales_with_frames():
    """~3200 onset candidates with max_notes 2048: no overflow when the
    candidate list scales with T, as in the JAX decoder."""
    T = 6400
    frames = np.zeros((T, 88), np.float32)
    onsets = np.zeros((T, 88), np.float32)
    rng = np.random.RandomState(11)
    for t in range(2, T - 2, 2):
        onsets[t, rng.randint(0, 88)] = 0.9
    assert _compare(frames, onsets, melodia=False, expect_overflow=False) == 0


def long_notes(n_frames=3100):
    """A 2040-frame onset note and a 2900-frame melodia note whose seed
    sits near its end, so both walks cross several 1024-frame chunks."""
    frames = np.zeros((n_frames, 88), np.float32)
    onsets = np.zeros((n_frames, 88), np.float32)
    frames[10:2050, 40] = 0.9
    onsets[9:12, 40] = (0.2, 0.9, 0.2)
    frames[100:3000, 60] = 0.5
    frames[2500, 60] = 0.95
    return frames, onsets


def test_long_notes_cross_chunks():
    frames, onsets = long_notes()
    assert _compare(frames, onsets, melodia=True) == 2


@pytest.mark.parametrize("cap", ["notes", "melodia_iters"])
def test_forced_overflow(cap):
    frames, onsets = _fuzz(5, 300)
    if cap == "notes":
        n = _compare(frames, onsets, melodia=True, max_notes=40, expect_overflow=True)
        assert n == 40
    else:
        _compare(frames, onsets, melodia=True, max_notes=8192, max_iters=50, expect_overflow=True)


def test_matches_pallas_kernel_interpret():
    frames, onsets = _fuzz(0, 300)
    ref = pallas_kernel.decode_pallas(
        frames, onsets, 0.5, 0.3, 5, melodia_trick=True,
        max_notes=2048, max_melodia_iters=8192, interpret=True,
    )
    out = greedy_kernel.decode_greedy(
        torch.from_numpy(frames), torch.from_numpy(onsets), 0.5, 0.3, 5,
        melodia_trick=True, max_notes=2048, max_melodia_iters=8192,
    )
    assert _assert_same(ref, out) > 100


def test_vocadito_posteriorgrams_decode_like_jax():
    golden = np.load(GOLDENS / "vocadito_windows.npz")
    length = int(golden["original_length"])
    note = unwrap_output(golden["note"], length, 30)
    onset = unwrap_output(golden["onset"], length, 30)
    ref = jax.jit(lambda f, o: j_device.decode(f, o, 0.5, 0.3, 11))(note, onset)
    out = t_device.decode_plain(torch.from_numpy(note), torch.from_numpy(onset), 0.5, 0.3, 11)
    assert _assert_same(ref, out, expect_overflow=False) > 5


def test_bend_matrix_matches_jax():
    contours = np.random.RandomState(13).rand(500, 264).astype(np.float32)
    contours[:, :30] = 0.0  # ties at the low edge take the first index
    ref = np.asarray(jax.jit(j_device.bend_matrix)(contours))
    out = t_device.bend_matrix(torch.from_numpy(contours)).numpy()
    assert out.dtype == np.int8
    np.testing.assert_array_equal(out, ref)


def test_gather_note_bends_matches_jax():
    frames, onsets = _fuzz(1, 600)
    bends = np.random.RandomState(14).randint(-25, 26, size=(600, 88)).astype(np.int8)
    ref_dec = jax.jit(lambda f, o: j_device.decode(f, o, 0.5, 0.3, 5, max_notes=8192))(frames, onsets)
    ref = np.asarray(jax.jit(j_device.gather_note_bends)(bends, ref_dec))
    dec = t_device.DecodedNotes(*(torch.from_numpy(np.array(x)) for x in ref_dec))
    out = t_device.gather_note_bends(torch.from_numpy(bends), dec).numpy()
    assert int(ref_dec.n_notes) > 100
    np.testing.assert_array_equal(out, ref)


def test_cuda_tensor_never_takes_the_plain_path():
    """Only CPU tensors reach decode_plain; any other device raises."""
    frames = torch.zeros((300, 88), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        greedy_kernel.decode_greedy(frames, frames, 0.5, 0.3, 5)
