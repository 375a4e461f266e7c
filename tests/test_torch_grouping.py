"""PyTorch port, compute grouping (`StreamingTranscriber(compute_group=k)`):
k uploaded pieces feed one model call, split back per piece before the trim
and the bend matrix. Held against itself across k and against the JAX
transcriber with the same k, on the CPU at two windows per chunk.

The tone mix lasts 14 s: nine windows, five chunks, so every k here leaves
a remainder group (2+2+1 at k = 2, 3+2 at k = 3).
"""

import numpy as np
import pytest
import torch

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_tpu import pipeline as j_pipeline
from torch_port_helpers import SR, one_torch_thread, tone_mix  # noqa: F401


@pytest.fixture(scope="module")
def audio():
    return tone_mix(SR, seconds=14.0, seed=0)


@pytest.fixture(scope="module")
def by_k(audio):
    out = {}
    for k in (1, 2, 3):
        tr = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", compute_group=k)
        assert tr._geometry(audio, SR)[2] == 5
        (events, post), = tr.transcribe_batch([(audio, SR)], return_model_outputs=True)
        out[k] = (events, post)
    return out


@pytest.mark.parametrize("k", [2, 3])
def test_grouping_is_transparent(by_k, k):
    """Events as the ungrouped transcriber gives them (the check of the JAX
    package's tests/test_pipeline.py), posteriorgrams within float32
    rounding of a larger batch."""
    base_events, base_post = by_k[1]
    events, post = by_k[k]
    assert len(base_events) > 4 and len(events) == len(base_events)
    for a, b in zip(sorted(base_events), sorted(events)):
        assert a[2] == b[2] and abs(a[0] - b[0]) < 1e-9 and abs(a[1] - b[1]) < 1e-9
    for key in base_post:
        np.testing.assert_allclose(post[key], base_post[key], atol=1e-5, rtol=0, err_msg=key)


def test_grouped_matches_jax_grouped(by_k, audio):
    jax_tr = j_pipeline.StreamingTranscriber(windows_per_chunk=2, decode_backend="xla", pcm_transport="raw", compute_group=2)
    (ref_events, ref_post), = jax_tr.transcribe_batch([(audio, SR)], return_model_outputs=True)
    events, post = by_k[2]
    for key in ref_post:
        assert post[key].shape == ref_post[key].shape
        np.testing.assert_allclose(post[key], ref_post[key], atol=1e-4, rtol=0, err_msg=key)
    assert [e[:3] for e in events] == [e[:3] for e in ref_events]
    for a, b in zip(events, ref_events):
        assert abs(a[3] - b[3]) <= 1e-4


def test_grouped_upload_reuses_the_pinned_buffer_safely():
    """Each upload waits for the previous copy out of the single pinned
    buffer before overwriting it: on the CPU no buffer is used, so the
    contract reduces to every piece arriving intact (the last one with its
    one needed window only) and the model calls taking their windows in
    order, k*W at a time and the rest padded to a whole chunk."""
    y = np.ascontiguousarray(tone_mix(SR, seconds=14.0, seed=5))
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", compute_group=2)
    uploaded, calls = [], []
    real_upload, real_call = tr._upload_piece, tr._model_call

    def upload(piece, packed, device, key):
        x = real_upload(piece, packed, device, key)
        uploaded.append(x.clone())
        return x

    def call(batch):
        calls.append(batch.clone())
        return real_call(batch)

    tr._upload_piece, tr._model_call = upload, call
    tr.posteriorgrams(y, SR)
    assert [len(batch) for batch in calls] == [4, 4, 2]
    sizes = [2, 2, 2, 2, 1]  # nine windows
    hosts = [tr._row(y, False, 2 * c, m) for c, m in enumerate(sizes)]
    assert len(uploaded) == len(hosts)
    for got, want in zip(uploaded, hosts):
        np.testing.assert_array_equal(got.numpy(), want)
    windows = torch.cat([t_pipeline.unfold_windows(x, m) for x, m in zip(uploaded, sizes)])
    run = torch.cat(calls)
    torch.testing.assert_close(run[:9], windows, rtol=0, atol=0)
    assert not run[9:].any()  # the padding of the last chunk
