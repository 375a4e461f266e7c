"""PyTorch port, window-parallel inference: `StreamingTranscriber(devices=...)`
and `parallel/mesh.py`, on the CPU.

The port's transcriber over ``["cpu"] * 8`` at W = 8 against its own
single-device transcriber and against the JAX transcriber over the
conftest's 8 virtual devices (`mesh=make_mesh()`, as
`tests/test_parallel.py` runs it), on the same seeded audio: 22.05 kHz
float32, 44.1 kHz int16 and 22.05 kHz int16 through the codec. Events must
be equal (amplitudes within 1e-4, the JAX dry run's bound) or agree by the
one-flip rule; posteriorgrams within 5e-3 of JAX's (the bound of
`tests/test_inference.py:147`) and within 1e-4 of the port's single
device's. Each shard uploads at most 1/N of the single device's raw bytes plus
the halo of each chunk, and a row that owns none of a recording's needed
windows uploads nothing. A device list packs a call's windows into shared
steps as one device does, and gives one device's events and posteriorgrams
at the shard batch bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.parallel import mesh as t_mesh
from basic_pitch_tpu import pipeline as j_pipeline
from basic_pitch_tpu.parallel import mesh as j_mesh
from torch_port_helpers import assert_events_agree, one_torch_thread, to_pcm16, tone_mix  # noqa: F401

SR = 22050
W = 8
N = 8
AMP_ATOL = 1e-4  # __graft_entry__.py's dry-run bound on amplitudes
JAX_POST_ATOL = 5e-3  # tests/test_inference.py:147
PORT_POST_ATOL = 1e-4


def _audio(case):
    y = tone_mix(SR, 12.0, seed=4)
    if case == "22k-float32":
        return y, SR, "raw"
    if case == "44k-int16":
        return to_pcm16(np.repeat(y, 2)), 2 * SR, "codec"
    return to_pcm16(y), SR, "codec"


def _assert_events_match(events, ref):
    """Equal (start, end, pitch) and bends with amplitudes within AMP_ATOL,
    or the one-flip rule."""
    if [e[:3] for e in events] == [e[:3] for e in ref]:
        for a, b in zip(events, ref):
            assert abs(a[3] - b[3]) <= AMP_ATOL, (a, b)
            assert list(a[4] or []) == list(b[4] or []), (a, b)
    else:
        assert_events_agree(events, ref)


@pytest.fixture(scope="module")
def transcribers():
    made = {}
    for transport in ("raw", "codec"):
        made[transport] = (
            t_pipeline.StreamingTranscriber(windows_per_chunk=W, devices=["cpu"] * N, pcm_transport=transport),
            t_pipeline.StreamingTranscriber(windows_per_chunk=W, device="cpu", pcm_transport=transport),
        )
    return made


@pytest.fixture(scope="module")
def jax_mesh_transcriber():
    if len(jax.devices()) < N:
        pytest.fail(f"the conftest gives {len(jax.devices())} JAX devices, expected {N}")
    return j_pipeline.StreamingTranscriber(windows_per_chunk=W, mesh=j_mesh.make_mesh())


@pytest.mark.parametrize("case", ["22k-float32", "44k-int16", "22k-int16-codec"])
def test_sharded_events_match_single_device_and_jax_mesh(case, transcribers, jax_mesh_transcriber):
    audio, sr, transport = _audio(case)
    sharded, single = transcribers[transport]
    ev_sharded = sharded.transcribe(audio, sr)
    assert ev_sharded
    _assert_events_match(ev_sharded, single.transcribe(audio, sr))
    _assert_events_match(ev_sharded, jax_mesh_transcriber.transcribe(audio, sr))


@pytest.mark.parametrize("case", ["22k-float32", "44k-int16"])
def test_sharded_posteriorgrams_match(case, transcribers, jax_mesh_transcriber):
    audio, sr, transport = _audio(case)
    sharded, single = transcribers[transport]
    got = sharded.posteriorgrams(audio, sr)
    ref = single.posteriorgrams(audio, sr)
    jref = jax_mesh_transcriber.posteriorgrams(audio, sr)
    for key in ("note", "onset", "contour"):
        assert got[key].shape == ref[key].shape == np.asarray(jref[key]).shape, key
        assert float(np.abs(got[key] - ref[key]).max()) <= PORT_POST_ATOL, key
        assert float(np.abs(got[key] - np.asarray(jref[key])).max()) <= JAX_POST_ATOL, key


@pytest.mark.parametrize("case", ["22k-float32", "44k-int16", "22k-int16-codec"])
def test_per_shard_upload_within_one_over_n_plus_halo(case, transcribers):
    """Keys "cpu/<row>" (the device repeats, so one count per shard); each at
    most the single device's raw bytes / N plus the overlap halo of every
    chunk (at 44.1 kHz twice the overlap plus the decimator's halos). The
    codec only shrinks that: a row goes packed only when that is smaller
    than the row (the JAX rule), and some row here does."""
    audio, sr, transport = _audio(case)
    sharded = transcribers[transport][0]
    single_raw = transcribers["raw"][1]
    sharded.piece_upload_bytes.clear()
    single_raw.piece_upload_bytes.clear()
    sharded.transcribe_batch([(audio, sr)])
    single_raw.transcribe_batch([(audio, sr)])
    per_shard = sharded.piece_upload_bytes
    assert sorted(per_shard) == sorted(f"cpu/{r}" for r in range(N))
    total_single = sum(single_raw.piece_upload_bytes.values())
    n_chunks = sharded._geometry(audio, sr)[2]
    halo = t_pipeline.OVERLAP if sr == SR else 2 * (t_pipeline.OVERLAP + t_pipeline._DEC_HALO)
    bound = total_single / N + n_chunks * halo * audio.itemsize
    assert max(per_shard.values()) <= bound, (per_shard, bound)
    row_span = (W // N) * t_pipeline.HOP + t_pipeline.OVERLAP  # one row's windows plus the overlap halo
    raw_row = n_chunks * (row_span if sr == SR else 2 * row_span + 2 * t_pipeline._DEC_HALO) * audio.itemsize
    assert max(per_shard.values()) <= raw_row
    if transport == "codec":
        assert min(per_shard.values()) < raw_row
    else:
        assert set(per_shard.values()) == {raw_row}


@pytest.mark.parametrize("rate", [SR, 2 * SR])
def test_sharded_equals_single_device_at_the_shard_batch(rate):
    """Two shards of W = 4 run the model on 2 windows each, as one device at
    W = 2 does on each of its chunks: the same windows through the same
    kernels, so events and posteriorgrams are equal bit for bit (the card's
    check, `chip_smoke.py` phase 9, is the same at W = 128 against 64)."""
    y = tone_mix(SR, 12.0, seed=4)
    audio = y if rate == SR else to_pcm16(np.repeat(y, 2))
    sharded = t_pipeline.StreamingTranscriber(windows_per_chunk=4, devices=["cpu"] * 2, pcm_transport="raw")
    single = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", pcm_transport="raw")
    assert sharded.transcribe(audio, rate) == single.transcribe(audio, rate)
    got, ref = sharded.posteriorgrams(audio, rate), single.posteriorgrams(audio, rate)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


def test_device_list_events_equal_one_device_in_a_multi_recording_call():
    """A call of three recordings (22.05 and 44.1 kHz): both the device list
    (steps of two rows of two windows) and the one device at the shard
    batch pack the call's windows into shared steps. The 44.1 kHz recording
    starts at window 3, inside a row, so its pieces there start inside its
    two-window slices and are decimated on the slices' grid; the same
    windows through the same kernels give the same events and
    posteriorgrams, bit for bit."""
    recordings = [
        (tone_mix(SR, 4.0, seed=1), SR), (to_pcm16(np.repeat(tone_mix(SR, 3.0, seed=2), 2)), 2 * SR), (tone_mix(SR, 7.0, seed=3), SR)]
    sharded = t_pipeline.StreamingTranscriber(windows_per_chunk=4, devices=["cpu"] * 2, pcm_transport="raw")
    single = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", pcm_transport="raw")
    got = sharded.transcribe_batch(recordings, return_model_outputs=True)
    ref = single.transcribe_batch(recordings, return_model_outputs=True)
    assert all(events for events, _ in got) and [e for e, _ in got] == [e for e, _ in ref]
    for (_, post), (_, post_ref) in zip(got, ref):
        for key in post_ref:
            np.testing.assert_array_equal(post[key], post_ref[key], err_msg=key)


@pytest.mark.parametrize("rate", [SR, 2 * SR])
def test_short_recording_uploads_only_the_rows_it_needs(rate):
    """Three needed windows over four rows of two: rows 0 and 1 upload their
    windows plus the halo, rows 2 and 3 nothing (no zero tails); the model
    still runs every row at the shard batch, and the events and
    posteriorgrams are one device's at that batch, bit for bit."""
    y = tone_mix(SR, 4.0, seed=6)
    audio = y if rate == SR else to_pcm16(np.repeat(y, 2))
    assert t_pipeline._needed_windows(len(audio), rate != SR) == 3
    sharded = t_pipeline.StreamingTranscriber(windows_per_chunk=8, devices=["cpu"] * 4, pcm_transport="raw")
    single = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", pcm_transport="raw")
    (got,) = sharded.transcribe_batch([(audio, rate)], return_model_outputs=True)
    (ref,) = single.transcribe_batch([(audio, rate)], return_model_outputs=True)
    halo = 0 if rate == SR else 2 * t_pipeline._DEC_HALO
    scale = 1 if rate == SR else 2
    assert sharded.piece_upload_bytes == {
        f"cpu/{r}": (scale * (m * t_pipeline.HOP + t_pipeline.OVERLAP) + halo) * audio.itemsize for r, m in ((0, 2), (1, 1))}
    assert got[0] and got[0] == ref[0]
    for key in ref[1]:
        np.testing.assert_array_equal(got[1][key], ref[1][key], err_msg=key)


def test_windows_must_divide_across_devices():
    with pytest.raises(ValueError, match="must divide across 4 devices"):
        t_pipeline.StreamingTranscriber(windows_per_chunk=6, devices=["cpu"] * 4)


def test_compute_group_is_forced_to_one(transcribers):
    sharded, single = transcribers["raw"]
    assert sharded.compute_group == 1 and single.compute_group == 2
    assert t_pipeline.StreamingTranscriber(windows_per_chunk=4, devices=["cpu"] * 2, compute_group=4).compute_group == 1
    # a list of one is one device: it keeps k
    assert t_pipeline.StreamingTranscriber(windows_per_chunk=4, devices=["cpu"]).compute_group == 2


def test_device_and_devices_are_exclusive():
    with pytest.raises(ValueError, match="not both"):
        t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", devices=["cpu"] * 2)


def test_devices_naming_cuda_without_a_gpu_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pipeline.StreamingTranscriber(windows_per_chunk=2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh()


def test_mesh_helpers():
    mesh = t_mesh.make_mesh(["cpu"] * 4)
    assert mesh == [torch.device("cpu")] * 4 and t_mesh.distinct(mesh) == [torch.device("cpu")]
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    parts = t_mesh.shard_batch(mesh, {"a": x, "b": {"c": torch.arange(8)}})
    assert len(parts) == 4
    for r, part in enumerate(parts):
        np.testing.assert_array_equal(part["a"].numpy(), x[4 * r : 4 * r + 4])
        assert part["b"]["c"].tolist() == [2 * r, 2 * r + 1]
    with pytest.raises(ValueError, match="does not divide"):
        t_mesh.shard_batch(mesh, np.zeros((6, 2)))
    model = torch.nn.Linear(2, 2)
    copies = t_mesh.replicate(mesh, model)
    assert len(copies) == 4 and all(c is model for c in copies)
    t = torch.ones(3)
    assert all(c.device.type == "cpu" for c in t_mesh.replicate(["cpu", "cpu"], t))
    with pytest.raises(ValueError):
        t_mesh.make_mesh([])
