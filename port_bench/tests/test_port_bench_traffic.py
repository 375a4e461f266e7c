"""The generator: the same seed gives the same traffic, every seed the same
sizes, and each mix its parameters."""

import json

import numpy as np
import pytest

from pb import bench, traffic

MIXES = {p.stem: json.loads(p.read_text()) for p in (bench.BENCH_DIR / "traffic").glob("*.json")}
SEED = 2**31 + 12345
# the mixes of recordings, whatever kind runs them
RECORDING_MIXES = sorted(n for n, s in MIXES.items() if "durations" in s)


def small(spec):
    spec = json.loads(json.dumps(spec))
    spec.update(snippet_s=1, snippets_per_level=1, pool=min(spec["pool"], 6))
    return spec


@pytest.mark.parametrize("name", RECORDING_MIXES)
def test_recordings_are_seeded(name):
    spec = small(MIXES[name])
    spec["durations"] = {"dist": "loguniform", "min_s": 0.5, "max_s": 2} if spec["durations"]["dist"] != "fixed" else {"dist": "fixed", "seconds": 1}
    a, b, c = (traffic.recordings(s, spec) for s in (SEED, SEED, SEED + 1))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in zip(a, c))
    # another seed: the same sizes and voice counts in the same order
    assert [p for p, _ in a] == [p for p, _ in c]
    for p, x in a:
        assert x.dtype == np.int16 and len(x) == p["samples"]


@pytest.mark.parametrize("name", RECORDING_MIXES)
def test_durations_and_voices_keep_to_the_mix(name):
    spec = MIXES[name]
    plan = traffic.recording_plan(spec)
    secs = [p["seconds"] for p in plan]
    d = spec["durations"]
    lo, hi = (d["seconds"], d["seconds"]) if d["dist"] == "fixed" else (d["min_s"], d["max_s"])
    assert lo <= min(secs) and max(secs) <= hi
    vox = [p["voices"] for p in plan]
    assert spec["voices"]["min"] == min(vox) and max(vox) == spec["voices"]["max"]
    if d["dist"] == "loguniform":
        # log-uniform: the median is the geometric mean of the ends
        assert np.median(secs) == pytest.approx(np.sqrt(lo * hi), rel=0.05)


def test_offline_mixed_durations():
    plan = traffic.recording_plan(MIXES["offline-mixed"])
    secs = np.array([p["seconds"] for p in plan])
    assert secs.mean() == pytest.approx(159, rel=0.06)
    assert 0.65 <= np.mean(secs <= 128 * 36164 / 22050) <= 0.78  # one 128-window chunk


def test_schedule_rate_and_order():
    spec = MIXES["serve-poisson"]
    a = traffic.schedule(spec, 10.0, 30.0)
    assert abs(len(a) - 300) <= 2
    times = [t for t, _ in a]
    assert times == sorted(times) and times[0] == 0.0 and times[-1] < 30.0
    gaps = np.diff(times)
    assert gaps.mean() == pytest.approx(0.1, rel=0.05)
    assert np.std(gaps) / gaps.mean() == pytest.approx(1.0, abs=0.15)  # exponential
    assert {c for _, c in a} == set(range(spec["pool"]))


def test_wav_bytes_round_trip():
    from basic_pitch_torch.serve import decode_wav_request

    x = (np.arange(1000) - 500).astype(np.int16)
    samples, sr = decode_wav_request(traffic.wav_bytes(x, 44100))
    assert sr == 44100 and np.array_equal(samples, x)


def test_train_batches_layout():
    spec = dict(MIXES["b16-highest"], pool=2)
    a = traffic.train_batches(SEED, spec, 3)
    b = traffic.train_batches(SEED, spec, 3)
    assert len(a) == 2
    for x, y in zip(a, b):
        assert np.array_equal(x["audio"], y["audio"]) and x["audio"].shape == (3, 43844) and x["audio"].dtype == np.int16
        for head, bins in traffic.HEAD_BINS.items():
            sp = x["targets_sparse"][head]
            assert sp["idx"].dtype == np.int32 and sp["val"].dtype == np.float32
            assert sp["idx"].shape[1] >= traffic.SPARSE_CAP_FLOORS[head]
            assert sp["idx"].max() <= 172 * bins
        dense = traffic.dense_targets(x)
        assert dense["note"].shape == (3, 172, 88) and dense["contour"].shape == (3, 172, 264)
        assert dense["note"].sum() > 0 and set(np.unique(dense["onset"])) <= {0.0, 1.0}


def test_sparse_targets_materialize_as_the_loader_does():
    """The port's materialize_batch gives the generator's dense targets."""
    import torch

    from basic_pitch_torch.train import loop

    batch = traffic.train_batches(SEED, dict(MIXES["b16-highest"], pool=1), 2)[0]
    dev, _ = loop.upload_batch(batch, torch.device("cpu"))
    mat = loop.materialize_batch(dev)
    for head, dense in traffic.dense_targets(batch).items():
        assert np.array_equal(mat["targets"][head].numpy(), dense)
    assert np.array_equal(mat["audio"].numpy(), batch["audio"] / np.float32(32768.0))
