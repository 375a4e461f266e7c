"""PyTorch port, the PCM upload-transport policy (`ops/transport.py`), as
tests/test_transport.py holds the JAX package's: the probe's record and its
process cache (one entry per device), the TTL re-probe with hysteresis,
forced and invalid modes, "auto" without the packer, "auto" consulting the
probe, and the transcriber's probes kept out of its dispatches. On the CPU
the probe times a host copy against pack + the plain decode."""

import numpy as np
import pytest
import torch

from basic_pitch_torch import constants
from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch.ops import pcmcodec, transport
from basic_pitch_tpu.ops import transport as j_transport
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_probe_cache(monkeypatch):
    monkeypatch.setattr(transport, "_PROBE_CACHE", {})
    monkeypatch.setattr(transport, "_REPROBE_THREADS", {})


def test_probe_measures_both_transports():
    result = transport.probe("cpu")
    assert result["platform"] == "cpu" and result["probe_mib"] == transport.PROBE_MIB
    assert result["transport"] in ("codec", "raw")
    assert result["raw_mib_s"] > 0 and result["codec_mib_s"] > 0
    assert result["pack_mib_s"] > 0 and result["codec_device_mib_s"] > 0
    assert result["packed_ratio"] > 1.0  # the canned buffer must compress
    want = "codec" if result["codec_mib_s"] > result["raw_mib_s"] else "raw"
    assert result["transport"] == want
    assert set(result) >= set(j_transport_keys())


def j_transport_keys():
    """The record's keys in the JAX package (`_measure`), read from its
    source, so the two stay interchangeable for run reports."""
    import inspect
    import re

    src = inspect.getsource(j_transport._measure)
    return set(re.findall(r'^\s+"(\w+)":', src, re.MULTILINE))


def test_canned_buffer_matches_jax():
    np.testing.assert_array_equal(transport._canned_pcm(1 << 16), j_transport._canned_pcm(1 << 16))


def test_probe_cached_per_process(monkeypatch):
    first = transport.probe("cpu")
    calls = []
    monkeypatch.setattr(transport, "_measure", lambda *a, **k: calls.append(1) or {})
    assert transport.probe("cpu") is first  # no ttl: the cache holds
    assert transport.probe("cpu", ttl_s=1e9) is first  # fresh within the ttl
    assert not calls


def _settle():
    for th in list(transport._REPROBE_THREADS.values()):
        th.join(timeout=10)
        assert not th.is_alive()


def test_ttl_reprobe_with_hysteresis(monkeypatch):
    base = {"raw_mib_s": 100.0, "codec_mib_s": 200.0, "transport": "codec", "platform": "cpu"}
    monkeypatch.setattr(transport, "_measure", lambda *a, **k: dict(base))
    assert transport.probe("cpu", ttl_s=60)["transport"] == "codec"

    # stale: the caller still gets the cached decision; the re-probe runs on
    # a background thread
    monkeypatch.setattr(transport.time, "monotonic", lambda: transport._PROBE_CACHE["cpu"]["ts"] + 61)
    wobble = dict(base, raw_mib_s=205.0, codec_mib_s=200.0, transport="raw")
    monkeypatch.setattr(transport, "_measure", lambda *a, **k: dict(wobble))
    assert transport.probe("cpu", ttl_s=60)["transport"] == "codec"
    _settle()
    held = transport.probe("cpu", ttl_s=1e9)
    assert held["transport"] == "codec"  # the incumbent is kept...
    assert held["held_by_hysteresis"] is True  # ...and the record says so
    assert held["raw_mib_s"] == 205.0  # with the new measurements

    # a decisively better challenger flips the decision
    monkeypatch.setattr(transport.time, "monotonic", lambda: transport._PROBE_CACHE["cpu"]["ts"] + 61)
    decisive = dict(base, raw_mib_s=500.0, codec_mib_s=200.0, transport="raw")
    monkeypatch.setattr(transport, "_measure", lambda *a, **k: dict(decisive))
    transport.probe("cpu", ttl_s=60)
    _settle()
    flipped = transport.probe("cpu", ttl_s=1e9)
    assert flipped["transport"] == "raw"
    assert "held_by_hysteresis" not in flipped

    # force re-measures synchronously and takes the winner outright
    back = dict(base, raw_mib_s=205.0, codec_mib_s=200.0, transport="raw")
    monkeypatch.setattr(transport, "_measure", lambda *a, **k: dict(back))
    assert transport.probe("cpu", force=True)["transport"] == "raw"


def test_probe_cache_keyed_by_device(monkeypatch):
    """A CPU probe never decides for a card: each device is measured, cached
    and reported on its own."""
    monkeypatch.setattr(t_pipeline, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(pcmcodec, "available", lambda: True)
    measured = []

    def fake(dev, size_mib=transport.PROBE_MIB):
        measured.append(str(dev))
        winner = "codec" if dev.type == "cpu" else "raw"
        return {"platform": dev.type, "raw_mib_s": 1.0, "codec_mib_s": 1.0, "codec_serial_mib_s": 1.0,
                "transport": winner, "transport_serial": winner}

    monkeypatch.setattr(transport, "_measure", fake)
    assert transport.resolve("auto", device="cpu") == "codec"
    assert transport.resolve("auto", device="cuda:0") == "raw"  # measured anew, not the CPU's record
    assert transport.resolve("auto", device="cpu") == "codec"
    assert transport.resolve("auto", device="cuda:0", serial=True) == "raw"
    assert measured == ["cpu", "cuda:0"]
    assert transport.report("cuda:0")["platform"] == "cuda" and transport.report("cpu")["platform"] == "cpu"

    # a stale card re-probes that card, on its own thread
    monkeypatch.setattr(transport.time, "monotonic", lambda: transport._PROBE_CACHE["cuda:0"]["ts"] + 61)
    transport.probe("cuda:0", ttl_s=60)
    _settle()
    assert measured == ["cpu", "cuda:0", "cuda:0"]
    assert set(transport._REPROBE_THREADS) == {"cuda:0"}


def test_report_without_packer(monkeypatch):
    monkeypatch.setattr(pcmcodec, "available", lambda: False)
    r = transport.report("cpu")
    assert r["transport"] == "raw"
    assert "raw_mib_s" not in r and "packer" in r["note"]


def test_check_mode_and_constants():
    assert transport.check_mode("auto") == "auto"
    with pytest.raises(ValueError, match="pcm_transport"):
        transport.check_mode("zip")
    assert transport.MODES == j_transport.MODES
    assert (transport.HYSTERESIS, transport.PROBE_MIB, transport.PACK_WORKERS) == (
        j_transport.HYSTERESIS, j_transport.PROBE_MIB, j_transport.PACK_WORKERS
    )


def test_resolve_forced_and_invalid():
    assert transport.resolve("codec") == "codec"
    assert transport.resolve("raw") == "raw"
    with pytest.raises(ValueError, match="pcm_transport"):
        transport.resolve("fast")


def test_resolve_auto_without_packer(monkeypatch):
    monkeypatch.setattr(pcmcodec, "available", lambda: False)
    assert transport.resolve("auto", device="cpu") == "raw"
    assert transport._PROBE_CACHE == {}  # nothing was measured


def test_transcriber_validates_transport():
    with pytest.raises(ValueError, match="pcm_transport"):
        t_pipeline.StreamingTranscriber(windows_per_chunk=1, device="cpu", pcm_transport="zip")
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=1, device="cpu")
    assert tr.pcm_transport == "auto" and tr.transport_ttl_s == 120.0
    if pcmcodec.available():  # "auto" probed its device when it was made
        assert set(transport._PROBE_CACHE) == {"cpu"}


def _tone_pcm(seconds=2.0):
    sr = constants.AUDIO_SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    y = 0.4 * np.sin(2 * np.pi * 440.0 * t) * np.exp(-0.3 * t)
    return (y * 32767).astype(np.int16), sr


@pytest.mark.parametrize("winner", ["raw", "codec"])
def test_auto_dispatch_consults_probe(monkeypatch, winner):
    """"auto" asks the policy once per int16 recording and follows it; float
    audio never asks."""
    pcm, sr = _tone_pcm()
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", pcm_transport="auto", transport_ttl_s=1e9)
    seen = []

    def spy(mode, device=None, ttl_s=None, serial=False):
        seen.append((mode, str(device), ttl_s, serial))
        return winner

    monkeypatch.setattr(transport, "resolve", spy)
    before = pcmcodec.launches
    packs = []
    real_pack = pcmcodec.pack
    monkeypatch.setattr(pcmcodec, "pack", lambda *a, **k: packs.append(1) or real_pack(*a, **k))
    (events,) = tr.transcribe_batch([(pcm, sr)])
    assert len(events) >= 1
    assert seen == [("auto", "cpu", None, False)]  # the cached decision; no re-probe
    assert bool(packs) == (winner == "codec")
    assert pcmcodec.launches == before  # the plain decode on the CPU, never the kernel
    seen.clear()
    tr.transcribe(pcm.astype(np.float32) / 32768.0, sr)
    assert not seen
    tr.close()


def test_reprobe_runs_after_results_never_in_dispatch(monkeypatch):
    """The transcriber's first probe runs in its constructor; a dispatch only
    reads the cached decision; the TTL re-probe is asked for once the call's
    results are on the host."""
    monkeypatch.setattr(pcmcodec, "available", lambda: True)
    order = []

    def spy(device=None, ttl_s=None, force=False, wait=False):
        order.append(("probe", str(device), ttl_s) + (("wait",) if wait else ()))
        return {"transport": "raw", "transport_serial": "raw"}

    monkeypatch.setattr(transport, "probe", spy)
    tr = t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", transport_ttl_s=30.0)
    assert order == [("probe", "cpu", None)]
    real_assemble = tr._assemble
    monkeypatch.setattr(tr, "_assemble", lambda *a: order.append("results") or real_assemble(*a))
    pcm, sr = _tone_pcm()
    tr.transcribe_batch([(pcm, sr), (pcm, sr)])
    assert order == [("probe", "cpu", None)] * 3 + ["results", "results", ("probe", "cpu", 30.0)]
    order.clear()
    tr.reprobe_after_calls = False  # the owner re-probes when it is idle
    tr.transcribe(pcm, sr)
    assert order == [("probe", "cpu", None), "results"]
    tr.refresh_transport(wait=True)
    assert order[-1] == ("probe", "cpu", 30.0, "wait")
    order.clear()
    t_pipeline.StreamingTranscriber(windows_per_chunk=2, device="cpu", pcm_transport="raw").transcribe(pcm, sr)
    assert order == []  # "raw" never measures
    tr.close()


def test_stale_probe_waits_on_the_callers_thread(monkeypatch):
    """``wait=True`` re-measures a stale probe on the caller's thread, with
    hysteresis, and starts no thread."""
    base = {"raw_mib_s": 100.0, "codec_mib_s": 200.0, "transport": "codec", "platform": "cpu"}
    monkeypatch.setattr(transport, "_measure", lambda *a, **k: dict(base))
    transport.probe("cpu")
    monkeypatch.setattr(transport.time, "monotonic", lambda: transport._PROBE_CACHE["cpu"]["ts"] + 61)
    assert transport.probe("cpu", ttl_s=1e9, wait=True)["raw_mib_s"] == 100.0  # fresh: nothing measured
    wobble = dict(base, raw_mib_s=205.0, transport="raw")
    monkeypatch.setattr(transport, "_measure", lambda *a, **k: dict(wobble))
    held = transport.probe("cpu", ttl_s=60, wait=True)
    assert held["raw_mib_s"] == 205.0 and held["transport"] == "codec" and held["held_by_hysteresis"] is True
    assert transport._REPROBE_THREADS == {}
