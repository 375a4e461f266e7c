"""PyTorch port, the HTTP serving frontend (`serve.py`).

Drives a real ThreadingHTTPServer on localhost over the port's CPU
transcriber, in the shape of `tests/test_serve.py`, with a seeded in-repo
tone mix in place of the reference's clip: routes, events equal to the
transcriber's, CSV/MIDI bytes equal to the JAX package's writers on the
same events, parameters, batching, and the status code of every error
path (400, 404, 413, 500, 503 with Retry-After, 504), drain on close and
the chunked streaming route.
"""

import http.client
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch import serve
from basic_pitch_torch.utils import audio as t_audio
from basic_pitch_torch.utils import midi as midi_io
from basic_pitch_tpu import serve as j_serve
from torch_port_helpers import MIDI_SET, SR, melody, one_torch_thread, to_pcm16, tone_mix  # noqa: F401

def _wav_bytes(samples: np.ndarray, sr: int = SR) -> bytes:
    buf = io.BytesIO()
    t_audio.write_wav(buf, samples, sr)
    return buf.getvalue()


WAV = _wav_bytes(tone_mix(SR))
PCM = np.frombuffer(WAV[44:], dtype="<i2")


def _start(service):
    srv = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    return srv, thread, f"http://{host}:{port}"


def _stop(srv, thread, service):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    service.close()


@pytest.fixture(scope="module")
def transcriber():
    return t_pipeline.StreamingTranscriber(windows_per_chunk=4, device="cpu")


@pytest.fixture(scope="module")
def expected(transcriber):
    """The transcriber's own events for the request audio, computed before
    the service's dispatch thread owns the transcriber."""
    return transcriber.transcribe(PCM, SR)


@pytest.fixture(scope="module")
def server(transcriber, expected):
    service = serve.TranscriptionService(transcriber, max_batch=4, max_wait_ms=100.0)
    srv, thread, base = _start(service)
    yield base, service
    _stop(srv, thread, service)


def _post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers.get_content_type(), resp.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_healthz_and_routes(server):
    base, _ = server
    status, info = _get(base, "/healthz")
    assert status == 200
    assert info == {"status": "ok", "decode_backend": "plain", "pcm_transport": "raw", "windows_per_chunk": 4}
    for path in ("/nope", "/v1/nope"):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base, path)
        assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, "/v1/nope", WAV)
    assert err.value.code == 404


def test_transcribe_json_equals_transcriber(server, expected):
    base, _ = server
    status, ctype, body = _post(base, "/v1/transcribe", WAV)
    assert status == 200 and ctype == "application/json"
    payload = json.loads(body)
    assert payload["n_notes"] == len(payload["notes"]) == len(expected) > 4
    assert payload["duration_s"] == 6.0
    for got, (s, e, p, a, b) in zip(payload["notes"], expected):
        assert (got["start_time_s"], got["end_time_s"], got["pitch_midi"], got["amplitude"]) == (s, e, p, a)
        assert got["pitch_bends"] == (list(b) if b is not None else None)
        assert got["velocity"] == int(np.round(127 * a))
    assert set(MIDI_SET) <= {n["pitch_midi"] for n in payload["notes"]}


def test_transcribe_formats_equal_jax_writers(server, expected, tmp_path):
    base, _ = server
    status, ctype, body = _post(base, "/v1/transcribe?format=csv", WAV)
    assert status == 200 and ctype == "text/csv"
    assert body == j_serve._events_csv(expected) == serve._events_csv(expected)

    for query, tempo, multi in (("format=midi", 120.0, False), ("format=mid&midi_tempo=90&multiple_pitch_bends=1", 90.0, True)):
        status, ctype, body = _post(base, "/v1/transcribe?" + query, WAV)
        assert status == 200 and ctype == "audio/midi"
        assert body == j_serve._events_midi(expected, tempo, multi) == serve._events_midi(expected, tempo, multi)
    status, _, body = _post(base, "/v1/transcribe?format=midi", WAV)
    midi_path = tmp_path / "response.mid"
    midi_path.write_bytes(body)
    parsed = midi_io.read_midi(midi_path)
    assert sum(len(i.notes) for i in parsed.instruments) == sum(int(np.round(127 * e[3])) > 0 for e in expected)

    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, "/v1/transcribe?format=xml", WAV)
    assert err.value.code == 400


def test_transcribe_parameters(server):
    base, _ = server
    status, _, body = _post(
        base, "/v1/transcribe?minimum_frequency=200&maximum_frequency=500&onset_threshold=0.6", WAV
    )
    assert status == 200
    notes = json.loads(body)["notes"]
    assert notes
    for n in notes:
        hz = 440.0 * 2 ** ((n["pitch_midi"] - 69) / 12)
        assert 180 <= hz <= 550  # the cage plus rounding at the bin edges
    status, _, body = _post(base, "/v1/transcribe?include_pitch_bends=0&no_melodia=1", WAV)
    assert all(n["pitch_bends"] is None for n in json.loads(body)["notes"])

    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, "/v1/transcribe?bogus_param=1", WAV)
    assert err.value.code == 400
    assert "bogus_param" in json.loads(err.value.read())["error"]


def test_parse_params_matches_jax():
    for query in ({}, {"minimum_note_length": ["20"], "melodia": ["0"]}, {"no_melodia": ["yes"], "min_freq": ["80"]},
                  {"format": ["csv"], "infer_onsets": ["false"], "maximum_frequency": ["900.5"]}):
        assert serve._parse_params(dict(query)) == j_serve._parse_params(dict(query))


def test_bad_bodies(server):
    base, _ = server
    for body in (b"", b"not a wav at all" * 10):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/v1/transcribe", body)
        assert err.value.code == 400


def test_concurrent_requests_batch_together(server, expected):
    base, service = server
    before = service.snapshot_metrics()
    results = [None] * 4

    def hit(i):
        results[i] = _post(base, "/v1/transcribe", WAV)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    payloads = [json.loads(body) for status, _, body in results if status == 200]
    assert len(payloads) == 4
    assert all(p["n_notes"] == len(expected) for p in payloads)
    after = service.snapshot_metrics()
    assert after["requests"] - before["requests"] == 4
    assert after["audio_seconds"] - before["audio_seconds"] == pytest.approx(24.0)
    assert after["notes"] - before["notes"] == 4 * len(expected)
    # four requests arriving together share transcribe_batch calls
    assert after["batches"] - before["batches"] < 4
    assert after["x_realtime_busy"] > 0 and after["queue_capacity"] == 32


def test_decode_wav_request_matches_jax():
    pcm = (np.sin(np.arange(SR) * 0.05) * 20000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    samples, got_sr = serve.decode_wav_request(buf.getvalue())
    assert got_sr == SR and samples.dtype == np.int16
    np.testing.assert_array_equal(samples, pcm)  # passthrough, exact

    # 48 kHz stereo: decodes, mixes down, resamples to the model rate
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48000)
        w.writeframes(np.stack([pcm, pcm // 2], axis=1).astype(np.int16).tobytes())
    samples, got_sr = serve.decode_wav_request(buf.getvalue())
    ref, ref_sr = j_serve.decode_wav_request(buf.getvalue())
    assert got_sr == ref_sr == SR and samples.dtype == np.float32
    np.testing.assert_array_equal(samples, ref)
    with pytest.raises(serve.RequestError):
        serve.decode_wav_request(b"")
    with pytest.raises(serve.RequestError):
        serve.decode_wav_request(b"RIFF....WAVEjunk")


def test_http_413_oversized_body(server):
    base, service = server
    host, port = base[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v1/transcribe", body=b"x" * 64, headers={"Content-Length": str(1 << 62)})
        resp = conn.getresponse()
        assert resp.status == 413
        resp.read()
    finally:
        conn.close()
    status, _, _ = _post(base, "/v1/transcribe", _wav_bytes(tone_mix(SR, 1.0)))  # still healthy
    assert status == 200


def _dechunk(body: bytes) -> bytes:
    out = b""
    pos = 0
    while True:
        eol = body.index(b"\r\n", pos)
        size = int(body[pos:eol].split(b";")[0], 16)
        if size == 0:
            return out
        out += body[eol + 2 : eol + 2 + size]
        pos = eol + 2 + size + 2


def test_stream_route_full_duplex(server, transcriber):
    """POST /v1/stream with a chunked PCM body: NDJSON events come back
    while the request body is still open, and the whole event set matches
    the offline transcribe of the same PCM."""
    base, service = server
    host, port = base[len("http://"):].rsplit(":", 1)
    pcm = to_pcm16(melody([60, 64, 67, 72, 76, 72, 67, 64]))
    before = service.snapshot_metrics()

    sock = socket.create_connection((host, int(port)), timeout=180)
    try:
        sock.sendall(
            b"POST /v1/stream?segment_seconds=1.0&lookahead_seconds=0.5 HTTP/1.1\r\n"
            b"Host: t\r\nTransfer-Encoding: chunked\r\nContent-Type: application/octet-stream\r\n\r\n"
        )
        raw = pcm.tobytes()
        step = len(raw) // 7 + 1
        for i in range(0, len(raw), step):
            piece = raw[i : i + step]
            sock.sendall(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
        sock.settimeout(120)
        got = b""
        while b"pitch_midi" not in got:  # the body is not terminated yet
            data = sock.recv(65536)
            assert data, "server closed before emitting any event"
            got += data
        sock.sendall(b"0\r\n\r\n")
        while b"\r\n0\r\n\r\n" not in got:
            data = sock.recv(65536)
            if not data:
                break
            got += data
    finally:
        sock.close()

    header, _, body = got.partition(b"\r\n\r\n")
    assert b"200" in header.splitlines()[0] and b"application/x-ndjson" in header
    events = [json.loads(line) for line in _dechunk(body).decode().splitlines() if line]
    assert all("error" not in e for e in events)
    metrics = service.snapshot_metrics()
    offline = transcriber.transcribe(pcm, SR)  # the stream has ended: the dispatch thread is idle
    assert len(offline) >= 6 and len(events) == len(offline)
    for got_ev, want in zip(
        sorted((e["start_time_s"], e["end_time_s"], e["pitch_midi"]) for e in events),
        sorted((s, e, p) for s, e, p, *_ in offline),
    ):
        assert got_ev[2] == want[2]
        assert abs(got_ev[0] - want[0]) <= 0.05 and abs(got_ev[1] - want[1]) <= 0.05
    assert metrics["streams"] - before["streams"] == 1
    assert metrics["stream_flushes"] - before["stream_flushes"] >= 2
    assert metrics["requests"] == before["requests"]  # flushes are not requests


def test_stream_route_bad_params(server):
    base, _ = server
    for query, word in (("pcm_format=mp3", "pcm_format"), ("sample_rate=16000", "22050"), ("bogus=1", "bogus")):
        req = urllib.request.Request(base + "/v1/stream?" + query, data=b"xx")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        assert word in json.loads(err.value.read())["error"]


class _StubTranscriber:
    """Blocks each transcribe_batch on an event, so a test can hold the
    dispatch thread busy and fill the bounded queue deterministically."""

    decode_backend = "plain"
    pcm_transport = "raw"
    w = 4

    def __init__(self):
        self.release = threading.Event()
        self.started = threading.Event()
        self.calls = []

    def transcribe_batch(self, recordings, **params):
        self.started.set()
        self.release.wait(timeout=30)
        self.calls.append(len(recordings))
        return [[] for _ in recordings]

    def close(self):
        pass


class _FailingTranscriber(_StubTranscriber):
    def transcribe_batch(self, recordings, **params):
        raise RuntimeError("greedy_decode kernel launch failed: cudaError_t 209")


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _status(base, path, body):
    try:
        req = urllib.request.Request(base + path, data=body)
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def test_http_503_sheds_beyond_queue_capacity():
    """One request in flight and max_queue queued: the next is shed at once
    with 503 and Retry-After, and counted."""
    stub = _StubTranscriber()
    service = serve.TranscriptionService(stub, max_batch=1, max_wait_ms=1.0, max_queue=1)
    srv, thread, base = _start(service)
    wav = _wav_bytes(tone_mix(SR, 0.25))
    try:
        results = []
        first = threading.Thread(target=lambda: results.append(_status(base, "/v1/transcribe", wav)))
        first.start()
        assert stub.started.wait(timeout=10)  # the dispatch thread is busy
        second = threading.Thread(target=lambda: results.append(_status(base, "/v1/transcribe", wav)))
        second.start()
        _wait_for(lambda: service._queue.qsize() == 1)
        code, headers, body = _status(base, "/v1/transcribe", wav)
        assert code == 503 and headers["Retry-After"] == "1"
        assert "queue full" in json.loads(body)["error"]
        stub.release.set()
        first.join(timeout=10)
        second.join(timeout=10)
        assert not first.is_alive() and not second.is_alive()
        assert sorted(r[0] for r in results) == [200, 200]
        m = service.snapshot_metrics()
        assert m["shed"] == 1 and m["requests"] == 2 and m["queue_capacity"] == 1
    finally:
        stub.release.set()
        _stop(srv, thread, service)


def test_http_504_on_timeout_and_abandoned_request_dropped():
    stub = _StubTranscriber()
    service = serve.TranscriptionService(stub, max_batch=1, max_wait_ms=1.0, max_queue=4, request_timeout_s=0.2)
    srv, thread, base = _start(service)
    wav = _wav_bytes(tone_mix(SR, 0.25))
    try:
        results = []
        first = threading.Thread(target=lambda: results.append(_status(base, "/v1/transcribe", wav)))
        first.start()
        assert stub.started.wait(timeout=10)
        code, _, body = _status(base, "/v1/transcribe", wav)  # queued behind the stuck batch
        assert code == 504 and "timeout" in json.loads(body)["error"]
        first.join(timeout=10)
        assert results[0][0] == 504
        calls = len(stub.calls)
        stub.release.set()
        _wait_for(lambda: len(stub.calls) > calls)
        time.sleep(0.2)  # room for the worker to (wrongly) dispatch the abandoned request
        assert len(stub.calls) == calls + 1
        assert service.snapshot_metrics()["timeouts"] == 2
    finally:
        stub.release.set()
        _stop(srv, thread, service)


def test_http_500_when_the_transcriber_fails(caplog):
    """A transcriber failure (here a kernel launch error) reaches the caller
    as 500 and is logged; the server stays up."""
    service = serve.TranscriptionService(_FailingTranscriber(), max_batch=1, max_wait_ms=1.0)
    srv, thread, base = _start(service)
    try:
        for _ in range(2):
            code, _, body = _status(base, "/v1/transcribe", _wav_bytes(tone_mix(SR, 0.25)))
            assert code == 500 and "cudaError_t 209" in json.loads(body)["error"]
        assert "transcribe failed" in caplog.text
        assert service.snapshot_metrics()["errors"] == 2
        assert _get(base, "/healthz")[0] == 200
    finally:
        _stop(srv, thread, service)


def test_close_drains_queued_requests():
    stub = _StubTranscriber()
    service = serve.TranscriptionService(stub, max_batch=1, max_wait_ms=1.0, max_queue=4)
    pcm = np.zeros(100, np.int16)
    results = []

    def hit():
        results.append(service.submit(pcm, SR, dict(serve._PARAM_DEFAULTS)))

    threads = [threading.Thread(target=hit) for _ in range(3)]
    for t in threads:
        t.start()
    assert stub.started.wait(timeout=10)
    _wait_for(lambda: service._queue.qsize() == 2)
    stub.release.set()
    closer = threading.Thread(target=service.close)
    closer.start()
    for t in threads:
        t.join(timeout=15)
    closer.join(timeout=15)
    assert not closer.is_alive()
    assert len(results) == 3  # every admitted request was served
    with pytest.raises(RuntimeError, match="closed"):
        service.submit(pcm, SR, dict(serve._PARAM_DEFAULTS))
