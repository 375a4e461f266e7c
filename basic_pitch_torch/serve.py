"""HTTP serving frontend: cross-request micro-batching over the transcriber.

A copy of `basic_pitch_tpu/serve.py` (the port imports nothing of the JAX
package) over the port's `pipeline.StreamingTranscriber`, whose note decode
is the greedy-decode CUDA kernel on the card, so every request and every
stream flush goes through that kernel. One GPU transcribes many times
faster than real time, so one card serves many concurrent callers, and
throughput comes from batching their requests into one `transcribe_batch`.

- `TranscriptionService` — a micro-batcher: requests queue up, a single
  dispatch thread drains them in groups (bounded by ``max_batch`` and
  ``max_wait_ms``), groups share one `transcribe_batch` call per distinct
  decode-parameter set, and each caller blocks only on its own result.
  One service owns the transcriber; only its dispatch thread touches the
  device, never an HTTP thread. Admission is bounded by ``max_queue``
  (beyond it requests are shed with HTTP 503 + Retry-After, counted in
  ``/metrics`` as ``shed``), an optional ``request_timeout_s`` abandons
  requests whose caller would wait longer (504, counted as ``timeouts``,
  dropped from later batches), request bodies are capped (413 / in-band
  stream error), and ``close()`` drains queued requests before stopping.
  A failure in the transcriber (a kernel that does not build or launch
  included) reaches the caller as HTTP 500 and is logged; nothing decodes
  with another decoder in its place.
- `TranscriptionHandler` / `make_server` — a stdlib ThreadingHTTPServer
  speaking a small JSON/MIDI API:

    GET  /healthz          -> {"status": "ok", decode_backend ("kernel" on
         the card, "plain" on the CPU), pcm_transport (the mode asked
         for: "auto", "codec" or "raw"), ...}
    GET  /metrics          -> request/audio-second/latency counters
    POST /v1/transcribe    -> WAV body; query params mirror the CLI flags
         (onset_threshold, frame_threshold, minimum_note_length,
         minimum_frequency, maximum_frequency, melodia, infer_onsets,
         midi_tempo); ``format=json|midi|csv`` selects the response body.
    POST /v1/stream        -> raw PCM body (s16le|f32le mono, chunked or
         content-length), NDJSON note events streamed back as they
         finalize (`streaming.StreamingSession`); flush decodes ride the
         same micro-batcher. Query: sample_rate, pcm_format,
         segment_seconds, lookahead_seconds, max_context_seconds + the
         decode params above.

- `basic-pitch-torch-serve` console script (`cli/serve.py`) starts it.

PCM16 mono WAVs at the model rates go to the transcriber as int16; note
events are the tuples `inference.predict` returns, serialized with the CSV
field names the reference writes (`start_time_s,end_time_s,pitch_midi,...`).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from basic_pitch_torch import constants
from basic_pitch_torch import streaming
from basic_pitch_torch.decode import export
from basic_pitch_torch.utils import audio as audio_io
from basic_pitch_torch.utils import hostmem

MAX_BODY_BYTES = 256 << 20  # one hour of 44.1 kHz stereo PCM16 is ~600 MB/2ch


class RequestError(ValueError):
    """Client error (HTTP 400): bad body, bad params, undecodable audio."""


class OverloadedError(RuntimeError):
    """Server over capacity (HTTP 503): the dispatch queue is full.

    Backpressure contract: the service admits at most ``max_queue`` pending
    requests; beyond that it sheds load immediately instead of queueing
    unboundedly (latency under overload stays bounded by
    queue_depth / service_rate). Shed requests are counted in
    ``/metrics`` as ``shed``."""


class DeadlineExceeded(RuntimeError):
    """Request exceeded the per-request timeout (HTTP 504).

    The caller stops waiting; the dispatch thread drops the abandoned
    request from its next batch (or completes it harmlessly if already
    in flight). Counted in ``/metrics`` as ``timeouts``."""


def decode_wav_request(raw: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (mono samples, model-compatible sample rate).

    PCM16 mono at 22.05/44.1 kHz passes through as int16 (scaled on the
    device); everything else decodes to float32, mixes down, and resamples
    to the model rate on the host.
    """
    if not raw:
        raise RequestError("empty request body; POST a WAV file")
    header = audio_io._parse_wav_header(raw)
    if header is not None:
        audio_format, n_channels, sample_rate, bits, data = header
        if (
            audio_format == audio_io.WAVE_FORMAT_PCM
            and bits == 16
            and n_channels == 1
            and sample_rate
            in (constants.AUDIO_SAMPLE_RATE, 2 * constants.AUDIO_SAMPLE_RATE)
        ):
            return audio_io.raw_to_np(data, np.int16), sample_rate
    try:
        samples, sr = audio_io.read_wav_bytes(raw, name="<request>")
    except audio_io.WavFormatError as err:
        raise RequestError(str(err)) from err
    mono = audio_io.to_mono(samples)
    if sr not in (constants.AUDIO_SAMPLE_RATE, 2 * constants.AUDIO_SAMPLE_RATE):
        mono = audio_io.resample(mono, sr, constants.AUDIO_SAMPLE_RATE)
        sr = constants.AUDIO_SAMPLE_RATE
    return mono.astype(np.float32), sr


# decode parameters a request may set; one batch dispatch shares one set
_PARAM_DEFAULTS = {
    "onset_threshold": 0.5,
    "frame_threshold": 0.3,
    "min_note_length": 11,  # frames, like StreamingTranscriber
    "min_freq": None,
    "max_freq": None,
    "infer_onsets": True,
    "melodia_trick": True,
    "include_pitch_bends": True,
}


class _Pending:
    __slots__ = (
        "samples", "sr", "params", "event", "result", "error", "kind", "abandoned",
    )

    def __init__(self, samples, sr, params, kind="request"):
        self.samples = samples
        self.sr = sr
        self.params = params
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.kind = kind  # "request" | "stream_flush" (metrics accounting)
        self.abandoned = False  # caller timed out; skip at dispatch


class TranscriptionService:
    """Thread-safe request funnel onto one StreamingTranscriber.

    `submit()` blocks the calling (HTTP) thread until its events are
    ready. A single dispatch thread drains the queue: it waits for one
    request, gathers more for up to ``max_wait_ms`` (or until
    ``max_batch``), groups them by decode-parameter set, and runs one
    `transcribe_batch` per group — so concurrent callers share device
    dispatches, which is where this pipeline's throughput lives. Only the
    dispatch thread calls the transcriber; when the queue is empty after a
    batch it also lets the transcriber re-probe its PCM transport
    (`refresh_transport`), so the probe never shares the card with a batch.
    """

    def __init__(
        self,
        transcriber,
        max_batch: int = 8,
        max_wait_ms: float = 25.0,
        max_queue: int = 32,
        request_timeout_s: Optional[float] = None,
    ):
        self.transcriber = transcriber
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.request_timeout_s = request_timeout_s
        # bounded admission: beyond max_queue pending requests the service
        # sheds (503) instead of queueing unboundedly — overload latency is
        # bounded by queue_depth / service_rate, not by offered load
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=max(1, max_queue)
        )
        self._metrics_lock = threading.Lock()
        self.metrics: Dict[str, float] = {
            "requests": 0,
            "errors": 0,
            "audio_seconds": 0.0,
            "busy_seconds": 0.0,
            "batches": 0,
            "notes": 0,
            "streams": 0,
            "stream_flushes": 0,
            "shed": 0,
            "timeouts": 0,
        }
        # the transport re-probe (`StreamingTranscriber.refresh_transport`)
        # runs here only while the queue is idle, never right after a batch
        # that more requests wait behind
        if hasattr(transcriber, "reprobe_after_calls"):
            transcriber.reprobe_after_calls = False
        self._worker = threading.Thread(
            target=self._run, name="bp-serve-dispatch", daemon=True
        )
        self._worker.start()

    def close(self) -> None:
        """Graceful drain: stop admitting (`submit` raises), serve every
        request already queued (FIFO order puts them ahead of the shutdown
        sentinel), then stop the dispatch thread and the transcriber."""
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=30)
        closer = getattr(self.transcriber, "close", None)
        if closer is not None:
            closer()

    # ------------------------------------------------------------------

    def submit(
        self, samples: np.ndarray, sr: int, params: Dict, kind: str = "request"
    ) -> List:
        if getattr(self, "_closed", False):
            raise RuntimeError("TranscriptionService is closed")
        pending = _Pending(samples, sr, params, kind)
        if kind == "stream_flush":
            # flushes belong to an already-admitted stream (one in flight
            # per connection thread), so they block instead of shedding —
            # admission control for streams happens at stream start
            self._queue.put(pending)
        else:
            try:
                self._queue.put_nowait(pending)
            except queue.Full:
                with self._metrics_lock:
                    self.metrics["shed"] += 1
                raise OverloadedError(
                    f"dispatch queue full ({self._queue.maxsize} pending); "
                    "retry shortly"
                ) from None
        if not pending.event.wait(self.request_timeout_s):
            pending.abandoned = True
            with self._metrics_lock:
                self.metrics["timeouts"] += 1
            raise DeadlineExceeded(
                f"request exceeded {self.request_timeout_s:.1f}s timeout"
            )
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _gather(self) -> List[_Pending]:
        first = self._queue.get()
        if first is None:
            return []
        group = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:  # propagate shutdown after serving this group
                self._queue.put(None)
                break
            group.append(item)
        return group

    def _run(self) -> None:
        while True:
            group = self._gather()
            if not group:
                return
            by_params: Dict[tuple, List[_Pending]] = {}
            for item in group:
                key = tuple(sorted(item.params.items()))
                by_params.setdefault(key, []).append(item)
            for items in by_params.values():
                self._dispatch_group(items)
            refresh = getattr(self.transcriber, "refresh_transport", None)
            if refresh is not None and self._queue.empty():
                try:
                    refresh(wait=True)
                except Exception:  # noqa: BLE001 — the cached decision stays
                    import logging

                    logging.getLogger(__name__).exception("transport re-probe failed")

    def _dispatch_group(self, items: List[_Pending]) -> None:
        # drop requests whose caller already timed out (their event is set
        # harmlessly; nobody reads the result) — under overload this keeps
        # the device working on requests someone is still waiting for
        live = [it for it in items if not it.abandoned]
        for item in items:
            if item.abandoned:
                item.event.set()
        if not live:
            return
        items = live
        t0 = time.monotonic()
        params = items[0].params
        try:
            results = self.transcriber.transcribe_batch(
                [(it.samples, it.sr) for it in items], **params
            )
            for item, events in zip(items, results):
                item.result = events
        except Exception as err:  # noqa: BLE001 — delivered to the caller
            for item in items:
                item.error = err
        finally:
            wall = time.monotonic() - t0
            with self._metrics_lock:
                self.metrics["batches"] += 1
                self.metrics["busy_seconds"] += wall
                for item in items:
                    if item.kind == "stream_flush":
                        # a sliding-window re-decode, not a caller request:
                        # counting its audio would double-book the stream
                        self.metrics["stream_flushes"] += 1
                        if item.error is not None:
                            self.metrics["errors"] += 1
                        continue
                    self.metrics["requests"] += 1
                    if item.error is not None:
                        self.metrics["errors"] += 1
                    else:
                        rate = item.sr
                        self.metrics["audio_seconds"] += len(item.samples) / rate
                        self.metrics["notes"] += len(item.result)
            for item in items:
                item.event.set()

    # ------------------------------------------------------------------

    def info(self) -> Dict:
        tr = self.transcriber
        return {
            "status": "ok",
            "decode_backend": getattr(tr, "decode_backend", None),
            "pcm_transport": getattr(tr, "pcm_transport", None),
            "windows_per_chunk": getattr(tr, "w", None),
        }

    def snapshot_metrics(self) -> Dict:
        with self._metrics_lock:
            m = dict(self.metrics)
        busy = m["busy_seconds"]
        m["x_realtime_busy"] = round(m["audio_seconds"] / busy, 1) if busy else None
        m["queue_depth"] = self._queue.qsize()
        m["queue_capacity"] = self._queue.maxsize
        return m


def _parse_params(query: Dict[str, List[str]]) -> Dict:
    """Query string -> transcribe_batch kwargs (reference CLI flag names
    and this pipeline's short names both accepted)."""
    alias = {
        "minimum_note_length": "min_note_length",
        "minimum_frequency": "min_freq",
        "maximum_frequency": "max_freq",
        "melodia": "melodia_trick",
        "no_melodia": "no_melodia",
    }
    params = dict(_PARAM_DEFAULTS)
    for key, values in query.items():
        if key in ("format", "midi_tempo", "multiple_pitch_bends"):
            continue
        name = alias.get(key, key)
        if name == "no_melodia":
            params["melodia_trick"] = values[-1].lower() not in ("1", "true", "yes")
            continue
        if name not in params:
            raise RequestError(f"unknown parameter {key!r}")
        value = values[-1]
        if name in ("infer_onsets", "melodia_trick", "include_pitch_bends"):
            params[name] = value.lower() in ("1", "true", "yes")
        elif name == "min_note_length":
            params[name] = int(value)
        else:
            params[name] = float(value)
    return params


def _events_json(events: List, duration_s: float) -> bytes:
    notes = [
        {
            "start_time_s": float(start),
            "end_time_s": float(end),
            "pitch_midi": int(pitch),
            "amplitude": float(amplitude),
            "velocity": int(np.round(127 * amplitude)),
            "pitch_bends": list(map(int, bends)) if bends is not None else None,
        }
        for start, end, pitch, amplitude, bends in events
    ]
    return json.dumps(
        {"duration_s": round(duration_s, 3), "n_notes": len(notes), "notes": notes}
    ).encode()


def _events_csv(events: List) -> bytes:
    # the reference CSV schema (inference.py save_note_events): bends joined
    lines = ["start_time_s,end_time_s,pitch_midi,velocity,pitch_bend"]
    for start, end, pitch, amplitude, bends in events:
        bend_cols = "," + ",".join(str(int(b)) for b in bends) if bends else ""
        lines.append(
            f"{start},{end},{int(pitch)},{int(np.round(127 * amplitude))}{bend_cols}"
        )
    return ("\n".join(lines) + "\n").encode()


def _events_midi(events: List, tempo: float, multiple_pitch_bends: bool) -> bytes:
    import io

    midi = export.note_events_to_midi(
        events, multiple_pitch_bends=multiple_pitch_bends, midi_tempo=tempo
    )
    buf = io.BytesIO()
    midi.write(buf)
    return buf.getvalue()


class TranscriptionHandler(BaseHTTPRequestHandler):
    """Routes; the service instance is attached to the server object."""

    server_version = "basic-pitch-torch"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: object) -> None:  # route through logging, not stderr
        import logging

        logging.getLogger(__name__).info("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: Dict) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        service: TranscriptionService = self.server.service
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send_json(200, service.info())
        elif path == "/metrics":
            self._send_json(200, service.snapshot_metrics())
        else:
            self._send_json(404, {"error": f"no route {path!r}"})

    # ---- live streaming route -----------------------------------------

    def _body_blocks(self):
        """Yield request-body byte blocks incrementally: chunked
        transfer-encoding when the client streams (ffmpeg | curl -T -),
        content-length read in slices otherwise. Total is capped."""
        total = 0
        max_body = getattr(self.server, "max_body_bytes", MAX_BODY_BYTES)
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            while True:
                line = self.rfile.readline(1024)
                if not line:
                    return
                size = int(line.strip().split(b";")[0] or b"0", 16)
                if size == 0:
                    while True:  # consume optional trailers
                        trailer = self.rfile.readline(1024)
                        if trailer in (b"\r\n", b"\n", b""):
                            return
                total += size
                if total > max_body:
                    raise RequestError(f"stream exceeds {max_body} bytes")
                data = self.rfile.read(size)
                self.rfile.read(2)  # chunk-terminating CRLF
                yield data
        else:
            remaining = int(self.headers.get("Content-Length", "0"))
            if remaining > max_body:
                raise RequestError(f"body exceeds {max_body} bytes")
            while remaining > 0:
                data = self.rfile.read(min(64 * 1024, remaining))
                if not data:
                    return
                remaining -= len(data)
                yield data

    def _write_chunk(self, payload: bytes) -> None:
        self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
        self.wfile.flush()

    def _emit_stream_events(self, events) -> None:
        for start, end, pitch, amplitude, bends in events:
            self._write_chunk(
                json.dumps(
                    {
                        "start_time_s": round(float(start), 6),
                        "end_time_s": round(float(end), 6),
                        "pitch_midi": int(pitch),
                        "amplitude": round(float(amplitude), 6),
                        "velocity": int(np.round(127 * float(amplitude))),
                        "pitch_bends": (
                            [int(b) for b in bends] if bends is not None else None
                        ),
                    }
                ).encode()
                + b"\n"
            )

    def _do_stream(self, url) -> None:
        """POST /v1/stream — raw PCM body (s16le/f32le mono), NDJSON note
        events streamed back as they finalize. Flush decodes go through the
        service's micro-batcher, so concurrent streams (and ordinary
        requests) share device dispatches."""
        service: TranscriptionService = self.server.service
        query = parse_qs(url.query)
        stream_keys = {
            "sample_rate": "22050",
            "pcm_format": "s16le",
            "segment_seconds": "2.0",
            "lookahead_seconds": "1.0",
            "max_context_seconds": "12.0",
        }
        stream_q = {
            k: query.pop(k, [v])[-1] for k, v in stream_keys.items()
        }
        params = _parse_params(query)
        pcm_format = stream_q["pcm_format"]
        if pcm_format not in ("s16le", "f32le"):
            raise RequestError(f"unknown pcm_format {pcm_format!r} (s16le|f32le)")
        dtype = np.dtype(np.int16 if pcm_format == "s16le" else np.float32)
        try:
            session = streaming.StreamingSession(
                None,
                sample_rate=int(stream_q["sample_rate"]),
                segment_seconds=float(stream_q["segment_seconds"]),
                lookahead_seconds=float(stream_q["lookahead_seconds"]),
                max_context_seconds=float(stream_q["max_context_seconds"]),
                transcribe_fn=lambda audio, sr, **_: service.submit(
                    audio, sr, params, kind="stream_flush"
                ),
            )
        except ValueError as err:
            raise RequestError(str(err)) from err
        with service._metrics_lock:
            service.metrics["streams"] += 1

        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        carry = b""
        try:
            try:
                for block in self._body_blocks():
                    raw = carry + block
                    usable = len(raw) - len(raw) % dtype.itemsize
                    carry = raw[usable:]
                    if usable:
                        samples = np.frombuffer(raw[:usable], dtype=dtype)
                        self._emit_stream_events(session.feed(samples))
                self._emit_stream_events(session.close())
            except RequestError as err:
                # response already started: report in-band, then terminate
                self._write_chunk(json.dumps({"error": str(err)}).encode() + b"\n")
        finally:
            if not session.closed:  # client vanished mid-stream
                session.close()
            try:
                # zero-length chunk = the chunked-encoding terminator
                self._write_chunk(b"")
            except OSError:
                pass

    def _handle_stream(self, url) -> None:
        try:
            self._do_stream(url)
        except RequestError as err:
            self._send_json(400, {"error": str(err)})
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream
        except Exception as err:  # noqa: BLE001 — server stays up
            import logging

            logging.getLogger(__name__).exception("stream failed")
            try:
                self._send_json(500, {"error": f"{type(err).__name__}: {err}"})
            except Exception:  # response already started
                pass

    def do_PUT(self) -> None:  # noqa: N802 — `curl -T -` (chunked upload) sends PUT
        url = urlparse(self.path)
        if url.path in ("/v1/stream", "/stream"):
            self._handle_stream(url)
        else:
            self._send_json(404, {"error": f"no route {url.path!r}"})

    def do_POST(self) -> None:  # noqa: N802
        service: TranscriptionService = self.server.service
        url = urlparse(self.path)
        if url.path in ("/v1/stream", "/stream"):
            self._handle_stream(url)
            return
        if url.path not in ("/v1/transcribe", "/transcribe"):
            self._send_json(404, {"error": f"no route {url.path!r}"})
            return
        try:
            max_body = getattr(self.server, "max_body_bytes", MAX_BODY_BYTES)
            length = int(self.headers.get("Content-Length", "0"))
            if length > max_body:
                # body is left unread: drop the connection after replying
                self.close_connection = True
                self._send_json(
                    413, {"error": f"body exceeds {max_body} bytes"}
                )
                return
            raw = self.rfile.read(length)
            query = parse_qs(url.query)
            params = _parse_params(query)
            samples, sr = decode_wav_request(raw)
            events = service.submit(samples, sr, params)
            fmt = query.get("format", ["json"])[-1]
            duration = len(samples) / sr
            if fmt == "json":
                self._send(200, _events_json(events, duration), "application/json")
            elif fmt == "csv":
                self._send(200, _events_csv(events), "text/csv")
            elif fmt in ("midi", "mid"):
                tempo = float(query.get("midi_tempo", ["120"])[-1])
                multi = query.get("multiple_pitch_bends", ["0"])[-1].lower() in (
                    "1",
                    "true",
                    "yes",
                )
                self._send(200, _events_midi(events, tempo, multi), "audio/midi")
            else:
                raise RequestError(f"unknown format {fmt!r} (json|csv|midi)")
        except RequestError as err:
            self._send_json(400, {"error": str(err)})
        except OverloadedError as err:
            # load shed: bounded queue is full — tell the client to back off
            self.send_response(503)
            body = json.dumps({"error": str(err)}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)
        except DeadlineExceeded as err:
            self._send_json(504, {"error": str(err)})
        except Exception as err:  # noqa: BLE001 — server stays up
            import logging

            logging.getLogger(__name__).exception("transcribe failed")
            self._send_json(500, {"error": f"{type(err).__name__}: {err}"})


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 drops the connections
    # of a burst of concurrent callers beyond it, and their clients retry
    # only after TCP's 1 s SYN timeout; the service's own queue (`max_queue`,
    # 503 beyond it) is the admission limit, so accept the whole burst
    request_queue_size = 128


def make_server(
    service: TranscriptionService,
    host: str = "127.0.0.1",
    port: int = 0,
    max_body_bytes: int = MAX_BODY_BYTES,
) -> ThreadingHTTPServer:
    """Bind (port 0 picks a free one); caller runs serve_forever()."""
    hostmem.tune_host_allocator()  # warm-heap reuse of request PCM buffers
    server = _Server((host, port), TranscriptionHandler)
    server.service = service
    server.max_body_bytes = max_body_bytes
    return server
