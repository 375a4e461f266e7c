"""PyTorch port, `streaming.StreamingSession` and the stream CLI.

The session logic is a copy of the JAX package's: on every scripted feed of
`tests/test_streaming.py` (force-emit, phantom drop, grace scaling,
re-find, supersede) both classes must pass the JAX assertions and the port
must emit exactly the JAX session's events and counters. Over the port's
CPU transcriber, both classes must also keep the streaming contract
(block-size independence, long-note carry, int16 feeds, API errors) on
gapped melodies, where window-local decoding equals offline decoding.
"""

import io
import json

import numpy as np
import pytest

from basic_pitch_torch import pipeline as t_pipeline
from basic_pitch_torch import streaming as t_streaming
from basic_pitch_torch.cli import stream as stream_cli
from basic_pitch_tpu import streaming as j_streaming
from torch_port_helpers import SR, melody, one_torch_thread, to_pcm16  # noqa: F401

SESSIONS = {"jax": j_streaming.StreamingSession, "port": t_streaming.StreamingSession}


@pytest.fixture(scope="module")
def transcriber():
    return t_pipeline.StreamingTranscriber(windows_per_chunk=4, device="cpu")


def stream_all(session, audio, block_s=0.25, rng=None):
    """Feed audio in blocks; returns (during_stream_events, close_events)."""
    live = []
    i = 0
    while i < len(audio):
        n = int(block_s * SR)
        if rng is not None:
            n = int(rng.uniform(0.05, 0.6) * SR)
        live.extend(session.feed(audio[i : i + n]))
        i += n
    return live, session.close()


def assert_same_events(streamed, offline, tol=0.05):
    assert len(streamed) == len(offline), (streamed, offline)
    for (s1, e1, p1, *_), (s2, e2, p2, *_) in zip(sorted(streamed), sorted(offline)):
        assert p1 == p2
        assert abs(s1 - s2) <= tol, (s1, s2)
        assert abs(e1 - e2) <= tol, (e1, e2)


# ---------------------------------------------------------------------------
# the session logic on scripted decodes
# ---------------------------------------------------------------------------


class _ScriptedTranscribe:
    """transcribe_fn stub: returns the scripted event list per flush."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def __call__(self, audio, sample_rate, **kw):
        events = self.script[min(self.calls, len(self.script) - 1)]
        self.calls += 1
        return list(events)


ANCHOR = (0.1, 99.0, 40, 0.5, None)  # never ends: pins the trim (window origin) at 0


def _check_force_emitted(out, stats):
    assert stats["pending_dropped"] == 0 and stats["pending_force_emitted"] == 1
    forced = [e for e in out if e[2] == 60]
    assert len(forced) == 1
    start, end, _, amp, _ = forced[0]
    assert abs(start - 0.5) < 1e-6 and abs(end - 3.9) < 1e-6 and amp == 0.8


def _check_force_emitted_at_close(out, stats):
    assert [e[2] for e in out] == [64]
    assert stats["pending_force_emitted"] == 1


def _check_phantom_dropped(out, stats):
    assert out == []
    assert stats["pending_force_emitted"] == 0 and stats["pending_dropped"] == 1


def _check_regained_not_duplicated(out, stats):
    assert [e[2] for e in out] == [60]


def _check_jittered_refind(out, stats):
    sixties = [e for e in out if e[2] == 60]
    assert len(sixties) == 1
    assert abs(sixties[0][0] - 0.62) < 1e-6  # the resurrected sighting's onset
    assert stats["pending_dropped"] == 1


def _check_superseded(out, stats):
    assert len([e for e in out if e[2] == 60]) == 1
    assert stats["pending_superseded"] == 1
    assert stats["pending_force_emitted"] == 0 and stats["pending_dropped"] == 0


# name -> (script, block seconds per feed, check)
SCRIPTED = {
    # a note seen in two flushes, then never again: emitted with its last end
    "force-emit": ([[(0.5, 3.9, 60, 0.8, None)]] * 2 + [[]] * 3, [0.5] * 24, _check_force_emitted),
    "force-emit-at-close": ([[(0.5, 3.9, 64, 0.7, None)]] * 2 + [[]], [2.0, 2.0], _check_force_emitted_at_close),
    # seen once, never confirmed: a window-edge hallucination, dropped
    "phantom-dropped": ([[(0.5, 1.9, 60, 0.8, None)]] + [[]] * 4, [0.5] * 16, _check_phantom_dropped),
    "regained-after-force-emit": (
        [[ANCHOR, (0.5, 1.9, 60, 0.8, None)], [ANCHOR], [ANCHOR], [ANCHOR, (0.5, 2.2, 60, 0.8, None)],
         [ANCHOR, (0.5, 2.2, 60, 0.8, None)]],
        [1.0] * 10,
        _check_regained_not_duplicated,
    ),
    "jittered-refind": (
        [[ANCHOR, (0.5, 3.5, 60, 0.8, None)], [ANCHOR], [ANCHOR], [ANCHOR, (0.62, 3.5, 60, 0.8, None)],
         [ANCHOR, (0.62, 3.5, 60, 0.8, None)]],
        [1.0] * 10,
        _check_jittered_refind,
    ),
    # a split first decode leaves two records for what later decodes see as one note
    "superseded": (
        [[(0.5, 1.4, 60, 0.8, None), (1.5, 3.5, 60, 0.8, None)]] + [[(0.5, 3.5, 60, 0.8, None)]] * 3,
        [1.0] * 8,
        _check_superseded,
    ),
}


def _run_scripted(session_cls, script, blocks):
    session = session_cls(
        transcriber=None, transcribe_fn=_ScriptedTranscribe(script), segment_seconds=2.0, lookahead_seconds=1.0
    )
    out = []
    for seconds in blocks:
        out.extend(session.feed(np.zeros(int(seconds * SR), np.float32)))
    out.extend(session.close())
    return out, dict(session.stats)


@pytest.mark.parametrize("impl", sorted(SESSIONS))
@pytest.mark.parametrize("case", sorted(SCRIPTED))
def test_scripted_session_logic(impl, case):
    script, blocks, check = SCRIPTED[case]
    out, stats = _run_scripted(SESSIONS[impl], script, blocks)
    check(out, stats)


@pytest.mark.parametrize("case", sorted(SCRIPTED))
def test_port_session_emits_exactly_the_jax_sessions_events(case):
    script, blocks, _ = SCRIPTED[case]
    assert _run_scripted(t_streaming.StreamingSession, script, blocks) == _run_scripted(
        j_streaming.StreamingSession, script, blocks
    )


@pytest.mark.parametrize("impl", sorted(SESSIONS))
def test_grace_budget_scales_with_segment_length(impl):
    cls = SESSIONS[impl]
    grace = [cls(None, transcribe_fn=_ScriptedTranscribe([[]]), segment_seconds=s)._grace_flushes for s in (1.0, 2.0, 4.0)]
    assert grace == [2, 1, 1]


# ---------------------------------------------------------------------------
# over the port's transcriber
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", sorted(SESSIONS))
def test_streamed_equals_offline_on_gapped_melody(transcriber, impl):
    audio = melody([60, 64, 67, 72, 67, 64, 60, 55])
    offline = transcriber.transcribe(audio, SR)
    assert len(offline) >= 6
    session = SESSIONS[impl](transcriber)
    live, tail = stream_all(session, audio)
    assert_same_events(live + tail, offline)
    assert len(live) >= len(offline) - 2  # most events during the stream
    assert session.stats["flushes"] >= 3


@pytest.mark.parametrize("impl", sorted(SESSIONS))
def test_block_size_independence(transcriber, impl):
    audio = melody([62, 66, 69, 74])
    offline = transcriber.transcribe(audio, SR)
    rng = np.random.RandomState(7)
    for _ in range(2):
        live, tail = stream_all(SESSIONS[impl](transcriber), audio, rng=rng)
        assert_same_events(live + tail, offline)


def test_port_and_jax_sessions_agree_over_the_port_transcriber(transcriber):
    audio = melody([60, 60, 65, 60, 60], note_s=0.4, gap_s=0.5)
    runs = [stream_all(cls(transcriber), audio, block_s=0.1) for cls in (t_streaming.StreamingSession, j_streaming.StreamingSession)]
    assert runs[0] == runs[1]
    events = runs[0][0] + runs[0][1]
    keys = [(round(s, 3), p) for s, _, p, *_ in events]
    assert len(keys) == len(set(keys)) and len(keys) >= 4
    assert runs[0][0] == sorted(runs[0][0])


def test_long_note_carries_across_flushes(transcriber):
    """A 3 s note spans several 2 s flush segments; it comes out once, with
    the onset from when it started."""
    t = np.arange(int(3.0 * SR)) / SR
    sustained = (
        0.4 * np.minimum(1.0, t / 0.02) * np.exp(-0.3 * t)
        * (np.sin(2 * np.pi * 220.0 * t) + 0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.25 * np.sin(2 * np.pi * 660.0 * t))
    ).astype(np.float32)
    audio = np.concatenate([np.zeros(int(0.5 * SR), np.float32), sustained, np.zeros(int(1.0 * SR), np.float32)])
    offline = transcriber.transcribe(audio, SR)
    live, tail = stream_all(t_streaming.StreamingSession(transcriber), audio, block_s=0.3)
    events = live + tail
    assert_same_events(events, offline)
    lows = [e for e in events if abs(e[0] - 0.5) < 0.1]
    assert lows and lows[0][1] - lows[0][0] > 1.5


def test_int16_feeds(transcriber):
    audio = melody([65, 69, 72])
    pcm = to_pcm16(audio)
    offline = transcriber.transcribe(pcm, SR)
    live, tail = stream_all(t_streaming.StreamingSession(transcriber), pcm)
    assert_same_events(live + tail, offline)


def test_api_errors_and_empty_close(transcriber):
    session = t_streaming.StreamingSession(transcriber)
    with pytest.raises(ValueError, match="mono"):
        session.feed(np.zeros((2, 100), np.float32))
    session.feed(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="dtype changed"):
        session.feed(np.zeros(100, np.int16))
    with pytest.raises(ValueError, match="unsupported dtype"):
        t_streaming.StreamingSession(transcriber).feed(np.zeros(10, np.int32))
    assert session.close() == []  # sub-threshold audio: no events, clean close
    with pytest.raises(RuntimeError):
        session.feed(np.zeros(10, np.float32))
    assert session.close() == []  # idempotent
    with pytest.raises(ValueError, match="22050 or 44100"):
        t_streaming.StreamingSession(transcriber, sample_rate=16000)
    with pytest.raises(ValueError, match="max_context_seconds"):
        t_streaming.StreamingSession(transcriber, segment_seconds=8.0, max_context_seconds=6.0)
    with pytest.raises(ValueError, match="segment_seconds"):
        t_streaming.StreamingSession(transcriber, segment_seconds=0.0)
    assert t_streaming.StreamingSession(transcriber).close() == []


class _ChunkedReader:
    """stdin stub delivering at most `chunk` bytes per read (misaligned
    sample boundaries exercise the carry path)."""

    def __init__(self, data: bytes, chunk: int):
        self._data = data
        self._pos = 0
        self._chunk = chunk

    def read(self, n: int) -> bytes:
        n = min(n, self._chunk)
        out = self._data[self._pos : self._pos + n]
        self._pos += len(out)
        return out


def test_stream_cli_ndjson_matches_offline(transcriber, capsys):
    audio = melody([60, 67, 72])
    pcm = to_pcm16(audio)
    offline = transcriber.transcribe(pcm, SR)

    out = io.StringIO()
    rc = stream_cli.main(
        ["--device", "cpu", "--windows-per-chunk", "4"],
        stdin=_ChunkedReader(pcm.tobytes(), chunk=5001),  # odd: splits samples
        stdout=out,
    )
    assert rc == 0
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    events = [(d["start_time_s"], d["end_time_s"], d["pitch_midi"]) for d in lines]
    assert_same_events(events, [(s, e, p) for s, e, p, *_ in offline])
    assert all(d["velocity"] == int(np.round(127 * d["amplitude"])) for d in lines)
    err = capsys.readouterr().err
    assert "stream done" in err
    assert "trailing byte" not in err


def test_stream_cli_reports_a_trailing_partial_sample(capsys):
    out = io.StringIO()
    assert stream_cli.main(["--device", "cpu", "--windows-per-chunk", "2"], stdin=io.BytesIO(b"\x01\x02\x03"), stdout=out) == 0
    assert out.getvalue() == ""
    assert "1 trailing byte(s)" in capsys.readouterr().err
