"""MT3's cell: its yardstick against counts written out by hand, its
readers on hand-made runs (and nothing from a run that holds nothing for
them), and the token budgets rebuilt from the traffic generator's draws."""

import types

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from basic_pitch_torch.utils import profiling
from pb import bench, mt3_yardstick, traffic
from pb.kinds import mt3 as kind
from reference import mt3 as ref_mt3

H100 = "NVIDIA H100 80GB HBM3"
READERS = ("model_mfu.mt3", "device_idle_pct.mt3", "decode_fill_pct.mt3", "host_encode_pct.mt3",
           "host_decode_loop_pct.mt3", "host_detok_pct.mt3", "cache_attn_roofline.mt3")


def test_segment_flops_match_a_count_by_hand():
    # front end: 497 taps x 2 per 16 kHz output, 32 768 outputs; mel
    # weighting 256 frames x 1 025 bins x 512 bands x 2
    front = 2 * 497 * 32768 + 2 * 256 * 1025 * 512
    assert mt3_yardstick.frontend_flops() == front == 301_268_992
    # encoder: input 256 x 512 x 512 x 2; per layer and position q, k, v
    # (512 -> 3 x 384), o (384 -> 512), MLP (512 -> 2 x 1024 -> 512), and
    # 2 x 2 x 256 x 384 for q k^T and p v
    per_position = 2 * (512 * 1152 + 384 * 512 + 512 * 2048 + 1024 * 512) + 4 * 256 * 384
    encoder = 2 * 256 * 512 * 512 + 8 * 256 * per_position
    assert mt3_yardstick.encoder_flops() == encoder == 10_603_200_512
    cross = 8 * 256 * 2 * 512 * 768
    assert mt3_yardstick.cross_kv_flops() == cross == 1_610_612_736
    # a decode step at cache length t + 1: self q, k, v, o; cache attention;
    # cross q and o; attention over 256 positions; MLP; logits to 1 408 rows
    def step(t):
        layer = (2 * (512 * 1152 + 384 * 512) + 4 * (t + 1) * 384 + 2 * (512 * 384 + 384 * 512)
                 + 4 * 256 * 384 + 2 * (512 * 2048 + 1024 * 512))
        return 8 * layer + 2 * 512 * 1408

    assert mt3_yardstick.decode_step_flops(0) == step(0) == 48_640_000
    assert mt3_yardstick.decode_step_flops(299) == step(299)
    n = 300
    assert mt3_yardstick.segment_flops(n) == front + encoder + cross + sum(step(t) for t in range(n))
    assert mt3_yardstick.segment_flops(0) == front + encoder + cross


def test_cache_attention_bytes_by_hand():
    # 3 tokens: self K and V at lengths 1, 2, 3 and cross K and V of 256
    # positions at each step, 6 x 64 float32 each, in 8 layers
    assert mt3_yardstick.cache_attention_bytes(3) == 8 * 2 * 384 * 4 * (1 + 2 + 3 + 3 * 256)
    assert mt3_yardstick.cache_attention_bytes(0) == 0


def _trace(window_s=2.0, busy_s=1.5, attn_s=0.02, launches=160):
    kernels = {"_mt3_cache_attention": attn_s, "sgemm": 0.5}
    calls = {"_mt3_cache_attention": launches, "sgemm": 900}
    return types.SimpleNamespace(
        window_s=window_s, busy_s=busy_s,
        device_seconds=lambda f: (sum(v for k, v in kernels.items() if f in k), sum(v for k, v in calls.items() if f in k)),
    )


def _run(stats=None, trace=None, device=H100):
    base = {"kind": "mt3", "setup_s": 20.0, "window_s": 50.0, "audio_s": 40000.0,
            "token_counts": [200, 300, 0], "traced_token_counts": [100, 50]}
    return types.SimpleNamespace(stats={**base, **(stats or {})}, trace=trace, device_name=device)


@pytest.fixture
def recorded(monkeypatch):
    """A scripted recording: time in ms of a clock that the spans read."""
    profiling.reset()
    now = [0]
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=lambda: now[0]))

    def at(ms):
        now[0] = int(ms * 1e6)

    yield at
    profiling.reset()


def test_readers_on_a_hand_made_run(recorded):
    at = recorded
    with profile(activities=[ProfilerActivity.CPU]):
        at(0)
        with profiling.span("bp.mt3.frontend"):
            profiling.count("mt3.segments", 3)
            at(100)
        with profiling.span("bp.mt3.encode"):
            at(300)
        with profiling.span("bp.mt3.decode"):
            profiling.count("mt3.decode_steps", 300)
            profiling.count("mt3.tokens_emitted", 500)
            profiling.count("mt3.token_rows_run", 800)
            at(1700)
        with profiling.span("bp.mt3.detokenize"):
            at(1800)
    run = _run(trace=_trace())
    got = {name: bench.read_metric(name, run) for name in READERS}
    flops = sum(mt3_yardstick.segment_flops(n) for n in (200, 300, 0))
    least = (mt3_yardstick.cache_attention_bytes(100) + mt3_yardstick.cache_attention_bytes(50)) / 3.35e12
    assert got == pytest.approx({
        "model_mfu.mt3": 100 * flops / 50.0 / 67.0e12,
        "device_idle_pct.mt3": 25.0,
        "decode_fill_pct.mt3": 62.5,
        "host_encode_pct.mt3": 10.0,  # 200 ms of 2 s
        "host_decode_loop_pct.mt3": 70.0,
        "host_detok_pct.mt3": 5.0,
        "cache_attn_roofline.mt3": 100 * least / 0.02,
    })


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_where_the_run_holds_nothing(name, recorded):
    """An untraced run gives only the window's share of the peak; a run of
    another kind, an unknown card, or a trace without the kernel or the
    spans gives nothing."""
    untraced = bench.read_metric(name, _run())
    assert (untraced is not None) == (name == "model_mfu.mt3")
    other = types.SimpleNamespace(stats={"kind": "offline", "window_s": 1.0}, trace=_trace(), device_name=H100)
    assert bench.read_metric(name, other) is None
    # a traced span with no recorded spans or counters and no kernel
    empty = _run(trace=_trace(attn_s=0.0, launches=0))
    if name not in ("model_mfu.mt3", "device_idle_pct.mt3"):
        assert bench.read_metric(name, empty) is None
    if name in ("model_mfu.mt3", "cache_attn_roofline.mt3"):
        assert bench.read_metric(name, _run(trace=_trace(), device="cpu")) is None


def test_snippet_notes_are_the_generators():
    spec = kind_spec()
    sr, n = spec["sample_rate"], int(spec["snippet_s"] * spec["sample_rate"])
    for level, k in [(12, 0), (16, 2)]:
        _, notes = traffic.tone_mix(traffic.rng(2**31 + 5, 1, level, k), n, sr, level, spec["tones"])
        assert kind.snippet_notes(2**31 + 5, level, k, n, sr, spec["tones"]) == notes


def kind_spec():
    import json

    return json.loads((bench.BENCH_DIR / "traffic" / "mt3-dense.json").read_text())


def test_token_budgets_of_the_pool():
    """The budgets of one dense 60 s recording: 30 segments of about 150-350
    tokens, each what the codec makes of the segment's notes."""
    spec = kind_spec()
    cfg = ref_mt3.Config()
    entry = traffic.recording_plan(spec)[0]
    notes = kind.recording_notes(2**31 + 9, spec, entry)
    n_seg = kind.n_segments(entry["samples"], spec["sample_rate"], cfg)
    assert n_seg == 30
    budgets = kind.token_budgets(notes, n_seg, cfg, spec["token_cap"])
    full = [(on, off, p, 127, 0, False) for on, off, p in notes]
    assert budgets == [len(ref_mt3.notes_to_tokens(full, k, cfg)) for k in range(n_seg)]
    assert 100 < np.median(budgets) < 400 and max(budgets) <= spec["token_cap"]
    assert abs(len(notes) / 60.0 - 20) < 6  # about 20 onsets a second


def test_unmatched_events_count_repeats_as_often_as_they_stand():
    drum = (0.5, 0.51, 36, 1.0, None)
    note = (0.1, 0.3, 60, 1.0, None)
    assert kind.unmatched_events([drum, drum, note], [128, 128, 0], [drum, drum, note], [128, 128, 0]) == 0
    assert kind.unmatched_events([drum, drum, note], [128, 128, 0], [drum, note], [128, 0]) == 1
    assert kind.unmatched_events([note], [0], [note], [5]) == 2  # another program
    assert kind.unmatched_events([note], [0], [(0.1, 0.3, 61, 1.0, None)], [0]) == 2


def _mt3_half_batch(monkeypatch):
    """The transcriber answers only the first half of each batch."""
    from basic_pitch_torch.mt3_pipeline import Mt3Transcriber

    real = Mt3Transcriber.transcribe_batch

    def half(self, recordings, **kwargs):
        kwargs["token_budgets"] = kwargs["token_budgets"][: max(1, len(recordings) // 2)]
        return real(self, recordings[: max(1, len(recordings) // 2)], **kwargs)

    monkeypatch.setattr(Mt3Transcriber, "transcribe_batch", half)


def _mt3_altered_tokens(monkeypatch):
    """Every segment's first token comes out one id higher, its events as
    the program read them before."""
    from basic_pitch_torch.mt3_pipeline import Mt3Transcriber

    real = Mt3Transcriber.transcribe_batch

    def altered(self, recordings, **kwargs):
        out = real(self, recordings, **kwargs)
        for _, outputs in out:
            for toks in outputs["tokens"]:
                if len(toks):
                    toks[0] += 1
        return out

    monkeypatch.setattr(Mt3Transcriber, "transcribe_batch", altered)


@pytest.mark.parametrize("fault", [_mt3_half_batch, _mt3_altered_tokens], ids=["half-batch", "altered-tokens"])
def test_fault_is_not_correct(monkeypatch, fault):
    from cells import execute

    fault(monkeypatch)
    result = execute("mt3.offline-dense", seconds=1.0)
    assert result["correct"] is False, result["checks"]
