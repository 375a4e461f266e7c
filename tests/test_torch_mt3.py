"""PyTorch port, MT3 (`models/mt3.py`, `ops/resample.py`'s 160/441
resampler, `ops/logmel.py`, `decode/mt3_codec.py`, `mt3_pipeline.py`)
against the plain reference `tests/mt3_reference.py`, on the CPU at a small
size with seeded weights (2 + 2 layers, width 64, 2 heads of 32, MLP 128,
16 mel bins, 32 frames a segment).

Tolerances. The program computes in float32 and the reference in float64,
so every gap is float32 rounding carried through the network: a few 1e-7
of the largest value at this size (measured 2-5e-7). The limits below give
that an order of magnitude of room and stay far under what any wrong
equation gives (order 1).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly
from torch.profiler import ProfilerActivity, profile

import mt3_reference as R
from basic_pitch_torch.decode import mt3_codec
from basic_pitch_torch.models import mt3
from basic_pitch_torch.mt3_pipeline import Mt3Transcriber
from basic_pitch_torch.ops import cache_attention as cache_ops
from basic_pitch_torch.ops import logmel
from basic_pitch_torch.ops import resample as resample_ops
from basic_pitch_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=2, d_head=32, d_mlp=128, n_mels=16, frames=32)
CFG = mt3.Mt3Config(**SMALL)
RCFG = R.Config(**SMALL)
SEED = 2**31 + 17
# float32 against float64, relative to the largest value compared (see the doc)
REL = 5e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    return mt3.init_params(CFG, SEED, "cpu")


@pytest.fixture(scope="module")
def ref64():
    return R.init_params(RCFG, SEED, "cpu", torch.float64)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a), dtype=torch.float64), torch.as_tensor(np.asarray(b), dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max())


def _recording(seconds: float, seed: int) -> np.ndarray:
    """int16 44.1 kHz: two tones over noise."""
    t = np.arange(int(44100 * seconds)) / 44100
    rng = np.random.default_rng(seed)
    y = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1234.5 * t) + 0.01 * rng.standard_normal(len(t))
    return np.round(y * 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first_block, n_blocks", [(0, 7), (37, 5), (266, 6)])
def test_resampler_matches_resample_poly(first_block, n_blocks):
    """Any run of blocks, with its halo, gives resample_poly's outputs
    (float32 products of a 497-tap window: ~1e-7 of the signal's scale)."""
    x = np.random.default_rng(3).standard_normal(int(44100 * 2.7))
    ref = resample_poly(x, 160, 441)
    assert len(ref) == resample_ops.poly_output_length(len(x))
    lo = 441 * first_block - resample_ops.POLY_HALO
    piece = np.zeros(441 * n_blocks + 2 * resample_ops.POLY_HALO)
    src = x[max(lo, 0) : lo + len(piece)]
    piece[max(-lo, 0) : max(-lo, 0) + len(src)] = src
    got = resample_ops.resample_160_441(torch.from_numpy(piece).float(), n_blocks).double().numpy()
    want = ref[160 * first_block : 160 * (first_block + n_blocks)]  # the last run ends with the recording
    assert len(want) > 0
    assert np.abs(got[: len(want)] - want).max() <= 1e-6 * np.abs(ref).max()


def test_resampler_refuses_a_short_piece():
    with pytest.raises(ValueError):
        resample_ops.resample_160_441(torch.zeros(441 * 3), 3)


def test_mel_weights_match_the_reference():
    ours = logmel.mel_weights(RCFG.sample_rate, RCFG.n_fft, 512, RCFG.f_min, RCFG.f_max)
    theirs = R.mel_matrix(R.Config())
    assert ours.shape == theirs.shape == (1025, 512)
    assert np.abs(ours - theirs).max() < 1e-7  # float32 storage of the weights


@pytest.mark.parametrize("sample_rate", [16000, 44100])
def test_log_mel_matches_the_reference(params, sample_rate):
    """The transcriber's front end (upload, resampler, segments, log-mel)
    against the reference's. The gap is in the log domain, so it is the
    relative error of each mel value: float32 FFT magnitudes of bins far
    below a frame's loudest carry ~1e-6 of their own value."""
    audio = _recording(1.3, 4)
    if sample_rate == 16000:
        audio = np.round(resample_poly(audio / 32768.0, 160, 441) * 32767).astype(np.int16)
    tr = Mt3Transcriber(params, CFG, device="cpu", pcm_transport="raw")
    tr.piece_segments = 5  # several pieces, their seams inside the recording
    got = tr.features(audio, sample_rate)
    want = R.log_mel(torch.from_numpy(R.segments(R.to_16k(audio, sample_rate), RCFG)), RCFG)
    assert got.shape == want.shape == (tr.n_segments(len(audio), sample_rate), CFG.frames, CFG.n_mels)
    assert float((got.double() - want).abs().max()) < 2e-5


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def test_seeded_weights_are_the_references_draws(params):
    ref = R.init_params(RCFG, SEED, "cpu", torch.float32)
    assert list(params) == list(ref)
    assert all(torch.equal(params[k], ref[k]) for k in ref)
    assert [(n, s) for n, s, _ in mt3.param_specs(mt3.Mt3Config())] == [(n, s) for n, s, _ in R.param_specs(R.Config())]


def test_sinusoids_match_the_reference():
    got = mt3.sinusoids(300, 512)
    want = R.positions(300, 512, torch.float64, "cpu").numpy()
    assert np.abs(got - want).max() < 1e-6


def _mel(batch: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((batch, CFG.frames, CFG.n_mels))).float()


def test_encoder_matches_the_reference(params, ref64):
    mel = _mel(3, 5)
    got = mt3.MT3(params, CFG, torch.device("cpu")).encode(mel)
    assert _rel(got, R.encode(ref64, mel.double(), RCFG)) < REL


def test_cached_decoding_matches_the_full_forward_pass(params, ref64):
    """The cached greedy loop's logits at every step against the
    reference's full forward pass, teacher-forced on the same tokens, per
    row, rows of other lengths beside it (the live prefix shrinks)."""
    model = mt3.MT3(params, CFG, torch.device("cpu"))
    mel = _mel(4, 6)
    caps = [23, 16, 9, 0]
    model.cross_kv(model.encode(mel))
    out = model.greedy(caps, [True] * 4, keep=[0, 1, 2, 3])
    assert [len(t) for t in out.tokens] == caps
    # every step runs one bucket of rows
    assert out.steps == 23 and out.rows_run == 23 * mt3.ROW_BUCKET
    enc = R.encode(ref64, mel.double(), RCFG)
    for row, toks in enumerate(out.tokens):
        assert out.logits[row].shape == (len(toks), mt3.VOCAB)
        if len(toks):
            full = R.decode_logits(ref64, enc[row : row + 1], R.teacher_inputs(list(toks), "cpu")[None], RCFG)[0]
            assert _rel(out.logits[row], full) < REL


def test_self_cache_holds_the_positions_the_batch_needs(params, ref64):
    """The self-attention cache is sized by the largest cap, rounded up to
    POSITION_BUCKET, grows for a longer batch and keeps its size for a
    shorter one; the kept logits' buffer lives only through its decode.
    A decode on the grown cache still matches the full forward pass."""
    model = mt3.MT3(params, CFG, torch.device("cpu"))
    mel = _mel(2, 11)
    model.cross_kv(model.encode(mel))
    model.greedy([5, 3], [True, True])
    assert model.cache_bytes()["positions"] == mt3.POSITION_BUCKET
    assert model.cache_bytes()["self_kv"] == CFG.n_dec_layers * 2 * mt3.ROW_BUCKET * CFG.n_heads * mt3.POSITION_BUCKET * CFG.d_head * 4
    model.cross_kv(model.encode(mel))
    out = model.greedy([mt3.POSITION_BUCKET + 1, 2], [True, True], keep=[0])
    assert model.cache_bytes()["positions"] == 2 * mt3.POSITION_BUCKET
    assert "history" not in model._state
    model.cross_kv(model.encode(mel))
    model.greedy([4, 4], [True, True])
    assert model.cache_bytes()["positions"] == 2 * mt3.POSITION_BUCKET
    enc = R.encode(ref64, mel.double(), RCFG)
    full = R.decode_logits(ref64, enc[:1], R.teacher_inputs(list(out.tokens[0]), "cpu")[None], RCFG)[0]
    assert _rel(out.logits[0], full) < REL


def test_emitted_tokens_are_the_argmax_of_their_logits(params):
    model = mt3.MT3(params, CFG, torch.device("cpu"))
    model.cross_kv(model.encode(_mel(3, 7)))
    out = model.greedy([12, 12, 5], [True, False, True], keep=[0, 1, 2])
    for row, budgeted in enumerate([True, False, True]):
        logits = out.logits[row].copy()
        if budgeted:
            logits[:, mt3.EOS] = -np.inf
        assert np.array_equal(np.argmax(logits, axis=1), out.tokens[row])


def _eos_prone(params):
    """The weights with EOS's logit column scaled up, so that EOS wins at
    some steps of some rows."""
    p = dict(params)
    w = p["decoder/logits"].clone()
    w[:, mt3.EOS] *= 6.0
    p["decoder/logits"] = w
    return p


def test_budgets_mask_eos_and_max_new_tokens_stops(params):
    """A budgeted row masks EOS and stops at its count; an unbudgeted row
    stops after its first EOS, or at the cap; the reference's greedy loop by
    full recomputation gives the same tokens."""
    p = _eos_prone(params)
    model = mt3.MT3(p, CFG, torch.device("cpu"))
    mel = _mel(6, 8)
    caps = [40, 40, 40, 30, 12, 3]
    budgeted = [False, True, False, True, False, True]
    order = sorted(range(6), key=lambda i: -caps[i])
    model.cross_kv(model.encode(mel[order]))
    out = model.greedy([caps[i] for i in order], [budgeted[i] for i in order])
    tokens = {i: out.tokens[j].tolist() for j, i in enumerate(order)}
    ref = {k: v.double() for k, v in p.items()}
    want, _ = R.greedy(ref, R.encode(ref, mel.double(), RCFG), caps, budgeted, RCFG)
    assert [tokens[i] for i in range(6)] == want
    for i in range(6):
        if budgeted[i]:
            assert len(tokens[i]) == caps[i] and mt3.EOS not in tokens[i]
        else:
            assert len(tokens[i]) == caps[i] or tokens[i][-1] == mt3.EOS
            assert mt3.EOS not in tokens[i][:-1]
    stopped = [i for i in range(6) if not budgeted[i] and len(tokens[i]) < caps[i]]
    assert stopped, "no row stopped at its EOS: the case tests nothing"


def test_greedy_refuses_unsorted_rows_and_caps_past_the_positions(params):
    model = mt3.MT3(params, CFG, torch.device("cpu"))
    with pytest.raises(ValueError):  # no batch set
        model.greedy([3], [True])
    model.cross_kv(model.encode(_mel(2, 9)))
    with pytest.raises(ValueError):
        model.greedy([3, 5], [True, True])
    with pytest.raises(ValueError):
        model.greedy([CFG.max_tokens + 1, 1], [True, True])
    with pytest.raises(ValueError):  # more rows than the batch
        model.greedy([5] * (mt3.ROW_BUCKET + 1), [True] * (mt3.ROW_BUCKET + 1))


@pytest.mark.parametrize("length", [1, 3, 5])
def test_cache_attention_plain_is_softmax_attention_over_the_length(length):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)) for s in [(3, 2, 8), (3, 2, 5, 8), (3, 2, 5, 8)])
    want = torch.stack([
        torch.stack([torch.softmax(k[n, h, :length] @ q[n, h], 0) @ v[n, h, :length] for h in range(2)]) for n in range(3)
    ])
    assert torch.allclose(cache_ops.cache_attention(q, k, v, torch.tensor([length])), want)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

T = R.token


def _both(segments, duration):
    ours = mt3_codec.tokens_to_events(segments, duration, RCFG.segment_samples, RCFG.sample_rate, RCFG.drum_note_s)
    theirs = R.tokens_to_events(segments, duration, RCFG)
    assert ours == theirs
    return ours


def test_codec_ids_are_mt3s_order():
    assert mt3_codec.VOCAB == R.VOCAB == mt3.VOCAB == 1391
    assert (mt3_codec.SHIFT, mt3_codec.PITCH, mt3_codec.VELOCITY, mt3_codec.TIE, mt3_codec.PROGRAM, mt3_codec.DRUM) == tuple(
        R.FIRST_ID[k] for k in ("shift", "pitch", "velocity", "tie", "program", "drum")
    )


def test_detokenizer_ties_a_note_across_segments():
    seg = RCFG.segment_s
    segments = [
        [T("tie"), T("shift", 10), T("program", 0), T("velocity", 1), T("pitch", 60), T("pitch", 64),
         T("shift", 20), T("velocity", 0), T("pitch", 64)],
        # 60 carries over, anything else would end at the segment's start
        [T("program", 0), T("pitch", 60), T("tie"), T("shift", 5), T("velocity", 0), T("pitch", 60)],
    ]
    events, programs = _both(segments, 2 * seg)
    assert [(round(s, 6), round(e, 6), p) for s, e, p, _, _ in events] == [
        (0.1, 0.2, 64), (0.1, round(seg + 0.05, 6), 60)]
    assert all(a == 1.0 and b is None for _, _, _, a, b in events) and programs == [0, 0]


def test_detokenizer_ends_untied_notes_at_the_segments_start():
    seg = RCFG.segment_s
    segments = [[T("tie"), T("velocity", 1), T("pitch", 50), T("pitch", 51)], [T("program", 0), T("pitch", 51), T("tie")]]
    events, _ = _both(segments, 2 * seg)
    assert [(round(s, 6), round(e, 6), p) for s, e, p, _, _ in events] == [(0.0, round(seg, 6), 50), (0.0, round(2 * seg, 6), 51)]


def test_detokenizer_program_changes_drums_and_an_open_note():
    segments = [[
        T("tie"), T("program", 33), T("velocity", 1), T("pitch", 40), T("program", 0), T("pitch", 40),
        T("shift", 3), T("drum", 36), T("program", 33), T("velocity", 0), T("pitch", 40),
        T("shift", 7), T("velocity", 1), T("pitch", 72),  # program 33, never ended
        R.EOS, T("pitch", 99),  # after EOS: ignored
    ]]
    events, programs = _both(segments, 0.5)
    got = sorted((round(s, 6), round(e, 6), p, prog) for (s, e, p, _, _), prog in zip(events, programs))
    assert got == [(0.0, 0.03, 40, 33), (0.0, 0.5, 40, 0), (0.03, 0.04, 36, mt3_codec.DRUM_PROGRAM), (0.07, 0.5, 72, 33)]


def test_detokenizer_skips_what_cannot_stand_there():
    segments = [[R.PAD, T("velocity", 1), T("drum", 1), T("tie"), T("tie"), R.UNK, T("velocity", 0), T("pitch", 5),
                 T("drum", 38), T("shift", 4), T("shift", 6), T("velocity", 1), T("pitch", 5)]]
    events, _ = _both(segments, 1.0)
    # shifts in a row add up; the velocity and drum in the tie section,
    # the second tie, the offset of a silent pitch and the drum at
    # velocity 0 leave nothing
    assert [(round(s, 6), round(e, 6), p) for s, e, p, _, _ in events] == [(0.1, 1.0, 5)]


def test_detokenizer_matches_the_reference_on_random_tokens():
    """Random segments, most ids drawn from a few shifts, pitches, states,
    ties, drums and EOS so that every rule is hit, with repeats: events and
    programs exactly the reference's."""
    rng = np.random.default_rng(0)
    repeated = 0
    for _ in range(300):
        n_seg = int(rng.integers(1, 5))
        pool = ([T("shift", int(v)) for v in rng.integers(0, 300, 3)] + [T("pitch", int(v)) for v in rng.integers(40, 44, 3)]
                + [T("velocity", 0), T("velocity", 1), T("tie"), T("program", 0), T("program", 5), T("drum", 36), R.EOS, R.PAD])
        segments = [
            [int(rng.choice(pool)) if rng.random() < 0.8 else int(rng.integers(0, R.VOCAB)) for _ in range(int(rng.integers(0, 60)))]
            for _ in range(n_seg)
        ]
        events, programs = _both(segments, n_seg * RCFG.segment_s)
        keys = [(e[0], e[1], e[2], prog) for e, prog in zip(events, programs)]
        repeated += len(keys) - len(set(keys))
    assert repeated > 0  # repeated events occur, and both sides keep them


def test_codec_round_trip_of_rendered_notes():
    """Notes -> the reference's tokens per segment -> the program's events:
    the notes come back on the 10 ms grid, ties and all."""
    seg = RCFG.segment_s
    rng = np.random.default_rng(11)
    notes = []
    for _ in range(30):
        on = float(rng.uniform(0, 4 * seg - 0.05))
        notes.append((on, min(on + float(rng.uniform(0.05, 0.6)), 4 * seg), int(rng.integers(30, 90)), 127, 0, False))
    notes.append((0.3, 0.3, 38, 127, 9, True))
    segments = [R.notes_to_tokens(notes, k, RCFG) for k in range(4)]
    events, programs = _both(segments, 4 * seg)

    def grid(t):
        k = R.segment_of(t, RCFG)
        return round(k * RCFG.segment_samples / RCFG.sample_rate + R.step_in(t, k, RCFG) / 100, 6)

    want = sorted((grid(on), grid(off), p) for on, off, p, _, _, drum in notes if not drum)
    got = sorted((round(s, 6), round(e, 6), p) for (s, e, p, _, _), prog in zip(events, programs) if prog != 128)
    assert len(got) == len(want)
    # overlapping notes of one pitch end each other early; every other note is exact
    exact = sum(g == w for g, w in zip(got, want))
    assert exact >= len(want) - 4
    assert programs.count(128) == 1


# ---------------------------------------------------------------------------
# the transcriber
# ---------------------------------------------------------------------------


def _reference_pipeline(ref, recordings, budgets, max_new_tokens):
    out = []
    for (audio, sr), budget in zip(recordings, budgets):
        mel = R.log_mel(torch.from_numpy(R.segments(R.to_16k(audio, sr), RCFG)), RCFG)
        enc = R.encode(ref, mel, RCFG)
        caps = [min(b, max_new_tokens) for b in budget] if budget else [max_new_tokens] * len(mel)
        tokens, logits = R.greedy(ref, enc, caps, [budget is not None] * len(mel), RCFG)
        events, programs = R.tokens_to_events(tokens, len(audio) / sr, RCFG)
        out.append((events, programs, tokens, logits, mel, enc))
    return out


def test_transcribe_batch_matches_the_reference_pipeline(params):
    """Two recordings of different lengths whose segments share decode
    batches, one with token budgets: tokens and events exactly, logits, mel
    and encoder output within float32 rounding."""
    p = _eos_prone(params)
    recordings = [(_recording(0.9, 1), 44100), (_recording(0.5, 2), 44100)]
    tr = Mt3Transcriber(p, CFG, device="cpu", segments_per_call=3, max_new_tokens=25, pcm_transport="raw")
    n_seg = [tr.n_segments(len(a), sr) for a, sr in recordings]
    assert n_seg == [4, 2]
    budgets = [[7, 0, 30, 12], None]
    got = tr.transcribe_batch(recordings, token_budgets=budgets, return_model_outputs=True, return_logits=[0, 1])
    ref = _reference_pipeline({k: v.double() for k, v in p.items()}, recordings, budgets, 25)
    for (events, outputs), (r_events, r_programs, r_tokens, r_logits, r_mel, r_enc) in zip(got, ref):
        assert [t.tolist() for t in outputs["tokens"]] == r_tokens
        assert events == r_events and outputs["programs"] == r_programs
        assert float(np.abs(outputs["mel"] - r_mel.numpy()).max()) < 2e-5
        assert _rel(outputs["encoded"], r_enc) < REL
        for a, b in zip(outputs["logits"], r_logits):
            assert a.shape == tuple(b.shape)
            if len(a):
                assert _rel(a, b) < REL
    assert [len(t) for t in got[0][1]["tokens"]] == [7, 0, 25, 12]
    plain = tr.transcribe_batch(recordings, token_budgets=budgets)
    assert plain == [events for events, _ in got]


def test_transcribe_batch_refuses_budgets_of_the_wrong_length(params):
    tr = Mt3Transcriber(params, CFG, device="cpu", pcm_transport="raw")
    with pytest.raises(ValueError):
        tr.transcribe_batch([(_recording(0.5, 3), 44100)], token_budgets=[[1, 2, 3]])
    with pytest.raises(ValueError):
        tr.transcribe_batch([(_recording(0.5, 3), 22050)])
    with pytest.raises(ValueError):
        Mt3Transcriber(params, CFG, device="cpu", max_new_tokens=CFG.max_tokens + 1, pcm_transport="raw")


def test_spans_and_counters(params):
    recordings = [(_recording(0.7, 5), 44100), (_recording(0.2, 6), 44100)]
    tr = Mt3Transcriber(params, CFG, device="cpu", segments_per_call=2, max_new_tokens=6, pcm_transport="raw")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tr.transcribe_batch(recordings, token_budgets=[[4, 6, 2], [5]], return_model_outputs=True)
    got_summary = profiling.summary()
    profiling.reset()
    spans, counters = got_summary["spans"], got_summary["counters"]
    assert spans["bp.mt3.frontend"]["count"] == 2 and spans["bp.mt3.detokenize"]["count"] == 2
    assert spans["bp.mt3.encode"]["count"] == spans["bp.mt3.decode"]["count"] == 2
    emitted = sum(len(t) for _, out in got for t in out["tokens"])
    assert counters["mt3.segments"] == 4 and counters["mt3.tokens_emitted"] == emitted == 17
    # batches [6, 4] and [5, 2]: each step runs one bucket of rows
    assert counters["mt3.decode_steps"] == 6 + 5 and counters["mt3.token_rows_run"] == (6 + 5) * mt3.ROW_BUCKET


def test_reference_copy_is_the_benchmarks():
    assert (ROOT / "tests" / "mt3_reference.py").read_bytes() == (ROOT / "port_bench" / "reference" / "mt3.py").read_bytes()


def test_mt3_imports_no_jax():
    code = (
        "import sys; import basic_pitch_torch.mt3_pipeline; "
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'basic_pitch_tpu'}); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
