"""The references against the port on the CPU at small sizes: the model's
posteriorgrams within float32's reach of the float64 reference, the frozen
decoder equal to the port's host decoder, and the training step's first
steps."""

import numpy as np
import pytest
import torch

from pb import bench, check, traffic
from reference import decode as ref_decode
from reference import nmp as ref_nmp

WEIGHTS = str(bench.ROOT / "basic_pitch_torch" / "assets" / "nmp_icassp2022.npz")
SPEC = {
    "sample_rate": 44100, "snippet_s": 2, "snippets_per_level": 1, "pool": 2,
    "durations": {"dist": "loguniform", "min_s": 2, "max_s": 4}, "voices": {"min": 2, "max": 6},
    "tones": {"noise": 0.01, "note_gap_s": [0.35, 0.7], "note_len_s": [0.5, 1.2], "pitch_midi": [36, 96]},
}


@pytest.mark.parametrize("sample_rate", [44100, 22050])
def test_posteriorgrams_match_the_port(sample_rate):
    from basic_pitch_torch.pipeline import StreamingTranscriber

    spec = dict(SPEC, sample_rate=sample_rate)
    ref = ref_nmp.Reference("cpu")
    params = ref_nmp.load_weights(WEIGHTS, "cpu", torch.float64)
    with StreamingTranscriber(device="cpu", windows_per_chunk=2, pcm_transport="raw") as port:
        for _, audio in traffic.recordings(7, spec):
            expected = ref.posteriorgrams(params, audio, sample_rate)
            got = port.posteriorgrams(audio, sample_rate)
            # float32 against float64: the dB normalisation amplifies
            # rounding in the quietest CQT bins to ~1e-4
            assert check.posteriorgram_gap(got, expected) < 1e-3


def _rolls(seed, frames):
    rng = np.random.RandomState(seed)
    note = (rng.rand(frames, 88) ** 6 * 0.6).astype(np.float32)
    onset = (rng.rand(frames, 88) ** 8 * 0.8).astype(np.float32)
    if seed % 2:
        note = np.round(note * 4) / 4  # ties for the argmax
    return note, onset


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("melodia", [True, False])
def test_frozen_decoder_is_the_ports_host_decoder(seed, melodia):
    from basic_pitch_torch.decode import notes as port_decode

    note, onset = _rolls(seed, 300 + 250 * seed)
    a = ref_decode.decode_note_events(note, onset, ref_decode.DecodeConfig(melodia_trick=melodia))
    b = port_decode.decode_note_events(note, onset, port_decode.DecodeConfig(melodia_trick=melodia))
    assert a == b
    contour = np.random.RandomState(seed).rand(note.shape[0], 264).astype(np.float32)
    assert ref_decode.extract_pitch_bends(contour, a) == port_decode.extract_pitch_bends(contour, b)


def test_scans_match_the_ports_on_edges():
    from basic_pitch_torch.decode import notes as port_decode

    rng = np.random.RandomState(1)
    for _ in range(2000):
        n = int(rng.choice([1, 2, 3, 12, 300, 600]))
        col = (rng.rand(n) < rng.rand()).astype(np.float32) * 0.5
        start, tol = int(rng.randint(0, n)), int(rng.choice([1, 2, 11]))
        assert ref_decode._forward_scan(col, start, 0.3, tol) == port_decode._forward_scan(col, start, 0.3, tol)
        assert ref_decode._backward_scan(col, start, 0.3, tol) == port_decode._backward_scan(col, start, 0.3, tol)


def test_events_of_the_transcriber_are_the_frozen_decoders():
    from basic_pitch_torch.pipeline import StreamingTranscriber

    with StreamingTranscriber(device="cpu", windows_per_chunk=2, pcm_transport="raw") as port:
        for _, audio in traffic.recordings(11, SPEC):
            events, outputs = port.transcribe_batch([(audio, 44100)], return_model_outputs=True)[0]
            cmp = check.compare_events(events, check.reference_events(outputs, check.DECODE_DEFAULTS))
            assert cmp["unmatched"] == 0 and cmp["bends_differ"] == 0 and cmp["amp_gap"] < 1e-6


def test_compare_events_counts():
    a = [(0.1, 0.5, 60, 0.5, [0, 1]), (0.2, 0.9, 62, 0.4, [0])]
    assert check.compare_events(a, a) == {"unmatched": 0.0, "unmatched_share": 0.0, "amp_gap": 0.0, "bends_differ": 0.0}
    b = [(0.1, 0.5, 60, 0.5001, [0, 2]), (0.2, 0.9, 63, 0.4, [0])]
    got = check.compare_events(a, b)
    assert got["unmatched"] == 2 and got["unmatched_share"] == pytest.approx(0.5)
    assert got["amp_gap"] == pytest.approx(1e-4) and got["bends_differ"] == 1


def test_norm_gap_takes_the_worst_leaf_against_the_median():
    ref = {"a": np.ones(4), "b": np.full(4, 2.0), "tiny": np.full(4, 1e-9)}
    assert check.norm_gap(ref, ref) == 0.0
    prog = dict(ref, a=np.ones(4) * 1.5)
    assert check.norm_gap(prog, ref) == pytest.approx(0.5 * 2 / 2)
    prog = dict(ref, tiny=np.full(4, 2e-9))  # measured against the median leaf
    assert check.norm_gap(prog, ref) < 1e-8
    assert check.norm_gap({k: v for k, v in ref.items() if k != "a"}, ref) == float("inf")
