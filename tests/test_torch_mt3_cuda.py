"""PyTorch port, MT3 on the card: the `_mt3_cache_attention` Triton kernel
against its plain version, and the transcriber at MT3's published widths
against the float64 reference.

Needs an NVIDIA GPU and Triton; every test here is marked `cuda` and skips
without a card. It imports no JAX, so on the GPU machine it runs without
the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mt3_cuda.py
"""

import numpy as np
import pytest
import torch

import mt3_reference as R
from basic_pitch_torch.models import mt3
from basic_pitch_torch.mt3_pipeline import Mt3Transcriber
from basic_pitch_torch.ops import cache_attention as cache_ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows, length", [(1, 1), (240, 17), (240, 64), (37, 257), (240, 1000)])
def test_cache_attention_kernel_matches_plain(cuda_device, rows, length):
    """On views of a larger cache, as the decode step passes them: float32
    sums in another order, so within a few 1e-7 of the values' scale."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows * 7919 + length)
    cache = torch.randn((2, rows + 3, 6, length + 9, 64), generator=gen, device=cuda_device)
    q = torch.randn((rows, 6, 64), generator=gen, device=cuda_device) * 0.2
    k, v = cache[0, :rows], cache[1, :rows]  # positions past the length hold other values
    before = cache_ops.LAUNCHES
    got = cache_ops.cache_attention(q, k, v, torch.tensor([length], device=cuda_device))
    torch.cuda.synchronize()
    assert cache_ops.LAUNCHES == before + 1
    want = cache_ops.cache_attention_plain(q.double(), k.double(), v.double(), torch.tensor([length], device=cuda_device))
    assert float((got.double() - want).abs().max()) < 2e-6 * float(want.abs().max())


@pytest.mark.cuda
def test_transcriber_at_published_widths_matches_the_reference(cuda_device):
    """Two segments of a 3 s recording with token budgets, decoded on the
    card, against the float64 reference teacher-forced on the program's
    tokens (float32 rounding through 16 layers: ~1e-6 of the largest
    logit)."""
    rng = np.random.default_rng(3)
    t = np.arange(3 * 44100) / 44100
    audio = np.round((0.3 * np.sin(2 * np.pi * 330 * t) + 0.01 * rng.standard_normal(len(t))) * 32767).astype(np.int16)
    tr = Mt3Transcriber(1234, device=cuda_device, pcm_transport="raw")
    (events, out), = tr.transcribe_batch([(audio, 44100)], token_budgets=[[40, 25]], return_model_outputs=True, return_logits=[0])
    assert [len(x) for x in out["tokens"]] == [40, 25]
    cfg = R.Config()
    params = R.init_params(cfg, 1234, cuda_device, torch.float64)
    mel = R.log_mel(torch.from_numpy(R.segments(R.to_16k(audio, 44100), cfg)).to(cuda_device), cfg)
    # mel magnitudes against the reference's largest: float32 rounding
    # (~1e-7); in the log domain the resampler's stopband bands, a thousandth
    # of the noise floor, read a few 1e-3
    got_mel = torch.from_numpy(out["mel"]).to(cuda_device).double().exp()
    assert float((got_mel - mel.exp()).abs().max() / mel.exp().max()) < 1e-5
    enc = R.encode(params, mel, cfg)
    for j, toks in enumerate(out["tokens"]):
        full = R.decode_logits(params, enc[j : j + 1], R.teacher_inputs(list(toks), cuda_device)[None], cfg)[0]
        got = torch.from_numpy(out["logits"][j]).to(cuda_device).double()
        assert float((got - full).abs().max() / full.abs().max()) < 1e-4
        masked = got.clone()
        masked[:, mt3.EOS] = float("-inf")
        assert masked.argmax(-1).tolist() == list(toks)


@pytest.mark.cuda
def test_graphs_are_captured_anew_when_the_cache_grows(cuda_device):
    """A batch that needs more positions than the self cache holds drops
    the step's graphs, and with them their memory pool, and captures anew;
    so does a decode after one whose graphs all kept logits. Each decode
    emits its budgets, and the kept logits follow the float64 reference's
    full forward pass (float32 rounding through 2 layers: ~1e-7)."""
    small = dict(n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=2, d_head=32, d_mlp=128, n_mels=16, frames=32)
    cfg, rcfg = mt3.Mt3Config(**small), R.Config(**small)
    params = mt3.init_params(cfg, 99, cuda_device)
    ref = R.init_params(rcfg, 99, cuda_device, torch.float64)
    mel = torch.randn((20, cfg.frames, cfg.n_mels), generator=torch.Generator(device=cuda_device).manual_seed(5), device=cuda_device)
    enc = R.encode(ref, mel.double(), rcfg)

    def decode(model, caps, keep=()):
        model.cross_kv(model.encode(mel[: len(caps)]))
        out = model.greedy(caps, [True] * len(caps), keep)
        assert [len(t) for t in out.tokens] == caps
        for row in keep:
            full = R.decode_logits(ref, enc[row : row + 1], R.teacher_inputs(list(out.tokens[row]), cuda_device)[None], rcfg)[0]
            got = torch.from_numpy(out.logits[row]).to(cuda_device).double()
            assert float((got - full).abs().max() / full.abs().max()) < 1e-5
        return model

    model = decode(mt3.MT3(params, cfg, cuda_device), [40] * 3 + [20] * 17)
    assert model.cache_bytes()["positions"] == mt3.POSITION_BUCKET
    decode(model, [mt3.POSITION_BUCKET + 30] * 2 + [9] * 18, keep=[0])  # grows: new graphs, new pool
    assert model.cache_bytes()["positions"] == 2 * mt3.POSITION_BUCKET
    decode(model, [50] * 20)
    fresh = decode(mt3.MT3(params, cfg, cuda_device), [12] * 20, keep=[0, 5])  # every graph kept logits
    decode(fresh, [12] * 20)
