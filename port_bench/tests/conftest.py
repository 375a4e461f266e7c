"""The harness's CPU tests: `port_bench/` and the checkout's root on the
import path, one torch thread, and the card-only tests decided inside each
test."""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
