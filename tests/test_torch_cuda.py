"""Tests of the port's CUDA kernels that need the card.

They carry the ``cuda`` marker and skip on a machine without a GPU.  This
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

The kernel is held to its plain PyTorch version with the tolerance the CPU
tests give the plume sample (rtol 1e-5, atol 1e-4).
"""

import pytest
import torch

from tpu_plume_torch.core import get_preset
from tpu_plume_torch.ops import plume

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    pos = torch.rand(n, 2, device=device, generator=g) * 520.0 - 10.0
    source = 50.0 + 400.0 * torch.rand(n, 2, device=device, generator=g)
    bits = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                         device=device, generator=g)
    return pos, source, bits


@pytest.mark.parametrize("preset", ["ppo_v2_0", "ppo_v1_0"])
@pytest.mark.parametrize("n", [1, 4096, 100_003])
def test_plume_kernel_matches_plain(card, preset, n):
    cfg = get_preset(preset).env
    args = _inputs(n, n, card)
    before = plume.launches
    conc, tke = plume.sample_plume(*args, cfg)
    torch.cuda.synchronize()
    assert plume.launches == before + 1
    want_c, want_t = plume.sample_plume_plain(*args, cfg)
    torch.testing.assert_close(conc, want_c, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(tke, want_t, rtol=1e-5, atol=1e-4)


def test_plume_wrapper_raises_on_bad_cuda_inputs(card):
    cfg = get_preset("ppo_v2_0").env
    pos, source, bits = _inputs(64, 0, card)
    with pytest.raises(TypeError):
        plume.sample_plume(pos, source, bits.to(torch.int64), cfg)
    with pytest.raises(ValueError):
        plume.sample_plume(pos, source.cpu(), bits, cfg)
    with pytest.raises(ValueError):
        plume.sample_plume(pos.t().contiguous().t(), source, bits, cfg)
