"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need a CUDA card and skip elsewhere. On the GPU machine, which
has no jax (so the repository's conftest files cannot load), run:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

TF32 is switched off for matmuls and cuDNN, so both sides are fp32; the
tolerance covers summation order (rtol 1e-4, atol 1e-5 for the kernels).
"""

import pytest
import torch

from sovits_tpu import config as scfg
from sovits_tpu_torch.models import factory
from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_plain
from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest tests/test_torch_gpu.py -m gpu --noconftest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _g(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("bh,t,d,window,masked", [
    (4, 48, 24, 4, True),        # the CPU tests' shape
    (4, 48, 24, None, False),    # causal
    (2, 128, 96, 4, True),       # ContentEncoder, 128-frame bucket
    (2, 1024, 96, 4, True),      # ContentEncoder, 10 s clip
    (2, 2048, 96, 4, False),     # ContentEncoder, 20 s clip
    (2, 1000, 96, None, False),  # F0Decoder (causal), a length off the tile grid
])
def test_attention_kernel_matches_plain(cuda, bh, t, d, window, masked):
    g = _g(t)
    q = torch.randn(bh, t, d, generator=g) * d**-0.5
    k, v = torch.randn(2, bh, t, d, generator=g)
    rel = [torch.randn(2 * window + 1, d, generator=g) * d**-0.5 for _ in range(2)] if window else [None, None]
    km = None
    if masked:
        km = torch.ones(bh, t)
        km[-1, t - t // 3:] = 0.0
    args = [x.to(cuda) if x is not None else None for x in (q, k.contiguous(), v.contiguous(), *rel, km)]
    causal = window is None
    before = fused_attention.launches
    got = fused_attention(*args, window=window, causal=causal)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = fused_attention_plain(*args, window=window, causal=causal)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("c,t", [(16, 96), (32, 72), (128, 861 * 64), (64, 861 * 128),
                                 (32, 861 * 256), (16, 861 * 512)])
def test_trio_kernel_matches_plain(cuda, c, t):
    g = _g(c)
    x = torch.randn(1, t, c, generator=g).to(cuda)
    kernels = [(torch.randn(k, c, c, generator=g) * (0.5 / (k * c) ** 0.5)).to(cuda)
               for k in (3, 7, 11) for _ in range(6)]
    biases = [(torch.randn(c, generator=g) * 0.01).to(cuda) for _ in range(18)]
    before = fused_resblock_trio.launches
    got = fused_resblock_trio(x, kernels, biases)
    torch.cuda.synchronize()
    assert fused_resblock_trio.launches == before + 1
    torch.testing.assert_close(got, fused_resblock_trio_plain(x, kernels, biases), **TOL)


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(1, 64, 24, device=cuda)  # C = 24 has no kernel instantiation
    kernels = [torch.randn(k, 24, 24, device=cuda) for k in (3, 7, 11) for _ in range(6)]
    biases = [torch.zeros(24, device=cuda) for _ in range(18)]
    with pytest.raises(ValueError):
        fused_resblock_trio(x, kernels, biases)
    q = torch.randn(2, 32, 24, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, causal=True)


def test_full_width_synthesizer_cuda_matches_cpu(cuda):
    hps = scfg.default_config()
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu"), _g(0))
    g = _g(1)
    b, t = 1, 96
    c = torch.randn(b, t, hps.model.ssl_dim, generator=g)
    f0 = 150.0 + 100.0 * torch.rand(b, t, generator=g)
    uv = torch.ones(b, t)
    spk = torch.zeros(b, dtype=torch.long)
    kw = dict(noise_scale=0.0, sample_noise=False)
    ref, _ = model.infer(c, f0, uv, spk, **kw)
    model.to(cuda)
    fused_attention.launches = fused_resblock_trio.launches = 0
    got, _ = model.infer(*(x.to(cuda) for x in (c, f0, uv, spk)), **kw)
    torch.cuda.synchronize()
    assert fused_attention.launches == 6  # the ContentEncoder's layers
    assert fused_resblock_trio.launches == 4  # stages with C = 128, 64, 32, 16
    assert got.shape == (b, t * hps.data.hop_length, 1)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
