"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These tests need a CUDA card and skip elsewhere. On the GPU machine, which
has no jax (so the repository's conftest files cannot load), run:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

TF32 is switched off for matmuls and cuDNN, so both sides are fp32; the
tolerance covers summation order (rtol 1e-4, atol 1e-5 for the kernels; the
rel-table gradients sum over every row of every head, atol 1e-4). A bf16
kernel is held to its plain bf16 version within 2e-2 x max|plain| (a few
bf16 ulps).
"""

import pytest
import torch

from chip_smoke import CONFIG_CASES, bench_signal, config_hps
from sovits_tpu_torch import config as scfg
from sovits_tpu_torch.models import factory
from sovits_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_plain,
    fused_attention_plain,
)
from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain, trio_plan

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


# (bh, t, d, window, causal, key mask, dropout). Key mask "tail": the last
# row's last third masked, as a shorter clip in a batch; "empty": also every
# key of row 0 masked, which the reference softmaxes to a uniform row. The
# kernel's tiles are 16 query rows and 32 (bf16) or 16 (fp32) keys, and D is
# zero-padded to 32, 64, 96 or 128; the lengths below fall off every boundary.
ATTN_CASES = [
    (4, 48, 24, 4, False, "tail", False),      # the CPU tests' shape
    (4, 48, 24, None, True, None, False),      # causal
    (2, 128, 96, 4, False, "tail", False),     # ContentEncoder, 128-frame bucket
    (2, 1024, 96, 4, False, "tail", False),    # ContentEncoder, 10 s clip
    (2, 2048, 96, 4, False, None, False),      # ContentEncoder, 20 s clip
    (2, 1000, 96, None, True, None, False),    # F0Decoder (causal), off the tile grid
    (3, 9, 96, 4, False, "tail", False),
    (3, 15, 24, None, True, None, False),
    (3, 17, 128, 4, False, "tail", False),
    (2, 63, 96, None, True, "tail", False),    # causal with a key mask: no tile skipped
    (2, 65, 128, None, True, None, False),     # causal without: tiles above the diagonal skipped
    (2, 2048, 24, None, True, None, False),
    (3, 100, 96, 4, False, "empty", False),    # a fully masked row, windowed
    (3, 65, 24, None, True, "empty", False),   # a fully masked row, causal
    (2, 100, 17, 4, False, "tail", False),     # rows not a whole number of 16-byte chunks
    (12, 800, 96, None, True, None, False),    # causal at the training shape
    (12, 800, 96, 4, False, "tail", True),     # training: dropout and LSE
    (12, 800, 96, None, True, None, True),
]


def _case_id(case):
    bh, t, d, window, causal, mask, drop = case
    return (f"bh{bh}-t{t}-d{d}-" + ("causal" if causal else f"w{window}") + (f"-{mask}" if mask else "")
            + ("-dropout" if drop else ""))


def _attention_inputs(case, dtype, device):
    bh, t, d, window, causal, mask, drop = case
    g = _g(bh * 100003 + t * 131 + d)
    q = torch.randn(bh, t, d, generator=g) * d**-0.5
    k, v = torch.randn(2, bh, t, d, generator=g)
    rel = [torch.randn(2 * window + 1, d, generator=g) * d**-0.5 for _ in range(2)] if window else [None, None]
    km = dm = None
    if mask:
        km = torch.ones(bh, t)
        km[-1, t - max(t // 3, 1):] = 0.0
        if mask == "empty":
            km[0] = 0.0
    if drop:
        dm = (torch.rand(bh, t, t, generator=g) >= 0.1).float() / 0.9
    args = [x.to(device, dtype) if x is not None else None for x in (q, k.contiguous(), v.contiguous(), *rel)]
    return args + [x.to(device) if x is not None else None for x in (km, dm)]


def _check_attention(case, dtype, device, close):
    """One launch of the forward kernel against the plain version; the LSE
    (a second launch, as training asks for it) against logsumexp of the
    plain scores; a fully masked row against the uniform row it must be."""
    from sovits_tpu_torch.ops.attention import _forward, _scores

    _, t, d, window, causal, mask, _ = case
    args = _attention_inputs(case, dtype, device)
    before = fused_attention.launches
    got = fused_attention(*args, window=window, causal=causal)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    close(got, fused_attention_plain(*args, window=window, causal=causal))
    out, lse = _forward(*args, window, causal, want_lse=True)
    assert torch.equal(out, got)
    q, k, v, rel_k, rel_v, km, _ = args
    torch.testing.assert_close(lse, torch.logsumexp(_scores(q, k, rel_k, km, window, causal), -1), **TOL)
    if mask == "empty":  # p = 1/T over all keys of row 0
        want = v[0].float().mean(0).expand(t, d).clone()
        if window is not None:
            for o in range(2 * window + 1):
                lo, hi = max(window - o, 0), min(t, t + window - o)
                want[lo:hi] += rel_v[o].float() / t
        err = (got[0].float() - want).abs().max().item()
        assert err <= (1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max().item()), err


@pytest.mark.parametrize("case", ATTN_CASES, ids=_case_id)
def test_attention_kernel_matches_plain(cuda, case):
    _check_attention(case, torch.float32, cuda, lambda a, b: torch.testing.assert_close(a, b, **TOL))


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
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(0))
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


@pytest.mark.parametrize("name", list(CONFIG_CASES))
def test_full_width_config_cuda_matches_cpu(cuda, name):
    """chip_smoke.py's [configs] models (so-vits-svc 4.1's options at full
    width) on the card against the CPU, fp32, noise off, atol 1e-4 on the
    audio and on the latent after the reversed flow, with the table's K1 and
    K3 launches: the transformer flow adds 12 causal K1, and only a
    resblock-"1" generator with plain convs launches K3."""
    _template, _overrides, k1, k3, _bf16 = CONFIG_CASES[name]
    hps = config_hps(name)
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(0))
    g = _g(1)
    b, t = 1, 96
    inputs = (torch.randn(b, t, hps.model.ssl_dim, generator=g), 150.0 + 100.0 * torch.rand(b, t, generator=g),
              torch.ones(b, t), torch.zeros(b, dtype=torch.long))
    kw = dict(noise_scale=0.0, sample_noise=False, vol=0.2 * torch.rand(b, t, generator=g))
    ref, _ = model.infer(*inputs, **kw)
    z_ref, _, _ = model.infer_pre(*inputs, **kw)
    model.to(cuda)
    kw["vol"] = kw["vol"].to(cuda)
    fused_attention.launches = fused_resblock_trio.launches = 0
    got, _ = model.infer(*(x.to(cuda) for x in inputs), **kw)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_resblock_trio.launches) == (k1, k3)
    assert got.shape == (b, t * hps.data.hop_length, 1)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
    z, _, _ = model.infer_pre(*(x.to(cuda) for x in inputs), **kw)
    torch.testing.assert_close(z.cpu(), z_ref, rtol=0, atol=1e-4)


def test_full_width_batched_dispatch_matches_single(cuda, tmp_path):
    """Svc's batched synthesizer pass on the card, as slice_inference runs it:
    three chunks of bucket 256 in one dispatch padded to four rows (6 K1 and
    4 K3 launches) equal their batch-1 dispatches with the noise off. fp32
    on both sides, with the sums in another order: atol 1e-4, the CPU
    parity tests' AUDIO_ATOL."""
    from sovits_tpu_torch.infer.svc import Svc

    hps = scfg.default_config()
    scfg.save_config(hps, tmp_path / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(0))
    torch.save({"model": model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    svc = Svc(str(tmp_path / "G_0.pth"), str(tmp_path / "config.json"), device=cuda)
    g = _g(2)
    items = [dict(c=torch.randn(n, hps.model.ssl_dim, generator=g).numpy(),
                  f0=(150.0 + 100.0 * torch.rand(n, generator=g)).numpy(),
                  uv=(torch.rand(n, generator=g) > 0.2).float().numpy(), n_frames=n, spk=("id", 0))
             for n in (200, 256, 137)]
    fused_attention.launches = fused_resblock_trio.launches = 0
    batched = svc._run_synth_batch(items, 0.0, False, 52468, sample_noise=False)
    assert fused_attention.launches == 6 and fused_resblock_trio.launches == 4  # one dispatch
    for it, got in zip(items, batched):
        want = svc._run_synth_batch([it], 0.0, False, 52468, sample_noise=False)[0]
        assert got.shape == want.shape == (it["n_frames"] * hps.data.hop_length,)
        assert abs(got).max() > 1e-4
        torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want), rtol=0, atol=1e-4)


def _train_attention_case(bh, t, window, masked, seed, device, dtype=torch.float32, d=96):
    """The training shapes' inputs in ``dtype``, head width ``d``: dropout
    0.1 as the attention modules draw it (keep/(1-rate), with the values of
    ``dtype``), stored float32."""
    from sovits_tpu_torch.nn.dropout import keep_mask

    g = _g(seed)
    q = torch.randn(bh, t, d, generator=g) * d**-0.5
    k, v, dout = torch.randn(3, bh, t, d, generator=g)
    rel = [torch.randn(2 * window + 1, d, generator=g) * d**-0.5 for _ in range(2)] if window else [None, None]
    km = None
    if masked:
        km = torch.ones(bh, t)
        km[-2:, t - t // 4:] = 0.0  # shorter clips in the batch
    dm = keep_mask((bh, t, t), 0.1, g, "cpu", dtype)
    args = [x.to(device, dtype) if x is not None else None for x in (q, k.contiguous(), v.contiguous(), *rel)]
    return args + [x.to(device) if x is not None else None for x in (km, dm)], dout.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [96, 64, 33, 128])  # 33: rows off every 16-byte chunk; 128: the widest
@pytest.mark.parametrize("bh,t,window,masked", [
    (12, 800, 4, True),     # ContentEncoder, training batch of 6
    (12, 800, None, False),  # F0Decoder (causal)
    (3, 100, 4, True),      # off the tile grid
    (3, 100, None, True),   # causal with a key mask: no tile skipped
    (12, 512, 4, True),     # ContentEncoder at bench.py's bf16 step (512 frames)
    (3, 9, 4, True),        # lengths off every tile
    (3, 33, 4, True),
    (3, 65, None, False),
    (2, 1000, 4, True),
    (3, 16, None, False),   # a single tile
])
def test_attention_backward_kernel_matches_plain(cuda, bh, t, window, masked, d, dtype):
    """K2 against the plain backward on the same inputs: fp32 to TOL (the
    rel-table gradients sum over every row, atol 1e-4); bf16 within 2e-2 x
    max|plain| in all five outputs. Causal: row 0 has one key, so its dq
    cancels: to 1e-5 in fp32, exactly to 0 in bf16, as the plain version
    gives it."""
    args, dout = _train_attention_case(bh, t, window, masked, t + bh + d - 96, cuda, dtype, d)
    causal = window is None
    from sovits_tpu_torch.ops.attention import _forward

    out, lse = _forward(*args, window, causal, want_lse=True)
    before, before_bf16 = fused_attention_bwd.launches, fused_attention_bwd.launches_bf16
    got = fused_attention_bwd(*args, out, lse, dout, window=window, causal=causal)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == before + 1
    assert fused_attention_bwd.launches_bf16 == before_bf16 + (dtype == torch.bfloat16)
    want = fused_attention_bwd_plain(*args, dout, window=window, causal=causal)
    for a, b in zip(got, want):
        if b is None:
            assert a is None and window is None
        elif dtype == torch.bfloat16:
            _rel_close(a, b)
        else:
            torch.testing.assert_close(a, b, **(TOL if b.shape == args[0].shape else dict(rtol=1e-4, atol=1e-4)))
    if causal:
        row0 = (got[0][:, 0].float() - want[0][:, 0].float()).abs().max().item()
        if dtype == torch.float32:
            assert row0 <= 1e-5, row0
        else:
            assert row0 == 0 and not want[0][:, 0].any(), row0


@pytest.mark.parametrize("window", [4, None], ids=["windowed", "causal"])
def test_fused_attention_grads_match_autograd_of_plain(cuda, window):
    args, dout = _train_attention_case(12, 800, window, window is not None, 7, cuda)
    causal = window is None
    grads = []
    for fn in (fused_attention, fused_attention_plain):
        leaves = [x.clone().requires_grad_() if x is not None else None for x in args[:5]]
        out = fn(*leaves, *args[5:], window=window, causal=causal)
        (out * dout).sum().backward()
        grads.append([x.grad for x in leaves if x is not None])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_forward_kernel_with_dropout_and_lse(cuda):
    from sovits_tpu_torch.ops.attention import _forward, _scores

    args, _ = _train_attention_case(12, 800, 4, True, 3, cuda)
    out, lse = _forward(*args, 4, False, want_lse=True)
    torch.testing.assert_close(out, fused_attention_plain(*args, window=4), **TOL)
    q, k, _, rel_k, _, km, _ = args
    torch.testing.assert_close(lse, torch.logsumexp(_scores(q, k, rel_k, km, 4, False), -1), **TOL)


def test_trio_under_grad_launches_once_per_forward(cuda):
    x = torch.randn(1, 64, 16, device=cuda, requires_grad=True)
    kernels = [torch.randn(k, 16, 16, device=cuda) for k in (3, 7, 11) for _ in range(6)]
    biases = [torch.zeros(16, device=cuda) for _ in range(18)]
    before = fused_resblock_trio.launches
    out = fused_resblock_trio(x, kernels, biases)
    out.square().sum().backward()  # the backward recomputes the plain version: no launch
    torch.cuda.synchronize()
    assert fused_resblock_trio.launches == before + 1
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with torch.no_grad():
        fused_resblock_trio(x, kernels, biases)
    assert fused_resblock_trio.launches == before + 2


def test_full_width_training_step_cuda_matches_cpu(cuda):
    """One deterministic GAN step at the default widths (batch 1, 32 frames)."""
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    hps = scfg.default_config()
    g = _g(5)
    t, hop = 32, hps.data.hop_length
    batch = dict(
        c=torch.randn(1, t, hps.model.ssl_dim, generator=g), f0=150.0 + 100.0 * torch.rand(1, t, generator=g),
        uv=torch.ones(1, t), spec=torch.rand(1, t, hps.data.filter_length // 2 + 1, generator=g),
        spk=torch.zeros(1, dtype=torch.long), lengths=torch.tensor([t]),
        wav=torch.randn(1, t * hop, 1, generator=g) * 0.1,
    )
    results = []
    for device in ("cpu", cuda):
        net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False), _g(0)).to(device)
        net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"), _g(1)).to(device)
        opts = [make_optimizer(n.parameters(), hps) for n in (net_g, net_d)]
        fused_attention.launches = fused_attention_bwd.launches = 0
        m = train_step(net_g, net_d, *opts, {k: v.to(device) for k, v in batch.items()}, hps,
                       deterministic=True)
        results.append({k: float(v) for k, v in m.items()})
        if device != "cpu":
            assert fused_attention.launches == 12 and fused_attention_bwd.launches == 12
    for k, want in results[0].items():
        assert abs(results[1][k] - want) <= 1e-3 * abs(want) + 1e-5, (k, results[1][k], want)


def _rel_close(got, want, rel=2e-2):
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= rel * peak, (err, peak)


@pytest.mark.parametrize("case", ATTN_CASES, ids=_case_id)
def test_attention_bf16_kernel_matches_plain(cuda, case):
    _check_attention(case, torch.bfloat16, cuda, _rel_close)


@pytest.mark.parametrize("c,t", [(16, 96), (128, 861 * 64), (64, 861 * 128), (32, 861 * 256),
                                 (16, 861 * 512)])
def test_trio_bf16_kernel_matches_plain(cuda, c, t):
    g = _g(c + 3)
    x = torch.randn(1, t, c, generator=g).to(cuda, torch.bfloat16)
    kernels = [(torch.randn(k, c, c, generator=g) * (0.5 / (k * c) ** 0.5)).to(cuda, torch.bfloat16)
               for k in (3, 7, 11) for _ in range(6)]
    biases = [(torch.randn(c, generator=g) * 0.01).to(cuda, torch.bfloat16) for _ in range(18)]
    before = fused_resblock_trio.launches
    got = fused_resblock_trio(x, kernels, biases)
    torch.cuda.synchronize()
    assert fused_resblock_trio.launches == before + 1
    _rel_close(got, fused_resblock_trio_plain(x, kernels, biases))


# K3 at the edges of its tile plan: T shorter than a chain's halo (1, 5, 61),
# one past the largest tile ("tt+1": TT + 1 from trio_plan, read in the
# test), one past the smallest (129 = 8 x 16 + 1: the wrapper's balanced plan
# launches short clips with 16-row tiles), and a batch of 6 at C = 128
TRIO_EDGE_CASES = [(c, t, 1) for c in (16, 32, 64, 128) for t in (1, 5, 61, "tt+1", 129)] + [(128, 1000, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,t,b", TRIO_EDGE_CASES, ids=lambda v: str(v))
def test_trio_kernel_edge_cases(cuda, c, t, b, dtype):
    if t == "tt+1":
        t = trio_plan(c, dtype).tt + 1
    g = _g(c * 1000 + t + b)
    x = torch.randn(b, t, c, generator=g).to(cuda, dtype)
    kernels = [(torch.randn(k, c, c, generator=g) * (0.5 / (k * c) ** 0.5)).to(cuda, dtype)
               for k in (3, 7, 11) for _ in range(6)]
    biases = [(torch.randn(c, generator=g) * 0.01).to(cuda, dtype) for _ in range(18)]
    before = fused_resblock_trio.launches
    got = fused_resblock_trio(x, kernels, biases)
    torch.cuda.synchronize()
    assert fused_resblock_trio.launches == before + 1
    want = fused_resblock_trio_plain(x, kernels, biases)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        _rel_close(got, want)


@pytest.mark.parametrize("variant", ["bf16", "fp32"])
@pytest.mark.parametrize("t", [1024, 4 * 1024 + 300, 55104], ids=["rows1024", "rows4096", "rows54272"])
def test_trio_shift_kernel_matches_plain(cuda, variant, t):
    """One 1024-row block, a ragged input (4096 rows written) and the TPU
    tool's defaults. The fp32 variant's intermediates are fp32-accurate, so
    at most 1% of its bf16 outputs may differ from the plain version's bits
    (one-pass TF32 would differ almost everywhere)."""
    from sovits_tpu_torch.tools.profile_trio_shift import (
        MISMATCH_MAX, make_inputs, mismatch, trio_shift, trio_shift_plain)

    xp, mats = make_inputs(128, t, seed=1, device=cuda)
    before = trio_shift.launches
    got = trio_shift(xp, mats, variant)
    torch.cuda.synchronize()
    assert trio_shift.launches == before + 1 and got.shape == (1, t // 1024 * 1024, 128)
    want = trio_shift_plain(xp, mats, variant)
    _rel_close(got, want)
    if variant == "fp32":
        assert mismatch(got, want) <= MISMATCH_MAX


@pytest.mark.parametrize("c,t", [(128, 1280), (16, 10240)])
def test_trio_function_grads_match_autograd_of_plain(cuda, c, t):
    g = _g(c + 5)
    x = torch.randn(6, t, c, generator=g)
    kernels = [torch.randn(k, c, c, generator=g) * (0.5 / (k * c) ** 0.5) for k in (3, 7, 11) for _ in range(6)]
    biases = [torch.randn(c, generator=g) * 0.01 for _ in range(18)]
    dout = torch.randn(6, t, c, generator=g).to(cuda)
    grads = []
    for fn in (fused_resblock_trio, fused_resblock_trio_plain):
        leaves = [a.to(cuda).requires_grad_() for a in (x, *kernels, *biases)]
        (fn(leaves[0], leaves[1:19], leaves[19:]) * dout).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_kernels_reject_other_types(cuda):
    x = torch.randn(1, 64, 16, device=cuda, dtype=torch.float16)
    kernels = [torch.randn(k, 16, 16, device=cuda, dtype=torch.float16) for k in (3, 7, 11) for _ in range(6)]
    biases = [torch.zeros(16, device=cuda, dtype=torch.float16) for _ in range(18)]
    with pytest.raises(ValueError):
        fused_resblock_trio(x, kernels, biases)
    with pytest.raises(ValueError):  # bf16 input with fp32 kernels: never upcast quietly
        fused_resblock_trio(x.bfloat16(), [w.float() for w in kernels], [b.float() for b in biases])
    q = torch.randn(2, 32, 24, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        fused_attention(q, q, q, causal=True)
    from sovits_tpu_torch.ops.attention import _forward

    qb = q.bfloat16()
    out, lse = _forward(qb, qb, qb, None, None, None, None, None, True, want_lse=True)
    with pytest.raises(ValueError):  # the backward kernel takes fp32 or bf16 only
        fused_attention_bwd(q, q, q, None, None, None, None, q, lse, torch.ones_like(q), causal=True)
    with pytest.raises(ValueError):  # out and dout in q's type: never a quiet cast
        fused_attention_bwd(qb, qb, qb, None, None, None, None, out.float(), lse, torch.ones_like(out),
                            causal=True)


def test_full_width_bf16_synthesizer_launches_bf16_kernels(cuda):
    hps = scfg.default_config()
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(0))
    g = _g(1)
    b, t = 1, 96
    c = torch.randn(b, t, hps.model.ssl_dim, generator=g)
    f0 = 150.0 + 100.0 * torch.rand(b, t, generator=g)
    uv, spk = torch.ones(b, t), torch.zeros(b, dtype=torch.long)
    kw = dict(noise_scale=0.0, sample_noise=False)
    ref, _ = model.to(cuda).infer(*(a.to(cuda) for a in (c, f0, uv, spk)), **kw)
    bf = factory.build_synthesizer(hps, cuda, fused_tail=True, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    fused_attention.launches = fused_resblock_trio.launches = 0
    got, _ = bf.infer(*(a.to(cuda) for a in (c, f0, uv, spk)), **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert fused_attention.launches == 6 and fused_resblock_trio.launches == 4
    err = (got.float() - ref).abs().max().item()
    assert err <= 5e-2 * ref.abs().max().item(), err


# -------------------------------------------------------- shallow diffusion
def _diffusion_files(root, n_layers=4, n_chans=128):
    """A seeded 44.1 kHz vocoder ({"generator": sd}, DEFAULT_NSF_CONFIG) and a
    seeded Unit2Mel of ``n_layers`` x ``n_chans`` over its 128 mels, with
    their configs. Returns (diffusion model, its config, the vocoder)."""
    import json

    from sovits_tpu_torch.models.diffusion.vocoder import DEFAULT_NSF_CONFIG, build_generator
    from sovits_tpu_torch.train.diffusion import DIFFUSION_DEFAULTS, build_unit2mel, load_diffusion_config

    vocoder = root / "model"
    net = factory.init_random_(build_generator(DEFAULT_NSF_CONFIG, "cpu"), _g(5))
    torch.save({"generator": net.state_dict()}, vocoder)
    (root / "config.json").write_text(json.dumps(DEFAULT_NSF_CONFIG))
    cfg = json.loads(json.dumps(DIFFUSION_DEFAULTS))
    cfg["model"].update(n_layers=n_layers, n_chans=n_chans)
    cfg["vocoder"]["ckpt"] = str(vocoder)
    (root / "config.yaml").write_text(json.dumps(cfg))
    model = factory.init_random_(build_unit2mel(load_diffusion_config(root / "config.yaml"), 128, "cpu"),
                                 _g(6))
    torch.save({"model": model.state_dict()}, root / "model_0.pt")
    return root / "model_0.pt", root / "config.yaml", vocoder


def test_diffusion_vocoder_fused_matches_unfused(cuda):
    """The full-width 44.1 kHz mel vocoder with the fused tail (4 K3
    launches) against the same weights through stock convs."""
    from sovits_tpu_torch.models.diffusion.vocoder import DEFAULT_NSF_CONFIG, build_generator

    fused = factory.init_random_(build_generator(DEFAULT_NSF_CONFIG, "cpu"), _g(7)).to(cuda)
    plain = build_generator(DEFAULT_NSF_CONFIG, cuda)
    plain.load_state_dict(fused.state_dict())
    plain.fused = False  # every stage through stock convs
    assert fused.cond is None and fused.fused
    g = _g(8)
    mel = (-9.0 * torch.rand(1, 128, 200, generator=g)).to(cuda)
    f0 = (150.0 + 100.0 * torch.rand(1, 200, generator=g)).to(cuda)
    fused_resblock_trio.launches = 0
    with torch.no_grad():
        got, want = fused(mel, f0), plain(mel, f0)
    torch.cuda.synchronize()
    assert fused_resblock_trio.launches == 4
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("second_encoding", [False, True], ids=["units", "second-encoding"])
def test_refiner_cuda_matches_cpu(cuda, tmp_path, second_encoding):
    """DiffusionRefiner.refine on the card against the same files on the CPU
    (a 4-layer, 128-channel Unit2Mel, the full vocoder): the q-sample noise
    comes from the same CPU generator, so the two compute the same thing."""
    import types

    import numpy as np

    from sovits_tpu_torch.infer.diffusion_wrapper import DiffusionRefiner

    model, cfg, _ = _diffusion_files(tmp_path)
    wave = bench_signal(1.5, 44100)
    n = len(wave) // 512
    rng = np.random.default_rng(9)
    units = rng.standard_normal((n, 768)).astype(np.float32)
    f0 = (170.0 + 30.0 * np.sin(np.arange(n) / 9.0)).astype(np.float32)

    class Encoder:  # a fixed random projection of the 16 kHz audio's frames
        def encode(self, wav16k):
            frames = (len(wav16k) - 400) // 320 + 1
            idx = np.arange(frames)[:, None] * 320 + np.arange(400)[None]
            return (wav16k[idx] @ np.random.default_rng(10).standard_normal((400, 768))).astype(np.float32)

    svc = types.SimpleNamespace(target_sample=44100, hop_size=512, encoder=Encoder(),
                                unit_interpolate_mode="left")
    outs = []
    for device in (cuda, "cpu"):
        refiner = DiffusionRefiner(str(model), str(cfg), device=device)
        fused_resblock_trio.launches = 0
        outs.append(refiner.refine(svc, wave[: n * 512], units, f0, None, np.asarray([0]), 100,
                                   second_encoding))
        if device == cuda:
            assert fused_resblock_trio.launches == 4
    got, want = outs
    assert got.shape == want.shape == (n * 512,)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= 1e-3 * np.abs(want).max(), err


@pytest.mark.parametrize("adaptive_key", [0, 2])
def test_enhancer_cuda_matches_cpu(cuda, tmp_path, adaptive_key):
    import numpy as np

    from sovits_tpu_torch.infer.enhancer import Enhancer

    _, _, vocoder = _diffusion_files(tmp_path, n_layers=1, n_chans=8)
    wave = bench_signal(1.0, 44100, seed=1)
    f0 = (170.0 + 30.0 * np.sin(np.arange(len(wave) // 512) / 9.0)).astype(np.float32)
    outs = [Enhancer("nsf-hifigan", str(vocoder), device=d).enhance(wave, 44100, f0, 512,
                                                                    adaptive_key=adaptive_key)
            for d in (cuda, "cpu")]
    (got, sr_got), (want, sr_want) = outs
    assert sr_got == sr_want == 44100 and got.shape == want.shape
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= 1e-4 * np.abs(want).max(), err


# the f0 nets at small widths (their published topologies, narrower)
F0_SMALL = {"rmvpe": ("RmvpeNet", dict(n_blocks=1, en_out_channels=4, gru_hidden=16)),
            "fcpe": ("FcpeNet", dict(n_layers=2)), "crepe": ("CrepeNet", {})}


def _small_f0_nets(monkeypatch):
    """Each f0 predictor builds its net at the small width of F0_SMALL
    (CREPE "tiny")."""
    import functools

    from sovits_tpu_torch.f0 import crepe, fcpe, rmvpe

    for module, (cls, kw) in zip((rmvpe, fcpe, crepe), F0_SMALL.values()):
        if module is crepe:
            monkeypatch.setattr(crepe, "CrepeNet", lambda capacity="full", net=crepe.CrepeNet: net("tiny"))
        else:
            monkeypatch.setattr(module, cls, functools.partial(getattr(module, cls), **kw))


@pytest.mark.parametrize("kind", list(F0_SMALL))
def test_f0_net_cuda_matches_cpu(cuda, monkeypatch, kind):
    """The predictor's salience of a 1.5 s 44.1 kHz clip on the card against
    its CPU copy (same seeded weights), and its f0 track on the card."""
    import numpy as np

    from sovits_tpu_torch.dsp.audio import resample
    from sovits_tpu_torch.f0.base import get_f0_predictor

    _small_f0_nets(monkeypatch)
    from sovits_tpu_torch.f0 import crepe, fcpe, rmvpe

    net = {"rmvpe": rmvpe.RmvpeNet, "fcpe": fcpe.FcpeNet, "crepe": crepe.CrepeNet}[kind]()
    sd = factory.init_random_(net, _g(12)).state_dict()
    card, host = (get_f0_predictor(kind, 512, 44100, weights=sd, device=d) for d in (cuda, "cpu"))
    assert next(card.net.parameters()).device.type == "cuda"
    wav = bench_signal(1.5, 44100, seed=2)
    if kind == "crepe":
        got, want = (p.salience(wav, len(wav) // 512) for p in (card, host))
    else:
        got, want = (p.salience(resample(wav, 44100, 16000)) for p in (card, host))
    assert got.shape == want.shape and got.shape[1] == 360
    assert np.abs(got - want).max() <= 1e-4
    f0, uv = card.compute_f0_uv(wav)
    assert f0.shape == uv.shape == (len(wav) // 512,) and np.isfinite(f0).all()


# the encoders at tiny widths, each keeping what sets it apart
ENCODER_SMALL = {
    "vec256l9": dict(output_layer=1, final_proj_dim=16),
    "hubertsoft": dict(final_proj_dim=16),
    "cnhubertlarge": dict(d_model=96, n_heads=6, ffn_dim=192),
}
TINY_CONVS = ((32, 10, 5),) + ((32, 3, 2),) * 4 + ((32, 2, 2),) * 2


def _tiny_encoder_config(name):
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config

    fields = dict(d_model=64, n_layers=2, n_heads=4, ffn_dim=128, pos_conv_kernel=16, pos_conv_groups=4,
                  conv_layers=TINY_CONVS)
    return Wav2Vec2Config(**{**fields, **ENCODER_SMALL.get(name, {})})


@pytest.mark.parametrize("name", list(ENCODER_SMALL))
def test_encoder_cuda_matches_cpu(cuda, tmp_path, monkeypatch, name):
    """A tiny seeded checkpoint in the encoder's layout (bshall's for
    hubertsoft) through get_speech_encoder on the card and on the CPU."""
    import numpy as np

    from chip_smoke import write_encoder_checkpoint
    from sovits_tpu_torch.encoders import factory as enc_factory

    cfg = _tiny_encoder_config(name)
    monkeypatch.setitem(enc_factory.CONFIGS, name, cfg)
    write_encoder_checkpoint(name, tmp_path / "enc.pt", cfg=cfg)
    card, host = (enc_factory.get_speech_encoder(name, tmp_path / "enc.pt", device=d)
                  for d in (cuda, "cpu"))
    wav = bench_signal(1.2, 16000, seed=3)
    got, want = card.encode(wav), host.encode(wav)
    assert got.shape == want.shape == ((len(wav) + 2 * card.pad - 400) // 320 + 1, card.hidden_dim)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_cli_rmvpe_with_a_preset_predictor_on_card(cuda, tmp_path, monkeypatch):
    """``cli.infer -f0p rmvpe`` on the card, its Svc given an RMVPE predictor
    (small seeded net) as f0_predictor_object: the song is written, and the
    predictor that ran is the card's."""
    import numpy as np
    from scipy.io import wavfile

    from chip_smoke import song, write_encoder_checkpoint
    from sovits_tpu_torch.cli import infer as cli
    from sovits_tpu_torch.encoders import factory as enc_factory
    from sovits_tpu_torch.f0 import rmvpe
    from sovits_tpu_torch.infer.svc import Svc

    _small_f0_nets(monkeypatch)
    cfg = _tiny_encoder_config("vec768l12")
    monkeypatch.setitem(enc_factory.CONFIGS, "vec768l12", cfg)
    write_encoder_checkpoint("vec768l12", tmp_path / "pretrain" / "checkpoint_best_legacy_500.pt", cfg=cfg)
    hps = scfg.default_config(**{"model.ssl_dim": cfg.d_model})
    scfg.save_config(hps, tmp_path / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(13))
    torch.save({"model": model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    wav = song(44100, (2.5, 2.5), seed=14)
    wavfile.write(tmp_path / "song.wav", 44100, (wav * 32767).astype(np.int16))
    sd = factory.init_random_(rmvpe.RmvpeNet(), _g(15)).state_dict()
    predictor = rmvpe.RmvpeF0Predictor(hop_length=512, sampling_rate=44100, weights=sd, device=cuda)
    used = []

    class PresetSvc(Svc):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.f0_predictor_object = predictor
            used.append(self)

    monkeypatch.setattr(cli, "Svc", PresetSvc)
    monkeypatch.chdir(tmp_path)
    cli.main(["-m", "G_0.pth", "-c", "config.json", "-n", "song.wav", "-f0p", "rmvpe"])
    (svc,) = used
    assert svc.f0_predictor_object is predictor and svc.device.type == "cuda"
    sr, audio = wavfile.read(tmp_path / "results" / "song_0key_0_sovits_rmvpe.wav")
    assert sr == 44100 and abs(len(audio) - len(wav)) <= 2 * 512 and np.abs(audio).max() > 0


def _ppg_small():
    """whisper-ppg, wavlmbase+ and dphubert at tiny widths."""
    from chip_smoke import DPHUBERT_CFG
    from sovits_tpu_torch.encoders.wavlm import WavLMDims
    from sovits_tpu_torch.encoders.whisper import WhisperDims

    dph = dict(DPHUBERT_CFG, encoder_embed_dim=48, encoder_num_layers=3, encoder_head_dim=12,
               encoder_use_attention=[True, False, True], encoder_use_feed_forward=[True, True, False],
               encoder_num_heads=[4, 0, 2], encoder_ff_interm_features=[96, 64, 0],
               encoder_pos_conv_kernel=16, encoder_pos_conv_groups=4,
               extractor_conv_layer_config=[(64, 10, 5), (64, 3, 2), (64, 2, 2)])
    return {"whisper-ppg": WhisperDims(n_audio_state=64, n_audio_head=4, n_audio_layer=2),
            "wavlmbase+": WavLMDims(d_model=64, n_layers=2, n_heads=4, ffn_dim=128, num_buckets=32,
                                    max_distance=64),
            "dphubert": dph}


@pytest.mark.parametrize("name", ["whisper-ppg", "wavlmbase+", "dphubert"])
def test_ppg_encoder_cuda_matches_cpu(cuda, tmp_path, name):
    """A tiny seeded checkpoint in the encoder's published layout through
    get_speech_encoder on the card and on the CPU."""
    import numpy as np

    from chip_smoke import write_ppg_checkpoint
    from sovits_tpu_torch.encoders.factory import get_speech_encoder

    write_ppg_checkpoint(name, tmp_path / "enc.pt", dims=_ppg_small()[name])
    card, host = (get_speech_encoder(name, tmp_path / "enc.pt", device=d) for d in (cuda, "cpu"))
    wav = bench_signal(1.2, 16000, seed=3)
    got, want = card.encode(wav), host.encode(wav)
    frames = len(wav) // 320 if name == "whisper-ppg" else (len(wav) - 400) // 320 + 1
    assert got.shape == want.shape == (frames, card.hidden_dim)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_cluster_cuda_matches_cpu(cuda):
    """kmeans_fit on the card (inertia never rises past summation order;
    every point at its nearest final center), and the nearest centers and
    the retrieval blend of card against CPU on rows without near-ties."""
    from sovits_tpu_torch.cluster import kmeans, store

    g = _g(5)
    x = torch.randn(4000, 64, generator=g)
    init = kmeans.kmeans_plus_plus_init(x.to(cuda), 100, torch.Generator(device=cuda).manual_seed(0))
    centers, inertia = kmeans.lloyd(x.to(cuda), init, 10)
    inertia = inertia.cpu()
    assert (inertia[1:] - inertia[:-1] <= 1e-6 * inertia[:-1]).all()
    d64 = kmeans._sq_dists(x.double(), centers.cpu().double())
    excess = d64.gather(1, kmeans.kmeans_predict(x.to(cuda), centers).cpu()[:, None])[:, 0] - d64.amin(1)
    assert (excess <= 1e-5 * d64.abs().amax(1)).all()
    units, bank = torch.randn(300, 64, generator=g), torch.randn(2000, 64, generator=g)
    for table, rank in ((centers.cpu(), 1), (bank, 8)):
        top = torch.topk(kmeans._sq_dists(units.double(), table.double()), rank + 1, dim=1, largest=False).values
        decided = top[:, rank] - top[:, rank - 1] > 1e-5 * top[:, rank].abs()
        assert decided.float().mean() > 0.9
        if rank == 1:
            got, want = (kmeans.nearest_centers(u, t) for u, t in ((units.to(cuda), table.to(cuda)), (units, table)))
        else:
            got, want = (store.blend_retrieval(u, t) for u, t in ((units.to(cuda), table.to(cuda)), (units, table)))
        torch.testing.assert_close(got.cpu()[decided], want[decided], rtol=0, atol=1e-4)


def test_fcpe_model_range_on_card(cuda, monkeypatch):
    """f0_min_model / f0_max_model reach the card's FCPE: its table and its
    decoded f0 lie in the range."""
    import numpy as np

    from sovits_tpu_torch.f0 import fcpe
    from sovits_tpu_torch.f0.base import get_f0_predictor

    _small_f0_nets(monkeypatch)
    sd = factory.init_random_(fcpe.FcpeNet(), _g(12)).state_dict()
    pred = get_f0_predictor("fcpe", 512, 44100, weights=sd, device=cuda, f0_min_model=50.0,
                            f0_max_model=1000.0, f0_min=30.0, f0_max=2100.0)
    np.testing.assert_array_equal(pred.table, fcpe.cent_table(50.0, 1000.0, 360))
    np.testing.assert_array_equal(pred.net.cent_table.cpu().numpy(), pred.table)
    f0, _ = pred.compute_f0_uv(bench_signal(1.5, 44100, seed=2))
    assert np.isfinite(f0).all() and f0.max() <= 1000.0 and f0[f0 > 0].min() >= 50.0


def _diffusion_run(root, n_layers=2, n_chans=64):
    """A small diffusion config over 4 clips' seeded artifacts (8 kHz, hop
    64, 16-frame crops, 16 mels, 32-wide units)."""
    import json

    import numpy as np

    from sovits_tpu_torch.train import diffusion as tdiff

    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = root / f"spk{i % 2}" / f"c{i}.wav"
        p.parent.mkdir(parents=True, exist_ok=True)
        n = 24 + 4 * i
        np.save(str(p) + ".f0.npy", np.array([rng.uniform(120, 320, n).astype(np.float32),
                                              np.ones(n, np.float32)], dtype=object), allow_pickle=True)
        np.save(str(p) + ".vol.npy", np.abs(rng.standard_normal(n)).astype(np.float32) * 0.1)
        np.save(str(p) + ".mel.npy", (rng.standard_normal((n, 16)) * 2 - 6).astype(np.float32))
        np.save(str(p) + ".soft.npy", rng.standard_normal((32, n)).astype(np.float32))
        paths.append(str(p))
    (root / "train.txt").write_text("\n".join(paths) + "\n")
    cfg = {"data": {"sampling_rate": 8000, "block_size": 64, "duration": 0.128, "encoder_out_channels": 32,
                    "training_files": str(root / "train.txt"), "validation_files": str(root / "train.txt")},
           "model": {"n_layers": n_layers, "n_chans": n_chans, "n_hidden": 24, "timesteps": 50,
                     "k_step_max": 0, "n_spk": 2, "use_pitch_aug": True},
           "train": {"batch_size": 4, "interval_log": 1, "interval_val": 100, "lr": 1e-3},
           "infer": {"speedup": 5, "method": "dpm-solver++"}, "spk": {"spk0": 0, "spk1": 1}}
    (root / "diffusion.yaml").write_text(json.dumps(cfg))
    return tdiff.load_diffusion_config(root / "diffusion.yaml")


def test_diffusion_train_step_cuda_matches_cpu(cuda, tmp_path):
    """One Unit2Mel training step's loss and gradients, card against CPU:
    the same batch, steps and noise (one CPU generator seed), and the same
    ReLU branches (``chip_smoke._relu_branches``: the CPU takes the card's;
    each element it moves lies within 1e-4 of its input's peak of 0)."""
    import numpy as np

    from chip_smoke import _relu_branches
    from sovits_tpu_torch.train import diffusion as tdiff

    args = _diffusion_run(tmp_path)
    ds = tdiff.DiffusionDataset(args.data.training_files, args)
    rng = np.random.default_rng(3)
    examples = [ds.example(i, rng) for i in range(4)]
    sd = factory.init_random_(tdiff.build_unit2mel(args, 16, "cpu"), _g(7)).state_dict()
    out, record = {}, None
    for dev in (cuda, torch.device("cpu")):
        model = tdiff.build_unit2mel(args, 16, dev).train()
        model.load_state_dict(sd)
        record, handles = _relu_branches(model, record)
        loss = tdiff._loss(model, tdiff._batch(examples, dev), torch.Generator().manual_seed(9))
        loss.backward()
        for h in handles:
            h.remove()
        out[dev.type] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    assert all(v <= 1e-4 for _, v in record.values()), record
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, g in out["cuda"][1].items():
        want = out["cpu"][1][k]
        assert (g - want).abs().max() <= 1e-4 * want.abs().max(), k


def test_train_diffusion_on_card_resumes(cuda, tmp_path):
    """train_diffusion on the card for 3 steps, then a resume to 5: finite
    losses, the model on the card, so-vits-svc's checkpoint."""
    import json

    from sovits_tpu_torch.train import diffusion as tdiff

    args = _diffusion_run(tmp_path)
    model = tdiff.train_diffusion(args, expdir=tmp_path / "exp", max_steps=3, vocoder_dim=16, device=cuda)
    assert next(model.parameters()).device.type == "cuda"
    tdiff.train_diffusion(args, expdir=tmp_path / "exp", max_steps=5, vocoder_dim=16, device=cuda)
    records = [json.loads(line) for line in (tmp_path / "exp" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "loss/diffusion" in r] == [1, 2, 3, 4, 5]
    assert all(torch.isfinite(torch.tensor(v)) for r in records for v in r.values())
    ckpt = torch.load(tmp_path / "exp" / "model_5.pt", weights_only=False)
    assert ckpt["global_step"] == 5 and ckpt["optimizer"]["state"][0]["step"] == 5


def test_sovits_ops_launch_kernels_and_match_plain(cuda):
    """The operators that torch.export keeps launch the kernels, counted,
    and agree with the plain versions."""
    q, k, v = (torch.randn(2, 100, 96, generator=_g(i)).cuda() for i in range(3))
    rel_k, rel_v = (0.1 * torch.randn(9, 96, generator=_g(i)).cuda() for i in (3, 4))
    km = torch.ones(2, 100, device=cuda)
    km[1, 70:] = 0
    before = fused_attention.launches
    out, lse = torch.ops.sovits.rel_attention_fwd(q, k, v, rel_k, rel_v, km, None, 4, False, True)
    assert fused_attention.launches == before + 1 and lse.shape == (2, 100)
    torch.testing.assert_close(out, fused_attention_plain(q, k, v, rel_k, rel_v, km, None, window=4), **TOL)
    x = torch.randn(2, 300, 32, generator=_g(5)).cuda()
    kernels = [0.05 * torch.randn(kk, 32, 32, generator=_g(6 + i)).cuda()
               for i, kk in enumerate(k_ for k_ in (3, 7, 11) for _ in range(6))]
    biases = [0.1 * torch.randn(32, generator=_g(30 + i)).cuda() for i in range(18)]
    before = fused_resblock_trio.launches
    got = torch.ops.sovits.resblock_trio(x, kernels, biases, [3, 7, 11], [1, 3, 5] * 3, [3, 3, 3])
    assert fused_resblock_trio.launches == before + 1
    torch.testing.assert_close(got, fused_resblock_trio_plain(x, kernels, biases), **TOL)


def test_exported_synthesizer_launches_kernels_on_card(cuda, tmp_path):
    """The full-width synthesizer exported on the card: its graph holds the
    sovits ops, and the loaded .pt2 launches K1 and K3 and matches the live
    Synthesizer.infer."""
    from sovits_tpu_torch.cli.export import example_inputs, export_program, load_exported

    hps = scfg.default_config()
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(0)).to(cuda)
    program = export_program(model, hps, 64)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"sovits.rel_attention_fwd.default", "sovits.resblock_trio.default"} <= targets
    torch.export.save(program, tmp_path / "model.pt2")
    call = load_exported(str(tmp_path / "model.pt2"))
    c, f0, uv, spk = example_inputs(hps, 64, cuda)
    c = c + 0.3 * torch.randn(c.shape, generator=_g(1)).cuda()
    f0 = f0 + 100.0 + 200.0 * torch.rand(f0.shape, generator=_g(2)).cuda()
    uv = uv + 1.0
    k1, k3 = fused_attention.launches, fused_resblock_trio.launches
    with torch.no_grad():
        got = call(c, f0, uv, spk)
    torch.cuda.synchronize()
    assert fused_attention.launches - k1 == hps.model.n_layers
    assert fused_resblock_trio.launches - k3 == 4
    want = model.infer(c, f0, uv, spk, sample_noise=False)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_onnx_runtime_on_card_matches_cpu(cuda):
    """The ONNX runtime's ops on the card against the CPU on a small synthesizer graph."""
    import numpy as np

    from chip_smoke import LEARNING_TINY
    from sovits_tpu_torch.export.onnx_run import run_model
    from sovits_tpu_torch.export.onnx_synth import build_synthesizer_onnx

    hps = scfg.default_config(**LEARNING_TINY)
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(0))
    mb = build_synthesizer_onnx(model, hps, chara_mix=False)
    t = 40
    rng = np.random.default_rng(0)
    feeds = {"c": rng.standard_normal((1, t, hps.model.ssl_dim)).astype(np.float32),
             "f0": rng.uniform(100, 300, (1, t)).astype(np.float32),
             "mel2ph": np.arange(1, t + 1, dtype=np.int64)[None], "uv": np.ones((1, t), np.float32),
             "noise": np.zeros((1, hps.model.inter_channels, t), np.float32),
             "sid": np.asarray([1], np.int64)}
    got, want = run_model(mb, feeds, cuda)["audio"], run_model(mb, feeds, "cpu")["audio"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


SEAM_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_sequence_parallel.py's bar


@pytest.mark.parametrize("noise", [False, True], ids=["noise-off", "noise-on"])
def test_shard_local_decode_seams_launch_k3(cuda, noise):
    """parallel.sequence.decode_local for each of 4 shards in turn, on its
    haloed slice of the whole latent with the phase prefix from the
    per-shard sums, against the monolithic decode on the card: within the
    JAX test's bar away from the song's edges and across every seam (noise
    off, then counter-based noise with one seed); K3 runs in every shard."""
    import numpy as np

    from sovits_tpu_torch.models.nsf_hifigan import Generator
    from sovits_tpu_torch.parallel.sequence import decode_local, phase_sum, required_halo_frames

    # tests/test_torch_parallel.py's generator: stage widths 128 and 64 (K3)
    dec = factory.init_random_(Generator(8000, 24, upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                                         upsample_initial_channel=256, gin_channels=16, fused_tail=True),
                                 _g(0))
    dec = dec.to(cuda).eval()
    n, t, g = 4, 4 * 24, _g(3)
    x = (torch.randn(1, 24, t, generator=g) * 0.3).to(cuda)
    f0 = (80.0 + 220.0 * torch.rand(1, t, generator=g)).to(cuda)
    if noise:
        f0[:, 30:45] = 0.0  # an unvoiced span, excited by the noise alone
    g = (torch.randn(1, 16, 1, generator=g) * 0.2).to(cuda)
    tl, halo, upp = t // n, required_halo_frames(dec), dec.upp
    noise_gen = (lambda: torch.Generator(cuda).manual_seed(7)) if noise else (lambda: None)
    xp, fp = torch.nn.functional.pad(x, (halo, halo)), torch.nn.functional.pad(f0, (halo, halo))
    sums = [phase_sum(f0[:, r * tl : (r + 1) * tl], dec.sampling_rate, upp) for r in range(n)]
    with torch.no_grad():
        mono = dec(x, f0, g, generator=noise_gen(), noise_frames=(0, t) if noise else None)
        parts = []
        for r in range(n):
            before = fused_resblock_trio.launches
            phase0 = sum(sums[:r]) if r else torch.zeros_like(sums[0])
            parts.append(decode_local(dec, xp[..., r * tl : (r + 1) * tl + 2 * halo],
                                      fp[:, r * tl : (r + 1) * tl + 2 * halo], g, phase0, halo, r * tl, t,
                                      noise_gen()))
            assert fused_resblock_trio.launches - before == 2  # stages of width 128 and 64
    got, want = torch.cat(parts, -1)[0, 0].cpu().numpy(), mono[0, 0].cpu().numpy()
    edge = halo * upp
    np.testing.assert_allclose(got[edge:-edge], want[edge:-edge], **SEAM_TOL)
    for s in range(1, n):
        win = slice(s * tl * upp - 64, s * tl * upp + 64)
        np.testing.assert_allclose(got[win], want[win], err_msg=f"seam {s}", **SEAM_TOL)
    if noise:
        assert np.abs(got[35 * upp : 40 * upp]).max() > 1e-4


def test_infer_seq_parallel_world1_nccl(cuda, tmp_path, monkeypatch):
    """Svc.infer_seq_parallel at full width over an NCCL group of one rank
    (a file:// store): one prior/flow pass (6 K1 launches) and one decode
    (4 K3 launches), equal to Svc's batched synthesizer pass on the same
    prepared item away from the song's edges, noise off."""
    import numpy as np
    import torch.distributed as dist

    from sovits_tpu_torch.infer.svc import Svc
    from sovits_tpu_torch.parallel import make_mesh
    from sovits_tpu_torch.parallel.sequence import required_halo_frames

    hps = scfg.default_config()
    scfg.save_config(hps, tmp_path / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True), _g(0))
    torch.save({"model": model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    svc = Svc(str(tmp_path / "G_0.pth"), str(tmp_path / "config.json"), device=cuda)
    g, n = _g(5), 700
    item = dict(c=torch.randn(n, hps.model.ssl_dim, generator=g).numpy(),
                f0=(150.0 + 100.0 * torch.rand(n, generator=g)).numpy(),
                uv=(torch.rand(n, generator=g) > 0.2).float().numpy(), vol=None, n_frames=n,
                spk=("id", 0))
    monkeypatch.setattr(svc, "_prepare_chunk", lambda *a, **k: item)
    make_mesh(1, 1, "cuda", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        assert dist.get_backend() == "nccl"
        fused_attention.launches = fused_resblock_trio.launches = 0
        got, n_samples, frames = svc.infer_seq_parallel(0, 0, np.zeros(16), n_shards=4,
                                                        sample_noise=False, noice_scale=0.0)
        assert (fused_attention.launches, fused_resblock_trio.launches) == (6, 4)
    finally:
        dist.destroy_process_group()
    want = svc._run_synth_batch([item], 0.0, False, 52468, sample_noise=False)[0]
    assert n_samples == frames * hps.data.hop_length == len(want)
    edge = required_halo_frames(svc.model.dec) * hps.data.hop_length
    np.testing.assert_allclose(got[edge:-edge], want[edge:-edge], **SEAM_TOL)
