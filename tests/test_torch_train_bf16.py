"""The port's bf16 GAN training step vs the JAX package's, in bf16 (CPU).

bench.py measures the JAX package's training step in bf16
(``build_synthesizer(hps, dtype=bf16)``, ``build_discriminator(hps,
dtype=bf16)``: float32 parameters, bf16 compute). The same inputs, made with
numpy, and the same weights go through both packages in bf16:

- the attention backward's plain version against ``jax.vjp`` of the Pallas
  kernel in bf16 (interpret mode, its ``_bwd_kernel``): windowed with a key
  mask and dropout, causal, causal with a key mask; all five outputs, and
  dq on causal row 0;
- the bf16 discriminator: logits and every feature map;
- ``mel_spectrogram`` of a bf16 waveform (float32 inside);
- one deterministic GAN step (noise off, no dropout): every loss and the
  whole generator and discriminator gradients.

Tolerances: 2e-2 x max|ref| for a kernel or a module (a few bf16 ulps: the
two packages round at different points and sum in other orders); 2e-2
relative for a loss and 5e-2 relative in norm for a whole gradient, where a
network of bf16 layers sits between input and output (measured on this
step: losses within 1.2e-3, the generator's gradient 2.6e-2 and the
discriminator's 1.2e-2). AdamW's first update (lr * sign(g)) is not compared
per entry: it flips on rounding-level gradients.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.dsp import stft as jstft  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu.ops.attention import fused_attention as jax_fused_attention  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.dsp import stft  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.nn.conv import set_compute_dtype  # noqa: E402
from sovits_tpu_torch.nn.dropout import keep_mask  # noqa: E402
from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_bwd_plain  # noqa: E402
from sovits_tpu_torch.train.optim import make_optimizer  # noqa: E402
from sovits_tpu_torch.train.step import train_step  # noqa: E402
from tests.test_torch_ops import _bwd_inputs  # noqa: E402
from tests.test_torch_train import _batch, _hps, _jax_step, _port_d, _port_g, _tree_np  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

BF = torch.bfloat16
KERNEL_REL = 2e-2  # a few bf16 ulps
LOSS_REL = 2e-2
GRAD_REL = 5e-2


def _tbf(x):
    return None if x is None else torch.from_numpy(np.asarray(x, np.float32)).to(BF)


def _jbf(x):
    return None if x is None else jnp.asarray(x, jnp.bfloat16)


def _rel(got: torch.Tensor, ref) -> float:
    """max|got - ref| / max|ref|, both in float32."""
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ------------------------------------------------- the attention backward
BWD_BF16_CASES = [(4, False, True, True), (None, True, False, False), (None, True, True, False)]


@pytest.mark.parametrize("window,causal,masked,dropout", BWD_BF16_CASES,
                         ids=["window4-keymask-dropout", "causal", "causal-keymask"])
def test_attention_backward_bf16_plain_matches_jax(window, causal, masked, dropout):
    q, k, v, rk, rv, km, _, dout = _bwd_inputs(window, masked, False, seed=13)
    # the bf16 keep mask, as the attention modules draw it (values 0 and 1.109375)
    dm = keep_mask((q.shape[0], q.shape[1], q.shape[1]), 0.1, torch.Generator().manual_seed(4),
                   "cpu", BF) if dropout else None

    def fwd(*xs):
        q_, k_, v_, rk_, rv_ = (*xs, None, None)[:5]
        return jax_fused_attention(q_, k_, v_, rk_, rv_,
                                   key_mask=None if km is None else jnp.asarray(km),
                                   drop_mask=None if dm is None else jnp.asarray(dm.numpy()),
                                   window=window, causal=causal, interpret=True)

    primals = [_jbf(x) for x in ((q, k, v, rk, rv) if window else (q, k, v))]
    out, vjp = jax.vjp(fwd, *primals)
    assert out.dtype == jnp.bfloat16
    ref = vjp(_jbf(dout))
    got = fused_attention_bwd_plain(_tbf(q), _tbf(k), _tbf(v), _tbf(rk), _tbf(rv),
                                    None if km is None else torch.from_numpy(km), dm, _tbf(dout),
                                    window=window, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv", "drel_k", "drel_v"), got, ref):
        assert a.dtype == BF, name
        assert _rel(a, b) <= KERNEL_REL, (name, _rel(a, b))
    if causal:  # row 0 has one key: ds = p (g - D) cancels, so its dq is 0 up to rounding
        row0 = np.abs(got[0][:, 0].float().numpy() - np.asarray(ref[0][:, 0], np.float32)).max()
        assert row0 <= KERNEL_REL * np.abs(np.asarray(ref[0], np.float32)).max(), row0
    # autograd through FusedAttention: on the CPU its backward is the plain version
    leaves = [_tbf(x).requires_grad_() if x is not None else None for x in (q, k, v, rk, rv)]
    out_t = fused_attention(*leaves, None if km is None else torch.from_numpy(km), dm,
                            window=window, causal=causal)
    assert out_t.dtype == BF
    (out_t.float() * torch.from_numpy(dout)).sum().backward()
    for leaf, a in zip(leaves, got):
        if leaf is not None:
            assert leaf.grad.dtype == BF
            torch.testing.assert_close(leaf.grad, a, rtol=0, atol=0)


# ----------------------------------------------------------- the modules
@pytest.fixture(scope="module")
def jax_d_bf16():
    """The JAX discriminator (disc_tiny) in bf16, with its own float32 init."""
    hps = _hps()
    jd = jfactory.build_discriminator(hps, dtype=jnp.bfloat16)
    params = _tree_np(jfactory.init_discriminator_params(
        jd, jax.random.PRNGKey(1), seg_samples=hps.train.segment_size))
    return jd, params


def test_discriminator_bf16_matches_jax(jax_d_bf16):
    hps = _hps()
    jd, params = jax_d_bf16
    net = factory.build_discriminator(hps, "cpu", dtype=BF)
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in from_jax.multi_period_discriminator(params).items()}, strict=True)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    rng = np.random.default_rng(15)
    y = (rng.standard_normal((2, 256, 1)) * 0.3).astype(np.float32)
    y_hat = _tbf(rng.standard_normal((2, 256, 1)) * 0.3)  # the generator's bf16 output
    ref = jax.jit(lambda p, a, b: jd.apply({"params": p}, a, b))(
        params, jnp.asarray(y), jnp.asarray(y_hat.float().numpy(), jnp.bfloat16))
    got = net(torch.from_numpy(y), y_hat)
    n = 0
    for logits_t, logits_j in zip(got[:2], ref[:2]):
        for a, b in zip(logits_t, logits_j):
            assert a.dtype == BF and b.dtype == jnp.bfloat16
            assert _rel(a, b) <= KERNEL_REL, _rel(a, b)
    for fmaps_t, fmaps_j in zip(got[2:], ref[2:]):
        for per_d_t, per_d_j in zip(fmaps_t, fmaps_j):
            assert len(per_d_t) == len(per_d_j)
            for a, b in zip(per_d_t, per_d_j):  # torch channels-first, JAX channels-last
                assert a.dtype == BF
                assert _rel(a.movedim(1, -1), b) <= KERNEL_REL, _rel(a.movedim(1, -1), b)
                n += 1
    assert n == 2 * (5 + 2 * 6)  # real and fake: the scale one's 5 maps, each period one's 6


def test_mel_spectrogram_of_bf16_wave_runs_in_float32():
    wav = _tbf(np.random.default_rng(16).standard_normal((2, 4096)) * 0.2)
    kw = dict(n_fft=256, n_mels=24, sample_rate=8000, fmin=0.0, fmax=4000.0, hop_length=64,
              win_length=256)
    got = stft.mel_spectrogram(wav, **kw)
    want = jstft.mel_spectrogram(jnp.asarray(wav.float().numpy(), jnp.bfloat16), **kw)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    torch.testing.assert_close(got, stft.mel_spectrogram(wav.float(), **kw), rtol=0, atol=0)


# ---------------------------------------------------- one bf16 GAN step
@pytest.fixture(scope="module")
def jax_step_bf16(jax_d_bf16):
    """The JAX reference step (tests/test_torch_train.py's, deterministic)
    with bf16 modules, on seeded port weights, as one compiled program."""
    hps = _hps()
    _, g_params = _port_g(hps)
    jd, d_params = jax_d_bf16
    bt = _batch(hps)
    jm = jfactory.build_synthesizer(hps, dtype=jnp.bfloat16)
    step = jax.jit(lambda gp, dp, b: _jax_step(hps, jm, jd, gp, dp, b))
    ref = jax.device_get(step(g_params, d_params, {k: jnp.asarray(v) for k, v in bt.items()}))
    return dict(ref, hps=hps, batch=bt, d_params=d_params)


def _grad_rel(net, grads_jax: dict) -> float:
    """||g_port - g_jax|| / ||g_jax|| over every parameter of the net."""
    params = dict(net.named_parameters())
    assert set(params) == set(grads_jax)
    diff = sum(float(((params[k].grad.double() - torch.from_numpy(np.asarray(g, np.float64))) ** 2).sum())
               for k, g in grads_jax.items())
    norm = sum(float((np.asarray(g, np.float64) ** 2).sum()) for g in grads_jax.values())
    return (diff / norm) ** 0.5


def test_gan_step_bf16_matches_jax(jax_step_bf16):
    ref = jax_step_bf16
    hps, bt = ref["hps"], ref["batch"]
    net_g, _ = _port_g(hps)
    net_d = _port_d(hps, ref["d_params"])
    set_compute_dtype(net_g, BF)
    set_compute_dtype(net_d, BF)
    batch = {k: torch.from_numpy(v) for k, v in bt.items()}
    # the training forward's outputs come out in the JAX forward's types
    with torch.no_grad():
        outs = net_g(*(batch[k] for k in ("c", "f0", "uv", "spec", "spk", "lengths")),
                     deterministic=True)
    flat = lambda o: [o[0], o[1], o[2], *o[3], o[4], o[5], o[6]]  # noqa: E731
    for a, b in zip(flat(outs), flat(ref["outs"])):
        assert str(a.dtype).split(".")[1] == str(np.asarray(b).dtype), (a.dtype, np.asarray(b).dtype)
    assert outs[0].dtype == BF
    opts = [make_optimizer(n.parameters(), hps) for n in (net_g, net_d)]
    got = {k: float(v) for k, v in train_step(net_g, net_d, *opts, batch, hps,
                                              deterministic=True).items()}
    want = {k: float(v) for k, v in ref["metrics"].items()}
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= LOSS_REL * abs(want[k]), (k, got[k], want[k])
    g_rel = _grad_rel(net_g, from_jax.synthesizer(_tree_np(ref["g_grads"]), hps))
    d_rel = _grad_rel(net_d, from_jax.multi_period_discriminator(_tree_np(ref["d_grads"])))
    assert g_rel <= GRAD_REL, g_rel
    assert d_rel <= GRAD_REL, d_rel
