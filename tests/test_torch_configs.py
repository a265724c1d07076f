"""The modules of so-vits-svc 4.1's model options in the port vs the JAX
package (CPU); the whole synthesizer and Svc are in
test_torch_configs_synth.py.

The options: ``vol_embedding`` (with the volume feature ``energy``),
``use_transformer_flow`` (causal FFT couplings conditioned on g),
``flow_share_parameter``, ``use_depthwise_conv`` (separable resblock convs),
``resblock: "2"`` and ``vocoder_name: nsf-snake-hifigan``.

JAX parameters come from the modules' own shapes (``jax.eval_shape`` of
``init``, no init graph is compiled) filled from a seeded numpy generator,
so that what starts at zero (the flows' ``post``, Snake's log-scale alpha
and beta) carries signal; ``from_jax`` carries them into the port, whose
state_dict must load strictly. The JAX side runs as its own CPU tests run
it: jnp attention and plain convs.

Bars: fp32 max-abs 1e-4 (``test_torch_modules.ATOL``; the audio's
``AUDIO_ATOL``), and the log-mel L1 < 1e-3 of BASELINE.md on the audio.
bf16, on max-abs relative to the reference's peak: 2e-2 for a module
(``test_torch_bf16.KERNEL_REL``), 5e-2 for a synthesizer or a generator
(``E2E_REL``). The JAX Snake generator cannot run in bf16 (its
``upsample2x`` hands ``lax.conv_general_dilated`` a bf16 input with a
float32 filter, which it refuses), so the port's bf16 Snake generator is
held against the JAX float32 one at E2E_REL; its Snake activations compute
in float32 and meet the fp32 bar.

The JAX package's separable resblocks cannot be built as they stand:
``resblocks.py`` hands ``make_conv1d`` a ``kernel_init``, which it passes on
to ``SeparableConv1d``, a module without that field, so a JAX synthesizer
with ``use_depthwise_conv`` raises TypeError at init. The initializer
decides only the values that ``init`` draws, and the params here are
filled from the shapes instead, so the tests that build separable
resblocks (``jax_separable``) drop that one keyword for separable convs;
what the JAX modules compute is unchanged.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.dsp import stft as jstft  # noqa: E402
from sovits_tpu.models import snake_hifigan as jsnake_gen  # noqa: E402
from sovits_tpu.nn import attention as jattn  # noqa: E402
from sovits_tpu.nn import conv as jconv  # noqa: E402
from sovits_tpu.nn import flows as jflows  # noqa: E402
from sovits_tpu.nn import resblocks as jres  # noqa: E402
from sovits_tpu.nn import snake as jsnake  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.dsp.stft import energy  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.models.nsf_hifigan import Generator  # noqa: E402
from sovits_tpu_torch.nn.attention import FFT  # noqa: E402
from sovits_tpu_torch.nn.conv import SeparableConv1d, set_compute_dtype  # noqa: E402
from sovits_tpu_torch.nn.flows import ResidualCouplingBlock, TransformerCouplingBlock  # noqa: E402
from sovits_tpu_torch.nn.resblocks import ResBlock1, ResBlock2  # noqa: E402
from sovits_tpu_torch.nn.snake import (  # noqa: E402
    SnakeAlias, SnakeBeta, downsample2x, lowpass, upsample2x)
from tests.test_torch_bf16 import E2E_REL, KERNEL_REL, _assert_rel  # noqa: E402
from tests.test_torch_modules import ATOL, _cf, _cl, _close, _load, _mask, _sd, _x  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

B, TL, C = 2, 40, 32
BF = torch.bfloat16


def _fill(node, rng, path=()):
    """A param tree of ShapeDtypeStructs -> seeded float32 numpy values:
    torch's uniform +-1/sqrt(fan_in) for kernels (N(0, 0.01) in the
    vocoder's resblocks, as the reference initialises them; its upsamplers
    keep the uniform draw, so that the latent, and with it the encoder and
    the flow, moves the audio well above the bars),
    weight-norm gains equal to their kernel's norm, N(0, 1) embeddings,
    N(0, d^-1/2) Shaw tables, LayerNorm scales near 1, and N(0, 0.1)
    otherwise (biases, Snake's log-scale alpha and beta, the source merge)."""
    if isinstance(node, dict):
        out = {k: _fill(v, rng, path + (k,)) for k, v in sorted(node.items())}
        kernel = out.get("kernel")
        if "g" in out:
            out["g"] = np.sqrt((kernel**2).sum(axis=tuple(range(kernel.ndim - 1)))).astype(np.float32)
        if "g_in" in out:
            out["g_in"] = np.sqrt((kernel**2).sum(axis=(0, 2))).astype(np.float32)
        return out
    shape, name = node.shape, path[-1]
    resblock_conv = any(p.startswith("resblock_") for p in path) and "depth" not in path
    if name == "kernel" and resblock_conv:
        value = rng.normal(0.0, 0.01, shape)
    elif name == "kernel":
        value = rng.uniform(-1.0, 1.0, shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "embedding":
        value = rng.standard_normal(shape)
    elif name in ("emb_rel_k", "emb_rel_v"):
        value = rng.standard_normal(shape) * shape[-1] ** -0.5
    elif name == "scale":
        value = 1.0 + 0.1 * rng.standard_normal(shape)
    else:
        value = 0.1 * rng.standard_normal(shape)
    return value.astype(np.float32)


@pytest.fixture
def jax_separable(monkeypatch):
    """The JAX resblocks' separable convs without the initializer that
    ``SeparableConv1d`` refuses (module docstring)."""
    make = jres.make_conv1d

    def without_init(separable, **kwargs):
        if separable:
            kwargs.pop("kernel_init", None)
        return make(separable, **kwargs)

    monkeypatch.setattr(jres, "make_conv1d", without_init)


def _params(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    return _fill(shapes, np.random.default_rng(seed))


def _apply(module, params, *args, **kw):
    """The JAX module on its params, as one compiled program."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(params, *args)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("kernel_size,dilation", [(5, 2), (11, 1)])
def test_separable_conv(kernel_size, dilation):
    x = _x((B, TL, 16))
    padding = (kernel_size - 1) * dilation // 2
    jm = jconv.SeparableConv1d(features=24, kernel_size=kernel_size, dilation=dilation, padding=padding,
                               weight_norm=True)
    params = _params(jm, jnp.asarray(x))
    tm = _load(SeparableConv1d(16, 24, kernel_size, padding, dilation), from_jax.conv1d_any(params))
    _close(_cl(tm(_cf(x))), _apply(jm, params, jnp.asarray(x)))


@pytest.mark.parametrize("kind,dilations,separable", [
    ("2", (1, 3), False), ("2", (1, 3, 5), False), ("1", (1, 3, 5), True), ("2", (1, 3), True),
], ids=["resblock2-2dil", "resblock2-3dil", "resblock1-separable", "resblock2-separable"])
def test_resblock(kind, dilations, separable, jax_separable):
    x = _x((B, TL, C))
    jcls, tcls = (jres.ResBlock1, ResBlock1) if kind == "1" else (jres.ResBlock2, ResBlock2)
    jm = jcls(channels=C, kernel_size=3, dilations=dilations, separable=separable)
    params = _params(jm, jnp.asarray(x))
    tm = _load(tcls(C, 3, dilations, separable=separable), _sd(from_jax.resblock, params))
    assert len(tm.convs1 if kind == "1" else tm.convs) == len(dilations)
    _close(_cl(tm(_cf(x))), _apply(jm, params, jnp.asarray(x)))


def _flow_args(gin=12):
    x, g = _x((B, TL, C), scale=0.5), _x((B, 1, gin), seed=1)
    mask = _mask([TL, TL - 7], TL)[..., None]
    return x, mask, g


def test_fft_flow_conditioned_on_g():
    x, mask, g = _flow_args()
    jm = jattn.FFT(hidden_channels=C, filter_channels=64, n_heads=2, n_layers=2, kernel_size=5,
                   isflow=True, gin_channels=12)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    params = _params(jm, *args)
    assert {"cond", "cond_pre"} <= set(params)
    tm = _load(FFT(C, 64, 2, 2, kernel_size=5, isflow=True, gin_channels=12), _sd(from_jax.attn_fft, params))
    got = tm(_cf(x), _cf(mask), g=_cf(g))
    _close(_cl(got), _apply(jm, params, *args))
    # g reaches every layer's gate
    assert (got - tm(_cf(x), _cf(mask), g=_cf(g) + 1.0)).abs().max() > 1e-3


@pytest.mark.parametrize("shared", [False, True], ids=["own-fft", "shared-fft"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_transformer_coupling_block(shared, reverse):
    x, mask, g = _flow_args()
    jm = jflows.TransformerCouplingBlock(channels=C, hidden_channels=24, filter_channels=48, n_heads=2,
                                         n_layers=2, kernel_size=5, n_flows=4, gin_channels=12,
                                         share_parameter=shared)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    params = _params(jm, *args)
    assert ("shared_enc" in params) == shared
    tm = TransformerCouplingBlock(C, 24, 48, 2, 2, 5, n_flows=4, gin_channels=12, share_parameter=shared)
    _load(tm, _sd(lambda sd, p, prm: from_jax.coupling_block(sd, p, prm, transformer=True), params))
    got = tm(_cf(x), _cf(mask), g=_cf(g), reverse=reverse)
    _close(_cl(got), _apply(jm, params, *args, reverse=reverse))
    assert (got - _cf(x) * _cf(mask)).abs().max() > 1e-2  # not the identity


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_residual_coupling_block_shared(reverse):
    x, mask, g = _flow_args()
    jm = jflows.ResidualCouplingBlock(channels=C, hidden_channels=24, kernel_size=5, dilation_rate=1,
                                      n_layers=2, n_flows=4, gin_channels=12, share_parameter=True)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    params = _params(jm, *args)
    tm = ResidualCouplingBlock(C, 24, 5, 1, 2, n_flows=4, gin_channels=12, share_parameter=True)
    sd = _sd(lambda sd, p, prm: from_jax.coupling_block(sd, p, prm, transformer=False), params)
    assert {k for k in sd if k.startswith("wn.")} and {k for k in sd if k.startswith("flows.6.enc.")}
    _load(tm, sd)
    assert all(layer.enc is tm.wn for layer in tm.flows[::2])
    got = tm(_cf(x), _cf(mask), g=_cf(g), reverse=reverse)
    _close(_cl(got), _apply(jm, params, *args, reverse=reverse))


@pytest.mark.parametrize("t", [40, 37], ids=["even", "odd"])
@pytest.mark.parametrize("which", ["up", "down"])
def test_resample(which, t):
    x = _x((B, t, 6), seed=3)
    jfn, tfn = (jsnake.upsample2x, upsample2x) if which == "up" else (jsnake.downsample2x, downsample2x)
    ref = jfn(jnp.asarray(x))
    assert ref.shape[1] == (2 * t if which == "up" else (t + 1) // 2)
    _close(_cl(tfn(_cf(x), lowpass())), ref, atol=1e-6)


@pytest.mark.parametrize("kind", ["snake_beta", "snake_alias"])
def test_snake(kind):
    x = _x((B, 37, 6), seed=4, scale=1.0)
    jm = jsnake.SnakeBeta() if kind == "snake_beta" else jsnake.SnakeAlias()
    params = _params(jm, jnp.asarray(x), seed=5)
    if kind == "snake_beta":
        tm = _load(SnakeBeta(6), {k: np.asarray(v) for k, v in params.items()})
    else:
        tm = _load(SnakeAlias(6), _sd(from_jax._snake, params))
    _close(_cl(tm(_cf(x))), _apply(jm, params, jnp.asarray(x)))


SNAKE_GEN = dict(sampling_rate=8000, inter_channels=24, resblock_kernel_sizes=(3, 7),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 4),
                 upsample_initial_channel=32, upsample_kernel_sizes=(8, 8), gin_channels=16)


def _snake_generator_pair(resblock, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 12, 24)).astype(np.float32)
    f0 = rng.uniform(100, 300, (1, 12)).astype(np.float32)
    g = (rng.standard_normal((1, 1, 16)) * 0.1).astype(np.float32)
    jm = jsnake_gen.SnakeGenerator(resblock=resblock, **SNAKE_GEN)
    args = (jnp.asarray(x), jnp.asarray(f0), jnp.asarray(g))
    params = _params(jm, *args, seed=seed)
    tm = _load(Generator(resblock=resblock, snake=True, **SNAKE_GEN), _sd(from_jax.generator, params))
    return jm, params, args, tm, (_cf(x), torch.from_numpy(f0), _cf(g))


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_snake_generator(resblock):
    jm, params, args, tm, targs = _snake_generator_pair(resblock)
    ref = _apply(jm, params, *args, rng=None)
    got = tm(*targs).transpose(1, 2).detach().numpy()
    assert got.shape == ref.shape == (1, 12 * 16, 1)
    assert 1e-3 < np.abs(got).max() < 0.99  # signal, not saturated
    _close(got, ref)


@pytest.mark.parametrize("length", [64 * 10, 64 * 10 + 17, 64 * 10 + 63])
def test_energy(length):
    y = _x((2, length), seed=8)
    got = energy(torch.from_numpy(y), 64).numpy()
    ref = np.asarray(jstft.energy(jnp.asarray(y), 64))
    assert got.shape == ref.shape == (2, length // 64)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------- bf16
def test_fft_flow_bf16_matches_jax():
    x, mask, g = _flow_args()
    jm = jattn.FFT(hidden_channels=C, filter_channels=64, n_heads=2, n_layers=2, kernel_size=5,
                   isflow=True, gin_channels=12, dtype=jnp.bfloat16)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    params = _params(jm, *args)
    tm = _load(FFT(C, 64, 2, 2, kernel_size=5, isflow=True, gin_channels=12), _sd(from_jax.attn_fft, params))
    set_compute_dtype(tm, BF)
    ref = _apply(jm, params, *args)
    _assert_rel(tm(_cf(x), _cf(mask), g=_cf(g)).transpose(1, 2).to(BF), ref, KERNEL_REL)


def test_jax_snake_generator_refuses_bf16():
    """Why the bf16 Snake tests below hold the port against JAX in float32."""
    jm, params, args, _tm, _targs = _snake_generator_pair("1")
    jbf = jsnake_gen.SnakeGenerator(resblock="1", dtype=jnp.bfloat16, **SNAKE_GEN)
    with pytest.raises(TypeError, match="same dtypes"):
        _apply(jbf, params, *args, rng=None)


def test_snake_alias_bf16():
    """A bf16 input is promoted to float32 with the float32 filter and
    parameters, as numpy's rules promote it: the JAX float32 module on the
    same bf16-rounded input, at the fp32 bar."""
    x = _x((B, 37, 6), seed=4, scale=1.0)
    jm = jsnake.SnakeAlias()
    params = _params(jm, jnp.asarray(x), seed=5)
    got = _load(SnakeAlias(6), _sd(from_jax._snake, params))(_cf(x).to(BF))
    assert got.dtype == torch.float32
    _close(_cl(got), _apply(jm, params, jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_snake_generator_bf16(resblock):
    jm, params, args, tm, targs = _snake_generator_pair(resblock)
    ref = _apply(jm, params, *args, rng=None)
    got = set_compute_dtype(tm, BF)(*targs)
    assert got.dtype == BF
    _assert_rel(got.transpose(1, 2), ref, E2E_REL)
