"""The port's bf16 voice-conversion path vs the JAX package's, in bf16 (CPU).

The JAX package runs its serving path in bf16 (``Synthesizer(dtype=bf16)``,
``Wav2Vec2Encoder(dtype=bf16)``: float32 parameters, bf16 compute). The
same inputs, made with numpy, go through both packages in bf16:

- the kernels' plain versions against the Pallas kernels in interpret mode
  with bf16 inputs;
- single modules (LayerNorm, a weight-normed conv, MultiHeadAttention);
- the speech encoder and ``Synthesizer.infer``.

Tolerances, on max-abs relative to the reference's peak: 2e-2 for a kernel
or a module (a few bf16 ulps: the two round at different points and sum in
other orders); 5e-2 for the encoder and the synthesizer, the bar bench.py
sets for two bf16 decodes (``e2e_synth_rel_err``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.encoders import wav2vec2 as jw2v  # noqa: E402
from sovits_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu.nn import attention as jattn  # noqa: E402
from sovits_tpu.nn import conv as jconv  # noqa: E402
from sovits_tpu.nn import norm as jnorm  # noqa: E402
from sovits_tpu.ops.attention import fused_attention as jax_fused_attention  # noqa: E402
from sovits_tpu.ops.fused_stage import fused_resblock_trio as jax_trio  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.nn.attention import MultiHeadAttention  # noqa: E402
from sovits_tpu_torch.nn.conv import WNConv1d, set_compute_dtype  # noqa: E402
from sovits_tpu_torch.nn.norm import LayerNorm  # noqa: E402
from sovits_tpu_torch.ops.attention import fused_attention  # noqa: E402
from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio  # noqa: E402
from tests.test_torch_modules import TINY_W2V, _cf, _init, _load, _mask, _sd, _x  # noqa: E402
from tests.test_torch_ops import _attn_inputs, _trio_inputs  # noqa: E402
from tests.tiny import tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

BF = torch.bfloat16
KERNEL_REL = 2e-2  # a few bf16 ulps
E2E_REL = 5e-2  # bench.py's e2e_synth_rel_err for two bf16 decodes


def _jbf(x):
    return None if x is None else jnp.asarray(x, jnp.bfloat16)


def _tbf(x):
    return None if x is None else torch.from_numpy(np.asarray(x, np.float32)).to(BF)


def _assert_rel(got: torch.Tensor, ref, rel: float) -> float:
    """max|got - ref| <= rel * max|ref|; both compared in float32."""
    assert got.dtype == BF, got.dtype
    got = got.float().detach().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, peak = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert np.isfinite(got).all() and peak > 0
    assert err <= rel * peak, (err, peak, err / peak)
    return err / peak


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("window,causal,masked", [(4, False, True), (None, True, False)],
                         ids=["window4-keymask", "causal"])
def test_attention_bf16_plain_matches_jax(window, causal, masked):
    q, k, v, rel_k, rel_v, km = _attn_inputs(window, masked, seed=11)
    rk, rv = (rel_k, rel_v) if window else (None, None)
    ref = jax_fused_attention(_jbf(q), _jbf(k), _jbf(v), _jbf(rk), _jbf(rv),
                              key_mask=None if km is None else jnp.asarray(km),
                              window=window, causal=causal, interpret=True)
    assert ref.dtype == jnp.bfloat16
    got = fused_attention(_tbf(q), _tbf(k), _tbf(v), _tbf(rk), _tbf(rv),
                          None if km is None else torch.from_numpy(km), window=window, causal=causal)
    _assert_rel(got, ref, KERNEL_REL)


@pytest.mark.parametrize("c,t", [(16, 96), (32, 72)])
def test_trio_bf16_plain_matches_jax(c, t):
    x, kernels, biases = _trio_inputs(c, t, seed=c + 1)
    ref = jax_trio(_jbf(x), [_jbf(w) for w in kernels], [_jbf(b) for b in biases], interpret=True)
    assert ref.dtype == jnp.bfloat16
    got = fused_resblock_trio(_tbf(x), [_tbf(w) for w in kernels], [_tbf(b) for b in biases])
    _assert_rel(got, ref, KERNEL_REL)


# ------------------------------------------------------------------ modules
B, TL, C = 2, 40, 32


def test_layer_norm_bf16():
    x = _x((B, TL, C))
    jm = jnorm.LayerNorm(dtype=jnp.bfloat16)
    params = _init(jm, jnp.asarray(x), perturb=0.1)
    tm = set_compute_dtype(_load(LayerNorm(C), {"gamma": np.array(params["scale"]),
                                                "beta": np.array(params["bias"])}), BF)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    _assert_rel(tm(_cf(x)).transpose(1, 2), ref, KERNEL_REL)


def test_wn_conv_bf16():
    x = _x((B, TL, 16))
    jm = jconv.Conv1d(features=24, kernel_size=3, dilation=3, padding=3, weight_norm=True,
                      dtype=jnp.bfloat16)
    params = _init(jm, jnp.asarray(x), perturb=0.05)
    tm = set_compute_dtype(_load(WNConv1d(16, 24, 3, dilation=3, padding=3), from_jax.conv1d_wn(params)), BF)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    _assert_rel(tm(_cf(x)).transpose(1, 2), ref, KERNEL_REL)
    # inference: the bf16 copy of the folded weight is refolded with the fp32 fold
    with torch.no_grad():
        before = tm.effective_weight()
        tm.weight_g.mul_(2.0)
        after = tm.effective_weight()
        assert before.dtype == after.dtype == BF
        torch.testing.assert_close(after, tm.weight.to(BF), rtol=0, atol=0)
        torch.testing.assert_close(after, 2 * before, rtol=1e-2, atol=0)


def test_multi_head_attention_bf16():
    x = _x((B, TL, C))
    mask = _mask([TL, TL - 9], TL)
    attn_mask = (mask[:, None, :, None] * mask[:, None, None, :]).astype(np.float32)
    jm = jattn.MultiHeadAttention(channels=C, out_channels=C, n_heads=2, window_size=4,
                                  dtype=jnp.bfloat16)
    args = (jnp.asarray(x), jnp.asarray(x), jnp.asarray(attn_mask))
    params = _init(jm, *args)
    ref = jm.apply({"params": params}, *args, key_mask=jnp.asarray(mask))
    tm = set_compute_dtype(_load(MultiHeadAttention(C, C, 2, window_size=4), _sd(from_jax.mha, params)), BF)
    got = tm(_cf(x), _cf(x), torch.from_numpy(attn_mask), key_mask=torch.from_numpy(mask))
    # valid query rows only, as the fp32 test: masked rows are zeroed downstream
    m = torch.from_numpy(mask)[:, None, :].to(BF)
    _assert_rel((got * m).transpose(1, 2), np.asarray(ref, np.float32) * mask[..., None], KERNEL_REL)


def test_wav2vec2_encoder_bf16():
    wav = _x((1, 8000), seed=5, scale=0.3)
    jm = jw2v.Wav2Vec2Encoder(jw2v.Wav2Vec2Config(**TINY_W2V), dtype=jnp.bfloat16)
    params = _init(jm, jnp.asarray(wav))
    ref = jm.apply({"params": params}, jnp.asarray(wav))
    assert ref.dtype == jnp.bfloat16
    cfg = Wav2Vec2Config(**TINY_W2V)
    tm = _load(Wav2Vec2Encoder(cfg, dtype=BF), from_jax.wav2vec2(params, cfg))
    assert all(p.dtype == torch.float32 for p in tm.parameters())  # param_dtype stays fp32
    _assert_rel(tm(torch.from_numpy(wav)), ref, E2E_REL)


# -------------------------------------------------------------- synthesizer
# upsampling 8 x 4 x 2 from 32 channels: the first stage (C = 16, fold 8)
# runs the fused trio in both packages (the JAX fold * C == 128 rule), the
# others plain ResBlock1 convs in both
SYN_OVERRIDES = {"model.upsample_rates": [8, 4, 2], "model.upsample_kernel_sizes": [16, 8, 4]}


@pytest.fixture(scope="module")
def bf16_pair():
    hps = tiny_hps(**SYN_OVERRIDES)
    tm = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True, dtype=BF),
                              torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    m = hps.model
    params = jax.tree.map(jnp.asarray, from_torch.synthesizer(
        sd, n_upsamples=len(m.upsample_rates), n_resblock_kernels=len(m.resblock_kernel_sizes)))
    jm = jfactory.build_synthesizer(hps, dtype=jnp.bfloat16, fused_tail=True)
    rng = np.random.default_rng(1)
    b, t = 2, 40
    inputs = dict(
        c=rng.standard_normal((b, t, m.ssl_dim)).astype(np.float32),
        f0=rng.uniform(100, 300, (b, t)).astype(np.float32),
        uv=(rng.random((b, t)) > 0.2).astype(np.float32),
        spk=np.array([0, 1], np.int64),
        lengths=np.array([t, t - 7], np.int64),
    )
    return hps, jm, params, tm, inputs


@pytest.mark.parametrize("predict_f0", [False, True], ids=["given-f0", "predicted-f0"])
def test_synthesizer_infer_bf16_matches_jax(bf16_pair, predict_f0):
    hps, jm, params, tm, inputs = bf16_pair
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    wav_j, f0_j = jax.jit(lambda p, c, f0, uv, spk, lengths: jm.apply(
        {"params": p}, c, f0, uv, spk, noise_scale=0.0, predict_f0=predict_f0,
        sample_noise=False, lengths=lengths, method=JaxSynthesizer.infer,
    ))(params, j["c"], j["f0"], j["uv"], j["spk"].astype(jnp.int32), j["lengths"].astype(jnp.int32))
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    wav_t, f0_t = tm.infer(t["c"], t["f0"], t["uv"], t["spk"], noise_scale=0.0,
                           predict_f0=predict_f0, sample_noise=False, lengths=t["lengths"])
    assert wav_j.dtype == jnp.bfloat16
    assert wav_t.shape == (2, 40 * hps.data.hop_length, 1)
    assert float(wav_t.float().abs().max()) > 1e-3
    _assert_rel(wav_t, wav_j, E2E_REL)
    # predicted f0 goes through 10**x of a float32 projection: relative to its Hz scale
    np.testing.assert_allclose(f0_t.numpy(), np.asarray(f0_j), rtol=2e-2, atol=1.0)
