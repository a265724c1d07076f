"""Each ported module vs its JAX module, same weights carried by from_jax (CPU).

JAX modules take [B, T, C]; the port's run channels-first [B, C, T], so the
tests transpose at the boundary. Tolerance: max-abs 1e-4 (fp32 on both
sides; the sums run in a different order).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.encoders import wav2vec2 as jw2v  # noqa: E402
from sovits_tpu.models import nsf_hifigan as jnsf  # noqa: E402
from sovits_tpu.models import synthesizer as jsyn  # noqa: E402
from sovits_tpu.nn import attention as jattn  # noqa: E402
from sovits_tpu.nn import conv as jconv  # noqa: E402
from sovits_tpu.nn import flows as jflows  # noqa: E402
from sovits_tpu.nn import norm as jnorm  # noqa: E402
from sovits_tpu.nn import resblocks as jres  # noqa: E402
from sovits_tpu.nn import wavenet as jwn  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder  # noqa: E402
from sovits_tpu_torch.models.nsf_hifigan import Generator, SourceModuleHnNSF  # noqa: E402
from sovits_tpu_torch.models.synthesizer import ContentEncoder  # noqa: E402
from sovits_tpu_torch.nn.attention import FFT, Encoder, MultiHeadAttention  # noqa: E402
from sovits_tpu_torch.nn.conv import WNConv1d, WNConvTranspose1d  # noqa: E402
from sovits_tpu_torch.nn.flows import ResidualCouplingBlock  # noqa: E402
from sovits_tpu_torch.nn.norm import LayerNorm  # noqa: E402
from sovits_tpu_torch.nn.resblocks import ResBlock1  # noqa: E402
from sovits_tpu_torch.nn.wavenet import WN  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ATOL = 1e-4
B, TL, C = 2, 40, 32


def _rng(seed=0):
    return np.random.default_rng(seed)


def _init(module, *args, seed=0, perturb=0.0, **kw):
    """flax params as numpy; ``perturb`` adds noise so zero-initialised
    weights (the flow's post conv) carry signal."""
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), *args, **kw)["params"])
    if perturb:
        rng = _rng(seed + 100)
        params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * perturb).astype(a.dtype), params)
    return params


def _load(module, sd, prefix=""):
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _sd(fn, params):
    sd = {}
    fn(sd, "", params)
    return sd


def _x(shape, seed=0, scale=0.5):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def _cf(x):  # [B, T, C] numpy -> [B, C, T] torch
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 1))))


def _cl(x):  # [B, C, T] torch -> [B, T, C] numpy
    return x.detach().numpy().transpose(0, 2, 1)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["conv1d", "conv1d_wn_dilated", "conv_transpose_wn"])
def test_conv(kind):
    x = _x((B, TL, 16))
    if kind == "conv1d":
        jm = jconv.Conv1d(features=24, kernel_size=5, padding=2)
        tm = torch.nn.Conv1d(16, 24, 5, padding=2)
        conv = from_jax.conv1d
    elif kind == "conv1d_wn_dilated":
        jm = jconv.Conv1d(features=24, kernel_size=3, dilation=3, padding=3, weight_norm=True)
        tm = WNConv1d(16, 24, 3, dilation=3, padding=3)
        conv = from_jax.conv1d_wn
    else:
        jm = jconv.ConvTranspose1d(features=8, kernel_size=16, stride=8, padding=4, weight_norm=True)
        tm = WNConvTranspose1d(16, 8, 16, 8, padding=4)
        conv = from_jax.conv_transpose1d_wn
    params = _init(jm, jnp.asarray(x), perturb=0.05)
    _load(tm, conv(params))
    _close(_cl(tm(_cf(x))), jm.apply({"params": params}, jnp.asarray(x)))


def test_layer_norm():
    x = _x((B, TL, C))
    jm = jnorm.LayerNorm()
    params = _init(jm, jnp.asarray(x), perturb=0.1)
    tm = _load(LayerNorm(C), {"gamma": np.array(params["scale"]), "beta": np.array(params["bias"])})
    _close(_cl(tm(_cf(x))), jm.apply({"params": params}, jnp.asarray(x)))


def test_wavenet():
    x, g = _x((B, TL, C)), _x((B, 1, 12), seed=1)
    mask = _mask([TL, TL - 7], TL)[..., None]
    jm = jwn.WaveNet(hidden_channels=C, kernel_size=5, dilation_rate=2, n_layers=3, gin_channels=12)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    params = _init(jm, *args, perturb=0.05)
    tm = _load(WN(C, 5, 2, 3, gin_channels=12), _sd(from_jax.wavenet, params))
    _close(_cl(tm(_cf(x), _cf(mask), _cf(g))), jm.apply({"params": params}, *args))


def test_multi_head_attention_windowed_keymask():
    x = _x((B, TL, C))
    mask = _mask([TL, TL - 9], TL)
    attn_mask = (mask[:, None, :, None] * mask[:, None, None, :]).astype(np.float32)
    jm = jattn.MultiHeadAttention(channels=C, out_channels=C, n_heads=2, window_size=4)
    args = (jnp.asarray(x), jnp.asarray(x), jnp.asarray(attn_mask))
    params = _init(jm, *args)
    ref = jm.apply({"params": params}, *args, key_mask=jnp.asarray(mask))
    tm = _load(MultiHeadAttention(C, C, 2, window_size=4), _sd(from_jax.mha, params))
    got = _cl(tm(_cf(x), _cf(x), torch.from_numpy(attn_mask), key_mask=torch.from_numpy(mask)))
    # valid query rows only: the JAX jnp path masks queries too, the fused
    # form only keys; masked rows are zeroed downstream in both packages
    _close(got * mask[..., None], np.asarray(ref) * mask[..., None])


@pytest.mark.parametrize("kind", ["encoder", "fft"])
def test_attention_stacks(kind):
    x = _x((B, TL, C), scale=0.3)
    mask = _mask([TL, TL - 9], TL)[..., None]
    if kind == "encoder":
        jm = jattn.Encoder(hidden_channels=C, filter_channels=64, n_heads=2, n_layers=2,
                           kernel_size=3, window_size=4)
        tm, conv = Encoder(C, 64, 2, 2, kernel_size=3, window_size=4), from_jax.attn_encoder
    else:
        jm = jattn.FFT(hidden_channels=C, filter_channels=64, n_heads=2, n_layers=2, kernel_size=3)
        tm, conv = FFT(C, 64, 2, 2, kernel_size=3), from_jax.attn_fft
    args = (jnp.asarray(x), jnp.asarray(mask))
    params = _init(jm, *args)
    _load(tm, _sd(conv, params))
    _close(_cl(tm(_cf(x), _cf(mask))), jm.apply({"params": params}, *args))


def test_coupling_block_reverse():
    x, g = _x((B, TL, C)), _x((B, 1, 12), seed=2)
    mask = _mask([TL, TL - 5], TL)[..., None]
    jm = jflows.ResidualCouplingBlock(channels=C, hidden_channels=24, kernel_size=5,
                                      dilation_rate=1, n_layers=2, n_flows=4, gin_channels=12)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    params = _init(jm, *args, perturb=0.05)
    sd = {}
    for i in range(4):
        cp = params[f"coupling_{i}"]
        for name in ("pre", "post"):
            for k, v in from_jax.conv1d(cp[name]).items():
                sd[f"flows.{2 * i}.{name}.{k}"] = v
        from_jax.wavenet(sd, f"flows.{2 * i}.enc.", cp["enc"])
    tm = _load(ResidualCouplingBlock(C, 24, 5, 1, 2, n_flows=4, gin_channels=12), sd)
    ref = jm.apply({"params": params}, *args, reverse=True)
    _close(_cl(tm(_cf(x), _cf(mask), g=_cf(g), reverse=True)), ref)


def test_resblock1():
    x = _x((B, TL, C))
    jm = jres.ResBlock1(channels=C, kernel_size=7, dilations=(1, 3, 5))
    params = _init(jm, jnp.asarray(x), perturb=0.03)
    sd = {}
    for j in range(3):
        for which in (1, 2):
            for k, v in from_jax.conv1d_wn(params[f"conv{which}_{j}"]).items():
                sd[f"convs{which}.{j}.{k}"] = v
    tm = _load(ResBlock1(C, 7, (1, 3, 5)), sd)
    _close(_cl(tm(_cf(x))), jm.apply({"params": params}, jnp.asarray(x)))


def test_source_module_without_noise():
    f0 = _rng(3).uniform(80, 400, (B, 12)).astype(np.float32)
    f0[0, 3:5] = 0.0  # unvoiced frames
    jm = jnsf.SourceModuleHnNSF(sample_rate=8000)
    params = _init(jm, jnp.asarray(f0), 64)
    ref, ref_uv = jm.apply({"params": params}, jnp.asarray(f0), 64, rng=None)
    tm = _load(SourceModuleHnNSF(8000), {
        "l_linear.weight": np.array(params["merge_kernel"]).T.copy(),
        "l_linear.bias": np.array(params["merge_bias"]),
    })
    har, uv = tm(torch.from_numpy(f0), 64)
    _close(_cl(har), ref)
    _close(_cl(uv), ref_uv, atol=0)


def test_generator_with_fused_trio_stages():
    """test_folded.py's generator config: stage widths 128 and 64, so both
    stages go through fused_resblock_trio (its plain version on the CPU)."""
    kw = dict(sampling_rate=8000, inter_channels=24, upsample_rates=(8, 2),
              upsample_kernel_sizes=(16, 4), upsample_initial_channel=256, gin_channels=16)
    rng = _rng(7)
    x = rng.standard_normal((1, 12, 24)).astype(np.float32)
    f0 = rng.uniform(100, 300, (1, 12)).astype(np.float32)
    g = (rng.standard_normal((1, 1, 16)) * 0.1).astype(np.float32)
    jm = jnsf.Generator(**kw)
    args = (jnp.asarray(x), jnp.asarray(f0), jnp.asarray(g))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"])
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, rng=None))(params, *args)
    tm = Generator(resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3, **kw)
    _load(tm, _sd(from_jax.generator, params))
    got = tm(_cf(x), torch.from_numpy(f0), _cf(g)).transpose(1, 2).detach().numpy()
    assert got.shape == ref.shape == (1, 12 * 16, 1)
    _close(got, ref)


def test_content_encoder():
    x = _x((B, TL, C), scale=0.3)
    mask = _mask([TL, TL - 6], TL)[..., None]
    coarse = _rng(4).integers(1, 256, (B, TL)).astype(np.int32)
    jm = jsyn.ContentEncoder(out_channels=16, hidden_channels=C, filter_channels=64, n_heads=2,
                             n_layers=2, kernel_size=3, p_dropout=0.0)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(coarse))
    params = _init(jm, *args)
    sd = {"f0_emb.weight": np.array(params["f0_emb"]["embedding"])}
    from_jax.attn_encoder(sd, "enc_.", params["enc"])
    sd.update({f"proj.{k}": v for k, v in from_jax.conv1d(params["proj"]).items()})
    tm = _load(ContentEncoder(16, C, 64, 2, 2, 3), sd)
    refs = jm.apply({"params": params}, *args, rng=None)
    gots = tm(_cf(x), _cf(mask), torch.from_numpy(coarse).long())
    for got, ref in zip(gots, refs):
        _close(_cl(got), ref)


TINY_W2V = dict(d_model=64, n_layers=2, n_heads=4, ffn_dim=128, pos_conv_kernel=16,
                pos_conv_groups=4, conv_layers=((32, 10, 5),) + ((32, 3, 2),) * 4 + ((32, 2, 2),) * 2)


def test_wav2vec2_encoder():
    wav = _x((1, 8000), seed=5, scale=0.3)
    jm = jw2v.Wav2Vec2Encoder(jw2v.Wav2Vec2Config(**TINY_W2V))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(wav))["params"])
    ref = jax.jit(lambda p, w: jm.apply({"params": p}, w))(params, jnp.asarray(wav))
    cfg = Wav2Vec2Config(**TINY_W2V)
    tm = _load(Wav2Vec2Encoder(cfg), from_jax.wav2vec2(params, cfg))
    got = tm(torch.from_numpy(wav)).detach().numpy()
    assert got.shape == ref.shape == (1, 24, 64)
    _close(got, ref)


@pytest.mark.parametrize("fn", ["f0_to_coarse", "lf0_round_trip", "normalize_f0", "interpolate_unvoiced",
                                "sequence_mask", "repeat_expand_nearest", "repeat_expand_linear",
                                "resample", "mel_spectrogram"])
def test_dsp(fn):
    from sovits_tpu import dsp as jdsp
    from sovits_tpu_torch.dsp import audio, f0, sequence, stft

    rng = _rng(8)
    hz = rng.uniform(40, 1300, (B, TL)).astype(np.float32)
    hz[0, :5] = 0.0
    if fn == "f0_to_coarse":
        np.testing.assert_array_equal(f0.f0_to_coarse(torch.from_numpy(hz)).numpy(),
                                      np.asarray(jdsp.f0_to_coarse(jnp.asarray(hz))))
    elif fn == "lf0_round_trip":
        lf0 = f0.f0_to_lf0(torch.from_numpy(hz))
        _close(lf0.numpy(), jdsp.f0_to_lf0(jnp.asarray(hz)), atol=1e-6)
        _close(f0.lf0_to_f0(lf0).numpy(), jdsp.lf0_to_f0(jdsp.f0_to_lf0(jnp.asarray(hz))), atol=1e-3)
    elif fn == "normalize_f0":
        lf0 = rng.standard_normal((B, TL, 1)).astype(np.float32)
        mask = _mask([TL, TL - 4], TL)[..., None]
        uv = (rng.random((B, TL)) > 0.3).astype(np.float32)
        uv[1] = 0.0  # no voiced frame at all
        got = f0.normalize_f0(*(torch.from_numpy(a) for a in (lf0, mask, uv)))
        _close(got.numpy(), jdsp.normalize_f0(jnp.asarray(lf0), jnp.asarray(mask), jnp.asarray(uv)), atol=1e-6)
    elif fn == "interpolate_unvoiced":
        got, want = f0.interpolate_unvoiced(hz[0]), jdsp.interpolate_unvoiced(hz[0])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    elif fn == "sequence_mask":
        lengths = np.array([TL, 7])
        np.testing.assert_array_equal(sequence.sequence_mask(torch.from_numpy(lengths), TL).numpy(),
                                      np.asarray(jdsp.sequence_mask(jnp.asarray(lengths), TL)))
    elif fn.startswith("repeat_expand"):
        mode = fn.rsplit("_", 1)[1]
        units = rng.standard_normal((50, 6)).astype(np.float32)
        for target in (86, 173, 31):  # 50 fps units onto 86 fps frames, and shrinking
            got = audio.repeat_expand(torch.from_numpy(units), target, mode).numpy()
            _close(got, jdsp.repeat_expand(jnp.asarray(units), target, mode), atol=1e-6)
    elif fn == "resample":
        wav = rng.standard_normal(4410).astype(np.float32)
        np.testing.assert_array_equal(audio.resample(wav, 44100, 16000), jdsp.resample(wav, 44100, 16000))
    else:
        wav = (rng.standard_normal((1, 8000)) * 0.2).astype(np.float32)
        got = stft.mel_spectrogram(torch.from_numpy(wav), 128, 20, 8000, 64, 128, 0.0, 4000.0).numpy()
        want = jdsp.mel_spectrogram(jnp.asarray(wav), 128, 20, 8000, 64, 128, 0.0, 4000.0)
        _close(got, want, atol=1e-4)


def test_fused_tail_generator_grads_match_jax():
    """The fused tail under autograd: the port's Generator(fused_tail=True)
    (FusedTrio on both stages) against jax.grad through the JAX fused-tail
    generator (trio_folded's custom VJP), every parameter, the loss and
    tolerance of tests/test_folded.py's train-path check."""
    kw = dict(sampling_rate=8000, inter_channels=24, upsample_rates=(8, 2),
              upsample_kernel_sizes=(16, 4), upsample_initial_channel=256, gin_channels=16)
    rng = _rng(7)
    x = rng.standard_normal((1, 12, 24)).astype(np.float32)
    f0 = rng.uniform(100, 300, (1, 12)).astype(np.float32)
    g = (rng.standard_normal((1, 1, 16)) * 0.1).astype(np.float32)
    jm = jnsf.Generator(**kw, fused_tail=True)
    args = (jnp.asarray(x), jnp.asarray(f0), jnp.asarray(g))
    # init and gradient each as one compiled program (op by op, the fused
    # tail's interpreted kernel took over a minute on the CPU)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"])

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, *args, rng=None) ** 2) * 1e3

    ref = _sd(from_jax.generator, jax.jit(jax.grad(loss))(params))
    tm = Generator(resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3,
                   fused_tail=True, **kw)
    _load(tm, _sd(from_jax.generator, params))
    wav = tm(_cf(x), torch.from_numpy(f0), _cf(g))
    assert wav.grad_fn is not None
    (wav.square().sum() * 1e3).backward()
    named = dict(tm.named_parameters())
    assert set(named) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(named[name].grad.numpy(), want, rtol=5e-3, atol=5e-4, err_msg=name)
