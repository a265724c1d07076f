"""so-vits-svc 4.1's model options through the whole synthesizer and Svc,
in the port against the JAX package (CPU); the modules alone are in
test_torch_configs.py, whose parameter filling and bars this file shares.

(a) Synthesizer.infer (audio, and the latent the reversed flow hands the
    vocoder) per option and for two combinations: the tiny template, and
    vol_embedding + transformer flow + shared flow; the vol + transformer
    flow synthesizer in bf16 against the JAX package in bf16.
(b) Each option builds its module; random init draws what starts at zero.
(c) Svc.infer and slice_inference on a vol_embedding model against the
    JAX Svc, with both packages' ``_run_synth_batch`` patched to
    ``sample_noise=False`` and yin f0 (bit-equal in the two packages);
    RealTimeVC and the infer CLI on that model.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu import config as scfg  # noqa: E402
from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.infer import svc as jsvc_mod  # noqa: E402
from sovits_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.dsp.stft import energy  # noqa: E402
from sovits_tpu_torch.infer import svc as tsvc_mod  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.nn.conv import SeparableConv1d  # noqa: E402
from sovits_tpu_torch.nn.flows import TransformerCouplingBlock  # noqa: E402
from sovits_tpu_torch.nn.resblocks import ResBlock2  # noqa: E402
from sovits_tpu_torch.nn.snake import SnakeAlias  # noqa: E402
from tests.test_torch_bf16 import E2E_REL, _assert_rel  # noqa: E402
from tests.test_torch_configs import BF, TL, _fill, jax_separable  # noqa: E402,F401
from tests.test_torch_infer import _song  # noqa: E402
from tests.test_torch_modules import _cl, _close  # noqa: E402
from tests.test_torch_slice import AUDIO_ATOL, MEL_L1, _log_mel, _voiced  # noqa: E402
from tests.tiny import tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


# ------------------------------------------------------- (a) synthesizer
# the tiny template's options and widths, with five upsampling stages as the
# full model has (hop 64): 400 halves to 25 and then 12, so a stage's input
# width is not twice its output's
TINY_TEMPLATE = {"model.filter_channels": 512, "model.upsample_initial_channel": 400,
                 "model.use_depthwise_conv": True, "model.flow_share_parameter": True,
                 "model.upsample_rates": [4, 2, 2, 2, 2], "model.upsample_kernel_sizes": [8, 4, 4, 4, 4]}
# tests/tiny.py's widths with one resblock kernel (of the three dilations),
# which cuts the JAX programs these tests compile to a third (the modules'
# own tests take three kernels)
SYNTH_BASE = {"model.resblock_kernel_sizes": [3], "model.resblock_dilation_sizes": [[1, 3, 5]]}
SYNTH_CASES = {
    "vol_embedding": {"model.vol_embedding": True},
    "transformer_flow": {"model.use_transformer_flow": True},
    "depthwise_conv": {"model.use_depthwise_conv": True},
    "flow_share_parameter": {"model.flow_share_parameter": True},
    "resblock2": {"model.resblock": "2"},
    "snake": {"model.vocoder_name": "nsf-snake-hifigan"},
    "tiny_template": TINY_TEMPLATE,
    "vol_tflow_shared": {"model.vol_embedding": True, "model.use_transformer_flow": True,
                         "model.flow_share_parameter": True},
}


def _synth_inputs(hps, seed=0):
    rng = np.random.default_rng(seed)
    b, t = 2, TL
    return dict(
        c=rng.standard_normal((b, t, hps.model.ssl_dim)).astype(np.float32),
        f0=rng.uniform(100, 300, (b, t)).astype(np.float32),
        uv=(rng.random((b, t)) > 0.2).astype(np.float32),
        spk=np.array([0, 1], np.int64),
        lengths=np.array([t, t - 7], np.int64),
        vol=rng.uniform(0.0, 0.3, (b, t)).astype(np.float32),
    )


def _synth_pair(case, dtype=torch.float32, seed=0):
    """The JAX Synthesizer (plain convs) with filled params, and the port's
    (fused tail, as Svc builds it) with the same weights through from_jax."""
    hps = tiny_hps(**SYNTH_BASE, **SYNTH_CASES[case])
    m = hps.model
    jm = jfactory.build_synthesizer(hps, dtype=jnp.bfloat16 if dtype == BF else jnp.float32)
    t = 16
    spec = jnp.zeros((1, t, hps.data.filter_length // 2 + 1))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1), "slice": jax.random.PRNGKey(2)},
        jnp.zeros((1, t, m.ssl_dim)), jnp.full((1, t), 220.0), jnp.ones((1, t)), spec,
        jnp.zeros((1,), jnp.int32), jnp.full((1,), t, jnp.int32),
        vol=jnp.zeros((1, t)) if m.vol_embedding else None, deterministic=True))["params"]
    params = _fill(shapes, np.random.default_rng(seed))
    tm = factory.build_synthesizer(hps, "cpu", fused_tail=True, dtype=dtype)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax.synthesizer(params, hps).items()},
                       strict=True)
    return hps, jm, jax.tree.map(jnp.asarray, params), tm, _synth_inputs(hps)


def _jax_decode(module, c, f0, uv, spk, lengths, vol):
    """The JAX Synthesizer.infer with the noise off, also returning the
    latent that infer_pre hands the vocoder (one traced program)."""
    z, f0, g = module.infer_pre(c, f0, uv, spk, noise_scale=0.0, vol=vol, sample_noise=False,
                                lengths=lengths)
    return module.dec(z, f0, g=g, rng=None), z


def _infer_pair(jm, params, tm, inputs):
    """(wav, latent) of both packages' infer with the noise off."""
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    wav_j, z_j = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=_jax_decode))(
        params, j["c"], j["f0"], j["uv"], j["spk"].astype(jnp.int32), j["lengths"].astype(jnp.int32),
        j["vol"])
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    kw = dict(noise_scale=0.0, sample_noise=False, lengths=t["lengths"], vol=t["vol"])
    wav_t, _ = tm.infer(t["c"], t["f0"], t["uv"], t["spk"], **kw)
    z_t, _, _ = tm.infer_pre(t["c"], t["f0"], t["uv"], t["spk"], **kw)
    return (wav_j, z_j), (wav_t, z_t)


@pytest.mark.parametrize("case", list(SYNTH_CASES))
def test_synthesizer_option_matches_jax(case, jax_separable):
    hps, jm, params, tm, inputs = _synth_pair(case)
    (wav_j, z_j), (wav_t, z_t) = _infer_pair(jm, params, tm, inputs)
    wav_j, wav_t = np.asarray(wav_j), wav_t.numpy()
    assert wav_t.shape == wav_j.shape == (2, TL * hps.data.hop_length, 1)
    assert np.isfinite(wav_t).all() and 1e-3 < np.abs(wav_t).max() < 0.99
    np.testing.assert_allclose(wav_t, wav_j, rtol=0, atol=AUDIO_ATOL)
    mel_l1 = np.abs(_log_mel(wav_t[..., 0], hps) - _log_mel(wav_j[..., 0], hps)).mean()
    assert mel_l1 < MEL_L1, mel_l1
    _close(_cl(z_t), z_j)  # the encoder and the flow alone
    if hps.model.vol_embedding:  # the volume reaches the audio
        t = {k: torch.from_numpy(v) for k, v in inputs.items()}
        silent, _ = tm.infer(t["c"], t["f0"], t["uv"], t["spk"], noise_scale=0.0, sample_noise=False,
                             lengths=t["lengths"], vol=torch.zeros_like(t["vol"]))
        assert np.abs(silent.numpy() - wav_t).max() > 1e-4


def test_synthesizer_vol_tflow_bf16_matches_jax():
    hps, jm, params, tm, inputs = _synth_pair("vol_tflow_shared", dtype=BF)
    (wav_j, _), (wav_t, _) = _infer_pair(jm, params, tm, inputs)
    assert wav_j.dtype == jnp.bfloat16
    assert float(wav_t.float().abs().max()) > 1e-3
    _assert_rel(wav_t, wav_j, E2E_REL)


# ---------------------------------------------------- (b) building the options
def test_config_options_build_their_modules():
    """Each option builds the module it names; the tiny template's config
    sets the template's values."""

    def build(case):
        return factory.build_synthesizer(tiny_hps(**SYNTH_CASES[case]), "cpu", fused_tail=True)

    assert isinstance(build("vol_embedding").emb_vol, torch.nn.Linear)
    assert isinstance(build("transformer_flow").flow, TransformerCouplingBlock)
    shared = build("flow_share_parameter").flow
    assert all(layer.enc is shared.wn for layer in shared.flows[::2])
    dec = build("depthwise_conv").dec
    assert not dec.fused and isinstance(dec.resblocks[0].convs1[0], SeparableConv1d)
    assert isinstance(build("resblock2").dec.resblocks[0], ResBlock2)
    dec = build("snake").dec
    assert dec.snake and not dec.fused and isinstance(dec.snakes[0], SnakeAlias)
    assert isinstance(dec.resblocks[0].activations[0], SnakeAlias)
    tiny = pcfg.tiny_config()
    assert (tiny.model.filter_channels, tiny.model.upsample_initial_channel) == (512, 400)
    assert tiny.model.use_depthwise_conv and tiny.model.flow_share_parameter


def test_random_init_draws_what_starts_at_zero():
    hps = tiny_hps(**SYNTH_CASES["vol_tflow_shared"], **{"model.vocoder_name": "nsf-snake-hifigan"})
    model = factory.build_synthesizer(hps, "cpu", fused_tail=True)
    assert float(model.flow.flows[0].post.weight.detach().abs().max()) == 0.0  # the reference's zero init
    factory.init_random_(model, torch.Generator().manual_seed(0))
    zero = [name for name, p in model.named_parameters() if p.dim() > 1 and float(p.detach().abs().max()) == 0.0]
    assert not zero, zero
    snake = model.dec.snakes[0].act
    assert float(snake.alpha.detach().abs().min()) > 0 and float(snake.beta.detach().abs().min()) > 0


# ------------------------------------------------------------------ (c) Svc
@pytest.fixture
def noise_off(monkeypatch):
    """Both packages' synthesizer dispatch with its noise off."""
    for cls in (jsvc_mod.Svc, tsvc_mod.Svc):
        monkeypatch.setattr(cls, "_run_synth_batch",
                            functools.partialmethod(cls._run_synth_batch, sample_noise=False))


@pytest.fixture(scope="module")
def vol_svc_pair(tmp_path_factory):
    """test_torch_slice.svc_pair's harness for a vol_embedding model: one
    G_0.pth (the port's seeded weights) in both packages, and one tiny
    speech encoder, the port's, for both (the encoders are held against
    each other in test_torch_modules.py), so that the units are equal and
    the synthesizers and their volume paths are compared alone."""
    from sovits_tpu.infer.svc import Svc as JaxSvc
    from sovits_tpu_torch.encoders.factory import SpeechEncoder
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from sovits_tpu_torch.infer.svc import Svc
    from tests.test_torch_modules import TINY_W2V

    tmp = tmp_path_factory.mktemp("vol_svc_pair")
    hps = tiny_hps(**SYNTH_BASE, **{"model.ssl_dim": TINY_W2V["d_model"], "model.vol_embedding": True})
    scfg.save_config(hps, tmp / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True),
                                 torch.Generator().manual_seed(2))
    torch.save({"model": model.state_dict(), "iteration": 0}, tmp / "G_0.pth")
    m = hps.model
    template = jax.tree.map(jnp.asarray, from_torch.synthesizer(
        {k: v.numpy() for k, v in model.state_dict().items()}, vol_embedding=True,
        n_upsamples=len(m.upsample_rates), n_resblock_kernels=len(m.resblock_kernel_sizes)))
    net = factory.init_random_(Wav2Vec2Encoder(Wav2Vec2Config(**TINY_W2V)), torch.Generator().manual_seed(3))
    encoder = SpeechEncoder("vec768l12", net, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfactory, "init_synthesizer_params", lambda *a, **k: template)
        jsvc = JaxSvc(str(tmp / "G_0.pth"), str(tmp / "config.json"), encoder=encoder)
    tsvc = Svc(str(tmp / "G_0.pth"), str(tmp / "config.json"), encoder=encoder, device="cpu")
    return jsvc, tsvc


def test_svc_infer_with_volume_matches_jax(vol_svc_pair, noise_off):
    jsvc, tsvc = vol_svc_pair
    sr = tsvc.target_sample
    clip = _voiced(1.3, sr, 9)
    item_j = jsvc._prepare_chunk(0, 0, clip, sr, 0.0, False, "yin", 0.05)
    item_t = tsvc._prepare_chunk(0, 0, clip, sr, 0.0, False, "yin", 0.05)
    assert item_t["vol"].shape == (item_t["n_frames"],)
    np.testing.assert_allclose(item_t["vol"], item_j["vol"][0], rtol=1e-6, atol=1e-7)
    kw = dict(noice_scale=0.0, f0_predictor="yin")
    got, n_t, frames_t = tsvc.infer(0, 0, clip, sr=sr, **kw)
    want, n_j, frames_j = jsvc.infer(0, 0, clip, sr=sr, **kw)
    assert (n_t, frames_t) == (n_j, frames_j) and got.shape == (frames_t * tsvc.hop_size,)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)


def test_slice_inference_with_volume_matches_jax(vol_svc_pair, noise_off):
    jsvc, tsvc = vol_svc_pair
    sr = tsvc.target_sample
    song = _song(sr, (5.5, 5.0), 1.0, seed=4)  # two chunks of bucket 1024: one batch of two
    kw = dict(noice_scale=0.0, f0_predictor="yin")
    got = tsvc.slice_inference(song, sr, 0, 0, **kw)
    want = jsvc.slice_inference(song, sr, 0, 0, **kw)
    assert got.shape == want.shape and np.isfinite(got).all() and np.abs(got).max() > 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)


def test_realtime_vc_with_volume(vol_svc_pair):
    """RealTimeVC streams through Svc.infer, whose volume path the test
    above holds against the JAX package: finite chunks of chunk_len."""
    _jsvc, tsvc = vol_svc_pair
    sr = tsvc.target_sample
    stream = _voiced(3 * 16000 / sr, sr, 7)
    rt = tsvc_mod.RealTimeVC()
    for i in range(3):
        got = rt.process(tsvc, 0, 0, stream[i * 16000 : (i + 1) * 16000], sr, f0_predictor="yin")
        assert got.shape == (rt.chunk_len,) and np.isfinite(got).all() and np.abs(got).max() > 0


def test_cli_converts_with_a_volume_model(vol_svc_pair, tmp_path, monkeypatch):
    """The infer CLI on the CPU with a vol_embedding G_0.pth: each chunk's
    volume is computed, and the written song has the input's length."""
    from scipy.io import wavfile

    from sovits_tpu_torch.cli import infer as cli
    from sovits_tpu_torch.encoders import factory as enc_factory

    _jsvc, tsvc = vol_svc_pair
    pcfg.save_config(tsvc.hps, tmp_path / "config.json")
    torch.save({"model": tsvc.model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    sr = tsvc.target_sample
    song = _song(sr, (5.5, 5.0), 1.0, seed=10)
    wavfile.write(tmp_path / "song.wav", sr, (song * 32767).astype(np.int16))
    monkeypatch.setattr(enc_factory, "get_speech_encoder", lambda name, device="cuda": tsvc.encoder)
    volumes = []
    monkeypatch.setattr(tsvc_mod, "energy", lambda *a: volumes.append(a[0].shape) or energy(*a))
    monkeypatch.chdir(tmp_path)
    cli.main(["-m", "G_0.pth", "-c", "config.json", "-n", "song.wav", "-f0p", "yin", "-d", "cpu"])
    out_sr, audio = wavfile.read(tmp_path / "results" / "song_0key_0_sovits_yin.wav")
    assert len(volumes) == 2  # the song's two chunks
    assert out_sr == sr and abs(len(audio) - len(song)) <= 2 * tsvc.hop_size
    assert np.abs(audio).max() > 0
