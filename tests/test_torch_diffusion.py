"""The port's shallow-diffusion stack vs the JAX package (CPU).

(a) The schedule's tables (exact in float64), the step embedding, one
    denoiser call and Unit2Mel's condition (atol 1e-5).
(b) Every sampler of the dispatch, each from the same start: the q-sample
    noise is patched to one array on both sides (the JAX noise cannot be
    drawn in torch), and for ddpm the step noise to zeros. Max-abs within
    1e-4 of the JAX output's peak.
(c) The nvSTFT mel at keyshift 0 and +-2 (atol 1e-4 on the log-mel); the
    mel vocoder, fused in the port against JAX's unfused one, and the
    enhancer at adaptive keys 0 and 2 (within 1e-4 of the wave's peak).
(d) The weight bridge: port state_dicts through the JAX package's
    converter and back; a so-vits-svc vocoder checkpoint without ``cond``
    and a diffusion checkpoint with its schedule buffers load strictly.
(e) DiffusionRefiner.refine, and Svc.infer (shallow diffusion,
    only_diffusion, the enhancer) and slice_inference with shallow
    diffusion against the JAX Svc: the synthesizer's noise off in both
    (``sample_noise=False``, as test_torch_infer.py) and the q-sample noise
    patched to one array. Audio within 1e-3 of its peak, log-mel L1 below
    1e-3 (the BASELINE.md bar). f0 from yin, which is bit-equal in the two
    packages.
(f) The errors both packages raise, and the infer CLI with -shd, -od and
    -eh on the CPU with a diffusion model saved as the JAX trainer's .npz
    and as a so-vits-svc .pt.

Sizes: the tiny Svc of test_torch_slice.py (8 kHz, hop 64, 64-wide
units), a 2-layer Unit2Mel of 32 channels over 16 mels and 100 steps, and
a 3-stage vocoder at 8 kHz whose 32- and 16-wide stages run the fused trio.
"""

import functools
import json
import logging

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from sovits_tpu.cli.tools import flatten_params  # noqa: E402
from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.infer import svc as jsvc_mod  # noqa: E402
from sovits_tpu.infer.diffusion_wrapper import DiffusionRefiner as JaxRefiner  # noqa: E402
from sovits_tpu.infer.enhancer import Enhancer as JaxEnhancer  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu.models.diffusion import gaussian as jgauss  # noqa: E402
from sovits_tpu.models.diffusion import unit2mel as junit2mel  # noqa: E402
from sovits_tpu.models.diffusion import vocoder as jvocoder  # noqa: E402
from sovits_tpu.models.diffusion import wavenet as jwavenet  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.infer import svc as tsvc_mod  # noqa: E402
from sovits_tpu_torch.infer.diffusion_wrapper import DiffusionRefiner  # noqa: E402
from sovits_tpu_torch.infer.enhancer import Enhancer  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.models.diffusion import gaussian as tgauss  # noqa: E402
from sovits_tpu_torch.models.diffusion import vocoder as tvocoder  # noqa: E402
from sovits_tpu_torch.models.diffusion import wavenet as twavenet  # noqa: E402
from sovits_tpu_torch.models.diffusion.unit2mel import Unit2Mel  # noqa: E402
from sovits_tpu_torch.ops.fused_stage import TRIO_CHANNELS  # noqa: E402
from tests.test_torch_slice import MEL_L1, _log_mel, _voiced, svc_pair  # noqa: E402,F401
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

VOC = {"sampling_rate": 8000, "num_mels": 16, "n_fft": 128, "win_size": 128, "hop_size": 64,
       "fmin": 40, "fmax": 4000, "upsample_rates": [4, 4, 4], "upsample_initial_channel": 64,
       "upsample_kernel_sizes": [8, 8, 8]}
U2M = dict(input_channel=64, n_spk=4, use_pitch_aug=True, out_dims=16, n_layers=2, n_chans=32,
           n_hidden=24, timesteps=100, k_step_max=0)
SAMPLE_REL = 1e-4  # a sampler's or the vocoder's output, max-abs over the JAX output's peak
SVC_REL = 1e-3  # a whole request's audio


def _fixed(shape) -> np.ndarray:
    """The noise both packages are given: N(0, 1), fixed by its shape."""
    return np.random.default_rng(sum(shape) * 31 + len(shape)).standard_normal(shape).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    """The q-sample noise of both packages patched to _fixed (JAX [B, T, M],
    the port [B, M, T]). Returns the port's patch, which counts its calls."""
    orig = jgauss.DiffusionSchedule.q_sample
    monkeypatch.setattr(jgauss.DiffusionSchedule, "q_sample",
                        lambda self, x, t, noise: orig(self, x, t, jnp.asarray(_fixed(noise.shape))))
    calls = []

    def port(shape, generator, device):
        calls.append(tuple(shape))
        b, m, t = shape
        return torch.from_numpy(_fixed((b, t, m)).transpose(0, 2, 1).copy()).to(device)

    monkeypatch.setattr(tgauss, "randn", port)
    return calls


@pytest.fixture
def noise_off(monkeypatch):
    """Both packages' synthesizer dispatch with its noise off."""
    for cls in (jsvc_mod.Svc, tsvc_mod.Svc):
        monkeypatch.setattr(cls, "_run_synth_batch",
                            functools.partialmethod(cls._run_synth_batch, sample_noise=False))


def _seeded(module, seed):
    return factory.init_random_(module, torch.Generator().manual_seed(seed)).eval()


def _numpy_sd(module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def u2m_pair():
    """The port's Unit2Mel with seeded weights, and the JAX Unit2Mel with
    the same weights through the JAX package's converter."""
    tm = _seeded(Unit2Mel(**U2M), 3)
    jm = junit2mel.Unit2Mel(**U2M)
    params = jax.tree.map(jnp.asarray, from_torch.unit2mel(_numpy_sd(tm), n_layers=U2M["n_layers"]))
    return jm, params, tm


def _inputs(b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    return dict(units=rng.standard_normal((b, t, 64)).astype(np.float32),
                f0=rng.uniform(100, 300, (b, t)).astype(np.float32),
                vol=rng.uniform(0.0, 0.3, (b, t)).astype(np.float32),
                mel=rng.uniform(-10.0, 1.0, (b, t, 16)).astype(np.float32))


# ---------------------------------------------------------------- (a) parts
def test_schedule_tables_match_jax():
    for kw in (dict(), dict(timesteps=100, k_step=40, max_beta=0.03)):
        j, t = jgauss.DiffusionSchedule(**kw), tgauss.DiffusionSchedule(**kw)
        for name in ("betas", "alphas_cumprod", "posterior_variance", "posterior_log_variance",
                     "posterior_mean_coef1", "posterior_mean_coef2"):
            got, want = getattr(t, name), getattr(j, name)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)
        for t_start, steps in ((kw.get("timesteps", 1000), 10), (40, 7)):
            for key, want in j.solver_times(t_start, steps).items():
                np.testing.assert_array_equal(t.solver_times(t_start, steps)[key], want)


def test_step_embedding_matches_jax():
    steps = np.array([0.0, 3.5, 42.0, 99.0], np.float32)
    want = np.asarray(jax.jit(lambda s: jwavenet.sinusoidal_pos_emb(s, 32))(jnp.asarray(steps)))
    got = twavenet.sinusoidal_pos_emb(torch.from_numpy(steps), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(twavenet.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jwavenet.mish(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_denoiser_matches_jax(u2m_pair):
    jm, params, tm = u2m_pair
    rng = np.random.default_rng(1)
    spec = rng.standard_normal((2, 24, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 24, 24)).astype(np.float32)
    t = np.array([3.0, 71.5], np.float32)
    den = jwavenet.DiffusionWaveNet(in_dims=16, n_layers=2, n_chans=32, n_hidden=24)
    want = np.asarray(jax.jit(lambda p, x, s, c: den.apply({"params": p}, x, s, c))(
        params["denoiser"], spec, t, cond))
    with torch.no_grad():
        got = tm.decoder["denoise_fn"](torch.from_numpy(spec.transpose(0, 2, 1).copy()),
                                       torch.from_numpy(t),
                                       torch.from_numpy(cond.transpose(0, 2, 1).copy()))
    got = got.numpy().transpose(0, 2, 1)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("spk", ["id", "static-mix", "per-frame-mix", "aug-shift"])
def test_condition_matches_jax(u2m_pair, spk):
    jm, params, tm = u2m_pair
    x = _inputs()
    rng = np.random.default_rng(2)
    spk_id, aug = {
        "id": (np.array([1, 3], np.int32), None),
        "static-mix": (rng.dirichlet(np.ones(4), 2).astype(np.float32), None),
        "per-frame-mix": (rng.dirichlet(np.ones(4), (2, 24)).astype(np.float32), None),
        "aug-shift": (np.array([0, 2], np.int32), np.array([-3.0, 7.5], np.float32)),
    }[spk]
    want = np.asarray(jax.jit(lambda p, u, f, v, s, a: jm.apply(
        {"params": p}, u, f, v, s, a, method=junit2mel.Unit2Mel.condition))(
        params, x["units"], x["f0"], x["vol"], spk_id, aug))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        got = tm.condition(t(x["units"]), t(x["f0"]), t(x["vol"]),
                           t(spk_id.astype(np.int64)) if spk_id.dtype == np.int32 else t(spk_id),
                           t(aug)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_training_loss_matches_jax(u2m_pair):
    """The training branch's loss (Unit2Mel(infer=False) -> p_losses) on the
    same normalised spectrogram, steps and noise."""
    jm, params, tm = u2m_pair
    x = _inputs()
    rng = np.random.default_rng(4)
    t = np.array([7, 93], np.int32)
    noise = rng.standard_normal((2, 24, 16)).astype(np.float32)
    jsched, tsched = jm.schedule, tm.schedule
    cond = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x["units"], x["f0"], x["vol"],
                                                 method=junit2mel.Unit2Mel.condition))(params))
    den = jwavenet.DiffusionWaveNet(in_dims=16, n_layers=2, n_chans=32, n_hidden=24)
    want = float(jax.jit(lambda p: jsched.p_losses(
        lambda a, b, c: den.apply({"params": p}, a, b, c), jsched.norm_spec(x["mel"]), t, cond,
        noise))(params["denoiser"]))
    cf = lambda a: torch.from_numpy(a.transpose(0, 2, 1).copy())  # noqa: E731
    with torch.no_grad():
        got = float(tsched.p_losses(tm.decoder["denoise_fn"], tsched.norm_spec(cf(x["mel"])),
                                    torch.from_numpy(t.astype(np.int64)), cf(cond), cf(noise)))
        g = torch.Generator().manual_seed(0)
        drawn = tm(*(torch.from_numpy(x[k]) for k in ("units", "f0", "vol")),
                   gt_spec=torch.from_numpy(x["mel"]), infer=False, generator=g)
    assert abs(got - want) <= 1e-5 * want, (got, want)
    assert drawn.dim() == 0 and torch.isfinite(drawn) and drawn > 0


# ------------------------------------------------------------- (b) samplers
# (method, k_step, speedup): every name the dispatch knows; the step counts
# take the branches (under 10 steps dpm-solver++ ends on order 1; the
# singlestep plans 3-3-3-1, 3-3-2-1 and 3-3-2; two-step UniPC skips its loop)
SAMPLERS = [
    ("ddpm", 20, 1), ("ddim", 100, 10), ("pndm", 100, 10),
    ("dpm-solver", 100, 10), ("dpm-solver++", 60, 10),
    ("dpm-solver++-1s", 50, 10), ("dpm-solver++-2s", 90, 10), ("dpm-solver++-3s", 100, 10),
    ("dpm-solver++-3s", 90, 10), ("dpm-solver++-3s", 80, 10),
    ("unipc", 100, 10), ("unipc-bh1", 100, 10), ("unipc-bh2", 20, 10), ("unipc-vary", 100, 10),
    ("dpm-solver++-adaptive", 100, 10), ("dpm-solver++-adaptive-3", 100, 10),
]


@pytest.mark.parametrize("method,k_step,speedup", SAMPLERS, ids=lambda v: str(v))
def test_sampler_matches_jax(u2m_pair, same_noise, monkeypatch, method, k_step, speedup):
    jm, params, tm = u2m_pair
    x = _inputs()
    spk = np.array([0, 2], np.int32)
    if method == "ddpm":  # the step noise off on both sides; the q-sample noise stays patched
        monkeypatch.setattr(jgauss.jax.random, "normal", lambda key, shape, *a, **k: jnp.zeros(shape))
        q_noise = tgauss.randn

        def step_noise_off(shape, generator, device):
            if not same_noise:
                return q_noise(shape, generator, device)
            same_noise.append(tuple(shape))
            return torch.zeros(tuple(shape), device=device)

        monkeypatch.setattr(tgauss, "randn", step_noise_off)
    run = jax.jit(lambda p, u, f, v, s, mel: jm.apply(
        {"params": p}, u, f, v, spk_id=s, gt_spec=mel, infer=True, infer_speedup=speedup,
        sampler=None if method == "ddpm" else method, k_step=k_step,
        rngs={"noise": jax.random.PRNGKey(0)}))
    want = np.asarray(run(params, x["units"], x["f0"], x["vol"], spk, x["mel"]))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        got = tm(t["units"], t["f0"], t["vol"], spk_id=torch.from_numpy(spk.astype(np.int64)),
                 gt_spec=t["mel"], infer=True, infer_speedup=speedup,
                 method=None if method == "ddpm" else method, k_step=k_step).numpy()
    assert same_noise[0] == (2, 16, 24)
    if method == "ddpm":
        assert len(same_noise) == 1 + k_step - 1  # one q-sample draw, a step draw for each i > 0
    assert got.shape == want.shape == (2, 24, 16)
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= SAMPLE_REL * peak, (np.abs(got - want).max(), peak)


def test_adaptive_sampler_converges(u2m_pair, caplog):
    """The adaptive solver lands on t_0 within its iteration bound: it
    logs no max_iters exit."""
    _jm, _params, tm = u2m_pair
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    sched = tm.schedule
    with torch.no_grad(), caplog.at_level(logging.WARNING, logger=tgauss.__name__):
        cond = tm.condition(x["units"], x["f0"], x["vol"]).transpose(1, 2)
        start = torch.from_numpy(_fixed((2, 16, 24)))
        for order in (2, 3):
            out = sched.sample_dpmpp_adaptive(tm.decoder["denoise_fn"], start, 100, cond, order=order)
            assert torch.isfinite(out).all()
    assert not [r for r in caplog.records if "max_iters" in r.getMessage()]


# ------------------------------------------------- (c) mel, vocoder, enhancer
@pytest.mark.parametrize("keyshift", [0, 2, -2])
def test_nv_mel_matches_jax(keyshift):
    y = _voiced(0.5, 44100, 3)[None]
    want = np.asarray(jax.jit(lambda a: jvocoder.nv_mel_spectrogram(a, keyshift=keyshift))(y))
    got = tvocoder.nv_mel_spectrogram(torch.from_numpy(y), keyshift=keyshift).numpy()
    assert got.shape == want.shape == (1, {0: 43, 2: 38, -2: 48}[keyshift], 128)  # hop 512 x 2^(k/12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def vocoder_files(tmp_path_factory):
    """A seeded tiny so-vits-svc vocoder checkpoint ({"generator": sd}, no
    ``cond``) with its config.json, and the same weights as JAX params."""
    tmp = tmp_path_factory.mktemp("vocoder")
    net = _seeded(tvocoder.build_generator({**tvocoder.DEFAULT_NSF_CONFIG, **VOC}, "cpu"), 4)
    sd = net.state_dict()
    assert not any(k.startswith("cond.") for k in sd)
    torch.save({"generator": sd}, tmp / "model")
    (tmp / "config.json").write_text(json.dumps(VOC))
    params = jax.tree.map(jnp.asarray, from_torch.nsf_hifigan_generator(
        {k: v.numpy() for k, v in sd.items()}, n_upsamples=3, n_kernels=3))
    return tmp / "model", params


def test_vocoder_fused_matches_jax_unfused(vocoder_files):
    ckpt, params = vocoder_files
    port = tvocoder.NsfHifiGANVocoder(str(ckpt), device="cpu")
    assert port.h["sampling_rate"] == 8000  # config.json beside the checkpoint
    assert port.net.fused and port.net.cond is None
    assert [c for c in port.net.stage_channels if c in TRIO_CHANNELS] == [32, 16]
    ref = jvocoder.NsfHifiGANVocoder(None, config=VOC)
    ref.params = params
    rng = np.random.default_rng(5)
    mel = rng.uniform(-9.0, 0.0, (2, 40, 16)).astype(np.float32)
    f0 = np.where(rng.random((2, 40)) < 0.2, 0.0, rng.uniform(100, 300, (2, 40))).astype(np.float32)
    want = np.asarray(ref.infer(jnp.asarray(mel), jnp.asarray(f0)))[..., 0]
    got = port.infer(torch.from_numpy(mel), torch.from_numpy(f0))[:, 0].numpy()
    assert got.shape == want.shape == (2, 40 * 64)
    peak = np.abs(want).max()
    assert peak > 1e-3 and np.abs(got - want).max() <= SAMPLE_REL * peak


@pytest.mark.parametrize("adaptive_key", [0, 2])
def test_enhancer_matches_jax(vocoder_files, adaptive_key):
    ckpt, _params = vocoder_files
    sr, hop = 8000, 64
    wav = _voiced(1.0, sr, 6)
    frames = len(wav) // hop
    f0 = (170.0 + 30.0 * np.sin(np.arange(frames) / 20.0)).astype(np.float32)
    f0[:10] = 0.0
    got, got_sr = Enhancer("nsf-hifigan", str(ckpt), device="cpu").enhance(
        wav, sr, f0, hop, adaptive_key=adaptive_key)
    want, want_sr = JaxEnhancer("nsf-hifigan", str(ckpt)).enhance(wav, sr, f0, hop,
                                                                  adaptive_key=adaptive_key)
    assert got_sr == want_sr == sr and got.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 1e-3 and np.abs(got - want).max() <= SAMPLE_REL * peak


# ------------------------------------------------------------ (d) the bridge
def test_weight_bridge_round_trips(u2m_pair, vocoder_files):
    """Port state_dict -> the JAX package's converter -> the port's inverse
    gives back every key and value."""
    _jm, params, tm = u2m_pair
    sd = _numpy_sd(tm)
    back = from_jax.unit2mel(jax.tree.map(np.asarray, params))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])
    ckpt, gparams = vocoder_files
    gsd = {k: v.numpy() for k, v in torch.load(ckpt)["generator"].items()}
    gback: dict = {}
    from_jax.generator(gback, "", jax.tree.map(np.asarray, gparams))
    assert gback.keys() == gsd.keys()
    for k in gsd:
        np.testing.assert_allclose(gback[k], gsd[k], rtol=0, atol=0)


def test_diffusion_checkpoint_loads_with_schedule_buffers(u2m_pair, tmp_path):
    """A so-vits-svc diffusion checkpoint also holds GaussianDiffusion's
    buffers; they are dropped and the rest loads strictly, as does the JAX
    trainer's .npz."""
    from sovits_tpu_torch.train import diffusion as tdiff

    _jm, params, tm = u2m_pair
    sd = tm.state_dict()
    sched = tm.schedule
    buffers = {f"decoder.{k}": torch.tensor(getattr(sched, k), dtype=torch.float32)
               for k in ("betas", "alphas_cumprod", "posterior_variance")}
    buffers["decoder.spec_min"] = torch.full((1, 1, 1), -12.0)
    torch.save({"model": {**sd, **buffers}}, tmp_path / "model_0.pt")
    np.savez(tmp_path / "model_0.npz", **flatten_params(jax.tree.map(np.asarray, params)))
    args = tdiff.load_diffusion_config(_diffusion_config(tmp_path, "unused"))
    for name in ("model_0.pt", "model_0.npz"):
        load = tdiff.load_npz_unit2mel if name.endswith(".npz") else tdiff.load_torch_unit2mel
        loaded = load(tmp_path / name, args, 16, "cpu")
        for k, v in sd.items():
            torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


# ---------------------------------------------------- (e) refiner and Svc
def _diffusion_config(root, vocoder_ckpt, method="dpm-solver++", speedup=10):
    """A diffusion config.yaml for the tiny Unit2Mel, written as JSON (valid YAML)."""
    cfg = {"data": {"sampling_rate": 8000, "block_size": 64, "encoder_out_channels": 64},
           "model": {k: U2M[k] for k in ("n_layers", "n_chans", "n_hidden", "timesteps",
                                         "k_step_max", "n_spk", "use_pitch_aug")},
           "vocoder": {"type": "nsf-hifigan", "ckpt": str(vocoder_ckpt)},
           "infer": {"speedup": speedup, "method": method}}
    (root / "config.yaml").write_text(json.dumps(cfg))
    return root / "config.yaml"


@pytest.fixture(scope="module")
def diff_files(tmp_path_factory, u2m_pair, vocoder_files, svc_pair):
    """G_0.pth and config.json of svc_pair's tiny model, the tiny Unit2Mel
    as a so-vits-svc checkpoint and as the JAX trainer's .npz with its
    config.yaml, and the vocoder also at the enhancer's default path."""
    from sovits_tpu_torch import config as tcfg

    tmp = tmp_path_factory.mktemp("diffusion")
    _jsvc, tsvc = svc_pair
    tcfg.save_config(tsvc.hps, tmp / "config.json")
    torch.save({"model": tsvc.model.state_dict(), "iteration": 0}, tmp / "G_0.pth")
    _jm, params, tm = u2m_pair
    (tmp / "logs").mkdir()
    torch.save({"model": tm.state_dict()}, tmp / "logs" / "model_0.pt")
    np.savez(tmp / "logs" / "model_0.npz", **flatten_params(jax.tree.map(np.asarray, params)))
    ckpt, _ = vocoder_files
    enh = tmp / "pretrain" / "nsf_hifigan"
    enh.mkdir(parents=True)
    (enh / "model").write_bytes(ckpt.read_bytes())
    (enh / "config.json").write_text(json.dumps(VOC))
    _diffusion_config(tmp / "logs", enh / "model")
    return tmp


def _svcs(diff_files, svc_pair, monkeypatch, **kw):
    """A JAX and a port Svc over the same files, with the options ``kw``."""
    jsvc0, tsvc0 = svc_pair
    root = diff_files
    if kw.get("shallow_diffusion") or kw.get("only_diffusion"):
        kw = dict(diffusion_model_path=str(root / "logs" / "model_0.pt"),
                  diffusion_config_path=str(root / "logs" / "config.yaml"), **kw)
    kw.setdefault("enhancer_ckpt", str(root / "pretrain" / "nsf_hifigan" / "model"))
    monkeypatch.setattr(jfactory, "init_synthesizer_params", lambda *a, **k: jsvc0.params)
    jsvc = jsvc_mod.Svc(str(root / "G_0.pth"), str(root / "config.json"), encoder=jsvc0.encoder, **kw)
    # the same synthesizer, its params an argument: share the compiled
    # synthesizers across these Svcs rather than compile them for each
    jsvc._infer_jit = jsvc0._infer_jit
    tsvc = tsvc_mod.Svc(str(root / "G_0.pth"), str(root / "config.json"), encoder=tsvc0.encoder,
                        device="cpu", **kw)
    return jsvc, tsvc


def _close(got, want, hps):
    assert got.dtype == want.dtype and got.shape == want.shape
    peak = np.abs(want).max()
    assert np.isfinite(got).all() and peak > 1e-3
    assert np.abs(got - want).max() <= SVC_REL * peak, (np.abs(got - want).max(), peak)
    l1 = np.abs(_log_mel(got[None], hps) - _log_mel(want[None], hps)).mean()
    assert l1 < MEL_L1, l1


@pytest.mark.parametrize("second_encoding", [False, True], ids=["units", "second-encoding"])
def test_refiner_matches_jax(svc_pair, diff_files, same_noise, second_encoding):
    jsvc, tsvc = svc_pair
    model, cfg = diff_files / "logs" / "model_0.pt", diff_files / "logs" / "config.yaml"
    port, ref = DiffusionRefiner(str(model), str(cfg), device="cpu"), JaxRefiner(str(model), str(cfg))
    assert port.vocoder.h["sampling_rate"] == 8000 and port.model.schedule.k_step == 100
    wav = _voiced(1.0, 8000, 8)
    item = tsvc._prepare_chunk(0, 0, wav, 8000, 0.0, False, "yin", 0.05)
    audio = wav[: item["n_frames"] * 64]
    args = (audio, item["c"], item["f0"], None, np.asarray([2]), 50, second_encoding)
    got, want = port.refine(tsvc, *args), np.asarray(ref.refine(jsvc, *args))
    assert same_noise == [(1, 16, item["n_frames"])]
    _close(got, want, tsvc.hps)


SVC_CASES = {
    "shallow": (dict(shallow_diffusion=True), dict(k_step=60)),
    "only-diffusion": (dict(only_diffusion=True), dict(k_step=100, loudness_envelope_adjustment=0.5)),
    "enhance": (dict(nsf_hifigan_enhance=True), dict(enhancer_adaptive_key=2)),
}


@pytest.mark.parametrize("case", list(SVC_CASES))
def test_svc_infer_matches_jax(svc_pair, diff_files, same_noise, noise_off, monkeypatch, case):
    options, call = SVC_CASES[case]
    jsvc, tsvc = _svcs(diff_files, svc_pair, monkeypatch, **options)
    assert (tsvc.diffusion is None) == (case == "enhance")
    assert (tsvc.enhancer is None) == (case != "enhance")
    wav = _voiced(1.0, 8000, 9)  # the refiner test's length: JAX reuses its compiled ops
    kw = dict(noice_scale=0.0, f0_predictor="yin", **call)
    got, n_got, frames = tsvc.infer(0, 0, wav, **kw)
    want, n_want, _ = jsvc.infer(0, 0, wav, **kw)
    # the enhancer resamples to its adaptive rate and back
    assert n_got == n_want == (frames * 64 if case != "enhance" else n_want)
    assert len(same_noise) == (0 if case == "enhance" else 1)
    _close(got, np.asarray(want), tsvc.hps)


def test_slice_inference_shallow_diffusion_matches_jax(svc_pair, diff_files, same_noise, noise_off,
                                                       monkeypatch):
    from tests.test_torch_infer import _song

    jsvc, tsvc = _svcs(diff_files, svc_pair, monkeypatch, shallow_diffusion=True)
    song = _song(8000, (5.5, 5.5), 1.0, seed=11)  # two chunks of one length: one JAX compile
    kw = dict(noice_scale=0.0, f0_predictor="yin", k_step=40)
    got = tsvc.slice_inference(song, 8000, 0, 0, **kw)
    want = jsvc.slice_inference(song, 8000, 0, 0, **kw)
    assert len(same_noise) == 2  # one refine per chunk
    _close(got, want, tsvc.hps)


def test_shallow_diffusion_supersedes_the_enhancer(svc_pair, diff_files, monkeypatch):
    jsvc, tsvc = _svcs(diff_files, svc_pair, monkeypatch, shallow_diffusion=True,
                       nsf_hifigan_enhance=True)
    assert jsvc.enhancer is None and tsvc.enhancer is None
    assert jsvc.diffusion is not None and tsvc.diffusion is not None


# ------------------------------------------------------- (f) errors, the CLI
def test_unit2mel_errors_match_jax(u2m_pair):
    jm, params, _tm = u2m_pair
    x = _inputs(b=1, t=8)
    limited = dict(U2M, k_step_max=40)
    tm = _seeded(Unit2Mel(**limited), 3)
    jl = junit2mel.Unit2Mel(**limited)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    for gt, k_step, match in ((x["mel"], 60, "k_step_max"), (None, 40, "only run shallow")):
        with pytest.raises(ValueError, match=match):
            jl.apply({"params": params}, x["units"], x["f0"], x["vol"], gt_spec=gt, k_step=k_step,
                     rngs={"noise": jax.random.PRNGKey(0)})
        with pytest.raises(ValueError, match=match):
            tm(t["units"], t["f0"], t["vol"], gt_spec=None if gt is None else t["mel"], k_step=k_step)


def test_only_diffusion_without_a_model_raises(svc_pair, diff_files, monkeypatch):
    for make in ("jax", "port"):
        with pytest.raises(FileNotFoundError, match="only_diffusion"):
            if make == "jax":
                monkeypatch.setattr(jfactory, "init_synthesizer_params",
                                    lambda *a, **k: svc_pair[0].params)
                jsvc_mod.Svc(str(diff_files / "G_0.pth"), str(diff_files / "config.json"),
                             encoder=svc_pair[0].encoder, only_diffusion=True)
            else:
                tsvc_mod.Svc(str(diff_files / "G_0.pth"), str(diff_files / "config.json"),
                             encoder=svc_pair[1].encoder, device="cpu", only_diffusion=True)


@pytest.mark.parametrize("user", ["refiner", "enhancer"])
def test_missing_vocoder_checkpoint_raises(svc_pair, diff_files, tmp_path, user):
    """A vocoder checkpoint that is not on disk is an error, never random
    weights: for the refiner (its config's vocoder.ckpt) and the enhancer."""
    missing = tmp_path / "nsf_hifigan" / "model"
    with pytest.raises(FileNotFoundError, match="no vocoder checkpoint"):
        if user == "refiner":
            cfg = _diffusion_config(tmp_path, missing)
            DiffusionRefiner(str(diff_files / "logs" / "model_0.pt"), str(cfg), device="cpu")
        else:
            tsvc_mod.Svc(str(diff_files / "G_0.pth"), str(diff_files / "config.json"),
                         encoder=svc_pair[1].encoder, device="cpu", nsf_hifigan_enhance=True,
                         enhancer_ckpt=str(missing))


@pytest.mark.parametrize("flags", [
    ["-shd", "-dm", "logs/model_0.npz"],
    ["-shd", "-dm", "logs/model_0.pt", "-ks", "30", "-se"],
    ["-od", "-dm", "logs/model_0.pt", "-ks", "20"],
    ["-eh", "-eak", "2"],
], ids=["shd-npz", "shd-pt-se", "od", "eh"])
def test_cli_infer_with_diffusion(svc_pair, diff_files, monkeypatch, capsys, flags):
    from sovits_tpu_torch.cli import infer as cli
    from sovits_tpu_torch.encoders import factory as enc_factory
    from tests.test_torch_infer import _song

    _jsvc, tsvc = svc_pair
    monkeypatch.chdir(diff_files)
    monkeypatch.setattr(enc_factory, "get_speech_encoder", lambda name, device="cuda": tsvc.encoder)
    song = _song(8000, (5.5, 5.5), 1.0, seed=12)  # two chunks
    wavfile.write(diff_files / "song.wav", 8000, (song * 32767).astype(np.int16))
    stages = []
    for cls, name in ((DiffusionRefiner, "refine"), (Enhancer, "enhance")):
        fn = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, _fn=fn, _n=name, **k: stages.append(_n)
                            or _fn(self, *a, **k))
    cli.main(["-m", "G_0.pth", "-c", "config.json", "-n", "song.wav", "-dc", "logs/config.yaml",
              "-f0p", "yin", "-d", "cpu", *flags])
    out = diff_files / "results" / "song_0key_0_sovits_yin.wav"
    assert f"wrote {out.relative_to(diff_files)}" in capsys.readouterr().out
    sr, audio = wavfile.read(out)
    assert sr == 8000 and abs(len(audio) - len(song)) <= 2 * 64
    assert np.abs(audio).max() > 0
    assert stages == ["enhance" if "-eh" in flags else "refine"] * 2  # once per chunk
