"""The ported voice-conversion slice as a whole vs the JAX package (CPU).

(a) Synthesizer.infer, JAX vs port, same weights, noise off.
(b) Svc: one G_0.pth and one tiny encoder in both packages; DIO f0, units
    and audio over two clips in different length buckets.
(c) The port runs in a fresh process without importing jax or flax.
(d) The onnx speech encoders, which neither package runs, raise NotImplementedError.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu import config as scfg  # noqa: E402
from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.dsp.stft import mel_spectrogram  # noqa: E402
from sovits_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from tests.tiny import TINY_OVERRIDES, tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
AUDIO_ATOL = 1e-4  # fp32 on both sides; the sums run in a different order
MEL_L1 = 1e-3  # the repository's parity bar for audio (BASELINE.md)


def _log_mel(wav, hps):
    d = hps.data
    return np.asarray(mel_spectrogram(
        jnp.asarray(wav), d.filter_length, d.n_mel_channels, d.sampling_rate, d.hop_length,
        d.win_length, d.mel_fmin, d.mel_fmax,
    ))


def _port_weights(hps, seed=0):
    """Seeded port weights, their state_dict, and the same weights as a
    JAX param tree through the JAX package's own converter (no JAX init:
    compiling the init graph costs tens of seconds on the CPU)."""
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True),
                                 torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    m = hps.model
    params = from_torch.synthesizer(sd, n_upsamples=len(m.upsample_rates),
                                    n_resblock_kernels=len(m.resblock_kernel_sizes))
    return model, sd, jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def tiny_pair():
    hps = tiny_hps()
    tm, sd, params = _port_weights(hps)
    jm = jfactory.build_synthesizer(hps)
    rng = np.random.default_rng(0)
    b, t = 2, 40
    inputs = dict(
        c=rng.standard_normal((b, t, hps.model.ssl_dim)).astype(np.float32),
        f0=rng.uniform(100, 300, (b, t)).astype(np.float32),
        uv=(rng.random((b, t)) > 0.2).astype(np.float32),
        spk=np.array([0, 1], np.int64),
        lengths=np.array([t, t - 7], np.int64),
    )
    return hps, jm, params, sd, tm, inputs


def _run_pair(jm, params, tm, inputs, predict_f0):
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    infer = jax.jit(lambda p, c, f0, uv, spk, lengths: jm.apply(
        {"params": p}, c, f0, uv, spk, noise_scale=0.0, predict_f0=predict_f0,
        sample_noise=False, lengths=lengths, method=JaxSynthesizer.infer,
    ))
    wav_j, f0_j = infer(params, j["c"], j["f0"], j["uv"], j["spk"].astype(jnp.int32),
                        j["lengths"].astype(jnp.int32))
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    wav_t, f0_t = tm.infer(t["c"], t["f0"], t["uv"], t["spk"], noise_scale=0.0,
                           predict_f0=predict_f0, sample_noise=False, lengths=t["lengths"])
    return np.asarray(wav_j), np.asarray(f0_j), wav_t.numpy(), f0_t.numpy()


@pytest.mark.parametrize("predict_f0", [False, True], ids=["given-f0", "predicted-f0"])
def test_synthesizer_infer_matches_jax(tiny_pair, predict_f0):
    hps, jm, params, _sd, tm, inputs = tiny_pair
    wav_j, f0_j, wav_t, f0_t = _run_pair(jm, params, tm, inputs, predict_f0)
    assert wav_t.shape == wav_j.shape == (2, 40 * hps.data.hop_length, 1)
    assert np.isfinite(wav_t).all() and np.abs(wav_t).max() > 1e-3
    np.testing.assert_allclose(wav_t, wav_j, rtol=0, atol=AUDIO_ATOL)
    # predicted f0 goes through 10**x: compare relative to its Hz scale
    np.testing.assert_allclose(f0_t, f0_j, rtol=1e-5, atol=1e-3)
    mel_l1 = np.abs(_log_mel(wav_t[..., 0], hps) - _log_mel(wav_j[..., 0], hps)).mean()
    assert mel_l1 < MEL_L1, mel_l1


_CHILD = """
import importlib, json, pkgutil, sys
import numpy as np, torch
import sovits_tpu_torch
for mod in pkgutil.walk_packages(sovits_tpu_torch.__path__, "sovits_tpu_torch."):
    importlib.import_module(mod.name)
from sovits_tpu import config as scfg
from sovits_tpu_torch.models import factory
args = json.loads(sys.argv[1])
hps = scfg.default_config(**args["overrides"])
model = factory.build_synthesizer(hps, "cpu", fused_tail=True)
model.load_state_dict(torch.load(args["weights"]), strict=True)
x = {k: torch.from_numpy(v) for k, v in np.load(args["inputs"]).items()}
wav, _ = model.infer(x["c"], x["f0"], x["uv"], x["spk"], noise_scale=0.0,
                     sample_noise=False, lengths=x["lengths"])
np.save(args["out"], wav.numpy())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not leaked, leaked
"""


def test_port_runs_without_jax(tiny_pair, tmp_path):
    _hps, _jm, _params, sd, tm, inputs = tiny_pair
    torch.save(tm.state_dict(), tmp_path / "w.pt")
    np.savez(tmp_path / "in.npz", **inputs)
    args = dict(overrides=TINY_OVERRIDES, weights=str(tmp_path / "w.pt"),
                inputs=str(tmp_path / "in.npz"), out=str(tmp_path / "out.npy"))
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(args)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    want, _ = tm.infer(t["c"], t["f0"], t["uv"], t["spk"], noise_scale=0.0, sample_noise=False,
                       lengths=t["lengths"])
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- (b) Svc
def _voiced(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    inst_f = 170.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    wav = 0.25 * np.sin(2 * np.pi * np.cumsum(inst_f) / sr) + 0.02 * rng.standard_normal(len(t))
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def svc_pair(tmp_path_factory):
    from sovits_tpu.encoders import wav2vec2 as jw2v
    from sovits_tpu.encoders.factory import JaxSpeechEncoder
    from sovits_tpu.f0.dio import DioF0Predictor as JaxDio
    from sovits_tpu.infer.svc import Svc as JaxSvc
    from sovits_tpu_torch.encoders.factory import SpeechEncoder
    from sovits_tpu_torch.f0.dio import DioF0Predictor as PortDio
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from sovits_tpu_torch.infer.svc import Svc
    from tests.test_torch_modules import TINY_W2V

    tmp = tmp_path_factory.mktemp("svc_pair")
    hps = tiny_hps(**{"model.ssl_dim": TINY_W2V["d_model"]})
    scfg.save_config(hps, tmp / "config.json")
    model, _sd, template = _port_weights(hps, seed=1)
    torch.save({"model": model.state_dict(), "iteration": 0}, tmp / "G_0.pth")

    jcfg = jw2v.Wav2Vec2Config(**TINY_W2V)
    enc_params = jax.tree.map(np.asarray, jw2v.Wav2Vec2Encoder(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16000)))["params"])
    jax_enc = JaxSpeechEncoder("vec768l12", {"params": enc_params}, jcfg, pad=False)
    tcfg = Wav2Vec2Config(**TINY_W2V)
    net = Wav2Vec2Encoder(tcfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax.wav2vec2(enc_params, tcfg).items()})
    port_enc = SpeechEncoder("vec768l12", net, "cpu")

    # The JAX Svc initialises a param tree only as the template that
    # load_torch_generator fills from G_0.pth; hand it the converted tree
    # instead of compiling the init graph (tens of seconds on the CPU).
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfactory, "init_synthesizer_params", lambda *a, **k: template)
        jsvc = JaxSvc(str(tmp / "G_0.pth"), str(tmp / "config.json"), encoder=jax_enc)
    dio = JaxDio(hop_length=hps.data.hop_length, sampling_rate=hps.data.sampling_rate)
    dio.exact = True  # the float64 numpy oracle the native library is held to
    jsvc.f0_predictor_object = dio
    tsvc = Svc(str(tmp / "G_0.pth"), str(tmp / "config.json"), encoder=port_enc, device="cpu")
    port_dio = PortDio(hop_length=hps.data.hop_length, sampling_rate=hps.data.sampling_rate)
    port_dio.exact = True  # the full-rate native path, held to the same oracle
    tsvc.f0_predictor_object = port_dio
    return jsvc, tsvc


def test_svc_matches_jax(svc_pair):
    jsvc, tsvc = svc_pair
    sr = tsvc.target_sample
    clips = [_voiced(1.0, sr, 0), _voiced(1.5, sr, 1)]  # 125 and 187 frames: buckets 128, 256
    n_spk = tsvc.hps.model.n_speakers
    items = {}
    for name, svc in (("jax", jsvc), ("port", tsvc)):
        items[name] = [svc._prepare_chunk(0, 0, w, sr, 0.0, False, "dio", 0.05) for w in clips]
    buckets = [next(b for b in (128, 256, 512) if b >= it["n_frames"]) for it in items["port"]]
    assert buckets == [128, 256]
    for ij, it in zip(items["jax"], items["port"]):
        assert ij["n_frames"] == it["n_frames"]
        assert (it["uv"] > 0).mean() > 0.5  # DIO found the voiced tone
        np.testing.assert_allclose(it["f0"], ij["f0"], rtol=1e-7, atol=1e-6)
        np.testing.assert_array_equal(it["uv"], ij["uv"])
        np.testing.assert_allclose(it["c"], ij["c"], rtol=0, atol=1e-4)
    # a per-frame speaker mix (the _speaker_embedding mix path) on the first clip
    first = items["port"][0]
    mix = np.zeros((first["n_frames"], n_spk), np.float32)
    mix[:, 0] = np.linspace(1.0, 0.0, first["n_frames"])
    mix[:, 1] = 1.0 - mix[:, 0]
    batch = items["port"] + [dict(first, spk=("mix", mix))]
    # the same inputs on both sides, so the synthesizers are compared alone
    audio_j = jsvc._run_synth_batch(batch, 0.0, False, 52468, sample_noise=False)
    audio_t = tsvc._run_synth_batch(batch, 0.0, False, 52468, sample_noise=False)
    # the mix path was taken (with random weights the speaker moves the audio only a little)
    assert np.abs(audio_t[2] - audio_t[0]).max() > 1e-6
    for aj, at, it in zip(audio_j, audio_t, batch):
        assert at.shape == aj.shape == (it["n_frames"] * tsvc.hop_size,)
        assert np.isfinite(at).all() and np.abs(at).max() > 1e-4
        np.testing.assert_allclose(at, aj, rtol=0, atol=AUDIO_ATOL)


# ----------------------------------------------------- (d) unsupported
@pytest.mark.parametrize("name", ["whisper-ppg", "wavlmbase+", "dphubert"])
def test_unsupported_front_ends_raise(name):
    """Every encoder of the JAX package is ported (test_torch_ppg_encoders.py),
    as is every f0 predictor (test_torch_f0nets.py); the onnx variants, which
    neither package runs, raise NotImplementedError naming the encoder."""
    import re

    from sovits_tpu_torch.encoders.factory import get_speech_encoder

    with pytest.raises(NotImplementedError, match=re.escape(name)):
        get_speech_encoder(f"{name}-onnx", device="cpu")
