"""so-vits-svc 4.1's model options trained by the port, against the JAX
package (CPU, tiny widths).

(a) One deterministic GAN step (``train_step``) of two option models
    against ``sovits_tpu.train.step.make_train_step`` on the same weights
    (JAX params filled from ``jax.eval_shape``, carried to the port through
    ``convert/from_jax.py``) and batch: the losses, both gradient norms and
    the updated G and D parameters at ``test_gan_step_matches_jax``'s bars.
    One model takes vol_embedding + the transformer flow + a shared flow +
    ResBlock2, the other the Snake vocoder + depthwise convs (the JAX
    resblocks patched as ``test_torch_configs.jax_separable`` does). The
    JAX step draws its own dropout, so its synthesizer is applied with
    ``deterministic=True``; its gradients are kept in the optimizer state.
(b) A dropout step of the transformer-flow model runs every causal FFT
    layer through ``FusedAttention`` with a keep mask, and the backward
    through ``fused_attention_bwd``.
(c) The user's path for a volume + transformer-flow model through the
    CLIs: ``preprocess_flist_config --vol_aug --use_transformer_flow``,
    ``preprocess_features`` (tiny vec768l12 checkpoint, yin), ``cli.train
    --max-steps 2`` with an evaluation, and a resume to step 3. The
    volume-augmented batches equal the JAX package's, and the G_3.pth loads
    into both packages' synthesizers, which convert 1 s alike with the
    noise off.
"""

import json
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from sovits_tpu.config import HParams as JaxHParams  # noqa: E402
from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu.train import checkpoint as jckpt  # noqa: E402
from sovits_tpu.train import data as jdata  # noqa: E402
from sovits_tpu.train import step as jstep  # noqa: E402
from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch.cli import preprocess_features as tpre  # noqa: E402
from sovits_tpu_torch.cli import preprocess_flist_config as tflist  # noqa: E402
from sovits_tpu_torch.cli import train as tcli_train  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.encoders import factory as tfactory  # noqa: E402
from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.nn.attention import MultiHeadAttention  # noqa: E402
from sovits_tpu_torch.ops import attention as tops  # noqa: E402
from sovits_tpu_torch.train import data as tdata  # noqa: E402
from sovits_tpu_torch.train.optim import make_optimizer  # noqa: E402
from sovits_tpu_torch.train.step import train_step  # noqa: E402
from tests.fairseq_fixture import make_fairseq_hubert_sd, save_as_torch_ckpt  # noqa: E402
from tests.test_torch_configs import _fill, jax_separable  # noqa: E402,F401
from tests.test_torch_encoders import CONVS  # noqa: E402
from tests.test_torch_modules import TINY_W2V  # noqa: E402
from tests.test_torch_train import TRAIN_OVERRIDES, _batch, _port_d, _tree_np  # noqa: E402
from tests.tiny import tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

T = torch.from_numpy
# one resblock kernel (of three dilations) cuts the JAX step's program to a
# third; the options' modules take three kernels in test_torch_configs.py
ONE_KERNEL = {"model.resblock_kernel_sizes": [3], "model.resblock_dilation_sizes": [[1, 3, 5]]}
STEP_CASES = {
    "vol_tflow_shared_resblock2": {"model.vol_embedding": True, "model.use_transformer_flow": True,
                                   "model.flow_share_parameter": True, "model.resblock": "2"},
    "snake_depthwise": {"model.vocoder_name": "nsf-snake-hifigan", "model.use_depthwise_conv": True},
}


def _option_hps(case):
    return tiny_hps(**TRAIN_OVERRIDES, **ONE_KERNEL, **STEP_CASES[case])


def _jax_g_params(jm, hps, seed=0):
    """The JAX synthesizer's params, filled by ``_fill`` from its shapes
    (no init program compiled)."""
    m, t = hps.model, hps.data.pad_to_frames
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1), "slice": jax.random.PRNGKey(2)},
        jnp.zeros((1, t, m.ssl_dim)), jnp.full((1, t), 220.0), jnp.ones((1, t)),
        jnp.zeros((1, t, hps.data.filter_length // 2 + 1)), jnp.zeros((1,), jnp.int32),
        jnp.full((1,), t, jnp.int32), vol=jnp.zeros((1, t)) if m.vol_embedding else None,
        deterministic=True))["params"]
    return _fill(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def jax_d():
    """The JAX discriminator (disc_tiny) with params filled from its shapes."""
    hps = _option_hps("snake_depthwise")
    jd = jfactory.build_discriminator(hps)
    seg = jnp.zeros((1, hps.train.segment_size, 1))
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(1), seg, seg))["params"]
    return jd, _fill(shapes, np.random.default_rng(1))


def _keeping_grads(tx):
    """``tx`` whose state also holds the last gradients it was given, so
    that the jitted JAX step hands them back."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _deterministic(jm):
    """``jm`` applied with ``deterministic=True`` whatever the step asks for."""
    def apply(variables, *args, deterministic=False, rngs=None, **kw):
        return jm.apply(variables, *args, deterministic=True, **kw)

    return types.SimpleNamespace(apply=apply)


def _jax_step(hps, g_params, jd, d_params, bt):
    """sovits_tpu.train.step.make_train_step's step, once, compiled."""
    jhps = JaxHParams(**hps.to_dict())
    jhps.train["packed_adamw"] = False  # optax.adamw itself (the packed one is its exact twin)
    tx = _keeping_grads(jstep.make_optimizer(jhps))
    step = jstep.make_train_step(_deterministic(jfactory.build_synthesizer(jhps)), jd, tx, tx, jhps)
    state = jstep.create_train_state(jax.tree.map(jnp.asarray, g_params), jax.tree.map(jnp.asarray, d_params),
                                     tx, tx)
    batch = {k: jnp.asarray(v, jnp.int32 if k in ("spk", "lengths") else None) for k, v in bt.items()}
    new, metrics = step(state, batch, jax.random.PRNGKey(0))
    return jax.device_get((new.g_params, new.d_params, new.g_opt_state[1], new.d_opt_state[1], metrics))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_option_gan_step_matches_jax(case, jax_d, jax_separable):
    hps = _option_hps(case)
    m = hps.model
    jd, d_params = jax_d
    g_params = _jax_g_params(jfactory.build_synthesizer(hps), hps)
    bt = _batch(hps)
    if m.vol_embedding:
        bt["volume"] = np.random.default_rng(8).uniform(0.0, 0.3, bt["f0"].shape).astype(np.float32)
    g_new, d_new, g_grads, d_grads, want = _jax_step(hps, g_params, jd, d_params, bt)

    phps = pcfg.HParams(**hps.to_dict())
    net_g = factory.build_synthesizer(phps, "cpu", fused_tail=False)
    net_g.load_state_dict({k: T(v) for k, v in from_jax.synthesizer(g_params, phps).items()}, strict=True)
    net_d = _port_d(phps, d_params)
    before = {id(p): p.detach().clone() for net in (net_g, net_d) for p in net.parameters()}
    got = train_step(net_g, net_d, make_optimizer(net_g.parameters(), phps),
                     make_optimizer(net_d.parameters(), phps), {k: T(v) for k, v in bt.items()}, phps,
                     deterministic=True)
    got = {k: float(v) for k, v in got.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    # test_gan_step_matches_jax's bars on the updated weights: 1e-6 (1% of
    # lr), where a weight may differ only if its JAX gradient is below 1e-7
    # (fp32 noise around a true 0), rarely, and within the step's bound. A
    # shared flow's net is one parameter set, named once by the port
    lr = hps.train.learning_rate
    n_noise = n_total = 0
    for net, new, grads in ((net_g, from_jax.synthesizer(_tree_np(g_new), phps),
                             from_jax.synthesizer(_tree_np(g_grads), phps)),
                            (net_d, from_jax.multi_period_discriminator(_tree_np(d_new)),
                             from_jax.multi_period_discriminator(_tree_np(d_grads)))):
        params = dict(net.named_parameters())
        assert set(params) <= set(new) and set(new) == set(net.state_dict())
        for k, p in params.items():
            p = p.detach().numpy()
            off = np.abs(p - new[k]) > 1e-6
            assert (np.abs(grads[k][off]) < 1e-7).all(), k
            n_noise += int(off.sum())
            n_total += off.size
            moved = np.abs(p - before[id(params[k])].numpy())
            assert moved.max() <= lr * 1.01 + 0.01 * lr * np.abs(p).max(), k
    assert n_noise < 1e-3 * n_total, (n_noise, n_total)
    if m.flow_share_parameter:  # one net, trained by every coupling
        assert net_g.flow.flows[0].enc is net_g.flow.flows[2].enc is net_g.flow.wn


def test_dropout_step_reaches_fused_attention(monkeypatch):
    """A training step with dropout (a generator, not deterministic) runs
    each causal layer of the transformer flow and of the F0 decoder through
    FusedAttention with a keep mask, and each one's backward through the
    fused backward; none takes the dense path."""
    hps = pcfg.HParams(**_option_hps("vol_tflow_shared_resblock2").to_dict())
    m = hps.model
    calls = {"fwd": [], "bwd": []}
    forward, backward = tops._forward, tops.fused_attention_bwd

    def spy_fwd(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal, want_lse):
        calls["fwd"].append((causal, drop_mask is not None, want_lse, q.shape[-1]))
        return forward(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal, want_lse)

    def spy_bwd(*args, **kw):
        calls["bwd"].append((kw["causal"], args[6] is not None))
        return backward(*args, **kw)

    monkeypatch.setattr(tops, "_forward", spy_fwd)
    monkeypatch.setattr(tops, "fused_attention_bwd", spy_bwd)
    mha = []  # every attention layer's call: fused (one _forward) or dense (none)
    mha_forward = MultiHeadAttention.forward
    monkeypatch.setattr(MultiHeadAttention, "forward", lambda self, *a, **k: mha.append(1) or mha_forward(
        self, *a, **k))
    init = torch.Generator().manual_seed(0)
    net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False), init)
    net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"), init)
    bt = _batch(hps)
    bt["volume"] = np.random.default_rng(8).uniform(0.0, 0.3, bt["f0"].shape).astype(np.float32)
    metrics = train_step(net_g, net_d, make_optimizer(net_g.parameters(), hps),
                         make_optimizer(net_d.parameters(), hps), {k: T(v) for k, v in bt.items()}, hps,
                         generator=torch.Generator().manual_seed(3))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    n_flow = m.n_flow_layer * m.n_layers_trans_flow
    n_f0 = m.n_layers  # the F0 decoder's causal FFT
    causal = [c for c in calls["fwd"] if c[0]]
    assert len(causal) == n_flow + n_f0, calls["fwd"]
    assert all(drop and lse and d == m.hidden_channels // m.n_heads for _, drop, lse, d in causal)
    assert len([c for c in calls["fwd"] if not c[0]]) == m.n_layers  # the content encoder, windowed
    assert calls["bwd"].count((True, True)) == n_flow + n_f0
    assert len(mha) == len(calls["fwd"])


# ------------------------------------------------------- (c) the CLI chain
CHAIN_SR, CHAIN_CLIPS = 8000, 4  # a speaker's clips: 2 validation, 2 training
# tests/tiny.py's widths, so that two steps and a resume stay cheap; the
# options are the CLI's own
CHAIN_TINY = {"data": {"sampling_rate": CHAIN_SR, "filter_length": 128, "hop_length": 64, "win_length": 128,
                       "n_mel_channels": 20, "mel_fmax": 4000, "pad_to_frames": 16},
              "train": {"segment_size": 256, "batch_size": 2, "log_interval": 1, "eval_interval": 2},
              "model": {"inter_channels": 16, "hidden_channels": 16, "filter_channels": 32, "n_layers": 2,
                        "upsample_rates": [4, 4, 4], "upsample_kernel_sizes": [8, 8, 8],
                        "upsample_initial_channel": 32, "gin_channels": 16, "ssl_dim": TINY_W2V["d_model"],
                        "n_flow_layer": 2, "disc_tiny": True, "resblock_kernel_sizes": [3],
                        "resblock_dilation_sizes": [[1, 3, 5]]}}


def _chain_signal(seconds, seed, hz):
    t = np.arange(int(CHAIN_SR * seconds)) / CHAIN_SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * hz * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t))
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The CLI chain in a fresh working directory, with TensorBoard's import
    blocked (metrics.jsonl alone is read here)."""
    work = tmp_path_factory.mktemp("chain")
    for s, spk in enumerate(("alto", "tenor")):
        (work / "dataset" / "44k" / spk).mkdir(parents=True)
        for i in range(CHAIN_CLIPS):
            wav = _chain_signal(0.4 + 0.1 * i, 10 * s + i, 160.0 + 40 * s + 15 * i)
            wavfile.write(work / "dataset" / "44k" / spk / f"take{i}.wav", CHAIN_SR,
                          (wav * 32767).astype(np.int16))
    ckpt = work / "pretrain" / "checkpoint_best_legacy_500.pt"
    ckpt.parent.mkdir()
    save_as_torch_ckpt(make_fairseq_hubert_sd(d_model=64, n_layers=2, ffn_dim=128, conv_specs=CONVS,
                                              pos_conv_kernel=16, pos_conv_groups=4, seed=3), str(ckpt))
    seen = []
    real_step = sys.modules["sovits_tpu_torch.train.trainer"].train_step

    def spy(net_g, net_d, optim_g, optim_d, batch, hps, **kw):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real_step(net_g, net_d, optim_g, optim_d, batch, hps, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setitem(tfactory.CONFIGS, "vec768l12", Wav2Vec2Config(**TINY_W2V))
        mp.setattr(sys.modules["sovits_tpu_torch.train.trainer"], "train_step", spy)
        tflist.main(["--vol_aug", "--use_transformer_flow"])
        config = work / "configs" / "config.json"
        cli_cfg = json.loads(config.read_text())
        cfg = json.loads(config.read_text())
        for section, values in CHAIN_TINY.items():
            cfg[section].update(values)
        config.write_text(json.dumps(cfg, indent=2))
        tpre.main(["-c", "configs/config.json", "--f0_predictor", "yin", "--encoder_checkpoint", str(ckpt),
                   "--device", "cpu"])
        argv = ["-c", "configs/config.json", "-m", "44k", "--device", "cpu"]
        tcli_train.main(argv + ["--max-steps", "2"])
        after_two = sorted(p.name for p in (work / "logs" / "44k").glob("*.pth"))
        tcli_train.main(argv + ["--max-steps", "3"])
    return dict(work=work, cli_cfg=cli_cfg, hps=pcfg.load_config(config), after_two=after_two, seen=seen)


@pytest.fixture
def in_chain(chain, monkeypatch):
    """The chain, from its working directory (the config's paths are relative)."""
    monkeypatch.chdir(chain["work"])
    return chain


def test_chain_config_and_features(in_chain):
    cfg, hps = in_chain["cli_cfg"], in_chain["hps"]
    assert cfg["model"]["vol_embedding"] and cfg["train"]["vol_aug"] and cfg["model"]["use_transformer_flow"]
    assert cfg["spk"] == {"alto": 0, "tenor": 1} and cfg["model"]["n_speakers"] == 2
    paths = tdata.load_filelist(hps.data.training_files) + tdata.load_filelist(hps.data.validation_files)
    assert len(paths) == 2 * CHAIN_CLIPS
    for p in paths:
        frames = len(wavfile.read(p)[1]) // hps.data.hop_length
        assert np.load(p + ".soft.npy").shape[0] == TINY_W2V["d_model"]
        assert np.load(p + ".vol.npy").shape == (frames,) and np.load(p + ".vol.npy").max() > 1e-3
        assert np.load(p + ".spec.npy").shape == (hps.data.filter_length // 2 + 1, frames)


def test_chain_trains_and_resumes(in_chain):
    chain = in_chain
    work, hps, seen = chain["work"], chain["hps"], chain["seen"]
    model_dir = work / "logs" / "44k"
    assert chain["after_two"] == ["D_2.pth", "G_2.pth"]
    assert sorted(p.name for p in model_dir.glob("*.pth")) == ["D_2.pth", "D_3.pth", "G_2.pth", "G_3.pth"]
    records = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "loss/g/total" in r] == [1, 2, 3]
    evals = [(r["step"], k) for r in records for k in r if k.startswith("eval/")]
    assert evals == [(2, "eval/mel_l1_0"), (2, "eval/mel_l1_1")]
    assert all(np.isfinite(v) for r in records for v in r.values())
    # every step was handed the batch's volume; the resumed run restarts the
    # data order (and so the volume augmentation's draws) from the seed
    assert len(seen) == 3 and all(b["volume"].abs().max() > 1e-3 for b in seen)
    for k in seen[0]:
        torch.testing.assert_close(seen[2][k], seen[0][k], rtol=0, atol=0)
    saved = pcfg.load_config(model_dir / "config.json")
    assert saved.model.vol_embedding and saved.model.use_transformer_flow and saved.train.vol_aug
    assert hps.train.vol_aug


def test_chain_vol_aug_batches_match_jax(in_chain):
    chain = in_chain
    """The same preprocessed files and seed give the same volume-augmented
    batches in both packages (the JAX iterator's ``epoch`` key dropped)."""
    import itertools

    hps = chain["hps"]
    seed = hps.train.seed
    port = tdata.batch_iterator(tdata.FeatureDataset(hps.data.training_files, hps), 2, seed=seed)
    got = list(itertools.islice(port, 4))
    port.close()
    jhps = JaxHParams(**hps.to_dict())
    want = list(itertools.islice(jdata.batch_iterator(jdata.FeatureDataset(hps.data.training_files, jhps),
                                                      2, seed=seed), 4))
    for a, b in zip(got, want):
        b.pop("epoch")
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
    # at least one clip was scaled: its volume is not the file's
    files = tdata.FeatureDataset(hps.data.training_files, hps, vol_aug=False)
    plain = list(itertools.islice(tdata.batch_iterator(files, 2, seed=seed), 4))
    assert any(not np.allclose(a["volume"], b["volume"]) for a, b in zip(got, plain))


def test_chain_generator_loads_into_both_packages(in_chain):
    chain = in_chain
    """G_3.pth in the port's synthesizer (inference build, fused tail) and,
    through the JAX loader, in the JAX synthesizer: 1 s converted alike
    with the noise off, the volume moving the latent."""
    work, hps = chain["work"], chain["hps"]
    m = hps.model
    path = work / "logs" / "44k" / "G_3.pth"
    net = factory.build_synthesizer(hps, "cpu", fused_tail=True)
    ckpt = torch.load(path, weights_only=False)
    net.load_state_dict(ckpt["model"], strict=True)
    template = from_torch.synthesizer(
        {k: v.numpy() for k, v in net.state_dict().items()}, n_flows=m.n_flow_layer, use_transformer_flow=True,
        vol_embedding=True, n_upsamples=len(m.upsample_rates), n_resblock_kernels=len(m.resblock_kernel_sizes))
    jhps = JaxHParams(**hps.to_dict())
    params, epoch = jckpt.load_torch_generator(str(path), jhps, template)
    assert epoch == ckpt["iteration"]
    p = tdata.load_filelist(hps.data.validation_files)[0]
    item = tdata.FeatureDataset(hps.data.validation_files, hps, vol_aug=False).load_utterance(p)
    frames = CHAIN_SR // hps.data.hop_length  # 1 s: the clip's features repeated to it
    idx = np.arange(frames) % item["f0"].shape[0]
    c, f0, uv, vol = (item[k][idx][None] for k in ("c", "f0", "uv", "volume"))
    infer = jax.jit(lambda prm, c, f0, uv, spk, vol: jfactory.build_synthesizer(jhps).apply(
        {"params": prm}, c, f0, uv, spk, noise_scale=0.0, sample_noise=False, vol=vol,
        method=JaxSynthesizer.infer))
    wav_j, _ = infer(jax.tree.map(jnp.asarray, params), jnp.asarray(c), jnp.asarray(f0), jnp.asarray(uv),
                     jnp.zeros((1,), jnp.int32), jnp.asarray(vol))
    spk = torch.zeros(1, dtype=torch.long)
    kw = dict(noise_scale=0.0, sample_noise=False)
    with torch.no_grad():
        wav_t, _ = net.infer(T(c), T(f0), T(uv), spk, vol=T(vol), **kw)
        # the volume reaches the latent the vocoder decodes (the audio of a
        # barely trained vocoder hardly depends on it)
        z, _, _ = net.infer_pre(T(c), T(f0), T(uv), spk, vol=T(vol), **kw)
        z_silent, _, _ = net.infer_pre(T(c), T(f0), T(uv), spk, vol=torch.zeros(1, frames), **kw)
    assert wav_t.shape == (1, CHAIN_SR, 1) and np.abs(wav_t.numpy()).max() > 1e-4
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), rtol=0, atol=1e-4)
    assert (z_silent - z).abs().max() > 1e-3
