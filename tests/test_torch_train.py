"""The port's training slice vs the JAX package (CPU, tiny config).

Inputs come from numpy seeds; weights are carried across by the converters.
Tolerances are fp32 on both sides with sums in another order: 1e-5 for
single modules, 1e-4 (absolute, or relative for large losses) where a whole
network or a step sits between input and output.

(a) modules: weight-norm grads, spectrograms, segment slicing, the
    discriminators, the losses;
(b) Synthesizer.forward(deterministic=True), all seven outputs, also for a
    vol_embedding + transformer-flow model given the batch's volume, which
    train_step hands to it;
(c) one full deterministic GAN step with its AdamW updates, against a
    reference step assembled from the JAX package's modules and optax;
(d) train() for two steps and a resume (the resumed run restarts the data
    order from hps.train.seed, as the JAX trainer does), the seeded batch
    iterator against the JAX package's and its thread, and a G_*.pth
    train() wrote loaded by the JAX package;
(e) the port imports neither jax nor sovits_tpu;
(f) the port's DIO and pm against the JAX package's, and Svc's default f0
    predictor.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.dsp import sequence as jseq  # noqa: E402
from sovits_tpu.dsp import stft as jstft  # noqa: E402
from sovits_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu.nn import conv as jconv  # noqa: E402
from sovits_tpu.train import losses as jlosses  # noqa: E402
from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.dsp import sequence, stft  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.nn.conv import WNConv1d  # noqa: E402
from sovits_tpu_torch.train import losses  # noqa: E402
from sovits_tpu_torch.train.optim import make_optimizer  # noqa: E402
from sovits_tpu_torch.train.step import train_step  # noqa: E402
from tests.tiny import make_synthetic_dataset, tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
T = torch.from_numpy
# hidden 16, filter 32, 2 layers, 2 heads, upsampling 4.4.4, segment 4 frames
TRAIN_OVERRIDES = {
    "model.inter_channels": 16, "model.hidden_channels": 16, "model.filter_channels": 32,
    "model.n_layers": 2, "model.disc_tiny": True, "train.batch_size": 2, "train.log_interval": 1,
}


def _hps():
    return pcfg.HParams(**tiny_hps(**TRAIN_OVERRIDES).to_dict())


def _rng(seed):
    return np.random.default_rng(seed)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _port_g(hps, seed=0):
    """Seeded port synthesizer (training build) and its weights as a JAX tree."""
    net = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                               torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    m = hps.model
    tree = from_torch.synthesizer(sd, n_upsamples=len(m.upsample_rates),
                                  n_resblock_kernels=len(m.resblock_kernel_sizes))
    return net, jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def jax_d():
    """The JAX discriminator (disc_tiny) with its own init, once per module."""
    hps = _hps()
    jd = jfactory.build_discriminator(hps)
    params = _tree_np(jfactory.init_discriminator_params(
        jd, jax.random.PRNGKey(1), seg_samples=hps.train.segment_size))
    return jd, params


def _port_d(hps, params):
    """The port's discriminator with the JAX discriminator's weights."""
    net = factory.build_discriminator(hps, "cpu")
    net.load_state_dict({k: T(v) for k, v in from_jax.multi_period_discriminator(params).items()},
                        strict=True)
    return net


# ------------------------------------------------------------------ (a) modules
def test_weight_norm_conv_grads():
    x = (_rng(0).standard_normal((2, 24, 16)) * 0.5).astype(np.float32)  # [B, T, C]
    jm = jconv.Conv1d(features=12, kernel_size=3, dilation=2, padding=2, weight_norm=True)
    params = _tree_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    w = _rng(1).standard_normal((2, 24, 12)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * w)

    grads = jax.grad(loss)(params)
    tm = WNConv1d(16, 12, 3, dilation=2, padding=2)
    tm.load_state_dict({k: T(v) for k, v in from_jax.conv1d_wn(params).items()})
    out = tm(T(x).transpose(1, 2))
    (out * T(w).transpose(1, 2)).sum().backward()
    want = from_jax.conv1d_wn(_tree_np(grads))  # grads share the params' layout
    for name in ("weight_g", "weight_v", "bias"):
        _close(getattr(tm, name).grad.numpy(), want[name], atol=1e-4)
    # after an optimizer step the folded weight follows g and v
    torch.optim.SGD(tm.parameters(), lr=0.1).step()
    with torch.no_grad():
        folded = tm(T(x).transpose(1, 2))
    _close(folded.numpy(), tm(T(x).transpose(1, 2)).detach().numpy(), atol=0)
    assert not np.allclose(folded.numpy(), out.detach().numpy(), atol=1e-3)


@pytest.mark.parametrize("fn", ["spectrogram", "mel_spectrogram", "spec_to_mel"])
def test_stft(fn):
    wav = (_rng(2).standard_normal((2, 4096)) * 0.2).astype(np.float32)
    kw = dict(n_fft=256, hop_length=64, win_length=256)
    mel_kw = dict(n_fft=256, n_mels=24, sample_rate=8000, fmin=0.0, fmax=4000.0)
    if fn == "spectrogram":
        got = stft.spectrogram(T(wav), **kw)
        want = jstft.spectrogram(jnp.asarray(wav), **kw)
    elif fn == "mel_spectrogram":
        got = stft.mel_spectrogram(T(wav), hop_length=64, win_length=256, **mel_kw)
        want = jstft.mel_spectrogram(jnp.asarray(wav), hop_length=64, win_length=256, **mel_kw)
    else:
        spec = np.abs(_rng(3).standard_normal((2, 30, 129))).astype(np.float32)
        got = stft.spec_to_mel(T(spec), **mel_kw)
        want = jstft.spec_to_mel(jnp.asarray(spec), **mel_kw)
    assert got.shape == want.shape
    _close(got.numpy(), want, atol=1e-4)


def test_rand_slice_segments_with_pitch():
    rng = _rng(4)
    x = rng.standard_normal((3, 20, 5)).astype(np.float32)
    pitch = rng.uniform(100, 300, (3, 20)).astype(np.float32)
    lengths = np.array([20, 9, 4])
    u = np.array([0.99, 0.5, 0.7], np.float32)
    ids = sequence.slice_starts(T(u), T(lengths), 4)
    want_ids = np.maximum((u * (lengths - 4 + 1).astype(np.float32)).astype(np.int32), 0)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    for arr in (x, pitch):
        got = sequence.slice_segments(T(arr), ids, 4)
        np.testing.assert_array_equal(got.numpy(), jseq.slice_segments(jnp.asarray(arr), jnp.asarray(want_ids), 4))
    xs, ps, ids = sequence.rand_slice_segments_with_pitch(T(x), T(pitch), T(lengths), 4,
                                                          torch.Generator().manual_seed(0))
    assert ((ids >= 0) & (ids <= T(lengths) - 4)).all()
    np.testing.assert_array_equal(xs.numpy(), sequence.slice_segments(T(x), ids, 4).numpy())
    np.testing.assert_array_equal(ps.numpy(), sequence.slice_segments(T(pitch), ids, 4).numpy())


def test_discriminator_logits_and_fmaps(jax_d):
    hps = _hps()
    jd, params = jax_d
    net = _port_d(hps, params)
    rng = _rng(5)
    y, y_hat = (rng.standard_normal((2, 2, 256, 1)) * 0.3).astype(np.float32)
    ref = jax.jit(lambda p, a, b: jd.apply({"params": p}, a, b))(params, jnp.asarray(y), jnp.asarray(y_hat))
    got = net(T(y), T(y_hat))
    for logits_t, logits_j in zip(got[:2], ref[:2]):
        for a, b in zip(logits_t, logits_j):
            _close(a.detach().numpy(), b)
    for fmaps_t, fmaps_j in zip(got[2:], ref[2:]):
        for per_d_t, per_d_j in zip(fmaps_t, fmaps_j):
            assert len(per_d_t) == len(per_d_j)
            for a, b in zip(per_d_t, per_d_j):  # torch channels-first, JAX channels-last
                _close(np.moveaxis(a.detach().numpy(), 1, -1), b)


def test_losses():
    rng = _rng(6)
    outs = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 5)]
    fakes = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 5)]
    fm_r = [[rng.standard_normal((2, 3, 4)).astype(np.float32)] * 2]
    fm_g = [[rng.standard_normal((2, 3, 4)).astype(np.float32)] * 2]
    z_p, logs_q, m_p, logs_p = (rng.standard_normal((4, 2, 6, 4)) * 0.3).astype(np.float32)
    mask = (np.arange(6)[None, :, None] < np.array([6, 4])[:, None, None]).astype(np.float32)
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    t = lambda xs: [T(x) for x in xs]  # noqa: E731
    _close(losses.discriminator_loss(t(outs), t(fakes))[0], jlosses.discriminator_loss(j(outs), j(fakes))[0])
    _close(losses.generator_loss(t(fakes))[0], jlosses.generator_loss(j(fakes))[0])
    _close(losses.feature_loss([t(f) for f in fm_r], [t(f) for f in fm_g]),
           jlosses.feature_loss([j(f) for f in fm_r], [j(f) for f in fm_g]))
    _close(losses.kl_loss(*t((z_p, logs_q, m_p, logs_p, mask))),
           jlosses.kl_loss(*j((z_p, logs_q, m_p, logs_p, mask))))


# ------------------------------------------------------ (b) Synthesizer.forward
def _batch(hps, seed=7):
    rng = _rng(seed)
    b, t = 2, hps.data.pad_to_frames
    n_freq = hps.data.filter_length // 2 + 1
    return dict(
        c=rng.standard_normal((b, t, hps.model.ssl_dim)).astype(np.float32),
        f0=rng.uniform(100, 300, (b, t)).astype(np.float32),
        uv=(rng.random((b, t)) > 0.2).astype(np.float32),
        spec=np.abs(rng.standard_normal((b, t, n_freq))).astype(np.float32),
        spk=np.array([0, 1]),
        lengths=np.array([t, t - 5]),
        wav=(rng.standard_normal((b, t * hps.data.hop_length, 1)) * 0.1).astype(np.float32),
    )


def _jax_forward(jm, params, bt):
    return jm.apply({"params": params}, *(jnp.asarray(bt[k]) for k in ("c", "f0", "uv", "spec")),
                    jnp.asarray(bt["spk"], jnp.int32), jnp.asarray(bt["lengths"], jnp.int32),
                    deterministic=True)


def test_synthesizer_forward_matches_jax(jax_step):
    hps, bt, ref = jax_step["hps"], jax_step["batch"], jax_step["outs"]
    net, _ = _port_g(hps)
    got = net(*(T(bt[k]) for k in ("c", "f0", "uv", "spec", "spk", "lengths")), deterministic=True)
    flat = lambda o: [o[0], o[1], o[2], *o[3], o[4], o[5], o[6]]  # noqa: E731
    names = ["wav", "ids", "spec_mask", "z", "z_p", "m_p", "logs_p", "m_q", "logs_q", "pred_lf0",
             "norm_lf0", "lf0"]
    assert got[0].shape == (2, hps.train.segment_size, 1)
    for name, a, b in zip(names, flat(got), flat(ref)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-4, err_msg=name)


VOL_TFLOW = {"model.vol_embedding": True, "model.use_transformer_flow": True}


def _vol_tflow_batch(hps):
    bt = _batch(hps)
    bt["volume"] = _rng(8).uniform(0.0, 0.3, bt["f0"].shape).astype(np.float32)
    return bt


def test_synthesizer_forward_with_volume_matches_jax():
    """A vol_embedding + transformer-flow synthesizer's deterministic training
    forward, with the batch's volume, against the JAX forward given ``vol``."""
    hps = pcfg.HParams(**tiny_hps(**TRAIN_OVERRIDES, **VOL_TFLOW).to_dict())
    m = hps.model
    net = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                               torch.Generator().manual_seed(4))
    tree = from_torch.synthesizer(
        {k: v.numpy() for k, v in net.state_dict().items()}, n_flows=m.n_flow_layer,
        use_transformer_flow=True, vol_embedding=True, n_upsamples=len(m.upsample_rates),
        n_resblock_kernels=len(m.resblock_kernel_sizes))
    bt = _vol_tflow_batch(hps)
    jm = jfactory.build_synthesizer(hps)
    names = ("c", "f0", "uv", "spec", "spk", "lengths", "volume")
    ref = jax.jit(lambda p, c, f0, uv, spec, spk, lengths, vol: jm.apply(
        {"params": p}, c, f0, uv, spec, spk, lengths, vol=vol, deterministic=True,
    ))(tree, *(jnp.asarray(bt[k], jnp.int32 if k in ("spk", "lengths") else None) for k in names))
    got = net(*(T(bt[k]) for k in names[:-1]), vol=T(bt["volume"]), deterministic=True)
    flat = lambda o: [o[0], o[2], *o[3], o[4], o[5], o[6]]  # noqa: E731
    labels = ["wav", "spec_mask", "z", "z_p", "m_p", "logs_p", "m_q", "logs_q", "pred_lf0", "norm_lf0", "lf0"]
    for name, a, b in zip(labels, flat(got), flat(ref)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-4, err_msg=name)
    # the volume moves the prior (m_p) and the flow's output
    silent = net(*(T(bt[k]) for k in names[:-1]), vol=torch.zeros(bt["f0"].shape), deterministic=True)
    assert (silent[3][2] - got[3][2]).abs().max() > 1e-3


def test_train_step_feeds_the_volume():
    """train_step hands the batch's volume to the generator, as the JAX step does."""
    hps = pcfg.HParams(**tiny_hps(**TRAIN_OVERRIDES, **VOL_TFLOW).to_dict())
    net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                                 torch.Generator().manual_seed(4))
    net_d = factory.build_discriminator(hps, "cpu")
    seen = {}
    forward = net_g.forward
    net_g.forward = lambda *a, **k: seen.update(vol=k.get("vol")) or forward(*a, **k)
    batch = {k: T(v) for k, v in _vol_tflow_batch(hps).items()}
    metrics = train_step(net_g, net_d, make_optimizer(net_g.parameters(), hps),
                         make_optimizer(net_d.parameters(), hps), batch, hps, deterministic=True)
    assert seen["vol"] is batch["volume"]
    assert all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("part", ["f0_decoder", "flow"])
def test_training_forward_applies_dropout(part):
    """The stochastic training forward drops out inside the F0 decoder's and
    the transformer flow's causal FFTs (p_dropout 0.1), as the JAX step
    does: with the same generator, turning that part's dropout off changes
    its output (pred_lf0, z_p) and nothing drawn before it."""
    hps = pcfg.HParams(**tiny_hps(**TRAIN_OVERRIDES, **VOL_TFLOW).to_dict())
    assert hps.model.p_dropout > 0
    net = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                               torch.Generator().manual_seed(4))
    bt = _vol_tflow_batch(hps)
    args = [T(bt[k]) for k in ("c", "f0", "uv", "spec", "spk", "lengths")]

    def run():
        out = net(*args, vol=T(bt["volume"]), generator=torch.Generator().manual_seed(5))
        return {"norm_lf0": out[5], "pred_lf0": out[4], "z": out[3][0], "z_p": out[3][1]}

    with torch.no_grad():
        on, again = run(), run()
        for mod in (net.f0_decoder.decoder if part == "f0_decoder" else net.flow).modules():
            if hasattr(mod, "p_dropout"):
                mod.p_dropout = 0.0
        off = run()
    before, out = ("norm_lf0", "pred_lf0") if part == "f0_decoder" else ("z", "z_p")
    torch.testing.assert_close(on[out], again[out], rtol=0, atol=0)
    torch.testing.assert_close(on[before], off[before], rtol=0, atol=0)
    assert (on[out] - off[out]).abs().max() > 1e-3, f"no dropout in the {part}"


# ------------------------------------------------------- (c) one full GAN step
def _jax_step(hps, jm, jd, g_params, d_params, bt):
    """sovits_tpu/train/step.py's train_step with deterministic=True and plain
    optax.adamw(weight_decay=0.01) (the JAX step hard-codes deterministic=False)."""
    d, hop = hps.data, hps.data.hop_length
    mel_kw = dict(n_fft=d.filter_length, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
                  fmin=d.mel_fmin, fmax=d.mel_fmax)
    tx = optax.adamw(hps.train.learning_rate, b1=hps.train.betas[0], b2=hps.train.betas[1],
                     eps=hps.train.eps, weight_decay=0.01)
    outs, gen_vjp = jax.vjp(lambda p: _jax_forward(jm, p, bt), g_params)
    y_hat, ids = jax.lax.stop_gradient(outs[0]), outs[1]
    y_seg = jseq.slice_segments(bt["wav"], ids * hop, hps.train.segment_size)

    def d_loss(dp):
        r, f, _, _ = jd.apply({"params": dp}, y_seg, y_hat)
        return jlosses.discriminator_loss(r, f)[0]

    loss_d, d_grads = jax.value_and_grad(d_loss)(d_params)
    d_upd, _ = tx.update(d_grads, tx.init(d_params), d_params)
    d_new = optax.apply_updates(d_params, d_upd)
    y_mel = jseq.slice_segments(jstft.spec_to_mel(bt["spec"], **mel_kw), ids,
                                hps.train.segment_size // hop)

    def head(o):
        y_hat_mel = jstft.mel_spectrogram(o[0][..., 0], hop_length=hop, win_length=d.win_length, **mel_kw)
        _, f, fr, fg = jd.apply({"params": d_new}, y_seg, o[0])
        z, z_p, m_p, logs_p, m_q, logs_q = o[3]
        terms = {"loss/g/mel": jnp.mean(jnp.abs(y_mel - y_hat_mel)) * hps.train.c_mel,
                 "loss/g/kl": jlosses.kl_loss(z_p, logs_q, m_p, logs_p, o[2]) * hps.train.c_kl,
                 "loss/g/fm": jlosses.feature_loss(fr, fg), "loss/g/gen": jlosses.generator_loss(f)[0],
                 "loss/g/lf0": jnp.mean((o[4] - o[6]) ** 2)}
        total = sum(terms.values())
        return total, {"loss/g/total": total, **terms}

    (_, metrics), out_grads = jax.value_and_grad(head, has_aux=True, allow_int=True)(outs)
    (g_grads,) = gen_vjp(out_grads)
    g_upd, _ = tx.update(g_grads, tx.init(g_params), g_params)
    metrics.update({"loss/d/total": loss_d, "grad_norm_d": optax.global_norm(d_grads),
                    "grad_norm_g": optax.global_norm(g_grads)})
    return dict(metrics=metrics, outs=outs, g_new=optax.apply_updates(g_params, g_upd),
                d_new=d_new, g_grads=g_grads, d_grads=d_grads)


@pytest.fixture(scope="module")
def jax_step(jax_d):
    """The JAX reference step on seeded port weights, as one compiled program
    (op by op it takes minutes on the CPU); the forward's outputs come with it."""
    hps = _hps()
    _, g_params = _port_g(hps)
    jd, d_params = jax_d
    bt = _batch(hps)
    jm = jfactory.build_synthesizer(hps)
    step = jax.jit(lambda gp, dp, b: _jax_step(hps, jm, jd, gp, dp, b))
    ref = jax.device_get(step(g_params, d_params, {k: jnp.asarray(v) for k, v in bt.items()}))
    return dict(ref, hps=hps, batch=bt, d_params=d_params)


def test_gan_step_matches_jax(jax_step):
    hps, bt = jax_step["hps"], jax_step["batch"]
    net_g, _ = _port_g(hps)
    net_d = _port_d(hps, jax_step["d_params"])
    before = {id(p): p.detach().clone() for net in (net_g, net_d) for p in net.parameters()}
    opt_g, opt_d = make_optimizer(net_g.parameters(), hps), make_optimizer(net_d.parameters(), hps)
    batch = {k: T(v) for k, v in bt.items()}
    got = {k: float(v) for k, v in train_step(net_g, net_d, opt_g, opt_d, batch, hps,
                                              deterministic=True).items()}
    want = {k: float(v) for k, v in jax_step["metrics"].items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # Adam's first step moves a weight by lr * g / (|g| + eps) plus the decay:
    # about lr (1e-4) times the sign of its gradient, so weights are held to
    # 1e-6, 1% of lr. Where the true gradient is 0 but fp32 leaves noise
    # (attention key biases, whose gradient softmax's shift invariance zeroes;
    # a few weight-norm v entries) the sign is noise in either package: a
    # weight may differ there only if its JAX gradient is below 1e-7, and such
    # weights must be rare and still move no more than the step's bound.
    lr = hps.train.learning_rate
    n_noise = n_total = 0
    for net, new, grads in ((net_g, from_jax.synthesizer(_tree_np(jax_step["g_new"]), hps),
                             from_jax.synthesizer(_tree_np(jax_step["g_grads"]), hps)),
                            (net_d, from_jax.multi_period_discriminator(_tree_np(jax_step["d_new"])),
                             from_jax.multi_period_discriminator(_tree_np(jax_step["d_grads"])))):
        params = dict(net.named_parameters())
        assert set(params) == set(new)
        for k, v in new.items():
            p = params[k].detach().numpy()
            off = np.abs(p - v) > 1e-6
            assert (np.abs(grads[k][off]) < 1e-7).all(), k
            n_noise += int(off.sum())
            n_total += off.size
            moved = np.abs(p - before[id(params[k])].numpy())
            assert moved.max() <= lr * 1.01 + 0.01 * lr * np.abs(p).max(), k
    assert n_noise < 1e-3 * n_total, (n_noise, n_total)


# ------------------------------------------- (d) train(), resume, JAX loading
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train() for two steps, then a resume to step 3; every batch the steps
    were given, in order."""
    from sovits_tpu_torch.train import trainer

    root = tmp_path_factory.mktemp("train")
    jhps = tiny_hps(**TRAIN_OVERRIDES)
    make_synthetic_dataset(root / "data", jhps)
    hps = pcfg.HParams(**jhps.to_dict())
    seen = []
    real_step = trainer.train_step

    def spy(net_g, net_d, optim_g, optim_d, batch, hps, **kw):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real_step(net_g, net_d, optim_g, optim_d, batch, hps, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "train_step", spy)
        trainer.train(hps, root / "model", max_steps=2, device="cpu")
        after_two = sorted(p.name for p in (root / "model").glob("*.pth"))
        trainer.train(hps, root / "model", max_steps=3, device="cpu")
    return hps, root / "model", after_two, seen


def test_train_and_resume(trained):
    import json

    hps, model_dir, after_two, seen = trained
    assert after_two == ["D_2.pth", "G_2.pth"]
    # the resumed run's first batch is the fresh run's first batch: both seed
    # the data order with hps.train.seed (sovits_tpu/train/trainer.py's rule)
    assert len(seen) == 3
    for k in seen[0]:
        torch.testing.assert_close(seen[2][k], seen[0][k], rtol=0, atol=0)
    assert not torch.equal(seen[1]["c"], seen[0]["c"])
    assert sorted(p.name for p in model_dir.glob("*.pth")) == ["D_2.pth", "D_3.pth", "G_2.pth", "G_3.pth"]
    records = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]  # the resumed run continues at step 3
    for r in records:
        assert all(np.isfinite(v) for v in r.values())
    ckpt = torch.load(model_dir / "G_3.pth", weights_only=False)
    assert set(ckpt) == {"model", "optimizer", "learning_rate", "iteration"}
    assert ckpt["optimizer"]["state"][0]["step"] == 3


def test_batch_iterator_matches_jax(trained):
    """The same dataset and seed give the same batches in both packages (the
    JAX iterator's extra ``epoch`` key dropped)."""
    import itertools

    from sovits_tpu.train import data as jdata
    from sovits_tpu_torch.train.data import FeatureDataset, batch_iterator

    hps = trained[0]
    seed = hps.train.seed
    port = batch_iterator(FeatureDataset(hps.data.training_files, hps), 2, seed=seed)
    got = list(itertools.islice(port, 2))
    port.close()
    from sovits_tpu.config import HParams as JaxHParams

    jhps = JaxHParams(**hps.to_dict())
    want = list(itertools.islice(jdata.batch_iterator(jdata.FeatureDataset(hps.data.training_files, jhps),
                                                      2, seed=seed), 2))
    for a, b in zip(got, want):
        b.pop("epoch")
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(got[0]["c"], got[1]["c"])


def test_batch_iterator_is_seeded_and_stops_its_thread(trained):
    import threading

    from sovits_tpu_torch.train.data import FeatureDataset, batch_iterator

    hps = trained[0]
    dataset = FeatureDataset(hps.data.training_files, hps)
    before = threading.active_count()
    batches = batch_iterator(dataset, 2, seed=3)
    first = next(batches)
    again = next(batch_iterator(dataset, 2, seed=3))  # that iterator is closed as it goes
    assert first.keys() == again.keys()
    for k in first:
        np.testing.assert_array_equal(first[k], again[k])
    batches.close()
    assert threading.active_count() == before

    def broken(index, rng):
        raise OSError("unreadable utterance")

    dataset.padded_example = broken
    with pytest.raises(OSError, match="unreadable utterance"):
        next(batch_iterator(dataset, 2))
    assert threading.active_count() == before


def test_trained_generator_loads_into_jax(trained):
    from sovits_tpu.train.checkpoint import load_torch_generator

    hps, model_dir, _, _ = trained
    net = factory.build_synthesizer(hps, "cpu", fused_tail=True)
    ckpt = torch.load(model_dir / "G_3.pth", weights_only=False)
    net.load_state_dict(ckpt["model"], strict=True)
    m = hps.model
    template = from_torch.synthesizer({k: v.numpy() for k, v in net.state_dict().items()},
                                      n_upsamples=len(m.upsample_rates),
                                      n_resblock_kernels=len(m.resblock_kernel_sizes))
    params, epoch = load_torch_generator(str(model_dir / "G_3.pth"), hps, template)
    assert epoch == ckpt["iteration"]
    bt = _batch(hps, seed=9)
    infer = jax.jit(lambda p, c, f0, uv, spk, lengths: jfactory.build_synthesizer(hps).apply(
        {"params": p}, c, f0, uv, spk, noise_scale=0.0, sample_noise=False, lengths=lengths,
        method=JaxSynthesizer.infer))
    wav_j, _ = infer(jax.tree.map(jnp.asarray, params), *(jnp.asarray(bt[k]) for k in ("c", "f0", "uv")),
                     jnp.asarray(bt["spk"], jnp.int32), jnp.asarray(bt["lengths"], jnp.int32))
    wav_t, _ = net.infer(*(T(bt[k]) for k in ("c", "f0", "uv", "spk")), noise_scale=0.0,
                         sample_noise=False, lengths=T(bt["lengths"]))
    assert np.abs(wav_t.numpy()).max() > 1e-4
    _close(wav_t.numpy(), wav_j, atol=1e-4)


# ------------------------------------------------------------ (e) no JAX imports
_IMPORT_CHILD = """
import importlib, importlib.abc, pkgutil, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "sovits_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, NoJax())
import sovits_tpu_torch
for mod in pkgutil.walk_packages(sovits_tpu_torch.__path__, "sovits_tpu_torch."):
    importlib.import_module(mod.name)
import sovits_tpu_torch.tools.profile_trio_shift
import chip_smoke
print("imported", len(sys.modules))
"""


def test_port_imports_nothing_of_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHILD], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


# --------------------------------------------------------------------- (f) DIO
def _voiced(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    inst_f = 170.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    return (0.25 * np.sin(2 * np.pi * np.cumsum(inst_f) / sr) + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.mark.parametrize("exact", [False, True], ids=["default-fast", "exact"])
def test_dio_matches_jax(exact):
    from sovits_tpu.f0.dio import DioF0Predictor as JaxDio
    from sovits_tpu_torch.f0.dio import DioF0Predictor

    wav = _voiced(3.0, 44100, 0)
    port, ref = DioF0Predictor(hop_length=512, sampling_rate=44100), JaxDio(hop_length=512, sampling_rate=44100)
    port.exact = ref.exact = exact
    f0_t, uv_t = port.compute_f0_uv(wav)
    f0_j, uv_j = ref.compute_f0_uv(wav)
    np.testing.assert_array_equal(uv_t, uv_j)
    assert uv_t.mean() > 0.9
    # default: the same operations; the port's library is built without
    # -march=native, so its float32 decimation rounds in another vector width
    # (measured 1.5e-5 Hz). exact: native float64 against the JAX package's
    # float64 numpy oracle.
    _close(f0_t, f0_j, atol=1e-3 if not exact else 1e-4)


def test_pm_matches_jax():
    """pm is a numpy copy of the JAX package's Praat port: the same f0."""
    from sovits_tpu.f0.praat import ParselmouthF0Predictor as JaxPm
    from sovits_tpu_torch.f0.base import get_f0_predictor

    wav = _voiced(3.0, 44100, 1)
    port = get_f0_predictor("pm", hop_length=512, sampling_rate=44100, threshold=0.05)
    f0_t, uv_t = port.compute_f0_uv(wav)
    f0_j, uv_j = JaxPm(hop_length=512, sampling_rate=44100).compute_f0_uv(wav)
    np.testing.assert_array_equal(uv_t, uv_j)
    assert uv_t.mean() > 0.9
    _close(f0_t, f0_j, atol=1e-6)


@pytest.mark.parametrize("method", ["get_unit_f0", "infer"])
def test_svc_default_f0_predictor_is_jax_default(method):
    import inspect

    from sovits_tpu.infer.svc import Svc as JaxSvc
    from sovits_tpu_torch.infer.svc import Svc

    default = lambda cls: inspect.signature(getattr(cls, method)).parameters["f0_predictor"].default  # noqa: E731
    assert default(Svc) == default(JaxSvc) == "pm"
