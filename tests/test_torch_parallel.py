"""The port's parallel/ slice on the CPU: the time-sharded decode, Svc's
seq-parallel inference and the infer CLI's -ss, and data-parallel and
FSDP training steps, held against the JAX package and the single process.

Every multi-rank check runs in one spawn of four gloo ranks
(tests/parallel_ranks.py, which imports no JAX) over a file store; the
ranks write their results to files and this module holds them against
references computed once here:

- ``sharded_decode`` at world 4 against the JAX package's on a 4-device
  mesh everywhere (noise off), and against the port's monolithic decode
  away from the song's edges and across every seam at the JAX test's bar,
  noise off and on (counter-based draws, an unvoiced span not silent);
- a DDP GAN step on a (4, 1) mesh and an FSDP step on a (2, 2) mesh
  against the single-process ``train_step`` on the same global batch of
  rows of unequal lengths, deterministic: the losses, and each gradient
  that the step leaves in ``.grad``; the FSDP step keeps its large
  parameters and their AdamW moments sharded, half the feature axis a
  rank;
- a DDP diffusion step against the single-process step.

Gradients are compared, not parameters: AdamW's first update moves a
parameter by lr times the sign of its gradient, so a gradient within
rounding of zero can flip a parameter by 2 lr. The bar is rtol 1e-5 plus
2e-5 times the net's largest gradient: fp32 convs round differently over a
batch of one row than of four, and the vocoder's gradients reach 1e2
here; a gradient whose true value is zero (a key bias under softmax) is
rounding noise that no bar relative to its own peak can hold.
"""

import json
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu.models import nsf_hifigan as jnsf  # noqa: E402
from sovits_tpu.parallel import sequence as jseq  # noqa: E402
from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.models.nsf_hifigan import Generator, SourceModuleHnNSF  # noqa: E402
from sovits_tpu_torch.parallel import sequence  # noqa: E402
from tests import parallel_ranks as pr  # noqa: E402
from tests.test_torch_modules import ATOL, _load, _sd  # noqa: E402
from tests.test_torch_slice import AUDIO_ATOL, _voiced, svc_pair  # noqa: E402,F401
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

SEAM = dict(rtol=2e-4, atol=2e-5)  # tests/test_sequence_parallel.py's bar
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_NET_ATOL = 1e-5, 2e-5


def _hps(kind):
    if kind == "tiny":
        return pcfg.tiny_config()
    over = {"resblock2": {"model.resblock": "2", "model.resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]},
            "snake": {"model.vocoder_name": "nsf-snake-hifigan"}}.get(kind, {})
    return pcfg.default_config(**over)


@pytest.mark.parametrize("kind", ["default", "tiny", "resblock2", "snake"])
def test_required_halo_frames_matches_jax(kind):
    from sovits_tpu import config as jcfg

    hps = _hps(kind)
    jhps = jcfg.HParams(**hps.to_dict())
    got = sequence.required_halo_frames(factory.build_decoder(hps, "cpu"))
    assert got == jseq.required_halo_frames(jfactory.build_decoder(jhps))


def test_build_decoder_loads_the_synthesizers_vocoder():
    hps = pcfg.tiny_config(**{"model.upsample_initial_channel": 64, "model.hidden_channels": 16,
                              "model.filter_channels": 32, "model.inter_channels": 16})
    syn = factory.build_synthesizer(hps, "cpu", fused_tail=True)
    dec = factory.build_decoder(hps, "cpu")
    dec.load_state_dict(syn.dec.state_dict(), strict=True)
    assert type(dec) is type(syn.dec) and dec.fused == syn.dec.fused


def _filled(module, *args, seed=0, **kw):
    """Seeded flax params of ``module``'s shapes (``jax.eval_shape``: no init
    graph compiled): uniform +-1/sqrt(fan-in) kernels, weight-norm scales
    in [0.5, 1.5], small biases."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        shape, name = leaf.shape, path[-1].key
        if name in ("g", "g_in"):
            value = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            bound = float(np.prod(shape[:-1])) ** -0.5
            value = rng.uniform(-bound, bound, shape)
        else:
            value = rng.uniform(-0.1, 0.1, shape)
        return value.astype(np.float32)

    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    return jax.tree_util.tree_map_with_path(one, shapes)


def test_source_with_phase0_matches_jax():
    rng = np.random.default_rng(3)
    f0 = rng.uniform(80, 400, (2, 12)).astype(np.float32)
    f0[0, 3:5] = 0.0
    phase0 = rng.uniform(0, 300, (2, 9)).astype(np.float32)
    jm = jnsf.SourceModuleHnNSF(sample_rate=8000)
    params = _filled(jm, jnp.asarray(f0), 64)
    ref, _ = jax.jit(lambda f, p0: jm.apply({"params": params}, f, 64, rng=None, phase0=p0))(
        jnp.asarray(f0), jnp.asarray(phase0))
    tm = _load(SourceModuleHnNSF(8000), {"l_linear.weight": np.array(params["merge_kernel"]).T.copy(),
                                         "l_linear.bias": np.array(params["merge_bias"])})
    har, _ = tm(torch.from_numpy(f0), 64, phase0=torch.from_numpy(phase0))
    np.testing.assert_allclose(har.detach().numpy().transpose(0, 2, 1), np.asarray(ref), rtol=0, atol=ATOL)


def _cl(a):  # [B, C, T] numpy -> [B, T, C] JAX
    return jnp.asarray(np.transpose(a, (0, 2, 1)))


@pytest.fixture(scope="module")
def decoder_pair(tmp_path_factory):
    """The fused-trio generator config (stage widths 128 and 64: the plain
    trio runs in each shard) with seeded JAX weights, carried to the port;
    the four ranks start here, on those weights, and run while the tests
    that need no rank do."""
    inp = pr.decode_inputs()
    jm = jnsf.Generator(**pr.DECODER_KW)
    params = _filled(jm, _cl(inp["x"][..., :16]), jnp.asarray(inp["f0"][:, :16]), _cl(inp["g"]))
    tm = _load(Generator(**pr.DECODER_KW, fused_tail=True), _sd(from_jax.generator, params))
    assert tm.fused
    root = tmp_path_factory.mktemp("ranks")
    torch.save(tm.state_dict(), root / "decoder.pt")
    pr.write_diffusion_corpus(root)
    procs = pr.start(root)
    yield jm, params, tm, inp, (root, procs)
    pr.stop(procs)


def test_generator_with_phase0_matches_jax(decoder_pair):
    jm, params, tm, inp, _ranks = decoder_pair
    x, f0, g = inp["x"][..., :20], inp["f0"][:, :20], inp["g"]
    phase0 = np.random.default_rng(4).uniform(0, 50, (1, 9)).astype(np.float32)
    ref = jax.jit(lambda *a: jm.apply({"params": params}, *a[:3], phase0=a[3]))(
        _cl(x), jnp.asarray(f0), _cl(g), jnp.asarray(phase0))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(f0), torch.from_numpy(g),
                 phase0=torch.from_numpy(phase0))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(ref), rtol=0, atol=ATOL)


def test_svc_infer_seq_parallel_matches_jax(svc_pair):
    """World 1 (no process group) against the JAX Svc's n_shards=1, noise
    off, the song's edges included."""
    jsvc, tsvc = svc_pair
    sr = tsvc.target_sample
    wav = _voiced(2.0, sr, 3)
    kw = dict(f0_predictor="dio", sample_noise=False, noice_scale=0.0)
    want, n_j, frames_j = jsvc.infer_seq_parallel(0, 0, wav, sr, n_shards=1, **kw)
    got, n_t, frames_t = tsvc.infer_seq_parallel(0, 0, wav, sr, n_shards=1, **kw)
    assert (n_t, frames_t) == (n_j, frames_j) and n_t == frames_t * tsvc.hop_size
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)
    with pytest.raises(ValueError, match="spk mix"):
        tsvc.infer_seq_parallel({0: 1.0}, 0, wav, sr)


@pytest.mark.parametrize("flags", [["-shd"], ["-od"], ["-eh"], ["-usm"], ["-lea", "0.5"],
                                   ["-shd", "-eh"]], ids=lambda f: "_".join(f))
def test_cli_seq_shard_refuses_what_jax_refuses(flags, tmp_path, monkeypatch):
    from sovits_tpu.cli import infer as jcli
    from sovits_tpu_torch.cli import infer as cli

    monkeypatch.chdir(tmp_path)
    argv = ["-m", "G_0.pth", "-n", "song.wav", "-ss", "2", *flags]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    assert str(got.value) == str(want.value) and "--seq_shard" in str(got.value)


def test_cli_seq_shard_writes_the_song(svc_pair, tmp_path, monkeypatch, capsys):
    from sovits_tpu_torch.cli import infer as cli
    from sovits_tpu_torch.encoders import factory as enc_factory

    _jsvc, tsvc = svc_pair
    pcfg.save_config(tsvc.hps, tmp_path / "config.json")
    torch.save({"model": tsvc.model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    sr = tsvc.target_sample
    wav = _voiced(2.5, sr, 5)
    wavfile.write(tmp_path / "song.wav", sr, (wav * 32767).astype(np.int16))
    monkeypatch.setattr(enc_factory, "get_speech_encoder", lambda name, device="cuda": tsvc.encoder)
    monkeypatch.chdir(tmp_path)
    cli.main(["-m", "G_0.pth", "-c", "config.json", "-n", "song.wav", "-f0p", "dio", "-ss", "2",
              "-d", "cpu"])
    out = tmp_path / "results" / "song_0key_0_sovits_dio.wav"
    assert f"wrote {out.relative_to(tmp_path)}" in capsys.readouterr().out
    out_sr, audio = wavfile.read(out)
    hop = tsvc.hop_size
    assert out_sr == sr and len(audio) == len(wav) // hop * hop and np.abs(audio).max() > 0
    assert json.loads((tmp_path / "config.json").read_text())["data"]["hop_length"] == hop


@pytest.fixture(scope="module")
def jax_sharded(decoder_pair):
    """The JAX package's sharded_decode on a 4-device mesh (noise off)."""
    jm, params, _tm, inp, _ranks = decoder_pair
    mesh = Mesh(np.array(jax.devices()[:pr.WORLD]), ("data",))
    fn = jax.jit(lambda x, f0, g: jseq.sharded_decode(jm, params, x, f0, g, mesh))
    return np.asarray(fn(_cl(inp["x"]), jnp.asarray(inp["f0"]), _cl(inp["g"])))[..., 0]


@pytest.fixture(scope="module")
def ranks(decoder_pair, jax_sharded):
    """The four ranks' results, and the single-process references."""
    root, procs = decoder_pair[-1]
    hps = pr.gan_hps()
    net_g, net_d = pr.gan_nets(hps)
    metrics, _ = pr.gan_step(net_g, net_d, pr.gan_batch(hps), hps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # optional, ~7 s to import
        diff_loss, diff_grads = pr.diffusion_step(root, root / "diff_single")
    refs = dict(metrics=metrics, grads_g=pr.grads(net_g), grads_d=pr.grads(net_d),
                diffusion_loss=diff_loss, diffusion_grads=diff_grads)
    return pr.join(root, procs), refs


def _song(results, key):
    return np.concatenate([r[key] for r in results], axis=-1)[:, 0]


def test_sharded_decode_matches_jax(ranks, jax_sharded):
    """World 4 over gloo against the JAX package's sharded_decode on a
    4-device mesh, everywhere, the song's edges included (noise off)."""
    results, _ = ranks
    np.testing.assert_allclose(_song(results, "decode"), jax_sharded, rtol=0, atol=ATOL)


def _seams(got, want, halo, upp):
    edge = halo * upp  # the song-edge zone of the edge-zone contract
    np.testing.assert_allclose(got[:, edge:-edge], want[:, edge:-edge], **SEAM)
    t_local = pr.DECODE_FRAMES // pr.WORLD * upp
    for s in range(1, pr.WORLD):
        win = slice(s * t_local - 64, s * t_local + 64)
        np.testing.assert_allclose(got[:, win], want[:, win], err_msg=f"seam {s}", **SEAM)


@pytest.mark.parametrize("noise", [False, True], ids=["noise-off", "noise-on"])
def test_sharded_decode_matches_monolithic(ranks, decoder_pair, noise):
    results, _ = ranks
    _jm, _params, tm, inp, _ranks = decoder_pair
    f0 = inp["f0_unvoiced" if noise else "f0"]
    kw = dict(generator=torch.Generator().manual_seed(pr.NOISE_SEED),
              noise_frames=(0, pr.DECODE_FRAMES)) if noise else {}
    with torch.no_grad():
        mono = tm(torch.from_numpy(inp["x"]), torch.from_numpy(f0), torch.from_numpy(inp["g"]), **kw)
    mono = mono.numpy()[:, 0]
    got = _song(results, "decode_noise" if noise else "decode")
    _seams(got, mono, sequence.required_halo_frames(tm), tm.upp)
    if noise:  # the noise is the only excitation of an unvoiced span, which must sound
        lo, hi = pr.UNVOICED
        assert np.abs(got[:, (lo + 5) * tm.upp : (hi - 5) * tm.upp]).max() > 1e-4


def _close_grads(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    peak = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL, atol=GRAD_NET_ATOL * peak,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_gan_step_matches_single_process(ranks, kind):
    """DDP on a (4, 1) mesh, FSDP on a (2, 2) mesh: every rank's metrics
    are the global batch's, and the averaged gradients the single
    process's."""
    results, refs = ranks
    for r in results:
        got = r[f"{kind}_metrics"]
        assert set(got) == set(refs["metrics"])
        for k, want in refs["metrics"].items():
            np.testing.assert_allclose(got[k], want, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    _close_grads(results[0][f"{kind}_grads_g"], refs["grads_g"], f"{kind} G")
    _close_grads(results[0][f"{kind}_grads_d"], refs["grads_d"], f"{kind} D")


def test_fsdp_keeps_parameters_and_moments_sharded(ranks):
    """JAX's test_fsdp_sharding_survives_train_step contract: after the
    update each large parameter and its exp_avg and exp_avg_sq hold half
    of the output-feature axis on every rank of the (2, 2) mesh."""
    results, _ = ranks
    for r in results:
        shards = r["fsdp_shards"]
        assert len(shards) > 20
        assert {s["dim"] for s in shards.values()} == {0, 1}  # convs and tables/transposed convs
        for name, s in shards.items():
            assert s["placement"] == f"S({s['dim']})", name
            assert s["local"] == [s["full"] // 2] * 3, name


def test_placement_helpers(ranks):
    """replicate_tree gives every rank rank 0's weights; data_sharding and
    replicated place a global batch as shard_batch splits it and whole."""
    results, _ = ranks
    want = results[0]["replicated"]
    np.testing.assert_array_equal(want, pr.flat_params(pr._rank_linear(0)))
    assert not np.array_equal(want, pr.flat_params(pr._rank_linear(1)))
    for r in results:
        np.testing.assert_array_equal(r["replicated"], want)
        assert r["data_sharding_rows"] and r["replicated_whole"]


def test_diffusion_step_matches_single_process(ranks):
    results, refs = ranks
    losses = [r["diffusion_loss"] for r in results]
    np.testing.assert_allclose(np.mean(losses), refs["diffusion_loss"], rtol=LOSS_RTOL)
    assert len(set(losses)) == pr.WORLD  # each rank had its own row and draws
    for r in results:
        _close_grads(r["diffusion_grads"], refs["diffusion_grads"], "diffusion")
