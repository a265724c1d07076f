"""The port's model export vs the JAX package's (CPU).

(a) onnx_proto: a graph written by the port's builder round-trips through
    the port's parser, reads in the JAX package's ``parse_model``, and is
    the JAX writer's bytes but for the producer string.
(b) The ONNX synthesizer at tests/test_onnx_export.py's tiny config in five
    cases (single speaker, one-hot CharaMix, vol embedding, transformer
    flow, noise live): the port's bytes run through the port's runtime and
    the JAX package's ``run_model``, against the port's Synthesizer.infer
    and JAX's infer on the same weights (noise off; with the noise live,
    against both packages' modules with that noise in the prior), within
    2e-4 as JAX's test.
(c) The four diffusion graphs of a tiny Unit2Mel against JAX's
    ``build_diffusion_onnx`` graphs on the same weights and inputs, and the
    MoeSS-side PLMS loop replayed through the port's graphs against the
    port's ``sample_plms``.
(d) ``export_synthesizer`` / ``load_exported``: the loaded .pt2 against the
    live Synthesizer.infer (rtol 1e-5, atol 1e-6), with the sovits ops in
    its graph; the CLI's --onnx (sidecar equal to JAX's ``moevs_config``)
    and --diffusion (from a so-vits-svc .pt and from the JAX trainer's .npz).
(e) utils: StageTimer, and annotate and count recorded only inside trace()'s
    window, which writes the trace and its counters.

Weights are drawn for the JAX tree (shapes by ``jax.eval_shape``, no init
graph compiled) with weight-norm gains scaled off their kernels' norms, so
the fold is exercised, and carried into the port by ``from_jax``.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu import config as jcfg  # noqa: E402
from sovits_tpu.dsp.f0 import f0_to_coarse as jax_f0_to_coarse  # noqa: E402
from sovits_tpu.export import onnx_diffusion as jdiff  # noqa: E402
from sovits_tpu.export import onnx_graph as jgraph  # noqa: E402
from sovits_tpu.export import onnx_proto as jproto  # noqa: E402
from sovits_tpu.export import onnx_synth as jsynth  # noqa: E402
from sovits_tpu.export.onnx_run import run_model as jax_run_model  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu.models.diffusion.unit2mel import Unit2Mel as JaxUnit2Mel  # noqa: E402
from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.export import onnx_diffusion as pdiff  # noqa: E402
from sovits_tpu_torch.export import onnx_graph as pgraph  # noqa: E402
from sovits_tpu_torch.export import onnx_proto as pproto  # noqa: E402
from sovits_tpu_torch.export.onnx_run import Session, run_model  # noqa: E402
from sovits_tpu_torch.export.onnx_synth import build_synthesizer_onnx  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.models.diffusion.unit2mel import Unit2Mel  # noqa: E402
from tests.test_torch_configs import _fill  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ONNX_ATOL = 2e-4  # tests/test_onnx_export.py's bar
PT2_TOL = dict(rtol=1e-5, atol=1e-6)

# tests/test_onnx_export.py's tiny_hps
ONNX_TINY = {
    "data.filter_length": 128, "data.hop_length": 64, "data.win_length": 128,
    "model.ssl_dim": 16, "model.gin_channels": 8, "model.hidden_channels": 32,
    "model.inter_channels": 16, "model.filter_channels": 48, "model.n_heads": 2,
    "model.n_layers": 2, "model.n_speakers": 3, "model.upsample_rates": [4, 4],
    "model.upsample_kernel_sizes": [8, 8], "model.upsample_initial_channel": 32,
    "model.resblock_kernel_sizes": [3, 5], "model.resblock_dilation_sizes": [[1, 2], [1, 2]],
}
MODELS = {
    "base": {},
    "vol": {"model.vol_embedding": True},
    "tflow": {"model.use_transformer_flow": True, "model.n_layers_trans_flow": 1},
    # the export round trip's: one layer, one WN layer a coupling, one
    # resblock kernel (torch.export traces every module: seconds each)
    "slim": {"model.n_layers": 1, "model.n_flow_layer": 1, "model.resblock_kernel_sizes": [3],
             "model.resblock_dilation_sizes": [[1, 2]]},
}
# case: (model, chara_mix, speaker, noise live)
SYNTH_CASES = {
    "single_speaker": ("base", False, 1, False),
    "chara_mix_one_hot": ("base", True, 2, False),
    "vol_embedding": ("vol", False, 0, False),
    "transformer_flow": ("tflow", False, 1, False),
    "noise_live": ("base", False, 1, True),
}


def _scale_gains(tree, rng):
    """Weight-norm gains off their kernels' norms (g = ||v|| folds to v)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _scale_gains(v, rng) for k, v in tree.items()}
    for key in ("g", "g_in"):
        if key in out:
            out[key] = (out[key] * rng.uniform(0.5, 1.5, out[key].shape)).astype(np.float32)
    return out


def _hps_pair(over: dict):
    """The same config in both packages."""
    o = {**ONNX_TINY, **over}
    return jcfg.default_config(**o), pcfg.default_config(**o)


def _jax_params(jm, hps, seed=0):
    m, t = hps.model, 16
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1), "slice": jax.random.PRNGKey(2)},
        jnp.zeros((1, t, m.ssl_dim)), jnp.full((1, t), 220.0), jnp.ones((1, t)),
        jnp.zeros((1, t, hps.data.filter_length // 2 + 1)), jnp.zeros((1,), jnp.int32),
        jnp.full((1,), t, jnp.int32), vol=jnp.zeros((1, t)) if m.vol_embedding else None,
        deterministic=True))["params"]
    rng = np.random.default_rng(seed)
    return _scale_gains(_fill(shapes, rng), rng)


_MODEL_CACHE = {}


def _models(name: str):
    """(JAX hps, port hps, JAX module, JAX params, port Synthesizer as Svc
    builds it, JAX infer with the noise off, jitted)."""
    if name not in _MODEL_CACHE:
        jhps, phps = _hps_pair(MODELS[name])
        jm = jfactory.build_synthesizer(jhps)
        params = _jax_params(jm, jhps)
        tm = factory.build_synthesizer(phps, "cpu", fused_tail=True)
        tm.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax.synthesizer(params, phps).items()},
                           strict=True)
        infer = jax.jit(lambda p, c, f0, uv, spk, vol: jm.apply(
            {"params": p}, c, f0, uv, spk, predict_f0=False, sample_noise=False, vol=vol,
            method=jm.infer)[0])
        _MODEL_CACHE[name] = (jhps, phps, jm, params, tm, infer)
    return _MODEL_CACHE[name]


# --------------------------------------------------------------- (a) proto
def _demo_graph(gb_mod):
    g = gb_mod.GraphBuilder("demo")
    x = g.input("x", [1, 3, "T"])
    w = np.arange(3 * 3 * 2, dtype=np.float32).reshape(3, 3, 2) / 10
    y = g.conv1d(x, w, np.ones(3, np.float32), pads=(1, 0), dilation=1)
    y = g.leaky_relu(g.transpose(y, [0, 2, 1]), 0.2)
    y = g.n("ReduceMean", [y], axes=[-1], keepdims=1)
    g.n_named("Identity", [g.mul(y, g.const_f32(2.5))], ["y"])
    g.output("y", [1, "T", 1])
    return g


def test_onnx_proto_round_trip_and_jax_reads_it():
    port = _demo_graph(pgraph).model_bytes()
    m = pproto.parse_model(port)
    jm = jproto.parse_model(port)
    assert m.producer == jm.producer == "sovits_tpu_torch"
    assert (m.ir_version, m.opset) == (jm.ir_version, jm.opset) == (8, 16)
    assert [n.op_type for n in m.graph.nodes] == [n.op_type for n in jm.graph.nodes] == [
        "Conv", "Transpose", "LeakyRelu", "ReduceMean", "Mul", "Identity"]
    assert m.graph.nodes[0].attrs == jm.graph.nodes[0].attrs
    assert m.graph.inputs == jm.graph.inputs == [("x", pproto.DT_FLOAT, [1, 3, "T"])]
    for name, arr in m.graph.initializers.items():
        np.testing.assert_array_equal(arr, jm.graph.initializers[name])
    # the same graph through the JAX builder: the same bytes but the producer
    g = _demo_graph(jgraph)
    want = jproto.model_proto(jproto.graph_proto(g.name, g._nodes, g._inputs, g._outputs, g._inits),
                              producer="sovits_tpu_torch")
    assert port == want
    # every attribute type round-trips
    attrs = dict(i=7, f=0.5, s="abc", ints=[1, -2, 3], floats=[0.25, -1.5], strings=["a", "bc"],
                 t=np.arange(6, dtype=np.int64).reshape(2, 3))
    node = pproto._parse_node(pproto.node_proto("Op", ["a"], ["b"], **attrs))
    for k, v in attrs.items():
        got = node.attrs[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got, v)
        else:
            assert got == v, k
    x = np.random.default_rng(0).standard_normal((1, 3, 9)).astype(np.float32)
    np.testing.assert_allclose(run_model(port, {"x": x}, "cpu")["y"], jax_run_model(port, {"x": x})["y"],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- (b) synthesizer
def _jax_noisy(module, c, f0, uv, spk, noise):
    """JAX's infer with ``noise`` [1, T, inter] in the prior, as the ONNX
    contract has it: z_p = m_p + noise exp(logs_p), mask all ones."""
    g = module._speaker_embedding(spk)
    x_mask = jnp.ones((1, c.shape[1], 1), c.dtype)
    _, m_p, logs_p = module.enc_p(module._prenet(c, uv, None, x_mask), x_mask, jax_f0_to_coarse(f0),
                                  noise_scale=0.0, rng=None)
    z = module.flow(m_p + noise * jnp.exp(logs_p), x_mask, g=g, reverse=True)
    return module.dec(z, f0, g=g, rng=None)


def _synth_inputs(jhps, t, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((1, t, jhps.model.ssl_dim)).astype(np.float32)
    f0 = rng.uniform(80, 400, (1, t)).astype(np.float32)
    f0[0, :2] = 0.0  # an unvoiced head
    uv = (f0 > 0).astype(np.float32)
    vol = np.abs(rng.standard_normal((1, t))).astype(np.float32)
    noise = 0.5 * rng.standard_normal((1, jhps.model.inter_channels, t)).astype(np.float32)
    return c, f0, uv, vol, noise


@pytest.mark.parametrize("case", list(SYNTH_CASES))
def test_onnx_synthesizer_matches_jax(case):
    name, chara_mix, spk, noise_live = SYNTH_CASES[case]
    jhps, phps, jm, params, tm, jax_infer = _models(name)
    t = 13
    c, f0, uv, vol, noise = _synth_inputs(jhps, t, seed=1)
    vol_in = vol if phps.model.vol_embedding else None
    mb = build_synthesizer_onnx(tm, phps, chara_mix=chara_mix)
    feeds = {"c": c, "f0": f0, "mel2ph": np.arange(1, t + 1, dtype=np.int64)[None], "uv": uv,
             "noise": noise if noise_live else np.zeros_like(noise)}
    if chara_mix:
        mix = np.zeros((t, phps.model.n_speakers), np.float32)
        mix[:, spk] = 1.0
        feeds["sid"] = mix
    else:
        feeds["sid"] = np.asarray([spk], np.int64)
    if vol_in is not None:
        feeds["vol"] = vol
    got_port = run_model(mb, feeds, "cpu")["audio"]
    got_jax = jax_run_model(mb, feeds)["audio"]
    assert got_port.shape == (1, 1, t * 16)
    np.testing.assert_allclose(got_port, got_jax, rtol=0, atol=ONNX_ATOL)

    tc, tf0, tuv = (torch.from_numpy(a) for a in (c, f0, uv))
    tspk = torch.tensor([spk])
    tvol = None if vol_in is None else torch.from_numpy(vol)
    if noise_live:
        # the port's modules with this noise in the prior: z_p = m + noise exp(logs)
        with torch.no_grad():
            g = tm._speaker_embedding(tspk)
            mask = torch.ones(1, 1, t)
            x = tm._prenet(tc, tuv, tvol, mask)
            from sovits_tpu_torch.dsp.f0 import f0_to_coarse

            _, m_p, logs_p = tm.enc_p(x, mask, f0_to_coarse(tf0))
            z = tm.flow(m_p + torch.from_numpy(noise) * torch.exp(logs_p), mask, g=g, reverse=True)
            want = tm.dec(z, tf0, g=g).numpy()
        want_jax = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=_jax_noisy))(
            params, jnp.asarray(c), jnp.asarray(f0), jnp.asarray(uv), jnp.asarray([spk], jnp.int32),
            jnp.asarray(noise.transpose(0, 2, 1))))
        for got in (got_port, got_jax):
            np.testing.assert_allclose(got[0, 0], want[0, 0], rtol=0, atol=ONNX_ATOL)
            np.testing.assert_allclose(got[0, 0], want_jax[0, :, 0], rtol=0, atol=ONNX_ATOL)
        zero = run_model(mb, {**feeds, "noise": np.zeros_like(noise)}, "cpu")["audio"]
        assert np.isfinite(got_port).all() and np.abs(got_port - zero).max() > 1e-4
        return
    want_port = tm.infer(tc, tf0, tuv, tspk, sample_noise=False, vol=tvol)[0].numpy()[0, :, 0]
    want_jax = np.asarray(jax_infer(params, jnp.asarray(c), jnp.asarray(f0), jnp.asarray(uv),
                                    jnp.asarray([spk], jnp.int32),
                                    None if vol_in is None else jnp.asarray(vol)))[0, :, 0]
    for got in (got_port, got_jax):
        np.testing.assert_allclose(got[0, 0], want_port, rtol=0, atol=ONNX_ATOL)
        np.testing.assert_allclose(got[0, 0], want_jax, rtol=0, atol=ONNX_ATOL)
    assert np.abs(want_port).max() > 1e-3


def test_onnx_synthesizer_structure_and_unsupported():
    _jhps, phps, _jm, _params, tm, _infer = _models("base")
    m = pproto.parse_model(build_synthesizer_onnx(tm, phps, chara_mix=False))
    assert (m.opset, m.ir_version, m.producer) == (16, 8, "sovits_tpu_torch")
    assert [n for n, _, _ in m.graph.inputs] == ["c", "f0", "mel2ph", "uv", "noise", "sid"]
    assert [n for n, _, _ in m.graph.outputs] == ["audio"]
    assert {"Conv", "ConvTranspose", "MatMul", "Softmax", "CumSum", "Einsum"} <= {
        n.op_type for n in m.graph.nodes}
    for over in ({"model.vocoder_name": "nsf-snake-hifigan"}, {"model.resblock": "2"}):
        _, p = _hps_pair(over)
        with pytest.raises(NotImplementedError):
            build_synthesizer_onnx(factory.build_synthesizer(p, "cpu", fused_tail=True), p)


# -------------------------------------------------------------- (c) diffusion
T_DIFF = 24
DIFF_TINY = dict(input_channel=20, n_spk=2, out_dims=12, n_layers=2, n_chans=32, n_hidden=16,
                 timesteps=50, k_step_max=50)


@pytest.fixture(scope="module")
def diffusion_pair():
    jmodel = JaxUnit2Mel(**DIFF_TINY)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, T_DIFF, DIFF_TINY["input_channel"])), jnp.zeros((1, T_DIFF)),
        jnp.zeros((1, T_DIFF)), spk_id=jnp.zeros((1,), jnp.int32), infer=False,
        gt_spec=jnp.zeros((1, T_DIFF, DIFF_TINY["out_dims"]))))["params"]
    params = _fill(shapes, np.random.default_rng(5))
    port = Unit2Mel(**DIFF_TINY).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax.unit2mel(params).items()}, strict=True)
    return params, jmodel, port, pdiff.build_diffusion_onnx(port), jdiff.build_diffusion_onnx(params, jmodel)


def _diffusion_feeds(seed=0):
    rng = np.random.default_rng(seed)
    m, h = DIFF_TINY["out_dims"], DIFF_TINY["n_hidden"]
    mix = rng.uniform(0.2, 0.8, (T_DIFF, DIFF_TINY["n_spk"])).astype(np.float32)
    return {
        "encoder": {"hubert": 0.3 * rng.standard_normal((1, T_DIFF, DIFF_TINY["input_channel"])).astype(np.float32),
                    "mel2ph": np.arange(1, T_DIFF + 1, dtype=np.int64)[None],
                    "f0": rng.uniform(80, 400, (1, T_DIFF)).astype(np.float32),
                    "volume": 0.1 * np.abs(rng.standard_normal((1, T_DIFF))).astype(np.float32),
                    "spk_mix": mix / mix.sum(axis=1, keepdims=True)},
        "denoise": {"noise": rng.standard_normal((1, 1, m, T_DIFF)).astype(np.float32),
                    "time": np.asarray([17], np.int64),
                    "condition": 0.3 * rng.standard_normal((1, h, T_DIFF)).astype(np.float32)},
        "pred": {"noise": rng.standard_normal((1, 1, m, T_DIFF)).astype(np.float32),
                 "noise_pred": rng.standard_normal((1, 1, m, T_DIFF)).astype(np.float32),
                 "time": np.asarray([40], np.int64), "time_prev": np.asarray([15], np.int64)},
        "after": {"x": rng.standard_normal((1, 1, m, T_DIFF)).astype(np.float32)},
    }


@pytest.mark.parametrize("graph", ["encoder", "denoise", "pred", "after"])
def test_diffusion_graph_matches_jax(diffusion_pair, graph):
    _params, _jm, port, port_graphs, jax_graphs = diffusion_pair
    feeds = _diffusion_feeds()[graph]
    got = run_model(port_graphs[graph], feeds, "cpu")
    want = jax_run_model(jax_graphs[graph], feeds)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    # the port's bytes read in the JAX runtime give the same outputs
    for k, v in jax_run_model(port_graphs[graph], feeds).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5)
    if graph == "encoder":  # and the condition is the port module's
        f = {k: torch.from_numpy(v) for k, v in feeds.items()}
        with torch.no_grad():
            cond = port.condition(f["hubert"], f["f0"], f["volume"], f["spk_mix"][None])
        np.testing.assert_allclose(got["mel_pred"], cond.transpose(1, 2).numpy(), rtol=1e-4, atol=1e-5)


def _plms_via_onnx(graphs, x, cond, k_step, speedup):
    """The MoeSS-side PLMS driver (diffusion_onnx.py:494-559) over the graphs,
    each loaded once."""
    sessions = {k: Session(v, "cpu") for k, v in graphs.items()}

    def denoise(x, t):
        return sessions["denoise"]({"noise": x, "time": np.asarray([t], np.int64),
                                    "condition": cond})["noise_pred"]

    def x_pred(x, noise_pred, t, t_prev):
        return sessions["pred"]({"noise": x, "noise_pred": noise_pred, "time": np.asarray([t], np.int64),
                                 "time_prev": np.asarray([t_prev], np.int64)})["noise_pred_o"]

    hist = []
    for stage, t in enumerate(range(k_step - speedup, -1, -speedup)):
        np_t = denoise(x, t)
        t_prev = max(t - speedup, 0)
        if stage == 0:
            np_prime = (np_t + denoise(x_pred(x, np_t, t, t_prev), t_prev)) / 2.0
        elif stage == 1:
            np_prime = (3.0 * np_t - hist[-1]) / 2.0
        elif stage == 2:
            np_prime = (23.0 * np_t - 16.0 * hist[-1] + 5.0 * hist[-2]) / 12.0
        else:
            np_prime = (55.0 * np_t - 59.0 * hist[-1] + 37.0 * hist[-2] - 9.0 * hist[-3]) / 24.0
        hist = (hist + [np_t])[-3:]
        x = x_pred(x, np_prime, t, t_prev)
    return sessions["after"]({"x": x})["mel_out"]


def test_plms_replay_matches_sample_plms(diffusion_pair):
    _params, _jm, port, port_graphs, _jax_graphs = diffusion_pair
    feeds = _diffusion_feeds(seed=3)
    cond = run_model(port_graphs["encoder"], feeds["encoder"], "cpu")["mel_pred"]
    x0 = feeds["denoise"]["noise"]
    speedup, k_step = 10, DIFF_TINY["timesteps"]
    got = _plms_via_onnx(port_graphs, x0, cond, k_step, speedup)
    sched = port.schedule
    with torch.no_grad():
        x = sched.sample_plms(port.decoder["denoise_fn"], torch.from_numpy(x0[:, 0]), k_step, speedup,
                              torch.from_numpy(cond))
        want = sched.denorm_spec(x).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


# -------------------------------------------------------- (d) export and CLI
def _write_g0(tmp_path, name):
    _jhps, phps, _jm, _params, tm, _infer = _models(name)
    phps["spk"] = pcfg.HParams(alto=0, tenor=1)
    pcfg.save_config(phps, tmp_path / "config.json")
    torch.save({"model": tm.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    return str(tmp_path / "G_0.pth"), str(tmp_path / "config.json"), tm


def test_export_synthesizer_round_trip(tmp_path):
    from sovits_tpu_torch.cli.export import export_synthesizer, load_exported

    ckpt, cfg, tm = _write_g0(tmp_path, "slim")
    out = tmp_path / "model.pt2"
    t = 32
    program = export_synthesizer(ckpt, cfg, str(out), t_frames=t, device="cpu")
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"sovits.rel_attention_fwd.default", "sovits.resblock_trio.default"} <= targets
    # the program holds the folded weights and only the modules infer reads
    saved = set(program.state_dict)
    assert not any(k.endswith(("weight_g", "weight_v")) or ".enc_q." in k for k in saved)
    assert "model.dec.conv_pre.weight" in saved
    assert not any(n.target == torch.ops.aten.linalg_vector_norm.default for n in program.graph.nodes)
    # and no cast of a tensor to its own type, nor the metadata asserts beside them
    assert not any(n.target is torch.ops.aten._assert_tensor_metadata.default
                   or (n.target is torch.ops.aten.to.dtype and n.args[0].meta["val"].dtype == n.meta["val"].dtype)
                   for n in program.graph.nodes)
    meta = json.loads(out.with_suffix(".json").read_text())
    assert meta["t_frames"] == t and meta["Characters"] == ["alto", "tenor"]
    call = load_exported(str(out))
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(0.1 * rng.standard_normal((1, t, 16)).astype(np.float32)),
            torch.from_numpy(rng.uniform(100, 300, (1, t)).astype(np.float32)),
            torch.ones(1, t), torch.tensor([1]))
    with torch.no_grad():
        wav = call(*args).numpy()
    want = tm.infer(*args, sample_noise=False)[0].numpy()
    assert np.isfinite(wav).all() and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(wav, want, **PT2_TOL)


def test_export_cli_onnx_sidecar_matches_jax(tmp_path):
    from sovits_tpu_torch.cli import export as export_cli

    ckpt, cfg, tm = _write_g0(tmp_path, "base")
    export_cli.main(["-m", ckpt, "-c", cfg, "-o", str(tmp_path / "tiny.pt2"), "--onnx", "-d", "cpu"])
    data = (tmp_path / "tiny.onnx").read_bytes()
    assert data == build_synthesizer_onnx(tm, pcfg.load_config(cfg), chara_mix=True)
    meta = json.loads((tmp_path / "tiny.json").read_text())
    assert meta == jsynth.moevs_config(jcfg.load_config(cfg), "tiny", chara_mix=True)


def test_export_cli_diffusion(tmp_path, diffusion_pair):
    from sovits_tpu.cli.tools import flatten_params
    from sovits_tpu_torch.cli import export as export_cli

    params, _jm, port, port_graphs, _jax_graphs = diffusion_pair
    cfg = {"data": {"sampling_rate": 8000, "block_size": 64, "encoder_out_channels": DIFF_TINY["input_channel"]},
           "model": {"n_layers": DIFF_TINY["n_layers"], "n_chans": DIFF_TINY["n_chans"],
                     "n_hidden": DIFF_TINY["n_hidden"], "timesteps": DIFF_TINY["timesteps"],
                     "k_step_max": 0, "n_spk": DIFF_TINY["n_spk"], "use_pitch_aug": False},
           "spk": {"a": 0, "b": 1}}
    (tmp_path / "diffusion.yaml").write_text(json.dumps(cfg))
    torch.save({"model": port.state_dict()}, tmp_path / "model_10.pt")
    np.savez(tmp_path / "model_10.npz", **flatten_params(params))
    for ckpt in ("model_10.pt", "model_10.npz"):
        prefix = tmp_path / ckpt.replace(".", "_")
        export_cli.main(["-m", str(tmp_path / ckpt), "-c", str(tmp_path / "diffusion.yaml"),
                         "-o", f"{prefix}.onnx", "--onnx", "--diffusion", "-d", "cpu"])
        for suffix, data in port_graphs.items():
            assert (tmp_path / f"{prefix.name}_{suffix}.onnx").read_bytes() == data, (ckpt, suffix)


# ---------------------------------------------------------------- (e) utils
def test_stage_timer_annotate_trace(tmp_path):
    from sovits_tpu_torch.utils import StageTimer, annotate, count, counters, trace

    timer = StageTimer()
    x = torch.ones(4)
    with annotate("outside"):
        count("outside")
    with trace(tmp_path / "trace") as log_dir:
        for _ in range(2):
            with timer.stage("a"), annotate("region"):
                x = x * 2
                count("region.calls")
                count("region.items", 4)
    with annotate("after"):
        count("after")
    s = timer.summary()
    assert set(s) == {"a"} and s["a"]["count"] == 2 and s["a"]["total_s"] >= 0
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 2)
    assert float(x.sum()) == 16.0
    traces = list(log_dir.glob("trace-*.json"))
    assert len(traces) == 1
    names = [e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]]
    assert names.count("region") == 2 and "outside" not in names and "after" not in names
    written = json.loads(traces[0].with_name(traces[0].name.replace("trace-", "counters-")).read_text())
    assert written == counters() == {"region.calls": 2, "region.items": 8}
