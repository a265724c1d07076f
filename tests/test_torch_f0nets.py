"""The port's f0 nets (RMVPE, FCPE, CREPE) vs the JAX package (CPU).

No trained rmvpe.pt, fcpe.pt or torchcrepe checkpoint is in the
repository, so every net here carries seeded random weights at small
widths (RMVPE: 1 block per level, 4 channels at the top level, GRU width
16, all 5/4/5 levels; FCPE: 2 layers at the published width 512; CREPE:
"tiny"). The port's net draws them (``factory.init_random_``) as a
state_dict in the published key names; the JAX package's own
``convert_*_state_dict`` takes that state_dict to its variables, so both
packages run the same weights.

(a) The mel front ends against JAX (rtol 1e-5).
(b) Each net's salience against JAX (fp32, atol SAL_ATOL).
(c) The host decoders bit-equal on one salience array.
(d) Each whole predictor through ``compute_f0_uv``. With random weights a
    frame's top two salience bins can lie within rounding of each other, and
    its decoded f0 may then flip between them without any fault, so f0 is
    compared on the frames whose JAX salience has its top two bins more
    than CLEAR = 100 x SAL_ATOL apart (and on the output frames that only
    such frames feed); each test asserts how many frames those are. CREPE
    tiny's random classifier gives a flat salience, so its classifier
    weights are scaled up (the same weights in both packages). The
    predictors' f0 range (F0_RANGE) spans all 360 bins.
(e) The JAX tree -> ``from_jax`` -> ``convert_*_state_dict`` round trip is
    the JAX tree exactly, and what ``from_jax`` writes loads strictly.
(f) FileNotFoundError without weights in both packages, and from the
    infer CLI of both with ``-f0p`` naming a net.
(g) One ``Svc.infer`` with an RMVPE predictor set on both packages'
    ``Svc`` (noise off); in a bf16 ``Svc`` the net stays float32.
"""

import functools
import re

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from sovits_tpu.f0 import base as jbase  # noqa: E402
from sovits_tpu.f0 import crepe as jcrepe  # noqa: E402
from sovits_tpu.f0 import fcpe as jfcpe  # noqa: E402
from sovits_tpu.f0 import rmvpe as jrmvpe  # noqa: E402
from sovits_tpu.infer import svc as jsvc_mod  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.f0 import base as tbase  # noqa: E402
from sovits_tpu_torch.f0 import crepe as tcrepe  # noqa: E402
from sovits_tpu_torch.f0 import fcpe as tfcpe  # noqa: E402
from sovits_tpu_torch.f0 import rmvpe as trmvpe  # noqa: E402
from sovits_tpu_torch.infer import svc as tsvc_mod  # noqa: E402
from sovits_tpu_torch.models.factory import init_random_  # noqa: E402
from tests.test_torch_slice import AUDIO_ATOL, _voiced, svc_pair  # noqa: E402,F401
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

SAL_ATOL = 1e-4  # fp32 on both sides; sums in another order
CLEAR = 100 * SAL_ATOL
RMVPE_SMALL = dict(n_blocks=1, en_out_channels=4, gru_hidden=16)
FCPE_SMALL = dict(n_layers=2)
CREPE_CLASSIFIER_SCALE = 8.0
SR, HOP = 44100, 512
# random weights put a frame's peak anywhere in the 360 bins (32 Hz to
# 2 kHz): with this range every frame keeps its own f0, where 50-1100 Hz
# (the default) would zero many and fill them in from their neighbours
F0_RANGE = dict(f0_min=30.0, f0_max=2100.0)


def _wav(seconds, sr=16000, seed=0):
    """A tone gliding 150-300 Hz with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f = 150.0 + 150.0 * t / seconds
    return (0.3 * np.sin(2 * np.pi * np.cumsum(f) / sr)
            + 0.03 * rng.standard_normal(len(t))).astype(np.float32)


def _state_dict(net: torch.nn.Module, seed: int) -> dict:
    init_random_(net, torch.Generator().manual_seed(seed))
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def _jax_rmvpe_variables(sd: dict) -> dict:
    """convert_rmvpe_state_dict reads four blocks a level (the published
    net's); a 1-block net's state_dict is handed over with block 0's
    entries repeated, and the repeats are dropped from the result."""
    padded = dict(sd)
    for key, value in sd.items():
        m = re.match(r"(unet\.(?:encoder|intermediate)\.layers\.\d+\.conv\.|"
                     r"unet\.decoder\.layers\.\d+\.conv2\.)0\.(.*)", key)
        if m:
            for j in (1, 2, 3):
                padded[f"{m.group(1)}{j}.{m.group(2)}"] = value
    variables = jrmvpe.convert_rmvpe_state_dict(padded)
    for collection in variables.values():
        for level in collection.values():
            if isinstance(level, dict):
                for j in (1, 2, 3):
                    level.pop(f"block_{j}", None)
    return variables


@functools.lru_cache(maxsize=None)
def _weights(kind: str):
    """(port state_dict, JAX variables) of the small seeded net ``kind``."""
    if kind == "rmvpe":
        sd = _state_dict(trmvpe.RmvpeNet(**RMVPE_SMALL), 0)
        return sd, _jax_rmvpe_variables(sd)
    if kind == "fcpe":
        sd = _state_dict(tfcpe.FcpeNet(**FCPE_SMALL), 1)
        return sd, {"params": jfcpe.convert_fcpe_state_dict(sd, n_layers=FCPE_SMALL["n_layers"])}
    sd = _state_dict(tcrepe.CrepeNet("tiny"), 2)
    sd["classifier.weight"] = sd["classifier.weight"] * CREPE_CLASSIFIER_SCALE
    return sd, jcrepe.convert_crepe_state_dict(sd)


@pytest.fixture(scope="module")
def predictors():
    """{kind: (JAX predictor, port predictor on the CPU)} with the same
    weights, at 44.1 kHz and hop 512; each package's predictor builds its
    net at the small widths (its net class patched while it is built)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrmvpe, "RmvpeNet", functools.partial(jrmvpe.RmvpeNet, **RMVPE_SMALL))
        mp.setattr(trmvpe, "RmvpeNet", functools.partial(trmvpe.RmvpeNet, **RMVPE_SMALL))
        mp.setattr(jfcpe, "FcpeNet", functools.partial(jfcpe.FcpeNet, **FCPE_SMALL))
        mp.setattr(tfcpe, "FcpeNet", functools.partial(tfcpe.FcpeNet, **FCPE_SMALL))
        for kind in ("rmvpe", "fcpe", "crepe"):
            sd, variables = _weights(kind)
            kw = dict(F0_RANGE, **dict(capacity="tiny") if kind == "crepe" else {})
            out[kind] = (jbase.get_f0_predictor(kind, HOP, SR, weights=variables, **kw),
                         tbase.get_f0_predictor(kind, HOP, SR, weights=sd, device="cpu", **kw))
    return out


def _clear(salience: np.ndarray) -> np.ndarray:
    """Frames whose top two bins lie more than CLEAR apart."""
    top = np.sort(salience, axis=-1)
    return top[..., -1] - top[..., -2] > CLEAR


def _jax_run(jp, wav: np.ndarray):
    """The JAX predictor's compute_f0_uv, and the salience its net gave
    inside that call (on the 10 ms grid, or one row a frame for CREPE)."""
    attr = "_forward" if isinstance(jp, jcrepe.CrepeF0Predictor) else "_fn"
    fn, seen = getattr(jp, attr), []
    setattr(jp, attr, lambda *a: seen.append(np.asarray(fn(*a))) or seen[-1])
    try:
        f0, uv = jp.compute_f0_uv(wav)
    finally:
        setattr(jp, attr, fn)
    (salience,) = seen
    return f0, uv, salience if salience.ndim == 2 else salience[0]


@pytest.fixture(scope="module")
def runs(predictors):
    """{kind: (JAX f0, uv, salience), (port f0, uv, salience)} of one 1.5 s
    44.1 kHz clip; the grid saliences are cut to the unpadded frames."""
    from sovits_tpu_torch.dsp.audio import resample

    wav = _wav(1.5, SR, seed=3)
    wav16 = resample(wav, SR, 16000)
    out = {}
    for kind, (jp, tp) in predictors.items():
        jf0, juv, jsal = _jax_run(jp, wav)
        tf0, tuv = tp.compute_f0_uv(wav)
        if kind == "crepe":
            tsal = tp.salience(wav, len(wav) // HOP)
        else:
            tsal = tp.salience(wav16)
            jsal = jsal[: len(tsal)]
        out[kind] = (jf0, juv, jsal), (tf0, tuv, tsal)
    return out


# ------------------------------------------------------------ (a) mels
@pytest.mark.parametrize("kind", ["rmvpe", "fcpe"])
def test_mel_matches_jax(kind):
    wav = _wav(1.0, seed=1)[None]
    if kind == "rmvpe":
        want, got = jrmvpe.rmvpe_mel(jnp.asarray(wav)), trmvpe.rmvpe_mel(torch.from_numpy(wav))
    else:
        want, got = jfcpe.fcpe_mel(jnp.asarray(wav)), tfcpe.fcpe_mel(torch.from_numpy(wav))
    assert got.shape == want.shape == (1, 101 if kind == "rmvpe" else 100, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- (b) salience
@pytest.mark.parametrize("kind", ["rmvpe", "fcpe", "crepe"])
def test_salience_matches_jax(runs, kind):
    (_, _, jsal), (_, _, tsal) = runs[kind]
    assert tsal.shape == jsal.shape and tsal.shape[1] == 360
    assert jsal.std() > 1e-2  # not a constant
    np.testing.assert_allclose(tsal, jsal, rtol=0, atol=SAL_ATOL)


# ------------------------------------------------------- (c) decoders
def test_decoders_bit_equal():
    rng = np.random.default_rng(4)
    salience = rng.uniform(0, 0.2, (64, 360)).astype(np.float32)
    salience[np.arange(64), rng.integers(0, 360, 64)] += 0.6  # a peak a frame, some at the edges
    salience[:4, :3] = 0.9
    salience[4:8, -2:] = 0.9
    salience[8:12] = 0.01  # below every threshold
    np.testing.assert_array_equal(trmvpe.to_local_average_cents(salience, 0.03),
                                  jrmvpe.to_local_average_cents(salience, 0.03))
    table = tfcpe.cent_table(32.70, 1975.5, 360)
    np.testing.assert_array_equal(table, jfcpe.FcpeNet().cent_table)
    np.testing.assert_array_equal(tfcpe.cents_local_decoder(salience, table, 0.05),
                                  jfcpe.cents_local_decoder(salience, table, 0.05))
    for got, want in zip(tcrepe.decode_salience(salience, 0.05), jcrepe.decode_salience(salience, 0.05)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- (d) predictors
# per predictor: the clear frames of its salience (of 151 and 150 on the
# 10 ms grid, 129 for CREPE) and the output frames compared (of 129)
CLEAR_AND_COMPARED = {"rmvpe": (113, 90), "fcpe": (106, 84), "crepe": (129, 129)}


@pytest.mark.parametrize("kind", ["rmvpe", "fcpe", "crepe"])
def test_predictor_matches_jax_where_not_near_ties(runs, kind):
    (jf0, juv, jsal), (tf0, tuv, _) = runs[kind]
    p_len = int(1.5 * SR) // HOP
    assert jf0.shape == tf0.shape == juv.shape == tuv.shape == (p_len,)
    clear = _clear(jsal)
    if kind == "crepe":
        fed_by_clear = clear
    else:  # an output frame interpolates the two grid frames around it
        i = np.floor(np.arange(p_len) * HOP / SR / 0.01 + 1e-9).astype(int)
        fed_by_clear = clear[i] & clear[np.minimum(i + 1, len(clear) - 1)]
    np.testing.assert_array_equal(tuv[fed_by_clear], juv[fed_by_clear])
    compared = fed_by_clear & (juv > 0)  # voiced frames carry their own f0, not an interpolation
    print(f"{kind}: {clear.sum()} of {len(clear)} salience frames clear, "
          f"{compared.sum()} of {p_len} output frames compared")
    assert (clear.sum(), compared.sum()) == CLEAR_AND_COMPARED[kind]
    np.testing.assert_allclose(tf0[compared], jf0[compared], rtol=1e-5)


# ------------------------------------------------------- (e) round trip
ROUND_TRIP = {  # JAX module, input for its shapes, from_jax, back, port net, at small widths
    "rmvpe": (lambda: jrmvpe.RmvpeNet(en_out_channels=4, gru_hidden=16), (1, 32, 128),
              from_jax.rmvpe, jrmvpe.convert_rmvpe_state_dict,
              lambda: trmvpe.RmvpeNet(en_out_channels=4, gru_hidden=16)),
    "fcpe": (lambda: jfcpe.FcpeNet(**FCPE_SMALL), (1, 20, 128),
             lambda v: from_jax.fcpe(v["params"]),
             lambda sd: {"params": jfcpe.convert_fcpe_state_dict(sd, n_layers=FCPE_SMALL["n_layers"])},
             lambda: tfcpe.FcpeNet(**FCPE_SMALL)),
    "crepe": (lambda: jcrepe.CrepeNet(capacity="tiny"), (2, 1024), from_jax.crepe,
              jcrepe.convert_crepe_state_dict, lambda: tcrepe.CrepeNet("tiny")),
}


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("kind", list(ROUND_TRIP))
def test_from_jax_round_trip_is_exact(kind):
    """A JAX tree with the JAX module's own structure (from eval_shape: four
    blocks a level for RMVPE, as convert_rmvpe_state_dict reads), filled
    with seeded values -> from_jax -> the JAX package's converter: the same
    tree; and from_jax's state_dict loads strictly into the port's net."""
    make_jax, shape, to_torch, to_jax, make_port = ROUND_TRIP[kind]
    shapes = jax.eval_shape(make_jax().init, jax.random.PRNGKey(0), jnp.zeros(shape))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)
    sd = to_torch(tree)
    _assert_trees_equal(to_jax(sd), tree)
    net = make_port()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    for k, v in sd.items():
        np.testing.assert_array_equal(net.state_dict()[k].numpy(), v, err_msg=k)


# ------------------------------------------- (f) weights are required
@pytest.mark.parametrize("kind", ["crepe", "rmvpe", "fcpe"])
def test_f0_net_without_weights_raises_as_jax(kind):
    for get in (jbase.get_f0_predictor, tbase.get_f0_predictor):
        with pytest.raises(FileNotFoundError):
            get(kind, HOP, SR)


@pytest.mark.parametrize("kind", ["crepe", "rmvpe", "fcpe"])
def test_cli_f0_net_without_weights_raises_as_jax(svc_pair, tmp_path, monkeypatch, kind):
    """-f0p naming a net goes through to get_f0_predictor in both packages'
    CLIs, which have no flag for its weights: both raise FileNotFoundError
    at the first chunk."""
    from sovits_tpu.cli import infer as jcli
    from sovits_tpu.models import factory as jfactory
    from sovits_tpu_torch import config as tcfg
    from sovits_tpu_torch.cli import infer as tcli

    jsvc, tsvc = svc_pair
    tcfg.save_config(tsvc.hps, tmp_path / "config.json")
    torch.save({"model": tsvc.model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    wavfile.write(tmp_path / "song.wav", tsvc.target_sample,
                  (_voiced(1.0, tsvc.target_sample, 0) * 32767).astype(np.int16))
    monkeypatch.chdir(tmp_path)
    # the JAX Svc's param template, without compiling its init graph
    monkeypatch.setattr(jfactory, "init_synthesizer_params", lambda *a, **k: jsvc.params)
    for main, device in ((jcli.main, []), (tcli.main, ["-d", "cpu"])):
        with pytest.raises(FileNotFoundError):
            main(["-m", "G_0.pth", "-c", "config.json", "-n", "song.wav", "-f0p", kind, *device])
    assert not (tmp_path / "results" / f"song_0key_0_sovits_{kind}.wav").exists()


# ------------------------------------------------------------ (g) Svc
def test_svc_infer_with_rmvpe_matches_jax(svc_pair, monkeypatch):
    """Svc.infer on both packages with an RMVPE predictor set as
    f0_predictor_object (the same small seeded net), noise off."""
    jsvc, tsvc = svc_pair
    for cls in (jsvc_mod.Svc, tsvc_mod.Svc):
        monkeypatch.setattr(cls, "_run_synth_batch",
                            functools.partialmethod(cls._run_synth_batch, sample_noise=False))
    sd, variables = _weights("rmvpe")
    sr, hop = tsvc.target_sample, tsvc.hop_size
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrmvpe, "RmvpeNet", functools.partial(jrmvpe.RmvpeNet, **RMVPE_SMALL))
        mp.setattr(trmvpe, "RmvpeNet", functools.partial(trmvpe.RmvpeNet, **RMVPE_SMALL))
        jsvc.f0_predictor_object = jrmvpe.RmvpeF0Predictor(hop_length=hop, sampling_rate=sr,
                                                           weights=variables, **F0_RANGE)
        tsvc.f0_predictor_object = trmvpe.RmvpeF0Predictor(hop_length=hop, sampling_rate=sr,
                                                           weights=sd, device="cpu", **F0_RANGE)
    wav = _voiced(1.0, sr, 2)
    # no frame of this clip is a near-tie (its least top-two gap is 3.0e-3,
    # 30 x SAL_ATOL), so f0 and the audio are compared over the whole clip
    _, _, jsal = _jax_run(jsvc.f0_predictor_object, wav)
    top = np.sort(jsal[: len(wav) * 16000 // sr // 160 + 1], axis=-1)
    assert (top[:, -1] - top[:, -2]).min() > 10 * SAL_ATOL
    outs = [svc.infer(0, 0, wav, sr=sr, f0_predictor="rmvpe", noice_scale=0.0) for svc in (jsvc, tsvc)]
    (aj, nj, fj), (at, nt, ft) = outs
    assert isinstance(tsvc.f0_predictor_object, trmvpe.RmvpeF0Predictor)  # kept: its name matches
    assert nt == nj and ft == fj == len(wav) // hop
    assert np.isfinite(at).all() and np.abs(at).max() > 1e-4
    np.testing.assert_allclose(at, aj, rtol=0, atol=AUDIO_ATOL)


def test_f0_net_stays_float32_in_a_bf16_svc(svc_pair, tmp_path):
    """A bf16 Svc computes its synthesizer in bf16; the f0 net it is given
    keeps float32, so the chunk's f0 is the predictor's own."""
    from sovits_tpu_torch import config as tcfg

    _, tsvc = svc_pair
    tcfg.save_config(tsvc.hps, tmp_path / "config.json")
    torch.save({"model": tsvc.model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    svc = tsvc_mod.Svc(str(tmp_path / "G_0.pth"), str(tmp_path / "config.json"), encoder=tsvc.encoder,
                       device="cpu", dtype=torch.bfloat16)
    sd, _ = _weights("rmvpe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trmvpe, "RmvpeNet", functools.partial(trmvpe.RmvpeNet, **RMVPE_SMALL))
        svc.f0_predictor_object = trmvpe.RmvpeF0Predictor(hop_length=svc.hop_size,
                                                          sampling_rate=svc.target_sample,
                                                          weights=sd, device="cpu")
    wav = _voiced(1.0, svc.target_sample, 4)
    item = svc._prepare_chunk(0, 0, wav, svc.target_sample, 0.0, False, "rmvpe", 0.05)
    assert all(p.dtype == torch.float32 for p in svc.f0_predictor_object.net.parameters())
    f0, uv = svc.f0_predictor_object.compute_f0_uv(wav)
    np.testing.assert_array_equal(item["f0"], f0)
    np.testing.assert_array_equal(item["uv"], uv)
    audio = svc._run_synth_batch([item], 0.0, False, 52468, sample_noise=False)[0]
    assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-4


# --------------------------------------------- (h) FCPE's model range
FCPE_RANGE = dict(f0_min_model=50.0, f0_max_model=1000.0)


def test_fcpe_model_range_matches_jax():
    """f0_min_model / f0_max_model (50 / 1000 Hz) in both packages: the cent
    table the decoder uses is the JAX one, and the decoded f0 agrees on the
    frames whose salience has its top two bins clear (as in (d))."""
    sd, variables = _weights("fcpe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfcpe, "FcpeNet", functools.partial(jfcpe.FcpeNet, **FCPE_SMALL))
        mp.setattr(tfcpe, "FcpeNet", functools.partial(tfcpe.FcpeNet, **FCPE_SMALL))
        jp = jbase.get_f0_predictor("fcpe", HOP, SR, weights=variables, **F0_RANGE, **FCPE_RANGE)
        tp = tbase.get_f0_predictor("fcpe", HOP, SR, weights=sd, device="cpu", **F0_RANGE, **FCPE_RANGE)
    np.testing.assert_array_equal(tp.table, jp.net.cent_table)
    np.testing.assert_array_equal(tp.net.cent_table.numpy(), jp.net.cent_table)
    assert tp.table[0] == pytest.approx(1200 * np.log2(5.0)) and tp.table[-1] == pytest.approx(1200 * np.log2(100.0))
    wav = _wav(1.5, SR, seed=3)
    jf0, juv, jsal = _jax_run(jp, wav)
    tf0, tuv = tp.compute_f0_uv(wav)
    p_len = int(1.5 * SR) // HOP
    i = np.floor(np.arange(p_len) * HOP / SR / 0.01 + 1e-9).astype(int)
    clear = _clear(jsal)
    fed_by_clear = clear[i] & clear[np.minimum(i + 1, len(clear) - 1)]
    np.testing.assert_array_equal(tuv[fed_by_clear], juv[fed_by_clear])
    compared = fed_by_clear & (juv > 0)
    assert (clear.sum(), compared.sum()) == CLEAR_AND_COMPARED["fcpe"]
    np.testing.assert_allclose(tf0[compared], jf0[compared], rtol=1e-5)
    assert tf0[compared].min() >= 50.0 and tf0[compared].max() <= 1000.0


def test_fcpe_state_dict_cannot_put_back_another_range():
    """A state_dict written for the default range (the published fcpe.pt's
    buffers) loaded into a 50-1000 Hz net: the buffers follow the net's range."""
    sd, _ = _weights("fcpe")
    net = tfcpe.FcpeNet(**FCPE_SMALL, f0_min=50.0, f0_max=1000.0)
    assert not np.array_equal(sd["cent_table"], tfcpe.cent_table(50.0, 1000.0, 360))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    np.testing.assert_array_equal(net.cent_table.numpy(), tfcpe.cent_table(50.0, 1000.0, 360))
    assert net.gaussian_blurred_cent_mask.item() == pytest.approx(1200 * np.log2(100.0))
