"""The port's inference surface vs the JAX package (CPU).

(a) Host helpers: the slicer, pad_array, split_list_by_n, crossfade,
    rms_envelope, change_rms and the speaker-mix timeline, on the same
    seeded inputs: equal, or within 1e-6 where float32 sums differ.
(b) Svc.slice_inference and RealTimeVC at the tiny width (8 kHz, hop 64),
    with the same G_0.pth and encoder in both packages. The JAX noise
    cannot be drawn in torch, so both packages' ``_run_synth_batch`` run
    with ``sample_noise=False`` here (patched in the test only) and
    ``noice_scale=0``: audio within AUDIO_ATOL. f0 comes from yin, which
    is bit-equal in the two packages: slice_inference pads every chunk with
    zeros, and in all-zero input DIO picks voiced frames out of rounding
    noise, so that its float64 numpy oracle and its native library (the
    JAX package's own build as well as the port's) disagree by up to
    ~200 Hz there. DIO's parity is held on voiced input in
    test_torch_train.py and test_torch_slice.py.
(c) The port's batched dispatch against its per-chunk dispatch.
(d) yin and harvest against the JAX package; the native Harvest stages
    against their numpy oracles.
(e) The infer CLI on the CPU, the flag it rejects and the cluster flags it passes on (its diffusion
    and enhancer flags: test_torch_diffusion.py; -f0p naming an f0 net:
    test_torch_f0nets.py).
"""

import functools
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from sovits_tpu.dsp import audio as jaudio  # noqa: E402
from sovits_tpu.infer import slicer as jslicer  # noqa: E402
from sovits_tpu.infer import spkmix as jspkmix  # noqa: E402
from sovits_tpu.infer import svc as jsvc_mod  # noqa: E402
from sovits_tpu_torch.dsp import audio as taudio  # noqa: E402
from sovits_tpu_torch.infer import slicer as tslicer  # noqa: E402
from sovits_tpu_torch.infer import spkmix as tspkmix  # noqa: E402
from sovits_tpu_torch.infer import svc as tsvc_mod  # noqa: E402
from tests.test_torch_slice import AUDIO_ATOL, _voiced, svc_pair  # noqa: E402,F401
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

SEED = 52468


def _song(sr, segments, gap=1.0, seed=0):
    """Voiced segments of ``segments`` seconds with ``gap`` seconds of
    near-silence between them (and before the first)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, seconds in enumerate(segments):
        parts.append(1e-4 * rng.standard_normal(int(gap * sr)).astype(np.float32))
        parts.append(_voiced(seconds, sr, seed + i))
    return np.concatenate(parts)


# ------------------------------------------------------------- (a) helpers
@pytest.mark.parametrize("sr,segments,gap", [
    (8000, (5.5, 5.0), 1.0),
    (44100, (6.0, 2.0, 7.0), 0.8),
    (16000, (3.0,), 0.2),  # shorter than the slicer's minimum length: one chunk
], ids=["8k", "44k1", "short"])
def test_slicer_matches_jax(sr, segments, gap):
    wav = _song(sr, segments, gap)
    chunks_t = tslicer.cut(wav, sr, db_thresh=-40)
    chunks_j = jslicer.cut(wav, sr, db_thresh=-40)
    assert chunks_t == chunks_j
    if len(segments) > 1:
        assert any(c["slice"] for c in chunks_t.values())  # a silence was cut out
    segs_t = tslicer.chunks2audio(wav, chunks_t)
    segs_j = jslicer.chunks2audio(wav, chunks_j)
    assert [tag for tag, _ in segs_t] == [tag for tag, _ in segs_j]
    for (_, a), (_, b) in zip(segs_t, segs_j):
        np.testing.assert_array_equal(a, b)


def _helper_cases():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1001).astype(np.float32)
    src = (rng.standard_normal(24000) * np.linspace(0.1, 1.0, 24000)).astype(np.float32)
    out = (rng.standard_normal(23990) * 0.3).astype(np.float32)
    return {
        "pad_array": lambda m: [m.pad_array(x, n) for n in (1001, 1400, 1401, 600, 599)],
        "split_list_by_n": lambda m: [list(m.split_list_by_n(x, 300, pre)) for pre in (0, 50)],
        "crossfade": lambda m: [m.crossfade(x[:600], x[400:], 200)],
        "rms_envelope": lambda m: [m.rms_envelope(src, 4000, 2000), m.rms_envelope(x, 128, 20)],
        "change_rms": lambda m: [m.change_rms(src, 8000, out, 8000, r) for r in (0.0, 0.3, 0.5)],
        "spk_mix": lambda m: [m.build_spk_mix_frames(m.EXAMPLE_SPK_MIX_MAP, n, s)
                              for n, s in ((437, 2), (1000, 4))]
        + [m.build_spk_mix_frames({1: [[0.2, 0.6, 0.5, 1.0]]}, 300, 3)],  # zero frames: uniform
    }


@pytest.mark.parametrize("name", list(_helper_cases()))
def test_host_helper_matches_jax(name):
    fn = _helper_cases()[name]
    mods = {"pad_array": (tsvc_mod, jsvc_mod), "split_list_by_n": (tsvc_mod, jsvc_mod),
            "crossfade": (tsvc_mod, jsvc_mod), "rms_envelope": (taudio, jaudio),
            "change_rms": (taudio, jaudio), "spk_mix": (tspkmix, jspkmix)}[name]
    got, want = fn(mods[0]), fn(mods[1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, list):  # split_list_by_n's pieces
            assert len(g) == len(w)
            for gp, wp in zip(g, w):
                np.testing.assert_array_equal(gp, wp)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mix,n_speakers", [
    ({0: [[0.0, 1.0, 1.0, 1.0]], 1: [[0.0, 1.0, 0.5, 0.5]], 2: [[0.0, 1.0, 1, 1]]}, 2),
    ({0: [[0.0, 0.5, -0.1, 1.0]]}, 2),  # negative weight
    ({0: [[0.5, 0.5, 1.0, 1.0]]}, 2),  # empty ramp
    ({0: [[0.0, 0.4, 1.0, 1.0], [0.5, 1.0, 1.0, 1.0]]}, 2),  # a gap between ramps
], ids=["too-many-speakers", "negative", "empty-ramp", "gap"])
def test_spk_mix_rejects_as_jax(mix, n_speakers):
    errors = []
    for mod in (tspkmix, jspkmix):
        with pytest.raises(ValueError) as info:
            mod.build_spk_mix_frames(mix, 200, n_speakers)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# ----------------------------------------------------- (b) slice_inference
@pytest.fixture
def noise_off(monkeypatch):
    """Both packages' synthesizer dispatch with its noise off."""
    for cls in (jsvc_mod.Svc, tsvc_mod.Svc):
        monkeypatch.setattr(cls, "_run_synth_batch",
                            functools.partialmethod(cls._run_synth_batch, sample_noise=False))


SLICE_VARIANTS = {
    "plain": {},
    "clips-lgr0.75": dict(clip_seconds=2.0, lg_num=0.5, lgr_num=0.75),
    "clips-lgr1": dict(clip_seconds=2.0, lg_num=0.5, lgr_num=1),
    "loudness0.5": dict(loudness_envelope_adjustment=0.5),
    "spk-mix": dict(use_spk_mix=True),
}


@pytest.mark.parametrize("variant", list(SLICE_VARIANTS))
def test_slice_inference_matches_jax(svc_pair, noise_off, monkeypatch, variant):
    jsvc, tsvc = svc_pair
    sr, hop = tsvc.target_sample, tsvc.hop_size
    song = _song(sr, (5.5, 5.0), 1.0, seed=4)  # ~12.5 s: two chunks of one bucket
    kw = dict(SLICE_VARIANTS[variant], noice_scale=0.0, f0_predictor="yin")
    spk = jspkmix.EXAMPLE_SPK_MIX_MAP if kw.get("use_spk_mix") else 0
    dispatched = []
    synth = tsvc._run_synth_batch
    monkeypatch.setattr(tsvc, "_run_synth_batch",
                        lambda items, *a, **k: dispatched.append(items) or synth(items, *a, **k))
    got = tsvc.slice_inference(song, sr, spk, 0, **kw)
    want = jsvc.slice_inference(song, sr, spk, 0, **kw)
    # one synthesizer pass over every chunk: the 2 pieces (53440 and 46560
    # samples), or their 4 + 3 forced clips of 2 s
    (items,) = dispatched
    assert len(items) == (7 if "clip_seconds" in kw else 2)
    assert {it["spk"][0] for it in items} == {"mix" if kw.get("use_spk_mix") else "id"}
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    n_chunks = sum(not c["slice"] for c in tslicer.cut(song, sr, db_thresh=-40).values())
    assert abs(len(got) - len(song)) <= hop * n_chunks
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)


def test_slice_inference_options_move_the_audio(svc_pair, noise_off):
    """Each variant takes its own path: it changes the output."""
    _jsvc, tsvc = svc_pair
    song = _song(tsvc.target_sample, (5.5, 5.0), 1.0, seed=4)
    outs = {name: tsvc.slice_inference(song, tsvc.target_sample,
                                       tspkmix.EXAMPLE_SPK_MIX_MAP if kw.get("use_spk_mix") else 0,
                                       0, noice_scale=0.0, f0_predictor="yin", **kw)
            for name, kw in SLICE_VARIANTS.items()}
    for name, out in outs.items():
        if name != "plain":
            n = min(len(out), len(outs["plain"]))
            assert np.abs(out[:n] - outs["plain"][:n]).max() > 1e-6, name


def test_realtime_vc_matches_jax(svc_pair, noise_off):
    jsvc, tsvc = svc_pair
    sr = tsvc.target_sample
    stream = _voiced(3 * 16000 / sr, sr, 7)
    rt_t, rt_j = tsvc_mod.RealTimeVC(), jsvc_mod.RealTimeVC()
    for i in range(3):
        chunk = stream[i * 16000 : (i + 1) * 16000]
        kw = dict(noice_scale=0.0, f0_predictor="yin")
        got = rt_t.process(tsvc, 0, 0, chunk, sr, **kw)
        want = rt_j.process(jsvc, 0, 0, chunk, sr, **kw)
        assert got.shape == want.shape == (rt_t.chunk_len,)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)


# ------------------------------------------------------ (c) batched dispatch
def test_batched_dispatch_matches_single(svc_pair):
    """Three chunks of one bucket run as one batch padded to four rows: with
    the noise off each equals its own batch-1 dispatch."""
    _jsvc, tsvc = svc_pair
    sr = tsvc.target_sample
    items = [tsvc._prepare_chunk(0, 0, _voiced(s, sr, i), sr, 0.0, False, "dio", 0.05)
             for i, s in enumerate((0.9, 1.0, 0.8))]
    assert {next(b for b in tsvc_mod.BUCKETS if b >= it["n_frames"]) for it in items} == {128}
    batched = tsvc._run_synth_batch(items, 0.0, False, SEED, sample_noise=False)
    singles = [tsvc._run_synth_batch([it], 0.0, False, SEED, sample_noise=False)[0] for it in items]
    for b, s, it in zip(batched, singles, items):
        assert b.shape == (it["n_frames"] * tsvc.hop_size,)
        np.testing.assert_allclose(b, s, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ (d) f0
def test_yin_matches_jax():
    from sovits_tpu.f0.yin import YinF0Predictor as JaxYin
    from sovits_tpu_torch.f0.base import get_f0_predictor

    wav = _song(16000, (1.5, 1.0), 0.3, seed=5)
    f0_t, uv_t = get_f0_predictor("yin", hop_length=160, sampling_rate=16000).compute_f0_uv(wav)
    f0_j, uv_j = JaxYin(hop_length=160, sampling_rate=16000).compute_f0_uv(wav)
    assert 0.5 < uv_t.mean() < 1.0
    np.testing.assert_array_equal(uv_t, uv_j)
    np.testing.assert_array_equal(f0_t, f0_j)


@pytest.mark.parametrize("exact", [False, True], ids=["default", "exact"])
def test_harvest_matches_jax(exact):
    """exact: the float64 numpy path on both sides, the same operations: f0
    within 1e-9 Hz. default: float32 filtering and the native stages; the
    port's library is built without -march=native, so its float32 sums may
    round in another vector width (DIO's measured 1.5e-5 Hz): 1e-3 Hz."""
    from sovits_tpu.f0.dio import HarvestF0Predictor as JaxHarvest
    from sovits_tpu_torch.f0.base import get_f0_predictor

    wav = _song(16000, (1.2, 0.8), 0.3, seed=6)
    port = get_f0_predictor("harvest", hop_length=160, sampling_rate=16000)
    ref = JaxHarvest(hop_length=160, sampling_rate=16000)
    port.exact = ref.exact = exact
    f0_t, uv_t = port.compute_f0_uv(wav)
    f0_j, uv_j = ref.compute_f0_uv(wav)
    assert 0.5 < uv_t.mean() < 1.0
    np.testing.assert_array_equal(uv_t, uv_j)
    np.testing.assert_allclose(f0_t, f0_j, rtol=0, atol=1e-9 if exact else 1e-3)


def test_native_harvest_remove_unreliable_matches_numpy():
    """The C++ stage 7 equals the numpy sentinel-sort oracle (the port's
    copy and the JAX package's), bit for bit: clustered candidates so the 5%
    gate keeps and kills, and an empty frame, which kills its neighbours."""
    from sovits_tpu.f0.world_harvest import _remove_unreliable as jax_remove
    from sovits_tpu_torch import native
    from sovits_tpu_torch.f0.world_harvest import UNRELIABLE_THRESHOLD, _remove_unreliable

    rng = np.random.default_rng(7)
    for _ in range(25):
        n_frames, k = int(rng.integers(2, 200)), int(rng.integers(1, 40))
        cands = np.where(rng.random((n_frames, k)) < 0.35, rng.uniform(60, 1100, (n_frames, k)), 0.0)
        base = rng.uniform(80, 400)
        cands = np.where(rng.random((n_frames, k)) < 0.3, base * rng.uniform(0.97, 1.03, (n_frames, k)),
                         cands)
        cands[rng.integers(0, n_frames)] = 0.0
        scores = np.where(cands > 0, rng.uniform(1, 10, (n_frames, k)), 0.0)
        c_np, s_np = cands.copy(), scores.copy()
        _remove_unreliable(c_np, s_np)
        c_jax, s_jax = cands.copy(), scores.copy()
        jax_remove(c_jax, s_jax)
        c_cc, s_cc = cands.copy(), scores.copy()
        native.world_harvest_remove_unreliable(c_cc, s_cc, UNRELIABLE_THRESHOLD)
        np.testing.assert_array_equal(c_np, c_jax)
        np.testing.assert_array_equal(c_cc, c_np)
        np.testing.assert_array_equal(s_cc, s_np)


@pytest.mark.parametrize("stage", ["band_candidates_f64", "band_candidates_f32", "refine_f0"])
def test_native_harvest_stage_matches_numpy(stage):
    """The native Harvest stages 3 (a chunk of channels in one call, float64
    and float32 in, as the default path passes them) and 6 against the
    port's numpy oracles on band-filtered noise-plus-tone channels. The
    library widens float32 input to float64, so the oracle reads the same
    values: the same operations, up to libm and summation order (measured
    ~1e-13)."""
    from sovits_tpu_torch import native
    from sovits_tpu_torch.f0 import world_harvest as wh
    from sovits_tpu_torch.f0.world_dio import _get_mean_f0_grouped, nuttall_window

    fs, n = 8000.0, 8000
    rng = np.random.default_rng(8)
    y = _voiced(n / fs, int(fs), 9).astype(np.float64) + 0.01 * rng.standard_normal(n)
    tpos = np.arange(int(n / fs * 1000.0) + 1) / 1000.0
    if stage == "refine_f0":
        pos = rng.uniform(0.05, 0.95, 300)
        f0s = rng.uniform(120, 260, 300)
        scores = np.zeros(300)
        want = _get_mean_f0_grouped(y, fs, pos, f0s, scores=scores)
        got, got_scores = native.world_refine_f0(y, fs, pos, f0s)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got_scores, scores, rtol=1e-9, atol=1e-9)
        return
    bounds = 64.0 * 2.0 ** (np.arange(30, 70, 3) / wh.CHANNELS_IN_OCTAVE)
    halves = np.asarray([wh._band_half_width(fs, b) for b in bounds], np.int64)
    filt = np.zeros((len(bounds), n + 4 * int(halves.max()) + 2))
    for j, (b, h) in enumerate(zip(bounds, halves)):
        fir = nuttall_window(2 * h + 1) * np.cos(2 * np.pi * b * np.arange(2 * h + 1) / fs)
        filt[j, : n + 2 * h] = np.convolve(y, fir)
    if stage == "band_candidates_f32":
        filt = filt.astype(np.float32)
    want = np.stack([
        wh._band_candidate_from_filtered(filt[j, h : h + n].astype(np.float64), fs, b, 58.0, 1210.0, tpos)
        for j, (b, h) in enumerate(zip(bounds, halves))])
    assert (want > 0).mean() > 0.05  # channels near the tone's f0 give candidates
    got = native.world_harvest_band_candidates_multi(filt, halves, n, fs, bounds, 58.0, 1210.0,
                                                     wh.TRACK_AGREEMENT, tpos)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kwarg", ["cluster_model_path", "feature_retrieval"])
def test_svc_rejects_what_it_does_not_run(svc_pair, tmp_path, kwarg):
    """The Svc arguments for cluster retrieval (ported; test_torch_cluster.py
    holds the blend against the JAX package): an existing cluster model path
    is read at once, so a file that is no cluster model is rejected as the
    JAX package's loader rejects it, before any request; feature_retrieval
    without a cluster model loads nothing and leaves a request unchanged."""
    from sovits_tpu import cluster as jcluster
    from sovits_tpu_torch import config as tcfg

    _jsvc, tsvc = svc_pair
    tcfg.save_config(tsvc.hps, tmp_path / "config.json")
    torch.save({"model": tsvc.model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    args = (str(tmp_path / "G_0.pth"), str(tmp_path / "config.json"))
    if kwarg == "cluster_model_path":
        (tmp_path / "kmeans.pt").write_bytes(b"")
        with pytest.raises(Exception) as jax_error:
            jcluster.load_cluster_model(str(tmp_path / "kmeans.pt"))
        with pytest.raises(type(jax_error.value)):
            tsvc_mod.Svc(*args, encoder=tsvc.encoder, device="cpu", cluster_model_path=str(tmp_path / "kmeans.pt"))
        return
    svc = tsvc_mod.Svc(*args, encoder=tsvc.encoder, device="cpu", feature_retrieval=True)
    assert svc.cluster is None and svc.feature_retrieval
    svc.f0_predictor_object = tsvc.f0_predictor_object
    wav = _voiced(0.5, svc.target_sample, 0)
    want, *_ = svc.infer(0, 0, wav, f0_predictor="dio")
    got, *_ = svc.infer(0, 0, wav, f0_predictor="dio", cluster_infer_ratio=0.5)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ (e) CLI
@pytest.fixture
def cli_dir(svc_pair, tmp_path, monkeypatch):
    """A tiny G_0.pth, its config (speakers "alto" and "tenor") and a 12 s song in a fresh working
    directory; the CLI's encoder is svc_pair's tiny one."""
    from sovits_tpu_torch import config as tcfg
    from sovits_tpu_torch.encoders import factory as enc_factory

    _jsvc, tsvc = svc_pair
    tcfg.save_config(tsvc.hps, tmp_path / "config.json")
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg["spk"] = {"alto": 0, "tenor": 1}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    torch.save({"model": tsvc.model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    song = _song(tsvc.target_sample, (5.5, 5.0), 1.0, seed=10)
    wavfile.write(tmp_path / "song.wav", tsvc.target_sample, (song * 32767).astype(np.int16))
    monkeypatch.setattr(enc_factory, "get_speech_encoder", lambda name, device="cuda": tsvc.encoder)
    monkeypatch.chdir(tmp_path)
    return tmp_path, len(song)


def test_cli_infer_writes_result(cli_dir, capsys):
    from sovits_tpu_torch.cli import infer as cli

    tmp, n = cli_dir
    cli.main(["-m", "G_0.pth", "-c", "config.json", "-n", "song.wav", "-t", "2", "-s", "tenor",
              "-f0p", "dio", "-d", "cpu"])
    out = tmp / "results" / "song_2key_tenor_sovits_dio.wav"
    assert f"wrote {out.relative_to(tmp)}" in capsys.readouterr().out
    sr, audio = wavfile.read(out)
    assert sr == 8000 and audio.dtype == np.int16
    assert abs(len(audio) - n) <= 2 * 64  # two chunks, each within a hop
    assert np.abs(audio).max() > 0


@pytest.mark.parametrize("flags,named", [
    (["-fr"], "--feature_retrieval"),
    (["-cm", "kmeans.pt"], "--cluster_model_path"),
    (["-cr", "0.5"], "--cluster_infer_ratio"),
    (["-ss", "4"], "--seq_shard"),
], ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_cli_rejects_unsupported_flag(tmp_path, monkeypatch, flags, named):
    """The cluster flags and -ss, ported, reach Svc and slice_inference (-ss:
    infer_seq_parallel with n_shards) as the JAX CLI passes them (the CLI run
    with a cluster model: test_torch_cluster.py; -ss through the real Svc:
    test_torch_parallel.py)."""
    from sovits_tpu_torch.cli import infer as cli

    monkeypatch.chdir(tmp_path)
    (tmp_path / "kmeans.pt").write_bytes(b"")
    wavfile.write(tmp_path / "song.wav", 8000, np.zeros(800, np.int16))
    loaded, sliced = [], []

    class FakeSvc:
        target_sample = 8000

        def __init__(self, *a, **k):
            loaded.append(k)

        def slice_inference(self, *a, **k):
            sliced.append(k)
            return np.zeros(8, np.float32)

        def infer_seq_parallel(self, *a, **k):
            sliced.append(k)
            return np.zeros(8, np.float32), 8, 1

    monkeypatch.setattr(cli, "Svc", FakeSvc)
    argv = ["-m", "G_0.pth", "-n", "song.wav", *flags]
    cli.main(argv)
    if named == "--seq_shard":
        assert sliced[0]["n_shards"] == 4
        assert (tmp_path / "results" / "song_0key_0_sovits_pm.wav").exists()
    (kw,) = loaded
    assert kw["cluster_model_path"] == ("kmeans.pt" if "-cm" in flags else None)
    assert kw["feature_retrieval"] == ("-fr" in flags)
    assert sliced[0]["cluster_infer_ratio"] == (0.5 if "-cr" in flags else 0.0)


def test_cli_ignores_a_cluster_path_that_does_not_exist(tmp_path, monkeypatch):
    """As the JAX CLI: -cm naming no file loads no cluster model and raises nothing."""
    from sovits_tpu_torch.cli import infer as cli

    monkeypatch.chdir(tmp_path)
    args = cli.build_parser().parse_args(["-m", "G_0.pth", "-n", "song.wav", "-cm", "none.pt"])
    assert cli.seq_shard_conflicts(args) == []
    assert args.device == "cuda"


def test_svc_ignores_a_cluster_path_that_does_not_exist(cli_dir):
    """As the JAX Svc: a missing cluster model loads nothing, and a cluster
    ratio without a model is ignored."""
    svc = tsvc_mod.Svc("G_0.pth", "config.json", cluster_model_path="none.pt", device="cpu")
    assert svc.cluster is None
    wav = _voiced(0.5, svc.target_sample, 0)
    want, *_ = svc.infer(0, 0, wav, f0_predictor="yin")
    got, *_ = svc.infer(0, 0, wav, f0_predictor="yin", cluster_infer_ratio=0.5)
    np.testing.assert_array_equal(got, want)
