"""The port's k-means, cluster store and feature retrieval vs the JAX
package (CPU), and their use through Svc, slice_inference, the infer CLI
and train_cluster.

The banks are the tiny encoder's own units (``svc_pair``'s, 64 wide) of
three voiced clips: k-means centers fitted by the port, and the raw units
as a retrieval bank. Both packages get the same arrays (through each
other's ``.npz`` where a file is read).

A nearest center, or the 8 nearest bank rows, may flip between the
packages where two distances lie within rounding of each other; the
replacement is then another row, without any fault. So indices are
compared on the rows whose deciding gap (the top two distances, or the 8th
and 9th) is wider than CLEAR of the distance's scale, and each test asserts
how many rows those are.

(a) kmeans_predict / nearest_centers and blend_retrieval against JAX.
(b) kmeans_fit recovers well-separated centers, as JAX's does.
(c) The .npz read across both packages; so-vits-svc's kmeans_10000.pt dict.
(d) Svc.get_unit_f0 (ratio 0.5 and 0.8), Svc.infer and slice_inference at
    ratio 0.5, k-means and retrieval, against the JAX Svc with the noise off
    (AUDIO_ATOL).
(e) The infer CLI with -cm -cr -fr, and train_cluster on a tiny dataset.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from sovits_tpu import cluster as jcluster  # noqa: E402
from sovits_tpu.cluster import store as jstore  # noqa: E402
from sovits_tpu.infer import svc as jsvc_mod  # noqa: E402
from sovits_tpu_torch import cluster as tcluster  # noqa: E402
from sovits_tpu_torch.cluster import kmeans as tkmeans  # noqa: E402
from sovits_tpu_torch.cluster import store as tstore  # noqa: E402
from sovits_tpu_torch.infer import svc as tsvc_mod  # noqa: E402
from tests.test_torch_infer import _song, cli_dir  # noqa: E402,F401
from tests.test_torch_slice import AUDIO_ATOL, _voiced, svc_pair  # noqa: E402,F401
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

UNITS_ATOL = 1e-4  # fp32 both sides: the encoders' units bar
CLEAR = 1e-4  # a deciding gap, relative to the largest distance of its row
RATIO = 0.5


def _rng_data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _sq_dists(x, bank):
    """float64 distances, to find the rows whose decision is clear."""
    x, bank = x.astype(np.float64), bank.astype(np.float64)
    return (x * x).sum(1)[:, None] + (bank * bank).sum(1)[None] - 2 * x @ bank.T


def _clear(d: np.ndarray, rank: int) -> np.ndarray:
    """Rows whose rank-th and (rank+1)-th smallest distances lie more than
    CLEAR x the row's largest distance apart."""
    s = np.sort(d, axis=1)
    return s[:, rank] - s[:, rank - 1] > CLEAR * np.abs(s).max(1)


# ----------------------------------------------------------- (a) vs JAX
def test_kmeans_predict_and_nearest_centers_match_jax():
    x, centers = _rng_data(0, (300, 16), (40, 16))
    clear = _clear(_sq_dists(x, centers), 1)
    assert clear.sum() == 300
    want = np.asarray(jcluster.kmeans_predict(x, centers))
    got = tcluster.kmeans_predict(torch.from_numpy(x), torch.from_numpy(centers)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcluster.nearest_centers(torch.from_numpy(x), torch.from_numpy(centers)).numpy(),
                                  np.asarray(jcluster.nearest_centers(x, centers)))


def test_blend_retrieval_matches_jax():
    units, bank = _rng_data(1, (200, 16), (500, 16))
    clear = _clear(_sq_dists(units, bank), 8)
    assert clear.sum() == 193
    want = np.asarray(jstore.blend_retrieval(units, bank))
    got = tstore.blend_retrieval(torch.from_numpy(units), torch.from_numpy(bank)).numpy()
    assert got.shape == want.shape == (200, 16)
    np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=1e-5)


# --------------------------------------------------------- (b) kmeans_fit
def test_kmeans_fit_recovers_separated_centers():
    """Five blobs 10 apart with unit spread: each package's fit finds every
    true center within 0.3, and its inertia never rises."""
    rng = np.random.default_rng(2)
    truth = 10.0 * rng.standard_normal((5, 8)).astype(np.float32)
    x = (truth[rng.integers(0, 5, 2000)] + 0.3 * rng.standard_normal((2000, 8))).astype(np.float32)
    for fit in (lambda: np.asarray(jcluster.kmeans_fit(x, 5, iters=20, seed=0)),
                lambda: tcluster.kmeans_fit(torch.from_numpy(x), 5, iters=20, seed=0).numpy()):
        centers = fit()
        assert centers.shape == (5, 8)
        err = np.sqrt(((truth[:, None] - centers[None]) ** 2).sum(-1)).min(1)
        assert err.max() < 0.3, err
    xt = torch.from_numpy(x)
    init = tkmeans.kmeans_plus_plus_init(xt, 5, torch.Generator().manual_seed(0))
    _, inertia = tkmeans.lloyd(xt, init, 10)
    assert (np.diff(inertia.numpy()) <= 1e-6 * inertia.numpy()[:-1]).all()
    assert tcluster.kmeans_fit(xt[:3], 10, iters=2).shape == (3, 8)  # K capped at N


# ------------------------------------------------------------- (c) files
def test_npz_is_read_across_packages(tmp_path):
    a, b = _rng_data(3, (6, 16), (9, 16))
    port = tstore.ClusterModel({"alto": torch.from_numpy(a), "1": torch.from_numpy(b)}, retrieval=True)
    tstore.save_cluster_model(port, tmp_path / "port.npz")
    jax_model = jcluster.load_cluster_model(tmp_path / "port.npz")
    assert jax_model.retrieval and set(jax_model.per_speaker) == {"alto", "1"}
    np.testing.assert_array_equal(jax_model.per_speaker["alto"], a)
    jstore.save_cluster_model(jstore.ClusterModel({"alto": a, "1": b}, False), tmp_path / "jax.npz")
    back = tcluster.load_cluster_model(tmp_path / "jax.npz", device="cpu")
    assert not back.retrieval
    np.testing.assert_array_equal(back.per_speaker["1"].numpy(), b)
    units = _rng_data(4, (20, 16))[0]
    np.testing.assert_allclose(back.blend(units, "tenor", RATIO, {"tenor": 1}),
                               jax_model.blend(units, "tenor", RATIO, {"tenor": 1}, retrieval=False),
                               rtol=0, atol=1e-6)
    with pytest.raises(KeyError):
        back.blend(units, "bass", RATIO, {"tenor": 1})


@pytest.mark.parametrize("feature_retrieval", [False, True])
def test_kmeans_pt_dict_loads_as_jax(tmp_path, feature_retrieval):
    """so-vits-svc's kmeans_10000.pt: {speaker: {"cluster_centers_": ...}}."""
    a, b = _rng_data(5, (12, 16), (12, 16))
    torch.save({"alto": {"cluster_centers_": a, "n_features_in_": 16},
                "tenor": {"cluster_centers_": torch.from_numpy(b)}}, tmp_path / "kmeans_10000.pt")
    want = jcluster.load_cluster_model(str(tmp_path / "kmeans_10000.pt"), feature_retrieval)
    got = tcluster.load_cluster_model(tmp_path / "kmeans_10000.pt", feature_retrieval, device="cpu")
    assert got.retrieval == want.retrieval == feature_retrieval
    for spk in ("alto", "tenor"):
        np.testing.assert_array_equal(got.per_speaker[spk].numpy(), want.per_speaker[spk])


# --------------------------------------------------------------- (d) Svc
@pytest.fixture(scope="module")
def banks(svc_pair):
    """{"kmeans": 16 centers, "retrieval": the raw units} of svc_pair's
    encoder on three voiced clips."""
    from sovits_tpu_torch.dsp.audio import resample

    _jsvc, tsvc = svc_pair
    sr = tsvc.target_sample
    units = np.concatenate([tsvc.encoder.encode(resample(_voiced(s, sr, 20 + i), sr, 16000))
                            for i, s in enumerate((1.0, 1.5, 2.0))])
    centers = tcluster.kmeans_fit(torch.from_numpy(units), 16, iters=20, seed=0).numpy()
    return {"kmeans": centers, "retrieval": units}


@pytest.fixture
def clustered(svc_pair, banks, monkeypatch, request):
    """svc_pair with the same cluster model on both Svcs (speaker 0's bank),
    k-means or retrieval as the test's parameter says."""
    jsvc, tsvc = svc_pair
    kind = request.param
    bank = banks[kind]
    monkeypatch.setattr(jsvc, "cluster", jstore.ClusterModel({"0": bank}, kind == "retrieval"))
    monkeypatch.setattr(tsvc, "cluster", tstore.ClusterModel({"0": torch.from_numpy(bank)}, kind == "retrieval"))
    for svc in (jsvc, tsvc):
        monkeypatch.setattr(svc, "feature_retrieval", kind == "retrieval")
    return jsvc, tsvc, kind, bank


# per kind: the rows of the 1.5 s clip's 187 frames whose deciding gap is clear
CLEAR_ROWS = {"kmeans": 187, "retrieval": 187}


@pytest.mark.parametrize("ratio", [RATIO, 0.8])  # 0.8: the blend is not symmetric in its two sides
@pytest.mark.parametrize("clustered", ["kmeans", "retrieval"], indirect=True)
def test_get_unit_f0_blends_as_jax(clustered, ratio):
    jsvc, tsvc, kind, bank = clustered
    sr = tsvc.target_sample
    wav = _voiced(1.5, sr, 7)
    j_units, j_f0, _ = jsvc.get_unit_f0(wav, 0, ratio, 0, f0_predictor="dio")
    t_units, t_f0, _ = tsvc.get_unit_f0(wav, 0, ratio, 0, f0_predictor="dio")
    plain, _, _ = tsvc.get_unit_f0(wav, 0, 0.0, 0, f0_predictor="dio")
    expanded = plain  # the unblended units at the f0 frames
    clear = _clear(_sq_dists(expanded, bank), 8 if kind == "retrieval" else 1)
    assert (clear.sum(), len(clear)) == (CLEAR_ROWS[kind], 187)
    assert t_units.shape == j_units.shape == (187, bank.shape[1]) and t_units.dtype == np.float32
    np.testing.assert_allclose(t_f0, j_f0, rtol=1e-6)
    np.testing.assert_allclose(t_units, j_units, rtol=0, atol=UNITS_ATOL)
    assert np.abs(t_units - plain).max() > 1e-2  # the blend moved the units


@pytest.fixture
def noise_off(monkeypatch):
    for cls in (jsvc_mod.Svc, tsvc_mod.Svc):
        monkeypatch.setattr(cls, "_run_synth_batch",
                            functools.partialmethod(cls._run_synth_batch, sample_noise=False))


@pytest.mark.parametrize("clustered", ["kmeans", "retrieval"], indirect=True)
def test_svc_infer_blends_as_jax(clustered, noise_off, monkeypatch):
    """The blended units reach the synthesizer in both packages, and the
    audio agrees. (With random weights and the noise off the tiny model's
    audio hardly depends on the units, so the units are held too.)"""
    jsvc, tsvc, _kind, _bank = clustered
    sr = tsvc.target_sample
    wav = _voiced(1.5, sr, 7)
    seen = {}
    for name, svc in (("jax", jsvc), ("port", tsvc)):
        run = svc._run_synth_batch
        monkeypatch.setattr(svc, "_run_synth_batch",
                            lambda items, *a, run=run, name=name, **k: seen.setdefault(name, items) and run(items, *a, **k))
    want, *_ = jsvc.infer(0, 0, wav, cluster_infer_ratio=RATIO, f0_predictor="dio", noice_scale=0.0)
    got, n_samples, n_frames = tsvc.infer(0, 0, wav, cluster_infer_ratio=RATIO, f0_predictor="dio",
                                          noice_scale=0.0)
    plain = tsvc._prepare_chunk(0, 0, wav, sr, 0.0, False, "dio", 0.05)["c"]
    (j_item,), (t_item,) = seen["jax"], seen["port"]
    np.testing.assert_allclose(t_item["c"], j_item["c"], rtol=0, atol=UNITS_ATOL)
    assert np.abs(t_item["c"] - plain).max() > 1e-2  # the blend moved the units
    assert got.shape == want.shape == (n_frames * tsvc.hop_size,) and n_samples == len(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)


@pytest.mark.parametrize("clustered", ["kmeans"], indirect=True)
def test_slice_inference_blends_as_jax(clustered, noise_off):
    """A song of two pieces, f0 from yin (bit-equal in both packages on the
    slicer's zero padding)."""
    jsvc, tsvc, _kind, _bank = clustered
    sr = tsvc.target_sample
    song = _song(sr, (1.5, 2.0), 0.5, seed=8)
    kw = dict(cluster_infer_ratio=RATIO, noice_scale=0.0, f0_predictor="yin")
    want = jsvc.slice_inference(song, sr, 0, 0, **kw)
    got = tsvc.slice_inference(song, sr, 0, 0, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL)


def test_ratio_ignored_without_a_model(svc_pair, noise_off):
    _jsvc, tsvc = svc_pair
    assert tsvc.cluster is None
    wav = _voiced(1.0, tsvc.target_sample, 9)
    want, *_ = tsvc.infer(0, 0, wav, f0_predictor="dio", noice_scale=0.0)
    got, *_ = tsvc.infer(0, 0, wav, f0_predictor="dio", noice_scale=0.0, cluster_infer_ratio=RATIO)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- (e) CLIs
@pytest.mark.parametrize("retrieval", [False, True], ids=["kmeans", "retrieval"])
def test_cli_infer_with_a_cluster_model(cli_dir, banks, capsys, retrieval):
    """-cm (a k-means .npz keyed by the speaker's name) -cr 0.5 [-fr]: the
    song is written, and differs from the one without the cluster model."""
    from scipy.io import wavfile

    from sovits_tpu_torch.cli import infer as cli

    tmp, _n = cli_dir
    bank = torch.from_numpy(banks["retrieval" if retrieval else "kmeans"])
    tstore.save_cluster_model(tstore.ClusterModel({"tenor": bank}, retrieval), tmp / "cluster.npz")
    base = ["-m", "G_0.pth", "-c", "config.json", "-n", "song.wav", "-s", "tenor", "-f0p", "yin",
            "-d", "cpu", "-ns", "0"]
    cli.main(base)
    plain = wavfile.read(tmp / "results" / "song_0key_tenor_sovits_yin.wav")[1]
    cli.main(base + ["-cm", "cluster.npz", "-cr", "0.5"] + (["-fr"] if retrieval else []))
    blended = wavfile.read(tmp / "results" / "song_0key_tenor_sovits_yin.wav")[1]
    assert capsys.readouterr().out.count("wrote results") == 2
    assert blended.shape == plain.shape and np.abs(blended.astype(int) - plain).max() > 0


@pytest.mark.parametrize("retrieval", [False, True], ids=["kmeans", "retrieval"])
def test_train_cluster_writes_what_jax_reads(tmp_path, retrieval):
    from sovits_tpu_torch.cli import train_cluster

    rng = np.random.default_rng(10)
    for spk, n_files in (("alto", 2), ("tenor", 1)):
        (tmp_path / "data" / spk).mkdir(parents=True)
        for i in range(n_files):
            np.save(tmp_path / "data" / spk / f"c{i}.wav.soft.npy", rng.standard_normal((16, 30)).astype(np.float32))
    (tmp_path / "data" / "empty").mkdir()
    out = tmp_path / "logs" / "kmeans.npz"
    args = ["--dataset", str(tmp_path / "data"), "--output", str(out), "--n_clusters", "4", "--device", "cpu"]
    train_cluster.main(args + (["--retrieval"] if retrieval else []))
    model = jcluster.load_cluster_model(out)
    assert model.retrieval == retrieval and set(model.per_speaker) == {"alto", "tenor"}
    feats = train_cluster.load_speaker_features(tmp_path / "data")
    assert feats["alto"].shape == (60, 16) and feats["tenor"].shape == (30, 16)
    for spk in ("alto", "tenor"):
        if retrieval:
            np.testing.assert_array_equal(model.per_speaker[spk], feats[spk])
        else:  # every center is the mean of the points nearest to it
            centers = model.per_speaker[spk]
            assign = np.asarray(jcluster.kmeans_predict(feats[spk], centers))
            assert centers.shape == (4, 16)
            for k in np.unique(assign):
                np.testing.assert_allclose(centers[k], feats[spk][assign == k].mean(0), atol=1e-5)
    with pytest.raises(SystemExit, match="no .soft.npy"):
        train_cluster.main(["--dataset", str(tmp_path / "data" / "empty"), "--device", "cpu"])
