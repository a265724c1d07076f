"""The port's training pipeline vs the JAX package (CPU, tiny sizes).

(a) ``cli.resample``: the same 16-bit wavs within 1 LSB.
(b) ``cli.preprocess_flist_config``: the same filelists and config.json,
    with and without the model options.
(c) ``cli.preprocess_features.process_one``: every artifact of one wav
    within 1e-5 of its peak (yin f0, one tiny vec768l12 checkpoint through
    each package's ``get_speech_encoder``, the vocoder's mel config without
    weights), the aug mel's keyshift equal and its mel within 1e-4; the CLI
    with ``--use_diff`` and a spawned f0 pool.
(d) ``MetricsLogger``: the same ``metrics.jsonl`` records; ``_evaluate``:
    the same ``eval/mel_l1_i`` within 1e-4 relative and audio within 1e-4 of
    its peak, the net back in training mode; ``train()`` evaluates at every
    ``eval_interval`` and not at a ``max_steps`` save off it.
(e) ``cli.tools``: ``compress --half`` and ``mix`` (both modes) of the
    port's G_*.pth against the JAX tools on the same weights (the JAX
    package's .npz, compared through the weight bridge's names), and
    ``Svc`` loading the compressed model.
"""

import json
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from sovits_tpu.cli import preprocess_features as jpre  # noqa: E402
from sovits_tpu.cli import preprocess_flist_config as jflist  # noqa: E402
from sovits_tpu.cli import resample as jresample  # noqa: E402
from sovits_tpu.cli import tools as jtools  # noqa: E402
from sovits_tpu.config import HParams as JaxHParams  # noqa: E402
from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.encoders import factory as jfactory  # noqa: E402
from sovits_tpu.encoders import wav2vec2 as jw2v  # noqa: E402
from sovits_tpu.f0 import get_f0_predictor as jget_f0  # noqa: E402
from sovits_tpu.models import factory as jmodels  # noqa: E402
from sovits_tpu.models.diffusion import NsfHifiGANVocoder as JaxVocoder  # noqa: E402
from sovits_tpu.train import trainer as jtrainer  # noqa: E402
from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch.cli import preprocess_features as tpre  # noqa: E402
from sovits_tpu_torch.cli import preprocess_flist_config as tflist  # noqa: E402
from sovits_tpu_torch.cli import resample as tresample  # noqa: E402
from sovits_tpu_torch.cli import tools as ttools  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.encoders import factory as tfactory  # noqa: E402
from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config  # noqa: E402
from sovits_tpu_torch.f0.base import get_f0_predictor as tget_f0  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.models.diffusion.vocoder import NsfHifiGANVocoder  # noqa: E402
from sovits_tpu_torch.train import trainer as ttrainer  # noqa: E402
from tests.fairseq_fixture import make_fairseq_hubert_sd, save_as_torch_ckpt  # noqa: E402
from tests.test_torch_encoders import CONVS  # noqa: E402
from tests.test_torch_modules import TINY_W2V  # noqa: E402
from tests.test_torch_train import TRAIN_OVERRIDES  # noqa: E402
from tests.tiny import make_synthetic_dataset, tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

ARTIFACT_REL = 1e-5  # an artifact's max-abs error over its peak, fp32 on both sides
AUG_MEL_ATOL = 1e-4
EVAL_REL = 1e-4  # _evaluate's mel L1 (relative) and audio (over its peak)
VOC = {"sampling_rate": 8000, "num_mels": 16, "n_fft": 256, "win_size": 256, "hop_size": 64,
       "fmin": 40, "fmax": 4000, "upsample_rates": [4, 4, 4], "upsample_kernel_sizes": [8, 8, 8],
       "upsample_initial_channel": 32}


def _signal(sr, seconds, seed, hz=180.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def _write(path, sr, wav):
    path.parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(path, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


def _peak_close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = np.abs(want).max()
    assert peak > 0, what
    err = np.abs(got - want).max()
    assert err <= rel * peak, f"{what}: {err} > {rel} x {peak}"


# ------------------------------------------------------------- (a) resample
def test_resample_matches_jax(tmp_path):
    raw = tmp_path / "dataset_raw"
    for s, spk in enumerate(("a", "b")):
        for i in range(2):
            stereo = np.stack([_signal(22050, 0.4, 10 * s + i), _signal(22050, 0.4, 10 * s + i + 5, 300.0)], 1)
            _write(raw / spk / f"c{i}.wav", 22050, stereo)
    common = ["--sr2", "8000", "--in_dir", str(raw), "--workers", "1"]
    jresample.main(common + ["--out_dir2", str(tmp_path / "jax")])
    assert tresample.main(common + ["--out_dir2", str(tmp_path / "port")]) == 4
    for spk in ("a", "b"):
        for i in range(2):
            sr_j, want = wavfile.read(tmp_path / "jax" / spk / f"c{i}.wav")
            sr_t, got = wavfile.read(tmp_path / "port" / spk / f"c{i}.wav")
            assert sr_j == sr_t == 8000 and got.dtype == want.dtype == np.int16
            assert got.shape == want.shape == (3200,)
            assert np.abs(got.astype(np.int32) - want).max() <= 1
            assert np.abs(got).max() >= 0.97 * 32767


# ----------------------------------------------------- (b) filelists, config
@pytest.mark.parametrize("flags", [[], ["--speech_encoder", "hubertsoft", "--vol_aug", "--tiny",
                                        "--use_transformer_flow"]], ids=["default", "options"])
def test_flist_config_matches_jax(tmp_path, flags):
    ds = tmp_path / "dataset" / "44k"
    for spk in ("alice", "bob"):
        for i in range(6):
            _write(ds / spk / f"c{i}.wav", 8000, _signal(8000, 0.05, i))
    out = {}
    for name, cli in (("jax", jflist), ("port", tflist)):
        d = tmp_path / name
        cli.main(["--source_dir", str(ds), "--train_list", str(d / "train.txt"),
                  "--val_list", str(d / "val.txt"), "--config_out", str(d / "config.json")] + flags)
        cfg = json.loads((d / "config.json").read_text())
        for key in ("training_files", "validation_files"):
            cfg["data"][key] = cfg["data"][key].replace(str(d), "")
        out[name] = ((d / "train.txt").read_text(), (d / "val.txt").read_text(), cfg)
    assert out["port"] == out["jax"]
    train, val, cfg = out["port"]
    assert len(train.split()) == 8 and len(val.split()) == 4
    assert cfg["spk"] == {"alice": 0, "bob": 1} and cfg["model"]["n_speakers"] == 2


# ---------------------------------------------------------- (c) features
@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """One tiny vec768l12 checkpoint through each package's get_speech_encoder."""
    path = tmp_path_factory.mktemp("encoder") / "vec768l12.pt"
    save_as_torch_ckpt(make_fairseq_hubert_sd(d_model=64, n_layers=2, ffn_dim=128, conv_specs=CONVS,
                                              pos_conv_kernel=16, pos_conv_groups=4, seed=3), str(path))
    with pytest.MonkeyPatch.context() as mp:
        _, pad, fmt = jfactory.CONFIGS["vec768l12"]
        mp.setitem(jfactory.CONFIGS, "vec768l12", (jw2v.Wav2Vec2Config(**TINY_W2V), pad, fmt))
        mp.setitem(tfactory.CONFIGS, "vec768l12", Wav2Vec2Config(**TINY_W2V))
        jenc = jfactory.get_speech_encoder("vec768l12", str(path))
        tenc = tfactory.get_speech_encoder("vec768l12", path, device="cpu")
    return jenc, tenc, path


ARTIFACTS = (".soft.npy", ".spec.npy", ".vol.npy", ".mel.npy", ".aug_vol.npy")


def test_process_one_matches_jax(tmp_path, encoders):
    jenc, tenc, _ = encoders
    hps = tiny_hps()
    wav = _signal(8000, 0.6, 4)
    paths = {}
    for name in ("jax", "port"):
        _write(tmp_path / name / "clip.wav", 8000, wav)
        paths[name] = str(tmp_path / name / "clip.wav")
    jpre.process_one(paths["jax"], hps, jenc, jget_f0("yin", 64, 8000), use_diff=True,
                     rng=np.random.default_rng(0), mel_extractor=JaxVocoder(None, config=VOC))
    seconds = tpre.process_one(paths["port"], pcfg.HParams(**hps.to_dict()), tenc, tget_f0("yin", 64, 8000),
                               use_diff=True, rng=np.random.default_rng(0),
                               mel_extractor=NsfHifiGANVocoder(None, VOC, "cpu", weights=False),
                               device="cpu")
    assert set(seconds) == set(tpre.KINDS) and all(v > 0 for v in seconds.values())
    frames = len(wav) // 64
    for ext in ARTIFACTS:
        got, want = np.load(paths["port"] + ext), np.load(paths["jax"] + ext)
        assert got.dtype == np.float32, ext
        _peak_close(got, want, ARTIFACT_REL, ext)
    assert np.load(paths["port"] + ".soft.npy").shape[0] == 64
    assert np.load(paths["port"] + ".spec.npy").shape == (65, frames)
    assert np.load(paths["port"] + ".vol.npy").shape == (frames,)
    assert np.load(paths["port"] + ".mel.npy").shape[1] == 16
    (f0_t, uv_t), (f0_j, uv_j) = (np.load(paths[n] + ".f0.npy", allow_pickle=True) for n in ("port", "jax"))
    assert f0_t.shape == (frames,) and np.abs(f0_t).max() > 100
    _peak_close(f0_t, f0_j, ARTIFACT_REL, "f0")
    np.testing.assert_array_equal(uv_t, uv_j)
    (mel_t, key_t), (mel_j, key_j) = (np.load(paths[n] + ".aug_mel.npy", allow_pickle=True)
                                      for n in ("port", "jax"))
    assert key_t == key_j != 0.0
    np.testing.assert_allclose(np.asarray(mel_t), np.asarray(mel_j), rtol=0, atol=AUG_MEL_ATOL)


def test_preprocess_features_cli(tmp_path, encoders, monkeypatch):
    """The CLI on a two-speaker list with --use_diff, a spawned two-worker
    f0 pool, and a vocoder config without weights; a rerun keeps every
    artifact."""
    _, _, ckpt = encoders
    monkeypatch.setitem(tfactory.CONFIGS, "vec768l12", Wav2Vec2Config(**TINY_W2V))
    hps = pcfg.HParams(**tiny_hps().to_dict())
    paths = []
    for i in range(3):
        p = tmp_path / "data" / f"spk{i % 2}" / f"c{i}.wav"
        _write(p, 8000, _signal(8000, 0.4 + 0.1 * i, i, 150.0 + 20 * i))
        paths.append(str(p))
    (tmp_path / "train.txt").write_text("\n".join(paths[:2]) + "\n")
    (tmp_path / "val.txt").write_text(paths[2] + "\n")
    hps.data["training_files"], hps.data["validation_files"] = str(tmp_path / "train.txt"), str(tmp_path / "val.txt")
    pcfg.save_config(hps, tmp_path / "config.json")
    (tmp_path / "diffusion.yaml").write_text(json.dumps(
        {"vocoder": {"type": "nsf-hifigan", "ckpt": str(tmp_path / "missing" / "model"), "config": VOC}}))
    argv = ["-c", str(tmp_path / "config.json"), "--diffusion_config", str(tmp_path / "diffusion.yaml"),
            "--use_diff", "--f0_predictor", "yin", "--encoder_checkpoint", str(ckpt), "--workers", "2",
            "--device", "cpu"]
    seconds = tpre.main(argv)
    assert seconds["units"] > 0 and seconds["mel"] > 0 and seconds["aug"] > 0
    yin = tget_f0("yin", 64, 8000)
    for p in paths:
        frames = len(wavfile.read(p)[1]) // 64
        assert np.load(p + ".soft.npy").shape[0] == 64
        f0, uv = np.load(p + ".f0.npy", allow_pickle=True)
        want_f0, want_uv = yin.compute_f0_uv(wavfile.read(p)[1].astype(np.float32) / 32768.0)
        np.testing.assert_array_equal(f0, want_f0)  # the pool's f0 is the main process's
        assert f0.shape == uv.shape == (frames,)
        assert np.load(p + ".spec.npy").shape == (65, frames)
        assert np.load(p + ".vol.npy").shape == (frames,)
        assert abs(np.load(p + ".mel.npy").shape[0] - frames) <= 1 and np.load(p + ".mel.npy").shape[1] == 16
        aug, key = np.load(p + ".aug_mel.npy", allow_pickle=True)
        # the hop scales with the keyshift in both packages' nvSTFT, so the
        # frame count differs from the mel's
        assert np.asarray(aug).shape[1] == 16 and np.isfinite(np.asarray(aug)).all() and -5 <= key <= 5
        assert np.load(p + ".aug_vol.npy").shape == (frames,)
    stamps = {p: (tmp_path / p).stat().st_mtime_ns for p in tmp_path.rglob("*.npy")}
    again = tpre.main(argv[:-4] + ["--device", "cpu"])
    assert not any(again.values())
    assert {p: (tmp_path / p).stat().st_mtime_ns for p in tmp_path.rglob("*.npy")} == stamps


def test_mel_extractor_needs_no_weights(tmp_path):
    """Preprocessing reads the vocoder's mel config alone; serving still
    raises on a missing checkpoint."""
    (tmp_path / "config.json").write_text(json.dumps(VOC))
    voc = NsfHifiGANVocoder(str(tmp_path / "model"), device="cpu", weights=False)
    assert voc.dimension == 16 and voc.sample_rate == 8000  # the config.json beside it
    assert NsfHifiGANVocoder(None, device="cpu", weights=False).dimension == 128
    mel = voc.extract(_signal(8000, 0.3, 1)[None], 8000)
    assert mel.shape == (1, 2400 // 64, 16) and torch.isfinite(mel).all()
    with pytest.raises(FileNotFoundError):
        voc.infer(mel, torch.full((1, mel.shape[1]), 200.0))
    with pytest.raises(FileNotFoundError):
        NsfHifiGANVocoder(str(tmp_path / "model"), device="cpu")


# ------------------------------------------------- (d) logging, evaluation
def test_metrics_logger_matches_jax(tmp_path):
    records = [(1, {"loss/g/total": 3.25, "steps_per_sec": np.float32(1.5)}),
               (2, {"eval/mel_l1_0": 0.125, "learning_rate": 1e-4})]
    for name, cls in (("jax", jtrainer.MetricsLogger), ("port", ttrainer.MetricsLogger)):
        mlog = cls(tmp_path / name)
        for step, values in records:
            mlog.scalars(step, values)
        mlog.audio(2, "gen/audio_0", np.zeros(64, np.float32), 8000)
        mlog.image(2, "mel", np.arange(12.0).reshape(3, 4))
        mlog.close()
    port = (tmp_path / "port" / "metrics.jsonl").read_text()
    assert port == (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert [json.loads(line)["step"] for line in port.splitlines()] == [1, 2]


@pytest.fixture(scope="module")
def eval_model(tmp_path_factory):
    """The tiny training config with its synthetic dataset (one validation
    clip per speaker), and a seeded port synthesizer (training build)."""
    root = tmp_path_factory.mktemp("eval")
    jhps = tiny_hps(**TRAIN_OVERRIDES)
    paths = make_synthetic_dataset(root / "data", jhps, n_per_spk=3)
    (root / "data" / "val.txt").write_text(f"{paths[2]}\n{paths[5]}\n")
    hps = pcfg.HParams(**jhps.to_dict())
    net = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                               torch.Generator().manual_seed(0)).train()
    return hps, net


def test_evaluate_matches_jax(tmp_path, eval_model, monkeypatch):
    hps, net = eval_model
    jhps = JaxHParams(**hps.to_dict())
    m = hps.model
    tree = from_torch.synthesizer({k: v.detach().numpy() for k, v in net.state_dict().items()},
                                  n_upsamples=len(m.upsample_rates),
                                  n_resblock_kernels=len(m.resblock_kernel_sizes))
    audio = {"jax": [], "port": []}
    logs = {}
    modes, real_infer = [], net.infer
    monkeypatch.setattr(net, "infer", lambda *a, **k: (modes.append(net.training), real_infer(*a, **k))[1])
    for name, mod in (("jax", jtrainer), ("port", ttrainer)):
        monkeypatch.setattr(mod.MetricsLogger, "audio",
                            lambda self, step, tag, wav, sr, name=name: audio[name].append((tag, wav)))
        mlog = mod.MetricsLogger(tmp_path / name)
        if name == "jax":
            # the trainer's synthesizer, its apply jitted (one compile, not one per op)
            syn = types.SimpleNamespace(apply=jax.jit(jmodels.build_synthesizer(jhps).apply,
                                                      static_argnames=("sample_noise", "method")))
            jtrainer._evaluate(jhps, syn, types.SimpleNamespace(g_params=jax.tree.map(np.asarray, tree)),
                               mlog, 4)
        else:
            ttrainer._evaluate(hps, net, mlog, 4)
        mlog.close()
        logs[name] = [json.loads(line) for line in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
    assert modes == [False, False] and net.training  # synthesised in eval mode, then back
    assert [list(r) for r in logs["port"]] == [["step", "eval/mel_l1_0"], ["step", "eval/mel_l1_1"]]
    for got, want in zip(logs["port"], logs["jax"], strict=True):
        assert got.keys() == want.keys() and got["step"] == want["step"] == 4
        key = [k for k in got if k != "step"][0]
        assert np.isfinite(got[key]) and abs(got[key] - want[key]) <= EVAL_REL * abs(want[key]), key
    assert [t for t, _ in audio["port"]] == [t for t, _ in audio["jax"]] == ["gen/audio_0", "gen/audio_1"]
    for (_, got), (_, want) in zip(audio["port"], audio["jax"]):
        assert got.shape == want.shape == (hps.data.pad_to_frames * hps.data.hop_length,)
        _peak_close(got, want, EVAL_REL, "eval audio")


def test_train_evaluates_at_eval_interval(tmp_path, eval_model):
    """train() saves and evaluates at every eval_interval; the max_steps save
    off the interval evaluates nothing; the code revision is pinned."""
    hps, _ = eval_model
    hps = pcfg.HParams(**hps.to_dict())
    hps.train["eval_interval"] = 2
    ttrainer.train(hps, tmp_path / "model", max_steps=3, device="cpu")
    records = [json.loads(line) for line in (tmp_path / "model" / "metrics.jsonl").read_text().splitlines()]
    evals = [(r["step"], k) for r in records for k in r if k.startswith("eval/")]
    assert evals == [(2, "eval/mel_l1_0"), (2, "eval/mel_l1_1")]
    assert [r["step"] for r in records if "loss/g/total" in r] == [1, 2, 3]
    assert sorted(p.name for p in (tmp_path / "model").glob("*.pth")) == [
        "D_2.pth", "D_3.pth", "G_2.pth", "G_3.pth"]


# --------------------------------------------------------------- (e) tools
def _jax_npz(sd: dict, hps, path):
    m = hps.model
    tree = from_torch.synthesizer({k: v.numpy() for k, v in sd.items()}, n_upsamples=len(m.upsample_rates),
                                  n_resblock_kernels=len(m.resblock_kernel_sizes))
    np.savez(path, **jtools.flatten_params(tree))


def _port_names(npz_path, hps) -> dict:
    """A JAX .npz of generator params under the port's state_dict names."""
    flat = {k: (v.view(ml_dtypes.bfloat16).astype(np.float32) if v.dtype.kind == "V" else v)
            for k, v in np.load(npz_path).items()}
    return from_jax.synthesizer(from_jax.unflatten_params(flat), hps)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two seeded tiny generators as the port's G_*.pth and as the JAX
    package's .npz, and their config."""
    root = tmp_path_factory.mktemp("tools")
    hps = pcfg.HParams(**tiny_hps().to_dict())
    pcfg.save_config(hps, root / "config.json")
    for i in (2, 4):
        net = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                                   torch.Generator().manual_seed(i))
        sd = net.state_dict()
        torch.save({"model": sd, "optimizer": {"state": {}}, "learning_rate": 1e-4, "iteration": i},
                   root / f"G_{i}.pth")
        _jax_npz(sd, hps, root / f"G_{i}.npz")
    return root, hps


def test_compress_matches_jax(checkpoints):
    root, hps = checkpoints
    jtools.compress(["-c", str(root / "config.json"), "-i", str(root / "G_4.npz"),
                     "-o", str(root / "jax_half.npz"), "--half"])
    ttools.main(["compress", "-i", str(root / "G_4.pth"), "-o", str(root / "port_half.pth"), "--half"])
    ckpt = torch.load(root / "port_half.pth", weights_only=False)
    assert "optimizer" not in ckpt and ckpt["iteration"] == 4
    got = ckpt["model"]
    full = torch.load(root / "G_4.pth", weights_only=False)["model"]
    assert not any(k.startswith("enc_q.") for k in got)
    assert set(got) == {k for k in full if not k.startswith("enc_q.")}
    want = _port_names(root / "jax_half.npz", hps)
    assert set(want) == set(got)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=k)
    # the port's Svc loads the release file (strictly, enc_q from a fresh net)
    from sovits_tpu_torch.infer.svc import Svc

    svc = Svc(str(root / "port_half.pth"), str(root / "config.json"), encoder=object(), device="cpu")
    for k, v in got.items():
        torch.testing.assert_close(svc.model.state_dict()[k], v.float(), rtol=0, atol=0)


@pytest.mark.parametrize("mode", [0, 1], ids=["convex", "linear"])
def test_mix_matches_jax(checkpoints, mode):
    root, hps = checkpoints
    rates = ["30", "70"]
    jtools.mix(["-c", str(root / "config.json"), "-i", str(root / "G_2.npz"), str(root / "G_4.npz"),
                "-r", *rates, "-o", str(root / "jax_mix.npz"), "--mode", str(mode)])
    ttools.main(["mix", "-i", str(root / "G_2.pth"), str(root / "G_4.pth"), "-r", *rates,
                 "-o", str(root / "port_mix.pth"), "--mode", str(mode)])
    ckpt = torch.load(root / "port_mix.pth", weights_only=False)
    assert ckpt["iteration"] == 2  # the rest is the first checkpoint's
    want = _port_names(root / "jax_mix.npz", hps)
    assert set(want) == set(ckpt["model"])
    for k, v in ckpt["model"].items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-7, err_msg=k)
