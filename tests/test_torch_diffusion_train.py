"""The port's diffusion trainer vs the JAX package (CPU, tiny sizes).

The tiny model is the JAX CLI test's: Unit2Mel of 2 layers x 16 channels x
12 hidden over 16 mels and 20 steps, 8-wide units, 8 kHz, hop 64, 16-frame
crops (tests/test_cli.py, tests/test_diffusion_train.py).

(a) DiffusionDataset: the same examples for one seed, aug and crop
    included; the staircase learning rate against optax's.
(b) train_diffusion for 3 steps with decay_step 2 against the JAX trainer:
    both start from the JAX init, the diffusion steps ``t`` and the
    noise are patched to the same arrays on both sides (the JAX
    noise cannot be drawn in torch), batch 8 (the JAX trainer rounds the
    batch to its 8-device CPU mesh). The logged training and validation
    losses within 1e-5 relative, the parameters within 2e-5 of their
    peak (PARAM_REL says why not 1e-5). The port's model_3.pt loads into the JAX package's
    load_torch_unit2mel and maps back equal through from_jax.unit2mel.
(c) The port alone: a resume (2 + 2 steps equal 4 straight, to the bit),
    retention with milestones, the NaN/Inf abort, measure_rtf, and the
    train_diff CLI.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.train import diffusion as jdiff  # noqa: E402
from sovits_tpu_torch.cli import train_diff as tcli  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.models.diffusion import gaussian as tgauss  # noqa: E402
from sovits_tpu_torch.train import diffusion as tdiff  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

LOSS_REL = 1e-5
# max-abs error over the tensor's peak |value|. A bias that starts at zero is
# the sum of three Adam steps of about lr each, and Adam's m / sqrt(v) carries
# the gradient's fp32 rounding (~1e-5 relative here) into each step whatever
# the gradient's size: those tensors land at 0.8-1.04e-5, the rest below 3e-7.
PARAM_REL = 2e-5
VOC = {"sampling_rate": 8000, "num_mels": 16, "n_fft": 256, "win_size": 256, "hop_size": 64,
       "fmin": 40, "fmax": 4000, "upsample_rates": [4, 4, 4], "upsample_kernel_sizes": [8, 8, 8],
       "upsample_initial_channel": 32}


def _write_dataset(root, n_files=4, frames=24, units_dim=8, mels=16):
    """Diffusion artifacts of ``n_files`` clips of two speakers, the units at
    a coarser rate than the frames, and every clip with its aug variant."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n_files):
        p = root / f"spk{i % 2}" / f"c{i}.wav"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.touch()
        n = frames + 4 * i
        f0 = rng.uniform(120, 320, n).astype(np.float32)
        np.save(str(p) + ".f0.npy", np.array([f0, np.ones(n, np.float32)], dtype=object), allow_pickle=True)
        np.save(str(p) + ".vol.npy", np.abs(rng.standard_normal(n)).astype(np.float32) * 0.1)
        np.save(str(p) + ".mel.npy", (rng.standard_normal((n, mels)) * 2 - 6).astype(np.float32))
        np.save(str(p) + ".soft.npy", rng.standard_normal((units_dim, n // 2)).astype(np.float32))
        np.save(str(p) + ".aug_mel.npy", np.array(
            [(rng.standard_normal((n, mels)) * 2 - 6).astype(np.float32), 2.0 + i], dtype=object),
            allow_pickle=True)
        np.save(str(p) + ".aug_vol.npy", np.abs(rng.standard_normal(n)).astype(np.float32) * 0.1)
        paths.append(str(p))
    (root / "train.txt").write_text("\n".join(paths) + "\n")
    (root / "val.txt").write_text("\n".join(paths[:2]) + "\n")
    return paths


def _config(tmp_path, **train):
    cfg = {
        "data": {"sampling_rate": 8000, "block_size": 64, "duration": 0.128,  # 16 frames
                 "encoder_out_channels": 8, "training_files": str(tmp_path / "data" / "train.txt"),
                 "validation_files": str(tmp_path / "data" / "val.txt")},
        "model": {"n_layers": 2, "n_chans": 16, "n_hidden": 12, "timesteps": 20, "k_step_max": 0,
                  "n_spk": 2, "use_pitch_aug": True},
        "train": {"batch_size": 8, "interval_log": 1, "interval_val": 100, "interval_force_save": 0,
                  "lr": 1e-3, "decay_step": 2, "gamma": 0.5, **train},
        "infer": {"speedup": 4, "method": "dpm-solver++"},
        "vocoder": {"type": "nsf-hifigan", "ckpt": str(tmp_path / "missing"), "config": VOC},
        "env": {"expdir": str(tmp_path / "exp")},
        "spk": {"spk0": 0, "spk1": 1},
    }
    path = tmp_path / "diffusion.yaml"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture
def data(tmp_path):
    _write_dataset(tmp_path / "data")
    return tmp_path


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


# ------------------------------------------------------------ (a) data, lr
def test_dataset_matches_jax(data):
    path = _config(data)
    jargs, targs = jdiff.load_diffusion_config(path), tdiff.load_diffusion_config(path)
    jds, tds = jdiff.DiffusionDataset(jargs.data.training_files, jargs), \
        tdiff.DiffusionDataset(targs.data.training_files, targs)
    assert tds.frames == jds.frames == 16
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    shifts = []
    for _ in range(3):
        for i in range(len(tds)):
            got, want = tds.example(i, trng), jds.example(i, jrng)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == np.asarray(want[k]).dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            shifts.append(float(got["aug_shift"]))
    assert 0.0 in shifts and any(s != 0.0 for s in shifts)  # both variants drawn
    assert {int(tds.example(i, trng)["spk"]) for i in range(len(tds))} == {0, 1}


def test_staircase_lr_matches_optax(data):
    args = tdiff.load_diffusion_config(_config(data))
    schedule = optax.exponential_decay(args.train.lr, transition_steps=args.train.decay_step,
                                       decay_rate=args.train.gamma, staircase=True)
    got = [tdiff.staircase_lr(args, k) for k in range(7)]
    np.testing.assert_allclose(got, [float(schedule(k)) for k in range(7)], rtol=1e-7)
    assert got[1] == args.train.lr and got[2] == args.train.lr * 0.5


# ---------------------------------------------------- (b) against the JAX trainer
T_FIXED = np.array([3, 17, 0, 9, 12, 5, 19, 1], np.int32)  # the patched diffusion steps


def _fixed(shape) -> np.ndarray:
    return np.random.default_rng(sum(shape) * 31 + len(shape)).standard_normal(shape).astype(np.float32)


@pytest.fixture
def same_draws(monkeypatch):
    """t and the noise patched to the same arrays in both packages (JAX
    [B, T, M], the port [B, M, T]): the JAX loss compares its prediction
    with the drawn noise itself, so its draw is patched."""
    real_randint = jax.random.randint
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **k:
                        jnp.asarray(T_FIXED[: shape[0]] % hi) if len(shape) == 1 and lo == 0
                        else real_randint(key, shape, lo, hi, *a, **k))
    real_normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), *a, **k:
                        jnp.asarray(_fixed(tuple(shape))) if len(shape) == 3
                        else real_normal(key, shape, *a, **k))
    real_torch_randint = torch.randint
    monkeypatch.setattr(torch, "randint", lambda lo, hi, size, generator=None, **k:
                        torch.from_numpy(T_FIXED[: size[0]] % hi).long() if lo == 0 and len(size) == 1
                        else real_torch_randint(lo, hi, size, generator=generator, **k))

    def port_noise(shape, generator, device):
        b, m, t = shape
        return torch.from_numpy(_fixed((b, t, m)).transpose(0, 2, 1).copy()).to(device)

    monkeypatch.setattr(tgauss, "randn", port_noise)


def _jax_init(args, example):
    """The JAX trainer's initial params (PRNGKey(0), shapes of one example)."""
    model = jdiff.build_unit2mel(args, 16)
    return model.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                      jnp.asarray(example["units"][None]), jnp.asarray(example["f0"][None]),
                      jnp.asarray(example["volume"][None]), spk_id=jnp.asarray([0], jnp.int32),
                      aug_shift=jnp.asarray([0.0]), gt_spec=jnp.asarray(example["mel"][None]),
                      infer=False)["params"]


def _port_sd(params) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in from_jax.unit2mel(jax.tree.map(np.asarray, params)).items()}


def test_train_diffusion_matches_jax(data, same_draws, monkeypatch):
    path = _config(data)
    jargs, targs = jdiff.load_diffusion_config(path), tdiff.load_diffusion_config(path)
    ex = jdiff.DiffusionDataset(jargs.data.training_files, jargs).example(0, np.random.default_rng(0))
    init = _jax_init(jargs, ex)

    def fresh(args, vocoder_dim, device):
        model = tdiff.build_unit2mel(args, vocoder_dim, device)
        model.load_state_dict(_port_sd(init), strict=True)
        return model

    monkeypatch.setattr(tdiff, "fresh_unit2mel", fresh)
    jparams = jdiff.train_diffusion(jargs, expdir=data / "jax", max_steps=3, vocoder_dim=16)
    model = tdiff.train_diffusion(targs, expdir=data / "port", max_steps=3, vocoder_dim=16, device="cpu")

    want, got = _records(data / "jax" / "metrics.jsonl"), _records(data / "port" / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("loss/diffusion", "loss/val_diffusion"):
            if key in g:
                assert np.isfinite(g[key]) and abs(g[key] - w[key]) <= LOSS_REL * abs(w[key]), (key, g, w)
    assert got[-1]["val_rtf"] > 0
    sd = model.state_dict()
    for k, v in _port_sd(jax.device_get(jparams)).items():
        err = (sd[k] - v).abs().max().item()
        assert err <= PARAM_REL * v.abs().max().item(), (k, err)
    # the updates moved the weights far beyond the tolerance, so the third
    # update's halved lr shows
    moved = max((sd[k] - v).abs().max().item() for k, v in _port_sd(init).items())
    assert moved > 1e-3

    # model_3.pt: so-vits-svc's layout, read by both packages' loaders
    ckpt = torch.load(data / "port" / "model_3.pt", weights_only=False)
    assert {"global_step", "model", "optimizer"} <= set(ckpt) and ckpt["global_step"] == 3
    assert ckpt["model"]["decoder.betas"].shape == (20,)
    _, variables = jdiff.load_torch_unit2mel(str(data / "port" / "model_3.pt"), jargs, 16)
    back = from_jax.unit2mel(jax.tree.map(np.asarray, variables["params"]))
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)
    loaded = tdiff.load_torch_unit2mel(data / "port" / "model_3.pt", targs, 16, "cpu")
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


# -------------------------------------------------------------- (c) the port
def test_resume_equals_straight(data):
    args = tdiff.load_diffusion_config(_config(data, batch_size=3))
    straight = tdiff.train_diffusion(args, expdir=data / "straight", max_steps=4, vocoder_dim=16,
                                     device="cpu")
    tdiff.train_diffusion(args, expdir=data / "resumed", max_steps=2, vocoder_dim=16, device="cpu")
    resumed = tdiff.train_diffusion(args, expdir=data / "resumed", max_steps=4, vocoder_dim=16,
                                    device="cpu")
    for k, v in straight.state_dict().items():
        torch.testing.assert_close(resumed.state_dict()[k], v, rtol=0, atol=0)
    losses = {name: {r["step"]: r["loss/diffusion"] for r in _records(data / name / "metrics.jsonl")
                     if "loss/diffusion" in r} for name in ("straight", "resumed")}
    assert losses["resumed"] == losses["straight"] and sorted(losses["straight"]) == [1, 2, 3, 4]
    steps = [r["step"] for r in _records(data / "resumed" / "metrics.jsonl") if "loss/diffusion" in r]
    assert steps == [1, 2, 3, 4]  # the resumed run logs its own steps, 3 and 4
    assert torch.load(data / "resumed" / "model_4.pt", weights_only=False)["optimizer"]["state"][0]["step"] == 4


def test_retention_keeps_milestones_and_the_cli(data):
    """The CLI for 7 steps (a save every 2, a milestone every 3, the newest 2
    kept), then NaN: the trainer aborts."""
    path = _config(data, batch_size=2, interval_val=2, interval_force_save=3, keep_ckpts=2)
    model = tcli.main(["-c", str(path), "--max-steps", "7", "--device", "cpu"])
    assert model.out_dims == 16  # the vocoder config's mel width
    kept = sorted(int(p.stem.split("_")[1]) for p in (data / "exp").glob("model_*.pt"))
    assert kept == [3, 6, 7]  # saves at 2 3 4 6 7; 6 and 7 newest, 3 and 6 milestones
    vals = [r["step"] for r in _records(data / "exp" / "metrics.jsonl") if "loss/val_diffusion" in r]
    assert vals == [2, 4, 6, 7]

    args = tdiff.load_diffusion_config(path)
    tds = tdiff.DiffusionDataset(args.data.validation_files, args, cache_all_data=False)
    assert tdiff.measure_rtf(model, tds, args, n_clips=2) > 0

    mel = data / "data" / "spk0" / "c0.wav.mel.npy"
    bad = np.load(mel)
    bad[:] = np.nan
    np.save(mel, bad)
    np.save(str(mel).replace(".mel.", ".aug_mel."), np.array([bad, 0.0], dtype=object), allow_pickle=True)
    with pytest.raises(RuntimeError, match="NaN/Inf loss at step"):
        tdiff.train_diffusion(args, expdir=data / "nan", max_steps=6, vocoder_dim=16, device="cpu")
