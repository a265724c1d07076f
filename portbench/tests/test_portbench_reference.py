"""The plain reference against the program at tiny widths on the CPU, and
whole cells driven at test size: a sound run is correct; a run with the
timed path broken underneath is not, once for each fault the cell can have."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import harness, weights  # noqa: E402
from portbench.reference import contentvec, nets  # noqa: E402
from portbench_tiny import tiny_config, tiny_run, tiny_traffic  # noqa: E402

LIMITS = ROOT / "portbench" / "limits"


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("config", ["sovits41-default", "sovits41-vol-tflow"])
def test_synthesizer_forward_matches_the_program(config):
    from sovits_tpu_torch import config as scfg
    from sovits_tpu_torch.models import factory

    cfg = tiny_config(config)
    sd = weights.seeded_state_dict(weights.meta(lambda: nets.Synthesizer(cfg)), 11, "cpu")
    prog = factory.build_synthesizer(scfg.HParams(**{k: cfg[k] for k in ("train", "data", "model", "spk")}),
                                     "cpu", fused_tail=True)
    prog.load_state_dict(sd, strict=True)
    ref = nets.Synthesizer(cfg).eval()
    ref.load_state_dict(sd)
    g = torch.Generator().manual_seed(1)
    b, t = 2, 40
    c = torch.randn(b, t, cfg["model"]["ssl_dim"], generator=g)
    f0 = 120 + 200 * torch.rand(b, t, generator=g)
    uv = (torch.rand(b, t, generator=g) > 0.2).float()
    lengths, spk, vol = torch.tensor([t, t - 7]), torch.tensor([1, 3]), torch.rand(b, t, generator=g)
    got, _ = prog.infer(c, f0, uv, spk, noise_scale=0.4, sample_noise=True, lengths=lengths,
                        generator=torch.Generator().manual_seed(5), vol=vol)
    with torch.no_grad():
        want = ref.infer(c.transpose(1, 2), f0, uv, spk, lengths, 0.4, torch.Generator().manual_seed(5), vol=vol)
    assert torch.allclose(got[..., 0], want[:, 0], rtol=1e-5, atol=1e-6)


def test_contentvec_matches_the_program_encoder():
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

    enc = tiny_config()["speech_encoder"]
    sd = weights.seeded_state_dict(weights.meta(lambda: contentvec.ContentVec(enc)), 4, "cpu")
    prog = Wav2Vec2Encoder(Wav2Vec2Config(d_model=enc["d_model"], n_layers=enc["n_layers"],
                                          n_heads=enc["n_heads"], ffn_dim=enc["ffn_dim"],
                                          conv_layers=tuple(map(tuple, enc["conv_layers"])),
                                          output_layer=enc["output_layer"],
                                          pos_conv_kernel=enc["pos_conv_kernel"],
                                          pos_conv_groups=enc["pos_conv_groups"]))
    prog.load_state_dict(sd)
    ref = contentvec.ContentVec(enc)
    ref.load_state_dict(sd)
    wav = torch.randn(1, 16000, generator=torch.Generator().manual_seed(2)) * 0.1
    with torch.no_grad():
        assert torch.allclose(prog(wav), ref(wav), rtol=1e-4, atol=1e-5)


def _limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())


def _drive(kind: str, config: str, cell: str, seed: int = 7):
    run = tiny_run(kind, seed=seed, seconds=1.0, config=config, limits=_limits(cell))
    harness.driver(run.traffic).run(run)
    return run


@pytest.mark.parametrize("kind,config,cell", [
    ("serve", "sovits41-default", "serve.default"),
    ("train", "sovits41-default", "train.default"),
    ("train", "sovits41-vol-tflow", "train.vol-tflow"),
])
def test_sound_run_is_correct(kind, config, cell):
    run = _drive(kind, config, cell)
    assert run.correct, run.compared
    assert run.attempted > 0 and run.failed == 0


def _altered_synth(monkeypatch):
    from sovits_tpu_torch.models.synthesizer import Synthesizer

    infer = Synthesizer.infer

    def altered(self, *a, **k):
        wav, f0 = infer(self, *a, **k)
        return wav * 1.01, f0
    monkeypatch.setattr(Synthesizer, "infer", altered)


def _half_dispatch(monkeypatch):
    from sovits_tpu_torch.models.synthesizer import Synthesizer

    infer = Synthesizer.infer

    def half(self, c, f0, uv, spk, **k):
        wav, f0_out = infer(self, c, f0, uv, spk, **k)
        keep = max(1, c.shape[0] // 2)
        wav = wav.clone()
        wav[keep:] = wav[:keep].mean(0, keepdim=True)
        return wav, f0_out
    monkeypatch.setattr(Synthesizer, "infer", half)


def _shifted_f0(monkeypatch):
    from sovits_tpu_torch.f0.base import F0Predictor

    compute = F0Predictor.compute_f0_uv

    def up(self, *a, **k):
        f0, uv = compute(self, *a, **k)
        return f0 * 2 ** (1 / 12), uv
    monkeypatch.setattr(F0Predictor, "compute_f0_uv", up)


def _unchanged_state(monkeypatch):
    from sovits_tpu_torch.train import optim

    make = optim.make_optimizer

    def frozen(params, hps):
        opt = make(params, hps)
        opt.step = lambda closure=None: None
        return opt
    monkeypatch.setattr(optim, "make_optimizer", frozen)


def _half_batch(monkeypatch):
    from sovits_tpu_torch.train import step as step_mod

    train_step = step_mod.train_step

    def half(net_g, net_d, og, od, batch, hps, **k):
        n = next(iter(batch.values())).shape[0] // 2
        return train_step(net_g, net_d, og, od, {key: v[:n] for key, v in batch.items()}, hps, **k)
    monkeypatch.setattr(step_mod, "train_step", half)


def _altered_loss(monkeypatch):
    from sovits_tpu_torch.train import step as step_mod

    train_step = step_mod.train_step

    def altered(*a, **k):
        out = train_step(*a, **k)
        out["loss/g/total"] = out["loss/g/total"] * 1.01
        return out
    monkeypatch.setattr(step_mod, "train_step", altered)


def _raising_take(monkeypatch):
    from sovits_tpu_torch.infer.svc import Svc

    convert, calls = Svc.slice_inference, [0]
    first_in_window = tiny_traffic("serve")["pool"] + 1  # after the warm-up's pass over the pool

    def raising(self, *a, **k):
        calls[0] += 1
        if calls[0] == first_in_window:
            raise RuntimeError("planted")
        return convert(self, *a, **k)
    monkeypatch.setattr(Svc, "slice_inference", raising)


def _nonfinite_loss(monkeypatch):
    from sovits_tpu_torch.train import step as step_mod

    train_step, calls = step_mod.train_step, [0]

    def nonfinite(*a, **k):
        out = train_step(*a, **k)
        calls[0] += 1
        if calls[0] > 3:  # a window step, after the three checked ones
            out["loss/g/total"] = out["loss/g/total"] * float("nan")
        return out
    monkeypatch.setattr(step_mod, "train_step", nonfinite)


@pytest.mark.parametrize("kind,cell,fault", [
    ("serve", "serve.default", _altered_synth),
    ("serve", "serve.default", _raising_take),
    ("serve", "serve.default", _half_dispatch),
    ("serve", "serve.default", _shifted_f0),
    ("train", "train.default", _unchanged_state),
    ("train", "train.default", _half_batch),
    ("train", "train.default", _altered_loss),
    ("train", "train.default", _nonfinite_loss),
])
def test_broken_path_is_not_correct(monkeypatch, kind, cell, fault):
    fault(monkeypatch)
    run = _drive(kind, "sovits41-default", cell)
    assert not run.correct, run.compared
