"""The port's spans and counters (CPU, tiny config).

(a) Svc.slice_inference under torch.profiler: one ``svc.slice_inference``
    span holding ``svc.slice``, one ``svc.pad`` and one ``svc.frontend``
    per chunk, the latter with its five stages, one ``svc.dispatch`` per
    synthesizer batch with its three, and ``svc.join``; the counters equal
    a hand count from the chunks' frames and ``BUCKETS``.
(b) With no profiler running the same take gives the same audio, no
    counter moves and no ``record_function`` is entered.
(c) Training: ``batch_iterator``'s ``train.data_wait`` and feed counters,
    ``_to_device``'s ``train.to_device`` and ``train_step``'s three phases;
    nothing is counted outside a window.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch import utils  # noqa: E402
from sovits_tpu_torch.infer import svc as svc_mod  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from tests.tiny import TINY_OVERRIDES, make_synthetic_dataset, tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

SR = TINY_OVERRIDES["data.sampling_rate"]
FRONTEND = ["svc.encode", "svc.f0", "svc.resample", "svc.units_wait", "svc.volume"]
DISPATCH = ["svc.stack", "svc.synth", "svc.fetch"]


class SeededEncoder:
    """A stand-in speech encoder: seeded units at 50 frames/s."""

    name = "fake"
    hidden_dim = TINY_OVERRIDES["model.ssl_dim"]

    def encode_async(self, wav16k):
        n = max((len(wav16k) - 400) // 320 + 1, 1)
        units = np.random.default_rng(len(wav16k)).standard_normal((n, self.hidden_dim))
        return lambda: (0.3 * units).astype(np.float32)


def _take() -> np.ndarray:
    """Three phrases between short silences: two slicer chunks of 5.5-7 s
    (bucket 1024 with the padding) and one of 12 s (bucket 2048)."""
    rng = np.random.default_rng(0)
    parts = []
    for seconds in (5.5, 6.0, 12.0):
        t = np.arange(int(SR * seconds)) / SR
        inst_f = 170.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
        parts.append(0.25 * np.sin(2 * np.pi * np.cumsum(inst_f) / SR) + 0.02 * rng.standard_normal(len(t)))
        parts.append(np.zeros(int(SR * 0.8)))
    return np.concatenate(parts[:-1]).astype(np.float32)


def _spans(prof, tmp_path) -> list[dict]:
    """The window's spans, each with its ``parent``: the shortest span on
    its thread that holds it."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    for e in spans:
        holders = [p for p in spans if p is not e and p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"] and p["dur"] > e["dur"]]
        e["parent"] = min(holders, key=lambda p: p["dur"])["name"] if holders else None
    return spans


def _children(spans, parent) -> list[str]:
    return sorted(e["name"] for e in spans
                  if e["parent"] == parent["name"] and parent["ts"] <= e["ts"] <= parent["ts"] + parent["dur"])


@pytest.fixture(scope="module")
def svc(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    hps = pcfg.default_config(**TINY_OVERRIDES)
    hps["spk"] = pcfg.HParams(alto=0, tenor=1)
    pcfg.save_config(hps, root / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True),
                                 torch.Generator().manual_seed(3))
    torch.save({"model": model.state_dict(), "iteration": 0}, root / "G_0.pth")
    return svc_mod.Svc(str(root / "G_0.pth"), str(root / "config.json"), encoder=SeededEncoder(),
                       device="cpu")


@pytest.fixture(scope="module")
def traced_take(svc, tmp_path_factory):
    """One take converted inside a profiler window: its audio, spans,
    counters and each chunk's frames as ``_prepare_chunk`` returned them."""
    frames = []
    prepare = svc._prepare_chunk

    def spy(*a, **k):
        item = prepare(*a, **k)
        frames.append(int(item["n_frames"]))
        return item

    svc._prepare_chunk = spy
    utils.reset_counters()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = svc.slice_inference(_take(), SR, "tenor", 0, f0_predictor="dio")
    finally:
        del svc._prepare_chunk
    return out, _spans(prof, tmp_path_factory.mktemp("trace")), utils.counters(), frames


def test_take_span_tree(traced_take):
    _, spans, _, frames = traced_take
    assert len(frames) == 3
    names = [e["name"] for e in spans]
    assert names.count("svc.slice_inference") == 1
    (take,) = [e for e in spans if e["name"] == "svc.slice_inference"]
    assert take["parent"] is None
    assert all(e["parent"] is not None for e in spans if e is not take)
    assert _children(spans, take) == sorted(
        ["svc.slice", "svc.join"] + ["svc.pad", "svc.frontend"] * 3 + ["svc.dispatch"] * 2)
    for e in spans:
        if e["name"] == "svc.frontend":  # the take is at the model rate: one resample, to 16 kHz
            assert _children(spans, e) == FRONTEND
        if e["name"] == "svc.dispatch":
            assert _children(spans, e) == sorted(DISPATCH)
    for name in FRONTEND:
        assert names.count(name) == 3, name
    for name in DISPATCH:
        assert names.count(name) == 2, name


def test_take_counters_equal_a_hand_count(traced_take):
    _, _, counted, frames = traced_take
    buckets = [next(b for b in svc_mod.BUCKETS if b >= n) for n in frames]
    rows = {b: buckets.count(b) for b in set(buckets)}
    padded = {b: 1 << (n - 1).bit_length() for b, n in rows.items()}
    assert sorted(buckets) == [1024, 1024, 2048]
    assert counted == {
        "svc.takes": 1, "svc.chunks": len(frames), "svc.dispatches": len(rows),
        "svc.dispatch_rows": sum(padded.values()), "svc.real_frames": sum(frames),
        "svc.synth_frames": sum(b * n for b, n in padded.items()),
    }


def test_no_window_no_spans_no_counts(svc, traced_take, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    utils.reset_counters()
    out = svc.slice_inference(_take(), SR, "tenor", 0, f0_predictor="dio")
    assert entered == [] and utils.counters() == {}
    np.testing.assert_array_equal(out, traced_take[0])  # spans change nothing
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        svc.infer("tenor", 0, _take()[: SR * 2], sr=SR, f0_predictor="dio")
    assert entered[0] == "svc.infer" and "svc.dispatch" in entered
    assert utils.counters()["svc.takes"] == 1 and utils.counters()["svc.dispatches"] == 1


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    hps = tiny_hps(**{"model.inter_channels": 16, "model.hidden_channels": 16,
                      "model.filter_channels": 32, "model.n_layers": 2, "model.disc_tiny": True,
                      "train.batch_size": 2})
    make_synthetic_dataset(tmp_path_factory.mktemp("corpus"), hps)
    return pcfg.HParams(**hps.to_dict())


def test_training_spans_and_feed_counters(corpus, tmp_path):
    from sovits_tpu_torch.train import trainer
    from sovits_tpu_torch.train.data import FeatureDataset, batch_iterator
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    hps = corpus
    net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False), torch.Generator().manual_seed(0))
    net_d = factory.build_discriminator(hps, "cpu")
    optim_g, optim_d = make_optimizer(net_g.parameters(), hps), make_optimizer(net_d.parameters(), hps)
    utils.reset_counters()
    batches = batch_iterator(FeatureDataset(hps.data.training_files, hps), 2, seed=3)
    next(batches)  # outside a window: counts nothing
    assert utils.counters() == {}
    steps = 2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            batch = next(batches)
            assert all(isinstance(v, np.ndarray) for v in batch.values())
            train_step(net_g, net_d, optim_g, optim_d, trainer._to_device(batch, torch.device("cpu")), hps,
                       generator=torch.Generator().manual_seed(1))
    next(batches)
    batches.close()
    assert utils.counters()["train.feed_batches"] == steps  # the take after the window is not counted
    spans = _spans(prof, tmp_path)
    names = [e["name"] for e in spans]
    for name in ("train.data_wait", "train.to_device", "train.g_forward", "train.d_step", "train.g_step"):
        assert names.count(name) == steps, name
        assert all(e["parent"] is None for e in spans if e["name"] == name), name
    # the optimizer's own range sits in each update's phase
    optim = [e["parent"] for e in spans if e["name"].startswith("Optimizer.step#")]
    assert sorted(optim) == sorted(["train.d_step", "train.g_step"] * steps)
    counted = utils.counters()
    assert set(counted) == {"train.feed_batches", "train.feed_build_s", "train.feed_empty"}
    assert counted["train.feed_batches"] == steps
    assert 0 < counted["train.feed_build_s"] < 60 and 0 <= counted["train.feed_empty"] <= steps
