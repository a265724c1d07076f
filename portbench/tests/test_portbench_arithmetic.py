"""The benchmark's own arithmetic on the CPU: the generators are
deterministic in the seed, the rate and the tail respond to a stall, and
each kernel's operations and bytes equal a hand count."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, signals  # noqa: E402
from portbench.drivers import serve_takes  # noqa: E402

HERE = ROOT / "portbench"
trio = harness.load_module(HERE / "metrics" / "resblock_trio_roofline.py", "trio_roofline_test")
k2 = harness.load_module(HERE / "metrics" / "rel_attention_bwd_roofline.py", "k2_roofline_test")


def _takes(seed):
    layouts = signals.take_layouts(4, 3, 12)
    return signals.synthesize(layouts, seed, "cpu", 200)


def test_takes_are_deterministic_in_the_seed():
    a, b, c = _takes(5), _takes(5), _takes(6)
    for x, y in zip(a, b):
        assert np.array_equal(x.audio, y.audio) and x.speaker == y.speaker
    assert [len(x.audio) for x in a] == [len(x.audio) for x in c]  # sizes do not move with the seed
    assert any(not np.array_equal(x.audio, y.audio) for x, y in zip(a, c))
    assert signals.order(48, 2**33 + 5) == signals.order(48, 2**33 + 5)
    assert sorted(signals.order(48, 7)) == list(range(48))


def test_take_pitch_is_what_was_drawn():
    clip = _takes(9)[0]
    p = clip.phrases[0]
    mid = p.start + p.length // 2
    seg = clip.audio[mid - 4096: mid + 4096].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg)), 1 << 16))
    peak = np.argmax(spec[: int(500 * (1 << 16) / signals.SR)]) * signals.SR / (1 << 16)
    true = clip.f0_at(np.arange(mid - 4096, mid + 4096), 0)
    assert true.min() * 0.97 < peak < true.max() * 1.03


def test_rate_and_tail_see_a_stall():
    takes = [(10.0, 0.12)] * 40
    stalled = takes[:20] + [(10.0, 1.5)] * 3 + takes[23:]
    rate = lambda d: sum(a for a, _ in d) / sum(w for _, w in d)  # noqa: E731
    assert rate(stalled) < rate(takes)
    assert serve_takes.p95([w / a for a, w in stalled]) > serve_takes.p95([w / a for a, w in takes])
    assert serve_takes.p95(list(range(1, 101))) == 95


def test_failed_takes_count_no_audio():
    done = [(10.0, 0.12)] * 20 + [(10.0, 0.01)] * 2
    faults = [""] * 20 + ["raised RuntimeError: planted"] * 2
    audio_s, rate, tail = serve_takes.rates(done, faults, 2.42)
    assert audio_s == 200.0 and rate == 200.0 / 2.42
    assert tail == serve_takes.p95([0.012] * 20)


def test_resblock_trio_counts_by_hand():
    b, t, c, ks = 1, 1000, 16, (3, 7, 11)
    # one stage: 3 kernel sizes x (3 dilated + 3 plain) convs, each 2 B T C C k
    flops = sum(6 * 2 * b * t * c * c * k for k in ks)
    assert trio.trio_flops(b, t, c, ks) == flops
    bytes_ = 4 * (b * t * c + b * t * c + sum(6 * k * c * c for k in ks) + 18 * c)
    assert trio.trio_bytes(b, t, c, ks) == bytes_


def test_attention_backward_counts_by_hand():
    heads, d, n = 2, 96, 10
    flops, nbytes = k2.launch_cost([n], heads, d, None, True)
    pairs = n * (n + 1) // 2
    assert flops == heads * 5 * 2 * d * pairs
    assert nbytes == 4 * heads * (8 * n * d + 2 * n + pairs)
    flops_w, nbytes_w = k2.launch_cost([n], heads, d, 4, False)
    assert flops_w == heads * 10 * d * (n * n + n * 9)
    assert nbytes_w == 4 * heads * (8 * n * d + 2 * n + n * n) + 4 * 4 * 9 * d


def test_busy_time_merges_overlaps():
    ev = [{"cat": "kernel", "ts": 0, "dur": 10, "name": "a"}, {"cat": "kernel", "ts": 5, "dur": 10, "name": "b"},
          {"cat": "kernel", "ts": 30, "dur": 5, "name": "a"}, {"cat": "cpu_op", "ts": 0, "dur": 100, "name": "x"}]
    assert harness.busy_s(ev) == pytest.approx(20e-6)
    bd = harness.breakdown(ev)
    assert bd["device_ops"][0][0] == "a" and bd["idle_gaps"] == [["x", pytest.approx(15e-6)]]


def test_weights_are_deterministic_and_weight_norm_is_the_draw():
    from portbench import weights
    from portbench.reference import nets

    torch.manual_seed(0)
    m = weights.meta(lambda: nets.WN(8, 5, 1, 2, 4))
    a = weights.seeded_state_dict(m, 3, "cpu")
    b = weights.seeded_state_dict(m, 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    v, g = a["in_layers.0.weight_v"], a["in_layers.0.weight_g"]
    assert torch.allclose(g, torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True))
    assert weights.subseed(2**33, "G") != weights.subseed(2**33, "D")
