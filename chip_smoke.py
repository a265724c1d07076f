"""Drive the PyTorch/CUDA port's voice-conversion path once on one GPU.

    python3 chip_smoke.py

Phases, one line each: 1 device, 2 kernel build, 3 kernel parity against
the plain PyTorch versions, 4 main path (full-width Svc with seeded random
weights answering real requests), 5 card vs CPU on the same weights,
6 kernel times. Any failure raises, so the script exits non-zero; the last
line is the JSON result the caller reads. Needs a CUDA card; without one
(or without the repository around it) it fails before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 both sides; sums in another order
TRIO_TOL = dict(rtol=1e-4, atol=1e-5)
SECONDS = 10.0


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log("device", name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)
    return name


def phase_build() -> None:
    from sovits_tpu_torch.ops import build

    for name in ("rel_attention", "resblock_trio"):
        kl = build.load(name)
        summary = [ln.strip() for ln in kl.ptxas_log.splitlines() if "registers" in ln or "spill" in ln]
        log("build", kernel=name, seconds=f"{kl.build_seconds:.2f}", lib=kl.path.name)
        for ln in summary:
            print("    ptxas:", ln, flush=True)


def _attn_case(t, causal, masked, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    bh, d, w = 2, 96, None if causal else 4
    q = torch.randn(bh, t, d, generator=g) * d**-0.5
    k = torch.randn(bh, t, d, generator=g)
    v = torch.randn(bh, t, d, generator=g)
    rel = [torch.randn(2 * w + 1, d, generator=g) * d**-0.5 for _ in range(2)] if w else [None, None]
    km = None
    if masked:
        km = torch.ones(bh, t)
        km[1, t - t // 5:] = 0.0  # second row padded, as a shorter clip in a batch
    dev = [x.cuda() if x is not None else None for x in (q, k, v, *rel, km)]
    return dev, w


def _trio_case(c, t, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(1, t, c, generator=g)
    kernels = [torch.randn(k, c, c, generator=g) * (0.5 / (k * c) ** 0.5)
               for k in (3, 7, 11) for _ in range(6)]
    biases = [torch.randn(c, generator=g) * 0.01 for _ in range(18)]
    return x.cuda(), [w.cuda() for w in kernels], [b.cuda() for b in biases]


# stage lengths of a 10 s 44.1 kHz clip (861 frames) after 8, 64, 128, 256, 512x
TRIO_STAGES = [(128, 861 * 64), (64, 861 * 128), (32, 861 * 256), (16, 861 * 512)]
ATTN_CASES = [(128, False, True), (1024, False, True), (2048, False, True), (1024, True, False)]


def phase_parity() -> dict:
    from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_plain
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("parity", tf32="off (matmul and cudnn)", attn_tol=ATTN_TOL, trio_tol=TRIO_TOL)
    errs = {"rel_attention": 0.0, "resblock_trio": 0.0}
    for i, (t, causal, masked) in enumerate(ATTN_CASES):
        (q, k, v, rk, rv, km), w = _attn_case(t, causal, masked, i)
        got = fused_attention(q, k, v, rk, rv, km, window=w, causal=causal)
        torch.cuda.synchronize()
        ref = fused_attention_plain(q, k, v, rk, rv, km, window=w, causal=causal)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = torch.allclose(got, ref, **ATTN_TOL)
        log("parity", kernel="rel_attention", shape=f"BH=2,T={t},D=96", window=w, causal=causal,
            key_mask=masked, max_abs_err=f"{err:.3e}", ok=ok)
        if not ok:
            raise AssertionError(f"rel_attention disagrees at T={t}: {err}")
        errs["rel_attention"] = max(errs["rel_attention"], err)
    for i, (c, t) in enumerate(TRIO_STAGES):
        x, kernels, biases = _trio_case(c, t, 10 + i)
        got = fused_resblock_trio(x, kernels, biases)
        torch.cuda.synchronize()
        ref = fused_resblock_trio_plain(x, kernels, biases)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = torch.allclose(got, ref, **TRIO_TOL)
        log("parity", kernel="resblock_trio", shape=f"B=1,T={t},C={c}", max_abs_err=f"{err:.3e}",
            ref_max=f"{ref.abs().max().item():.3f}", ok=ok)
        if not ok:
            raise AssertionError(f"resblock_trio disagrees at C={c}: {err}")
        errs["resblock_trio"] = max(errs["resblock_trio"], err)
    return errs


def _time(fn, iters=10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times() -> dict:
    from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_plain
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain

    times = {"rel_attention": [0.0, 0.0], "resblock_trio": [0.0, 0.0]}
    for i, (t, causal, masked) in enumerate(ATTN_CASES):
        (q, k, v, rk, rv, km), w = _attn_case(t, causal, masked, i)
        kw = dict(window=w, causal=causal)
        ms_k = _time(lambda: fused_attention(q, k, v, rk, rv, km, **kw))
        ms_p = _time(lambda: fused_attention_plain(q, k, v, rk, rv, km, **kw))
        log("times", kernel="rel_attention", T=t, causal=causal, kernel_ms=f"{ms_k:.4f}",
            plain_ms=f"{ms_p:.4f}")
        if t == 1024 and not causal:  # the 10 s clip's bucket: the JSON line's number
            times["rel_attention"] = [ms_k, ms_p]
    for i, (c, t) in enumerate(TRIO_STAGES):
        x, kernels, biases = _trio_case(c, t, 10 + i)
        ms_k = _time(lambda: fused_resblock_trio(x, kernels, biases), iters=5)
        ms_p = _time(lambda: fused_resblock_trio_plain(x, kernels, biases), iters=5)
        log("times", kernel="resblock_trio", C=c, T=t, kernel_ms=f"{ms_k:.4f}", plain_ms=f"{ms_p:.4f}")
        times["resblock_trio"][0] += ms_k  # the JSON line: all four stages of a 10 s clip
        times["resblock_trio"][1] += ms_p
    return times


def bench_signal(seconds: float, sr: int, seed: int = 0) -> np.ndarray:
    """bench.py's test signal: 170 Hz with vibrato, phase-integrated, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    inst_f = 170.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    wav = 0.25 * np.sin(2 * np.pi * np.cumsum(inst_f) / sr) + 0.02 * rng.standard_normal(len(t))
    return wav.astype(np.float32)


def build_svc(tmp: Path, device: str, encoder=None):
    """Full-width default config, seeded random weights written as a
    so-vits-svc G_0.pth, loaded by the port's Svc like a trained model."""
    from sovits_tpu import config as scfg
    from sovits_tpu_torch.encoders.factory import CONFIGS, SpeechEncoder
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Encoder
    from sovits_tpu_torch.infer.svc import Svc
    from sovits_tpu_torch.models import factory

    if not (tmp / "G_0.pth").exists():
        hps = scfg.default_config()
        scfg.save_config(hps, tmp / "config.json")
        model = factory.init_random_(factory.build_synthesizer(hps, "cpu"),
                                     torch.Generator().manual_seed(0))
        torch.save({"model": model.state_dict(), "iteration": 0}, tmp / "G_0.pth")
    if encoder is None:
        net = factory.init_random_(Wav2Vec2Encoder(CONFIGS["vec768l12"]), torch.Generator().manual_seed(1))
        encoder = SpeechEncoder("vec768l12", net, device)
    return Svc(str(tmp / "G_0.pth"), str(tmp / "config.json"), encoder=encoder, device=device)


def phase_main_path(tmp: Path):
    from sovits_tpu_torch.ops.attention import fused_attention
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio

    svc = build_svc(tmp, "cuda")
    sr, hop = svc.target_sample, svc.hop_size
    long_clip = bench_signal(SECONDS, sr)
    requests = [
        ("10s warm-up", long_clip, False),
        ("10s", long_clip, False),
        ("3s", bench_signal(3.0, sr, seed=1), False),
        ("20s (bucket 2048)", bench_signal(20.0, sr, seed=2), False),
        ("10s auto_predict_f0", long_clip, True),
    ]
    fused_attention.launches = 0
    fused_resblock_trio.launches = 0
    rtf = None
    for name, wav, auto in requests:
        k1, k3 = fused_attention.launches, fused_resblock_trio.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, n_samples, n_frames = svc.infer(0, 0, wav, sr=sr, f0_predictor="dio",
                                               auto_predict_f0=auto)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seconds = len(wav) / sr
        ok = (n_samples == n_frames * hop == len(wav) // hop * hop and np.isfinite(audio).all()
              and float(np.abs(audio).max()) > 1e-4)
        log("main", request=repr(name), seconds=seconds, frames=n_frames, wall_s=f"{wall:.4f}",
            rtf=f"{wall / seconds:.5f}", rel_attention=fused_attention.launches - k1,
            resblock_trio=fused_resblock_trio.launches - k3, peak=f"{np.abs(audio).max():.4f}", ok=ok)
        if not ok:
            raise AssertionError(f"request {name}: bad output")
        if name == "10s":
            rtf = wall / seconds
    launches = {"rel_attention": fused_attention.launches, "resblock_trio": fused_resblock_trio.launches}
    log("main", launches=launches, rtf_10s=f"{rtf:.5f}")
    if min(launches.values()) == 0:
        raise AssertionError(f"the main path did not run every kernel: {launches}")
    log("breakdown", clip="10s", **stage_times(svc, long_clip))
    return svc, launches


def stage_times(svc, wav: np.ndarray) -> dict:
    """Seconds of each stage of one request, run one after another (in
    Svc.infer the encoder overlaps DIO)."""
    from sovits_tpu_torch.dsp.audio import resample

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    sr = svc.target_sample
    t_resample, wav16k = timed(lambda: resample(wav, sr, 16000))
    t_encoder, _ = timed(lambda: svc.encoder.encode(wav16k))
    t_dio, _ = timed(lambda: svc.f0_predictor_object.compute_f0_uv(wav))
    item = svc._prepare_chunk(0, 0, wav, sr, 0.0, False, "dio", 0.05)
    t_synth, _ = timed(lambda: svc._run_synth_batch([item], 0.4, False, 52468))
    return {k: f"{v:.4f}" for k, v in dict(resample_s=t_resample, encoder_s=t_encoder,
                                          dio_host_s=t_dio, synthesizer_s=t_synth).items()}


def phase_card_vs_cpu(tmp: Path, svc) -> None:
    from sovits_tpu_torch.dsp.mel import mel_spectrogram

    cpu_svc = build_svc(tmp, "cpu", encoder=svc.encoder)
    sr = svc.target_sample
    item = svc._prepare_chunk(0, 0, bench_signal(3.0, sr, seed=3), sr, 0.0, False, "dio", 0.05)
    card = svc._run_synth_batch([item], 0.0, False, 52468, sample_noise=False)[0]
    host = cpu_svc._run_synth_batch([item], 0.0, False, 52468, sample_noise=False)[0]
    mels = [mel_spectrogram(torch.from_numpy(a)[None]) for a in (card, host)]
    l1 = (mels[0] - mels[1]).abs().mean().item()
    log("card_vs_cpu", clip="3s", max_abs=f"{np.abs(card - host).max():.3e}", mel_l1=f"{l1:.3e}",
        limit=1e-3, ok=l1 < 1e-3)
    if not l1 < 1e-3:
        raise AssertionError(f"card and CPU disagree: log-mel L1 {l1}")


KERNELS = {
    "rel_attention": ("sovits_tpu_torch/csrc/rel_attention.cu", "sovits_tpu/ops/attention.py:191"),
    "resblock_trio": ("sovits_tpu_torch/csrc/resblock_trio.cu", "sovits_tpu/ops/fused_stage.py:200"),
}


def main() -> None:
    name = phase_device()
    phase_build()
    errs = phase_parity()
    with tempfile.TemporaryDirectory() as tmp:
        svc, launches = phase_main_path(Path(tmp))
        phase_card_vs_cpu(Path(tmp), svc)
    times = phase_times()
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": launches[k],
         "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
