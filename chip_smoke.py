"""Drive the PyTorch/CUDA port's voice-conversion and training paths once
on one GPU.

    python3 chip_smoke.py

Phases: 1 device, 2 build (every kernel and the native WORLD library, all
at once), 3 kernel parity against the plain PyTorch versions (fp32 and bf16
forwards, the attention backward, the fused trio's autograd Function, the
trio staging microbench's two variants), 4 main path (full-width fp32 Svc
with seeded random weights answering real requests), 5 card vs CPU on the
same weights, 6 the bf16 main path (the same requests through a bf16 Svc and
a bf16 encoder; bf16 against fp32 audio), 7 ``slice_inference`` (a 59.5 s
song of six pieces in fp32 and bf16, each same-bucket group one batched
dispatch; forced clips, the loudness envelope, a speaker mix, harvest and
yin, RealTimeVC, one batched dispatch on the card against the CPU, and the
infer CLI), 8 ``[configs]``: so-vits-svc 4.1's model options at full width
(volume embedding with the transformer flow, the tiny template's depthwise
convs and shared flow, ResBlock2, the Snake vocoder), each a seeded
G_0.pth loaded by Svc, with its K1/K3 launches checked, held against the
CPU and, for two of them, run in bf16 too, 9 ``[diffusion]``: shallow
diffusion at full width (so-vits-svc's published diffusion template and
44.1 kHz NSF-HiFiGAN vocoder as seeded checkpoints) through Svc.infer,
slice_inference and the infer CLI, in fp32 and on the bf16 Svc, with
only_diffusion, the enhancer and every sampler, each request's K1/K3
launches checked and its stages timed, held against the CPU, 10
``[frontend]``: the f0 nets (RMVPE, FCPE, CREPE "full") and the vec256l9,
hubertsoft and cnhubertlarge encoders at their published widths with seeded
weights, each held against a CPU copy and run in 10 s requests through Svc,
11 ``[encoders]``: whisper-ppg (medium), whisper-ppg-large (large-v2),
wavlmbase+ and dphubert the same way, each written in its published
checkpoint layout, 12 ``[cluster]``: k-means (10 000 centers, 50 steps) over
an hour of one speaker's units (180 000 x 768) and a retrieval bank of the
same rows on the card, the blends card against CPU, 10 s requests through
Svc at cluster ratio 0.5 (k-means .npz, kmeans_10000.pt, retrieval), the
train_cluster and infer CLIs, 13 ``[pipeline]``: a user's training path
through its CLIs (2 speakers x 6 seeded 48 kHz stereo clips resampled,
filelists and config, features with --use_diff, four GAN steps at the
default config with two evaluations, compress and mix, 200 diffusion steps
at so-vits-svc's template (one profiled) and a resume, one diffusion step
held against the CPU, the trained model served with shallow diffusion),
14 ``[surfaces]``: the HTTP API on 127.0.0.1 answering the 10 s clip raw
and through RealTimeVC and the song, each twice, each response against the
direct call, with the server's stage times, 15 ``[export]``: the full-width synthesizer by torch.export, saved,
loaded and run with K1 and K3 as the sovits operators against the live
one, the ONNX synthesizer through the port's runtime on the card, the
diffusion ONNX artifacts with the PLMS loop replayed through them, the
operators' dispatch cost, and the 10 s request through the operators
against direct launches, 16 training (a feature dataset made by the port
itself, six full-width GAN steps through ``train``, a resume, a profiled
step), 17 ``[train-configs]``: so-vits-svc 4.1's model options trained at
full width (a volume + transformer-flow model through
preprocess_flist_config --vol_aug --use_transformer_flow,
preprocess_features and cli.train with an evaluation and a resume, then
served by Svc; ResBlock2, Snake and the tiny template through train(); one
deterministic step of vol_tflow and of Snake on the card against the CPU;
vol_tflow's bf16 step against fp32; a learning proof with the volume
embedding and the transformer flow), 18 three GAN steps with the fused tail
against the same steps without it, 19 ``[learning]``: tests/test_learning.py's
GAN learning proof (300 steps on one batch, then train() with a resume), 20
``[parallel]``:
parallel/ at world size 1 over NCCL: the 59.5 s song through
Svc.infer_seq_parallel in fp32 (against Synthesizer.infer) and bf16
(against fp32), the shard-local decode at 4 and 8 shards against the
monolithic decode across every seam, noise off and on, with K3 in every
shard, two DDP GAN steps through train(mesh) and two FSDP-sharded steps
against the plain ones, a DDP diffusion step against the plain one, and
the infer CLI's -ss, 21 the bf16 GAN step at bench.py's
training configuration (batch 6 x 512 frames, bf16 synthesizer and
discriminator; its first step against the same step through fp32 nets),
22 the trio staging microbench at its defaults, 23 kernel times beside
their bounds. Any failure raises, so the script exits non-zero; the
last line is the JSON result the caller reads. Needs a CUDA card; without
one (or without the repository around it) it fails before printing a result.
"""

from __future__ import annotations

import contextlib
import itertools
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
# dq/dk/dv as the forward; the rel-table and autograd leaf grads sum over
# every row of every head (9600 rows at the training shape)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
REL_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# a bf16 kernel against its plain bf16 version: max-abs <= 2e-2 x max|plain|,
# a few bf16 ulps (bench.py's bf16 trio comparisons use 5e-2)
BF16_REL = 2e-2
# a bf16 request against the fp32 one: log-mel L1 < 0.1 over the mel bins
# within 40 dB of the loudest (bench.py:711 puts bf16-precision mel-L1 near
# 4e-2), and wave max-abs <= 5e-2 x peak (bench.py's bar for two bf16
# decodes). The L1 over all bins is printed beside the L1 that rounding the
# fp32 audio to bf16 alone gives: with random weights most bins lie below
# the bf16 output's rounding noise, and both are far above 0.1 there.
MEL_L1_BF16 = 0.1
LOUD_DB = 40.0
E2E_REL = 5e-2
STEP_REL = 1e-3  # fused-tail against unfused GAN step, fp32: the card training-step test's bar
# the bf16 GAN step's first step against the same step through fp32 nets (same
# weights, batch and generator seed): each loss within 5e-2 relative, the
# generator's whole gradient within 0.1 relative in norm. The mel loss (and
# so the total) is held through its waveform instead, as the bf16 request is
# (loud-bin log-mel L1 < MEL_L1_BF16, wave max-abs <= E2E_REL x peak): with
# random weights most mel bins of the generator's quiet output lie below
# bf16's rounding noise, which lifts them and moved the mel loss by 14.6% on
# an H100 (PERF.md; the same effect as the bf16 request's all-bin log-mel L1)
BF16_STEP_LOSS_REL = 5e-2
BF16_STEP_GRAD_REL = 0.1
BENCH_T = 512  # bench.py's training step: batch 6 x 512 frames (bench.py:747-748)
SECONDS = 10.0
# the H100's published peaks (SXM, 700 W): bf16 dense tensor cores, fp32
# outside the tensor cores, TF32 dense tensor cores, HBM
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12
TF32_TC_FLOPS = 495e12
HBM_BYTES = 3.35e12
TRAIN_BH, TRAIN_T, HEAD_D = 12, 800, 96  # batch 6 x 2 heads, pad_to_frames, 192 / 2
# the fused tail's stages in a training step: batch 6, segment 10240 samples
TRAIN_TRIO_STAGES = [(128, 1280), (64, 2560), (32, 5120), (16, 10240)]


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
    from sovits_tpu_torch import native
    from sovits_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.load_all()  # one nvcc per source, all at once
    wall = time.perf_counter() - t0
    for name, kl in libs.items():
        log("build", kernel=name, seconds=f"{kl.build_seconds:.2f}", lib=kl.path.name)
        rows = ptxas_summary(kl.ptxas_log)  # the log of this build, or of the reused one
        wanted = CHECKED_INSTANTIATIONS.get(name, [])
        for fn, regs, spills in rows:
            print(f"    ptxas: {fn}: {regs} registers, {spills}", flush=True)
            if fn in wanted and not spills.startswith("0 bytes spill stores, 0 bytes spill loads"):
                raise AssertionError(f"{fn} spills: {spills}")
        missing = set(wanted) - {fn for fn, _, _ in rows}  # every instantiation must have been checked
        if missing:
            raise AssertionError(f"ptxas log of {kl.path.name} lacks {sorted(missing)}: "
                                 f"delete {kl.path.parent} and rebuild")
        tensor_core = [fn for fn in wanted if fn in HMMA_INSTANTIATIONS]
        if tensor_core:
            hmma = sass_hmma(kl.path)
            log("build", kernel=name, hmma={fn: hmma.get(fn, 0) for fn in tensor_core})
            idle = [fn for fn in tensor_core if hmma.get(fn, 0) == 0]
            if idle:
                raise AssertionError(f"no HMMA in the SASS of {idle}: they do not run on the tensor cores")
    t0 = time.perf_counter()
    native.load()
    log("build", kernels_wall_s=f"{wall:.2f}", world_f0_s=f"{time.perf_counter() - t0:.2f}",
        world_lib=native.library_path().name)


def kernel_name(mangled: str) -> str:
    """K1's instantiations as rel_attn_fwd<type, padded D>, K3's as
    trio_<type><C>, K2's as bwd_<pass>_<tf32 or bf16><padded D>, K4's as
    trio_shift<variant>; anything else its mangled name, cut."""
    import re

    m = re.search(r"rel_attn_fwdI(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if m:
        return f"rel_attn_fwd<{'fp32' if m.group(1) == 'f' else 'bf16'}, {m.group(2)}>"
    m = re.search(r"trio_shift_kernelI(f|13__nv_bfloat16)E", mangled)
    if m:
        return f"trio_shift<{'fp32' if m.group(1) == 'f' else 'bf16'}>"
    m = re.search(r"(trio_bf16|trio_fp32|bwd_(?:q|kv)_(?:tf32|bf16))ILi(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled[:80]


def sass_hmma(lib: Path) -> dict[str, int]:
    """HMMA (tensor-core) instructions per entry function in the SASS of a
    built library, from cuobjdump -sass (beside nvcc in the CUDA toolkit)."""
    from sovits_tpu_torch.ops import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = kernel_name(ln.split("Function :")[1].strip())
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def ptxas_summary(log_text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spill line) per entry function of an nvcc -Xptxas -v
    log, named by kernel_name."""
    rows, fn, spills = [], "?", ""
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            fn = kernel_name(ln.split("'")[1])
        elif "spill" in ln:
            spills = ln.strip().split(", ", 1)[1]
        elif "Used" in ln and "registers" in ln:
            rows.append((fn, ln.split("Used ")[1].split(" registers")[0], spills))
    return rows


# K1's entry functions as ptxas_summary names them: both types, D padded to 32/64/96/128
K1_INSTANTIATIONS = [f"rel_attn_fwd<{t}, {p}>" for t in ("fp32", "bf16") for p in (32, 64, 96, 128)]
# K3's entry functions, both types, C = 16/32/64/128
K3_INSTANTIATIONS = [f"trio_{t}<{c}>" for t in ("fp32", "bf16") for c in (16, 32, 64, 128)]
# K2's entry functions (its two passes) in each type, D padded to 32/64/96/128
K2_FP32_INSTANTIATIONS = [f"bwd_{p}_tf32<{d}>" for p in ("q", "kv") for d in (32, 64, 96, 128)]
K2_BF16_INSTANTIATIONS = [f"bwd_{p}_bf16<{d}>" for p in ("q", "kv") for d in (32, 64, 96, 128)]
# K2's kernels as the profiler names them: both passes in both types
K2_KERNELS = ("bwd_q_tf32", "bwd_kv_tf32", "bwd_q_bf16", "bwd_kv_bf16")
# K4's entry functions, its two variants
K4_INSTANTIATIONS = ["trio_shift<bf16>", "trio_shift<fp32>"]
# the entry functions each library's ptxas log must list, each with 0 spills;
# every one of them must show HMMA in its SASS (run on the tensor cores)
CHECKED_INSTANTIATIONS = {"rel_attention": K1_INSTANTIATIONS, "resblock_trio": K3_INSTANTIATIONS,
                          "rel_attention_bwd": K2_FP32_INSTANTIATIONS + K2_BF16_INSTANTIATIONS,
                          "trio_shift": K4_INSTANTIATIONS}
HMMA_INSTANTIATIONS = (K1_INSTANTIATIONS + K3_INSTANTIATIONS + K2_FP32_INSTANTIATIONS + K2_BF16_INSTANTIATIONS
                       + K4_INSTANTIATIONS)


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


def _train_attn_case(causal, seed):
    """Training shapes: the ContentEncoder (window 4, key mask) or the
    F0Decoder (causal), dropout 0.1 as keep/(1-rate) values, and a dout."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bh, t, d, w = TRAIN_BH, TRAIN_T, HEAD_D, None if causal else 4
    q = torch.randn(bh, t, d, generator=g) * d**-0.5
    k, v, dout = torch.randn(3, bh, t, d, generator=g)
    rel = [torch.randn(2 * w + 1, d, generator=g) * d**-0.5 for _ in range(2)] if w else [None, None]
    km = None
    if not causal:
        km = torch.ones(bh, t)
        km[-4:, t - t // 3:] = 0.0  # two shorter clips of the six
    dm = (torch.rand(bh, t, t, generator=g) >= 0.1).float() / 0.9
    dev = [x.cuda() if x is not None else None for x in (q, k.contiguous(), v.contiguous(), *rel, km, dm)]
    return dev, dout.contiguous().cuda(), w


def _max_err(got, want, tol, what) -> float:
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, **tol):
        raise AssertionError(f"{what} disagrees with its plain version: max-abs {err}")
    return err


def _trio_case(c, t, seed, batch=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(batch, t, c, generator=g)
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
    errs["resblock_trio"] = max(errs["resblock_trio"], parity_trio_edges(torch.float32))
    errs.update(parity_training_attention())
    errs.update(parity_bf16())
    errs["resblock_trio_bf16"] = max(errs["resblock_trio_bf16"], parity_trio_edges(torch.bfloat16))
    errs.update(parity_bf16_backward())
    parity_trio_vjp()
    return errs


def parity_trio_edges(dtype) -> float:
    """K3 at the edges of its tile plan, against its plain version on the same
    inputs: T shorter than a chain's halo (1, 5, 61), one past the largest
    tile (TT + 1 from trio_plan) and one past the smallest (129 = 8 x 16 + 1,
    the balanced plan's tile for short clips) at every C, and a batch of 6 at
    C = 128 (fp32 TRIO_TOL, bf16 BF16_REL x max|plain|). Returns the largest
    max-abs."""
    from sovits_tpu_torch.ops.fused_stage import TRIO_CHANNELS, fused_resblock_trio
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio_plain, trio_plan

    cases = [(c, t, 1) for c in TRIO_CHANNELS for t in (1, 5, 61, trio_plan(c, dtype).tt + 1, 129)]
    cases.append((128, 2 * trio_plan(128, dtype).tt + 7, 6))
    worst = 0.0
    for i, (c, t, b) in enumerate(cases):
        x, kernels, biases = _trio_case(c, t, 90 + i, batch=b)
        x, kernels, biases = x.to(dtype), [w.to(dtype) for w in kernels], [bb.to(dtype) for bb in biases]
        got = fused_resblock_trio(x, kernels, biases)
        torch.cuda.synchronize()
        ref = fused_resblock_trio_plain(x, kernels, biases)
        what = f"K3 {dtype} B={b} T={t} C={c}"
        err = _max_err(got, ref, TRIO_TOL, what) if dtype == torch.float32 else _rel_err(got, ref, what)
        worst = max(worst, err)
    log("parity", kernel="resblock_trio", dtype=str(dtype).split(".")[1], edge_cases=len(cases),
        shapes=" ".join(f"{b}x{t}x{c}" for c, t, b in cases), max_abs_err=f"{worst:.3e}", ok=True)
    return worst


def _bf16(xs):
    return [x.bfloat16() if x is not None else None for x in xs]


def _rel_err(got, want, what) -> float:
    """max-abs of bf16 got against want; raises above BF16_REL x max|want|."""
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    if got.dtype != want.dtype or not torch.isfinite(got.float()).all() or not err <= BF16_REL * peak:
        raise AssertionError(f"{what} disagrees with its plain version: max-abs {err}, max|plain| {peak}")
    return err


def parity_bf16() -> dict:
    """bf16 K1 (windowed T 1024 with a key mask; causal at the serving and
    training shapes), bf16 K3 (the four stages of a 10 s clip) and K4's two
    variants at the microbench's defaults, each against its plain version on
    the same bf16 inputs; K4's share of outputs not bit-equal to the plain
    version's is logged for both and held to MISMATCH_MAX for fp32."""
    from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_plain
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain
    from sovits_tpu_torch.tools.profile_trio_shift import (
        MISMATCH_MAX, make_inputs, mismatch, trio_shift, trio_shift_plain)

    log("parity", bf16_rel_tol=BF16_REL)
    errs = {"rel_attention_bf16": 0.0, "resblock_trio_bf16": 0.0}
    for i, (t, causal, masked) in enumerate([(1024, False, True), (1024, True, False)]):
        (q, k, v, rk, rv, km), w = _attn_case(t, causal, masked, 40 + i)
        args = [*_bf16((q, k, v, rk, rv)), km]
        got = fused_attention(*args, window=w, causal=causal)
        torch.cuda.synchronize()
        err = _rel_err(got, fused_attention_plain(*args, window=w, causal=causal), "K1 bf16")
        log("parity", kernel="rel_attention", dtype="bf16", shape=f"BH=2,T={t},D=96", window=w,
            causal=causal, key_mask=masked, max_abs_err=f"{err:.3e}", ok=True)
        errs["rel_attention_bf16"] = max(errs["rel_attention_bf16"], err)
    args, _, _ = _train_attn_case(True, 22)
    args = [*_bf16(args[:5]), None, None]
    got = fused_attention(*args, causal=True)
    torch.cuda.synchronize()
    err = _rel_err(got, fused_attention_plain(*args, causal=True), "K1 bf16 causal")
    log("parity", kernel="rel_attention", dtype="bf16", shape=f"BH={TRAIN_BH},T={TRAIN_T},D={HEAD_D}",
        causal=True, max_abs_err=f"{err:.3e}", ok=True)
    errs["rel_attention_bf16"] = max(errs["rel_attention_bf16"], err)
    for i, (c, t) in enumerate(TRIO_STAGES):
        x, kernels, biases = _trio_case(c, t, 50 + i)
        x, kernels, biases = x.bfloat16(), _bf16(kernels), _bf16(biases)
        got = fused_resblock_trio(x, kernels, biases)
        torch.cuda.synchronize()
        ref = fused_resblock_trio_plain(x, kernels, biases)
        err = _rel_err(got, ref, f"K3 bf16 C={c}")
        log("parity", kernel="resblock_trio", dtype="bf16", shape=f"B=1,T={t},C={c}",
            max_abs_err=f"{err:.3e}", ref_max=f"{ref.float().abs().max().item():.3f}", ok=True)
        errs["resblock_trio_bf16"] = max(errs["resblock_trio_bf16"], err)
    xp, mats = make_inputs(128, 55104, 0, "cuda")
    for variant in ("bf16", "fp32"):
        got = trio_shift(xp, mats, variant)
        torch.cuda.synchronize()
        ref = trio_shift_plain(xp, mats, variant)
        err = _rel_err(got, ref, f"K4 {variant}")
        share = mismatch(got, ref)
        if variant == "fp32" and not share <= MISMATCH_MAX:
            raise AssertionError(f"K4 fp32: {share:.2%} of the outputs differ from the plain version's bits")
        log("parity", kernel="trio_shift", variant=variant, shape=f"xp=[1,{xp.shape[1]},128]",
            rows=got.shape[1], max_abs_err=f"{err:.3e}", ref_max=f"{ref.float().abs().max().item():.4f}",
            not_bit_equal=f"{share:.5f}", ok=True)
        errs[f"trio_shift_{variant}"] = err
    return errs


def _bf16_train_attn_case(causal, seed, t=BENCH_T):
    """bench.py's bf16 step's attention shapes (BH 12, T 512, D 96): the
    ContentEncoder's (window 4, key mask) or the F0Decoder's (causal), with
    dropout 0.1 as the attention modules draw it in bf16 (mask values 0 and
    1.109375, stored float32); q, k, v, the tables and dout in bf16."""
    from sovits_tpu_torch.nn.dropout import keep_mask

    g = torch.Generator(device="cpu").manual_seed(seed)
    bh, d, w = TRAIN_BH, HEAD_D, None if causal else 4
    q = torch.randn(bh, t, d, generator=g) * d**-0.5
    k, v, dout = torch.randn(3, bh, t, d, generator=g)
    rel = [torch.randn(2 * w + 1, d, generator=g) * d**-0.5 for _ in range(2)] if w else [None, None]
    km = None
    if not causal:
        km = torch.ones(bh, t)
        km[-4:, t - t // 3:] = 0.0  # two shorter clips of the six
    dm = keep_mask((bh, t, t), 0.1, g, "cpu", torch.bfloat16)
    dev = [x.contiguous().cuda().bfloat16() if x is not None else None for x in (q, k, v, *rel)]
    dev += [x.cuda() if x is not None else None for x in (km, dm)]
    return dev, dout.contiguous().cuda().bfloat16(), w


def parity_bf16_backward() -> dict:
    """bf16 K2 against the plain bf16 backward (the TPU backward kernel's
    rounding points) at bench.py's bf16 step shapes, all five outputs within
    BF16_REL x max|plain|; causal row 0, whose one key makes ds cancel,
    exactly 0 as the plain version's."""
    from sovits_tpu_torch.ops.attention import _forward, fused_attention_bwd, fused_attention_bwd_plain

    err_all = 0.0
    for i, causal in enumerate((False, True)):
        args, dout, w = _bf16_train_attn_case(causal, 80 + i)
        out, lse = _forward(*args, w, causal, want_lse=True)
        got = fused_attention_bwd(*args, out, lse, dout, window=w, causal=causal)
        torch.cuda.synchronize()
        want = fused_attention_bwd_plain(*args, dout, window=w, causal=causal)
        errs = [_rel_err(a, b, f"K2 bf16 {n}") for n, a, b in
                zip(("dq", "dk", "dv", "drel_k", "drel_v"), got, want) if b is not None]
        row0 = (got[0][:, 0].float() - want[0][:, 0].float()).abs().max().item()
        if causal and (row0 != 0 or want[0][:, 0].any()):
            raise AssertionError(f"K2 bf16: causal row 0's dq is off by {row0}")
        log("parity", kernel="rel_attention_bwd", dtype="bf16", shape=f"BH={TRAIN_BH},T={BENCH_T},D={HEAD_D}",
            window=w, causal=causal, dropout=0.1, key_mask=args[5] is not None,
            max_abs_err=f"{max(errs):.3e}", per_output=[f"{e:.2e}" for e in errs],
            ref_max=[f"{b.float().abs().max().item():.3e}" for b in want if b is not None],
            row0_dq_err=f"{row0:.3e}" if causal else "n/a", ok=True)
        err_all = max(err_all, *errs)
    return {"rel_attention_bwd_bf16": err_all}


def parity_trio_vjp() -> None:
    """The fused trio's autograd Function (K3 forward, recomputed plain
    backward) against autograd through the plain version, at the training
    stages: gradients of x (BWD_TOL) and of every kernel and bias, which sum
    over all 61440 rows of the batch (REL_GRAD_TOL)."""
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain

    for i, (c, t) in enumerate(TRAIN_TRIO_STAGES):
        x, kernels, biases = _trio_case(c, t, 60 + i, batch=6)
        dout = torch.randn(x.shape, generator=torch.Generator().manual_seed(70 + i)).cuda()
        grads = []
        before = fused_resblock_trio.launches
        for fn in (fused_resblock_trio, fused_resblock_trio_plain):
            leaves = [a.clone().requires_grad_() for a in (x, *kernels, *biases)]
            (fn(leaves[0], leaves[1:19], leaves[19:]) * dout).sum().backward()
            grads.append([leaf.grad for leaf in leaves])
        torch.cuda.synchronize()
        if fused_resblock_trio.launches != before + 1:
            raise AssertionError("the trio under autograd did not launch K3 once")
        e_x = _max_err(grads[0][0], grads[1][0], BWD_TOL, "FusedTrio dx")
        e_w = max(_max_err(a, b, REL_GRAD_TOL, "FusedTrio dW") for a, b in zip(grads[0][1:], grads[1][1:]))
        log("parity", what="FusedTrio grads vs autograd(plain)", shape=f"B=6,T={t},C={c}",
            dx_err=f"{e_x:.3e}", dweights_err=f"{e_w:.3e}", ok=True)


def parity_training_attention() -> dict:
    """K1 with dropout and LSE, K2, and FusedAttention's gradients, at the
    training shapes, against the plain versions on the same inputs."""
    from sovits_tpu_torch.ops.attention import (
        _forward, _scores, fused_attention, fused_attention_bwd, fused_attention_bwd_plain,
        fused_attention_plain,
    )

    log("parity", bwd_tol=BWD_TOL, rel_grad_tol=REL_GRAD_TOL)
    errs = {"rel_attention": 0.0, "rel_attention_bwd": 0.0}
    for i, causal in enumerate((False, True)):
        args, dout, w = _train_attn_case(causal, 20 + i)
        shape = f"BH={TRAIN_BH},T={TRAIN_T},D={HEAD_D}"
        out, lse = _forward(*args, w, causal, want_lse=True)
        torch.cuda.synchronize()
        e_out = _max_err(out, fused_attention_plain(*args, window=w, causal=causal), ATTN_TOL, "K1+dropout")
        q, k, _, rk, _, km, _ = args
        e_lse = _max_err(lse, torch.logsumexp(_scores(q, k, rk, km, w, causal), -1), ATTN_TOL, "K1 lse")
        got = fused_attention_bwd(*args, out, lse, dout, window=w, causal=causal)
        torch.cuda.synchronize()
        want = fused_attention_bwd_plain(*args, dout, window=w, causal=causal)
        e_bwd = [_max_err(a, b, BWD_TOL, f"K2 {n}") for n, a, b in zip(("dq", "dk", "dv"), got, want)]
        row0 = (got[0][:, 0] - want[0][:, 0]).abs().max().item()  # causal: one key, ds = 0
        if w is not None:
            e_bwd += [_max_err(a, b, REL_GRAD_TOL, f"K2 {n}")
                      for n, a, b in zip(("drel_k", "drel_v"), got[3:], want[3:])]
        # gradients of FusedAttention (K1 then K2) against autograd through the plain forward
        grads = []
        for fn in (fused_attention, fused_attention_plain):
            leaves = [x.clone().requires_grad_() if x is not None else None for x in args[:5]]
            (fn(*leaves, *args[5:], window=w, causal=causal) * dout).sum().backward()
            grads.append([x.grad for x in leaves if x is not None])
        torch.cuda.synchronize()
        e_auto = [_max_err(a, b, REL_GRAD_TOL, "FusedAttention grad") for a, b in zip(*grads)]
        log("parity", kernel="rel_attention+dropout+lse", shape=shape, window=w, causal=causal,
            key_mask=km is not None, max_abs_err=f"{e_out:.3e}", lse_err=f"{e_lse:.3e}", ok=True)
        log("parity", kernel="rel_attention_bwd", shape=shape, window=w, causal=causal, dropout=0.1,
            key_mask=km is not None, max_abs_err=f"{max(e_bwd):.3e}",
            per_output=[f"{e:.2e}" for e in e_bwd], row0_dq_err=f"{row0:.3e}" if causal else "n/a", ok=True)
        log("parity", what="FusedAttention grads vs autograd(plain)", shape=shape, causal=causal,
            max_abs_err=f"{max(e_auto):.3e}", ok=True)
        errs["rel_attention"] = max(errs["rel_attention"], e_out)
        errs["rel_attention_bwd"] = max(errs["rel_attention_bwd"], *e_bwd)
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


# profiler windows _device_ms_each takes before it fails for a window without
# kernel records: late in the smoke CUPTI once lost every record of two windows
# in a row, and part of many (PERF.md §7)
PROFILER_TRIES = 4
# a kernel launch's attributes in torch.profiler's trace, as the [times] lines name them
LAUNCH_ARGS = {"grid": "grid", "block": "block", "shared memory": "smem_bytes",
               "registers per thread": "registers", "blocks per SM": "blocks_per_sm"}


def _device_ms_each(fn, keys: tuple[str, ...], iters: int = 20) -> dict[str, tuple[float, dict]]:
    """Device time per call of fn, from one torch.profiler window over `iters`
    calls after a warm-up, of the kernels whose name holds each key, and the
    launch attributes (grid, block, shared memory, ...) the profiler recorded
    for the first such kernel, with the kernel records it saw against the
    calls (`device_records`). CUDA events around a kernel of a few tens of
    microseconds time the wrapper's host work as well: this is the card's own
    time, printed beside the events' and used nowhere else. After many
    windows in one process CUPTI loses kernel records on an H100: whole
    windows (such a window is taken again, PROFILER_TRIES windows in all,
    before this fails) or part of one (K4's window late in the smoke kept
    14 of 20 launches, PERF.md). So the
    time is the mean of the records seen times the launches per call, the
    records over the calls rounded up: exact for a key of one kernel
    launched once a call (every kernel key here); for "" (all of a call's
    kernels) a lost record can still lower it."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = {key: [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key] for key in keys}
        us = {key: sum(e.self_device_time_total for e in evs) for key, evs in seen.items()}
        if all(v > 0 for v in us.values()):
            break
    missing = [key for key, v in us.items() if v <= 0]
    if missing:
        raise AssertionError(f"the profiler saw no device time for {missing}")
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
        events = json.loads((Path(tmp) / "trace.json").read_text()).get("traceEvents", [])
    out = {}
    for key in keys:
        args = next((e.get("args", {}) for e in events if e.get("cat") == "kernel" and key in e.get("name", "")), {})
        launch = {ours: str(args[theirs]).replace(" ", "") for theirs, ours in LAUNCH_ARGS.items() if theirs in args}
        records = sum(e.count for e in seen[key])
        launch["device_records"] = f"{records}/{iters}"
        out[key] = (us[key] / records * -(-records // iters) / 1e3, launch)
    return out


def _device_ms(fn, key: str = "", iters: int = 20) -> tuple[float, dict]:
    """_device_ms_each for one key ("": every kernel fn launches)."""
    return _device_ms_each(fn, (key,), iters)[key]


def phase_times() -> dict:
    from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_plain

    times = {"rel_attention": [0.0, 0.0], "resblock_trio": [0.0, 0.0]}
    times.update(times_training_attention())
    times.update(times_bf16())
    times.update(times_bf16_backward())
    times_trio_vjp()
    for i, (t, causal, masked) in enumerate(ATTN_CASES):
        (q, k, v, rk, rv, km), w = _attn_case(t, causal, masked, i)
        kw = dict(window=w, causal=causal)
        for dtype in (torch.float32, torch.bfloat16):
            args = [x.to(dtype) if x is not None else None for x in (q, k, v, rk, rv)] + [km]
            call = lambda: fused_attention(*args, **kw)  # noqa: E731
            ms_k = _time(call)
            ms_d, launch = _device_ms(call, "rel_attn_fwd")
            ms_p = _time(lambda: fused_attention_plain(*args, **kw))
            log("times", kernel="rel_attention", dtype=str(dtype).split(".")[1], T=t, window=w,
                causal=causal, key_mask=masked, kernel_ms=f"{ms_k:.4f}", kernel_device_ms=f"{ms_d:.4f}",
                plain_ms=f"{ms_p:.4f}", **launch)
            if t == 1024 and not causal and dtype == torch.float32:  # the 10 s clip's bucket: the JSON line
                times["rel_attention"] = [ms_k, ms_p]
    times["resblock_trio"] = times_trio(torch.float32, 10)  # the JSON line: all four stages of a 10 s clip
    return times


def times_trio(dtype, seed: int) -> list[float]:
    """K3 at the four stages of a 10 s clip in one type: CUDA events (the JSON
    line's ms), the profiler's device time of the kernel and its launch
    (grid, shared memory, blocks per SM), and the plain version's events;
    per stage and summed. Returns [kernel ms, plain ms], summed."""
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain

    name = str(dtype).split(".")[1]
    total = [0.0, 0.0, 0.0]
    for i, (c, t) in enumerate(TRIO_STAGES):
        x, kernels, biases = _trio_case(c, t, seed + i)
        x, kernels, biases = x.to(dtype), [w.to(dtype) for w in kernels], [b.to(dtype) for b in biases]
        call = lambda: fused_resblock_trio(x, kernels, biases)  # noqa: E731
        ms_k = _time(call, iters=5)
        ms_d, launch = _device_ms(call, "trio_fp32" if dtype == torch.float32 else "trio_bf16", iters=5)
        ms_p = _time(lambda: fused_resblock_trio_plain(x, kernels, biases), iters=5)
        log("times", kernel="resblock_trio", dtype=name, C=c, T=t, kernel_ms=f"{ms_k:.4f}",
            kernel_device_ms=f"{ms_d:.4f}", plain_ms=f"{ms_p:.4f}", **launch)
        for j, v in enumerate((ms_k, ms_d, ms_p)):
            total[j] += v
    log("times", kernel="resblock_trio", dtype=name, stages="four, 10 s clip", kernel_ms=f"{total[0]:.4f}",
        kernel_device_ms=f"{total[1]:.4f}", plain_ms=f"{total[2]:.4f}")
    return [total[0], total[2]]


def times_training_attention() -> dict:
    """K1 (with dropout and LSE) and K2 at the training shapes, against the
    plain versions; for the causal shape also SDPA forward+backward, the
    library yardstick (no key mask, so -1e4 replacement and -inf agree)."""
    import torch.nn.functional as F

    from sovits_tpu_torch.ops.attention import (
        _forward, fused_attention_bwd, fused_attention_bwd_plain, fused_attention_plain,
    )

    out = {}
    for i, causal in enumerate((False, True)):
        args, dout, w = _train_attn_case(causal, 20 + i)
        o, lse = _forward(*args, w, causal, want_lse=True)
        kw = dict(window=w, causal=causal)
        fwd_k = _time(lambda: _forward(*args, w, causal, want_lse=True))
        fwd_p = _time(lambda: fused_attention_plain(*args, **kw))
        bwd = lambda: fused_attention_bwd(*args, o, lse, dout, **kw)  # noqa: E731
        bwd_k = _time(bwd)
        bwd_p = _time(lambda: fused_attention_bwd_plain(*args, dout, **kw))
        extra = _k2_passes(bwd)
        if causal:
            q, k, v = (x.view(6, 2, TRAIN_T, HEAD_D).detach().clone().requires_grad_() for x in args[:3])
            g = dout.view(6, 2, TRAIN_T, HEAD_D)

            def sdpa():
                F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=1.0).backward(g)

            with torch.no_grad():
                sdpa_fwd = _time(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=1.0))
            extra.update(sdpa_fwd_ms=f"{sdpa_fwd:.4f}", sdpa_fwd_bwd_ms=f"{_time(sdpa):.4f}",
                         kernels_fwd_bwd_ms=f"{fwd_k + bwd_k:.4f}")
        log("times", shape=f"BH={TRAIN_BH},T={TRAIN_T},D={HEAD_D}", window=w, causal=causal,
            dropout=0.1, fwd_kernel_ms=f"{fwd_k:.4f}", fwd_plain_ms=f"{fwd_p:.4f}",
            bwd_kernel_ms=f"{bwd_k:.4f}", bwd_plain_ms=f"{bwd_p:.4f}", **extra)
        if not causal:  # the JSON line: the ContentEncoder's backward
            out["rel_attention_bwd"] = [bwd_k, bwd_p]
    return out


def times_bf16() -> dict:
    """K1 at the causal training shape in fp32 and bf16, each beside SDPA in
    its type (the library yardstick: no key mask, so -1e4 replacement and
    -inf agree), and bf16 K3 over the four stages of a 10 s clip, against
    their plain versions (K1 at the serving buckets: phase_times)."""
    import torch.nn.functional as F

    from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_plain

    args, _, _ = _train_attn_case(True, 22)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dtype) for x in args[:3])
        qs, ks, vs = (x.view(6, 2, TRAIN_T, HEAD_D) for x in (q, k, v))
        call = lambda: fused_attention(q, k, v, causal=True)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=1.0)  # noqa: E731
        ms_k, (ms_d, launch) = _time(call), _device_ms(call, "rel_attn_fwd")
        ms_l, (ms_ld, _) = _time(sdpa), _device_ms(sdpa)
        ms_p = _time(lambda: fused_attention_plain(q, k, v, causal=True))
        name = str(dtype).split(".")[1]
        log("times", kernel="rel_attention", dtype=name, shape=f"BH={TRAIN_BH},T={TRAIN_T},D={HEAD_D}",
            causal=True, kernel_ms=f"{ms_k:.4f}", kernel_device_ms=f"{ms_d:.4f}", plain_ms=f"{ms_p:.4f}",
            **{f"sdpa_{name}_ms": f"{ms_l:.4f}", f"sdpa_{name}_device_ms": f"{ms_ld:.4f}"},
            tf32="off", **launch)
        if dtype == torch.bfloat16:  # the JSON line's bf16 row, beside SDPA in bf16
            out["rel_attention_bf16"] = [ms_k, ms_p, ms_l]
    out["resblock_trio_bf16"] = times_trio(torch.bfloat16, 50)
    return out


def _k2_passes(bwd) -> dict:
    """The [times] fields of K2's two passes under bwd: the profiler's device
    time of each and their sum, and each launch's grid, shared memory and
    blocks per SM. The keys match the tensor-core passes (bwd_q_tf32,
    bwd_kv_tf32, bwd_q_bf16, bwd_kv_bf16) and the earlier FMA ones
    (rel_attn_bwd_q, rel_attn_bwd_kv), so tools/time_attention_bwd.py times
    an older tree of the port by the same functions."""
    passes = _device_ms_each(bwd, ("bwd_q", "bwd_kv"))
    return {"bwd_kernel_device_ms": f"{sum(ms for ms, _ in passes.values()):.4f}",
            **{f"{name}_device_ms": f"{ms:.4f}" for name, (ms, _) in passes.items()},
            **{f"{name}_{k}": v for name, (_, attrs) in passes.items() for k, v in attrs.items()}}


def times_bf16_backward() -> dict:
    """bf16 K2 at bench.py's bf16 step shape (BH 12, T 512, window 4, key
    mask, dropout) against its plain version, the JSON line's row, with the
    device time and launch of each pass; then, as the fp32 row does at T
    800, causal bf16 K1+K2 against SDPA bf16 forward and backward (no key
    mask, no dropout: -1e4 replacement and -inf agree), by events and by
    device time (SDPA's gradients returned, not accumulated into .grad)."""
    import torch.nn.functional as F

    from sovits_tpu_torch.ops.attention import _forward, fused_attention_bwd, fused_attention_bwd_plain

    out = {}
    for i, causal in enumerate((False, True)):
        args, dout, w = _bf16_train_attn_case(causal, 80 + i)
        if causal:
            args = args[:5] + [None, None]
        o, lse = _forward(*args, w, causal, want_lse=True)
        kw = dict(window=w, causal=causal)
        fwd = lambda: _forward(*args, w, causal, want_lse=True)  # noqa: E731
        bwd = lambda: fused_attention_bwd(*args, o, lse, dout, **kw)  # noqa: E731
        fwd_k, bwd_k = _time(fwd), _time(bwd)
        bwd_p = _time(lambda: fused_attention_bwd_plain(*args, dout, **kw))
        extra = _k2_passes(bwd)
        if causal:
            q, k, v = (x.view(TRAIN_BH // 2, 2, BENCH_T, HEAD_D).detach().clone().requires_grad_()
                       for x in args[:3])
            g = dout.view(TRAIN_BH // 2, 2, BENCH_T, HEAD_D)

            def sdpa():
                y = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=1.0)
                torch.autograd.grad(y, (q, k, v), g)

            extra.update(sdpa_bf16_fwd_bwd_ms=f"{_time(sdpa):.4f}", kernels_fwd_bwd_ms=f"{fwd_k + bwd_k:.4f}",
                         sdpa_bf16_fwd_bwd_device_ms=f"{_device_ms(sdpa)[0]:.4f}",
                         kernels_fwd_bwd_device_ms=f"{_device_ms(lambda: (fwd(), bwd()))[0]:.4f}")
        else:  # the JSON line: the ContentEncoder's backward in bench.py's bf16 step
            out["rel_attention_bwd_bf16"] = [bwd_k, bwd_p]
        log("times", dtype="bf16", shape=f"BH={TRAIN_BH},T={BENCH_T},D={HEAD_D}", window=w, causal=causal,
            dropout=0.1 if not causal else 0.0, fwd_kernel_ms=f"{fwd_k:.4f}", bwd_kernel_ms=f"{bwd_k:.4f}",
            bwd_plain_ms=f"{bwd_p:.4f}", **extra)
    return out


def times_trio_vjp() -> None:
    """The fused trio under autograd (K3 forward + recomputed plain backward)
    against autograd through the plain version, forward and backward, at
    the training stages; the bound counts the forward's products three
    times (forward, input gradient, weight gradient) at the fp32 peak."""
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio, fused_resblock_trio_plain

    total = {"fused": 0.0, "plain": 0.0}
    flops = 0.0
    for i, (c, t) in enumerate(TRAIN_TRIO_STAGES):
        x, kernels, biases = _trio_case(c, t, 60 + i, batch=6)
        dout = torch.randn_like(x)
        leaves = [a.clone().requires_grad_() for a in (x, *kernels, *biases)]
        row = {}
        for name, fn in (("fused", fused_resblock_trio), ("plain", fused_resblock_trio_plain)):
            step = lambda fn=fn: torch.autograd.backward(  # noqa: E731
                fn(leaves[0], leaves[1:19], leaves[19:]), dout)
            row[name] = _time(step, iters=5)
            total[name] += row[name]
        flops += 3 * 2 * 6 * t * c * c * 6 * (3 + 7 + 11)
        log("times", what="FusedTrio fwd+bwd", shape=f"B=6,T={t},C={c}", fused_ms=f"{row['fused']:.4f}",
            plain_ms=f"{row['plain']:.4f}")
    log("times", what="FusedTrio fwd+bwd, four training stages", fused_ms=f"{total['fused']:.4f}",
        plain_ms=f"{total['plain']:.4f}", bound_ms=f"{1e3 * flops / FP32_FLOPS:.4f}", bound_by="operations")


def bounds() -> dict:
    """Least time of each kernel's work at the JSON line's shapes: the larger
    of its operations over the rate they run at (bf16 tensor cores 989
    TFLOP/s; K1, K2 and K3 fp32 run 3xTF32, 495/3 TFLOP/s; K4 fp32 three
    bf16 products per fp32 one, 989/3) and its bytes (each input read once,
    each output written once) over 3.35 TB/s. ms and what bounds it."""
    def bound(flops, nbytes, peak=FP32_FLOPS):
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
        return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    win = 9
    bh, t, d = 2, 1024, HEAD_D  # rel_attention: the 10 s clip's bucket, window 4, key mask
    k1_ops, k1_bytes = 4 * bh * t * t * d + 4 * bh * t * win * d, 4 * (4 * bh * t * d + 2 * win * d + bh * t)
    k1 = bound(k1_ops, k1_bytes, TF32_TC_FLOPS / 3)  # 3xTF32: three tf32 products per fp32 one
    log("bounds", kernel="rel_attention", at="3xTF32 (495/3 TFLOP/s)", bound_ms=f"{k1[0]:.4f}",
        fma_bound_ms=f"{bound(k1_ops, k1_bytes)[0]:.4f}")
    bh, t = TRAIN_BH, TRAIN_T  # rel_attention_bwd: the ContentEncoder's, dropout 0.1
    # 5 products of 2 T^2 D, 4 band ones; 3xTF32, as K1
    k2_ops = 10 * bh * t * t * d + 8 * bh * t * win * d
    k2_bytes = 4 * (8 * bh * t * d + 2 * bh * t + bh * t * t + 4 * win * d)
    k2 = bound(k2_ops, k2_bytes, TF32_TC_FLOPS / 3)
    log("bounds", kernel="rel_attention_bwd", at="3xTF32 (495/3 TFLOP/s)", bound_ms=f"{k2[0]:.4f}",
        fma_bound_ms=f"{bound(k2_ops, k2_bytes)[0]:.4f}")
    # rel_attention_bwd_bf16: bench.py's bf16 step, BH 12, T 512, window 4, key
    # mask, dropout; 5 products of 2 T^2 D (bf16 operands, fp32 sums) and 4 band
    # ones; bytes: q, k, v, dout in and dq, dk, dv out in bf16 (out is not read),
    # lse, key mask and the fp32 dropout mask in, the bf16 tables in and out
    tb = BENCH_T
    k2_bf16 = bound(10 * bh * tb * tb * d + 8 * bh * tb * win * d,
                    2 * 7 * bh * tb * d + 4 * (2 * bh * tb + bh * tb * tb) + 2 * 4 * win * d, BF16_TC_FLOPS)
    # rel_attention_bf16: causal at the training shape, no key mask: the
    # products of the lower triangle (diagonal included) are all it needs
    pairs = bh * t * (t + 1) / 2
    k1_bf16 = bound(4 * pairs * d, 2 * 4 * bh * t * d, BF16_TC_FLOPS)
    flops = nbytes = nbytes_bf16 = 0  # resblock_trio: four stages of a 10 s clip, 18 convs each
    for c, length in TRIO_STAGES:
        flops += 2 * length * c * c * 6 * (3 + 7 + 11)
        nbytes += 4 * (2 * length * c + 6 * (3 + 7 + 11) * c * c + 18 * c)
        nbytes_bf16 += 2 * (2 * length * c + 6 * (3 + 7 + 11) * c * c) + 4 * 18 * c
    from sovits_tpu_torch.tools.profile_trio_shift import PEAK_FLOPS as K4_PEAK
    from sovits_tpu_torch.tools.profile_trio_shift import flops as k4_flops

    q, d4 = 55104, 128  # trio_shift: the microbench's defaults
    rows = q // 1024 * 1024
    k4_bytes = 2 * ((q + 32) * d4 + 36 * d4 * d4 + rows * d4)
    return {"rel_attention": k1, "rel_attention_bwd": k2, "rel_attention_bwd_bf16": k2_bf16,
            "resblock_trio": bound(flops, nbytes, TF32_TC_FLOPS / 3),
            "rel_attention_bf16": k1_bf16, "resblock_trio_bf16": bound(flops, nbytes_bf16, BF16_TC_FLOPS),
            "trio_shift_bf16": bound(k4_flops(rows, d4), k4_bytes, K4_PEAK["bf16"]),
            "trio_shift_fp32": bound(k4_flops(rows, d4), k4_bytes, K4_PEAK["fp32"])}


def bench_signal(seconds: float, sr: int, seed: int = 0, base_hz: float = 170.0) -> np.ndarray:
    """bench.py's test signal: 170 Hz with vibrato, phase-integrated, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    inst_f = base_hz + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    wav = 0.25 * np.sin(2 * np.pi * np.cumsum(inst_f) / sr) + 0.02 * rng.standard_normal(len(t))
    return wav.astype(np.float32)


def build_svc(tmp: Path, device: str, encoder=None, dtype=torch.float32, hps=None, **options):
    """A full-width config (``hps``, the default when None), seeded random
    weights written as a so-vits-svc G_0.pth, loaded by the port's Svc like a
    trained model; in bf16 the synthesizer and the encoder (same weights)
    compute in bf16. ``options`` are Svc's (shallow diffusion, the enhancer)."""
    from sovits_tpu_torch import config as scfg
    from sovits_tpu_torch.encoders.factory import CONFIGS, SpeechEncoder
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Encoder
    from sovits_tpu_torch.infer.svc import Svc
    from sovits_tpu_torch.models import factory

    if not (tmp / "G_0.pth").exists():
        hps = hps or scfg.default_config()
        scfg.save_config(hps, tmp / "config.json")
        model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True),
                                     torch.Generator().manual_seed(0))
        torch.save({"model": model.state_dict(), "iteration": 0}, tmp / "G_0.pth")
    if encoder is None:
        net = factory.init_random_(Wav2Vec2Encoder(CONFIGS["vec768l12"], dtype=dtype),
                                   torch.Generator().manual_seed(1))
        encoder = SpeechEncoder("vec768l12", net, device)
    return Svc(str(tmp / "G_0.pth"), str(tmp / "config.json"), encoder=encoder, device=device,
               dtype=dtype, **options)


def _reset_counts() -> None:
    from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio

    fused_attention.launches = fused_attention_bwd.launches = fused_resblock_trio.launches = 0
    fused_attention.launches_bf16 = fused_attention_bwd.launches_bf16 = 0
    fused_resblock_trio.launches_bf16 = 0


def _counts() -> dict:
    """Launches since the last reset, per kernel and type."""
    from sovits_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio

    return {"rel_attention": fused_attention.launches - fused_attention.launches_bf16,
            "rel_attention_bf16": fused_attention.launches_bf16,
            "rel_attention_bwd": fused_attention_bwd.launches - fused_attention_bwd.launches_bf16,
            "rel_attention_bwd_bf16": fused_attention_bwd.launches_bf16,
            "resblock_trio": fused_resblock_trio.launches - fused_resblock_trio.launches_bf16,
            "resblock_trio_bf16": fused_resblock_trio.launches_bf16}


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
    _reset_counts()
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
        if name.startswith("10s") and not auto:
            ok = ok and fused_attention.launches - k1 == 6
        log("main", request=repr(name), seconds=seconds, frames=n_frames, wall_s=f"{wall:.4f}",
            rtf=f"{wall / seconds:.5f}", rel_attention=fused_attention.launches - k1,
            resblock_trio=fused_resblock_trio.launches - k3, peak=f"{np.abs(audio).max():.4f}", ok=ok)
        if not ok:
            raise AssertionError(f"request {name}: bad output")
        if name == "10s":
            rtf = wall / seconds
    launches = _counts()
    log("main", launches=launches, rtf_10s=f"{rtf:.5f}")
    if launches["rel_attention"] == 0 or launches["resblock_trio"] == 0:
        raise AssertionError(f"the inference path did not run its kernels: {launches}")
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
    from sovits_tpu_torch.dsp.stft import mel_spectrogram

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


def phase_main_bf16(tmp: Path, svc32) -> dict:
    """The JAX package's measured configuration: a bf16 Svc (synthesizer and
    encoder in bf16, the same weights) answering the main path's requests,
    each 10 s request through 6 bf16 K1 and 4 bf16 K3 launches; then the
    log-mel L1 of a bf16 request against the fp32 one, noise off."""
    svc = build_svc(tmp, "cuda", dtype=torch.bfloat16)
    sr, hop = svc.target_sample, svc.hop_size
    long_clip = bench_signal(SECONDS, sr)
    requests = [
        ("10s warm-up", long_clip, False),
        ("10s", long_clip, False),
        ("3s", bench_signal(3.0, sr, seed=1), False),
        ("20s (bucket 2048)", bench_signal(20.0, sr, seed=2), False),
        ("10s auto_predict_f0", long_clip, True),
    ]
    _reset_counts()
    for name, wav, auto in requests:
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, n_samples, n_frames = svc.infer(0, 0, wav, sr=sr, f0_predictor="dio", auto_predict_f0=auto)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seconds = len(wav) / sr
        got = {k: v - before[k] for k, v in _counts().items()}
        ok = (audio.dtype == np.float32 and n_samples == n_frames * hop == len(wav) // hop * hop
              and np.isfinite(audio).all() and float(np.abs(audio).max()) > 1e-4
              and got["rel_attention"] == got["resblock_trio"] == 0)
        if name.startswith("10s") and not auto:
            ok = ok and got["rel_attention_bf16"] == 6 and got["resblock_trio_bf16"] == 4
        log("main-bf16", request=repr(name), seconds=seconds, frames=n_frames, wall_s=f"{wall:.4f}",
            rtf=f"{wall / seconds:.5f}", rel_attention_bf16=got["rel_attention_bf16"],
            resblock_trio_bf16=got["resblock_trio_bf16"], peak=f"{np.abs(audio).max():.4f}", ok=ok)
        if not ok:
            raise AssertionError(f"bf16 request {name}: bad output or launches {got}")
    total = _counts()
    if total["rel_attention_bf16"] == 0 or total["resblock_trio_bf16"] == 0:
        raise AssertionError(f"the bf16 path did not run its kernels: {total}")
    log("breakdown", clip="10s", dtype="bf16", **stage_times(svc, long_clip))

    bf16_vs_fp32("main-bf16", svc32, svc)
    return total, svc


def bf16_vs_fp32(phase: str, svc32, svc16) -> None:
    """A 3 s request through the bf16 Svc against the fp32 one, noise off:
    loud-bin log-mel L1 < MEL_L1_BF16 and wave max-abs <= E2E_REL x peak."""
    from sovits_tpu_torch.dsp.stft import mel_spectrogram

    sr = svc32.target_sample
    clip = bench_signal(3.0, sr, seed=3)
    item32 = svc32._prepare_chunk(0, 0, clip, sr, 0.0, False, "dio", 0.05)
    item16 = svc16._prepare_chunk(0, 0, clip, sr, 0.0, False, "dio", 0.05)
    run = dict(noice_scale=0.0, auto_predict_f0=False, seed=52468, sample_noise=False)
    a32 = svc32._run_synth_batch([item32], **run)[0]
    a16 = svc16._run_synth_batch([item16], **run)[0]
    a16_same_units = svc16._run_synth_batch([item32], **run)[0]
    mel = lambda a: mel_spectrogram(torch.from_numpy(a)[None])  # noqa: E731
    m32, m16 = mel(a32), mel(a16)
    loud = m32 > m32.max() - LOUD_DB / 20 * np.log(10)  # log-mel is ln of a magnitude
    l1 = (m16 - m32).abs().mean().item()
    l1_loud = (m16 - m32).abs()[loud].mean().item()
    l1_rounding = (mel(torch.from_numpy(a32).bfloat16().float().numpy()) - m32).abs().mean().item()
    l1_synth = (mel(a16_same_units) - m32).abs().mean().item()
    units = np.abs(item16["c"] - item32["c"]).max() / np.abs(item32["c"]).max()
    rel = np.abs(a16 - a32).max() / np.abs(a32).max()
    ok = l1_loud < MEL_L1_BF16 and rel <= E2E_REL
    log(phase, what="bf16 vs fp32 request, 3 s clip, noise off", mel_l1_all_bins=f"{l1:.4e}",
        mel_l1_fp32_audio_rounded_to_bf16=f"{l1_rounding:.4e}",
        mel_l1_loud_bins=f"{l1_loud:.4e}", loud_share=f"{loud.float().mean().item():.3f}",
        synthesizer_only_mel_l1=f"{l1_synth:.4e}", units_rel_max_abs=f"{units:.3e}",
        wave_rel_max_abs=f"{rel:.3e}", limits=f"loud-bin L1<{MEL_L1_BF16}, wave<={E2E_REL}", ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: bf16 and fp32 requests disagree: loud-bin log-mel L1 "
                             f"{l1_loud}, wave {rel}")


SONG_SEGMENTS = (5.5, 8.0, 12.0, 6.0, 9.0, 14.0)  # seconds, 1 s of zeros between


def song(sr: int, segments=SONG_SEGMENTS, seed: int = 40) -> np.ndarray:
    """bench_signal segments separated by 1 s of zeros, each at its own pitch."""
    parts = []
    for i, seconds in enumerate(segments):
        if i:
            parts.append(np.zeros(sr, np.float32))
        parts.append(bench_signal(seconds, sr, seed=seed + i, base_hz=150.0 + 12.0 * i))
    return np.concatenate(parts)


def _dispatches(items: list, hop: int) -> list[tuple[int, int]]:
    """(bucket, padded batch) of each synthesizer launch that Svc's batched
    pass makes for ``items``, from their buckets as _run_synth_batch groups them."""
    from sovits_tpu_torch.infer.svc import BUCKETS

    groups: dict = {}
    for it in items:
        bucket = next((b for b in BUCKETS if b >= it["n_frames"]), it["n_frames"])
        groups.setdefault((bucket, it["spk"][0]), []).append(it)
    out = []
    for (bucket, _kind), its in sorted(groups.items()):
        for start in range(0, len(its), 8):
            n = len(its[start : start + 8])
            out.append((bucket, 1 << (n - 1).bit_length()))
    return out


def _synced(spent: dict, key: str, fn):
    """``fn``, adding the host seconds of each call, between synchronises,
    to ``spent[key]``."""
    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        return out
    return run


def _slice_run(svc, wav: np.ndarray, what: str, bf16: bool = False, per_dispatch=(6, 4),
               per_chunk_k3: int = 0, **kw) -> tuple[np.ndarray, list]:
    """One slice_inference call with its front-end and synthesizer time taken
    apart; checks the output and, per dispatch, ``per_dispatch`` K1 and K3
    launches of the Svc's type (bf16 or fp32), plus ``per_chunk_k3`` fp32 K3
    launches per chunk (a shallow-diffusion Svc's vocoder), and no others.
    Returns (audio, dispatches)."""
    sr, hop = svc.target_sample, svc.hop_size
    k1, k3 = ("rel_attention_bf16", "resblock_trio_bf16") if bf16 else ("rel_attention", "resblock_trio")
    spent = {"front_end_s": 0.0, "synthesizer_s": 0.0}
    batches: list = []
    synth = _synced(spent, "synthesizer_s", svc._run_synth_batch)
    svc._prepare_chunk = _synced(spent, "front_end_s", svc._prepare_chunk)
    svc._run_synth_batch = lambda items, *a, **k: batches.append(items) or synth(items, *a, **k)
    before = _counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = svc.slice_inference(wav, sr, kw.pop("spk", 0), 0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del svc._prepare_chunk, svc._run_synth_batch
    got = {k: v - before[k] for k, v in _counts().items()}
    (items,) = batches
    dispatches = _dispatches(items, hop)
    seconds = len(wav) / sr
    ok = (abs(len(audio) - len(wav)) <= hop * len(items) and audio.dtype == np.float32
          and np.isfinite(audio).all() and float(np.abs(audio).max()) > 1e-4
          and got[k1] == per_dispatch[0] * len(dispatches)
          and got[k3] == per_dispatch[1] * len(dispatches) + per_chunk_k3 * len(items)
          and sum(got.values()) == got[k1] + got[k3])
    log("slice", what=repr(what), seconds=f"{seconds:.2f}", chunks=len(items),
        frames=[it["n_frames"] for it in items], dispatches=dispatches, out_len=len(audio),
        in_len=len(wav), wall_s=f"{wall:.4f}", rtf=f"{wall / seconds:.5f}",
        front_end_s=f"{spent['front_end_s']:.4f}", synthesizer_s=f"{spent['synthesizer_s']:.4f}",
        other_s=f"{wall - spent['front_end_s'] - spent['synthesizer_s']:.4f}",
        **{k1: got[k1], k3: got[k3]}, peak=f"{np.abs(audio).max():.4f}", ok=ok)
    if not ok:
        raise AssertionError(f"slice_inference {what}: bad output or launches {got} "
                             f"for dispatches {dispatches}")
    return audio, dispatches


def phase_slice(tmp: Path, svc32, svc16) -> tuple[dict, dict]:
    """Svc.slice_inference at the full width: a 59.5 s song of six pieces in
    fp32 and in bf16 (slicer, per-chunk front end, one batched synthesizer
    pass), forced clips with both crossfades, the loudness envelope, a
    speaker mix, harvest and yin, RealTimeVC, one batched dispatch on the
    card against the CPU, and the infer CLI on the card. Returns the K1/K3
    launches of the fp32 runs and of the bf16 song."""
    from sovits_tpu_torch.infer.spkmix import EXAMPLE_SPK_MIX_MAP
    from sovits_tpu_torch.infer.svc import RealTimeVC

    t_phase = time.perf_counter()
    sr = svc32.target_sample
    wav = song(sr)
    _reset_counts()
    _slice_run(svc32, wav, "song fp32 (first run)", f0_predictor="dio")
    _, dispatches = _slice_run(svc32, wav, "song fp32", f0_predictor="dio")
    if max(b for _, b in dispatches) < 2:
        raise AssertionError(f"no dispatch ran a batch: {dispatches}")
    piece = bench_signal(SONG_SEGMENTS[-1], sr, seed=40 + len(SONG_SEGMENTS) - 1)
    _slice_run(svc32, piece, "14 s, forced clips lgr 0.75", f0_predictor="dio", clip_seconds=5,
               lg_num=1, lgr_num=0.75)
    _slice_run(svc32, piece, "14 s, forced clips lgr 1", f0_predictor="dio", clip_seconds=5,
               lg_num=1, lgr_num=1)
    two = song(sr, (5.5, 5.5))
    _slice_run(svc32, two, "12 s, loudness 0.5", f0_predictor="dio", loudness_envelope_adjustment=0.5)
    _slice_run(svc32, two, "12 s, speaker mix", f0_predictor="dio", use_spk_mix=True,
               spk=EXAMPLE_SPK_MIX_MAP)
    clip = bench_signal(6.0, sr, seed=50)
    for name in ("harvest", "yin"):
        _slice_run(svc32, clip, f"6 s, {name}", f0_predictor=name)
        t0 = time.perf_counter()
        f0, uv = svc32.f0_predictor_object.compute_f0_uv(clip)
        host = time.perf_counter() - t0
        log("slice", f0_predictor=name, clip_s=6.0, host_s=f"{host:.4f}",
            voiced=f"{uv.mean():.3f}", median_f0=f"{np.median(f0[uv > 0]):.2f}")
    rt, stream = RealTimeVC(), bench_signal(3.0, 16000, seed=51)
    for i in range(3):  # a 16 kHz stream, one second a chunk
        out = rt.process(svc32, 0, 0, stream[i * 16000 : (i + 1) * 16000], 16000, f0_predictor="dio")
        ok = out.shape == (rt.chunk_len,) and np.isfinite(out).all()
        log("slice", realtime_chunk=i, out_len=len(out), ok=ok)
        if not ok:
            raise AssertionError(f"RealTimeVC chunk {i}: {out.shape}")
    phase_cli(tmp, sr, svc32.hop_size)
    slice32 = _counts()
    _reset_counts()
    _slice_run(svc16, wav, "song bf16 (first run)", bf16=True, f0_predictor="dio")
    _slice_run(svc16, wav, "song bf16", bf16=True, f0_predictor="dio")
    slice16 = _counts()
    phase_card_vs_cpu_batch(tmp, svc32, wav)
    log("slice", phase_s=f"{time.perf_counter() - t_phase:.1f}", launches=slice32, launches_bf16=slice16)
    return slice32, slice16


# [configs]: so-vits-svc 4.1's model options at full width (default widths
# unless the template sets them): template, overrides, the K1 and K3
# launches of one 10 s request, and whether the model runs in bf16 too
CONFIG_CASES = {
    "vol_tflow": ("default_config", {"vol_embedding": True, "use_transformer_flow": True,
                                     "n_flow_layer": 4, "n_layers_trans_flow": 3}, 18, 4, True),
    "tiny": ("tiny_config", {}, 6, 0, False),
    "resblock2": ("default_config", {"resblock": "2"}, 6, 0, False),
    "snake": ("default_config", {"vocoder_name": "nsf-snake-hifigan"}, 6, 0, True),
}
# the latent after the reversed flow, card against CPU (fp32, TF32 off):
# max-abs <= Z_REL x peak; the audio alone would hardly see the encoder and
# the flow, since random N(0, 0.01) upsamplers shrink the latent's share of it
Z_REL = 1e-3


def config_hps(name: str):
    from sovits_tpu_torch import config as scfg

    template, overrides, *_ = CONFIG_CASES[name]
    return getattr(scfg, template)(**{f"model.{k}": v for k, v in overrides.items()})


def _latent(svc, item) -> torch.Tensor:
    """Synthesizer.infer_pre's latent for one prepared chunk, noise off."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(svc.device)  # noqa: E731
    z, _, _ = svc.model.infer_pre(t(item["c"]), t(item["f0"]), t(item["uv"]),
                                  torch.zeros(1, dtype=torch.long, device=svc.device),
                                  noise_scale=0.0, sample_noise=False,
                                  vol=None if item["vol"] is None else t(item["vol"]))
    return z.float().cpu()


def phase_configs(tmp: Path, svc32, svc16) -> tuple[dict, dict]:
    """Each CONFIG_CASES model written as a seeded G_0.pth and config.json and
    loaded by Svc on the card like a trained model: a warm-up and a 10 s
    request, each with the table's K1 and K3 launches and no others; a 3 s
    request on the card against the same model on the CPU (log-mel L1 < 1e-3
    and the latent within Z_REL, fp32, noise off), and the 10 s request's
    latent too; in bf16 where the table says so, the same requests in bf16
    held against fp32 by the bf16 bars.
    The vol_tflow model also converts a song through slice_inference, and
    the Snake model's synthesizer pass is profiled. Returns the K1/K3
    launches of the fp32 and the bf16 requests."""
    from sovits_tpu_torch.dsp.stft import mel_spectrogram

    t_phase = time.perf_counter()
    sr, hop = svc32.target_sample, svc32.hop_size
    long_clip = bench_signal(SECONDS, sr)
    totals = {torch.float32: dict.fromkeys(_counts(), 0), torch.bfloat16: dict.fromkeys(_counts(), 0)}
    for name, (_template, _overrides, k1, k3, with_bf16) in CONFIG_CASES.items():
        work = tmp / "configs" / name
        work.mkdir(parents=True)
        hps = config_hps(name)
        svcs = {torch.float32: build_svc(work, "cuda", encoder=svc32.encoder, hps=hps)}
        if with_bf16:
            svcs[torch.bfloat16] = build_svc(work, "cuda", encoder=svc16.encoder, dtype=torch.bfloat16)
        for dtype, svc in svcs.items():
            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            want = {f"rel_attention{suffix}": k1, f"resblock_trio{suffix}": k3}
            _reset_counts()
            for request in ("10s warm-up", "10s"):
                before = _counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                audio, n_samples, n_frames = svc.infer(0, 0, long_clip, sr=sr, f0_predictor="dio")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {k: v - before[k] for k, v in _counts().items()}
                ok = (n_samples == n_frames * hop == len(long_clip) // hop * hop
                      and np.isfinite(audio).all() and float(np.abs(audio).max()) > 1e-4
                      and all(got[k] == want.get(k, 0) for k in got))
                log("configs", config=name, dtype=str(dtype).split(".")[1], request=repr(request),
                    frames=n_frames, wall_s=f"{wall:.4f}", rtf=f"{wall / SECONDS:.5f}",
                    **{k: got[k] for k in want}, peak=f"{np.abs(audio).max():.4f}", ok=ok)
                if not ok:
                    raise AssertionError(f"[configs] {name} {request}: bad output or launches {got}, "
                                         f"want {want}")
            if name == "vol_tflow" and dtype == torch.float32:
                _slice_run(svc, song(sr, (5.5, 5.5)), "12 s, vol_tflow", f0_predictor="dio",
                           per_dispatch=(k1, k3))
            for k, v in _counts().items():
                totals[dtype][k] += v
        svc = svcs[torch.float32]
        cpu_svc = build_svc(work, "cpu", encoder=svc.encoder)
        item = svc._prepare_chunk(0, 0, bench_signal(3.0, sr, seed=3), sr, 0.0, False, "dio", 0.05)
        card = svc._run_synth_batch([item], 0.0, False, 52468, sample_noise=False)[0]
        host = cpu_svc._run_synth_batch([item], 0.0, False, 52468, sample_noise=False)[0]
        mels = [mel_spectrogram(torch.from_numpy(a)[None]) for a in (card, host)]
        l1 = (mels[0] - mels[1]).abs().mean().item()
        # the latent also at the 10 s request's own length: the shapes the
        # path gives K1 (the transformer flow's causal layers at BH 2, T 861)
        item10 = svc._prepare_chunk(0, 0, long_clip, sr, 0.0, False, "dio", 0.05)
        z_rel = {}
        for clip, it in (("3s", item), ("10s", item10)):
            z_card, z_host = _latent(svc, it), _latent(cpu_svc, it)
            z_rel[clip] = ((z_card - z_host).abs().max() / z_host.abs().max()).item()
        ok = l1 < 1e-3 and max(z_rel.values()) <= Z_REL
        log("configs", config=name, what="card vs CPU, fp32, noise off: audio of a 3 s clip, "
            "latent of it and of the 10 s request", frames_10s=item10["n_frames"],
            max_abs=f"{np.abs(card - host).max():.3e}", mel_l1=f"{l1:.3e}",
            z_rel_max_abs={k: f"{v:.3e}" for k, v in z_rel.items()},
            limits=f"mel L1<1e-3, latent<={Z_REL}", ok=ok)
        if not ok:
            raise AssertionError(f"[configs] {name}: card and CPU disagree: log-mel L1 {l1}, latent {z_rel}")
        del cpu_svc
        if with_bf16:
            bf16_vs_fp32(f"configs:{name}", svc, svcs[torch.bfloat16])
        if name == "snake":
            wall, busy_ms, dev = _profiled(lambda: svc._run_synth_batch([item10], 0.4, False, 52468))
            top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
            log("configs", config=name, what="profiled synthesizer pass, 10 s, fp32",
                wall_s=f"{wall:.4f}", device_busy_ms=f"{busy_ms:.2f}",
                top_kernels_us={k[:60]: round(v, 1) for k, v in top})
        del svcs, svc
        torch.cuda.empty_cache()
    log("configs", phase_s=f"{time.perf_counter() - t_phase:.1f}", launches=totals[torch.float32],
        launches_bf16=totals[torch.bfloat16])
    return totals[torch.float32], totals[torch.bfloat16]


# [diffusion]: the sampler names of the diffusion config's ``infer.method``
# (None: the ancestral chain, one denoiser call per step)
DIFFUSION_METHODS = (None, "ddim", "pndm", "dpm-solver", "dpm-solver++", "dpm-solver++-1s",
                     "dpm-solver++-2s", "dpm-solver++-3s", "unipc", "unipc-bh1", "unipc-bh2",
                     "unipc-vary", "dpm-solver++-adaptive", "dpm-solver++-adaptive-3")
K_STEP = 100  # shallow diffusion's depth, the infer CLI's -ks default


def write_diffusion_files(root: Path) -> dict:
    """so-vits-svc's published diffusion template (DIFFUSION_DEFAULTS: 20
    layers, 512 channels, 256 hidden, 1000 steps, vec768l12 units) and the
    44.1 kHz NSF-HiFiGAN of DEFAULT_NSF_CONFIG, with seeded random weights,
    written in so-vits-svc's formats: model_0.pt ({"model": sd}), its
    config.yaml (as JSON text, which is valid YAML), the vocoder's
    {"generator": sd} with its config.json."""
    from sovits_tpu_torch.models import factory
    from sovits_tpu_torch.models.diffusion.vocoder import DEFAULT_NSF_CONFIG, build_generator
    from sovits_tpu_torch.train.diffusion import (DIFFUSION_DEFAULTS, build_unit2mel,
                                                  load_diffusion_config)

    (root / "nsf_hifigan").mkdir(parents=True)
    vocoder = root / "nsf_hifigan" / "model"
    net = factory.init_random_(build_generator(DEFAULT_NSF_CONFIG, "cpu"), torch.Generator().manual_seed(5))
    torch.save({"generator": net.state_dict()}, vocoder)
    (root / "nsf_hifigan" / "config.json").write_text(json.dumps(DEFAULT_NSF_CONFIG))
    (root / "config.yaml").write_text(json.dumps(
        {**DIFFUSION_DEFAULTS, "vocoder": {"type": "nsf-hifigan", "ckpt": str(vocoder)}}))
    args = load_diffusion_config(root / "config.yaml")
    model = factory.init_random_(build_unit2mel(args, DEFAULT_NSF_CONFIG["num_mels"], "cpu"),
                                 torch.Generator().manual_seed(6))
    torch.save({"model": model.state_dict()}, root / "model_0.pt")
    n_params = sum(p.numel() for p in model.parameters())
    log("diffusion", unit2mel_params=n_params, layers=args.model.n_layers, chans=args.model.n_chans,
        hidden=args.model.n_hidden, timesteps=args.model.timesteps, mels=DEFAULT_NSF_CONFIG["num_mels"],
        vocoder_params=sum(p.numel() for p in net.parameters()))
    return dict(diffusion_model_path=str(root / "model_0.pt"),
                diffusion_config_path=str(root / "config.yaml"))


def _timed_stages(svc) -> dict:
    """Wrap the Svc's stages with synchronised host timers: VITS (the
    synthesizer), mel extraction, Unit2Mel sampling, vocoding. Returns the
    dict the wrappers add their seconds to; ``_untime`` takes them off."""
    spent = dict.fromkeys(("vits_s", "mel_s", "sampling_s", "vocoder_s"), 0.0)
    svc._run_synth_batch = _synced(spent, "vits_s", svc._run_synth_batch)
    vocoder = (svc.diffusion or svc.enhancer).vocoder
    vocoder.extract = _synced(spent, "mel_s", vocoder.extract)
    vocoder.infer = _synced(spent, "vocoder_s", vocoder.infer)
    if svc.diffusion is not None:
        svc.diffusion.model.forward = _synced(spent, "sampling_s", svc.diffusion.model.forward)
    return spent


def _untime(svc) -> None:
    del svc._run_synth_batch
    vocoder = (svc.diffusion or svc.enhancer).vocoder
    del vocoder.extract, vocoder.infer
    if svc.diffusion is not None:
        del svc.diffusion.model.forward


def _diffusion_request(svc, wav: np.ndarray, what: str, want: dict, **kw) -> np.ndarray:
    """One Svc.infer with its stages timed apart; checks the output and that
    the K1/K3 launches are ``want``'s (every other count 0)."""
    sr, hop = svc.target_sample, svc.hop_size
    spent = _timed_stages(svc)
    calls = []  # denoiser calls: the adaptive samplers' step count shows in them
    hook = (svc.diffusion.model.decoder["denoise_fn"].register_forward_hook(lambda *a: calls.append(1))
            if svc.diffusion is not None else None)
    before = _counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio, n_samples, n_frames = svc.infer(0, 0, wav, sr=sr, f0_predictor="dio", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        _untime(svc)
        if hook is not None:
            hook.remove()
    got = {k: v - before[k] for k, v in _counts().items()}
    seconds = len(wav) / sr
    # the enhancer resamples to its adaptive rate and back: within two hops
    ok = (abs(n_samples - n_frames * hop) <= 2 * hop and n_frames == len(wav) // hop
          and np.isfinite(audio).all() and float(np.abs(audio).max()) > 1e-4
          and all(got[k] == want.get(k, 0) for k in got))
    log("diffusion", request=repr(what), seconds=seconds, frames=n_frames, wall_s=f"{wall:.4f}",
        rtf=f"{wall / seconds:.5f}", **{k: f"{v:.4f}" for k, v in spent.items()},
        other_s=f"{wall - sum(spent.values()):.4f}", denoiser_calls=len(calls),
        **{k: v for k, v in got.items() if v},
        peak=f"{np.abs(audio).max():.4f}", ok=ok)
    if not ok:
        raise AssertionError(f"[diffusion] {what}: bad output or launches {got}, want {want}")
    return audio


def phase_diffusion(tmp: Path, svc32, svc16) -> tuple[dict, dict]:
    """Shallow diffusion at full width through Svc and slice_inference: the
    published diffusion template and 44.1 kHz vocoder as seeded checkpoints;
    10 s requests after a warm-up with shallow diffusion (fp32, and on the
    bf16 Svc with the refiner in fp32), only_diffusion, the enhancer at
    adaptive key 2, each sampler once at speedup 10, the 59.5 s song, and
    the infer CLI with -shd; each request's stages timed apart and its
    K1/K3 launches checked; the denoiser's device-busy time; shallow
    diffusion and only_diffusion on the card against the CPU (log-mel
    L1 < 1e-3, fp32, synthesizer noise off). Returns the K1/K3 launches of
    the fp32 and of the bf16 Svc's requests."""
    from sovits_tpu_torch.dsp.stft import mel_spectrogram

    t_phase = time.perf_counter()
    files = write_diffusion_files(tmp / "diffusion")
    shallow = dict(shallow_diffusion=True, **files)
    sr = svc32.target_sample
    long_clip = bench_signal(SECONDS, sr)
    _reset_counts()
    svc = build_svc(tmp, "cuda", encoder=svc32.encoder, **shallow)
    _diffusion_request(svc, long_clip, "10s shallow warm-up", {"rel_attention": 6, "resblock_trio": 8})
    _diffusion_request(svc, long_clip, "10s shallow", {"rel_attention": 6, "resblock_trio": 8})
    model = svc.diffusion.model
    captured = {}
    forward = model.forward
    model.forward = lambda *a, **k: captured.update(a=a, k=k) or forward(*a, **k)
    svc.infer(0, 0, long_clip, sr=sr, f0_predictor="dio")
    del model.forward
    wall, busy_ms, dev = _profiled(lambda: model(*captured["a"], **captured["k"]))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    t_frames = captured["k"]["gt_spec"].shape[1]
    gflop = 10 * 20 * 2 * t_frames * 1024 * (512 * 3 + 256 + 512) / 1e9  # 10 calls, 20 blocks
    log("diffusion", what=f"Unit2Mel sampling alone, profiled: {K_STEP} steps at speedup 10, dpm-solver++",
        frames=t_frames, wall_s=f"{wall:.4f}", device_busy_ms=f"{busy_ms:.2f}",
        conv_gflop=f"{gflop:.1f}", fp32_bound_ms=f"{gflop * 1e12 / FP32_FLOPS:.2f}")
    for key, us in top:
        print(f"    device {us / 1e3:9.3f} ms  {key[:110]}", flush=True)
    for method in DIFFUSION_METHODS:
        svc.diffusion.args.infer.method = method
        _diffusion_request(svc, long_clip, f"10s shallow, {method or 'ddpm'}",
                           {"rel_attention": 6, "resblock_trio": 8})
    svc.diffusion.args.infer.method = "dpm-solver++"
    only = build_svc(tmp, "cuda", encoder=svc32.encoder, only_diffusion=True, **files)
    for what in ("10s only_diffusion warm-up", "10s only_diffusion"):
        _diffusion_request(only, long_clip, what, {"resblock_trio": 4})
    enh = build_svc(tmp, "cuda", encoder=svc32.encoder, nsf_hifigan_enhance=True,
                    enhancer_ckpt=str(tmp / "diffusion" / "nsf_hifigan" / "model"))
    for what in ("10s enhancer warm-up", "10s enhancer, adaptive key 2"):
        _diffusion_request(enh, long_clip, what, {"rel_attention": 6, "resblock_trio": 8},
                           enhancer_adaptive_key=2)
    wav = song(sr)
    _slice_run(svc, wav, "song fp32, shallow diffusion", f0_predictor="dio", per_chunk_k3=4)
    phase_cli_diffusion(tmp, files)
    counts32 = _counts()

    _reset_counts()
    svc_bf16 = build_svc(tmp, "cuda", encoder=svc16.encoder, dtype=torch.bfloat16, **shallow)
    bf16_want = {"rel_attention_bf16": 6, "resblock_trio_bf16": 4, "resblock_trio": 4}
    _diffusion_request(svc_bf16, long_clip, "10s shallow bf16 warm-up", bf16_want)
    _diffusion_request(svc_bf16, long_clip, "10s shallow bf16 (refiner fp32)", bf16_want)
    counts16 = _counts()

    clip = bench_signal(3.0, sr, seed=3)
    cpu = {"shallow": build_svc(tmp, "cpu", encoder=svc32.encoder, **shallow),
           "only_diffusion": build_svc(tmp, "cpu", encoder=svc32.encoder, only_diffusion=True, **files)}
    for name, card_svc in (("shallow", svc), ("only_diffusion", only)):
        item = card_svc._prepare_chunk(0, 0, clip, sr, 0.0, False, "dio", 0.05)
        outs = []
        for s in (card_svc, cpu[name]):
            if name == "shallow":
                audio = s._run_synth_batch([item], 0.0, False, 52468, sample_noise=False)[0]
                outs.append(s._post_chunk(item, audio, K_STEP, False, 1.0, 0))
            else:
                outs.append(s.infer_only_diffusion(item, K_STEP, False, 1.0))
        mels = [mel_spectrogram(torch.from_numpy(np.asarray(a, np.float32))[None]) for a in outs]
        l1 = (mels[0] - mels[1]).abs().mean().item()
        log("diffusion", what=f"card vs CPU, {name}, 3 s clip, fp32, synthesizer noise off",
            max_abs=f"{np.abs(outs[0] - outs[1]).max():.3e}", peak=f"{np.abs(outs[1]).max():.4f}",
            mel_l1=f"{l1:.3e}", limit=1e-3, ok=l1 < 1e-3)
        if not l1 < 1e-3:
            raise AssertionError(f"[diffusion] {name}: card and CPU disagree: log-mel L1 {l1}")
    log("diffusion", phase_s=f"{time.perf_counter() - t_phase:.1f}", launches=counts32,
        launches_bf16=counts16)
    del svc, only, enh, svc_bf16, cpu
    torch.cuda.empty_cache()
    return counts32, counts16


# [frontend]: the f0 nets at their published widths (seeded weights in the
# published key names) and the wav2vec2-family encoders other than
# vec768l12, each in its checkpoint layout
F0_NETS = ("rmvpe", "fcpe", "crepe")
NEW_ENCODERS = ("vec256l9", "hubertsoft", "cnhubertlarge")
SALIENCE_ATOL = 1e-4  # card against CPU, fp32 with TF32 off: the CPU tests' bar against JAX
UNITS_REL = 1e-4  # the units' max-abs error over max|units|, card against CPU
FRONTEND_LIMIT_S = 420  # the phase's hard time limit (SIGALRM)


def f0_net_weights(kind: str, seed: int = 7) -> dict:
    """A seeded state_dict (CPU tensors, the published checkpoint's key
    names) of ``kind`` at its published width."""
    from sovits_tpu_torch.f0.crepe import CrepeNet
    from sovits_tpu_torch.f0.fcpe import FcpeNet
    from sovits_tpu_torch.f0.rmvpe import RmvpeNet
    from sovits_tpu_torch.models import factory

    net = {"rmvpe": RmvpeNet, "fcpe": FcpeNet, "crepe": CrepeNet}[kind]()
    return factory.init_random_(net, torch.Generator().manual_seed(seed)).state_dict()


def to_bshall_hubert(sd: dict) -> dict:
    """A fairseq-named HuBERT state_dict (the port's encoder) under bshall's
    HuBERT-soft names (hubert_model.py, as the hubertsoft checkpoint holds
    them): the inverse of the port's ``encoders.convert.from_bshall_hubert``."""
    top = {"layer_norm": "feature_projection.norm", "post_extract_proj": "feature_projection.projection",
           "encoder.pos_conv.0": "positional_embedding.conv", "encoder.layer_norm": "norm",
           "final_proj": "proj", "feature_extractor.conv_layers.0.2": "feature_extractor.norm0"}
    layer = {"fc1": "linear1", "fc2": "linear2", "self_attn_layer_norm": "norm1",
             "final_layer_norm": "norm2", "self_attn.out_proj": "self_attn.out_proj"}
    out = {}
    for key, value in sd.items():
        stem, leaf = key.rsplit(".", 1)
        parts = stem.split(".")
        if stem in top:
            out[f"{top[stem]}.{leaf}"] = value
        elif stem.startswith("feature_extractor.conv_layers."):
            out[f"feature_extractor.conv{parts[2]}.{leaf}"] = value
        elif stem.startswith("encoder.layers."):
            pre, rest = ".".join(parts[:3]), ".".join(parts[3:])
            if rest in layer:
                out[f"{pre}.{layer[rest]}.{leaf}"] = value
            elif rest == "self_attn.q_proj":
                qkv = [sd[f"{pre}.self_attn.{p}_proj.{leaf}"] for p in "qkv"]
                out[f"{pre}.self_attn.in_proj_{leaf}"] = (torch.cat(qkv) if torch.is_tensor(qkv[0])
                                                          else np.concatenate(qkv))
    return out


def write_encoder_checkpoint(name: str, path: Path, seed: int = 11, cfg=None) -> None:
    """A seeded ``name`` encoder (``cfg``, its configuration by default)
    saved in its checkpoint's layout: fairseq's {"model": state_dict}, or
    bshall's flat state_dict with the ``module.`` prefix for hubertsoft."""
    from sovits_tpu_torch.encoders.factory import BSHALL, CONFIGS
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Encoder
    from sovits_tpu_torch.models import factory

    net = factory.init_random_(Wav2Vec2Encoder(cfg or CONFIGS[name]), torch.Generator().manual_seed(seed))
    sd = net.state_dict()
    path.parent.mkdir(parents=True, exist_ok=True)
    if name in BSHALL:
        torch.save({f"module.{k}": v for k, v in to_bshall_hubert(sd).items()}, path)
    else:
        torch.save({"model": sd}, path)


# [encoders]: whisper-ppg, whisper-ppg-large, wavlmbase+ and dphubert at
# their published widths. DPHuBERT's published per-layer widths are not in
# the repository: HuBERT-base's outer widths (768, 12 layers, 512-wide convs,
# head_dim 64) with per-layer heads and FFN widths that vary, layer 3
# without attention and layer 8 without its FFN
PPG_ENCODERS = ("whisper-ppg", "whisper-ppg-large", "wavlmbase+", "dphubert")
ENCODERS_LIMIT_S = 420  # the phase's hard time limit (SIGALRM)
DPHUBERT_CFG = dict(
    extractor_mode="group_norm",
    extractor_conv_layer_config=[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2,
    extractor_conv_bias=False, encoder_embed_dim=768, encoder_projection_dropout=0.0,
    encoder_pos_conv_kernel=128, encoder_pos_conv_groups=16, encoder_num_layers=12,
    encoder_use_attention=[i != 3 for i in range(12)],
    encoder_use_feed_forward=[i != 8 for i in range(12)],
    encoder_num_heads=[12, 10, 9, 0, 8, 8, 7, 6, 6, 5, 4, 4], encoder_head_dim=64,
    encoder_attention_dropout=0.0,
    encoder_ff_interm_features=[3072, 2900, 2600, 2400, 2200, 2000, 1800, 1500, 0, 1200, 1000, 800],
    encoder_ff_interm_dropout=0.0, encoder_dropout=0.0, encoder_layer_norm_first=False,
    encoder_layer_drop=0.0, normalize_waveform=False,
)
# openai-whisper's text-decoder fields of ``dims`` (medium's), which the
# encoder does not read
WHISPER_TEXT_DIMS = dict(n_vocab=51865, n_text_ctx=448, n_text_state=1024, n_text_head=16,
                         n_text_layer=24)


def seeded_encoder(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``factory.init_random_`` from ``seed``, then every LayerNorm and
    GroupNorm scale 1 + N(0, 0.1) and shift N(0, 0.1), and WavLM's grep_a
    U(0.5, 1.5): no parameter keeps a constant value."""
    from sovits_tpu_torch.models import factory

    generator = torch.Generator().manual_seed(seed)
    factory.init_random_(net, generator)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                module.weight.copy_(1.0 + 0.1 * torch.randn(module.weight.shape, generator=generator))
                module.bias.copy_(0.1 * torch.randn(module.bias.shape, generator=generator))
            if hasattr(module, "grep_a"):
                module.grep_a.copy_(0.5 + torch.rand(module.grep_a.shape, generator=generator))
    return net


def write_ppg_checkpoint(name: str, path: Path, seed: int = 13, dims=None) -> None:
    """A seeded ``name`` encoder (``dims``: WhisperDims, WavLMDims or a
    DPHuBERT config; the published widths by default) saved in its
    checkpoint's layout: openai-whisper's {"dims", "model_state_dict"} with
    the stored positional embedding and a decoder entry, WavLM's {"cfg",
    "model"} with ``mask_emb``, DPHuBERT's {"config", "state_dict"} with
    ``aux_num_out`` and an auxiliary head. What the encoder does not use is
    there to be ignored."""
    import dataclasses

    from sovits_tpu_torch.encoders import dphubert, wavlm, whisper

    path.parent.mkdir(parents=True, exist_ok=True)
    if name.startswith("whisper-ppg"):
        dims = dims or whisper.WHISPER_CONFIGS[name]
        sd = dict(seeded_encoder(whisper.WhisperEncoder(dims), seed).state_dict())
        sd["encoder.positional_embedding"] = torch.from_numpy(
            whisper.sinusoids(dims.n_audio_ctx, dims.n_audio_state))
        sd["decoder.ln.weight"] = torch.ones(dims.n_audio_state)
        ckpt = {"dims": dict(WHISPER_TEXT_DIMS, **dataclasses.asdict(dims)), "model_state_dict": sd}
    elif name == "wavlmbase+":
        dims = dims or wavlm.WavLMDims()
        sd = dict(seeded_encoder(wavlm.WavLMEncoder(dims), seed).state_dict())
        sd["mask_emb"] = torch.zeros(dims.d_model)
        cfg = {"encoder_embed_dim": dims.d_model, "encoder_layers": dims.n_layers,
               "encoder_attention_heads": dims.n_heads, "encoder_ffn_embed_dim": dims.ffn_dim,
               "num_buckets": dims.num_buckets, "max_distance": dims.max_distance,
               "normalize": dims.normalize_input, "conv_pos": 128, "conv_pos_groups": 16,
               "relative_position_embedding": True, "gru_rel_pos": True}
        ckpt = {"cfg": cfg, "model": sd}
    elif name == "dphubert":
        cfg = dims or DPHUBERT_CFG
        sd = dict(seeded_encoder(dphubert.DPHubertEncoder(cfg), seed).state_dict())
        sd["aux.weight"] = torch.zeros(4, cfg["encoder_embed_dim"])
        ckpt = {"config": dict(cfg, aux_num_out=None), "state_dict": sd}
    else:
        raise ValueError(f"not a whisper, WavLM or DPHuBERT encoder: {name}")
    torch.save(ckpt, path)


def _gflop(fn) -> float:
    """The FLOPs torch's FlopCounterMode counts in one call of fn (convs,
    matmuls; not the GRU's cuDNN kernel), in GFLOP."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e9


def _net_call(kind: str, pred, wav: np.ndarray, sr: int):
    """A zero-argument call of the predictor's net alone on the clip's
    input (the FLOP count's subject) and the GRU's GFLOP, which the counter
    does not see."""
    from sovits_tpu_torch.dsp.audio import resample

    if kind == "crepe":
        from sovits_tpu_torch.f0.crepe import crepe_frames

        hop16 = int(round(pred.hop_length * 16000 / sr))
        x = torch.from_numpy(crepe_frames(resample(wav, sr, 16000), len(wav) // pred.hop_length,
                                          hop16)).to(pred.device)
        return lambda: pred.net(x), 0.0
    wav16 = torch.from_numpy(resample(wav, sr, 16000)[None]).to(pred.device)
    if kind == "rmvpe":
        from sovits_tpu_torch.f0.rmvpe import rmvpe_mel

        mel = rmvpe_mel(wav16)
        mel = torch.nn.functional.pad(mel, (0, 0, 0, -mel.shape[1] % 32))
        gru = pred.net.fc[0].gru
        h, t = gru.hidden_size, mel.shape[1]
        return lambda: pred.net(mel), 2 * 2 * t * 3 * h * (gru.input_size + h) / 1e9
    from sovits_tpu_torch.f0.fcpe import fcpe_mel

    mel = fcpe_mel(wav16)
    return lambda: pred.net(mel), 0.0


def _device_union_ms(fn) -> float:
    """Milliseconds of one call of fn in which at least one kernel ran on
    the card: the union of the profiler's kernel intervals (where kernels
    overlap, the sum of their times exceeds it)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, reached = 0.0, float("-inf")
    for start, end in spans:
        if end > reached:
            total += end - max(start, reached)
            reached = end
    return total / 1e3


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _frontend_request(svc, wav: np.ndarray, what: str, f0_predictor: str, phase: str = "frontend",
                      **kw) -> dict:
    """One Svc.infer on the card (``kw``: more of its arguments): wall, RTF
    and its K1/K3 launches (6 and 4)."""
    before = _counts()
    wall, (audio, n_samples, n_frames) = _timed(
        lambda: svc.infer(0, 0, wav, sr=svc.target_sample, f0_predictor=f0_predictor, **kw))
    got = {k: v - before[k] for k, v in _counts().items()}
    seconds = len(wav) / svc.target_sample
    ok = (n_samples == n_frames * svc.hop_size == len(wav) // svc.hop_size * svc.hop_size
          and np.isfinite(audio).all() and float(np.abs(audio).max()) > 1e-4
          and got["rel_attention"] == 6 and got["resblock_trio"] == 4
          and all(v == 0 for k, v in got.items() if k not in ("rel_attention", "resblock_trio")))
    log(phase, request=repr(what), f0=f0_predictor, encoder=svc.encoder.name, frames=n_frames,
        wall_s=f"{wall:.4f}", rtf=f"{wall / seconds:.5f}", rel_attention=got["rel_attention"],
        resblock_trio=got["resblock_trio"], peak=f"{np.abs(audio).max():.4f}", ok=ok)
    if not ok:
        raise AssertionError(f"[{phase}] {what}: bad output or launches {got} (want 6 and 4)")
    return {"wall_s": wall, "rtf": wall / seconds}


def frontend_f0_nets(svc) -> None:
    """Each f0 net at its published width: the salience of a 3 s clip on
    the card against a CPU copy (SALIENCE_ATOL), then a warm-up and a 10 s
    request through ``svc`` with the net as its f0_predictor_object; the
    predictor's own seconds, its device-busy time and top kernels, and its
    FLOPs beside the fp32 bound."""
    from sovits_tpu_torch.dsp.audio import resample
    from sovits_tpu_torch.f0.base import get_f0_predictor

    sr, hop = svc.target_sample, svc.hop_size
    clip3, long_clip = bench_signal(3.0, sr, seed=5), bench_signal(SECONDS, sr)
    for kind in F0_NETS:
        sd = f0_net_weights(kind)
        card, host = (get_f0_predictor(kind, hop, sr, weights=sd, device=d) for d in ("cuda", "cpu"))
        t0 = time.perf_counter()
        if kind == "crepe":
            sal = [p.salience(clip3, len(clip3) // hop) for p in (card, host)]
        else:
            wav16 = resample(clip3, sr, 16000)
            sal = [p.salience(wav16) for p in (card, host)]
        err = float(np.abs(sal[0] - sal[1]).max())
        ok = sal[0].shape == sal[1].shape and np.isfinite(sal[0]).all() and err <= SALIENCE_ATOL
        log("frontend", f0=kind, what="salience, card vs CPU, 3 s clip, fp32 (TF32 off)",
            frames=sal[0].shape[0], max_abs=f"{err:.3e}", limit=SALIENCE_ATOL,
            card_and_cpu_s=f"{time.perf_counter() - t0:.2f}", ok=ok)
        if not ok:
            raise AssertionError(f"[frontend] {kind}: card and CPU salience disagree by {err}")
        del host
        svc.f0_predictor_object = card
        _frontend_request(svc, long_clip, "10s warm-up", kind)
        r = _frontend_request(svc, long_clip, "10s", kind)
        if svc.f0_predictor_object is not card:
            raise AssertionError(f"[frontend] Svc replaced the preset {kind} predictor")
        pred_s, _ = _timed(lambda: card.compute_f0_uv(long_clip))
        wall, busy_ms, dev = _profiled(lambda: card.compute_f0_uv(long_clip))
        union_ms = _device_union_ms(lambda: card.compute_f0_uv(long_clip))
        net_call, gru_gflop = _net_call(kind, card, long_clip, sr)
        net_s, _ = _timed(net_call)
        gflop = _gflop(net_call) + gru_gflop
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
        log("frontend", f0=kind, what="10 s clip", request_wall_s=f"{r['wall_s']:.4f}",
            request_rtf=f"{r['rtf']:.5f}", predictor_s=f"{pred_s:.4f}", net_s=f"{net_s:.4f}",
            profiled_wall_s=f"{wall:.4f}", device_busy_ms=f"{busy_ms:.2f}",
            device_busy_union_ms=f"{union_ms:.2f}", kernel_names=len(dev), gflop=f"{gflop:.1f}",
            fp32_bound_ms=f"{gflop * 1e12 / FP32_FLOPS:.2f}")
        for key, us in top:
            print(f"    device {us / 1e3:9.3f} ms  {key[:110]}", flush=True)
        svc.f0_predictor_object = None
        del card
        torch.cuda.empty_cache()


def encoder_checks(tmp: Path, name: str, write, phase: str) -> dict:
    """One encoder at its full width, seeded and written by ``write(name,
    path)`` in its checkpoint's layout, loaded by get_speech_encoder on the
    card and on the CPU: the units of a 3 s clip card against CPU
    (UNITS_REL of their peak) and the encode seconds of 10 s (after a
    warm-up), with the net's GFLOP on that input beside the fp32 bound;
    then a full-width default model with the encoder's ssl_dim: a warm-up
    and a 10 s request (K1/K3 6/4), and a 3 s request card against CPU with
    noise off (log-mel L1 < 1e-3). Returns the 10 s request's numbers."""
    from sovits_tpu_torch import config as scfg
    from sovits_tpu_torch.dsp.audio import resample
    from sovits_tpu_torch.dsp.stft import mel_spectrogram
    from sovits_tpu_torch.encoders.factory import get_speech_encoder

    work = tmp / phase / name
    path = work / f"{name}.pt"
    t0 = time.perf_counter()
    write(name, path)
    card, host = (get_speech_encoder(name, path, device=d) for d in ("cuda", "cpu"))
    load_s = time.perf_counter() - t0
    path.unlink()
    hps = scfg.default_config(**{"model.ssl_dim": card.hidden_dim, "model.speech_encoder": name})
    sr = hps.data.sampling_rate
    clip3, long_clip = bench_signal(3.0, sr, seed=5), bench_signal(SECONDS, sr)
    wav16 = resample(clip3, sr, 16000)
    t0 = time.perf_counter()
    units = [e.encode(wav16) for e in (card, host)]
    units_s = time.perf_counter() - t0
    rel = float(np.abs(units[0] - units[1]).max() / np.abs(units[1]).max())
    long16 = resample(long_clip, sr, 16000)
    card.encode(long16)
    encode_s, _ = _timed(lambda: card.encode(long16))
    net_input = torch.from_numpy(card.prepare(long16)[0][None]).cuda()
    net_s, _ = _timed(lambda: card.net(net_input))
    gflop = _gflop(lambda: card.net(net_input))
    frames = len(wav16) // 320 if name.startswith("whisper") else (len(wav16) + 2 * card.pad - 400) // 320 + 1
    ok = units[0].shape == (frames, card.hidden_dim) and np.isfinite(units[0]).all() and rel <= UNITS_REL
    log(phase, encoder=name, params_m=f"{sum(p.numel() for p in card.net.parameters()) / 1e6:.1f}",
        write_and_load_s=f"{load_s:.2f}", units_shape=units[0].shape, units_rel_max_abs=f"{rel:.3e}",
        limit=UNITS_REL, card_and_cpu_3s_s=f"{units_s:.2f}", encode_10s_s=f"{encode_s:.4f}",
        net_s=f"{net_s:.4f}", gflop=f"{gflop:.1f}", fp32_bound_ms=f"{gflop * 1e12 / FP32_FLOPS:.2f}",
        ok=ok)
    if not ok:
        raise AssertionError(f"[{phase}] {name}: units {units[0].shape}, card vs CPU {rel}")
    svc = build_svc(work, "cuda", encoder=card, hps=hps)
    if svc.model.pre.in_channels != card.hidden_dim:
        raise AssertionError(f"[{phase}] {name}: the synthesizer takes {svc.model.pre.in_channels}")
    _frontend_request(svc, long_clip, "10s warm-up", "dio", phase)
    request = _frontend_request(svc, long_clip, "10s", "dio", phase)
    cpu_svc = build_svc(work, "cpu", encoder=host)
    outs = [s._run_synth_batch([s._prepare_chunk(0, 0, clip3, sr, 0.0, False, "dio", 0.05)], 0.0,
                               False, 52468, sample_noise=False)[0] for s in (svc, cpu_svc)]
    mels = [mel_spectrogram(torch.from_numpy(a)[None]) for a in outs]
    l1 = (mels[0] - mels[1]).abs().mean().item()
    log(phase, encoder=name, what="3 s request card vs CPU (encoder and synthesizer), noise off",
        max_abs=f"{np.abs(outs[0] - outs[1]).max():.3e}", mel_l1=f"{l1:.3e}", limit=1e-3, ok=l1 < 1e-3)
    if not l1 < 1e-3:
        raise AssertionError(f"[{phase}] {name}: card and CPU disagree: log-mel L1 {l1}")
    del svc, cpu_svc, card, host
    torch.cuda.empty_cache()
    return dict(request, encode_s=encode_s)


def frontend_encoders(tmp: Path) -> None:
    """``encoder_checks`` for each new wav2vec2-family encoder."""
    for name in NEW_ENCODERS:
        encoder_checks(tmp, name, write_encoder_checkpoint, "frontend")


def phase_frontend(tmp: Path, svc) -> dict:
    """The front end of a request on the card (``frontend_f0_nets``, then
    ``frontend_encoders``) under a hard time limit of FRONTEND_LIMIT_S.
    Returns the K1/K3 launches of the phase's requests."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    def run():
        _reset_counts()
        frontend_f0_nets(svc)
        f0_s = time.perf_counter() - t_phase
        frontend_encoders(tmp)
        return _counts(), f0_s

    counts, f0_s = _limited("frontend", FRONTEND_LIMIT_S, run)
    log("frontend", phase_s=f"{time.perf_counter() - t_phase:.1f}", f0_nets_s=f"{f0_s:.1f}",
        limit_s=FRONTEND_LIMIT_S, launches=counts)
    return counts


def _limited(phase: str, limit_s: int, fn):
    """fn() under a hard time limit (SIGALRM): a phase over it raises."""
    import signal

    def over(*_):
        raise TimeoutError(f"[{phase}] over its {limit_s} s limit")

    previous = signal.signal(signal.SIGALRM, over)
    signal.alarm(limit_s)
    try:
        return fn()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def phase_encoders(tmp: Path) -> dict:
    """whisper-ppg, whisper-ppg-large, wavlmbase+ and dphubert at their
    published widths (``encoder_checks``; DPHuBERT's widths: DPHUBERT_CFG)
    under a hard limit of ENCODERS_LIMIT_S. Returns the K1/K3 launches of
    the phase's requests."""
    t_phase = time.perf_counter()

    def run():
        _reset_counts()
        for name in PPG_ENCODERS:
            encoder_checks(tmp, name, write_ppg_checkpoint, "encoders")
        return _counts()

    counts = _limited("encoders", ENCODERS_LIMIT_S, run)
    log("encoders", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=ENCODERS_LIMIT_S,
        launches=counts)
    return counts


# [cluster]: one speaker's hour of units at 50 frames/s, so-vits-svc's
# train_cluster.py defaults (10 000 centers, 50 iterations)
CLUSTER_N, CLUSTER_D, CLUSTER_K, CLUSTER_ITERS = 180_000, 768, 10_000, 50
CLUSTER_LIMIT_S = 300
NEAREST_REL = 1e-5  # a point's distance to its assigned center over its float64 nearest, excess / (|x|^2 + |c|^2)
INERTIA_REL = 1e-6  # a Lloyd step's inertia may exceed the last one's by summation order only
TIE_REL = 1e-5  # a deciding gap narrower than this x the row's distance scale is a near-tie


def cluster_units(seed: int = 3) -> torch.Tensor:
    """[CLUSTER_N, CLUSTER_D] seeded units on the card: 2000 gaussian
    clusters (centers N(0, 1), spread 0.5), with unit-scale rows as
    LayerNorm-ed encoder units have."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    modes = torch.randn(2000, CLUSTER_D, generator=g, device="cuda")
    pick = torch.randint(2000, (CLUSTER_N,), generator=g, device="cuda")
    return modes[pick] + 0.5 * torch.randn(CLUSTER_N, CLUSTER_D, generator=g, device="cuda")


def _float64_dists(x: torch.Tensor, centers: torch.Tensor, rows: int = 20_000):
    """Yields (first row, the float64 squared distances of ``rows`` rows of
    x to every center) over x."""
    c = centers.double()
    c2 = (c * c).sum(1)
    for start in range(0, x.shape[0], rows):
        xs = x[start : start + rows].double()
        yield start, (xs * xs).sum(1, keepdim=True) + c2[None] - 2.0 * xs @ c.T


def _decided(d64: torch.Tensor, rank: int) -> torch.Tensor:
    """Rows whose rank-th and (rank+1)-th smallest float64 distances lie more
    than TIE_REL x the row's largest distance apart."""
    s = torch.topk(d64, rank + 1, dim=1, largest=False).values
    return s[:, rank] - s[:, rank - 1] > TIE_REL * d64.abs().amax(1)


def cluster_fit(x: torch.Tensor) -> torch.Tensor:
    """kmeans_fit's two stages on the card, timed, with their GFLOP; checks
    that every point is assigned to its nearest final center (float64) and
    that the inertia never rises."""
    from sovits_tpu_torch.cluster import kmeans

    gen = torch.Generator(device="cuda").manual_seed(0)
    init_s, init = _timed(lambda: kmeans.kmeans_plus_plus_init(x, CLUSTER_K, gen))
    lloyd_s, (centers, inertia) = _timed(lambda: kmeans.lloyd(x, init, CLUSTER_ITERS))
    n, d, k = CLUSTER_N, CLUSTER_D, CLUSTER_K
    init_gflop = 2 * n * d * k / 1e9  # a matrix-vector product a seed
    lloyd_gflop = CLUSTER_ITERS * 2 * n * d * k / 1e9  # one [N, D] x [D, K] product a step
    assign = kmeans.kmeans_predict(x, centers)
    worst, moved = 0.0, 0
    for start, d64 in _float64_dists(x, centers):
        a = assign[start : start + d64.shape[0]]
        excess = d64.gather(1, a[:, None])[:, 0] - d64.amin(1)
        scale = (x[start : start + d64.shape[0]].double() ** 2).sum(1) + (centers[a].double() ** 2).sum(1)
        worst = max(worst, float((excess / scale).max()))
        moved += int((excess > 0).sum())
    inertia = inertia.cpu().numpy()
    rises = np.diff(inertia) / inertia[:-1]
    ok = (worst <= NEAREST_REL and rises.max() <= INERTIA_REL and bool(torch.isfinite(centers).all()))
    log("cluster", what=f"kmeans_fit N {n} D {d} K {k}, {CLUSTER_ITERS} Lloyd steps, fp32 (TF32 off)",
        init_s=f"{init_s:.3f}", init_gflop=f"{init_gflop:.1f}", lloyd_s=f"{lloyd_s:.3f}",
        lloyd_gflop=f"{lloyd_gflop:.1f}", lloyd_tflops=f"{lloyd_gflop / lloyd_s / 1e3:.2f}",
        lloyd_fp32_bound_s=f"{lloyd_gflop * 1e9 / FP32_FLOPS:.3f}",
        empty_clusters=int((torch.bincount(assign, minlength=k) == 0).sum()),
        inertia_first=f"{inertia[0]:.6e}", inertia_last=f"{inertia[-1]:.6e}",
        inertia_max_rise_rel=f"{rises.max():.3e}", inertia_limit=INERTIA_REL,
        assigned_not_float64_nearest=moved, worst_excess_rel=f"{worst:.3e}", limit=NEAREST_REL, ok=ok)
    if not ok:
        raise AssertionError(f"[cluster] k-means: nearest {worst}, inertia rise {rises.max()}")
    return centers


def cluster_blends_card_vs_cpu(units: np.ndarray, centers: torch.Tensor, bank: torch.Tensor) -> None:
    """nearest_centers and blend_retrieval of a 10 s request's units, card
    against CPU: indices equal on the rows whose deciding gap is not a
    near-tie (float64 distances), the blend within UNITS_REL of its peak."""
    from sovits_tpu_torch.cluster import kmeans, store

    u = torch.from_numpy(units).cuda()
    for kind, table, rank in (("kmeans", centers, 1), ("retrieval", bank, 8)):
        (d64,) = [d for _, d in _float64_dists(u, table, rows=len(units))]
        decided = _decided(d64, rank).cpu().numpy()
        if kind == "kmeans":
            got = [kmeans.kmeans_predict(u, table).cpu().numpy(),
                   kmeans.kmeans_predict(u.cpu(), table.cpu()).numpy()]
            out = [kmeans.nearest_centers(u, table).cpu().numpy(),
                   kmeans.nearest_centers(u.cpu(), table.cpu()).numpy()]
        else:
            got = [torch.topk(kmeans._sq_dists(v, t), 8, dim=1, largest=False).indices.sort(1).values
                   .cpu().numpy() for v, t in ((u, table), (u.cpu(), table.cpu()))]
            out = [store.blend_retrieval(u, table).cpu().numpy(),
                   store.blend_retrieval(u.cpu(), table.cpu()).numpy()]
        same = (got[0] == got[1]).reshape(len(units), -1).all(1)
        rel = float(np.abs(out[0] - out[1])[decided].max() / np.abs(out[1]).max())
        blend_s, _ = _timed(lambda: (kmeans.nearest_centers(u, table) if kind == "kmeans"
                                     else store.blend_retrieval(u, table)))
        ok = bool(same[decided].all()) and rel <= UNITS_REL
        log("cluster", what=f"{kind} replacement of a 10 s request's units, card vs CPU",
            rows=len(units), near_ties_excluded=int((~decided).sum()), indices_equal=int(same[decided].sum()),
            rel_max_abs=f"{rel:.3e}", limit=UNITS_REL, card_s=f"{blend_s:.4f}", ok=ok)
        if not ok:
            raise AssertionError(f"[cluster] {kind}: card and CPU disagree off near-ties ({rel})")


def cluster_train_cli(tmp: Path) -> None:
    """``python -m sovits_tpu_torch.cli.train_cluster`` on the card over a
    small dataset of two speakers' .soft.npy units ([H, T])."""
    from sovits_tpu_torch.cli import train_cluster
    from sovits_tpu_torch.cluster import load_cluster_model

    rng = np.random.default_rng(4)
    data = tmp / "cluster" / "dataset"
    for spk in ("alto", "tenor"):
        (data / spk).mkdir(parents=True)
        for i in range(3):
            np.save(data / spk / f"clip{i}.wav.soft.npy", rng.standard_normal((CLUSTER_D, 400)).astype(np.float32))
    out = tmp / "cluster" / "kmeans_64.npz"
    wall, _ = _timed(lambda: train_cluster.main(["--dataset", str(data), "--output", str(out),
                                                 "--n_clusters", "64"]))
    model = load_cluster_model(out, device="cpu")
    ok = (not model.retrieval and set(model.per_speaker) == {"alto", "tenor"}
          and all(v.shape == (64, CLUSTER_D) and bool(torch.isfinite(v).all()) for v in model.per_speaker.values()))
    log("cluster", what="train_cluster CLI, 2 speakers x 1200 frames, 64 centers", wall_s=f"{wall:.2f}", ok=ok)
    if not ok:
        raise AssertionError("[cluster] train_cluster wrote a bad model")


def cluster_cli(tmp: Path, model_path: Path) -> None:
    """The infer CLI with -cm -cr 0.5 -fr, from the directory phase_cli
    prepared (its encoder checkpoint and 12 s song)."""
    import os

    from scipy.io import wavfile

    from sovits_tpu_torch.cli import infer as cli

    work = tmp / "cli"
    cwd = os.getcwd()
    os.chdir(work)
    try:
        wall, _ = _timed(lambda: cli.main(["-m", str(tmp / "G_0.pth"), "-c", str(tmp / "config.json"),
                                           "-n", "song.wav", "-f0p", "dio", "-cm", str(model_path),
                                           "-cr", "0.5", "-fr"]))
    finally:
        os.chdir(cwd)
    out_sr, audio = wavfile.read(work / "results" / "song_0key_0_sovits_dio.wav")
    ok = len(audio) > 0 and np.abs(audio).max() > 0
    log("cluster", what="infer CLI -cm -cr 0.5 -fr", samples=len(audio), wall_s=f"{wall:.2f}", ok=ok)
    if not ok:
        raise AssertionError("[cluster] the CLI with a cluster model wrote no audio")


def phase_cluster(tmp: Path, svc) -> dict:
    """k-means and retrieval at so-vits-svc's size for one speaker, on the
    card: ``cluster_fit``; a retrieval bank of the same rows; the blends
    card against CPU; 10 s requests through Svc at ratio 0.5 on the k-means
    .npz, on a kmeans_10000.pt dict and by retrieval (K1/K3 6/4, the
    blend's seconds); a 3 s request card against CPU, noise off; the
    train_cluster and infer CLIs. Under CLUSTER_LIMIT_S. Returns the K1/K3
    launches of the phase's requests."""
    from sovits_tpu_torch.cluster import ClusterModel
    from sovits_tpu_torch.cluster.store import save_cluster_model
    from sovits_tpu_torch.dsp.stft import mel_spectrogram

    t_phase = time.perf_counter()

    def run():
        work = tmp / "cluster"
        work.mkdir(parents=True, exist_ok=True)
        x = cluster_units()
        centers = cluster_fit(x)
        files = {"kmeans.npz": work / "kmeans_10000.npz", "kmeans_10000.pt": work / "kmeans_10000.pt",
                 "retrieval.npz": work / "retrieval.npz"}
        save_cluster_model(ClusterModel({"0": centers}, False), files["kmeans.npz"])
        torch.save({"0": {"cluster_centers_": centers.cpu().numpy()}}, files["kmeans_10000.pt"])
        save_cluster_model(ClusterModel({"0": x}, True), files["retrieval.npz"])
        sr = svc.target_sample
        long_clip, clip3 = bench_signal(SECONDS, sr), bench_signal(3.0, sr, seed=5)
        units, _, _ = svc.get_unit_f0(long_clip, 0, 0.0, 0, f0_predictor="dio")
        cluster_blends_card_vs_cpu(units, centers, x)
        del x
        _reset_counts()
        for what, path, retrieval in (("k-means .npz", files["kmeans.npz"], False),
                                      ("kmeans_10000.pt", files["kmeans_10000.pt"], False),
                                      ("retrieval .npz", files["retrieval.npz"], True)):
            csvc = build_svc(tmp, "cuda", encoder=svc.encoder, cluster_model_path=str(path),
                             feature_retrieval=retrieval)
            csvc.f0_predictor_object = svc.f0_predictor_object
            _frontend_request(csvc, long_clip, f"10s warm-up, {what}", "dio", "cluster", cluster_infer_ratio=0.5)
            _frontend_request(csvc, long_clip, f"10s, {what}", "dio", "cluster", cluster_infer_ratio=0.5)
            blend_s, _ = _timed(lambda: csvc.cluster.blend(units, 0, 0.5, csvc.spk2id, retrieval=retrieval))
            log("cluster", what=f"blend of the 10 s request's units, {what}", rows=len(units),
                bank_rows=csvc.cluster.per_speaker["0"].shape[0], blend_s=f"{blend_s:.4f}")
            if what == "retrieval .npz":
                cpu_svc = build_svc(tmp, "cpu", encoder=svc.encoder, cluster_model_path=str(path),
                                    feature_retrieval=True)
                outs = [s._run_synth_batch([s._prepare_chunk(0, 0, clip3, sr, 0.5, False, "dio", 0.05)],
                                           0.0, False, 52468, sample_noise=False)[0] for s in (csvc, cpu_svc)]
                mels = [mel_spectrogram(torch.from_numpy(a)[None]) for a in outs]
                l1 = (mels[0] - mels[1]).abs().mean().item()
                log("cluster", what="3 s request at ratio 0.5 by retrieval, card vs CPU, noise off",
                    max_abs=f"{np.abs(outs[0] - outs[1]).max():.3e}", mel_l1=f"{l1:.3e}", limit=1e-3,
                    ok=l1 < 1e-3)
                if not l1 < 1e-3:
                    raise AssertionError(f"[cluster] card and CPU disagree: log-mel L1 {l1}")
                del cpu_svc
            del csvc
            torch.cuda.empty_cache()
        cluster_cli(tmp, files["retrieval.npz"])
        counts = _counts()
        cluster_train_cli(tmp)
        return counts

    counts = _limited("cluster", CLUSTER_LIMIT_S, run)
    log("cluster", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=CLUSTER_LIMIT_S, launches=counts)
    return counts


# [pipeline]: a user's path from raw recordings to a released model, through
# the CLIs: 2 speakers x 6 clips of 3-8 s recorded at 48 kHz in stereo;
# so-vits-svc's default config (GAN) and diffusion template (DIFFUSION_DEFAULTS)
PIPELINE_LIMIT_S = 300
PIPELINE_SPEAKERS = {"alto": 190.0, "tenor": 130.0}  # speaker: base pitch (Hz)
PIPELINE_CLIP_S = (3.0, 4.0, 5.0, 6.0, 7.0, 8.0)
PIPELINE_GAN_STEPS, PIPELINE_EVAL_INTERVAL = 4, 2
DIFF_STEPS, DIFF_RESUME_STEPS = 200, 210
DIFF_PROFILED_STEP = 151  # no log, save or validation follows it
DIFF_CARD_BATCH = 4
DIFF_LOSS_REL = 1e-5  # one diffusion step, card against CPU, fp32 with TF32 off
DIFF_GRAD_REL = 1e-4  # each gradient's max-abs error over its tensor's peak |value|


def _launched(before: dict) -> dict:
    now = _counts()
    return {k: now[k] - before[k] for k in now}


@contextlib.contextmanager
def _spied_training():
    """Within it, every trainer.train_step and trainer._evaluate call appends
    (wall s ending in a synchronize, its launches, its result) to the
    yielded dict's "steps" or "evals"."""
    from sovits_tpu_torch.train import trainer

    records = {"steps": [], "evals": []}

    def spied(fn, record):
        def run(*a, **k):
            torch.cuda.synchronize()
            before, t0 = _counts(), time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            record.append((time.perf_counter() - t0, _launched(before), out))
            return out
        return run

    real = trainer.train_step, trainer._evaluate
    trainer.train_step, trainer._evaluate = spied(real[0], records["steps"]), spied(real[1], records["evals"])
    try:
        yield records
    finally:
        trainer.train_step, trainer._evaluate = real


def pipeline_corpus(raw: Path) -> float:
    """The raw recordings: 48 kHz stereo 16-bit, left and right a little
    apart. Returns their seconds."""
    from scipy.io import wavfile

    total = 0.0
    for s, (spk, hz) in enumerate(PIPELINE_SPEAKERS.items()):
        (raw / spk).mkdir(parents=True)
        for i, seconds in enumerate(PIPELINE_CLIP_S):
            left = bench_signal(seconds, 48000, seed=70 + 10 * s + i, base_hz=hz + 9.0 * i)
            right = 0.9 * left + 0.01 * np.random.default_rng(90 + 10 * s + i).standard_normal(len(left))
            stereo = np.clip(np.stack([left, right], 1), -1, 1)
            wavfile.write(raw / spk / f"take{i}.wav", 48000, (stereo * 32767).astype(np.int16))
            total += seconds
    return total


def pipeline_features(work: Path, tmp: Path) -> dict:
    """preprocess_flist_config, then preprocess_features --use_diff with
    DIO on two spawned workers and the smoke's seeded vec768l12 checkpoint;
    every artifact's shape checked against its wav's frames."""
    from scipy.io import wavfile

    from sovits_tpu_torch.cli import preprocess_features, preprocess_flist_config
    from sovits_tpu_torch.train.diffusion import DIFFUSION_DEFAULTS
    from sovits_tpu_torch.train.data import load_filelist

    lists = {"train": work / "filelists" / "train.txt", "val": work / "filelists" / "val.txt"}
    config = work / "configs" / "config.json"
    preprocess_flist_config.main(["--source_dir", str(work / "dataset" / "44k"), "--train_list",
                                  str(lists["train"]), "--val_list", str(lists["val"]),
                                  "--config_out", str(config)])
    cfg = json.loads(config.read_text())
    train, val = (load_filelist(lists[k]) for k in ("train", "val"))
    ok = len(train) == 8 and len(val) == 4 and cfg["spk"] == {"alto": 0, "tenor": 1}
    log("pipeline", what="filelists and config", train=len(train), val=len(val), spk=cfg["spk"],
        ssl_dim=cfg["model"]["ssl_dim"], n_speakers=cfg["model"]["n_speakers"], ok=ok)
    if not ok:
        raise AssertionError(f"[pipeline] filelists {len(train)}/{len(val)}, speakers {cfg['spk']}")

    diff = json.loads(json.dumps(DIFFUSION_DEFAULTS))
    diff["data"].update(training_files=str(lists["train"]), validation_files=str(lists["val"]))
    diff["model"]["n_spk"] = len(cfg["spk"])
    diff["train"].update(interval_log=10, interval_val=100, interval_force_save=100)
    diff["vocoder"]["ckpt"] = str(tmp / "diffusion" / "nsf_hifigan" / "model")  # [diffusion]'s seeded vocoder
    diff["env"]["expdir"] = str(work / "logs" / "44k" / "diffusion")
    diff["spk"] = cfg["spk"]
    (work / "configs" / "diffusion.yaml").write_text(json.dumps(diff))  # JSON text is valid YAML

    t0 = time.perf_counter()
    seconds = preprocess_features.main([
        "-c", str(config), "--diffusion_config", str(work / "configs" / "diffusion.yaml"), "--use_diff",
        "--f0_predictor", "dio", "--encoder_checkpoint",
        str(tmp / "cli" / "pretrain" / "checkpoint_best_legacy_500.pt"),  # [slice]'s seeded vec768l12
        "--workers", "2", "--device", "cuda"])
    wall = time.perf_counter() - t0
    paths = train + val
    d, mels = cfg["data"], json.loads(Path(diff["vocoder"]["ckpt"]).with_name("config.json").read_text())["num_mels"]
    bad = []
    for p in paths:
        sr, wav = wavfile.read(p)
        t = len(wav) // d["hop_length"]
        f0, uv = np.load(p + ".f0.npy", allow_pickle=True)
        mel = np.load(p + ".mel.npy")
        aug, key = np.load(p + ".aug_mel.npy", allow_pickle=True)
        shapes = {"soft": (np.load(p + ".soft.npy").shape[0], cfg["model"]["ssl_dim"]), "f0": (f0.shape, (t,)),
                  "uv": (uv.shape, (t,)), "spec": (np.load(p + ".spec.npy").shape, (d["filter_length"] // 2 + 1, t)),
                  "vol": (np.load(p + ".vol.npy").shape, (t,)), "mel": (mel.shape[1], mels),
                  "mel_frames": (abs(mel.shape[0] - t) <= 1, True), "aug_mel": (np.asarray(aug).shape[1], mels),
                  "aug_vol": (np.load(p + ".aug_vol.npy").shape, (t,)), "sr": (sr, d["sampling_rate"])}
        bad += [(Path(p).name, k, got, want) for k, (got, want) in shapes.items() if got != want]
        if not (np.isfinite(mel).all() and np.isfinite(np.asarray(aug, np.float32)).all() and -5 <= key <= 5):
            bad.append((Path(p).name, "mel values", float(np.abs(mel).max()), key))
    log("pipeline", what="preprocess_features --use_diff, dio on 2 workers", files=len(paths),
        wall_s=f"{wall:.2f}", s_per_file=f"{wall / len(paths):.3f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in seconds.items()}, shapes_ok=not bad)
    if bad:
        raise AssertionError(f"[pipeline] artifacts of the wrong shape: {bad}")
    return seconds


def pipeline_gan(work: Path) -> None:
    """cli.train at the default config (MPD + MSD, batch 6, TF32 off) for
    PIPELINE_GAN_STEPS steps, evaluating every PIPELINE_EVAL_INTERVAL: each
    step's wall and K1/K2 launches, each evaluation's wall and K1 launches
    (6 a clip, 2 clips)."""
    from sovits_tpu_torch.cli import train as cli_train

    config = work / "configs" / "config.json"
    cfg = json.loads(config.read_text())
    cfg["train"].update(eval_interval=PIPELINE_EVAL_INTERVAL, log_interval=1)
    config.write_text(json.dumps(cfg, indent=2))
    with _spied_training() as rec, contextlib.chdir(work):
        t0 = time.perf_counter()
        cli_train.main(["-c", "configs/config.json", "-m", "44k", "--max-steps", str(PIPELINE_GAN_STEPS),
                        "--device", "cuda"])
        wall = time.perf_counter() - t0
    steps, evals = rec["steps"], rec["evals"]
    model_dir = work / "logs" / "44k"
    records = [json.loads(ln) for ln in (model_dir / "metrics.jsonl").read_text().splitlines()]
    mel_l1 = {(r["step"], k): r[k] for r in records for k in r if k.startswith("eval/")}
    for i, (s, c, _) in enumerate(steps, 1):
        log("pipeline", what="GAN step", step=i, wall_s=f"{s:.4f}", rel_attention=c["rel_attention"],
            rel_attention_bwd=c["rel_attention_bwd"])
    for i, (s, c, _) in enumerate(evals):
        log("pipeline", what="evaluation", step=PIPELINE_EVAL_INTERVAL * (i + 1), wall_s=f"{s:.4f}",
            rel_attention=c["rel_attention"], resblock_trio=c["resblock_trio"])
    tb = sorted(p.name for p in model_dir.glob("events.out.tfevents*"))
    ckpts = sorted(p.name for p in model_dir.glob("*.pth"))
    want_evals = {(s, f"eval/mel_l1_{i}") for s in (2, 4) for i in (0, 1)}
    ok = (len(steps) == PIPELINE_GAN_STEPS and len(evals) == 2
          and all(c["rel_attention"] > 0 and c["rel_attention_bwd"] > 0 for _, c, _ in steps)
          and all(c["rel_attention"] == 12 and c["resblock_trio"] == 0 for _, c, _ in evals)
          and set(mel_l1) == want_evals and all(np.isfinite(v) for v in mel_l1.values())
          and ckpts == ["D_2.pth", "D_4.pth", "G_2.pth", "G_4.pth"])
    log("pipeline", what="cli.train", steps=len(steps), wall_s=f"{wall:.2f}",
        eval_mel_l1={f"{s}:{k[5:]}": f"{v:.4f}" for (s, k), v in sorted(mel_l1.items())},
        tensorboard_events=len(tb), checkpoints=ckpts, ok=ok)
    if not ok:
        raise AssertionError(f"[pipeline] GAN training: steps {steps}, evaluations {evals}, "
                             f"mel L1 {mel_l1}, checkpoints {ckpts}")


def pipeline_release(work: Path, encoder) -> None:
    """tools compress --half on G_4.pth, served by Svc (K1/K3 6/4) beside
    the uncompressed model in fp32 (log-mel L1 printed, not barred: the
    bf16 cast moves it); tools mix of G_2 and G_4 at 50/50 against their
    mean."""
    from sovits_tpu_torch.cli import tools
    from sovits_tpu_torch.dsp.stft import mel_spectrogram
    from sovits_tpu_torch.infer.svc import Svc

    model_dir, config = work / "logs" / "44k", str(work / "configs" / "config.json")
    release = tools.main(["compress", "-i", str(model_dir / "G_4.pth"), "-o", str(work / "release.pth"),
                          "--half"])
    sr = json.loads(Path(config).read_text())["data"]["sampling_rate"]
    clip = bench_signal(3.0, sr, seed=83, base_hz=180.0)
    audio, counts = {}, {}
    for name, path in (("compressed", release), ("G_4", model_dir / "G_4.pth")):
        svc = Svc(str(path), config, encoder=encoder, device="cuda")
        before = _counts()
        audio[name] = svc.infer("alto", 0, clip, sr=sr, f0_predictor="dio")[0]
        counts[name] = _launched(before)
        del svc
    mels = [mel_spectrogram(torch.from_numpy(audio[k])[None]) for k in ("compressed", "G_4")]
    l1 = (mels[0] - mels[1]).abs().mean().item()
    ok = (counts["compressed"]["rel_attention"] == 6 and counts["compressed"]["resblock_trio"] == 4
          and np.isfinite(audio["compressed"]).all())
    log("pipeline", what="compress --half, 3 s request", size_mb=f"{release.stat().st_size / 1e6:.1f}",
        g4_mb=f"{(model_dir / 'G_4.pth').stat().st_size / 1e6:.1f}",
        rel_attention=counts["compressed"]["rel_attention"],
        resblock_trio=counts["compressed"]["resblock_trio"],
        mel_l1_vs_fp32_g4=f"{l1:.4e}", ok=ok)
    if not ok:
        raise AssertionError(f"[pipeline] the compressed model's request: {counts}")
    mixed = tools.main(["mix", "-i", str(model_dir / "G_2.pth"), str(model_dir / "G_4.pth"),
                        "-r", "50", "50", "-o", str(work / "mix.pth")])
    sds = [torch.load(p, map_location="cpu", weights_only=False)["model"]
           for p in (mixed, model_dir / "G_2.pth", model_dir / "G_4.pth")]
    err = max(((sds[0][k].double() - (sds[1][k].double() + sds[2][k].double()) / 2).abs().max()
               / sds[0][k].double().abs().max().clamp_min(1e-30)).item() for k in sds[0])
    ok = set(sds[0]) == set(sds[1]) and err <= 1e-6
    log("pipeline", what="mix G_2 G_4 at 50/50 against their mean", tensors=len(sds[0]),
        max_rel_err=f"{err:.3e}", ok=ok)
    if not ok:
        raise AssertionError(f"[pipeline] mix is not the mean: {err}")


def pipeline_diffusion(work: Path) -> Path:
    """cli.train_diff at the template for DIFF_STEPS steps, then a resume to
    DIFF_RESUME_STEPS: steps/s after 10 warm-up steps, peak memory, the
    logged losses, val_rtf, the kept checkpoints, and step
    DIFF_PROFILED_STEP under the profiler (from its loss to the next
    step's: forward, backward, AdamW, the loss read back, the next batch
    assembled) with its wall, device-busy share and top 5 kernels; every
    loss finite, the last 20 steps' mean loss below the first 20's, the
    resumed run on steps 201-210 only. Returns model_200.pt."""
    from sovits_tpu_torch.cli import train_diff
    from sovits_tpu_torch.train import diffusion as tdiff
    from sovits_tpu_torch.train.checkpoint import checkpoint_paths

    config = str(work / "configs" / "diffusion.yaml")
    args = tdiff.load_diffusion_config(config)
    expdir = Path(args.env.expdir)
    steps, window = [], {}
    real = tdiff._loss

    def loss_spy(model, batch, generator, *rest):
        if model.training and len(steps) + 1 == DIFF_PROFILED_STEP:
            window["started"] = _profile_start()
        elif model.training and len(steps) == DIFF_PROFILED_STEP:
            window["result"] = _profile_stop(window.pop("started"))
        t = time.perf_counter()
        loss = real(model, batch, generator, *rest)
        if model.training:
            steps.append((t, loss.detach()))
        return loss

    tdiff._loss = loss_spy
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        train_diff.main(["-c", config, "--max-steps", str(DIFF_STEPS), "--device", "cuda"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_first = len(steps)
        before = len((expdir / "metrics.jsonl").read_text().splitlines())
        t0 = time.perf_counter()
        train_diff.main(["-c", config, "--max-steps", str(DIFF_RESUME_STEPS), "--device", "cuda"])
        resume_wall = time.perf_counter() - t0
    finally:
        tdiff._loss = real
        if "started" in window:
            window.pop("started")[0].stop()
    losses = [float(v) for _, v in steps]
    records = [json.loads(ln) for ln in (expdir / "metrics.jsonl").read_text().splitlines()]
    resumed = sorted({r["step"] for r in records[before:]})
    rate = (100 - 11) / (steps[99][0] - steps[10][0])  # steps 11-100: no save or validation between
    kept = [p.name for p in checkpoint_paths(expdir, "model", ".pt")]
    log("pipeline", what="cli.train_diff", steps=n_first, wall_s=f"{wall:.2f}",
        steps_per_s_after_10=f"{rate:.3f}", peak_mem_gb=f"{peak / 1e9:.3f}",
        batch=args.train.batch_size, frames=int(args.data.duration * args.data.sampling_rate / args.data.block_size),
        layers=args.model.n_layers, chans=args.model.n_chans)
    wall_s, busy, dev = window["result"]
    log("pipeline", what=f"train_diffusion's step {DIFF_PROFILED_STEP} profiled", wall_ms=f"{1e3 * wall_s:.2f}",
        device_busy_ms=f"{busy:.2f}", busy_share=f"{busy / (1e3 * wall_s):.4f}")
    for key, us in sorted(dev.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    device {us / 1e3:9.3f} ms  {key[:110]}", flush=True)
    log("pipeline", what="diffusion losses",
        logged={r["step"]: f"{r['loss/diffusion']:.4f}" for r in records if "loss/diffusion" in r},
        val={r["step"]: (f"{r['loss/val_diffusion']:.4f}", f"{r['val_rtf']:.5f}")
             for r in records if "val_rtf" in r},
        mean_1_20=f"{np.mean(losses[:20]):.4f}", mean_181_200=f"{np.mean(losses[180:200]):.4f}")
    ok = (n_first == DIFF_STEPS and len(steps) == DIFF_RESUME_STEPS and np.isfinite(losses).all()
          and np.mean(losses[180:200]) < np.mean(losses[:20]) and resumed and min(resumed) > DIFF_STEPS
          and max(resumed) == DIFF_RESUME_STEPS
          and kept == ["model_100.pt", "model_200.pt", "model_210.pt"])
    log("pipeline", what="resume", resumed_steps=len(steps) - n_first, logged_steps=resumed,
        resume_wall_s=f"{resume_wall:.2f}", checkpoints=kept, ok=ok)
    if not ok:
        raise AssertionError(f"[pipeline] diffusion training: {n_first} + {len(steps) - n_first} steps, "
                             f"losses {losses[:3]}...{losses[-3:]}, resumed {resumed}, kept {kept}")
    return expdir / f"model_{DIFF_STEPS}.pt"


def _mels(args) -> int:
    from sovits_tpu_torch.models.diffusion.vocoder import NsfHifiGANVocoder

    return NsfHifiGANVocoder(str(args.vocoder.ckpt), device="cpu", weights=False).dimension


def _relu_branches(model, sides: dict | None = None) -> tuple[dict, list]:
    """Forward hooks on the inputs of the denoiser's two ReLUs (after
    input_projection and skip_projection, wavenet.py). Without ``sides``
    they record which elements are > 0. With another device's record they
    move each element that lies on the other side of 0 to that side (value
    0 or the smallest normal float, gradient passed on as is), so that both
    devices take the same branch, and record per ReLU how many moved and
    the largest |value| among them over the input's peak |value|. Returns
    (the record, the hooks' handles)."""
    record, handles = {}, []

    def hook(name):
        def run(module, args, out):
            if sides is None:
                record[name] = out > 0
                return None
            want = sides[name].to(out.device)
            moved = want != (out > 0)
            record[name] = (int(moved.sum()),
                            ((out.abs() * moved).max() / out.abs().max().clamp_min(1e-30)).item())
            target = torch.where(want, torch.finfo(out.dtype).tiny, 0.0)
            return torch.where(moved, target + (out - out.detach()), out)  # the value target, d/dout 1
        return run

    for name in ("input_projection", "skip_projection"):
        handles.append(model.decoder["denoise_fn"].get_submodule(name).register_forward_hook(hook(name)))
    return record, handles


def diffusion_card_vs_cpu(config: str, ckpt: Path) -> None:
    """One diffusion step at batch DIFF_CARD_BATCH on the card and on the
    CPU: the same examples, steps and noise (one CPU generator seed) and the
    same ReLU branches (the CPU takes the card's, ``_relu_branches``), fp32
    with TF32 off. An element within rounding of 0 can fall on the other
    side of a ReLU on each device, and then one side's gradient carries it
    and the other's does not (PERF.md §7). Loss within DIFF_LOSS_REL
    relative, every gradient within DIFF_GRAD_REL of its tensor's peak,
    every moved element within DIFF_GRAD_REL of its ReLU input's peak."""
    from sovits_tpu_torch.train import diffusion as tdiff

    args = tdiff.load_diffusion_config(config)
    ds = tdiff.DiffusionDataset(args.data.training_files, args)
    rng = np.random.default_rng(4)
    examples = [ds.example(i, rng) for i in range(DIFF_CARD_BATCH)]
    out, record = {}, None
    for dev in ("cuda", "cpu"):  # record: the card's sides, then what the CPU moved
        model = tdiff.load_torch_unit2mel(ckpt, args, _mels(args), dev).train()
        record, handles = _relu_branches(model, record)
        loss = tdiff._loss(model, tdiff._batch(examples, torch.device(dev)), torch.Generator().manual_seed(9))
        loss.backward()
        for h in handles:
            h.remove()
        out[dev] = (loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    card = out["cuda"]
    loss_rel = abs(card[0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst = sorted((((g - out["cpu"][1][k]).abs().max() / out["cpu"][1][k].abs().max().clamp_min(1e-30)).item(),
                    k, out["cpu"][1][k].abs().max().item()) for k, g in card[1].items())[::-1]
    grad_rel = worst[0][0]
    ok = (loss_rel <= DIFF_LOSS_REL and grad_rel <= DIFF_GRAD_REL
          and all(v <= DIFF_GRAD_REL for _, v in record.values()))
    log("pipeline", what=f"diffusion step, batch {DIFF_CARD_BATCH}, card vs CPU", loss=f"{out['cpu'][0]:.6f}",
        loss_rel=f"{loss_rel:.3e}", grad_rel_max=f"{grad_rel:.3e}",
        worst={k: (f"{r:.3e}", f"peak {peak:.3e}") for r, k, peak in worst[:3]},
        relu_moved={k: (n, f"{v:.2e}") for k, (n, v) in record.items()},
        limits=f"loss<={DIFF_LOSS_REL}, grad<={DIFF_GRAD_REL}, moved<={DIFF_GRAD_REL}", ok=ok)
    if not ok:
        raise AssertionError(f"[pipeline] diffusion step card vs CPU: loss {loss_rel}, grad {grad_rel}, "
                             f"moved {record}")


def phase_pipeline(tmp: Path, svc) -> dict:
    """The training pipeline through its CLIs, as a user runs it: resample
    (48 kHz stereo -> 44.1 kHz mono), filelists and config, features with
    --use_diff, GAN training with evaluation, release (compress, mix),
    diffusion training (one step profiled) and a resume, one diffusion step
    held against the CPU, and the trained diffusion model served by Svc with
    shallow diffusion (K1/K3 6/8). Under PIPELINE_LIMIT_S. Returns the
    phase's K1/K2/K3 launches."""
    from sovits_tpu_torch.cli import resample
    from sovits_tpu_torch.infer.svc import Svc

    t_phase = time.perf_counter()

    def run():
        work = tmp / "pipeline"
        _reset_counts()
        audio_s = pipeline_corpus(work / "dataset_raw")
        t0 = time.perf_counter()
        n = resample.main(["--in_dir", str(work / "dataset_raw"), "--out_dir2", str(work / "dataset" / "44k"),
                           "--sr2", str(svc.target_sample), "--workers", "2"])
        log("pipeline", what="resample 48 kHz stereo -> 44.1 kHz mono", files=n, audio_s=f"{audio_s:.1f}",
            wall_s=f"{time.perf_counter() - t0:.2f}")
        pipeline_features(work, tmp)
        pipeline_gan(work)
        pipeline_release(work, svc.encoder)
        config = str(work / "configs" / "diffusion.yaml")
        ckpt = pipeline_diffusion(work)
        diffusion_card_vs_cpu(config, ckpt)
        shallow = Svc(str(work / "logs" / "44k" / "G_4.pth"), str(work / "configs" / "config.json"),
                      encoder=svc.encoder, device="cuda", shallow_diffusion=True,
                      diffusion_model_path=str(ckpt), diffusion_config_path=config)
        before = _counts()
        sr = svc.target_sample
        audio = shallow.infer("tenor", 0, bench_signal(3.0, sr, seed=84, base_hz=140.0), sr=sr,
                              f0_predictor="dio", k_step=K_STEP)[0]
        c = _launched(before)
        ok = np.isfinite(audio).all() and c["rel_attention"] == 6 and c["resblock_trio"] == 8
        log("pipeline", what=f"model_{DIFF_STEPS}.pt served, shallow diffusion k_step {K_STEP}, 3 s",
            samples=len(audio), peak=f"{np.abs(audio).max():.4f}", rel_attention=c["rel_attention"],
            resblock_trio=c["resblock_trio"], ok=ok)
        if not ok:
            raise AssertionError(f"[pipeline] shallow diffusion with the trained model: {c}")
        return _counts()

    counts = _limited("pipeline", PIPELINE_LIMIT_S, run)
    log("pipeline", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=PIPELINE_LIMIT_S, launches=counts)
    return counts


# [surfaces], [export], [learning]: the HTTP API over a socket, the exported
# programs (torch.export .pt2, the ONNX synthesizer and diffusion artifacts),
# and the GAN learning proof (tests/test_learning.py's twin)
SURFACES_LIMIT_S = 240
EXPORT_LIMIT_S = 300
LEARNING_LIMIT_S = 300
DAW_RATE = 48000  # /voiceChangeModel answers at the caller's rate: a resample
EXPORT_FRAMES = 512
ONNX_FRAMES = 96
PT2_TOL = dict(rtol=1e-5, atol=1e-6)  # the loaded .pt2 against the live synthesizer, fp32
ONNX_MEL_L1 = 1e-3  # tests/test_onnx_export.py::test_onnx_fullsize_parity_mel_l1's bar
PLMS_TOL = dict(rtol=5e-4, atol=5e-4)  # tests/test_onnx_diffusion.py's PLMS replay bar
DISPATCH_CALLS = 2000
DISPATCH_ROUNDS = 10


def _noise_off():
    """Svc's synthesizer dispatch with the noise off (the tests' patch); returns its undo."""
    import functools

    from sovits_tpu_torch.infer.svc import Svc

    original = Svc._run_synth_batch
    Svc._run_synth_batch = functools.partialmethod(original, sample_noise=False)
    return lambda: setattr(Svc, "_run_synth_batch", original)


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    import io

    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def _int16(data: bytes) -> tuple[int, np.ndarray]:
    import io

    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(data))
    return sr, wav.astype(np.int32)


def _post(port: int, path: str, fields: dict) -> tuple[int, bytes, float]:
    """POST multipart ``fields`` to the API; (status, body, wall s)."""
    import http.client

    boundary = "smokeboundary"
    parts = []
    for name, value in fields.items():
        parts.append(f"--{boundary}\r\n".encode())
        if isinstance(value, bytes):
            parts += [f'Content-Disposition: form-data; name="{name}"; filename="in.wav"\r\n'
                      "Content-Type: audio/wav\r\n\r\n".encode(), value]
        else:
            parts += [f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode(), str(value).encode()]
        parts.append(b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SURFACES_LIMIT_S)
    t0 = time.perf_counter()
    conn.request("POST", path, b"".join(parts), {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    resp = conn.getresponse()
    body = resp.read()
    wall = time.perf_counter() - t0
    conn.close()
    return resp.status, body, wall


def phase_surfaces(svc) -> dict:
    """serving/api.py on 127.0.0.1 with the full-width fp32 Svc of [main]:
    the 10 s clip to /voiceChangeModel raw and through RealTimeVC (answered
    at DAW_RATE), the 59.5 s song to /wav2wav, each twice (the first
    request on a server's worker thread builds that thread's cuDNN plans);
    each 200 response against the direct call's int16 wav with the noise
    off on both sides (equal, or 1 LSB where a resample rounds), its wall
    over HTTP and direct, the server's stage seconds, and its K1/K3
    launches (6 and 4 per synthesizer dispatch). Under SURFACES_LIMIT_S.
    Returns the phase's launches."""
    import threading

    from sovits_tpu_torch.infer.svc import RealTimeVC
    from sovits_tpu_torch.serving import api

    t_phase = time.perf_counter()
    sr = svc.target_sample
    clip, whole = bench_signal(SECONDS, sr), song(sr)

    def run():
        undo = _noise_off()
        servers = []
        try:
            for raw in (True, False):
                srv = api.make_server(svc, "127.0.0.1", 0, raw_infer=raw, f0_predictor="dio")
                threading.Thread(target=srv.serve_forever, daemon=True).start()
                servers.append(srv)
            realtime = RealTimeVC()
            voice = {"sample": _wav_bytes(clip, sr), "fPitchChange": 0, "sampleRate": DAW_RATE, "sSpeakId": 0}
            song_fields = {"audio": _wav_bytes(whole, sr), "tran": 0, "spk": 0}
            wav_clip = api.wav_bytes_to_array(voice["sample"])[0]
            wav_song = api.wav_bytes_to_array(song_fields["audio"])[0]
            requests = [
                ("voiceChangeModel raw 10 s", servers[0], "/voiceChangeModel", voice, DAW_RATE,
                 lambda: svc.infer(0, 0, wav_clip, sr=sr, f0_predictor="dio")[0]),
                ("voiceChangeModel RealTimeVC 10 s", servers[1], "/voiceChangeModel", voice, DAW_RATE,
                 lambda: realtime.process(svc, 0, 0, wav_clip, sr, f0_predictor="dio")),
                ("wav2wav 59.5 s song", servers[0], "/wav2wav", song_fields, sr,
                 lambda: svc.slice_inference(wav_song, sr, 0, 0, slice_db=-40, f0_predictor="dio")),
            ]
            _reset_counts()
            for what, srv, path, fields, out_sr, direct in requests:
                for call in ("first", "warm"):  # the first on a server's worker thread plans its convs
                    before = _counts()
                    stages_before = srv.timer.summary()
                    status, body, http_wall = _post(srv.server_address[1], path, fields)
                    torch.cuda.synchronize()
                    c_http = _launched(before)
                    server_ms = {k: 1e3 * (v["total_s"] - stages_before.get(k, {"total_s": 0.0})["total_s"])
                                 for k, v in srv.timer.summary().items()}
                    if status != 200:
                        raise AssertionError(f"[surfaces] {what}: HTTP {status} {body[:300]!r}")
                    before = _counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = direct()
                    if out_sr != sr:
                        out = api.resample(np.asarray(out), sr, out_sr)
                    want = api.array_to_wav_bytes(out, out_sr)
                    direct_wall = time.perf_counter() - t0
                    c_direct = _launched(before)
                    (got_sr, got), (want_sr, want) = _int16(body), _int16(want)
                    diff = np.abs(got - want).max() if got.shape == want.shape else None
                    k1, k3 = c_http["rel_attention"], c_http["resblock_trio"]
                    ok = (got_sr == want_sr == out_sr and diff is not None and diff <= 1 and k1 > 0
                          and k1 % 6 == 0 and k3 == k1 // 6 * 4 and c_direct == c_http)
                    log("surfaces", request=repr(what), call=call, status=status, samples=len(got), rate=got_sr,
                        http_wall_s=f"{http_wall:.4f}", direct_wall_s=f"{direct_wall:.4f}",
                        http_over_direct_ms=f"{1e3 * (http_wall - direct_wall):.2f}",
                        max_lsb_diff=diff, lsb_off=int((got != want).sum()) if diff is not None else None,
                        rel_attention=k1, resblock_trio=k3, peak=f"{np.abs(got).max() / 32767:.4f}", ok=ok)
                    log("surfaces", request=repr(what), call=call,
                        server_stage_ms={k: f"{v:.2f}" for k, v in server_ms.items()},
                        server_ms=f"{sum(server_ms.values()):.2f}",
                        outside_server_ms=f"{1e3 * http_wall - sum(server_ms.values()):.2f}")
                    if not ok:
                        raise AssertionError(f"[surfaces] {what}: {diff} LSB, launches {c_http} / {c_direct}")
            status, body, _ = _post(servers[0].server_address[1], "/nowhere", {"x": 1})
            if status != 404:
                raise AssertionError(f"[surfaces] a wrong path answered {status}")
            return _counts()
        finally:
            undo()
            for srv in servers:
                srv.shutdown()
                srv.server_close()

    counts = _limited("surfaces", SURFACES_LIMIT_S, run)
    log("surfaces", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=SURFACES_LIMIT_S, launches=counts)
    return counts


def _synth_inputs(hps, t: int, seed: int) -> tuple:
    """Seeded Synthesizer.infer inputs on the card: units, f0 with an
    unvoiced head, uv, speaker 0."""
    g = torch.Generator().manual_seed(seed)
    c = 0.3 * torch.randn(1, t, hps.model.ssl_dim, generator=g)
    f0 = 100.0 + 300.0 * torch.rand(1, t, generator=g)
    f0[:, :3] = 0.0
    return tuple(x.cuda() for x in (c, f0, (f0 > 0).float(), torch.zeros(1, dtype=torch.long)))


def _walls(fns: dict, reps: int = 5) -> dict:
    """Median synchronised wall (s) of each callable, taken in turns."""
    walls = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in walls.items()}


def dispatch_cost(calls: int = DISPATCH_CALLS) -> dict:
    """Host microseconds per K1 and K3 launch through the sovits operator
    against the direct launch it wraps (``_launch_fwd`` / ``_launch``), at
    shapes small enough that the host, not the card, sets the pace: calls
    queued back to back, timed between synchronises, in turns."""
    from sovits_tpu_torch.ops import attention as A
    from sovits_tpu_torch.ops import fused_stage as S

    g = torch.Generator().manual_seed(77)
    q, k, v = (torch.randn(2, 128, 96, generator=g).cuda() for _ in range(3))
    rk, rv = (0.1 * torch.randn(9, 96, generator=g).cuda() for _ in range(2))
    km = torch.ones(2, 128, device="cuda")
    x = torch.randn(1, 256, 16, generator=g).cuda()
    ks = [0.05 * torch.randn(kk, 16, 16, generator=g).cuda() for kk in (3, 7, 11) for _ in range(6)]
    bs = [torch.zeros(16, device="cuda") for _ in range(18)]
    dils = ((1, 3, 5),) * 3
    fns = {
        "k1_op": lambda: A.rel_attention_fwd(q, k, v, rk, rv, km, None, 4, False, False),
        "k1_direct": lambda: A._launch_fwd(q, k, v, rk, rv, km, None, 4, False, False),
        "k3_op": lambda: S.resblock_trio(x, ks, bs, [3, 7, 11], [1, 3, 5] * 3, [3, 3, 3]),
        "k3_direct": lambda: S._launch(x, ks, bs, (3, 7, 11), dils),
    }
    us = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(3):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            us[name].append(1e6 * host / calls)
    out = {name: min(v) for name, v in us.items()}
    out["k1_dispatch_us"] = out["k1_op"] - out["k1_direct"]
    out["k3_dispatch_us"] = out["k3_op"] - out["k3_direct"]
    return out


@contextlib.contextmanager
def _direct_launches():
    """K1's forward and K3 launched straight through ``_launch_fwd`` /
    ``_launch``, past the sovits operators (the modules' ``_forward``
    patched), for the block."""
    from sovits_tpu_torch.ops import attention as A
    from sovits_tpu_torch.ops import fused_stage as S

    def k1(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal, want_lse):
        out, lse = A._launch_fwd(q, k, v, rel_k, rel_v, key_mask, drop_mask,
                                 -1 if window is None else window, causal, want_lse)
        return out, lse if want_lse else None

    saved = A._forward, S._forward
    A._forward, S._forward = k1, S._launch
    try:
        yield
    finally:
        A._forward, S._forward = saved


def dispatch_ab(svc, rounds: int = DISPATCH_ROUNDS) -> dict:
    """The fp32 10 s request of [main] (Svc.infer) and its synthesizer
    dispatch alone, with K1 and K3 launched through the sovits operators and
    then straight (:func:`_direct_launches`), in turns, in one process:
    median and min ms of each, and the K1/K3 launches of one request by
    either route."""
    sr = svc.target_sample
    clip = bench_signal(SECONDS, sr)
    item = svc._prepare_chunk(0, 0, clip, sr, 0.0, False, "dio", 0.05)
    fns = {"request": lambda: svc.infer(0, 0, clip, sr=sr, f0_predictor="dio"),
           "synth": lambda: svc._run_synth_batch([item], 0.4, False, 52468)}
    ms = {f"{k}_{route}": [] for k in fns for route in ("op", "direct")}
    launches = {}
    for _ in range(rounds + 1):  # the first round warms up and is dropped
        for route in ("op", "direct"):
            with contextlib.ExitStack() as stack:
                if route == "direct":
                    stack.enter_context(_direct_launches())
                for k, fn in fns.items():
                    before = _counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ms[f"{k}_{route}"].append(1e3 * (time.perf_counter() - t0))
                    if k == "request":
                        launches[route] = _launched(before)
    out = {}
    for k, v in ms.items():
        out[f"{k}_median_ms"] = float(np.median(v[1:]))
        out[f"{k}_min_ms"] = float(np.min(v[1:]))
    for k in fns:
        out[f"{k}_op_minus_direct_median_ms"] = out[f"{k}_op_median_ms"] - out[f"{k}_direct_median_ms"]
    if launches["op"] != launches["direct"] or launches["op"]["rel_attention"] != 6:
        raise AssertionError(f"[export] the two routes launched {launches}")
    return out


def _kernel_profile(fn) -> dict:
    """Wall ms, device busy ms and device kernels of one call of fn under
    torch.profiler (ending in a synchronize)."""
    prof, t0 = _profile_start()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and (getattr(e, "self_device_time_total", 0) or 0) > 0]
    return {"wall_ms": f"{1e3 * wall:.3f}", "busy_ms": f"{sum(e.self_device_time_total for e in cuda) / 1e3:.3f}",
            "kernels": sum(e.count for e in cuda)}


def phase_export(tmp: Path, svc) -> dict:
    """The full-width synthesizer of [main] exported on the card by
    torch.export at EXPORT_FRAMES, saved, loaded and run: it must match the
    live Synthesizer.infer (PT2_TOL) and launch K1 and K3; export seconds,
    .pt2 MB and the walls of the exported program and the live one. The
    ONNX synthesizer from the same model, run through the port's runtime on
    the card at ONNX_FRAMES: log-mel L1 against Synthesizer.infer <
    ONNX_MEL_L1. The four diffusion artifacts of the [diffusion] template
    written by the export CLI on the card, and the PLMS loop replayed
    through them against the port's sample_plms. The sovits operators'
    dispatch cost per launch. Under EXPORT_LIMIT_S. Returns the launches of
    the exported program's calls."""
    from sovits_tpu_torch.cli import export as export_cli
    from sovits_tpu_torch.dsp.stft import mel_spectrogram
    from sovits_tpu_torch.export.onnx_run import Session
    from sovits_tpu_torch.export.onnx_synth import build_synthesizer_onnx

    t_phase = time.perf_counter()
    hps, model = svc.hps, svc.model
    out_dir = tmp / "export"
    out_dir.mkdir()

    def run():
        t0 = time.perf_counter()
        program = export_cli.export_program(model, hps, EXPORT_FRAMES)
        export_s = time.perf_counter() - t0
        path = out_dir / "model.pt2"
        t0 = time.perf_counter()
        torch.export.save(program, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        call = export_cli.load_exported(str(path))
        load_s = time.perf_counter() - t0
        ops = sorted({str(n.target) for n in program.graph.nodes if "sovits" in str(n.target)})
        args = _synth_inputs(hps, EXPORT_FRAMES, seed=90)
        _reset_counts()
        with torch.no_grad():
            got = call(*args)
            torch.cuda.synchronize()
            counts = _counts()
            want = model.infer(*args, sample_noise=False)[0]
            walls = _walls({"exported": lambda: call(*args),
                            "live": lambda: model.infer(*args, sample_noise=False)}, reps=9)
            profiles = {"exported": _kernel_profile(lambda: call(*args)),
                        "live": _kernel_profile(lambda: model.infer(*args, sample_noise=False))}
        err = (got - want).abs().max().item()
        ok = (torch.allclose(got, want, **PT2_TOL) and counts["rel_attention"] == 6
              and counts["resblock_trio"] == 4 and len(ops) == 2)
        log("export", what="torch.export of Synthesizer.infer", frames=EXPORT_FRAMES, ops=ops,
            export_s=f"{export_s:.2f}", save_s=f"{save_s:.2f}", load_s=f"{load_s:.2f}",
            pt2_mb=f"{path.stat().st_size / 1e6:.1f}", rel_attention=counts["rel_attention"],
            resblock_trio=counts["resblock_trio"], max_abs_err=f"{err:.3e}",
            tol=f"rtol {PT2_TOL['rtol']} atol {PT2_TOL['atol']}",
            exported_wall_ms=f"{1e3 * walls['exported']:.3f}", live_wall_ms=f"{1e3 * walls['live']:.3f}",
            peak=f"{want.abs().max().item():.4f}", ok=ok)
        saved = list(program.state_dict)
        log("export", what="one call of each under torch.profiler", **profiles,
            graph_nodes=sum(n.op == "call_function" for n in program.graph.nodes), state_tensors=len(saved),
            weight_norm_params=sum(k.endswith(("weight_g", "weight_v")) for k in saved))
        if not ok:
            raise AssertionError(f"[export] the loaded .pt2: err {err}, launches {counts}, ops {ops}")

        t0 = time.perf_counter()
        mb = build_synthesizer_onnx(model, hps, chara_mix=False)
        build_s = time.perf_counter() - t0
        c, f0, uv, spk = _synth_inputs(hps, ONNX_FRAMES, seed=91)
        feeds = {"c": c.cpu().numpy(), "f0": f0.cpu().numpy(), "uv": uv.cpu().numpy(),
                 "mel2ph": np.arange(1, ONNX_FRAMES + 1, dtype=np.int64)[None],
                 "noise": np.zeros((1, hps.model.inter_channels, ONNX_FRAMES), np.float32),
                 "sid": np.zeros((1,), np.int64)}
        t0 = time.perf_counter()
        session = Session(mb, "cuda")
        audio = session(feeds)["audio"][0, 0]
        onnx_s = time.perf_counter() - t0
        with torch.no_grad():
            ref = model.infer(c, f0, uv, spk, sample_noise=False)[0][0, :, 0].cpu().numpy()
        d = hps.data
        mel_kw = dict(n_fft=d.filter_length, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
                      hop_length=d.hop_length, win_length=d.win_length, fmin=d.mel_fmin, fmax=d.mel_fmax)
        mels = [mel_spectrogram(torch.from_numpy(a[None]), **mel_kw) for a in (audio, ref)]
        l1 = (mels[0] - mels[1]).abs().mean().item()
        ok = audio.shape == ref.shape and np.isfinite(audio).all() and l1 < ONNX_MEL_L1
        log("export", what="ONNX synthesizer, port runtime on the card", frames=ONNX_FRAMES,
            onnx_mb=f"{len(mb) / 1e6:.1f}", nodes=len(session.graph.nodes), build_s=f"{build_s:.2f}",
            load_and_run_s=f"{onnx_s:.2f}", max_abs=f"{np.abs(audio - ref).max():.3e}",
            mel_l1=f"{l1:.3e}", limit=ONNX_MEL_L1, ok=ok)
        if not ok:
            raise AssertionError(f"[export] ONNX synthesizer: log-mel L1 {l1}")

        files = tmp / "diffusion"
        prefix = out_dir / "diffusion"
        t0 = time.perf_counter()
        export_cli.main(["-m", str(files / "model_0.pt"), "-c", str(files / "config.yaml"),
                         "-o", f"{prefix}.onnx", "--onnx", "--diffusion", "-d", "cuda"])
        cli_s = time.perf_counter() - t0
        unit2mel = export_cli.load_unit2mel(str(files / "model_0.pt"), str(files / "config.yaml"), "cuda")
        graphs = {k: Session((out_dir / f"diffusion_{k}.onnx").read_bytes(), "cuda")
                  for k in ("encoder", "denoise", "pred", "after")}
        t = 100
        g = torch.Generator().manual_seed(92)
        enc_feeds = {"hubert": (0.3 * torch.randn(1, t, unit2mel.unit_embed.in_features, generator=g)).numpy(),
                     "mel2ph": np.arange(1, t + 1, dtype=np.int64)[None],
                     "f0": (100.0 + 300.0 * torch.rand(1, t, generator=g)).numpy(),
                     "volume": (0.1 * torch.rand(1, t, generator=g)).numpy()}
        cond = graphs["encoder"](enc_feeds)["mel_pred"]
        x0 = torch.randn(1, 1, unit2mel.out_dims, t, generator=g).numpy()
        t0 = time.perf_counter()
        got = plms_via_onnx(graphs, x0, cond, K_STEP, 10)
        replay_s = time.perf_counter() - t0
        sched = unit2mel.schedule
        with torch.no_grad():
            f = {k: torch.from_numpy(v).cuda() for k, v in enc_feeds.items() if k != "mel2ph"}
            cond_ref = unit2mel.condition(f["hubert"], f["f0"], f["volume"]).transpose(1, 2)
            x = sched.sample_plms(unit2mel.decoder["denoise_fn"], torch.from_numpy(x0[:, 0]).cuda(), K_STEP,
                                  10, torch.from_numpy(cond).cuda())
            want = sched.denorm_spec(x).cpu().numpy()
        cond_err = (torch.from_numpy(cond).cuda() - cond_ref).abs().max().item()
        err = np.abs(got - want).max()
        ok = np.allclose(got, want, **PLMS_TOL) and cond_err < 1e-4
        log("export", what="diffusion ONNX (CLI on the card) + PLMS replay against sample_plms",
            mb={k: f"{(out_dir / f'diffusion_{k}.onnx').stat().st_size / 1e6:.1f}" for k in graphs},
            cli_s=f"{cli_s:.2f}", frames=t, k_step=K_STEP, speedup=10, replay_s=f"{replay_s:.2f}",
            condition_max_abs=f"{cond_err:.3e}", mel_max_abs=f"{err:.3e}",
            tol=f"rtol {PLMS_TOL['rtol']} atol {PLMS_TOL['atol']}", ok=ok)
        if not ok:
            raise AssertionError(f"[export] PLMS replay: {err}, condition {cond_err}")
        cost = dispatch_cost()
        log("export", what=f"host us per launch, {DISPATCH_CALLS} back-to-back calls, best of 3",
            **{k: f"{v:.2f}" for k, v in cost.items()}, k1_per_request=6, k3_per_request=4,
            dispatch_per_10s_request_us=f"{6 * cost['k1_dispatch_us'] + 4 * cost['k3_dispatch_us']:.1f}")
        ab = dispatch_ab(svc)
        log("export", what=f"fp32 10 s request, operators against direct launches, {DISPATCH_ROUNDS} rounds in turns",
            **{k: f"{v:.3f}" for k, v in ab.items()})
        return counts

    counts = _limited("export", EXPORT_LIMIT_S, run)
    log("export", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=EXPORT_LIMIT_S, launches=counts)
    return counts


def plms_via_onnx(graphs: dict, x: np.ndarray, cond: np.ndarray, k_step: int, speedup: int) -> np.ndarray:
    """The MoeSS-side PLMS driver (so-vits-svc diffusion_onnx.py:494-559)
    over loaded denoise/pred/after sessions; returns the mel [1, M, T]."""
    def denoise(x, t):
        return graphs["denoise"]({"noise": x, "time": np.asarray([t], np.int64), "condition": cond})["noise_pred"]

    def x_pred(x, noise_pred, t, t_prev):
        return graphs["pred"]({"noise": x, "noise_pred": noise_pred, "time": np.asarray([t], np.int64),
                               "time_prev": np.asarray([t_prev], np.int64)})["noise_pred_o"]

    hist: list = []
    for stage, t in enumerate(range(k_step - speedup, -1, -speedup)):
        eps = denoise(x, t)
        t_prev = max(t - speedup, 0)
        if stage == 0:
            eps_prime = (eps + denoise(x_pred(x, eps, t, t_prev), t_prev)) / 2.0
        elif stage == 1:
            eps_prime = (3.0 * eps - hist[-1]) / 2.0
        elif stage == 2:
            eps_prime = (23.0 * eps - 16.0 * hist[-1] + 5.0 * hist[-2]) / 12.0
        else:
            eps_prime = (55.0 * eps - 59.0 * hist[-1] + 37.0 * hist[-2] - 9.0 * hist[-3]) / 24.0
        hist = (hist + [eps])[-3:]
        x = x_pred(x, eps_prime, t, t_prev)
    return graphs["after"]({"x": x})["mel_out"]


# a copy of tests/tiny.py's TINY_OVERRIDES (that module imports JAX)
LEARNING_TINY = {
    "train.segment_size": 256, "train.batch_size": 8, "data.sampling_rate": 8000,
    "data.filter_length": 128, "data.hop_length": 64, "data.win_length": 128,
    "data.n_mel_channels": 20, "data.mel_fmax": 4000, "data.pad_to_frames": 16,
    "model.inter_channels": 32, "model.hidden_channels": 32, "model.filter_channels": 64,
    "model.n_layers": 1, "model.upsample_rates": [4, 4, 4], "model.upsample_kernel_sizes": [8, 8, 8],
    "model.upsample_initial_channel": 32, "model.gin_channels": 16, "model.ssl_dim": 24,
    "model.n_speakers": 4, "model.n_flow_layer": 2,
    # tests/test_learning.py's
    "train.learning_rate": 8e-4, "model.disc_tiny": True,
}
LEARNING_STEPS = 300
LEARNING_FIRST, LEARNING_SECOND, LEARNING_WINDOW = 120, 60, 20


def learning_hps(**extra):
    from sovits_tpu_torch import config as scfg

    return scfg.default_config(**{**LEARNING_TINY, **extra})


def sine_batch(hps, b: int = 8, frames: int = 64, seed: int = 11) -> dict:
    """tests/test_learning.py's fixed overfit batch: pure sines, one
    frequency per item, seeded random units; on the card."""
    from sovits_tpu_torch.dsp.stft import spectrogram

    rng = np.random.default_rng(seed)
    d = hps.data
    t = np.arange(frames * d.hop_length) / d.sampling_rate
    freqs = 150.0 + 22.0 * np.arange(b)
    wav = (0.3 * np.sin(2 * np.pi * freqs[:, None] * t)).astype(np.float32)
    spec = spectrogram(torch.from_numpy(wav), d.filter_length, d.hop_length, d.win_length)
    batch = {"c": rng.standard_normal((b, frames, hps.model.ssl_dim)).astype(np.float32),
             "f0": np.repeat(freqs[:, None], frames, 1).astype(np.float32),
             "uv": np.ones((b, frames), np.float32), "spec": spec.numpy(), "wav": wav[..., None],
             "spk": np.arange(b) % hps.model.n_speakers, "lengths": np.full(b, frames),
             "volume": np.abs(wav).reshape(b, frames, d.hop_length).mean(-1)}
    return {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in batch.items()}


def write_learning_dataset(root: Path, hps, n_speakers: int = 2, n_per_spk: int = 3) -> None:
    """tests/tiny.py's make_synthetic_dataset in the port: 0.5 s sines at
    8 kHz with their f0, spectrogram, seeded units and volume; filelists
    (the last clip for validation) and the speakers into ``hps``."""
    from scipy.io import wavfile

    from sovits_tpu_torch import config as scfg
    from sovits_tpu_torch.dsp.stft import spectrogram

    rng = np.random.default_rng(0)
    d = hps.data
    n = int(d.sampling_rate * 0.5) // d.hop_length * d.hop_length
    frames, paths = n // d.hop_length, []
    for s in range(n_speakers):
        (root / f"spk{s}").mkdir(parents=True)
        for i in range(n_per_spk):
            freq = 150.0 + 50 * s + 10 * i
            wav = (0.3 * np.sin(2 * np.pi * freq * np.arange(n) / d.sampling_rate)).astype(np.float32)
            p = str(root / f"spk{s}" / f"clip{i}.wav")
            wavfile.write(p, d.sampling_rate, (wav * 32767).astype(np.int16))
            np.save(p + ".f0.npy", np.stack([np.full(frames, freq, np.float32), np.ones(frames, np.float32)]))
            spec = spectrogram(torch.from_numpy(wav)[None], d.filter_length, d.hop_length, d.win_length)
            np.save(p + ".spec.npy", spec[0].T.numpy())
            np.save(p + ".soft.npy", rng.standard_normal((hps.model.ssl_dim, frames)).astype(np.float32))
            np.save(p + ".vol.npy", np.abs(wav).reshape(frames, d.hop_length).mean(1).astype(np.float32))
            paths.append(p)
    (root / "train.txt").write_text("\n".join(paths[:-1]) + "\n")
    (root / "val.txt").write_text(paths[-1] + "\n")
    hps.data["training_files"], hps.data["validation_files"] = str(root / "train.txt"), str(root / "val.txt")
    hps["spk"] = scfg.HParams(**{f"spk{s}": s for s in range(n_speakers)})


def overfit_steps(phase: str, hps) -> dict:
    """tests/test_learning.py's proof on the card: LEARNING_STEPS fp32 GAN
    steps on one fixed sine batch at ``hps``: the last 25 steps' mean mel loss
    < 0.7 x the first 25's and the total < 0.8 x, the synthesis afterwards
    finite and not silent, K1 and K2 launched. Returns the steps' launches."""
    from sovits_tpu_torch.dsp.stft import mel_spectrogram
    from sovits_tpu_torch.models import factory
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    d = hps.data
    batch = sine_batch(hps)
    init = torch.Generator().manual_seed(0)
    net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False), init).cuda()
    net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"), init).cuda()
    opts = [make_optimizer(n.parameters(), hps) for n in (net_g, net_d)]
    mel_kw = dict(n_fft=d.filter_length, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
                  hop_length=d.hop_length, win_length=d.win_length, fmin=d.mel_fmin, fmax=d.mel_fmax)

    def synth():
        net_g.eval()
        with torch.no_grad():
            wav_hat = net_g.infer(batch["c"], batch["f0"], batch["uv"], batch["spk"], vol=batch["volume"],
                                  sample_noise=False)[0][..., 0]
        net_g.train()
        gt = mel_spectrogram(batch["wav"][..., 0], **mel_kw)
        got = mel_spectrogram(wav_hat, **mel_kw)
        tm = min(gt.shape[1], got.shape[1])
        return wav_hat, (gt[:, :tm] - got[:, :tm]).abs().mean().item()

    _, mel0 = synth()
    net_d.train()
    gen = torch.Generator(device="cuda")
    before = _counts()
    t0 = time.perf_counter()
    trace = []
    for i in range(LEARNING_STEPS):
        gen.manual_seed(3 + i)
        m = train_step(net_g, net_d, *opts, batch, hps, generator=gen)
        trace.append([m[k].item() for k in ("loss/g/total", "loss/g/mel", "loss/d/total")])
    steps_s = time.perf_counter() - t0
    counts = _launched(before)
    g_tot, g_mel, d_tot = np.asarray(trace).T
    wav_hat, mel1 = synth()
    wav_hat = wav_hat.float().cpu().numpy()
    k = LEARNING_STEPS // 12
    w0 = wav_hat[0] - wav_hat[0].mean()
    power = np.abs(np.fft.rfft(w0 * np.hanning(len(w0)))) ** 2 + 1e-20
    flatness = float(np.exp(np.mean(np.log(power))) / power.mean())
    peak = float(np.abs(wav_hat).max())
    ok = (np.isfinite(trace).all() and g_mel[-k:].mean() < 0.7 * g_mel[:k].mean()
          and g_tot[-k:].mean() < 0.8 * g_tot[:k].mean() and np.isfinite(wav_hat).all()
          and 1e-3 < peak < 10.0 and counts["rel_attention"] > 0 and counts["rel_attention_bwd"] > 0)
    log(phase, what=f"{LEARNING_STEPS} fp32 GAN steps on one sine batch (tests/test_learning.py)",
        steps_s=f"{steps_s:.2f}", step_ms=f"{1e3 * steps_s / LEARNING_STEPS:.2f}",
        g_mel_first=f"{g_mel[:k].mean():.4f}", g_mel_last=f"{g_mel[-k:].mean():.4f}",
        g_mel_ratio=f"{g_mel[-k:].mean() / g_mel[:k].mean():.4f}", limit_mel=0.7,
        g_total_ratio=f"{g_tot[-k:].mean() / g_tot[:k].mean():.4f}", limit_total=0.8,
        d_total_first=f"{d_tot[:k].mean():.4f}", d_total_last=f"{d_tot[-k:].mean():.4f}",
        eval_mel_l1_before=f"{mel0:.4f}", eval_mel_l1_after=f"{mel1:.4f}",
        synth_peak=f"{peak:.4f}", spectral_flatness=f"{flatness:.4f}",
        rel_attention=counts["rel_attention"], rel_attention_bwd=counts["rel_attention_bwd"], ok=ok)
    if not ok:
        raise AssertionError(f"[{phase}] the GAN did not learn: mel {g_mel[:k].mean()} -> "
                             f"{g_mel[-k:].mean()}, total {g_tot[:k].mean()} -> {g_tot[-k:].mean()}, "
                             f"peak {peak}, launches {counts}")
    return counts


def phase_learning(tmp: Path) -> dict:
    """overfit_steps at tests/test_learning.py's tiny config; then train() to
    LEARNING_FIRST steps on a synthetic dataset and resumed to LEARNING_FIRST
    + LEARNING_SECOND: the first window after the resume < 1.15 x the one
    before it, the tail <= 1.05 x. Under LEARNING_LIMIT_S. Returns its K1/K2
    launches."""
    from sovits_tpu_torch.train.trainer import train

    t_phase = time.perf_counter()

    def run():
        _reset_counts()
        overfit_steps("learning", learning_hps())

        hps = learning_hps(**{"train.log_interval": 1, "train.eval_interval": 10_000, "train.epochs": 10_000})
        write_learning_dataset(tmp / "learning" / "data", hps)
        model_dir = tmp / "learning" / "model"
        walls, before = [], _counts()
        for steps in (LEARNING_FIRST, LEARNING_FIRST + LEARNING_SECOND):
            t0 = time.perf_counter()
            train(hps, model_dir, max_steps=steps, device="cuda")
            walls.append(time.perf_counter() - t0)
        trained = _launched(before)
        recs = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text().splitlines()]
        mel = {r["step"]: r["loss/g/mel"] for r in recs if "loss/g/mel" in r}
        first, w = LEARNING_FIRST, LEARNING_WINDOW
        window = lambda lo: float(np.mean([mel[s] for s in range(lo, lo + w)]))  # noqa: E731
        head, pre, post = window(1), window(first - w + 1), window(first + 1)
        tail = window(first + LEARNING_SECOND - w + 1)
        ok = (sorted(mel) == list(range(1, first + LEARNING_SECOND + 1)) and post < pre * 1.15 + 1e-6
              and tail <= pre * 1.05 + 1e-6)
        log("learning", what=f"train() to {first} steps, resumed to {first + LEARNING_SECOND}",
            steps_logged=len(mel), first_run_s=f"{walls[0]:.2f}", resumed_run_s=f"{walls[1]:.2f}",
            head=f"{head:.4f}", pre=f"{pre:.4f}", post=f"{post:.4f}", tail=f"{tail:.4f}",
            pre_over_head=f"{pre / head:.4f}", post_over_pre=f"{post / pre:.4f}", limit_post=1.15,
            tail_over_pre=f"{tail / pre:.4f}", limit_tail=1.05,
            rel_attention=trained["rel_attention"], rel_attention_bwd=trained["rel_attention_bwd"], ok=ok)
        if not ok:
            raise AssertionError(f"[learning] the resume did not continue: pre {pre}, post {post}, tail {tail}")
        return _counts()

    counts = _limited("learning", LEARNING_LIMIT_S, run)
    log("learning", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=LEARNING_LIMIT_S, launches=counts)
    return counts


# [parallel]: the time-sharded decode (Svc.infer_seq_parallel, the shard-local
# decode at 4 and 8 shards, the infer CLI's -ss) and data-parallel and FSDP
# training over torch.distributed, at world size 1 over NCCL
PARALLEL_LIMIT_S = 240
SEAM_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_sequence_parallel.py's bar, fp32
PARALLEL_STEP_TOL = dict(rtol=1e-4, atol=1e-5)  # DDP / FSDP at world 1 against the plain step
PARALLEL_NOISE_SEED = 1234


def _seams_ok(got: np.ndarray, want: np.ndarray, edge: int, t_local: int, n: int) -> tuple[bool, float]:
    """Whether ``got`` matches ``want`` [S] within SEAM_TOL away from the
    song's edge zone and in a window over every seam; the worst error there."""
    keep = [slice(edge, len(want) - edge)] + [slice(s * t_local - 256, s * t_local + 256)
                                              for s in range(1, n)]
    ok = all(np.allclose(got[w], want[w], **SEAM_TOL) for w in keep)
    return ok, max(float(np.abs(got[w] - want[w]).max()) for w in keep)


def parallel_song(svc, svc16, wav: np.ndarray) -> dict:
    """The song through Svc.infer_seq_parallel (one shard at world 1) in
    fp32 against Synthesizer.infer on the same prepared item, with its wall
    beside slice_inference's, then in bf16 against the fp32 result."""
    from sovits_tpu_torch.dsp.stft import mel_spectrogram
    from sovits_tpu_torch.parallel.sequence import required_halo_frames

    sr, hop = svc.target_sample, svc.hop_size
    kw = dict(f0_predictor="dio", sample_noise=False, noice_scale=0.0)
    svc.infer_seq_parallel(0, 0, wav, sr, **kw)  # warm-up
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, n_samples, n_frames = svc.infer_seq_parallel(0, 0, wav, sr, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launched(before)
    t0 = time.perf_counter()
    svc.slice_inference(wav, sr, 0, 0, f0_predictor="dio")
    torch.cuda.synchronize()
    slice_wall = time.perf_counter() - t0
    item = svc._prepare_chunk(0, 0, wav, sr, 0.0, False, "dio", 0.05)
    put = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].cuda()  # noqa: E731
    mono, _ = svc.model.infer(put(item["c"]), put(item["f0"]), put(item["uv"]),
                              torch.tensor([0], device="cuda"), noise_scale=0.0, sample_noise=False)
    mono = mono[0, :, 0].float().cpu().numpy()
    edge = required_halo_frames(svc.model.dec) * hop
    ok, err = _seams_ok(audio, mono, edge, len(mono), 1)
    seconds = len(wav) / sr
    ok = ok and n_samples == n_frames * hop == len(mono) and np.isfinite(audio).all()
    log("parallel", what="song fp32 through infer_seq_parallel, world 1 over NCCL", seconds=f"{seconds:.2f}",
        frames=n_frames, wall_s=f"{wall:.4f}", rtf=f"{wall / seconds:.5f}",
        slice_inference_wall_s=f"{slice_wall:.4f}", slice_inference_rtf=f"{slice_wall / seconds:.5f}",
        max_abs_err_vs_monolithic=f"{err:.3e}", edge_zone_samples=edge, peak=f"{np.abs(audio).max():.4f}",
        rel_attention=launched["rel_attention"], resblock_trio=launched["resblock_trio"], ok=ok)
    if not ok or launched["rel_attention"] != 6 or launched["resblock_trio"] != 4:
        raise AssertionError(f"[parallel] infer_seq_parallel fp32: err {err}, launches {launched}")

    before = _counts()
    t0 = time.perf_counter()
    a16, _, _ = svc16.infer_seq_parallel(0, 0, wav, sr, **kw)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    launched16 = _launched(before)
    mel = lambda a: mel_spectrogram(torch.from_numpy(a)[None])  # noqa: E731
    m32, m16 = mel(audio), mel(a16)
    loud = m32 > m32.max() - LOUD_DB / 20 * np.log(10)
    l1_loud = (m16 - m32).abs()[loud].mean().item()
    rel = np.abs(a16 - audio).max() / np.abs(audio).max()
    ok = l1_loud < MEL_L1_BF16 and rel <= E2E_REL and launched16["resblock_trio_bf16"] == 4
    log("parallel", what="song bf16 through infer_seq_parallel vs fp32", wall_s=f"{wall16:.4f}",
        mel_l1_loud_bins=f"{l1_loud:.4e}", wave_rel_max_abs=f"{rel:.3e}",
        limits=f"loud-bin L1<{MEL_L1_BF16}, wave<={E2E_REL}", rel_attention_bf16=launched16["rel_attention_bf16"],
        resblock_trio_bf16=launched16["resblock_trio_bf16"], ok=ok)
    if not ok:
        raise AssertionError(f"[parallel] bf16 song: loud-bin L1 {l1_loud}, wave {rel}, {launched16}")
    return {"wall_s": wall, "slice_wall_s": slice_wall, "seconds": seconds}


def parallel_seams(svc, wav: np.ndarray) -> None:
    """The shard-local decode (parallel.sequence.decode_local) for n = 4 and
    8 shards of the song in turn, each on its haloed slice of the whole
    latent with the phase prefix from the per-shard sums, against the
    monolithic decode of a standalone decoder (factory.build_decoder,
    loaded from the synthesizer's): noise off, then noise on with one seed.
    Each shard must launch K3."""
    from sovits_tpu_torch.models import factory
    from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio
    from sovits_tpu_torch.parallel.sequence import decode_local, phase_sum, required_halo_frames

    sr = svc.target_sample
    dec = factory.build_decoder(svc.hps, "cuda")
    dec.load_state_dict(svc.model.dec.state_dict(), strict=True)
    item = svc._prepare_chunk(0, 0, wav, sr, 0.0, False, "dio", 0.05)
    halo, upp = required_halo_frames(dec), dec.upp
    def noise(seed):
        return None if seed is None else torch.Generator("cuda").manual_seed(seed)

    for n in (4, 8):
        t = -(-item["n_frames"] // n) * n

        def put(a):
            a = np.asarray(a, np.float32)
            return torch.from_numpy(np.pad(a, [(0, t - len(a))] + [(0, 0)] * (a.ndim - 1)))[None].cuda()

        z, f0, g = svc.model.infer_pre(put(item["c"]), put(item["f0"]), put(item["uv"]),
                                       torch.tensor([0], device="cuda"), noise_scale=0.0, sample_noise=False,
                                       lengths=torch.tensor([item["n_frames"]], device="cuda"))
        tl = t // n
        zp = torch.nn.functional.pad(z, (halo, halo))
        fp = torch.nn.functional.pad(f0, (halo, halo))
        sums = [phase_sum(f0[:, r * tl : (r + 1) * tl], dec.sampling_rate, upp) for r in range(n)]
        for seed in (None, PARALLEL_NOISE_SEED):
            with torch.no_grad():
                mono = dec(z, f0, g, generator=noise(seed), noise_frames=None if seed is None else (0, t))
                parts, k3 = [], []
                for r in range(n):
                    before = fused_resblock_trio.launches
                    phase0 = sum(sums[:r]) if r else torch.zeros_like(sums[0])
                    parts.append(decode_local(dec, zp[..., r * tl : (r + 1) * tl + 2 * halo],
                                              fp[:, r * tl : (r + 1) * tl + 2 * halo], g, phase0, halo,
                                              r * tl, t, noise(seed)))
                    k3.append(fused_resblock_trio.launches - before)
            got = torch.cat(parts, -1)[0, 0].cpu().numpy()
            ok, err = _seams_ok(got, mono[0, 0].cpu().numpy(), halo * upp, tl * upp, n)
            ok = ok and min(k3) >= 1
            log("parallel", what=f"shard-local decode, {n} shards, noise {'off' if seed is None else 'on'}",
                frames=t, halo=halo, max_abs_err_vs_monolithic=f"{err:.3e}", tol=SEAM_TOL,
                resblock_trio_per_shard=k3, ok=ok)
            if not ok:
                raise AssertionError(f"[parallel] {n} shards, seed {seed}: err {err}, K3 per shard {k3}")


def parallel_training(tmp: Path, hps, mesh) -> None:
    """Two GAN steps through train(mesh=...) (DDP at world 1) against the
    same two through train(), the second step's wall beside the plain one;
    two FSDP-sharded train_steps (shard_params, model axis 1) against the
    plain steps, the first compared; one diffusion step through
    train_diffusion(mesh=...) against the plain one, on [pipeline]'s
    corpus. Each within PARALLEL_STEP_TOL, each GAN path launching K1 and K2."""
    from sovits_tpu_torch.models import factory
    from sovits_tpu_torch.parallel import shard_params
    from sovits_tpu_torch.train import diffusion as tdiff
    from sovits_tpu_torch.train.data import FeatureDataset, batch_iterator
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step
    from sovits_tpu_torch.train.trainer import train

    runs = {}
    for name, kw in (("plain", {}), ("ddp", {"mesh": mesh})):
        records, stamps = [], []

        def on_step(step, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            records.append({k: float(v) for k, v in m.items()})

        before = _counts()
        train(hps, tmp / f"parallel_{name}", max_steps=2, device="cuda", on_step=on_step, **kw)
        runs[name] = (records, stamps[1] - stamps[0], _launched(before))
    (plain, plain_s, _), (ddp, ddp_s, c) = runs["plain"], runs["ddp"]
    ok = len(ddp) == len(plain) == 2 and all(np.allclose(d[k], p[k], **PARALLEL_STEP_TOL)
                                             for d, p in zip(ddp, plain) for k in p)
    worst = max(abs(d[k] - p[k]) / max(abs(p[k]), 1e-12) for d, p in zip(ddp, plain) for k in p)
    ok = ok and c["rel_attention"] > 0 and c["rel_attention_bwd"] > 0
    log("parallel", what="2 GAN steps through train(mesh) (DDP, world 1) vs train()",
        ddp_step2_wall_s=f"{ddp_s:.4f}", plain_step2_wall_s=f"{plain_s:.4f}",
        worst_rel_metric_diff=f"{worst:.3e}", tol=PARALLEL_STEP_TOL,
        rel_attention=c["rel_attention"], rel_attention_bwd=c["rel_attention_bwd"], ok=ok)
    if not ok:
        raise AssertionError(f"[parallel] DDP GAN steps: {ddp} vs {plain}, launches {c}")

    batch = next(batch_iterator(FeatureDataset(hps.data.training_files, hps), hps.train.batch_size, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    metrics = {}
    for name in ("plain", "fsdp"):
        init = torch.Generator().manual_seed(0)
        net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False), init)
        net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"), init)
        net_g, net_d = net_g.cuda().train(), net_d.cuda().train()
        if name == "fsdp":
            shard_params(net_g, mesh)
            shard_params(net_d, mesh)
        opts = [make_optimizer(n.parameters(), hps) for n in (net_g, net_d)]
        before = _counts()
        walls, first = [], None
        for i in range(2):  # the first step is compared, the second timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(net_g, net_d, *opts, batch, hps, generator=torch.Generator("cuda").manual_seed(3 + i),
                           mesh=mesh if name == "fsdp" else None)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            first = first or {k: float(v) for k, v in m.items()}
        metrics[name] = (first, walls, _launched(before))
        del net_g, net_d, opts
    (fsdp, fsdp_s, c), (plain, plain_s, _) = metrics["fsdp"], metrics["plain"]
    ok = all(np.allclose(fsdp[k], plain[k], **PARALLEL_STEP_TOL) for k in plain)
    ok = ok and c["rel_attention"] > 0 and c["rel_attention_bwd"] > 0
    log("parallel", what="FSDP-sharded GAN steps (model axis 1) vs plain, the first compared",
        fsdp_step_walls_s=[f"{w:.4f}" for w in fsdp_s], plain_step_walls_s=[f"{w:.4f}" for w in plain_s],
        loss_g=f"{fsdp['loss/g/total']:.6f}/{plain['loss/g/total']:.6f}",
        grad_norm_g=f"{fsdp['grad_norm_g']:.6f}/{plain['grad_norm_g']:.6f}",
        rel_attention=c["rel_attention"], rel_attention_bwd=c["rel_attention_bwd"], ok=ok)
    if not ok:
        raise AssertionError(f"[parallel] FSDP step: {fsdp} vs {plain}, launches {c}")

    config = tmp / "pipeline" / "configs" / "diffusion.yaml"
    args = tdiff.load_diffusion_config(config)
    real, out = tdiff._loss, {}
    for name, kw in (("plain", {}), ("ddp", {"mesh": mesh})):
        seen = []
        tdiff._loss = lambda *a, **k: seen.append(real(*a, **k)) or seen[-1]  # noqa: E731
        try:
            model = tdiff.train_diffusion(args, expdir=tmp / f"parallel_diff_{name}", max_steps=1,
                                          vocoder_dim=_mels(args), resume=False, device="cuda", **kw)
        finally:
            tdiff._loss = real
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
        out[name] = (float(seen[0].detach()), grads)
    (loss_d, grads_d), (loss_p, grads_p) = out["ddp"], out["plain"]
    worst = max(float((grads_d[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                for n, g in grads_p.items())
    ok = np.isclose(loss_d, loss_p, **PARALLEL_STEP_TOL) and set(grads_d) == set(grads_p) and worst <= 1e-4
    log("parallel", what="1 diffusion step through train_diffusion(mesh) (DDP) vs plain",
        loss=f"{loss_d:.6f}/{loss_p:.6f}", worst_grad_err_over_peak=f"{worst:.3e}", ok=ok)
    if not ok:
        raise AssertionError(f"[parallel] DDP diffusion step: loss {loss_d} vs {loss_p}, grad {worst}")


def parallel_cli(tmp: Path, sr: int, hop: int) -> None:
    """``python -m sovits_tpu_torch.cli.infer -ss 4`` on [slice]'s 12 s song:
    the whole song in one dispatch, written with the song's length."""
    import os

    from scipy.io import wavfile

    from sovits_tpu_torch.cli import infer as cli

    work = tmp / "cli"
    out = work / "results" / "song_0key_0_sovits_dio.wav"
    out.unlink()
    _, wav = wavfile.read(work / "song.wav")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        cli.main(["-m", str(tmp / "G_0.pth"), "-c", str(tmp / "config.json"), "-n", "song.wav",
                  "-f0p", "dio", "-ss", "4"])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    out_sr, audio = wavfile.read(out)
    ok = out_sr == sr and len(audio) == len(wav) // hop * hop and np.abs(audio).max() > 0
    log("parallel", what="infer CLI -ss 4 (world 1: one shard)", wrote=out.name, samples=len(audio),
        seconds=f"{len(audio) / sr:.3f}", song_samples=len(wav), wall_s=f"{wall:.2f}", ok=ok)
    if not ok:
        raise AssertionError(f"[parallel] the -ss CLI wrote {len(audio)} samples at {out_sr} Hz for {len(wav)}")


def phase_parallel(tmp: Path, svc, hps) -> dict:
    """parallel/ on the card at world size 1 over NCCL (a file:// store in
    the temp dir): the song through Svc.infer_seq_parallel in fp32 and bf16,
    the shard seams at 4 and 8 shards, DDP and FSDP GAN steps and a DDP
    diffusion step against the plain ones, the -ss CLI. Under
    PARALLEL_LIMIT_S. Returns the phase's K1/K2/K3 launches."""
    import torch.distributed as dist

    from sovits_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()

    def run():
        mesh = make_mesh(1, 1, "cuda", init_method=f"file://{tmp / 'nccl_store'}", rank=0, world_size=1)
        try:
            log("parallel", backend=dist.get_backend(), world=dist.get_world_size(), mesh=tuple(mesh.shape))
            _reset_counts()
            wav = song(svc.target_sample)
            svc16 = build_svc(tmp, "cuda", dtype=torch.bfloat16)
            walls = parallel_song(svc, svc16, wav)
            del svc16
            parallel_seams(svc, wav)
            parallel_training(tmp, hps, mesh)
            parallel_cli(tmp, svc.target_sample, svc.hop_size)
            return _counts(), walls
        finally:
            dist.destroy_process_group()

    counts, walls = _limited("parallel", PARALLEL_LIMIT_S, run)
    log("parallel", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=PARALLEL_LIMIT_S, launches=counts,
        **{k: f"{v:.4f}" for k, v in walls.items()})
    return counts


def phase_cli_diffusion(tmp: Path, files: dict) -> None:
    """``python -m sovits_tpu_torch.cli.infer -shd`` on the card, from the
    directory ``phase_cli`` prepared (its encoder checkpoint and 12 s song)."""
    import os

    from scipy.io import wavfile

    from sovits_tpu_torch.cli import infer as cli

    work = tmp / "cli"
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        cli.main(["-m", str(tmp / "G_0.pth"), "-c", str(tmp / "config.json"), "-n", "song.wav",
                  "-f0p", "dio", "-shd", "-dm", files["diffusion_model_path"],
                  "-dc", files["diffusion_config_path"], "-ks", str(K_STEP)])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    _, audio = wavfile.read(work / "results" / "song_0key_0_sovits_dio.wav")
    _, src = wavfile.read(work / "song.wav")
    ok = abs(len(audio) - len(src)) <= 2 * 512 and np.abs(audio).max() > 0
    log("diffusion", what="infer CLI -shd, 12 s song", samples=len(audio), wall_s=f"{wall:.2f}", ok=ok)
    if not ok:
        raise AssertionError(f"the CLI with -shd wrote {len(audio)} samples for {len(src)}")


def phase_card_vs_cpu_batch(tmp: Path, svc, wav: np.ndarray) -> None:
    """One batched dispatch of two slicer chunks of one bucket, on the card
    and on a CPU Svc with the same weights: log-mel L1 per chunk < 1e-3."""
    from sovits_tpu_torch.dsp.stft import mel_spectrogram
    from sovits_tpu_torch.infer import slicer

    sr = svc.target_sample
    pieces = [d for tag, d in slicer.chunks2audio(wav, slicer.cut(wav, sr, db_thresh=-40)) if not tag]
    pad = np.zeros(sr // 2, np.float32)
    items = [svc._prepare_chunk(0, 0, np.concatenate([pad, d, pad]), sr, 0.0, False, "dio", 0.05)
             for d in pieces[:4:3]]  # the 5.5 s and 6 s pieces: one bucket
    dispatches = _dispatches(items, svc.hop_size)
    if dispatches != [(1024, 2)]:
        raise AssertionError(f"expected one batch of two in bucket 1024, got {dispatches}")
    cpu_svc = build_svc(tmp, "cpu", encoder=svc.encoder)
    t0 = time.perf_counter()
    card = svc._run_synth_batch(items, 0.0, False, 52468, sample_noise=False)
    host = cpu_svc._run_synth_batch(items, 0.0, False, 52468, sample_noise=False)
    cpu_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(card, host)):
        mels = [mel_spectrogram(torch.from_numpy(x)[None]) for x in (a, b)]
        l1 = (mels[0] - mels[1]).abs().mean().item()
        log("card_vs_cpu", batch=dispatches, chunk=i, frames=items[i]["n_frames"],
            max_abs=f"{np.abs(a - b).max():.3e}", mel_l1=f"{l1:.3e}", limit=1e-3, ok=l1 < 1e-3)
        if not l1 < 1e-3:
            raise AssertionError(f"card and CPU disagree on batched chunk {i}: log-mel L1 {l1}")
    log("card_vs_cpu", card_and_cpu_dispatch_s=f"{cpu_s:.2f}")


def phase_cli(tmp: Path, sr: int, hop: int) -> None:
    """``python -m sovits_tpu_torch.cli.infer`` as a user runs it, on the card:
    G_0.pth, its config and a seeded full-width encoder checkpoint where the
    CLI looks for it, a 12 s song; the written wav must have the song's length."""
    import os

    from scipy.io import wavfile

    from sovits_tpu_torch.cli import infer as cli

    work = tmp / "cli"
    write_encoder_checkpoint("vec768l12", work / "pretrain" / "checkpoint_best_legacy_500.pt", seed=1)
    wav = song(sr, (5.5, 5.5), seed=60)
    wavfile.write(work / "song.wav", sr, (wav * 32767).astype(np.int16))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        cli.main(["-m", str(tmp / "G_0.pth"), "-c", str(tmp / "config.json"), "-n", "song.wav",
                  "-f0p", "dio"])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    out = work / "results" / "song_0key_0_sovits_dio.wav"
    out_sr, audio = wavfile.read(out)
    ok = out_sr == sr and abs(len(audio) - len(wav)) <= 2 * hop and np.abs(audio).max() > 0  # two chunks
    log("cli", wrote=out.name, samples=len(audio), song_samples=len(wav), wall_s=f"{wall:.2f}", ok=ok)
    if not ok:
        raise AssertionError(f"the CLI wrote {len(audio)} samples at {out_sr} Hz for {len(wav)}")


def corpus_clips(spk_dir: Path, sr: int, hop: int) -> list[tuple[str, np.ndarray]]:
    """Eight seeded clips of 3-12 s (bench_signal at rising pitches), whole
    hops long, written to ``spk_dir`` as 16-bit wavs: (path, samples)."""
    from scipy.io import wavfile

    spk_dir.mkdir(parents=True)
    clips = []
    for i, seconds in enumerate(np.linspace(3.0, 12.0, 8)):
        wav = bench_signal(float(seconds), sr, seed=30 + i, base_hz=140.0 + 15.0 * i)
        wav = wav[: len(wav) // hop * hop]
        path = str(spk_dir / f"clip{i}.wav")
        wavfile.write(path, sr, (wav * 32767).astype(np.int16))
        clips.append((path, wav))
    return clips


def make_feature_dataset(root: Path, hps, encoder) -> Path:
    """so-vits-svc's preprocessed layout, made by the port itself: eight
    44.1 kHz clips of 3-12 s, units from the vec768l12 encoder, f0 from the
    port's DIO, linear spectrograms from dsp.stft. Returns the filelist."""
    from sovits_tpu_torch.dsp.audio import resample
    from sovits_tpu_torch.dsp.stft import spectrogram
    from sovits_tpu_torch.f0.dio import DioF0Predictor

    d = hps.data
    sr, hop = d.sampling_rate, d.hop_length
    dio = DioF0Predictor(hop_length=hop, sampling_rate=sr)
    paths = []
    for path, wav in corpus_clips(root / "spk0", sr, hop):
        f0, uv = dio.compute_f0_uv(wav)
        np.save(path + ".f0.npy", np.stack([f0, uv]))
        np.save(path + ".soft.npy", encoder.encode(resample(wav, sr, 16000)).T)  # [H, T]
        spec = spectrogram(torch.from_numpy(wav)[None].cuda(), d.filter_length, hop, d.win_length)
        np.save(path + ".spec.npy", spec[0].T.cpu().numpy())  # [F, T]
        paths.append(path)
    filelist = root / "train.txt"
    filelist.write_text("\n".join(paths) + "\n")
    return filelist


def phase_train(tmp: Path, encoder) -> dict:
    """Six full-width GAN steps through train(), then a resume for one more,
    then one profiled step."""
    from sovits_tpu_torch import config as scfg
    from sovits_tpu_torch.train.trainer import train

    t0 = time.perf_counter()
    hps = scfg.default_config(**{"train.log_interval": 1})
    hps.data["training_files"] = str(make_feature_dataset(tmp / "data", hps, encoder))
    hps["spk"] = scfg.HParams(spk0=0)
    log("train", dataset="8 clips, 3-12 s, 44.1 kHz", prep_s=f"{time.perf_counter() - t0:.2f}",
        batch=hps.train.batch_size, pad_to_frames=hps.data.pad_to_frames,
        segment=hps.train.segment_size)
    records = []
    last = [time.perf_counter()]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = _counts()
        losses = {k: float(v) for k, v in metrics.items()}
        records.append((step, now - last[0], counts, losses))
        _reset_counts()
        last[0] = now

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    last[0] = time.perf_counter()
    net_g, net_d = train(hps, tmp / "model", max_steps=6, device="cuda", on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    for step, wall, counts, losses in records:
        finite = all(np.isfinite(v) for v in losses.values())
        log("train", step=step, wall_s=f"{wall:.4f}", rel_attention=counts["rel_attention"],
            rel_attention_bwd=counts["rel_attention_bwd"], finite=finite,
            **{k.replace("loss/", ""): f"{v:.4f}" for k, v in losses.items()})
        if not finite or counts["rel_attention"] == 0 or counts["rel_attention_bwd"] == 0:
            raise AssertionError(f"step {step}: losses {losses}, launches {counts}")
    if [r[0] for r in records] != list(range(1, 7)):
        raise AssertionError(f"train() ran steps {[r[0] for r in records]}")
    steady = sum(r[1] for r in records[2:])
    log("train", steps_per_s_after_2_warmup=f"{len(records[2:]) / steady:.4f}",
        step_s_mean=f"{steady / len(records[2:]):.4f}", step1_with_setup_s=f"{records[0][1]:.4f}",
        peak_mem_gb=f"{peak / 1e9:.3f}", launches_per_step=records[-1][2])

    n_before = len(records)
    t0 = time.perf_counter()
    train(hps, tmp / "model", max_steps=7, device="cuda", on_step=on_step)
    resumed = [r[0] for r in records[n_before:]]
    if resumed != [7]:
        raise AssertionError(f"the resumed run took steps {resumed}, not [7]")
    jsonl = [json.loads(ln) for ln in (tmp / "model" / "metrics.jsonl").read_text().splitlines()]
    log("train", resumed_steps=resumed, resume_wall_s=f"{time.perf_counter() - t0:.2f}",
        metrics_jsonl_steps=[r["step"] for r in jsonl],
        checkpoints=sorted(p.name for p in (tmp / "model").glob("*.pth")))

    profile_step("train", net_g, net_d, hps)  # on the nets of the first run
    total = {k: sum(r[2][k] for r in records) for k in ("rel_attention", "rel_attention_bwd")}
    return total, hps


def profile_step(phase: str, net_g, net_d, hps, **labels) -> None:
    """One training step of (net_g, net_d) on a batch of hps's training
    files, after a warm-up step, under torch.profiler: its wall, device busy,
    K1's and K2's device ms and the top kernels."""
    from sovits_tpu_torch.train.data import FeatureDataset, batch_iterator
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    it = batch_iterator(FeatureDataset(hps.data.training_files, hps), hps.train.batch_size, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
    it.close()
    opts = [make_optimizer(n.parameters(), hps) for n in (net_g, net_d)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_step(net_g, net_d, *opts, batch, hps, generator=gen)  # warm-up
    wall, busy, dev = _profiled(lambda: train_step(net_g, net_d, *opts, batch, hps, generator=gen))
    k1 = sum(v for k, v in dev.items() if "rel_attn_fwd" in k) / 1e3
    k2 = sum(v for k, v in dev.items() if any(n in k for n in K2_KERNELS)) / 1e3
    log(phase, **labels, profiled_step_wall_ms=f"{1e3 * wall:.2f}", device_busy_ms=f"{busy:.2f}",
        rel_attention_ms=f"{k1:.3f}", rel_attention_bwd_ms=f"{k2:.3f}",
        k1_share_of_busy=f"{k1 / busy:.4f}" if busy else "n/a",
        k2_share_of_busy=f"{k2 / busy:.4f}" if busy else "n/a")
    for key, us in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    device {us / 1e3:9.3f} ms  {key[:110]}", flush=True)


# [train-configs]: so-vits-svc 4.1's model options trained at published widths
TRAIN_CONFIGS_LIMIT_S = 300
TRAIN_CONFIGS_STEPS = 4  # per run; the user's path resumes for one more
TRAIN_CONFIGS_OTHERS = ("resblock2", "snake", "tiny")
CARD_CPU_CONFIGS = ("vol_tflow", "snake")
CARD_CPU_ROWS = 2  # of the training batch, for the step on the CPU: its time, not the widths, is cut
GRAD_REL = 1e-3  # card against CPU: the generator's whole gradient, relative in norm


def attention_per_step(hps) -> int:
    """K1 (and K2) launches in one training step: the content encoder's
    layers, the F0 decoder's, and the transformer flow's causal layers."""
    m = hps.model
    flow = m.n_flow_layer * m.n_layers_trans_flow if m.use_transformer_flow else 0
    return m.n_layers * (1 + bool(m.use_automatic_f0_prediction)) + flow


def attention_per_synthesis(hps) -> int:
    """K1 launches of one Synthesizer.infer with f0 given: the content
    encoder's layers and the reversed transformer flow's."""
    m = hps.model
    return m.n_layers + (m.n_flow_layer * m.n_layers_trans_flow if m.use_transformer_flow else 0)


def _step_records(phase: str, what: str, steps: list, want: int) -> None:
    """Log each spied training step (wall, K1/K2, losses) and the steps per
    second after two warm-ups; raise on a non-finite loss or on other than
    ``want`` fp32 K1 and K2 launches."""
    for i, (wall, c, m) in enumerate(steps, 1):
        losses = {k: float(v) for k, v in m.items()}
        finite = all(np.isfinite(v) for v in losses.values())
        log(phase, what=what, step=i, wall_s=f"{wall:.4f}", rel_attention=c["rel_attention"],
            rel_attention_bwd=c["rel_attention_bwd"], finite=finite,
            **{k.replace("loss/", ""): f"{v:.4f}" for k, v in losses.items()})
        if not finite or c["rel_attention"] != want or c["rel_attention_bwd"] != want:
            raise AssertionError(f"[{phase}] {what} step {i}: losses {losses}, launches {c}, want {want} K1/K2")
    steady = [w for w, _, _ in steps[2:]]
    if steady:
        log(phase, what=what, steps_per_s_after_2_warmup=f"{len(steady) / sum(steady):.4f}",
            step_s_mean=f"{np.mean(steady):.4f}", step1_s=f"{steps[0][0]:.4f}", k1_k2_per_step=want)


def train_configs_cli(work: Path, tmp: Path, encoder):
    """(a) The user's path for a volume + transformer-flow model:
    corpus_clips, preprocess_flist_config --vol_aug --use_transformer_flow,
    preprocess_features (DIO, [slice]'s seeded vec768l12 checkpoint),
    cli.train for TRAIN_CONFIGS_STEPS steps with an evaluation at the last,
    a resume for one more, one profiled step of a fresh seeded model, and
    G_<n+1>.pth served by Svc (a warm-up and a 10 s request, K1/K3
    checked). Returns the trained config."""
    from sovits_tpu_torch import config as scfg
    from sovits_tpu_torch.cli import preprocess_features, preprocess_flist_config
    from sovits_tpu_torch.cli import train as cli_train
    from sovits_tpu_torch.infer.svc import Svc
    from sovits_tpu_torch.models import factory

    d = scfg.default_config().data
    clips = corpus_clips(work / "dataset" / "44k" / "alto", d.sampling_rate, d.hop_length)
    n = TRAIN_CONFIGS_STEPS
    with contextlib.chdir(work):
        preprocess_flist_config.main(["--vol_aug", "--use_transformer_flow"])
        config = Path("configs/config.json")
        cfg = json.loads(config.read_text())
        cfg["train"].update(eval_interval=n, log_interval=1)
        config.write_text(json.dumps(cfg, indent=2))
        t0 = time.perf_counter()
        seconds = preprocess_features.main(["-c", str(config), "--f0_predictor", "dio", "--encoder_checkpoint",
                                            str(tmp / "cli" / "pretrain" / "checkpoint_best_legacy_500.pt"),
                                            "--device", "cuda"])
        prep_s = time.perf_counter() - t0
        hps = scfg.load_config(config)
        m = hps.model
        vols = [np.load(p + ".vol.npy") for p, _ in clips]
        ok = (m.vol_embedding and m.use_transformer_flow and hps.train.vol_aug
              and all(v.shape == (len(w) // d.hop_length,) and v.max() > 1e-3 for v, (_, w) in zip(vols, clips)))
        log("train-configs", what="preprocess_flist_config --vol_aug --use_transformer_flow, preprocess_features",
            clips=len(clips), audio_s=f"{sum(len(w) for _, w in clips) / d.sampling_rate:.1f}",
            prep_s=f"{prep_s:.2f}", **{f"{k}_s": f"{v:.3f}" for k, v in seconds.items()},
            vol_embedding=m.vol_embedding, use_transformer_flow=m.use_transformer_flow,
            vol_aug=hps.train.vol_aug, n_flow_layer=m.n_flow_layer, n_layers_trans_flow=m.n_layers_trans_flow,
            ok=ok)
        if not ok:
            raise AssertionError(f"[train-configs] the CLI config or the volumes: {dict(m)}")
        want = attention_per_step(hps)
        argv = ["-c", str(config), "-m", "44k", "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        with _spied_training() as rec:
            t0 = time.perf_counter()
            cli_train.main(argv + ["--max-steps", str(n)])
            first_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            cli_train.main(argv + ["--max-steps", str(n + 1)])
            resume_s = time.perf_counter() - t0
        net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                                     torch.Generator().manual_seed(31)).cuda().train()
        net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"),
                                     torch.Generator().manual_seed(32)).cuda().train()
        profile_step("train-configs", net_g, net_d, hps, config="vol_tflow")
        del net_g, net_d
        model_dir = Path("logs/44k")
        records = [json.loads(ln) for ln in (model_dir / "metrics.jsonl").read_text().splitlines()]
        ckpts = sorted(p.name for p in model_dir.glob("G_*.pth"))
        _step_records("train-configs", "vol_tflow, cli.train", rec["steps"][:n], want)
        _step_records("train-configs", "vol_tflow, resumed", rec["steps"][n:], want)
        evals = [(wall, c) for wall, c, _ in rec["evals"]]
        want_eval = 2 * attention_per_synthesis(hps)  # two validation clips
        ok = (len(rec["steps"]) == n + 1 and [r["step"] for r in records if "loss/g/total" in r]
              == list(range(1, n + 2)) and len(evals) == 1 and evals[0][1]["rel_attention"] == want_eval
              and evals[0][1]["resblock_trio"] == 0 and f"G_{n + 1}.pth" in ckpts
              and all(np.isfinite(v) for r in records for v in r.values()))
        log("train-configs", what="vol_tflow: cli.train, resumed", first_run_s=f"{first_s:.2f}",
            resumed_run_s=f"{resume_s:.2f}", peak_mem_gb=f"{peak / 1e9:.3f}",
            eval_wall_s=[f"{w:.4f}" for w, _ in evals], eval_rel_attention=[c["rel_attention"] for _, c in evals],
            eval_mel_l1={k: f"{v:.4f}" for r in records for k, v in r.items() if k.startswith("eval/")},
            metrics_steps=[r["step"] for r in records if "loss/g/total" in r], checkpoints=ckpts, ok=ok)
        if not ok:
            raise AssertionError(f"[train-configs] vol_tflow training: steps {len(rec['steps'])}, "
                                 f"evaluations {evals}, checkpoints {ckpts}")

        svc = Svc(str(model_dir / f"G_{n + 1}.pth"), str(config), encoder=encoder, device="cuda")
        sr, hop = svc.target_sample, svc.hop_size
        clip = bench_signal(SECONDS, sr, seed=91)
        want_infer = {"rel_attention": attention_per_synthesis(hps), "resblock_trio": 4}
        for request in ("10s warm-up", "10s"):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio, n_samples, n_frames = svc.infer("alto", 0, clip, sr=sr, f0_predictor="dio")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _launched(before)
            ok = (n_samples == n_frames * hop == len(clip) // hop * hop and np.isfinite(audio).all()
                  and float(np.abs(audio).max()) > 1e-4
                  and all(got[k] == want_infer.get(k, 0) for k in got))
            log("train-configs", what=f"G_{n + 1}.pth served by Svc.infer", request=repr(request),
                frames=n_frames, wall_s=f"{wall:.4f}", rtf=f"{wall / SECONDS:.5f}",
                **{k: got[k] for k in want_infer}, peak=f"{np.abs(audio).max():.4f}", ok=ok)
            if not ok:
                raise AssertionError(f"[train-configs] the trained vol_tflow model's {request}: launches {got}")
    return hps


def train_configs_options(work: Path, cli_hps) -> dict:
    """(b) The other options' models (CONFIG_CASES) trained by train() on
    (a)'s features for TRAIN_CONFIGS_STEPS steps at batch 6: each step's
    wall, launches and losses, peak memory. Returns each option's config."""
    from sovits_tpu_torch.train.trainer import train

    configs = {}
    with contextlib.chdir(work):
        for name in TRAIN_CONFIGS_OTHERS:
            hps = config_hps(name)
            hps.data["training_files"] = cli_hps.data.training_files
            hps.data["validation_files"] = cli_hps.data.validation_files
            for key in ("n_speakers", "ssl_dim", "gin_channels", "speech_encoder"):  # (a)'s features and speakers
                hps.model[key] = cli_hps.model[key]
            hps["spk"] = cli_hps.spk
            configs[name] = hps
            torch.cuda.reset_peak_memory_stats()
            with _spied_training() as rec:
                t0 = time.perf_counter()
                train(hps, Path("logs") / name, max_steps=TRAIN_CONFIGS_STEPS, device="cuda")
                wall = time.perf_counter() - t0
            m = hps.model
            log("train-configs", config=name, what="train()", run_s=f"{wall:.2f}",
                peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}", batch=hps.train.batch_size,
                resblock=m.resblock, vocoder=m.vocoder_name or "nsf-hifigan",
                use_depthwise_conv=bool(m.use_depthwise_conv), flow_share_parameter=bool(m.flow_share_parameter),
                filter_channels=m.filter_channels, upsample_initial_channel=m.upsample_initial_channel)
            if len(rec["steps"]) != TRAIN_CONFIGS_STEPS:
                raise AssertionError(f"[train-configs] {name}: train() ran {len(rec['steps'])} steps")
            _step_records("train-configs", name, rec["steps"], attention_per_step(hps))
    return configs


def train_configs_card_vs_cpu(work: Path, configs: dict) -> None:
    """(c) One deterministic GAN step of each CARD_CPU_CONFIGS model on the
    card against the same step on the CPU: same seeded weights, the first
    CARD_CPU_ROWS rows of a training batch, TF32 off. Every metric (losses
    and both gradient norms) within STEP_REL, the generator's whole
    gradient within GRAD_REL in norm; the worst tensor is printed."""
    from sovits_tpu_torch.models import factory
    from sovits_tpu_torch.train.data import FeatureDataset, batch_iterator
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    for name in CARD_CPU_CONFIGS:
        hps = configs[name]
        with contextlib.chdir(work):
            it = batch_iterator(FeatureDataset(hps.data.training_files, hps), hps.train.batch_size, seed=7)
            rows = {k: v[:CARD_CPU_ROWS] for k, v in next(it).items()}
            it.close()
        runs = {}
        for device in ("cuda", "cpu"):
            net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False),
                                         torch.Generator().manual_seed(21)).to(device).train()
            net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"),
                                         torch.Generator().manual_seed(22)).to(device).train()
            opts = [make_optimizer(n.parameters(), hps) for n in (net_g, net_d)]
            batch = {k: torch.from_numpy(v).to(device) for k, v in rows.items()}
            torch.cuda.synchronize()
            before, t0 = _counts(), time.perf_counter()
            m = train_step(net_g, net_d, *opts, batch, hps, deterministic=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            grads = {n: p.grad.detach().cpu() for n, p in net_g.named_parameters() if p.grad is not None}
            runs[device] = (wall, {k: float(v) for k, v in m.items()}, grads, _launched(before))
            del net_g, net_d, opts, batch
        (w_card, m_card, g_card, c_card), (w_cpu, m_cpu, g_cpu, c_cpu) = runs["cuda"], runs["cpu"]
        loss_rel = {k: abs(m_card[k] - v) / max(abs(v), 1e-8) for k, v in m_cpu.items()}
        worst_loss = max(loss_rel, key=loss_rel.get)
        grad_rel = (sum((g_card[n] - g).square().sum() for n, g in g_cpu.items()).sqrt()
                    / sum(g.square().sum() for g in g_cpu.values()).sqrt()).item()
        rel = {n: ((g_card[n] - g).norm() / g.norm().clamp_min(1e-30)).item() for n, g in g_cpu.items()}
        worst = max(rel, key=rel.get)
        # a key projection's bias shifts a query row's scores alike, which the
        # softmax removes: its exact gradient is 0 and the computed one noise
        worst_else = max((n for n in rel if not n.endswith("conv_k.bias")), key=rel.get)
        want = attention_per_step(hps)
        ok = (set(g_card) == set(g_cpu) and loss_rel[worst_loss] <= STEP_REL and grad_rel <= GRAD_REL
              and c_card["rel_attention"] == c_card["rel_attention_bwd"] == want
              and not any(c_cpu.values()))
        log("train-configs", config=name, what="one deterministic GAN step, card against CPU (fp32, TF32 off)",
            rows=CARD_CPU_ROWS, frames=hps.data.pad_to_frames, card_s=f"{w_card:.4f}", cpu_s=f"{w_cpu:.2f}",
            loss_max_rel=f"{loss_rel[worst_loss]:.3e}", worst_metric=worst_loss,
            g_total_card=f"{m_card['loss/g/total']:.5f}", g_total_cpu=f"{m_cpu['loss/g/total']:.5f}",
            grad_g_total_rel=f"{grad_rel:.3e}", worst_parameter=worst, worst_parameter_rel=f"{rel[worst]:.3e}",
            worst_but_key_biases=worst_else, worst_but_key_biases_rel=f"{rel[worst_else]:.3e}",
            rel_attention=c_card["rel_attention"], rel_attention_bwd=c_card["rel_attention_bwd"],
            limits=f"metrics<={STEP_REL}, gradient<={GRAD_REL}", ok=ok)
        if not ok:
            raise AssertionError(f"[train-configs] {name}: card and CPU steps disagree: metrics {loss_rel}, "
                                 f"gradient {grad_rel} (worst {worst} {rel[worst]}), launches {c_card}")


def phase_train_configs(tmp: Path, encoder) -> dict:
    """so-vits-svc 4.1's model options trained on the card at published
    widths: (a) the vol_tflow model through the user's CLIs, resumed and
    served; (b) ResBlock2, Snake and the tiny template through train(); (c)
    vol_tflow and Snake, one deterministic step card against CPU; (d)
    vol_tflow in bf16, two steps of bench.py's recipe, the first against
    fp32; (e) the learning proof at LEARNING_TINY's widths with the volume
    embedding and the transformer flow. Under TRAIN_CONFIGS_LIMIT_S.
    Returns the phase's launches."""
    from sovits_tpu_torch import config as scfg

    t_phase = time.perf_counter()

    def run():
        _reset_counts()
        work = tmp / "train-configs"
        cli_hps = train_configs_cli(work, tmp, encoder)
        configs = train_configs_options(work, cli_hps)
        configs["vol_tflow"] = cli_hps
        train_configs_card_vs_cpu(work, configs)

        hps = scfg.HParams(**cli_hps.to_dict())
        hps.data["pad_to_frames"] = BENCH_T
        log("train-configs", config="vol_tflow", what="bench.py's bf16 step", batch=hps.train.batch_size,
            pad_to_frames=BENCH_T, segment=hps.train.segment_size)
        bf16_steps("train-configs", hps, bench_train_batch(hps), 2, attention_per_step(hps))

        hps = learning_hps(**{"model.vol_embedding": True, "model.use_transformer_flow": True})
        got = overfit_steps("train-configs", hps)
        if not got["rel_attention"] == got["rel_attention_bwd"] == LEARNING_STEPS * attention_per_step(hps):
            raise AssertionError(f"[train-configs] the learning proof's steps launched {got}")
        return _counts()

    counts = _limited("train-configs", TRAIN_CONFIGS_LIMIT_S, run)
    log("train-configs", phase_s=f"{time.perf_counter() - t_phase:.1f}", limit_s=TRAIN_CONFIGS_LIMIT_S,
        launches=counts)
    return counts


def _profile_start():
    """A torch.profiler window opened after a synchronize, and its start."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof, time.perf_counter()


def _profile_stop(started):
    """(wall s, device busy ms, {kernel: device us}) of the window that
    _profile_start opened, closed after a synchronize."""
    prof, t0 = started
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = us
    return wall, sum(dev.values()) / 1e3, dev


def _profiled(fn):
    """(wall s, device busy ms, {kernel: device us}) of one call of fn under
    torch.profiler, ending in a synchronize."""
    started = _profile_start()
    fn()
    return _profile_stop(started)


def phase_train_fused_tail(hps) -> dict:
    """Three full-width GAN steps (train_step) with the generator built
    fused_tail=True, against the same steps from the same weights, batches
    and seed with fused_tail=False: K3 runs in the forward, FusedTrio's
    backward recomputes the plain convs. At every step the losses and the
    generator's whole gradient agree within STEP_REL (relative, in norm); at
    the first step, from the same weights, so does each gradient tensor.
    After it the nets differ: AdamW's first update is lr * sign(g) wherever
    |g| >> eps, so entries whose gradient is at the rounding level move by
    +-lr either way, as they do between two runs of the same unfused step on
    the card. The attention key projections' biases are left out of the
    per-tensor check: such a bias adds the same amount to every score of a
    query row, which the softmax removes, so their exact gradient is 0 and
    the computed one is rounding noise."""
    from sovits_tpu_torch.models import factory
    from sovits_tpu_torch.train.data import FeatureDataset, batch_iterator
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    it = batch_iterator(FeatureDataset(hps.data.training_files, hps), hps.train.batch_size, seed=7)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in itertools.islice(it, 3)]
    it.close()
    nets = {}
    for fused in (False, True):
        net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=fused),
                                     torch.Generator().manual_seed(11)).cuda().train()
        net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"),
                                     torch.Generator().manual_seed(12)).cuda().train()
        nets[fused] = (net_g, net_d, *(make_optimizer(n.parameters(), hps) for n in (net_g, net_d)))
    gen = torch.Generator(device="cuda")
    runs = {False: [], True: []}
    for i, batch in enumerate(batches):
        for fused in ((False, True) if i % 2 == 0 else (True, False)):  # in turns
            net_g = nets[fused][0]
            gen.manual_seed(100 + i)
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(*nets[fused], batch, hps, generator=gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            grads = {n: p.grad.detach().clone() for n, p in net_g.named_parameters() if p.grad is not None}
            runs[fused].append((wall, {k: float(v) for k, v in m.items()}, grads, _counts()))
    worst = 0.0
    for i, ((w0, m0, g0, c0), (w1, m1, g1, c1)) in enumerate(zip(runs[False], runs[True])):
        loss_rel = max(abs(m1[k] - v) / max(abs(v), 1e-8) for k, v in m0.items())
        total_rel = (sum((g1[n] - g).square().sum() for n, g in g0.items()).sqrt()
                     / sum(g.square().sum() for g in g0.values()).sqrt()).item()
        rel = {n: ((g1[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
               for n, g in g0.items() if not n.endswith("conv_k.bias")}
        name, grad_rel = max(rel.items(), key=lambda kv: kv[1])
        worst = max(worst, loss_rel, total_rel, grad_rel if i == 0 else 0.0)
        ok = (c1["resblock_trio"] == 4 and c0["resblock_trio"] == 0 and set(g0) == set(g1)
              and max(loss_rel, total_rel, grad_rel if i == 0 else 0.0) <= STEP_REL)
        log("train-fused-tail", step=i + 1, unfused_wall_s=f"{w0:.4f}", fused_wall_s=f"{w1:.4f}",
            resblock_trio=c1["resblock_trio"], rel_attention=c1["rel_attention"],
            rel_attention_bwd=c1["rel_attention_bwd"], loss_max_rel=f"{loss_rel:.3e}",
            grad_total_rel=f"{total_rel:.3e}", grad_worst_tensor_rel=f"{grad_rel:.3e}",
            worst_tensor=name, g_total=f"{m1['loss/g/total']:.4f}", ok=ok)
        if not ok:
            raise AssertionError(f"fused-tail step {i + 1} disagrees: losses {m0} vs {m1}, gradient "
                                 f"{total_rel}, {name} {grad_rel}, launches {c0} / {c1}")
    total = {k: sum(st[3][k] for st in runs[True]) for k in ("rel_attention", "resblock_trio")}
    log("train-fused-tail", steps=len(batches), tol=STEP_REL, worst_rel=f"{worst:.3e}", launches=total)
    # step times: the first steps of a net pay one-time costs, so six more
    # steps of each, in turns, then one profiled step of each
    walls = {False: [], True: []}
    for i in range(6):
        for fused in ((False, True) if i % 2 == 0 else (True, False)):
            gen.manual_seed(200 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(*nets[fused], batches[i % len(batches)], hps, generator=gen)
            torch.cuda.synchronize()
            walls[fused].append(time.perf_counter() - t0)
    busy = {fused: _profiled(lambda: train_step(*nets[fused], batches[0], hps, generator=gen))[1]
            for fused in (False, True)}
    log("train-fused-tail", timed_steps=6, unfused_median_s=f"{np.median(walls[False]):.4f}",
        fused_median_s=f"{np.median(walls[True]):.4f}",
        unfused_steps_s=[f"{w:.4f}" for w in walls[False]], fused_steps_s=[f"{w:.4f}" for w in walls[True]],
        unfused_device_busy_ms=f"{busy[False]:.2f}", fused_device_busy_ms=f"{busy[True]:.2f}")
    return total


def bench_train_batch(hps, device="cuda") -> dict:
    """bench.py's training batch (bench.py:768-785): batch 6 x 512 frames,
    seeded normals for the units, spectrogram and waveform, f0 uniform in
    80-400 Hz, all voiced, speaker 0, full lengths; for a volume model,
    volumes uniform in 0-0.3."""
    rng = np.random.default_rng(0)
    b, t, hop = hps.train.batch_size, hps.data.pad_to_frames, hps.data.hop_length
    batch = dict(
        c=rng.standard_normal((b, t, hps.model.ssl_dim)).astype(np.float32),
        f0=rng.uniform(80, 400, (b, t)).astype(np.float32),
        uv=np.ones((b, t), np.float32),
        spec=np.abs(rng.standard_normal((b, t, hps.data.filter_length // 2 + 1))).astype(np.float32),
        wav=(rng.standard_normal((b, t * hop, 1)) * 0.1).astype(np.float32),
        spk=np.zeros(b, np.int64),
        lengths=np.full(b, t, np.int64),
    )
    if hps.model.vol_embedding:
        batch["volume"] = rng.uniform(0.0, 0.3, (b, t)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def bf16_steps(phase: str, hps, batch: dict, n_steps: int, attn_per_step: int):
    """bench.py's bf16 training recipe on ``hps``: the model with seeded
    random weights, build_synthesizer(fused_tail=False, dtype=bf16) and
    build_discriminator(dtype=bf16), fp32 parameters. Its first step is held
    against the same step through fp32 nets (same weights, batch and
    generator seed; the mel loss through its waveform, as the bf16 request is
    held); then ``n_steps - 1`` more steps. Every bf16 step must launch
    ``attn_per_step`` bf16 K1 and as many bf16 K2, no fp32 attention kernel,
    and give finite losses. Returns the bf16 nets and optimizers, the step
    walls after the first, the bf16 launches and the step generator."""
    import torch.nn.functional as F

    from sovits_tpu_torch.dsp.sequence import slice_segments
    from sovits_tpu_torch.dsp.stft import mel_spectrogram, spec_to_mel
    from sovits_tpu_torch.models import factory
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    bf = torch.bfloat16
    nets = {}
    for dtype in (torch.float32, bf):
        net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False, dtype=dtype),
                                     torch.Generator().manual_seed(0)).cuda().train()
        net_d = factory.init_random_(factory.build_discriminator(hps, "cpu", dtype=dtype),
                                     torch.Generator().manual_seed(1)).cuda().train()
        nets[dtype] = (net_g, net_d, *(make_optimizer(n.parameters(), hps) for n in (net_g, net_d)))
    gen = torch.Generator(device="cuda")

    def step(dtype, seed):
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        before, t0 = _counts(), time.perf_counter()
        m = train_step(*nets[dtype], batch, hps, generator=gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, {k: float(v) for k, v in m.items()}, _launched(before)

    def check(i, counts, losses):
        ok = (all(np.isfinite(v) for v in losses.values()) and counts["rel_attention_bf16"] == attn_per_step
              and counts["rel_attention_bwd_bf16"] == attn_per_step and counts["rel_attention"] == 0
              and counts["rel_attention_bwd"] == 0)
        if not ok:
            raise AssertionError(f"[{phase}] bf16 step {i}: losses {losses}, launches {counts}")

    d = hps.data
    mel_kw = dict(n_fft=d.filter_length, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
                  fmin=d.mel_fmin, fmax=d.mel_fmax)

    def mel(y_hat):
        return mel_spectrogram(y_hat[..., 0], hop_length=d.hop_length, win_length=d.win_length, **mel_kw)

    def mel_loss(y_hat, ids_slice) -> float:
        """train_step's mel loss of a waveform."""
        y_mel = slice_segments(spec_to_mel(batch["spec"], **mel_kw), ids_slice,
                               hps.train.segment_size // d.hop_length)
        return (F.l1_loss(mel(y_hat), y_mel) * hps.train.c_mel).item()

    # the first step in fp32 and in bf16, from the same weights, batch and seed;
    # each keeps its generator output (y_hat, ids_slice)
    forward_out = {}

    def keep(dtype):
        def hook(_module, _args, out) -> None:  # returns None: the output stays as it is
            forward_out.setdefault(dtype, (out[0].detach(), out[1]))
        return hook

    hooks = [nets[dtype][0].register_forward_hook(keep(dtype)) for dtype in nets]
    _, m32, _ = step(torch.float32, 300)
    g32 = {n: p.grad.detach().clone() for n, p in nets[torch.float32][0].named_parameters()
           if p.grad is not None}
    del nets[torch.float32]
    torch.cuda.reset_peak_memory_stats()
    walls, launches = [], {"rel_attention_bf16": 0, "rel_attention_bwd_bf16": 0}
    wall, m16, counts = step(bf, 300)
    for h in hooks:
        h.remove()
    check(1, counts, m16)
    for k in launches:
        launches[k] += counts[k]
    g16 = {n: p.grad.detach().float() for n, p in nets[bf][0].named_parameters() if p.grad is not None}
    if set(g16) != set(g32):
        raise AssertionError(f"[{phase}] bf16 and fp32 steps trained other parameters: {set(g16) ^ set(g32)}")
    (y32, ids), (y16, ids16) = forward_out[torch.float32], forward_out[bf]
    if y16.dtype != bf or not torch.equal(ids, ids16):
        raise AssertionError(f"[{phase}] the bf16 forward gave {y16.dtype}, slices {ids16.tolist()} vs "
                             f"{ids.tolist()}")
    mel32, mel16 = mel(y32), mel(y16)
    loud = mel32 > mel32.amax(dim=(1, 2), keepdim=True) - LOUD_DB / 20 * np.log(10)
    mel_l1_loud = (mel16 - mel32).abs()[loud].mean().item()
    wave_rel = ((y16.float() - y32).abs().max() / y32.abs().max()).item()
    # every loss but the mel loss, which the waveform stands in for
    no_mel = {k: v for k, v in m32.items() if k != "loss/g/mel"}
    no_mel["loss/g/total"] = m32["loss/g/total"] - m32["loss/g/mel"]
    got_no_mel = dict(m16, **{"loss/g/total": m16["loss/g/total"] - m16["loss/g/mel"]})
    loss_rel = {k: abs(got_no_mel[k] - v) / max(abs(v), 1e-8) for k, v in no_mel.items()}
    grad_rel = (sum((g16[n] - g).square().sum() for n, g in g32.items()).sqrt()
                / sum(g.square().sum() for g in g32.values()).sqrt()).item()
    worst = max(loss_rel, key=loss_rel.get)
    ok = (max(loss_rel.values()) <= BF16_STEP_LOSS_REL and grad_rel <= BF16_STEP_GRAD_REL
          and mel_l1_loud < MEL_L1_BF16 and wave_rel <= E2E_REL)
    log(phase, what="first step, bf16 against fp32 nets (same weights, batch, seed)",
        **{f"{k.replace('loss/', '')}_fp32": f"{v:.5g}" for k, v in m32.items()},
        **{f"{k.replace('loss/', '')}_bf16": f"{m16[k]:.5g}" for k in m32},
        g_mel_rel=f"{abs(m16['loss/g/mel'] - m32['loss/g/mel']) / m32['loss/g/mel']:.3e}",
        g_mel_of_fp32_wave_rounded_to_bf16=f"{mel_loss(y32.bfloat16(), ids):.5g}",
        y_hat_mel_l1_loud_bins=f"{mel_l1_loud:.4e}", loud_share=f"{loud.float().mean().item():.3f}",
        y_hat_mel_l1_all_bins=f"{(mel16 - mel32).abs().mean().item():.4e}",
        y_hat_wave_rel_max_abs=f"{wave_rel:.3e}", loss_max_rel_but_mel=f"{loss_rel[worst]:.3e}",
        worst_loss=worst, grad_g_total_rel=f"{grad_rel:.3e}",
        rel_attention_bf16=counts["rel_attention_bf16"], rel_attention_bwd_bf16=counts["rel_attention_bwd_bf16"],
        limits=(f"losses but mel<={BF16_STEP_LOSS_REL}, grad<={BF16_STEP_GRAD_REL}, "
                f"loud-bin L1<{MEL_L1_BF16}, wave<={E2E_REL}"), ok=ok)
    if not ok:
        raise AssertionError(f"[{phase}] bf16 step disagrees with fp32: losses {loss_rel}, gradient "
                             f"{grad_rel}, loud-bin log-mel L1 {mel_l1_loud}, wave {wave_rel}")
    for i in range(2, n_steps + 1):
        wall, m16, counts = step(bf, 300 + i)
        check(i, counts, m16)
        for k in launches:
            launches[k] += counts[k]
        walls.append(wall)
        log(phase, step=i, wall_s=f"{wall:.4f}", rel_attention_bf16=counts["rel_attention_bf16"],
            rel_attention_bwd_bf16=counts["rel_attention_bwd_bf16"],
            **{k.replace("loss/", ""): f"{v:.4f}" for k, v in m16.items()})
    return nets[bf], walls, launches, gen


def phase_train_bf16() -> dict:
    """bench.py's training configuration (bench.py:736-806) through the
    port: the full-width default model in bf16 (bf16_steps), batch 6 x 512
    frames, segment 10240: its first step against fp32 nets, one more
    warm-up and six timed steps, and one profiled step; 12 bf16 K1 and K2 a
    step."""
    from sovits_tpu_torch import config as scfg
    from sovits_tpu_torch.train.step import train_step

    hps = scfg.default_config(**{"data.pad_to_frames": BENCH_T})
    batch = bench_train_batch(hps)
    log("train-bf16", config="bench.py: default model, fused_tail=False, bf16 G and D, fp32 parameters",
        batch=hps.train.batch_size, pad_to_frames=hps.data.pad_to_frames, segment=hps.train.segment_size)
    nets, walls, launches, gen = bf16_steps("train-bf16", hps, batch, 8, 12)
    walls = walls[1:]  # after one more warm-up step
    peak = torch.cuda.max_memory_allocated()
    wall, busy, dev = _profiled(lambda: train_step(*nets, batch, hps, generator=gen))
    k1 = sum(v for k, v in dev.items() if "rel_attn_fwd" in k) / 1e3
    k2 = sum(v for k, v in dev.items() if any(n in k for n in K2_KERNELS)) / 1e3
    log("train-bf16", timed_steps=len(walls), steps_per_s=f"{len(walls) / sum(walls):.4f}",
        step_s_mean=f"{sum(walls) / len(walls):.4f}", step_s_median=f"{np.median(walls):.4f}",
        steps_s=[f"{w:.4f}" for w in walls], peak_mem_gb=f"{peak / 1e9:.3f}",
        profiled_step_wall_ms=f"{1e3 * wall:.2f}", device_busy_ms=f"{busy:.2f}",
        rel_attention_bf16_ms=f"{k1:.3f}", rel_attention_bwd_bf16_ms=f"{k2:.3f}", launches=launches)
    for key, us in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    device {us / 1e3:9.3f} ms  {key[:110]}", flush=True)
    return launches


def phase_trio_shift() -> list[dict]:
    """The K4 microbench at its defaults (C 128, T 55104), as its CLI runs it
    (events), then each variant's device time and launch from the profiler."""
    from sovits_tpu_torch.tools import profile_trio_shift as k4

    results = k4.main([])
    xp, mats = k4.make_inputs(128, 55104, 0, "cuda")
    for r in results:
        if r["launches"] == 0:
            raise AssertionError(f"the microbench did not launch K4 ({r['variant']})")
        ms_d, launch = _device_ms(lambda: k4.trio_shift(xp, mats, r["variant"]), "trio_shift_kernel")
        log("trio-shift", variant=r["variant"], launches=r["launches"], kernel_ms=f"{r['ms']:.4f}",
            kernel_device_ms=f"{ms_d:.4f}", plain_ms=f"{r['plain_ms']:.4f}", tflops=f"{r['tflops']:.3f}",
            device_tflops=f"{r['gflop'] / ms_d:.3f}", bound_ms=f"{r['bound_ms']:.4f}", **launch)
    return results


K1 = ("sovits_tpu_torch/csrc/rel_attention.cu", "sovits_tpu/ops/attention.py:191")
K2 = ("sovits_tpu_torch/csrc/rel_attention_bwd.cu", "sovits_tpu/ops/attention.py:217")
K3 = ("sovits_tpu_torch/csrc/resblock_trio.cu", "sovits_tpu/ops/fused_stage.py:200")
K4 = ("sovits_tpu_torch/csrc/trio_shift.cu", "tools/profile_trio_shift.py:106")
KERNELS = {  # JSON name: (source, TPU kernel it replaces)
    "rel_attention": K1,
    "rel_attention_bf16": K1,
    "rel_attention_bwd": K2,
    "rel_attention_bwd_bf16": K2,
    "resblock_trio": K3,
    "resblock_trio_bf16": K3,
    "trio_shift_bf16": K4,
    "trio_shift_fp32": K4,
}


def main() -> None:
    t_smoke = time.perf_counter()
    name = phase_device()
    phase_build()
    errs = phase_parity()
    with tempfile.TemporaryDirectory() as tmp:
        svc, infer = phase_main_path(Path(tmp))
        phase_card_vs_cpu(Path(tmp), svc)
        infer_bf16, svc16 = phase_main_bf16(Path(tmp), svc)
        slice32, slice16 = phase_slice(Path(tmp), svc, svc16)
        configs32, configs16 = phase_configs(Path(tmp), svc, svc16)
        diffusion32, diffusion16 = phase_diffusion(Path(tmp), svc, svc16)
        frontend = phase_frontend(Path(tmp), svc)
        encoders = phase_encoders(Path(tmp))
        cluster = phase_cluster(Path(tmp), svc)
        pipeline = phase_pipeline(Path(tmp), svc)
        surfaces = phase_surfaces(svc)
        export = phase_export(Path(tmp), svc)
        del svc16
        train, hps = phase_train(Path(tmp), svc.encoder)
        train_configs = phase_train_configs(Path(tmp), svc.encoder)
        fused_tail = phase_train_fused_tail(hps)
        learning = phase_learning(Path(tmp))
        parallel = phase_parallel(Path(tmp), svc, hps)
    train_bf16 = phase_train_bf16()
    k4 = {f"trio_shift_{r['variant']}": r for r in phase_trio_shift()}
    times = phase_times()
    for key, r in k4.items():
        times[key] = [r["ms"], r["plain_ms"]]
    paths = {
        "rel_attention": {"infer": infer["rel_attention"], "slice": slice32["rel_attention"],
                          "configs": configs32["rel_attention"],
                          "diffusion": diffusion32["rel_attention"], "frontend": frontend["rel_attention"],
                          "encoders": encoders["rel_attention"], "cluster": cluster["rel_attention"],
                          "pipeline": pipeline["rel_attention"], "surfaces": surfaces["rel_attention"],
                          "export": export["rel_attention"], "train": train["rel_attention"],
                          "train_configs": train_configs["rel_attention"],
                          "train_fused_tail": fused_tail["rel_attention"], "learning": learning["rel_attention"],
                          "parallel": parallel["rel_attention"]},
        "rel_attention_bf16": {"infer_bf16": infer_bf16["rel_attention_bf16"],
                               "slice_bf16": slice16["rel_attention_bf16"],
                               "configs_bf16": configs16["rel_attention_bf16"],
                               "diffusion_bf16": diffusion16["rel_attention_bf16"],
                               "train_bf16": train_bf16["rel_attention_bf16"],
                               "train_configs": train_configs["rel_attention_bf16"],
                               "parallel": parallel["rel_attention_bf16"]},
        "rel_attention_bwd": {"pipeline": pipeline["rel_attention_bwd"], "train": train["rel_attention_bwd"],
                              "train_configs": train_configs["rel_attention_bwd"],
                              "learning": learning["rel_attention_bwd"], "parallel": parallel["rel_attention_bwd"]},
        "rel_attention_bwd_bf16": {"train_bf16": train_bf16["rel_attention_bwd_bf16"],
                                   "train_configs": train_configs["rel_attention_bwd_bf16"]},
        "resblock_trio": {"infer": infer["resblock_trio"], "slice": slice32["resblock_trio"],
                          "configs": configs32["resblock_trio"],
                          "diffusion": diffusion32["resblock_trio"],
                          "diffusion_bf16": diffusion16["resblock_trio"], "frontend": frontend["resblock_trio"],
                          "encoders": encoders["resblock_trio"], "cluster": cluster["resblock_trio"],
                          "pipeline": pipeline["resblock_trio"], "surfaces": surfaces["resblock_trio"],
                          "export": export["resblock_trio"], "train_fused_tail": fused_tail["resblock_trio"],
                          "train_configs": train_configs["resblock_trio"],
                          "parallel": parallel["resblock_trio"]},
        "resblock_trio_bf16": {"infer_bf16": infer_bf16["resblock_trio_bf16"],
                               "slice_bf16": slice16["resblock_trio_bf16"],
                               "configs_bf16": configs16["resblock_trio_bf16"],
                               "diffusion_bf16": diffusion16["resblock_trio_bf16"],
                               "parallel": parallel["resblock_trio_bf16"]},
        **{key: {"microbench": r["launches"]} for key, r in k4.items()},
    }
    bound = bounds()
    log("smoke", seconds=f"{time.perf_counter() - t_smoke:.1f}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(paths[k].values()), "launches_by_path": paths[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bound[k][0],
         "bound_by": bound[k][1], "library_ms": times[k][2] if len(times[k]) > 2 else None}
        for k, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
