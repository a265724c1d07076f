"""Microbench: how the trio's row-shifted operands are staged, on the card.

Counterpart of ``tools/profile_trio_shift.py`` (K4 in PERF.md). The chain is
the one that tool times, 12 rounds of

    x = lrelu_0.1(x);   x[r] = sum_{s in -1, 0, 1} x[r + s] . M[3i + j]

on a folded [Q + 32, D] bf16 input with 36 bf16 matrices [D, D] and fp32
accumulation, where P = max(128 // C, 1), D = P * C and Q = T / P. The
output is the chain at input rows [16, 16 + n_blocks * 1024), n_blocks =
Q // 1024: the rows the TPU tool writes (53 blocks, 54272 of 55104 rows at
the defaults); its other rows are left unwritten there and are not part of
the function here.

The TPU tool's four modes compute two functions, which are this tool's two
variants:

- ``bf16``: its ``concat``, ``roll`` and ``scratch`` modes. They differ only
  in how Mosaic feeds a shifted view to the TPU's matrix unit; on Hopper a
  shifted view is another row base. Every intermediate is rounded to bf16.
- ``fp32``: its ``fp32in`` mode. Intermediates stay fp32.

``trio_shift`` runs ``csrc/trio_shift.cu`` on CUDA tensors, on the tensor
cores in both variants (bf16 products with fp32 sums; fp32 as three bf16
products per fp32 one), with the tile plan of :func:`trio_shift_plan`; on
CPU tensors it runs the plain version, 12 ``F.conv1d`` calls (bf16 convs
for ``bf16``, fp32 for ``fp32``). ``main`` times both with CUDA events at
the TPU tool's defaults and prints the kernel's achieved TFLOP/s against
the rate its products run at, and the card's name and power limit.

Usage: python -m sovits_tpu_torch.tools.profile_trio_shift [C] [T]
"""

from __future__ import annotations

import subprocess
import sys
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import build

BLOCK_Q = 1024  # the TPU tool's output block
HALO = 16  # its halo rows on each side of a block
N_CONV = 12
SHIFTS = (-1, 0, 1)
SLOPE = 0.1
D_KERNEL = 128  # the folded width the kernel is built for
VARIANTS = {"bf16": ("concat", "roll", "scratch"), "fp32": ("fp32in",)}
# the H100's published dense bf16 tensor-core peak (SXM, 700 W); the fp32
# variant takes three bf16 products per fp32 one
BF16_TC_FLOPS = 989e12
PEAK_FLOPS = {"bf16": BF16_TC_FLOPS, "fp32": BF16_TC_FLOPS / 3}
# the kernel's tiling (csrc/trio_shift.cu)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may opt in to on an H100
ROW_STRIDE = D_KERNEL + 8  # elements a row of the window and of a staged matrix
PASS_ROWS = 256  # rows a round's warps cover (4 warp rows x 4 m16 tiles): the window's cap
TAP_BYTES = D_KERNEL * ROW_STRIDE * 2  # one staged matrix [C_in][C_out + 8] bf16; two are in flight
WINDOW_ITEM = {"bf16": 2, "fp32": 4}  # bytes a window value: bf16 A, or fp32 A split in registers
MISMATCH_MAX = 0.01  # fp32: share of bf16 outputs allowed to differ from the plain version's bits


@dataclass(frozen=True)
class ShiftPlan:
    """How the kernel tiles the written rows: each of ``blocks`` blocks owns
    ``tt`` output rows and holds a window of ``window`` = tt + 24 rows (the
    chain's reach on each side) in ``smem`` bytes of shared memory."""

    tt: int
    window: int
    smem: int
    blocks: int
    window_stride: int  # bytes a window row
    tap_stride: int  # bytes a row of a staged matrix


def trio_shift_plan(rows: int, variant: str, sms: int) -> ShiftPlan:
    """The kernel's tile plan for ``rows`` written rows on ``sms`` SMs: the
    fewest whole waves of one block per SM (the kernel's registers allow no
    second) with windows no larger than shared memory and one round's row
    tiles hold, then the shortest tile that fills those waves."""
    if variant not in VARIANTS or rows < 1 or sms < 1:
        raise ValueError(f"trio_shift_plan: variant in {sorted(VARIANTS)}, rows and sms >= 1")
    stride = ROW_STRIDE * WINDOW_ITEM[variant]
    fit = min((SMEM_LIMIT - 2 * TAP_BYTES) // stride, PASS_ROWS)
    tt_max = fit - 2 * N_CONV
    waves = -(-rows // (sms * tt_max))
    tt = -(-rows // (sms * waves))
    window = tt + 2 * N_CONV
    return ShiftPlan(tt, window, 2 * TAP_BYTES + window * stride, -(-rows // tt), stride, ROW_STRIDE * 2)


def shapes(c: int, t: int) -> tuple[int, int, int]:
    """(P, D, Q) as the TPU tool derives them from [C] [T]."""
    p = max(128 // c, 1)
    return p, p * c, t // p


def out_rows(xp: torch.Tensor) -> int:
    """Rows written for an input [1, Q + 32, D]: whole 1024-row blocks of Q."""
    return (xp.shape[1] - 2 * HALO) // BLOCK_Q * BLOCK_Q


def flops(rows: int, d: int) -> float:
    """Products the written rows need: 2 * 12 * 3 * rows * D^2."""
    return 2.0 * N_CONV * len(SHIFTS) * rows * d * d


def make_inputs(c: int, t: int, seed: int = 0, device="cpu"):
    """The TPU tool's inputs: xp [1, Q + 32, D] ~ 0.1 N(0, 1) and 36
    matrices ~ sqrt(0.5 / D) N(0, 1), both bf16, drawn with numpy."""
    _, d, q = shapes(c, t)
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy((rng.standard_normal((1, q + 2 * HALO, d)) * 0.1).astype(np.float32))
    mats = torch.from_numpy((rng.standard_normal((N_CONV * len(SHIFTS), d, d))
                             * (0.5 / d) ** 0.5).astype(np.float32))
    return xp.to(device, torch.bfloat16), mats.to(device, torch.bfloat16)


def trio_shift_plain(xp: torch.Tensor, mats: torch.Tensor, variant: str) -> torch.Tensor:
    """The chain as 12 valid (unpadded) ``F.conv1d`` calls; [1, rows, D] bf16."""
    rows = out_rows(xp)
    stage = torch.bfloat16 if variant == "bf16" else torch.float32
    # the rows output row 0 .. rows-1 reach: input rows 4 .. rows + 28
    x = xp[0, HALO - N_CONV : HALO + rows + N_CONV].t()[None]  # [1, D, rows + 24]
    for i in range(N_CONV):
        a = F.leaky_relu(x.float(), SLOPE)
        # the first round's lrelu is the TPU tool's, on the bf16 input
        a = a.to(stage if i else torch.bfloat16).to(stage)
        w = mats[len(SHIFTS) * i : len(SHIFTS) * (i + 1)].permute(2, 1, 0).to(stage)  # [out, in, 3]
        x = F.conv1d(a, w)
    return x[0].t().to(torch.bfloat16)[None].contiguous()


def trio_shift(xp: torch.Tensor, mats: torch.Tensor, variant: str) -> torch.Tensor:
    """The chain's written rows [1, rows, D] bf16. CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything it does not take
    raises."""
    if variant not in VARIANTS:
        raise ValueError(f"trio_shift: variant must be one of {sorted(VARIANTS)}")
    if xp.device.type == "cpu":
        return trio_shift_plain(xp, mats, variant)
    if xp.device.type != "cuda":
        raise ValueError(f"trio_shift: unsupported device {xp.device}")
    d = xp.shape[2]
    n_mats = N_CONV * len(SHIFTS)
    for tns in (xp, mats):
        if tns.dtype != torch.bfloat16 or not tns.is_contiguous() or tns.device != xp.device:
            raise ValueError("trio_shift: contiguous bfloat16 tensors on one CUDA device")
    if xp.shape[0] != 1 or d != D_KERNEL or mats.shape != (n_mats, d, d) or out_rows(xp) < 1:
        raise ValueError(f"trio_shift: xp [1, Q + 32, {D_KERNEL}] with Q >= {BLOCK_Q} and "
                         f"mats [{n_mats}, {D_KERNEL}, {D_KERNEL}]")
    if xp.data_ptr() % 16 or mats.data_ptr() % 16:
        raise ValueError("trio_shift: 16-byte aligned tensors")
    rows = out_rows(xp)
    plan = trio_shift_plan(rows, variant, torch.cuda.get_device_properties(xp.device).multi_processor_count)
    out = torch.empty(1, rows, d, device=xp.device, dtype=torch.bfloat16)
    rc = build.load("trio_shift").lib.sovits_trio_shift(
        xp.data_ptr(), mats.data_ptr(), out.data_ptr(), rows, d, int(variant == "fp32"),
        plan.tt, plan.window, plan.smem, plan.blocks, torch.cuda.current_stream(xp.device).cuda_stream,
    )
    build.check(rc, "trio_shift launch")
    trio_shift.launches += 1
    return out


trio_shift.launches = 0  # kernel launches since the last reset


def _time(fn, iters: int) -> float:
    """ms per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of the bf16 outputs whose bits differ from the plain version's.
    An fp32 variant whose intermediates are fp32-accurate differs only where
    a value lies on a bf16 rounding edge; one-pass TF32 differs almost
    everywhere."""
    return (got.view(torch.int16) != want.view(torch.int16)).float().mean().item()


def run(c: int = 128, t: int = 55104, iters: int = 20, seed: int = 0) -> list[dict]:
    """Check and time both variants on the card; one dict per variant.
    The check holds the kernel to its plain version: max-abs <= 2e-2 x
    max|plain| (a few bf16 ulps: the two sum in other orders and round the
    bf16 intermediates at different points), and for fp32 at most
    MISMATCH_MAX of the outputs not bit-equal to the plain version's."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the microbench runs only on a GPU")
    torch.backends.cudnn.allow_tf32 = False  # the fp32 plain convs in full fp32
    xp, mats = make_inputs(c, t, seed, "cuda")
    rows = out_rows(xp)
    work = flops(rows, xp.shape[2])
    results = []
    for variant in VARIANTS:
        got = trio_shift(xp, mats, variant)
        want = trio_shift_plain(xp, mats, variant)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        share = mismatch(got, want)
        if not err <= 2e-2 * ref:
            raise AssertionError(f"trio_shift {variant}: max-abs {err} against max|plain| {ref}")
        if variant == "fp32" and not share <= MISMATCH_MAX:
            raise AssertionError(f"trio_shift fp32: {share:.2%} of the outputs differ from the plain version's")
        before = trio_shift.launches  # the timed runs; not the check above
        ms = _time(lambda: trio_shift(xp, mats, variant), iters)
        launches = trio_shift.launches - before
        plain_ms = _time(lambda: trio_shift_plain(xp, mats, variant), iters)
        peak = PEAK_FLOPS[variant]
        results.append(dict(variant=variant, tpu_modes=VARIANTS[variant], rows=rows,
                            launches=launches,
                            gflop=work / 1e9, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                            ref_max=ref, mismatch=share, tflops=work / ms / 1e9,
                            bound_ms=1e3 * work / peak, bound_peak_tflops=peak / 1e12))
    return results


def main(argv=None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    c = int(argv[0]) if len(argv) > 0 else 128
    t = int(argv[1]) if len(argv) > 1 else 55104
    p, d, q = shapes(c, t)
    print(card(), flush=True)
    print(f"C={c} P={p} D={d} T={t} Q={q} convs={N_CONV} shifts/conv={len(SHIFTS)} "
          f"rows written={q // BLOCK_Q * BLOCK_Q}", flush=True)
    results = run(c, t)
    for r in results:
        print(f"{r['variant']:5s} ({'/'.join(r['tpu_modes'])})  kernel {r['ms']:8.4f} ms  "
              f"plain {r['plain_ms']:8.4f} ms  {r['tflops']:7.2f} TFLOP/s = "
              f"{100 * r['tflops'] / r['bound_peak_tflops']:5.2f}% of the {r['bound_peak_tflops']:.1f} "
              f"TFLOP/s its products run at  bound {r['bound_ms']:.4f} ms  max-abs {r['max_abs_err']:.3e}  "
              f"not bit-equal {r['mismatch']:.4%}", flush=True)
    return results


if __name__ == "__main__":
    main()
