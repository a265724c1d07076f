"""One vocoder stage's ResBlock1 trio: CUDA kernel wrapper, autograd
Function and plain version.

Counterpart of ``sovits_tpu/ops/fused_stage.py::fused_resblock_trio`` and
``trio_folded``, same signature and chain order: ``kernels``/``biases`` hold
the 18 convs as [k, C_in, C_out] / [C] (weight norm already folded), chain
j = kernel size ``kernel_sizes[j]``, and within a chain, per dilation d,
conv (k, d) then conv (k, 1). Activations are [B, T, C].

Types, as the TPU kernel's: x and the kernels fp32 or bf16 (one type), the
biases in that type or fp32; the biases, the residual stream and every
intermediate are fp32 and the output is in x's type.

``fused_resblock_trio`` dispatches by device: a CPU tensor goes to
``fused_resblock_trio_plain``; a CUDA tensor launches ``csrc/resblock_trio.cu``
or raises. The call goes through the operator ``sovits::resblock_trio``, so
that an exported program keeps the kernel. The kernel runs on the tensor
cores in both types (bf16 products with fp32 sums; fp32 as 3xTF32). Its
tile plan (halos, output rows per block, window rows, shared memory, grid)
comes from :func:`trio_plan`, which the CPU tests check and the kernel's
entry point checks again before it launches. When autograd needs a gradient the call goes through
:class:`FusedTrio`, whose backward recomputes the plain version, as the JAX
package's custom VJP recomputes ``trio_folded_xla``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Sequence

import torch
import torch.nn.functional as F

from . import build

LRELU_SLOPE = 0.1
# channel counts the kernel is instantiated for: the stages where the JAX
# package's fold condition (fold * C == 128) fires
TRIO_CHANNELS = (16, 32, 64, 128)
_MAX_PAIRS = 3
SMEM_LIMIT = 232_448  # bytes of shared memory one block may opt in to on an H100
# the kernel's tiling (csrc/resblock_trio.cu): a window holds at most the rows
# its warps' m16 tiles cover in one pass (Bf16<C>::PASS, Fp32<C>::PASS)
_PASS_ROWS = {True: {16: 2048, 32: 1024, 64: 512, 128: 256}, False: {16: 1280, 32: 768, 64: 384, 128: 192}}
_SMEM_PER_SM = 233_472  # an H100 SM's shared memory; each block also reserves 1 KB


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclass(frozen=True)
class TrioPlan:
    """How the kernel tiles one stage: each block owns ``tt`` output rows of
    one batch row and holds a window of ``rows`` >= tt + 2 max(halos) rows
    in ``smem`` bytes of shared memory."""

    halos: tuple[int, ...]  # per chain: the sum of its convs' reaches
    rows: int
    tt: int
    smem: int

    def grid(self, b: int, t: int) -> tuple[int, int]:
        """Blocks along T (covering it) and along the batch."""
        return -(-t // self.tt), b

    def balanced(self, b: int, t: int, sms: int) -> TrioPlan:
        """The same window with ``tt`` cut (not below 16) so that [B, T]
        fills whole waves of blocks on ``sms`` SMs: the largest tile would
        leave the last wave part-empty (464 blocks at C = 128 on 132 SMs)."""
        slots = sms * max(1, _SMEM_PER_SM // (self.smem + 1024))  # blocks resident at once
        waves = -(-b * self.grid(b, t)[0] // slots)
        per_row = max(1, waves * slots // b)  # blocks along T that fit those waves
        return replace(self, tt=min(self.tt, max(16, -(-t // per_row))))


def _trio_smem(c: int, bf16: bool, rows: int) -> int:
    """Shared-memory bytes of a window of ``rows`` rows, as the kernel lays
    them out: the fp32 residual [rows][C + 8], the inner activation [rows][C
    + 8] in bf16 (bf16) or fp32 (fp32), and two staged weight steps, bf16
    [min(C, 64)][C + 8] or fp32 [min(C, 32)][C + 4]."""
    if bf16:
        return 2 * min(c, 64) * (c + 8) * 2 + rows * ((c + 8) * 4 + (c + 8) * 2)
    return 2 * min(c, 32) * (c + 4) * 4 + rows * 2 * (c + 8) * 4


def trio_plan(
    c: int,
    dtype: torch.dtype,
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
) -> TrioPlan:
    """The kernel's tile plan for one stage of C channels in ``dtype``: the
    largest window the shared memory and one pass of the warps' row tiles
    hold, less the largest halo on each side."""
    if c not in TRIO_CHANNELS or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"trio_plan: C in {TRIO_CHANNELS}, float32 or bfloat16; got {c}, {dtype}")
    bf16 = dtype == torch.bfloat16
    halos = tuple(sum((k - 1) // 2 * (d + 1) for d in dils) for k, dils in zip(kernel_sizes, dilation_sizes))
    fixed = _trio_smem(c, bf16, 0)
    rows = min((SMEM_LIMIT - fixed) // (_trio_smem(c, bf16, 1) - fixed), _PASS_ROWS[bf16][c])
    tt = rows - 2 * max(halos)
    if tt < 16:
        raise ValueError(f"trio_plan: halos {halos} leave {tt} output rows per block at C={c}")
    return TrioPlan(halos, rows, tt, _trio_smem(c, bf16, rows))


def fused_resblock_trio_plain(
    x: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
) -> torch.Tensor:
    """mean_j ResBlock1_j(x) with F.conv1d in fp32; x [B, T, C] -> [B, T, C]
    in x's type."""
    def conv(h, i, k, d):
        w = kernels[i].float().permute(2, 1, 0)  # [C_out, C_in, k]
        h = F.leaky_relu(h, LRELU_SLOPE)
        return F.conv1d(h, w, biases[i].float(), padding=(k - 1) * d // 2, dilation=d)

    xc = x.float().transpose(1, 2)  # [B, C, T]
    idx = 0
    total = None
    for k, dils in zip(kernel_sizes, dilation_sizes):
        xr = xc
        for d in dils:
            xt = conv(conv(xr, idx, k, d), idx + 1, k, 1)
            idx += 2
            xr = xt + xr
        total = xr if total is None else total + xr
    return (total / len(kernel_sizes)).transpose(1, 2).to(x.dtype)


def _check(x, kernels, biases, kernel_sizes, dilation_sizes) -> None:
    """Raise on what the kernel does not take."""
    b, t, c = x.shape
    if (x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous() or c not in TRIO_CHANNELS
            or x.data_ptr() % 16):
        raise ValueError(f"fused_resblock_trio: contiguous, 16-byte aligned float32 or bfloat16 [B, T, C] "
                         f"with C in {TRIO_CHANNELS}, got {x.dtype} {tuple(x.shape)}")
    if not 1 <= len(kernel_sizes) <= 3 or any(not 1 <= len(d) <= _MAX_PAIRS for d in dilation_sizes):
        raise ValueError("fused_resblock_trio: 1-3 chains of 1-3 dilations")
    idx = 0
    for k, dils in zip(kernel_sizes, dilation_sizes):
        if k % 2 == 0:
            raise ValueError(f"fused_resblock_trio: odd kernel sizes only, got {k}")
        for _ in range(2 * len(dils)):
            kern, bias = kernels[idx], biases[idx]
            if kern.shape != (k, c, c) or bias.shape != (c,):
                raise ValueError(f"fused_resblock_trio: conv {idx} must be [{k}, {c}, {c}] + [{c}]")
            idx += 1
    for tns in kernels:
        if tns.device != x.device or tns.dtype != x.dtype:
            raise ValueError(f"fused_resblock_trio: {x.dtype} kernels on the input's device")
    for tns in biases:
        if tns.device != x.device or tns.dtype not in (x.dtype, torch.float32):
            raise ValueError(f"fused_resblock_trio: {x.dtype} or float32 biases on the input's device")


def _forward(x, kernels, biases, kernel_sizes, dilation_sizes) -> torch.Tensor:
    """Through the ``sovits::resblock_trio`` op: CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    return resblock_trio(x, list(kernels), list(biases), list(kernel_sizes),
                         [d for dils in dilation_sizes for d in dils], [len(d) for d in dilation_sizes])


# The trio kernel as an operator a tracer keeps opaque (``torch.export``
# records the call, not the pointers handed to ctypes). Chain j takes
# ``n_pairs[j]`` dilations, in order, from the flat ``dilations``. The
# dispatcher picks the implementation by device: the plain version on the
# CPU, the kernel on CUDA (which launches or raises); another device has
# none and raises. No autograd kernel of its own (``FusedTrio`` holds the
# gradient): a call costs one Python kernel, not custom_op's autograd wrapper
# around it (``tools/surfaces_ab.py`` times both).
_LIB = torch.library.Library("sovits", "FRAGMENT")
_LIB.define("resblock_trio(Tensor x, Tensor[] kernels, Tensor[] biases, int[] kernel_sizes, "
            "int[] dilations, int[] n_pairs) -> Tensor")


def _nest(dilations, n_pairs) -> tuple:
    it = iter(dilations)
    return tuple(tuple(next(it) for _ in range(n)) for n in n_pairs)


def _plain_op(x, kernels, biases, kernel_sizes, dilations, n_pairs) -> torch.Tensor:
    """The operator's CPU implementation: the plain version."""
    return fused_resblock_trio_plain(x, kernels, biases, tuple(kernel_sizes), _nest(dilations, n_pairs))


def _launch_op(x, kernels, biases, kernel_sizes, dilations, n_pairs) -> torch.Tensor:
    """The operator's CUDA implementation: :func:`_launch`."""
    return _launch(x, kernels, biases, tuple(kernel_sizes), _nest(dilations, n_pairs))


def _launch(x, kernels, biases, kernel_sizes, dilation_sizes) -> torch.Tensor:
    """Check CUDA inputs, plan the tiles and launch the kernel (callable
    without the dispatcher to time what it adds)."""
    _check(x, kernels, biases, kernel_sizes, dilation_sizes)
    b, t, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    plan = trio_plan(c, x.dtype, kernel_sizes, dilation_sizes).balanced(b, t, _sm_count(x.device))
    w = torch.cat([kern.reshape(-1) for kern in kernels])
    bias = torch.cat(biases).float()  # fp32, as the TPU kernel's
    out = torch.empty_like(x)
    acc = torch.empty(x.shape, device=x.device, dtype=torch.float32) if bf16 else out
    n = len(kernel_sizes)
    ks = (ctypes.c_int * n)(*kernel_sizes)
    n_pairs = (ctypes.c_int * n)(*(len(d) for d in dilation_sizes))
    dils = (ctypes.c_int * (n * _MAX_PAIRS))(
        *(d[i] if i < len(d) else 0 for d in dilation_sizes for i in range(_MAX_PAIRS))
    )
    halos = (ctypes.c_int * n)(*plan.halos)
    lib = build.load("resblock_trio").lib
    rc = lib.sovits_resblock_trio(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), acc.data_ptr(), b, t, c, n,
        ks, n_pairs, dils, halos, plan.rows, plan.tt, plan.smem, plan.grid(b, t)[0], int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "resblock_trio launch")
    fused_resblock_trio.launches += 1
    fused_resblock_trio.launches_bf16 += bf16
    return out


def _fake_op(x, kernels, biases, kernel_sizes, dilations, n_pairs):
    return torch.empty_like(x)


_LIB.impl("resblock_trio", _plain_op, "CPU")
_LIB.impl("resblock_trio", _launch_op, "CUDA")
torch.library.register_fake("sovits::resblock_trio", _fake_op, lib=_LIB)
resblock_trio = torch.ops.sovits.resblock_trio.default


class FusedTrio(torch.autograd.Function):
    """The trio with a gradient: forward by :func:`_forward` (the kernel on
    CUDA), saving only x, the kernels and the biases; backward by autograd
    through a recomputed :func:`fused_resblock_trio_plain` (cuDNN convs on
    CUDA), the counterpart of the JAX package's ``_make_trio_vjp``."""

    @staticmethod
    def forward(ctx, x, kernel_sizes, dilation_sizes, *weights):
        n = len(weights) // 2
        ctx.save_for_backward(x, *weights)
        ctx.plan = (kernel_sizes, dilation_sizes)
        return _forward(x, weights[:n], weights[n:], kernel_sizes, dilation_sizes)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[3:])
        n = (len(saved) - 1) // 2
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            out = fused_resblock_trio_plain(leaves[0], leaves[1:n + 1], leaves[n + 1:], *ctx.plan)
            wanted = [leaf for leaf in leaves if leaf.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, dout))
        grads = [next(got) if leaf.requires_grad else None for leaf in leaves]
        return grads[0], None, None, *grads[1:]


def fused_resblock_trio(
    x: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
) -> torch.Tensor:
    """xs = mean_j ResBlock1_j(x). Returns [B, T, C].

    Device dispatch, not a fallback: CPU tensors take the plain version;
    CUDA tensors launch the kernel, and anything it does not take raises.
    When autograd needs a gradient the call goes through :class:`FusedTrio`;
    otherwise the forward runs alone.
    """
    n_convs = 2 * sum(len(d) for d in dilation_sizes)
    if len(kernels) != n_convs or len(biases) != n_convs or len(kernel_sizes) != len(dilation_sizes):
        raise ValueError(f"fused_resblock_trio: expected {n_convs} kernels and biases")
    kernel_sizes = tuple(kernel_sizes)
    dilation_sizes = tuple(map(tuple, dilation_sizes))
    if torch.is_grad_enabled() and any(tns.requires_grad for tns in [x, *kernels, *biases]):
        return FusedTrio.apply(x, kernel_sizes, dilation_sizes, *kernels, *biases)
    return _forward(x, kernels, biases, kernel_sizes, dilation_sizes)


fused_resblock_trio.launches = 0  # kernel launches since the last reset
fused_resblock_trio.launches_bf16 = 0  # of which with bf16 inputs
