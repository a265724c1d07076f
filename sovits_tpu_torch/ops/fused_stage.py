"""One vocoder stage's ResBlock1 trio: CUDA kernel wrapper and plain version.

Counterpart of ``sovits_tpu/ops/fused_stage.py::fused_resblock_trio``, same
signature and chain order: ``kernels``/``biases`` hold the 18 convs as
[k, C_in, C_out] / [C] (weight norm already folded), chain j = kernel size
``kernel_sizes[j]``, and within a chain, per dilation d, conv (k, d) then
conv (k, 1). Activations are [B, T, C].

``fused_resblock_trio`` dispatches by device: a CPU tensor goes to
``fused_resblock_trio_plain``; a CUDA tensor launches
``csrc/resblock_trio.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import build

LRELU_SLOPE = 0.1
# channel counts the kernel is instantiated for: the stages where the JAX
# package's fold condition (fold * C == 128) fires
TRIO_CHANNELS = (16, 32, 64, 128)
_MAX_PAIRS = 3


def fused_resblock_trio_plain(
    x: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int] = (3, 7, 11),
    dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
) -> torch.Tensor:
    """mean_j ResBlock1_j(x) with F.conv1d; x [B, T, C] -> [B, T, C]."""
    def conv(h, i, k, d):
        w = kernels[i].permute(2, 1, 0)  # [C_out, C_in, k]
        h = F.leaky_relu(h, LRELU_SLOPE)
        return F.conv1d(h, w, biases[i], padding=(k - 1) * d // 2, dilation=d)

    xc = x.transpose(1, 2)  # [B, C, T]
    idx = 0
    total = None
    for k, dils in zip(kernel_sizes, dilation_sizes):
        xr = xc
        for d in dils:
            xt = conv(conv(xr, idx, k, d), idx + 1, k, 1)
            idx += 2
            xr = xt + xr
        total = xr if total is None else total + xr
    return (total / len(kernel_sizes)).transpose(1, 2)


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
    """
    n_convs = 2 * sum(len(d) for d in dilation_sizes)
    if len(kernels) != n_convs or len(biases) != n_convs or len(kernel_sizes) != len(dilation_sizes):
        raise ValueError(f"fused_resblock_trio: expected {n_convs} kernels and biases")
    if x.device.type == "cpu":
        return fused_resblock_trio_plain(x, kernels, biases, kernel_sizes, dilation_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_trio: unsupported device {x.device}")
    b, t, c = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous() or c not in TRIO_CHANNELS:
        raise ValueError(
            f"fused_resblock_trio: contiguous float32 [B, T, C] with C in {TRIO_CHANNELS}"
        )
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
    for tns in list(kernels) + list(biases):
        if tns.device != x.device or tns.dtype != torch.float32:
            raise ValueError("fused_resblock_trio: float32 weights on the input's device")
    w = torch.cat([kern.reshape(-1) for kern in kernels])
    bias = torch.stack(list(biases)).contiguous()
    out = torch.empty_like(x)
    n = len(kernel_sizes)
    ks = (ctypes.c_int * n)(*kernel_sizes)
    n_pairs = (ctypes.c_int * n)(*(len(d) for d in dilation_sizes))
    dils = (ctypes.c_int * (n * _MAX_PAIRS))(
        *(d[i] if i < len(d) else 0 for d in dilation_sizes for i in range(_MAX_PAIRS))
    )
    lib = build.load("resblock_trio").lib
    rc = lib.sovits_resblock_trio(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, c, n,
        ks, n_pairs, dils, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "resblock_trio launch")
    fused_resblock_trio.launches += 1
    return out


fused_resblock_trio.launches = 0  # kernel launches since the last reset
