"""Fused relative-position attention: CUDA kernel wrapper and plain version.

Counterpart of ``sovits_tpu/ops/attention.py::fused_attention`` (forward).
Inputs are [BH, T, D] with q pre-scaled by 1/sqrt(D); ``rel_k``/``rel_v``
are the shared [2w+1, D] Shaw tables; ``key_mask`` is [BH, T] with 0 for a
masked key. Masked and causal scores are *replaced* by -1e4, so a fully
masked row softmaxes to a uniform row, as in the reference.

``fused_attention`` dispatches by device: a CPU tensor goes to
``fused_attention_plain``; a CUDA tensor launches ``csrc/rel_attention.cu``
or raises.
"""

from __future__ import annotations

import torch

from . import build

NEG = -1e4  # the reference's masking constant


def _diag_rows(off: int, t: int, device) -> torch.Tensor:
    """Query rows r of the diagonal u = r + off inside a [T, T] matrix."""
    start = max(-off, 0)
    return torch.arange(start, max(start, t - max(off, 0)), device=device)


def fused_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_k: torch.Tensor | None = None,
    rel_v: torch.Tensor | None = None,
    key_mask: torch.Tensor | None = None,
    *,
    window: int | None = None,
    causal: bool = False,
) -> torch.Tensor:
    """Dense PyTorch version of the kernel: the whole [BH, T, T] at once."""
    t = q.shape[1]
    scores = torch.matmul(q, k.transpose(1, 2)).float()
    if window is not None:
        rl = torch.matmul(q, rel_k.to(q.dtype).t()).float()  # [BH, T, 2w+1]
        for o in range(2 * window + 1):
            off = o - window  # key index u = t + off
            rows = _diag_rows(off, t, q.device)
            scores.diagonal(offset=off, dim1=1, dim2=2).add_(rl[:, rows, o])
    if causal:
        scores = scores.masked_fill(torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1), NEG)
    if key_mask is not None:
        scores = scores.masked_fill(~(key_mask[:, None, :] > 0), NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(p, v)
    if window is not None:
        band = torch.zeros(q.shape[0], t, 2 * window + 1, dtype=p.dtype, device=q.device)
        for o in range(2 * window + 1):
            off = o - window
            rows = _diag_rows(off, t, q.device)
            band[:, rows, o] = p.diagonal(offset=off, dim1=1, dim2=2)
        out = out + torch.matmul(band, rel_v.to(out.dtype))
    return out


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_k: torch.Tensor | None = None,
    rel_v: torch.Tensor | None = None,
    key_mask: torch.Tensor | None = None,
    *,
    window: int | None = None,
    causal: bool = False,
) -> torch.Tensor:
    """Fused attention forward. Returns [BH, T, D].

    Device dispatch, not a fallback: CPU tensors take the plain version;
    CUDA tensors launch the kernel, and anything it does not take raises.
    """
    if (window is None) != (rel_k is None) or (rel_k is None) != (rel_v is None):
        raise ValueError("rel_k and rel_v are given exactly when window is")
    if q.device.type == "cpu":
        return fused_attention_plain(
            q, k, v, rel_k, rel_v, key_mask, window=window, causal=causal
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    bh, t, d = q.shape
    tensors = [q, k, v] + ([rel_k, rel_v] if window is not None else [])
    tensors += [key_mask] if key_mask is not None else []
    for x in tensors:
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("fused_attention: contiguous float32 tensors on one CUDA device")
    if k.shape != q.shape or v.shape != q.shape or not 1 <= d <= 128:
        raise ValueError(f"fused_attention: q/k/v must share [BH, T, D<=128], got {q.shape}")
    if window is not None and (rel_k.shape != (2 * window + 1, d) or rel_v.shape != rel_k.shape):
        raise ValueError(f"fused_attention: rel tables must be [{2 * window + 1}, {d}]")
    if key_mask is not None and key_mask.shape != (bh, t):
        raise ValueError(f"fused_attention: key_mask must be [{bh}, {t}]")
    out = torch.empty_like(q)
    lib = build.load("rel_attention").lib
    rc = lib.sovits_rel_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        rel_k.data_ptr() if window is not None else None,
        rel_v.data_ptr() if window is not None else None,
        key_mask.data_ptr() if key_mask is not None else None,
        out.data_ptr(), bh, t, d, -1 if window is None else window, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "rel_attention launch")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0  # kernel launches since the last reset
