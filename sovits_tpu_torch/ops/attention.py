"""Fused relative-position attention: CUDA kernels, their autograd Function,
and the plain versions.

Counterpart of ``sovits_tpu/ops/attention.py::fused_attention`` (forward
and backward). Inputs are [BH, T, D] with q pre-scaled by 1/sqrt(D);
``rel_k``/``rel_v`` are the shared [2w+1, D] Shaw tables; ``key_mask`` is
[BH, T] with 0 for a masked key; ``drop_mask`` is an optional [BH, T, T]
dropout mask of keep/(1-rate) values, drawn by the caller. Masked and
causal scores are *replaced* by -1e4, so a fully masked row softmaxes to a
uniform row, as in the reference.

Types, as the TPU kernel's: q, k, v and the rel tables in fp32 or bf16 (the
tables are cast to q's type, as ``fused_attention`` casts them there); the
masks are stored fp32 (the dropout mask holding the values JAX gives it in
q's type: ``nn.dropout.keep_mask``). Scores, band and softmax are fp32; p is
rounded to the input type before p . v and the band sums; the output is in
the input type. The backward takes both types too, with the TPU backward
kernel's rounding points (:func:`fused_attention_bwd_plain`): out, dout,
dq, dk and dv in q's type, the LSE fp32, the rel-table gradients summed in
fp32 and returned in the tables' type.

``fused_attention`` dispatches by device: CPU tensors go to the plain
versions; CUDA tensors launch ``csrc/rel_attention.cu`` (forward) and, when
a gradient is needed, ``csrc/rel_attention_bwd.cu`` (backward), or raise.
The forward is the operator ``sovits::rel_attention_fwd``, so that an
exported program keeps the kernel; the backward stays a direct call inside
:class:`FusedAttention`, which exported programs (inference) never reach.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import build

NEG = -1e4  # the reference's masking constant
SMEM_LIMIT = 232_448  # bytes of shared memory one block may opt in to on an H100
# the backward kernel's tiling (csrc/rel_attention_bwd.cu). fp32: query rows
# per pass-(a) block and keys per tile it streams (two in flight); keys per
# pass-(b) block and query rows per tile it streams (two in flight). bf16:
# rows a block of either pass owns, and rows per tile it streams
_Q_ROWS, _BKT = 32, 16
_KV_KEYS, _QT = 32, 32
_BF_ROWS, _BF_TILE = 16, 64


def _diag_rows(off: int, t: int) -> slice:
    """Query rows r of the diagonal u = r + off inside a [T, T] matrix."""
    start = max(-off, 0)
    return slice(start, max(start, t - max(off, 0)))  # never a negative (wrapping) stop


def _to_band(m: torch.Tensor, window: int) -> torch.Tensor:
    """[BH, T, T] -> [BH, T, 2w+1]: entry (t, o) is m[t, t + o - w], 0 off the matrix."""
    t = m.shape[1]
    band = m.new_zeros(m.shape[0], t, 2 * window + 1)
    for o in range(2 * window + 1):
        band[:, _diag_rows(o - window, t), o] = m.diagonal(offset=o - window, dim1=1, dim2=2)
    return band


def _add_band_(m: torch.Tensor, band: torch.Tensor, window: int) -> torch.Tensor:
    """Inverse placement of :func:`_to_band`, added in place along the
    diagonals: m[t, t + o - w] += band[t, o]. Returns m."""
    t = m.shape[1]
    for o in range(2 * window + 1):
        m.diagonal(offset=o - window, dim1=1, dim2=2).add_(band[:, _diag_rows(o - window, t), o])
    return m


def _scores(q, k, rel_k, key_mask, window, causal) -> torch.Tensor:
    """q . k^T with the band added and the masks replayed, all in fp32 (bf16
    inputs are widened: their products are exact in fp32)."""
    t = q.shape[1]
    q = q.float()
    scores = torch.matmul(q, k.float().transpose(1, 2))
    if window is not None:
        _add_band_(scores, torch.matmul(q, rel_k.float().t()), window)
    if causal:
        scores = scores.masked_fill(torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1), NEG)
    if key_mask is not None:
        scores = scores.masked_fill(~(key_mask[:, None, :] > 0), NEG)
    return scores


def _probs(q, k, rel_k, key_mask, window, causal) -> torch.Tensor:
    """The fp32 softmax, rounded to the input type (the TPU kernel's p_lo)."""
    return torch.softmax(_scores(q, k, rel_k, key_mask, window, causal), dim=-1).to(q.dtype)


def fused_attention_plain(q, k, v, rel_k=None, rel_v=None, key_mask=None, drop_mask=None, *,
                          window: int | None = None, causal: bool = False) -> torch.Tensor:
    """Dense PyTorch version of the forward kernel: the whole [BH, T, T] at
    once, its sums in fp32 and the output in the input type."""
    pt = _probs(q, k, rel_k, key_mask, window, causal).float()
    if drop_mask is not None:
        pt = pt * drop_mask
    out = torch.matmul(pt.to(q.dtype).float(), v.float())
    if window is not None:
        out = out + torch.matmul(_to_band(pt, window), rel_v.float())
    return out.to(q.dtype)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and widened back to fp32 (the identity for fp32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def fused_attention_bwd_plain(q, k, v, rel_k, rel_v, key_mask, drop_mask, dout, *,
                              window: int | None = None, causal: bool = False):
    """The TPU backward kernel (``_bwd_kernel``) step by step in PyTorch, with
    its rounding points: every product in fp32 on inputs in q's type; p is
    the forward's p rounded to q's type; pt = p dm, ds and both bands are
    rounded to q's type where a product takes them; g, D = rowsum(g p) and
    ds = p (g - D) stay fp32. In fp32 every rounding is the identity.
    Returns (dq, dk, dv) in q's type and (drel_k, drel_v), summed in fp32,
    in the tables' type; the rel grads are None without a window."""
    lo = q.dtype
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
    p = _probs(q, k, rel_k, key_mask, window, causal).float()  # p_lo, widened
    pt = p * drop_mask if drop_mask is not None else p
    dv = torch.matmul(_rounded(pt, lo).transpose(1, 2), do32)
    g = torch.matmul(do32, v32.transpose(1, 2))  # d(pt), before the value band
    drel_k = drel_v = None
    if window is not None:
        drel_v = torch.matmul(_rounded(_to_band(pt, window), lo).transpose(1, 2), do32).sum(0)
        _add_band_(g, torch.matmul(do32, rel_v.float().t()), window)
    if drop_mask is not None:
        g = g * drop_mask
    ds = p * (g - (g * p).sum(-1, keepdim=True))  # softmax VJP
    ds_lo = _rounded(ds, lo)
    dq = torch.matmul(ds_lo, k32)
    dk = torch.matmul(ds_lo.transpose(1, 2), q32)
    if window is not None:
        ds_band = _rounded(_to_band(ds, window), lo)
        dq = dq + torch.matmul(ds_band, rel_k.float())
        drel_k = torch.matmul(ds_band.transpose(1, 2), q32).sum(0).to(rel_k.dtype)
        drel_v = drel_v.to(rel_v.dtype)
    return dq.to(lo), dk.to(lo), dv.to(lo), drel_k, drel_v


@dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel tiles one call: pass (a) (dq, D, the rel-table
    partials) in blocks of ``q_rows`` query rows, one partial each; pass (b)
    (dk, dv) in blocks of ``kv_keys`` keys; ``smem_q``/``smem_kv`` bytes of
    shared memory a block; ``row_bytes`` the row stride of the streamed
    tiles of pass (a) and of pass (b), in bytes."""

    q_rows: int
    kv_keys: int
    smem_q: int
    smem_kv: int
    row_bytes: tuple[int, int]

    def blocks(self, t: int) -> tuple[int, int]:
        """Blocks along T of pass (a) and of pass (b), each covering T."""
        return -(-t // self.q_rows), -(-t // self.kv_keys)


def bwd_plan(d: int, window: int | None, dtype: torch.dtype) -> BwdPlan:
    """The tiling of ``csrc/rel_attention_bwd.cu`` for head width ``d``, which
    its entry point checks again. Both types run on the tensor cores, rows of
    d zero-padded to dp = 32, 64, 96 or 128. fp32: (a) 32 query rows (q and
    dout resident, rows of dp + 8 words) against double-buffered 16-key K
    and V tiles, then fp32 band tables of 2w+1 entries a row; (b) 32 keys (K
    and V resident, rows of dp + 4 words) against double-buffered 32-row q
    and dout tiles. bf16: a block of either pass owns 16 rows ((a) query
    rows, (b) keys; two tensors resident) against double-buffered 64-row
    tiles of the other two, rows of dp + 8 elements (16-byte aligned, an
    odd number of 16-byte chunks: ldmatrix without bank conflicts); (a)
    adds the band tables and 4 warps' parts of D."""
    if dtype not in (torch.float32, torch.bfloat16) or not 1 <= d <= 128:
        raise ValueError(f"bwd_plan: float32 or bfloat16 and 1 <= D <= 128, got {dtype}, {d}")
    win = 0 if window is None else 2 * window + 1
    dp = -(-d // 32) * 32
    if dtype == torch.bfloat16:
        row, warps = 2 * (dp + 8), _BF_TILE // 16
        tiles = row * (2 * _BF_ROWS + 4 * _BF_TILE)
        plan = BwdPlan(_BF_ROWS, _BF_ROWS, tiles + 4 * (2 * win * d + 4 * _BF_ROWS * win + warps * _BF_ROWS),
                       tiles, (row, row))
    else:
        plan = BwdPlan(_Q_ROWS, _KV_KEYS,
                       4 * ((2 * _Q_ROWS + 4 * _BKT) * (dp + 8) + 2 * win * d + 4 * _Q_ROWS * win),
                       4 * (2 * _KV_KEYS + 4 * _QT) * (dp + 4), (4 * (dp + 8), 4 * (dp + 4)))
    if max(plan.smem_q, plan.smem_kv) > SMEM_LIMIT:
        raise ValueError(f"bwd_plan: window {window} needs more shared memory than a block has")
    return plan


def bwd_scratch(plan: BwdPlan, bh: int, t: int, d: int, window: int | None, device):
    """The backward kernel's fp32 scratch: D per row [BH, T]; without a
    window None, None, else the per-row band products [BH, T, 2 (2w+1)] and
    the rel-table partials [pass (a)'s blocks x BH, 2, 2w+1, D]."""
    dvec = torch.empty(bh, t, device=device, dtype=torch.float32)
    if window is None:
        return dvec, None, None
    win = 2 * window + 1
    band = torch.empty(bh, t, 2 * win, device=device, dtype=torch.float32)
    part = torch.empty(plan.blocks(t)[0] * bh, 2, win, d, device=device, dtype=torch.float32)
    return dvec, band, part


def _check(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, what: str) -> None:
    """Raise on what the kernels do not take: q, k, v and the rel tables of
    one type, fp32 or bf16; float32 masks (the dropout mask's values are
    those of q's type, as ``nn.dropout.keep_mask`` makes them); all
    contiguous on q's device."""
    bh, t, d = q.shape
    dtypes = (torch.float32, torch.bfloat16)
    if q.dtype not in dtypes:
        raise ValueError(f"{what}: q/k/v must be one of {dtypes}, got {q.dtype}")
    for x in (q, k, v, rel_k, rel_v, key_mask, drop_mask):
        if x is None:
            continue
        want = torch.float32 if x is key_mask or x is drop_mask else q.dtype
        if x.device != q.device or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"{what}: contiguous tensors on one CUDA device: q, k, v and the "
                             f"rel tables {q.dtype}, the masks float32")
    if k.shape != q.shape or v.shape != q.shape or not 1 <= d <= 128:
        raise ValueError(f"{what}: q/k/v must share [BH, T, D<=128], got {tuple(q.shape)}")
    if window is not None and (rel_k.shape != (2 * window + 1, d) or rel_v.shape != rel_k.shape):
        raise ValueError(f"{what}: rel tables must be [{2 * window + 1}, {d}]")
    if key_mask is not None and key_mask.shape != (bh, t):
        raise ValueError(f"{what}: key_mask must be [{bh}, {t}]")
    if drop_mask is not None and drop_mask.shape != (bh, t, t):
        raise ValueError(f"{what}: drop_mask must be [{bh}, {t}, {t}]")


def _ptr(x: torch.Tensor | None):
    return x.data_ptr() if x is not None else None


def _forward(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal, want_lse: bool):
    """(out, lse) through the ``sovits::rel_attention_fwd`` op: CPU tensors
    take the plain version (lse None); CUDA tensors launch the forward kernel."""
    out, lse = rel_attention_fwd(q, k, v, rel_k, rel_v, key_mask, drop_mask,
                                 -1 if window is None else window, causal, want_lse)
    return out, lse if q.device.type == "cuda" and want_lse else None


# The forward kernel as an operator a tracer keeps opaque (``torch.export``
# records the call, not the pointers handed to ctypes). ``window`` -1 is no
# window. Returns (out, lse): lse is float32 [BH, T] when CUDA tensors ask
# for it, else empty. The dispatcher picks the implementation by device: the
# plain version on the CPU, the kernel on CUDA (which launches or raises);
# another device has none and raises. Defined through ``torch.library.Library``
# with no autograd kernel of its own (``FusedAttention`` holds the gradient):
# a call costs one Python kernel, not custom_op's autograd wrapper around it
# (``tools/surfaces_ab.py`` times both).
_LIB = torch.library.Library("sovits", "FRAGMENT")
_LIB.define("rel_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor? rel_k, Tensor? rel_v, "
            "Tensor? key_mask, Tensor? drop_mask, int window, bool causal, bool want_lse) -> (Tensor, Tensor)")


def _plain_fwd(q, k, v, rel_k, rel_v, key_mask, drop_mask, window: int, causal: bool,
               want_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The operator's CPU implementation: the plain version, an empty lse."""
    out = fused_attention_plain(q, k, v, rel_k, rel_v, key_mask, drop_mask,
                                window=None if window < 0 else window, causal=causal)
    return out, q.new_empty(0, dtype=torch.float32)


def _launch_fwd(q, k, v, rel_k, rel_v, key_mask, drop_mask, window: int, causal: bool,
                want_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: check the inputs and launch the
    forward kernel (callable without the dispatcher to time what it adds)."""
    _check(q, k, v, rel_k, rel_v, key_mask, drop_mask, None if window < 0 else window, "fused_attention")
    bh, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t) if want_lse else (0,), device=q.device, dtype=torch.float32)
    rc = build.load("rel_attention").lib.sovits_rel_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rel_k), _ptr(rel_v), _ptr(key_mask),
        _ptr(drop_mask), out.data_ptr(), _ptr(lse) if want_lse else None, bh, t, d, window,
        int(causal), int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "rel_attention launch")
    fused_attention.launches += 1
    fused_attention.launches_bf16 += q.dtype == torch.bfloat16
    return out, lse


def _fake_fwd(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal, want_lse):
    lse_shape = q.shape[:2] if want_lse and q.device.type == "cuda" else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


_LIB.impl("rel_attention_fwd", _plain_fwd, "CPU")
_LIB.impl("rel_attention_fwd", _launch_fwd, "CUDA")
torch.library.register_fake("sovits::rel_attention_fwd", _fake_fwd, lib=_LIB)
rel_attention_fwd = torch.ops.sovits.rel_attention_fwd.default


def fused_attention_bwd(q, k, v, rel_k, rel_v, key_mask, drop_mask, out, lse, dout, *,
                        window: int | None = None, causal: bool = False):
    """(dq, dk, dv, drel_k, drel_v) of the fused attention, in fp32 or bf16.
    CPU tensors take :func:`fused_attention_bwd_plain`; CUDA tensors launch
    the backward kernel on the forward's ``out`` and log-sum-exp ``lse``, or
    raise."""
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, rel_k, rel_v, key_mask, drop_mask, dout,
                                         window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: unsupported device {q.device}")
    _check(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, "fused_attention_bwd")
    for x in (out, dout):
        if x.shape != q.shape or x.dtype != q.dtype or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"fused_attention_bwd: out and dout must be contiguous {q.dtype} like q")
    bh, t, d = q.shape
    if lse is None or lse.shape != (bh, t) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"fused_attention_bwd: lse must be float32 [{bh}, {t}] on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    plan = bwd_plan(d, window, q.dtype)
    q_blocks, kv_blocks = plan.blocks(t)
    dvec, band, part = bwd_scratch(plan, bh, t, d, window, q.device)
    rc = build.load("rel_attention_bwd").lib.sovits_rel_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rel_k), _ptr(rel_v), _ptr(key_mask),
        _ptr(drop_mask), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(), _ptr(band), _ptr(part), bh, t, d,
        -1 if window is None else window, int(causal), int(q.dtype == torch.bfloat16), q_blocks, kv_blocks,
        plan.smem_q, plan.smem_kv, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "rel_attention_bwd launch")
    fused_attention_bwd.launches += 1
    fused_attention_bwd.launches_bf16 += q.dtype == torch.bfloat16
    if window is None:
        return dq, dk, dv, None, None
    drel = part.sum(0)  # the per-block partials, summed as the JAX package sums its own
    return dq, dk, dv, drel[0].to(rel_k.dtype), drel[1].to(rel_v.dtype)


class FusedAttention(torch.autograd.Function):
    """Forward kernel (saving out and the per-row log-sum-exp), backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal):
        out, lse = _forward(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal,
                            want_lse=True)
        ctx.save_for_backward(q, k, v, rel_k, rel_v, key_mask, drop_mask, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_k, rel_v, key_mask, drop_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, drel_k, drel_v = fused_attention_bwd(
            q, k, v, rel_k, rel_v, key_mask, drop_mask, out, lse, dout.contiguous(),
            window=ctx.window, causal=ctx.causal,
        )
        return dq, dk, dv, drel_k, drel_v, None, None, None, None


def fused_attention(q, k, v, rel_k=None, rel_v=None, key_mask=None, drop_mask=None, *,
                    window: int | None = None, causal: bool = False) -> torch.Tensor:
    """Fused attention. Returns [BH, T, D].

    Device dispatch, not a fallback: CPU tensors take the plain versions;
    CUDA tensors launch the kernels, and anything they do not take raises.
    When autograd needs a gradient the call goes through
    :class:`FusedAttention`; otherwise the forward kernel runs alone.
    """
    if (window is None) != (rel_k is None) or (rel_k is None) != (rel_v is None):
        raise ValueError("rel_k and rel_v are given exactly when window is")
    if window is not None:  # the tables in q's type, as the JAX wrapper casts them
        rel_k, rel_v = rel_k.to(q.dtype), rel_v.to(q.dtype)
    trained = [x for x in (q, k, v, rel_k, rel_v) if x is not None and x.requires_grad]
    if torch.is_grad_enabled() and trained:
        return FusedAttention.apply(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal)
    return _forward(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal, want_lse=False)[0]


fused_attention.launches = 0  # forward kernel launches since the last reset
fused_attention.launches_bf16 = 0  # of which with bf16 inputs
fused_attention_bwd.launches = 0  # backward kernel launches since the last reset
fused_attention_bwd.launches_bf16 = 0  # of which with bf16 inputs
