"""Relative-position MHA, Encoder, causal FFT and conv FFN (counterpart of
``sovits_tpu/nn/attention.py``; so-vits-svc ``modules/attentions.py``).

Modules run channels-first [B, C, T] and keep so-vits-svc's parameter names
(``conv_q``, ``emb_rel_k``, ``norm_layers_1`` ...). Self-attention in the
structured forms the kernel takes -- Shaw window with a shared table plus a
key mask (ContentEncoder), or causal (F0Decoder) -- goes through
``ops.attention.fused_attention``; anything else takes the dense path here.

Dropout sits where the JAX package puts it: on the attention weights (as a
[B*H, T, T] keep mask handed to the kernel, with the values JAX gives it in
q's type, or as ``nn.dropout.dropout`` on the fp32 ``p_attn`` in the dense
path), after the FFN's activation, and on both residual branches of the
Encoder and FFT layers. It is active only when a ``drop_generator`` is
passed; inference passes none and is deterministic.

Compute type (``nn.conv.Cast``), as the JAX modules': the projections run
in it, so q/k/v reach the kernel in it; the dense path's scores are in it
and its softmax in float32; the LayerNorms' statistics are float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import NEG, fused_attention
from .conv import Conv1d, WNConv1d
from .dropout import dropout, keep_mask
from .norm import LayerNorm
from .wavenet import gated_tanh_sigmoid


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] relative logits -> [B, H, L, L] absolute."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, length * 2 * length)
    x = F.pad(x, (0, length - 1)).reshape(b, h, length + 1, 2 * length - 1)
    return x[:, :, :length, length - 1 :]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] attention weights -> [B, H, L, 2L-1] relative."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, length - 1)).reshape(b, h, length * length + length * (length - 1))
    x = F.pad(x, (length, 0)).reshape(b, h, length, 2 * length)
    return x[:, :, :, 1:]


def _window_relative_embeddings(emb: torch.Tensor, length: int, window: int) -> torch.Tensor:
    """Slice/pad the [G, 2w+1, d] table to [G, 2L-1, d]."""
    pad_len = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start : start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int | None = None, p_dropout: float = 0.0):
        super().__init__()
        if channels % n_heads:
            raise ValueError("channels must divide into heads")
        self.p_dropout = p_dropout
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        if window_size is not None:  # one Shaw table shared by all heads, as so-vits-svc
            std = self.k_channels**-0.5
            self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)
            self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.k_channels) * std)

    def _fused_eligible(self, t_t: int, t_s: int, causal: bool, key_mask, attn_mask) -> bool:
        """The JAX package's rule, minus its TPU-only and T <= 1024 limits."""
        if t_t != t_s:
            return False
        if attn_mask is not None and key_mask is None and not causal:
            return False  # a free-form mask is not representable in the kernel
        if self.window_size is not None:
            return t_s >= 2 * self.window_size + 1
        return causal or key_mask is not None

    def forward(self, x: torch.Tensor, c: torch.Tensor, attn_mask: torch.Tensor | None = None,
                key_mask: torch.Tensor | None = None, causal: bool = False,
                drop_generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, C, T_t] queries, c [B, C, T_s] keys/values; attn_mask
        [B, 1, T_t, T_s] (0 = masked); key_mask [B, T_s] its structured form."""
        b, ch, t_t = x.shape
        t_s = c.shape[2]
        h, d = self.n_heads, self.k_channels
        q = self.conv_q(x).view(b, h, d, t_t).transpose(2, 3) / math.sqrt(d)
        k = self.conv_k(c).view(b, h, d, t_s).transpose(2, 3)
        v = self.conv_v(c).view(b, h, d, t_s).transpose(2, 3)
        w = self.window_size

        if self._fused_eligible(t_t, t_s, causal, key_mask, attn_mask):
            dm = None
            if drop_generator is not None and self.p_dropout > 0.0:
                dm = keep_mask((b * h, t_t, t_s), self.p_dropout, drop_generator, x.device, q.dtype)
            km = key_mask.float().repeat_interleave(h, dim=0).contiguous() if key_mask is not None else None
            out = fused_attention(
                q.reshape(b * h, t_t, d).contiguous(),
                k.reshape(b * h, t_s, d).contiguous(),
                v.reshape(b * h, t_s, d).contiguous(),
                self.emb_rel_k[0].contiguous() if w is not None else None,
                self.emb_rel_v[0].contiguous() if w is not None else None,
                km, dm, window=w, causal=causal,
            ).view(b, h, t_t, d)
        else:
            scores = torch.matmul(q, k.transpose(2, 3))
            if w is not None:
                key_rel = _window_relative_embeddings(self.emb_rel_k, t_s, w)
                scores = scores + _relative_to_absolute(
                    torch.einsum("bhtd,gmd->bhtm", q, key_rel.to(q.dtype)))
            if causal:
                tri = torch.ones(t_t, t_s, dtype=torch.bool, device=x.device).triu(1)
                scores = scores.masked_fill(tri, NEG)
            if attn_mask is not None:
                scores = scores.masked_fill(attn_mask == 0, NEG)
            p = dropout(torch.softmax(scores.float(), dim=-1), self.p_dropout, drop_generator)
            p = p.to(v.dtype)
            out = torch.matmul(p, v)
            if w is not None:
                value_rel = _window_relative_embeddings(self.emb_rel_v, t_s, w).to(p.dtype)
                out = out + torch.einsum("bhtm,gmd->bhtd", _absolute_to_relative(p), value_rel)
        return self.conv_o(out.transpose(2, 3).reshape(b, ch, t_t))


class FFN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, causal: bool = False, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)
        if kernel_size == 1:
            self.pad = (0, 0)
        elif causal:
            self.pad = (kernel_size - 1, 0)
        else:
            self.pad = ((kernel_size - 1) // 2, kernel_size // 2)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                drop_generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.conv_1(F.pad(x * x_mask, self.pad)))
        x = dropout(x, self.p_dropout, drop_generator)
        return self.conv_2(F.pad(x * x_mask, self.pad)) * x_mask


class Encoder(nn.Module):
    """Post-LN self-attention stack with windowed relative attention."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int = 1, window_size: int = 4, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads, window_size=window_size,
                               p_dropout=p_dropout)
            for _ in range(n_layers)
        )
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size, p_dropout=p_dropout)
            for _ in range(n_layers)
        )
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                drop_generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, C, T], x_mask [B, 1, T]."""
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)  # [B, 1, T, T]
        key_mask = x_mask[:, 0]
        p, gen = self.p_dropout, drop_generator
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                          self.ffn_layers, self.norm_layers_2):
            y = attn(x, x, attn_mask, key_mask=key_mask, drop_generator=gen)
            x = norm1(x + dropout(y, p, gen))
            x = norm2(x + dropout(ffn(x, x_mask, gen), p, gen))
        return x * x_mask


class FFT(nn.Module):
    """Causal self-attention stack: the F0Decoder's, and with ``isflow`` the
    transformer flow's inner net, conditioned on g (so-vits-svc ``FFT``)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int = 1, kernel_size: int = 1, p_dropout: float = 0.0,
                 isflow: bool = False, gin_channels: int = 0):
        super().__init__()
        self.p_dropout = p_dropout
        self.hidden_channels = hidden_channels
        if isflow:
            # one 1x1 conv makes every layer's gate offsets; one pre-gate
            # projection is shared by all layers
            self.cond_layer = WNConv1d(gin_channels, 2 * hidden_channels * n_layers, 1)
            self.cond_pre = Conv1d(hidden_channels, 2 * hidden_channels, 1)
        self.self_attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads, p_dropout=p_dropout)
            for _ in range(n_layers)
        )
        self.norm_layers_0 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size, causal=True,
                p_dropout=p_dropout)
            for _ in range(n_layers)
        )
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                drop_generator: torch.Generator | None = None,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H, T], x_mask [B, 1, T]; g [B, gin, 1 or T] gates each layer's
        input when the stack is a flow's."""
        p, gen, h = self.p_dropout, drop_generator, self.hidden_channels
        g_all = self.cond_layer(g) if g is not None and hasattr(self, "cond_layer") else None
        x = x * x_mask
        for i, (attn, norm0, ffn, norm1) in enumerate(zip(
                self.self_attn_layers, self.norm_layers_0, self.ffn_layers, self.norm_layers_1)):
            if g_all is not None:
                x = gated_tanh_sigmoid(self.cond_pre(x), g_all[:, i * 2 * h : (i + 1) * 2 * h])
            x = norm0(x + dropout(attn(x, x, causal=True, drop_generator=gen), p, gen))
            x = norm1(x + dropout(ffn(x, x_mask, gen), p, gen))
        return x * x_mask
