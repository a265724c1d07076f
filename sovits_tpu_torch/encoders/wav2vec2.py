"""wav2vec2/HuBERT-family speech encoder (counterpart of
``sovits_tpu/encoders/wav2vec2.py``), with fairseq HuBERT parameter names
so a ContentVec checkpoint's state_dict loads directly.

waveform [B, L] at 16 kHz -> 7 strided convs (group norm on the first,
exact GELU) -> LayerNorm -> Linear -> + grouped positional conv (weight
norm over dim 2) -> LayerNorm -> N post-LN transformer layers -> [B, T, d].
Attention is plain PyTorch: the JAX package has no kernel here.

``Wav2Vec2Encoder(cfg, dtype)`` computes in ``dtype`` as the JAX module
does: parameters stay float32, convs and dense layers run in ``dtype``, the
group and layer norms take float32 statistics and return ``dtype``, and the
attention softmax is float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import Cast, Conv1d, Linear, WeightNormed, set_compute_dtype


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    conv_layers: Sequence[tuple[int, int, int]] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    output_layer: int | None = None  # tap the N-th layer's output (1-based)
    final_proj_dim: int | None = None
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16


class LayerNorm(Cast, nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


class GroupNorm(Cast, nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.dtype)


class PosConv(WeightNormed):
    """fairseq's weight_norm(Conv1d, dim=2): one gain per kernel tap."""

    _g_dim = 2

    def __init__(self, d: int, kernel_size: int, groups: int):
        self.groups = groups
        self.kernel_size = kernel_size
        super().__init__((d, d // groups, kernel_size), d, True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.to(self.dtype), self.effective_weight(), self.cast_bias(),
                     padding=self.kernel_size // 2, groups=self.groups)
        if self.kernel_size % 2 == 0:
            y = y[:, :, :-1]  # fairseq SamePad
        return F.gelu(y)


class SelfAttention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_heads
        hd = d // h
        q = self.q_proj(x).view(b, t, h, hd).transpose(1, 2) / math.sqrt(hd)
        k = self.k_proj(x).view(b, t, h, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, t, h, hd).transpose(1, 2)
        p = torch.softmax(torch.matmul(q, k.transpose(2, 3)).float(), dim=-1).to(v.dtype)
        return self.out_proj(torch.matmul(p, v).transpose(1, 2).reshape(b, t, d))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.self_attn = SelfAttention(cfg.d_model, cfg.n_heads)
        self.self_attn_layer_norm = LayerNorm(cfg.d_model, eps=1e-5)
        self.fc1 = Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class FeatureExtractor(nn.Module):
    def __init__(self, conv_layers):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        in_ch = 1
        for i, (ch, k, s) in enumerate(conv_layers):
            conv = Conv1d(in_ch, ch, k, stride=s, bias=False)
            # fairseq's Sequential(conv, dropout, [group norm], GELU) indexing
            if i == 0:
                block = nn.Sequential(conv, nn.Identity(), GroupNorm(ch, ch, eps=1e-5), nn.GELU())
            else:
                block = nn.Sequential(conv, nn.Identity(), nn.GELU())
            self.conv_layers.append(block)
            in_ch = ch

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for block in self.conv_layers:
            x = block(x)
        return x  # [B, C, T]


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, n_layers: int):
        super().__init__()
        self.pos_conv = nn.ModuleList([PosConv(cfg.d_model, cfg.pos_conv_kernel, cfg.pos_conv_groups)])
        self.layer_norm = LayerNorm(cfg.d_model, eps=1e-5)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(n_layers))


class Wav2Vec2Encoder(nn.Module):
    """16 kHz waveform [B, L] -> features [B, T, d] at a 320-sample hop."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.hidden_dim = cfg.final_proj_dim or cfg.d_model
        feat = cfg.conv_layers[-1][0]
        self.feature_extractor = FeatureExtractor(cfg.conv_layers)
        self.layer_norm = LayerNorm(feat, eps=1e-5)
        self.post_extract_proj = Linear(feat, cfg.d_model)
        self.encoder = Encoder(cfg, cfg.output_layer or cfg.n_layers)
        if cfg.final_proj_dim:
            self.final_proj = Linear(cfg.d_model, cfg.final_proj_dim)
        set_compute_dtype(self, dtype)

    @torch.no_grad()
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feature_extractor(wav).transpose(1, 2)  # [B, T, C]
        x = self.post_extract_proj(self.layer_norm(x))
        x = x + self.encoder.pos_conv[0](x.transpose(1, 2)).transpose(1, 2)
        x = self.encoder.layer_norm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        if self.cfg.final_proj_dim:
            x = self.final_proj(x)
        return x
