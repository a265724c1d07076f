"""DPHuBERT speech encoder (counterpart of ``sovits_tpu/encoders/dphubert.py``),
with torchaudio's wav2vec2 parameter names so a ``DPHuBERT-sp0.75.pth``'s
``state_dict`` loads directly.

A pruned wav2vec2 built from the checkpoint's ``config``: the conv stack
(a per-channel GroupNorm on conv 0 in ``group_norm`` mode, conv biases only
with ``extractor_conv_bias``), the feature projection, the weight-normed
grouped positional conv (an even kernel drops the last frame), then layers
with their own head counts and FFN widths; a layer's attention or FFN is
absent when its flag is false or its width is 0. As in the JAX package every
layer is post-norm, and the encoder LayerNorm sits after the positional
conv when ``encoder_layer_norm_first`` is false and after the layers when it
is true (torchaudio's ``_get_encoder`` inverts the flag for the wrapper).
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from .factory import SpeechEncoder
from .wav2vec2 import GroupNorm, LayerNorm, PosConv


class ConvLayerBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, bias: bool, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.layer_norm = GroupNorm(out_ch, out_ch, eps=1e-5) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        group_norm = cfg.get("extractor_mode", "group_norm") == "group_norm"
        bias = bool(cfg.get("extractor_conv_bias", False))
        in_ch, layers = 1, []
        for i, (ch, k, s) in enumerate(cfg["extractor_conv_layer_config"]):
            layers.append(ConvLayerBlock(in_ch, ch, k, s, bias, group_norm and i == 0))
            in_ch = ch
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)  # [B, T, C]


class FeatureProjection(nn.Module):
    def __init__(self, in_features: int, d: int):
        super().__init__()
        self.layer_norm = LayerNorm(in_features, eps=1e-5)
        self.projection = nn.Linear(in_features, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PosConvEps(PosConv):
    """The positional conv with the JAX package's 1e-12 under the norm."""

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        return super()._norm(v) + 1e-12


class ConvolutionalPositionalEmbedding(nn.Module):
    def __init__(self, d: int, kernel_size: int, groups: int):
        super().__init__()
        self.conv = PosConvEps(d, kernel_size, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, d: int, n_heads: int, head_dim: int):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        inner = n_heads * head_dim
        self.q_proj = nn.Linear(d, inner)
        self.k_proj = nn.Linear(d, inner)
        self.v_proj = nn.Linear(d, inner)
        self.out_proj = nn.Linear(inner, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = (proj(x).view(b, t, self.n_heads, self.head_dim).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, -1))


class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, hidden)
        self.output_dense = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-norm; ``attention`` or ``feed_forward`` is None when pruned away."""

    def __init__(self, d: int, n_heads: int, head_dim: int, ff_dim: int):
        super().__init__()
        self.attention = SelfAttention(d, n_heads, head_dim) if n_heads > 0 else None
        self.layer_norm = LayerNorm(d, eps=1e-5)
        self.feed_forward = FeedForward(d, ff_dim) if ff_dim > 0 else None
        self.final_layer_norm = LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.attention is not None:
            x = x + self.attention(x)
        x = self.layer_norm(x)
        if self.feed_forward is not None:
            x = x + self.feed_forward(x)
        return self.final_layer_norm(x)


class Transformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["encoder_embed_dim"]
        n = cfg["encoder_num_layers"]
        use_attn = cfg.get("encoder_use_attention", [True] * n)
        use_ff = cfg.get("encoder_use_feed_forward", [True] * n)
        self.pos_conv_embed = ConvolutionalPositionalEmbedding(
            d, cfg.get("encoder_pos_conv_kernel", 128), cfg.get("encoder_pos_conv_groups", 16))
        self.layer_norm = LayerNorm(d, eps=1e-5)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg["encoder_num_heads"][i] if use_attn[i] else 0,
                         cfg.get("encoder_head_dim", 64),
                         cfg["encoder_ff_interm_features"][i] if use_ff[i] else 0)
            for i in range(n))
        self.norm_after_layers = bool(cfg.get("encoder_layer_norm_first", False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pos_conv_embed(x)
        if not self.norm_after_layers:
            x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x) if self.norm_after_layers else x


class _Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.feature_projection = FeatureProjection(cfg["extractor_conv_layer_config"][-1][0],
                                                    cfg["encoder_embed_dim"])
        self.transformer = Transformer(cfg)


class DPHubertEncoder(nn.Module):
    """16 kHz waveform [B, L] -> features [B, T, d]; ``cfg`` is the
    checkpoint's ``config`` without ``aux_num_out``."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.hidden_dim = cfg["encoder_embed_dim"]
        self.feature_extractor = FeatureExtractor(cfg)
        self.encoder = _Encoder(cfg)

    @torch.no_grad()
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.encoder.feature_projection(self.feature_extractor(wav))
        return self.encoder.transformer(x)


def load_dphubert_encoder(path: str | Path, device: torch.device | str = "cuda") -> SpeechEncoder:
    """A DPHuBERT checkpoint ({"config", "state_dict"}); ``aux_num_out`` is
    dropped from the config and the auxiliary head's entries are ignored."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = dict(ckpt["config"])
    cfg.pop("aux_num_out", None)
    net = DPHubertEncoder(cfg)
    sd = ckpt["state_dict"]
    net.load_state_dict({k: sd[k].float() for k in net.state_dict() if k in sd}, strict=True)
    return SpeechEncoder("dphubert", net, device)
