"""WavLM speech encoder, wavlmbase+ (counterpart of ``sovits_tpu/encoders/wavlm.py``),
with fairseq/WavLM parameter names so a ``WavLM-Base+.pt``'s ``model``
state_dict loads directly.

The wav2vec2 trunk (``wav2vec2.py``'s 7-conv feature extractor, LayerNorm,
projection, weight-normed positional conv, then the encoder LayerNorm) and
post-LN layers whose attention logits carry WavLM's gated relative position
bias: layer 0 owns a T5-style bucketed table [num_buckets, H] that every
layer shares, and each layer scales it per query by
``gate_a * (gate_b * grep_a - 1) + 2``, the gates from ``grep_linear`` on
the projected query split into heads. As in the JAX package, the conv stack
and the 128-tap, 16-group positional conv are the defaults whatever the
checkpoint's ``cfg`` says. Attention is PyTorch's
``scaled_dot_product_attention`` with the bias as a float32 mask.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .factory import SpeechEncoder
from .wav2vec2 import FeatureExtractor, LayerNorm, PosConv, Wav2Vec2Config


@dataclasses.dataclass(frozen=True)
class WavLMDims:
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    num_buckets: int = 320
    max_distance: int = 800
    normalize_input: bool = False


def relative_position_buckets(length: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5 bucket indices [T, T], int64 (WavLM modules.py, bidirectional)."""
    context = np.arange(length)[:, None]
    memory = np.arange(length)[None, :]
    rel = memory - context
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


class WavLMAttention(nn.Module):
    def __init__(self, d: int, n_heads: int, num_buckets: int | None = None):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.grep_linear = nn.Linear(d // n_heads, 8)
        self.grep_a = nn.Parameter(torch.ones(1, n_heads, 1, 1))
        if num_buckets is not None:  # layer 0 only
            self.relative_attention_bias = nn.Embedding(num_buckets, n_heads)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        """x [B, T, D]; position_bias [H, T, T], shared by every layer."""
        b, t, d = x.shape
        h = self.n_heads
        q, k, v = (proj(x).view(b, t, h, d // h).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        gate_a, gate_b = torch.sigmoid(self.grep_linear(q).view(b, h, t, 2, 4).sum(-1)).unbind(-1)
        gate = gate_a * (gate_b * self.grep_a[..., 0] - 1.0) + 2.0  # [B, H, T]
        bias = (gate[..., None] * position_bias).float()  # [B, H, T, T]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class WavLMLayer(nn.Module):
    """Post-LN: attention, then the exact-GELU feed-forward."""

    def __init__(self, dims: WavLMDims, has_bias_table: bool):
        super().__init__()
        self.self_attn = WavLMAttention(dims.d_model, dims.n_heads,
                                        dims.num_buckets if has_bias_table else None)
        self.self_attn_layer_norm = LayerNorm(dims.d_model, eps=1e-5)
        self.fc1 = nn.Linear(dims.d_model, dims.ffn_dim)
        self.fc2 = nn.Linear(dims.ffn_dim, dims.d_model)
        self.final_layer_norm = LayerNorm(dims.d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, position_bias))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class _Encoder(nn.Module):
    def __init__(self, dims: WavLMDims, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv = nn.ModuleList([PosConv(dims.d_model, cfg.pos_conv_kernel, cfg.pos_conv_groups)])
        self.layer_norm = LayerNorm(dims.d_model, eps=1e-5)
        self.layers = nn.ModuleList(WavLMLayer(dims, i == 0) for i in range(dims.n_layers))


class WavLMEncoder(nn.Module):
    """16 kHz waveform [B, L] -> features [B, T, d] at a 320-sample hop."""

    def __init__(self, dims: WavLMDims = WavLMDims()):
        super().__init__()
        self.dims = dims
        self.hidden_dim = dims.d_model
        cfg = Wav2Vec2Config()  # the default conv stack and positional conv
        feat = cfg.conv_layers[-1][0]
        self.feature_extractor = FeatureExtractor(cfg.conv_layers)
        self.layer_norm = LayerNorm(feat, eps=1e-5)
        self.post_extract_proj = nn.Linear(feat, dims.d_model)
        self.encoder = _Encoder(dims, cfg)
        self._buckets: dict[tuple[int, torch.device], torch.Tensor] = {}

    def position_bias(self, t: int) -> torch.Tensor:
        """Layer 0's table at the bucket of each (query, key) pair: [H, T, T].
        The bucket table is made once per length and device: its numpy
        construction would otherwise be host work on every call."""
        table = self.encoder.layers[0].self_attn.relative_attention_bias.weight
        key = (t, table.device)
        if key not in self._buckets:
            self._buckets[key] = torch.from_numpy(relative_position_buckets(
                t, self.dims.num_buckets, self.dims.max_distance)).to(table.device)
        return table[self._buckets[key]].permute(2, 0, 1)

    @torch.no_grad()
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feature_extractor(wav).transpose(1, 2)
        x = self.post_extract_proj(self.layer_norm(x))
        x = x + self.encoder.pos_conv[0](x.transpose(1, 2)).transpose(1, 2)
        x = self.encoder.layer_norm(x)  # post-norm models: right after the positional conv
        position_bias = self.position_bias(x.shape[1])
        for layer in self.encoder.layers:
            x = layer(x, position_bias)
        return x


class WavLMSpeechEncoder(SpeechEncoder):
    """so-vits-svc's WavLMBasePlus: with the checkpoint's ``normalize``, the
    clip is standardised first (on the host, before the 1 s bucket)."""

    def prepare(self, wav: np.ndarray) -> tuple[np.ndarray, int]:
        if self.net.dims.normalize_input:
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
        return super().prepare(wav)


def load_wavlm_encoder(path: str | Path, device: torch.device | str = "cuda") -> WavLMSpeechEncoder:
    """A WavLM checkpoint ({"cfg", "model"}): the widths from ``cfg``, the
    encoder's entries of ``model`` loaded strictly (the rest, such as
    ``mask_emb``, ignored)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = ckpt.get("cfg", {})
    dims = WavLMDims(
        d_model=cfg.get("encoder_embed_dim", 768),
        n_layers=cfg.get("encoder_layers", 12),
        n_heads=cfg.get("encoder_attention_heads", 12),
        ffn_dim=cfg.get("encoder_ffn_embed_dim", 3072),
        num_buckets=cfg.get("num_buckets", 320),
        max_distance=cfg.get("max_distance", 800),
        normalize_input=cfg.get("normalize", False),
    )
    net = WavLMEncoder(dims)
    sd = ckpt["model"]
    net.load_state_dict({k: sd[k].float() for k in net.state_dict() if k in sd}, strict=True)
    return WavLMSpeechEncoder("wavlmbase+", net, device)
