"""ContentVec / HuBERT base (vec768l12) in plain PyTorch, float32: the
reference for the program's speech encoder.

fairseq's HuBERT layout and parameter names: 16 kHz audio [B, L] -> 7
strided convs without bias (group norm after the first, exact GELU) ->
LayerNorm -> Linear -> + weight-normed grouped positional conv (one gain
per tap) with GELU -> LayerNorm -> post-LN transformer layers -> [B, T, d].
so-vits-svc's vec768l12 takes the 12th layer's output.

``units`` is so-vits-svc's front end around it, as the program runs it: the
clip zero-padded to whole seconds (a padding the group norm and attention
see), the frames of the unpadded clip kept.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Layer(nn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x):
        b, t, d = x.shape
        h = self.heads
        a = self.self_attn
        q = a.q_proj(x).view(b, t, h, d // h).transpose(1, 2) / math.sqrt(d // h)
        k = a.k_proj(x).view(b, t, h, d // h).transpose(1, 2)
        v = a.v_proj(x).view(b, t, h, d // h).transpose(1, 2)
        y = torch.softmax(q @ k.transpose(2, 3), -1) @ v
        x = self.self_attn_layer_norm(x + a.out_proj(y.transpose(1, 2).reshape(b, t, d)))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class ContentVec(nn.Module):
    def __init__(self, enc: dict):
        super().__init__()
        d = enc["d_model"]
        self.kernel, self.groups = enc["pos_conv_kernel"], enc["pos_conv_groups"]
        self.feature_extractor = nn.Module()
        layers = nn.ModuleList()
        c_in = 1
        for i, (c, k, s) in enumerate(enc["conv_layers"]):
            conv = nn.Conv1d(c_in, c, k, stride=s, bias=False)
            block = nn.Sequential(conv, nn.Identity(), nn.GroupNorm(c, c, eps=1e-5), nn.GELU()) \
                if i == 0 else nn.Sequential(conv, nn.Identity(), nn.GELU())
            layers.append(block)
            c_in = c
        self.feature_extractor.conv_layers = layers
        self.layer_norm = nn.LayerNorm(c_in, eps=1e-5)
        self.post_extract_proj = nn.Linear(c_in, d)
        self.encoder = nn.Module()
        pos = nn.Module()
        pos.weight_g = nn.Parameter(torch.empty(1, 1, self.kernel))
        pos.weight_v = nn.Parameter(torch.empty(d, d // self.groups, self.kernel))
        pos.bias = nn.Parameter(torch.empty(d))
        self.encoder.pos_conv = nn.ModuleList([pos])
        self.encoder.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.encoder.layers = nn.ModuleList(Layer(d, enc["n_heads"], enc["ffn_dim"])
                                            for _ in range(enc["output_layer"]))

    def forward(self, wav):
        x = wav[:, None]
        for block in self.feature_extractor.conv_layers:
            x = block(x)
        x = self.post_extract_proj(self.layer_norm(x.transpose(1, 2)))
        pos = self.encoder.pos_conv[0]
        v = pos.weight_v
        w = pos.weight_g * v / torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)
        y = F.conv1d(x.transpose(1, 2), w, pos.bias, padding=self.kernel // 2, groups=self.groups)
        if self.kernel % 2 == 0:
            y = y[:, :, :-1]
        x = self.encoder.layer_norm(x + F.gelu(y).transpose(1, 2))
        for layer in self.encoder.layers:
            x = layer(x)
        return x


def units(net: ContentVec, wav16k: np.ndarray, device) -> torch.Tensor:
    """[T, d] units of a 16 kHz clip: padded to whole seconds, frames of the clip kept."""
    n_frames = (len(wav16k) - 400) // 320 + 1
    bucket = int(np.ceil(len(wav16k) / 16000)) * 16000
    wav = np.pad(np.asarray(wav16k, np.float32), (0, bucket - len(wav16k)))
    with torch.no_grad():
        return net(torch.from_numpy(wav)[None].to(device))[0, :n_frames]
