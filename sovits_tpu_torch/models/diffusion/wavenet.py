"""Diffusion WaveNet denoiser (counterpart of
``sovits_tpu/models/diffusion/wavenet.py``; so-vits-svc
``diffusion/wavenet.py``, whose parameter names it keeps).

Non-dilated gated residual blocks conditioned on the sinusoidal
diffusion-step embedding and the Unit2Mel hidden track, channels first.
The gate is sigmoid(first half) * tanh(second half), the opposite order of
the VITS WN's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion steps [B] -> [B, dim] (wavenet.py:16-28)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


class ResidualBlock(nn.Module):
    def __init__(self, encoder_hidden: int, residual_channels: int):
        super().__init__()
        self.residual_channels = residual_channels
        self.dilated_conv = nn.Conv1d(residual_channels, 2 * residual_channels, 3, padding=1)
        self.diffusion_projection = nn.Linear(residual_channels, residual_channels)
        self.conditioner_projection = nn.Conv1d(encoder_hidden, 2 * residual_channels, 1)
        self.output_projection = nn.Conv1d(residual_channels, 2 * residual_channels, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                step: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, C, T], cond [B, H, T], step [B, C] -> (residual out, skip)."""
        y = x + self.diffusion_projection(step)[:, :, None]
        y = self.dilated_conv(y) + self.conditioner_projection(cond)
        gate, filt = torch.split(y, self.residual_channels, dim=1)
        y = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt))
        residual, skip = torch.split(y, self.residual_channels, dim=1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffusionWaveNet(nn.Module):
    """spec [B, M, T] + steps [B] + cond [B, H, T] -> predicted noise [B, M, T]."""

    def __init__(self, in_dims: int = 128, n_layers: int = 20, n_chans: int = 384,
                 n_hidden: int = 256):
        super().__init__()
        self.n_chans = n_chans
        self.input_projection = nn.Conv1d(in_dims, n_chans, 1)
        self.mlp = nn.Sequential(nn.Linear(n_chans, n_chans * 4), Mish(),
                                 nn.Linear(n_chans * 4, n_chans))
        self.residual_layers = nn.ModuleList(
            [ResidualBlock(n_hidden, n_chans) for _ in range(n_layers)])
        self.skip_projection = nn.Conv1d(n_chans, n_chans, 1)
        self.output_projection = nn.Conv1d(n_chans, in_dims, 1)

    def forward(self, spec: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.input_projection(spec))
        step = self.mlp(sinusoidal_pos_emb(t, self.n_chans))
        skips = 0.0
        for layer in self.residual_layers:
            x, skip = layer(x, cond, step)
            skips = skips + skip
        x = F.relu(self.skip_projection(skips / math.sqrt(len(self.residual_layers))))
        return self.output_projection(x)
