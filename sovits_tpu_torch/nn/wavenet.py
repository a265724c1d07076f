"""Non-causal WaveNet with gated activations (counterpart of
``sovits_tpu/nn/wavenet.py``; so-vits-svc ``modules.WN``). Channels-first."""

from __future__ import annotations

import torch
from torch import nn

from .conv import WNConv1d


def gated_tanh_sigmoid(x: torch.Tensor, cond: torch.Tensor | float) -> torch.Tensor:
    """tanh(a) * sigmoid(b) on the two channel halves of x + cond ([B, 2H, T])."""
    a, b = torch.chunk(x + cond, 2, dim=1)
    return torch.tanh(a) * torch.sigmoid(b)


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("WN needs an odd kernel size")
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        self.cond_layer = (
            WNConv1d(gin_channels, 2 * hidden_channels * n_layers, 1) if gin_channels else None
        )
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate**i
            self.in_layers.append(WNConv1d(
                hidden_channels, 2 * hidden_channels, kernel_size, dilation=d,
                padding=(kernel_size - 1) * d // 2,
            ))
            out = hidden_channels if i == n_layers - 1 else 2 * hidden_channels
            self.res_skip_layers.append(WNConv1d(hidden_channels, out, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, H, T], x_mask [B, 1, T], g [B, gin, 1 or T]."""
        h = self.hidden_channels
        g_all = self.cond_layer(g) if g is not None and self.cond_layer is not None else None
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            g_l = g_all[:, i * 2 * h : (i + 1) * 2 * h] if g_all is not None else 0.0
            res_skip = self.res_skip_layers[i](gated_tanh_sigmoid(x_in, g_l))
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask
