"""Mean-only affine couplings over a WN or a causal FFT (counterpart of
``sovits_tpu/nn/flows.py``).

so-vits-svc's ``ResidualCouplingBlock`` and ``TransformerCouplingBlock``
store couplings at ``flows.{0,2,4,6}`` with parameter-free channel flips
between them; the ModuleList here keeps that indexing so the state_dict
names match. With ``share_parameter`` one inner net, ``wn``, serves every
coupling: as in so-vits-svc it is each coupling's ``enc`` too, so a
state_dict holds it under ``wn.`` and under every ``flows.{i}.enc.``.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import FFT
from .conv import Conv1d
from .wavenet import WN


class Flip(nn.Module):
    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return torch.flip(x, [1])


class _MeanOnlyCoupling(nn.Module):
    """pre -> enc -> post on the first channel half shifts the second."""

    def __init__(self, channels: int, hidden_channels: int, enc: nn.Module):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = enc
        self.post = Conv1d(hidden_channels, self.half, 1)
        nn.init.zeros_(self.post.weight)  # the flow starts as the identity
        nn.init.zeros_(self.post.bias)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False,
                drop_generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, C, T]; mean-only, so the log-determinant is zero and not
        returned. ``drop_generator`` drives the inner net's dropout (training)."""
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.pre(x0) * x_mask
        m = self.post(self.enc(h, x_mask, g=g, drop_generator=drop_generator)) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingLayer(_MeanOnlyCoupling):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 shared_wn: WN | None = None):
        if shared_wn is None:
            shared_wn = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        super().__init__(channels, hidden_channels, shared_wn)


class TransformerCouplingLayer(_MeanOnlyCoupling):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, n_layers: int,
                 n_heads: int, p_dropout: float = 0.0, filter_channels: int = 0,
                 gin_channels: int = 0, shared_enc: FFT | None = None):
        if shared_enc is None:
            shared_enc = FFT(hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                             p_dropout, isflow=True, gin_channels=gin_channels)
        super().__init__(channels, hidden_channels, shared_enc)


class _CouplingBlock(nn.Module):
    def __init__(self, couplings, wn: nn.Module | None):
        super().__init__()
        self.wn = wn
        self.flows = nn.ModuleList()
        for coupling in couplings:
            self.flows.append(coupling)
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False,
                drop_generator: torch.Generator | None = None) -> torch.Tensor:
        flows = reversed(self.flows) if reverse else self.flows
        for flow in flows:
            x = flow(x, x_mask, g=g, reverse=reverse, drop_generator=drop_generator)
        return x


class ResidualCouplingBlock(_CouplingBlock):
    """n_flows x (WN coupling + flip)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4, gin_channels: int = 0,
                 share_parameter: bool = False):
        wn = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels) if share_parameter else None
        super().__init__([
            ResidualCouplingLayer(channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                                  gin_channels, shared_wn=wn)
            for _ in range(n_flows)
        ], wn)


class TransformerCouplingBlock(_CouplingBlock):
    """n_flows x (causal-FFT coupling + flip)."""

    def __init__(self, channels: int, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int, p_dropout: float = 0.0, n_flows: int = 4,
                 gin_channels: int = 0, share_parameter: bool = False):
        wn = FFT(hidden_channels, filter_channels, n_heads, n_layers, kernel_size, p_dropout,
                 isflow=True, gin_channels=gin_channels) if share_parameter else None
        super().__init__([
            TransformerCouplingLayer(channels, hidden_channels, kernel_size, n_layers, n_heads,
                                     p_dropout, filter_channels, gin_channels, shared_enc=wn)
            for _ in range(n_flows)
        ], wn)
