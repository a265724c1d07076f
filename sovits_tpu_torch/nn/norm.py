"""LayerNorm over channels (counterpart of ``sovits_tpu/nn/norm.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Cast


class LayerNorm(Cast, nn.Module):
    """so-vits-svc's channel LayerNorm on [B, C, T]: parameters gamma, beta.
    Statistics and affine in float32; the output in the compute type."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float().transpose(1, -1), (x.shape[1],), self.gamma, self.beta, self.eps)
        return y.transpose(1, -1).to(self.dtype)
