"""HiFi-GAN ResBlock1 (counterpart of ``sovits_tpu/nn/resblocks.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import WNConv1d

LRELU_SLOPE = 0.1


class ResBlock1(nn.Module):
    """3x (lrelu -> dilated conv -> lrelu -> conv), residual per pair; [B, C, T]."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d, padding=(kernel_size - 1) * d // 2)
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilations
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x

    def chain_weights(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The 6 (kernel [k, C_in, C_out], bias [C]) pairs in chain order and
        in the compute type, the layout ``ops.fused_stage.fused_resblock_trio``
        takes (the JAX module's ``return_weights``)."""
        return [
            (conv.effective_weight().permute(2, 1, 0), conv.cast_bias())
            for pair in zip(self.convs1, self.convs2)
            for conv in pair
        ]
