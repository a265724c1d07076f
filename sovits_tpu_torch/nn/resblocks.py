"""HiFi-GAN ResBlock1 and ResBlock2 (counterpart of ``sovits_tpu/nn/resblocks.py``).

``separable`` swaps every conv of kernel size > 1 for a depthwise-separable
one (the ``use_depthwise_conv`` option), as the JAX package's
``make_conv1d`` does. ``snake`` swaps every leaky ReLU for an alias-free
SnakeAlias (``vocoder_name: nsf-snake-hifigan``; the JAX package's
``SnakeResBlock1/2``); either way the nonlinearities sit in
``activations``, so-vits-svc's name for the Snake ones (a leaky ReLU holds
no parameters, so the plain blocks' state_dict names do not change).
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import SeparableConv1d, WNConv1d
from .snake import SnakeAlias

LRELU_SLOPE = 0.1


def activation(channels: int, snake: bool, slope: float = LRELU_SLOPE) -> nn.Module:
    """The vocoder's nonlinearity: a leaky ReLU, or with ``snake`` SnakeAlias."""
    return SnakeAlias(channels) if snake else nn.LeakyReLU(slope)


def _conv(channels: int, kernel_size: int, dilation: int, separable: bool) -> nn.Module:
    """A weight-normed 'same' conv: so-vits-svc's ``Conv1dModel`` switch."""
    padding = (kernel_size - 1) * dilation // 2
    if separable and kernel_size > 1:
        return SeparableConv1d(channels, channels, kernel_size, padding, dilation)
    return WNConv1d(channels, channels, kernel_size, padding=padding, dilation=dilation)


class ResBlock1(nn.Module):
    """3x (act -> dilated conv -> act -> conv), residual per pair; [B, C, T].
    ``activations`` alternate: 2j before convs1[j], 2j + 1 before convs2[j]."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: tuple[int, ...] = (1, 3, 5),
                 separable: bool = False, snake: bool = False):
        super().__init__()
        self.convs1 = nn.ModuleList(_conv(channels, kernel_size, d, separable) for d in dilations)
        self.convs2 = nn.ModuleList(_conv(channels, kernel_size, 1, separable) for _ in dilations)
        self.activations = nn.ModuleList(
            activation(channels, snake) for _ in range(2 * len(dilations)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c1(self.activations[2 * j](x))
            x = c2(self.activations[2 * j + 1](xt)) + x
        return x

    def chain_weights(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The 6 (kernel [k, C_in, C_out], bias [C]) pairs in chain order and
        in the compute type, the layout ``ops.fused_stage.fused_resblock_trio``
        takes (the JAX module's ``return_weights``); plain convs only."""
        return [
            (conv.effective_weight().permute(2, 1, 0), conv.cast_bias())
            for pair in zip(self.convs1, self.convs2)
            for conv in pair
        ]


class ResBlock2(nn.Module):
    """(act -> dilated conv), residual each; one conv per dilation, as the
    JAX package builds it; [B, C, T]."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: tuple[int, ...] = (1, 3),
                 separable: bool = False, snake: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(_conv(channels, kernel_size, d, separable) for d in dilations)
        self.activations = nn.ModuleList(activation(channels, snake) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, act in zip(self.convs, self.activations):
            x = conv(act(x)) + x
        return x
