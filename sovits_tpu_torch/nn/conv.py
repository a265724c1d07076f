"""Weight-normed 1-D convolutions (counterpart of ``sovits_tpu/nn/conv.py``).

so-vits-svc stores weight-normed convs as ``weight_g`` / ``weight_v``; these
modules keep those names and torch layouts, so a reference ``G_*.pth``
loads strictly. The effective weight g * v / ||v|| is folded once, at
construction and after every ``load_state_dict``, into a non-persistent
``weight`` buffer that the forward uses. After changing ``weight_g`` or
``weight_v`` in place, call :meth:`fold_weight_norm`.

Plain convs are ``torch.nn.Conv1d``. None of the JAX package's folded,
block-dense, convvjp or im2col lowerings is ported: they are TPU layout work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class WeightNormed(nn.Module):
    """Holds weight_g / weight_v / bias; norm over every dim but ``_g_dim``."""

    _g_dim = 0

    def __init__(self, v_shape: tuple[int, ...], bias_len: int, bias: bool):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(v_shape))
        g_shape = [1] * len(v_shape)
        g_shape[self._g_dim] = v_shape[self._g_dim]
        self.weight_g = nn.Parameter(torch.empty(g_shape))
        self.bias = nn.Parameter(torch.zeros(bias_len)) if bias else None
        self.register_buffer("weight", torch.empty(v_shape), persistent=False)
        nn.init.kaiming_uniform_(self.weight_v, a=5**0.5)
        with torch.no_grad():
            self.weight_g.copy_(self._norm(self.weight_v))
        self.fold_weight_norm()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.fold_weight_norm())

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        dims = [d for d in range(v.dim()) if d != self._g_dim]
        return torch.linalg.vector_norm(v, dim=dims, keepdim=True)

    @torch.no_grad()
    def fold_weight_norm(self) -> None:
        self.weight = self.weight_g * self.weight_v / self._norm(self.weight_v)


class WNConv1d(WeightNormed):
    """weight_norm(nn.Conv1d): norm per output channel (weight_g [out, 1, 1])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        self.stride, self.padding, self.dilation = stride, padding, dilation
        super().__init__((out_channels, in_channels, kernel_size), out_channels, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding, self.dilation)


class WNConvTranspose1d(WeightNormed):
    """weight_norm(nn.ConvTranspose1d): norm per *input* channel
    (weight_v [in, out, k], weight_g [in, 1, 1])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int = 0, bias: bool = True):
        self.stride, self.padding = stride, padding
        super().__init__((in_channels, out_channels, kernel_size), out_channels, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight, self.bias, self.stride, self.padding)
