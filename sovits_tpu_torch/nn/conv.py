"""Convolutions, dense layers and embeddings with a compute type, and
weight-normed convolutions (counterpart of ``sovits_tpu/nn/conv.py``).

so-vits-svc stores weight-normed convs as ``weight_g`` / ``weight_v``; these
modules keep those names and torch layouts, so a reference ``G_*.pth`` or
``D_*.pth`` loads strictly. The effective weight is g * v / ||v||:

- under autograd (grad mode on, g or v trainable) the forward computes it
  from ``weight_g`` and ``weight_v``, so both receive gradients;
- otherwise it uses a non-persistent ``weight`` buffer holding the folded
  value, refolded whenever g or v changed since the last fold (an optimizer
  step, ``load_state_dict``, an in-place edit, a move to another device).

Compute type: as in the JAX modules, parameters stay float32 (their
``param_dtype``) and ``dtype`` is the type a module computes in: it casts
its input, weight and bias to it, and its output is in it. The weight norm
is folded in float32 first; the folded weight's copy in the compute type is
kept beside it and refolded with it. ``set_compute_dtype`` sets ``dtype`` on
every such module under a root. Plain convs are :class:`Conv1d` and
:class:`Conv2d` (``torch.nn.Conv1d`` / ``Conv2d`` with a compute type; a
spectral norm's hook sets their ``weight`` in float32 before the cast).
None of the JAX package's folded, block-dense, convvjp or im2col lowerings
is ported: they are TPU layout work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Cast:
    """Mixin: ``dtype`` is the module's compute type (float32 by default)."""

    dtype = torch.float32

    def cast_bias(self) -> torch.Tensor | None:
        return None if self.bias is None else self.bias.to(self.dtype)


def set_compute_dtype(root: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute type of every :class:`Cast` module under ``root``."""
    for module in root.modules():
        if isinstance(module, Cast):
            module.dtype = dtype
    return root


class Conv1d(Cast, nn.Conv1d):
    """``torch.nn.Conv1d`` in the compute type (the JAX ``Conv1d`` without
    weight norm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), self.cast_bias())


class Conv2d(Cast, nn.Conv2d):
    """``torch.nn.Conv2d`` in the compute type (the JAX ``Conv2d`` without
    weight norm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), self.cast_bias())


class Linear(Cast, nn.Linear):
    """``torch.nn.Linear`` in the compute type (the JAX ``nn.Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.cast_bias())


class Embedding(Cast, nn.Embedding):
    """``torch.nn.Embedding`` returning the compute type (the JAX ``nn.Embed``)."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.dtype)


class WeightNormed(Cast, nn.Module):
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
        self._folded_from = None
        nn.init.kaiming_uniform_(self.weight_v, a=5**0.5)
        with torch.no_grad():
            self.weight_g.copy_(self._norm(self.weight_v))
        self.fold_weight_norm()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.fold_weight_norm())

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        dims = [d for d in range(v.dim()) if d != self._g_dim]
        return torch.linalg.vector_norm(v, dim=dims, keepdim=True)

    def _source(self) -> tuple:
        return tuple((p._version, p.data_ptr()) for p in (self.weight_g, self.weight_v))

    @torch.no_grad()
    def fold_weight_norm(self) -> None:
        self.weight = self.weight_g * self.weight_v / self._norm(self.weight_v)
        self._weight_cast = self.weight.to(self.dtype)  # the buffer itself for float32
        self._folded_from = (self._source(), self.dtype)

    @torch.no_grad()
    def freeze_weight_norm(self) -> None:
        """Fold g * v / ||v|| for good into a saved float32 ``weight`` buffer
        and drop g and v (torch's ``remove_weight_norm``): for inference
        only, as in a module that ``torch.export`` saves, whose graph then
        reads the folded weight instead of folding it at every call."""
        weight = self.weight_g * self.weight_v / self._norm(self.weight_v)
        del self.weight_g, self.weight_v, self.weight
        self.register_buffer("weight", weight)
        self._folded_from = None

    def effective_weight(self) -> torch.Tensor:
        """g * v / ||v|| in the compute type: differentiable when g or v
        trains, else the folded buffer (or its compute-type copy). While a
        tracer runs (``torch.export``) the parameters have no storage to key
        the cache on, so the fold is computed in the traced graph, from g and
        v, by the same operations as :meth:`fold_weight_norm`. A frozen module
        (:meth:`freeze_weight_norm`) has only the folded weight."""
        if "weight_v" not in self._parameters:
            return self.weight.to(self.dtype)
        if torch.compiler.is_compiling() or (
                torch.is_grad_enabled() and (self.weight_g.requires_grad or self.weight_v.requires_grad)):
            return (self.weight_g * self.weight_v / self._norm(self.weight_v)).to(self.dtype)
        if self._folded_from != (self._source(), self.dtype):
            self.fold_weight_norm()
        return self._weight_cast


class WNConv1d(WeightNormed):
    """weight_norm(nn.Conv1d): norm per output channel (weight_g [out, 1, 1])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1, bias: bool = True):
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        super().__init__((out_channels, in_channels // groups, kernel_size), out_channels, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x.to(self.dtype), self.effective_weight(), self.cast_bias(), self.stride,
                        self.padding, self.dilation, self.groups)


class WNConv2d(WeightNormed):
    """weight_norm(nn.Conv2d): norm per output channel (weight_g [out, 1, 1, 1])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
                 bias: bool = True):
        self.stride, self.padding = stride, padding
        super().__init__((out_channels, in_channels, *kernel_size), out_channels, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.effective_weight(), self.cast_bias(), self.stride,
                        self.padding)


class WNConvTranspose1d(WeightNormed):
    """weight_norm(nn.ConvTranspose1d): norm per *input* channel
    (weight_v [in, out, k], weight_g [in, 1, 1])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int = 0, bias: bool = True):
        self.stride, self.padding = stride, padding
        super().__init__((in_channels, out_channels, kernel_size), out_channels, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x.to(self.dtype), self.effective_weight(), self.cast_bias(),
                                  self.stride, self.padding)


class SeparableConv1d(nn.Module):
    """Depthwise-separable conv (so-vits-svc ``Depthwise_Separable_Conv1D``
    under its weight norm, the JAX ``SeparableConv1d(weight_norm=True)``): a
    weight-normed depthwise conv (groups = C_in), then a weight-normed
    pointwise 1x1; state_dict names ``depth_conv`` / ``point_conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0,
                 dilation: int = 1):
        super().__init__()
        self.depth_conv = WNConv1d(in_channels, in_channels, kernel_size, padding=padding,
                                   dilation=dilation, groups=in_channels)
        self.point_conv = WNConv1d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.point_conv(self.depth_conv(x))
