"""GAN discriminators: multi-period plus scale (counterpart of
``sovits_tpu/models/discriminator.py``; so-vits-svc ``models.py``
``MultiPeriodDiscriminator``).

Parameter names are so-vits-svc's (``discriminators.{0..5}.convs.*``,
``conv_post``), so a reference ``D_*.pth`` loads strictly. Convs are
weight-normed; with ``use_spectral_norm`` they carry torch's spectral norm
instead, as so-vits-svc selects it. Waveforms come in the JAX package's
layout [B, T, 1]; feature maps go out channels-first (torch's layout).

``dtype`` is the compute type, as the JAX ``MultiPeriodDiscriminator(dtype=)``:
parameters stay float32, every conv (weight norm or spectral norm folded in
float32 first) casts its input and weights to it, and logits and feature
maps come out in it. The losses reduce in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import Conv1d, Conv2d, WNConv1d, WNConv2d, set_compute_dtype

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)
P_CHANNELS = (32, 128, 512, 1024)
# (features, kernel, stride, groups, padding) per conv of the scale discriminator
S_SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
           (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))


def _conv1d(spectral: bool, c_in, c_out, k, stride=1, groups=1, padding=0):
    if spectral:
        return nn.utils.spectral_norm(Conv1d(c_in, c_out, k, stride, padding, groups=groups))
    return WNConv1d(c_in, c_out, k, stride, padding, groups=groups)


def _conv2d(spectral: bool, c_in, c_out, k, stride, padding):
    if spectral:
        return nn.utils.spectral_norm(Conv2d(c_in, c_out, k, stride, padding))
    return WNConv2d(c_in, c_out, k, stride, padding)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False, channels=P_CHANNELS):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        ins = (1,) + tuple(channels)
        self.convs = nn.ModuleList(
            _conv2d(use_spectral_norm, c_in, c_out, (kernel_size, 1), (stride, 1), (pad, 0))
            for c_in, c_out in zip(ins[:-1], ins[1:])
        )
        self.convs.append(_conv2d(use_spectral_norm, channels[-1], channels[-1], (kernel_size, 1),
                                  (1, 1), (pad, 0)))
        self.conv_post = _conv2d(use_spectral_norm, channels[-1], 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        """x [B, 1, T] -> (logits [B, -1], feature maps [B, C, T/p, p])."""
        b, c, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.view(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class DiscriminatorS(nn.Module):
    def __init__(self, use_spectral_norm: bool = False, specs=S_SPECS):
        super().__init__()
        ins = (1,) + tuple(s[0] for s in specs)
        self.convs = nn.ModuleList(
            _conv1d(use_spectral_norm, c_in, c_out, k, s, grp, pad)
            for c_in, (c_out, k, s, grp, pad) in zip(ins, specs)
        )
        self.conv_post = _conv1d(use_spectral_norm, specs[-1][0], 1, 3, padding=1)

    def forward(self, x: torch.Tensor):
        """x [B, 1, T] -> (logits [B, -1], feature maps [B, C, T'])."""
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Slot 0 is the scale discriminator, slots 1.. the period ones."""

    def __init__(self, use_spectral_norm: bool = False, periods=PERIODS, p_channels=P_CHANNELS,
                 s_specs=S_SPECS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(use_spectral_norm, s_specs)]
            + [DiscriminatorP(p, use_spectral_norm=use_spectral_norm, channels=p_channels)
               for p in periods]
        )
        set_compute_dtype(self, dtype)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat [B, T, 1] -> (real logits, fake logits, real fmaps, fake fmaps),
        one entry per sub-discriminator."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            y_d_r, fmap_r = d(y.transpose(1, 2))
            y_d_g, fmap_g = d(y_hat.transpose(1, 2))
            y_d_rs.append(y_d_r)
            y_d_gs.append(y_d_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
