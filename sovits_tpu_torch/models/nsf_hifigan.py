"""NSF-HiFiGAN generator (counterpart of ``sovits_tpu/models/nsf_hifigan.py``).

Parameter names follow so-vits-svc's ``vdecoder/hifigan/models.py``
(``m_source.l_linear``, ``conv_pre``, ``ups``, ``noise_convs``,
``resblocks``, ``conv_post``, ``cond``). Channels-first inside.

The harmonic source is computed frame-exactly, as in the JAX package: f0
is constant over each hop, so a sample's phase is the frame's base phase
(an exclusive cumsum over frames) plus (j + 1) times the frame's
per-sample advance -- no length-T cumulative sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..nn.conv import Cast, Conv1d, WNConv1d, WNConvTranspose1d
from ..nn.resblocks import ResBlock1, ResBlock2, activation
from ..ops.fused_stage import TRIO_CHANNELS, fused_resblock_trio


class SourceModuleHnNSF(Cast, nn.Module):
    """Harmonic sine source merged to one excitation channel (linear + tanh),
    computed in float32 and returned in the compute type (``har_source``)."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 8, sine_amp: float = 0.1,
                 add_noise_std: float = 0.003, voiced_threshold: float = 0.0):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.harmonic_num = harmonic_num
        self.sine_amp = sine_amp
        self.noise_std = add_noise_std
        self.voiced_threshold = voiced_threshold
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0_frames: torch.Tensor, upp: int,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """f0_frames [B, T_f] Hz -> (har_source [B, 1, T_f*upp], uv [B, 1, T_f*upp]).

        With no generator the source is deterministic: no random initial
        phases and no additive noise. With one, both are drawn from it.
        """
        b, t_f = f0_frames.shape
        h = self.harmonic_num + 1
        dev = f0_frames.device
        harmonics = torch.arange(1, h + 1, dtype=torch.float32, device=dev)
        rad = (f0_frames.float()[:, None, :] * harmonics[None, :, None] / self.sampling_rate) % 1.0
        frame_adv = (rad * upp) % 1.0
        base = torch.cumsum(frame_adv, dim=-1) - frame_adv  # [B, H, T_f], exclusive
        offsets = torch.arange(1, upp + 1, dtype=torch.float32, device=dev)
        phase = base[..., None] + offsets * rad[..., None]  # [B, H, T_f, upp]
        if generator is not None:
            rand_ini = torch.rand(b, h, 1, 1, generator=generator, device=dev)
            rand_ini[:, 0] = 0.0  # the fundamental starts at phase 0
            phase = phase + rand_ini
        sines = torch.sin(2.0 * math.pi * phase) * self.sine_amp
        uv4 = (f0_frames > self.voiced_threshold).float()[:, None, :, None]  # [B, 1, T_f, 1]
        if generator is not None:
            noise_amp = uv4 * self.noise_std + (1.0 - uv4) * self.sine_amp / 3.0
            noise = torch.randn(sines.shape, generator=generator, device=dev)
            sines = sines * uv4 + noise_amp * noise
        else:
            sines = sines * uv4
        merged = torch.einsum("bhtu,h->btu", sines, self.l_linear.weight[0]) + self.l_linear.bias
        har_source = torch.tanh(merged.reshape(b, 1, t_f * upp)).to(self.dtype)
        uv = uv4.expand(b, 1, t_f, upp).reshape(b, 1, t_f * upp)
        return har_source, uv


class Generator(nn.Module):
    """latent [B, C_in, T_f] + f0 [B, T_f] + g [B, gin, 1 or T_f] -> wav [B, 1, T_f*upp].

    With ``snake`` it is the ``nsf-snake-hifigan`` vocoder (the JAX
    package's ``SnakeGenerator``; so-vits-svc
    ``vdecoder/hifiganwithsnake/models.py``): every leaky ReLU becomes an
    alias-free SnakeAlias -- before each upsample (``snakes``), around every
    resblock conv and before ``conv_post`` (``snake_post``). The leaky
    ReLUs sit under the same names and hold no parameters. In a bf16 Snake
    model the convs compute in bf16 while the residual stream between them
    and the Snake activations stay float32: Snake's periodic activation
    turns the absolute rounding error of its input into output error, and a
    bf16 stream moved the full-width model's audio by 5.3% of its peak
    against float32 on an H100, over the 5% bar of two bf16 decodes
    (PERF.md). The JAX package's Snake generator has no bf16 path to follow
    (``nn/snake.py``).
    """

    def __init__(self, sampling_rate: int = 44100, inter_channels: int = 192,
                 resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3,
                 upsample_rates=(8, 8, 2, 2, 2), upsample_initial_channel: int = 512,
                 upsample_kernel_sizes=(16, 16, 4, 4, 4), gin_channels: int = 768,
                 fused_tail: bool = False, resblock: str = "1", separable: bool = False,
                 snake: bool = False):
        """``fused_tail`` (the JAX package's name) runs the stages of width
        16-128 through the fused ResBlock trio (differentiable: its backward
        recomputes the plain convs); without it every stage runs the plain
        ResBlock1 convs, as the trainer does. ``resblock`` "2" builds
        ResBlock2s and ``separable`` (``use_depthwise_conv``) makes their
        convs depthwise-separable; as in the JAX package, the fused trio
        serves only the leaky resblock "1" with plain convs, and the other
        generators run stock convs in every stage."""
        super().__init__()
        block_cls = ResBlock1 if str(resblock) == "1" else ResBlock2
        self.fused = fused_tail and str(resblock) == "1" and not separable and not snake
        self.snake = snake
        self.upsample_rates = tuple(upsample_rates)
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilation_sizes = tuple(map(tuple, resblock_dilation_sizes))
        self.upp = int(np.prod(upsample_rates))
        self.m_source = SourceModuleHnNSF(sampling_rate)
        self.conv_pre = WNConv1d(inter_channels, upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        self.snakes = nn.ModuleList()
        self.stage_channels = []
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_in = upsample_initial_channel // (2**i)
            ch = ch_in // 2
            self.stage_channels.append(ch)
            self.snakes.append(activation(ch_in, snake))
            self.ups.append(WNConvTranspose1d(ch_in, ch, k, u, padding=(k - u + 1) // 2))
            if i + 1 < len(upsample_rates):
                s = int(np.prod(upsample_rates[i + 1 :]))
                self.noise_convs.append(Conv1d(1, ch, s * 2, stride=s, padding=(s + 1) // 2))
            else:
                self.noise_convs.append(Conv1d(1, ch, 1))
            for rk, rd in zip(self.kernel_sizes, self.dilation_sizes):
                self.resblocks.append(block_cls(ch, rk, rd, separable=separable, snake=snake))
        # torch's default slope 0.01 before conv_post, as the reference
        self.snake_post = activation(ch, snake, slope=0.01)
        self.conv_post = WNConv1d(ch, 1, 7, padding=3)
        # a standalone vocoder (gin_channels 0) has no speaker input and no cond
        self.cond = Conv1d(gin_channels, upsample_initial_channel, 1) if gin_channels else None

    def _stream(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream's type: float32 around Snake, else the compute type."""
        return x.float() if self.snake else x

    def forward(self, x: torch.Tensor, f0: torch.Tensor, g: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        har_source, _ = self.m_source(f0, self.upp, generator)
        x = self._stream(self.conv_pre(x))
        if g is not None:
            x = x + self.cond(g)
        nk = len(self.kernel_sizes)
        for i, ch in enumerate(self.stage_channels):
            x = self._stream(self.ups[i](self.snakes[i](x))) + self.noise_convs[i](har_source)
            blocks = self.resblocks[i * nk : (i + 1) * nk]
            if self.fused and ch in TRIO_CHANNELS:
                # the JAX package's use_pallas condition: resblock "1" with
                # plain convs, and by stage width as its fold * C == 128: these
                # stages run the fused trio (kernel on CUDA, its plain version
                # on the CPU; under autograd through FusedTrio); wider ones,
                # and every stage of a resblock-2, separable or Snake
                # generator, stock convs
                pairs = [p for block in blocks for p in block.chain_weights()]
                x = fused_resblock_trio(
                    x.transpose(1, 2).contiguous(), [p[0] for p in pairs], [p[1] for p in pairs],
                    self.kernel_sizes, self.dilation_sizes,
                ).transpose(1, 2)
            else:
                xs = None
                for block in blocks:
                    y = block(x)
                    xs = y if xs is None else xs + y
                x = xs / nk
        return torch.tanh(self.conv_post(self.snake_post(x)))
