"""NSF-HiFiGAN generator (counterpart of ``sovits_tpu/models/nsf_hifigan.py``).

Parameter names follow so-vits-svc's ``vdecoder/hifigan/models.py``
(``m_source.l_linear``, ``conv_pre``, ``ups``, ``noise_convs``,
``resblocks``, ``conv_post``, ``cond``). Channels-first inside.

The harmonic source is computed frame-exactly, as in the JAX package: f0
is constant over each hop, so a sample's phase is the frame's base phase
(an exclusive cumsum over frames) plus (j + 1) times the frame's
per-sample advance -- no length-T cumulative sum. The base phase is summed
in float64 and reduced to one turn before it meets the per-sample advance:
over a song's thousands of frames a float32 sum drifts by 1e-4 turns with
the order of summation, which a time-sharded decode
(``parallel/sequence.py``) would turn into seams.
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
                generator: torch.Generator | None = None, phase0: torch.Tensor | None = None,
                noise_frames: tuple[int, int] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """f0_frames [B, T_f] Hz -> (har_source [B, 1, T_f*upp], uv [B, 1, T_f*upp]).

        With no generator the source is deterministic: no random initial
        phases and no additive noise. With one, both are drawn from it.

        ``phase0`` [B, H] (turns) is the phase accumulated before this
        chunk's first frame: a time-sharded decode continues the sine across
        shard boundaries with it. ``noise_frames`` (frame_offset, total)
        makes the draws counter-based (:func:`counter_normal`): the initial
        phases depend on the generator's seed alone, frame t's noise on the
        seed and its absolute frame ``frame_offset + t``, and frames outside
        [0, total) get none, so every shard of a song draws what the
        monolithic decode draws (the JAX package's per-frame ``fold_in``).
        """
        b, t_f = f0_frames.shape
        h = self.harmonic_num + 1
        dev = f0_frames.device
        harmonics = torch.arange(1, h + 1, dtype=torch.float32, device=dev)
        rad = (f0_frames.float()[:, None, :] * harmonics[None, :, None] / self.sampling_rate) % 1.0
        adv = frame_advance(rad, upp).double()
        base = torch.cumsum(adv, dim=-1) - adv  # [B, H, T_f], exclusive
        if phase0 is not None:
            base = base + phase0.double()[:, :, None]
        base = (base % 1.0).float()
        offsets = torch.arange(1, upp + 1, dtype=torch.float32, device=dev)
        phase = base[..., None] + offsets * rad[..., None]  # [B, H, T_f, upp]
        counter = generator is not None and noise_frames is not None
        if counter:
            seed = generator.initial_seed()
            rand_ini = counter_uniform(seed, 0, torch.arange(b * h, device=dev)).reshape(b, h, 1, 1)
        elif generator is not None:
            rand_ini = torch.rand(b, h, 1, 1, generator=generator, device=dev)
        if generator is not None:
            rand_ini[:, 0] = 0.0  # the fundamental starts at phase 0
            phase = phase + rand_ini
        sines = torch.sin(2.0 * math.pi * phase) * self.sine_amp
        uv4 = (f0_frames > self.voiced_threshold).float()[:, None, :, None]  # [B, 1, T_f, 1]
        if generator is not None:
            noise_amp = uv4 * self.noise_std + (1.0 - uv4) * self.sine_amp / 3.0
            if counter:
                offset, total = noise_frames
                frames = offset + torch.arange(t_f, device=dev)
                noise = counter_normal(seed, frames, b * h, upp).reshape(t_f, b, h, upp)
                valid = ((frames >= 0) & (frames < total)).float()
                noise = noise.permute(1, 2, 0, 3) * valid[:, None]
            else:
                noise = torch.randn(sines.shape, generator=generator, device=dev)
            sines = sines * uv4 + noise_amp * noise
        else:
            sines = sines * uv4
        merged = torch.einsum("bhtu,h->btu", sines, self.l_linear.weight[0]) + self.l_linear.bias
        har_source = torch.tanh(merged.reshape(b, 1, t_f * upp)).to(self.dtype)
        uv = uv4.expand(b, 1, t_f, upp).reshape(b, 1, t_f * upp)
        return har_source, uv


def frame_advance(rad: torch.Tensor, upp: int) -> torch.Tensor:
    """A frame's phase advance in turns, per harmonic, from the per-sample
    advance ``rad`` (turns, in [0, 1))."""
    return (rad * upp) % 1.0


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds) of int64 tensors
    holding values in [0, 2^32); each product stays below 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _MASK32
    return x ^ (x >> 16)


def _counter_bits(seed: int, stream: int, frames: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """32 hashed bits per (frame, inner index) pair: [len(frames), len(inner)]."""
    key = int(_mix32(torch.tensor((seed ^ (stream * 0x9E3779B9)) & _MASK32)))
    frame_key = _mix32((frames.long() + key) & _MASK32)
    return _mix32(frame_key[:, None] ^ _mix32(inner.long() & _MASK32)[None, :])


def _unit_interval(bits: torch.Tensor) -> torch.Tensor:
    """The top 24 of 32 bits as a float32 in (0, 1)."""
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def counter_uniform(seed: int, stream: int, inner: torch.Tensor) -> torch.Tensor:
    """U(0, 1) draws that depend only on (seed, stream, index): [len(inner)]."""
    return _unit_interval(_counter_bits(seed, stream, torch.zeros(1, dtype=torch.long,
                                                                   device=inner.device), inner))[0]


def counter_normal(seed: int, frames: torch.Tensor, rows: int, upp: int) -> torch.Tensor:
    """N(0, 1) draws [len(frames), rows * upp] that depend only on (seed,
    absolute frame, row, sample): an integer hash of the counter, then
    Box-Muller, in plain torch on the source's own small tensor."""
    inner = torch.arange(rows * upp, device=frames.device) * 2
    u1 = _unit_interval(_counter_bits(seed, 1, frames, inner))
    u2 = _unit_interval(_counter_bits(seed, 1, frames, inner + 1))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


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
        self.sampling_rate = sampling_rate
        self.gin_channels = gin_channels
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
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
                generator: torch.Generator | None = None, phase0: torch.Tensor | None = None,
                noise_frames: tuple[int, int] | None = None) -> torch.Tensor:
        """``phase0`` and ``noise_frames`` go to the source
        (:meth:`SourceModuleHnNSF.forward`): a time-sharded decode passes a
        shard's phase prefix and its absolute frame offset."""
        har_source, _ = self.m_source(f0, self.upp, generator, phase0, noise_frames)
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
