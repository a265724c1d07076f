"""The SoftVC-VITS synthesizer (counterpart of
``sovits_tpu/models/synthesizer.py``; so-vits-svc ``SynthesizerTrn``).

Parameter names and layouts are so-vits-svc's, so a reference ``G_*.pth``
loads with ``load_state_dict(strict=True)``.

Public layouts are the JAX package's: ``infer`` takes c [B, T, ssl],
f0 [B, T], uv [B, T] and returns (wav [B, T*hop, 1], f0 [B, T]); the
training ``forward`` also takes spec [B, T, F] and returns its tensors as
[B, T, C]. Inside, modules run channels-first.

All randomness of the training forward (dropout masks, the f0 random
scale, the posterior noise, the slice offsets, the source's phases and
noise) comes from one explicit ``torch.Generator``.

``dtype`` is the JAX module's compute type (``Synthesizer(dtype=...)``):
parameters stay float32 and every submodule computes in ``dtype``. As in
the JAX package, the masks take the type of the units ``c`` (float32 from
``Svc``), so the products with them promote back to float32 where the JAX
modules' do, and the prior noise is drawn in the type of its mean.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..dsp.f0 import f0_to_coarse, f0_to_lf0, lf0_to_f0, normalize_f0
from ..dsp.sequence import rand_slice_segments_with_pitch, sequence_mask
from ..nn.attention import FFT, Encoder
from ..nn.conv import Conv1d, Embedding, Linear, set_compute_dtype
from ..nn.flows import ResidualCouplingBlock, TransformerCouplingBlock
from ..nn.wavenet import WN
from .nsf_hifigan import Generator


class ContentEncoder(nn.Module):
    """Prior encoder over content units (so-vits-svc ``TextEncoder``)."""

    def __init__(self, out_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.out_channels = out_channels
        self.f0_emb = Embedding(256, hidden_channels)
        self.enc_ = Encoder(hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                            p_dropout=p_dropout)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, x_mask, f0_coarse, noise_scale: float = 1.0,
                generator: torch.Generator | None = None, sample_noise: bool = False,
                drop_generator: torch.Generator | None = None):
        """x [B, H, T], x_mask [B, 1, T], f0_coarse [B, T] -> (z, m, logs)."""
        x = x + self.f0_emb(f0_coarse).transpose(1, 2)
        x = self.enc_(x * x_mask, x_mask, drop_generator)
        m, logs = torch.split(self.proj(x) * x_mask, self.out_channels, dim=1)
        if sample_noise:
            eps = torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype)
            z = (m + eps * torch.exp(logs) * noise_scale) * x_mask
        else:
            z = m * x_mask
        return z, m, logs


class PosteriorEncoder(nn.Module):
    """Linear-spec posterior (so-vits-svc ``Encoder``); training runs it."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, spec, lengths, g=None, generator: torch.Generator | None = None):
        """spec [B, F, T], lengths [B] -> (z, m, logs, x_mask [B, 1, T]); the
        sample z = m + eps exp(logs) draws eps from ``generator``, or is m without one."""
        x_mask = sequence_mask(lengths, spec.shape[2])[:, None, :].to(spec.dtype)
        x = self.pre(spec) * x_mask
        x = self.enc(x, x_mask, g=g)
        m, logs = torch.split(self.proj(x) * x_mask, self.out_channels, dim=1)
        if generator is not None:
            eps = torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype)
            return (m + eps * torch.exp(logs)) * x_mask, m, logs, x_mask
        return m * x_mask, m, logs, x_mask


class F0Decoder(nn.Module):
    """Causal-FFT lf0 predictor."""

    def __init__(self, out_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, spk_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        self.prenet = Conv1d(hidden_channels, hidden_channels, 3, padding=1)
        self.decoder = FFT(hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                           p_dropout=p_dropout)
        self.proj = Conv1d(hidden_channels, out_channels, 1)
        self.f0_prenet = Conv1d(1, hidden_channels, 3, padding=1)
        self.cond = Conv1d(spk_channels, hidden_channels, 1)

    def forward(self, x, norm_f0, x_mask, spk_emb=None, drop_generator=None):
        """x [B, H, T], norm_f0 [B, 1, T] -> pred lf0 [B, 1, T]."""
        x = x.detach()
        if spk_emb is not None:
            x = x + self.cond(spk_emb)
        x = x + self.f0_prenet(norm_f0)
        x = self.prenet(x) * x_mask
        x = self.decoder(x * x_mask, x_mask, drop_generator)
        return self.proj(x) * x_mask


class Synthesizer(nn.Module):
    def __init__(
        self,
        spec_channels: int = 1025,
        segment_size: int = 20,
        inter_channels: int = 192,
        hidden_channels: int = 192,
        filter_channels: int = 768,
        n_heads: int = 2,
        n_layers: int = 6,
        kernel_size: int = 3,
        p_dropout: float = 0.1,
        resblock: str = "1",
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
        upsample_rates: Sequence[int] = (8, 8, 2, 2, 2),
        upsample_initial_channel: int = 512,
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4, 4),
        gin_channels: int = 768,
        ssl_dim: int = 768,
        n_speakers: int = 200,
        sampling_rate: int = 44100,
        vol_embedding: bool = False,
        use_depthwise_conv: bool = False,
        use_automatic_f0_prediction: bool = True,
        flow_share_parameter: bool = False,
        n_flow_layer: int = 4,
        n_layers_trans_flow: int = 3,
        use_transformer_flow: bool = False,
        n_layers_q: int = 16,
        vocoder_name: str = "nsf-hifigan",
        fused_tail: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        """``segment_size`` is in latent frames (segment samples // hop);
        ``fused_tail`` decodes through the fused ResBlock trio where the
        generator allows it (resblock "1", plain convs); ``dtype`` is the
        compute type (float32 or bfloat16). The other keywords are
        so-vits-svc 4.1's model options, as the JAX package names them:
        ``vol_embedding`` adds a per-frame volume to the prenet,
        ``use_transformer_flow`` takes ``n_flow_layer`` couplings of causal
        FFTs ``n_layers_trans_flow`` deep (the WN flow has 4 couplings of WNs
        ``n_flow_layer`` deep), ``flow_share_parameter`` shares one inner net
        among the couplings, ``use_depthwise_conv`` makes the vocoder's
        resblock convs separable, and ``vocoder_name`` "nsf-snake-hifigan"
        takes the Snake generator."""
        super().__init__()
        self.segment_size = segment_size
        self.use_automatic_f0_prediction = use_automatic_f0_prediction
        self.vol_embedding = vol_embedding
        self.emb_g = Embedding(n_speakers, gin_channels)
        self.emb_uv = Embedding(2, hidden_channels)
        if vol_embedding:
            self.emb_vol = Linear(1, hidden_channels)
        self.pre = Conv1d(ssl_dim, hidden_channels, 5, padding=2)
        self.enc_p = ContentEncoder(inter_channels, hidden_channels, filter_channels, n_heads,
                                    n_layers, kernel_size, p_dropout)
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels, hidden_channels, 5, 1,
                                      n_layers_q, gin_channels)
        if use_transformer_flow:
            self.flow = TransformerCouplingBlock(
                inter_channels, hidden_channels, filter_channels, n_heads, n_layers_trans_flow, 5,
                p_dropout, n_flows=n_flow_layer, gin_channels=gin_channels,
                share_parameter=flow_share_parameter)
        else:  # so-vits-svc: always 4 couplings; n_flow_layer is each WN's depth
            self.flow = ResidualCouplingBlock(
                inter_channels, hidden_channels, 5, 1, n_flow_layer, n_flows=4,
                gin_channels=gin_channels, share_parameter=flow_share_parameter)
        if use_automatic_f0_prediction:
            self.f0_decoder = F0Decoder(1, hidden_channels, filter_channels, n_heads, n_layers,
                                        kernel_size, spk_channels=gin_channels,
                                        p_dropout=p_dropout)
        dec_args = (sampling_rate, inter_channels, resblock_kernel_sizes, resblock_dilation_sizes,
                    upsample_rates, upsample_initial_channel, upsample_kernel_sizes, gin_channels)
        snake = vocoder_name == "nsf-snake-hifigan"
        # as in the JAX package, the Snake vocoder takes no separable convs
        self.dec = Generator(*dec_args, fused_tail=fused_tail, resblock=resblock,
                             separable=use_depthwise_conv and not snake, snake=snake)
        set_compute_dtype(self, dtype)

    def _speaker_embedding(self, spk: torch.Tensor) -> torch.Tensor:
        """int ids [B] (or [B, 1]) -> [B, gin, 1]; float mix [B, T, S] -> [B, gin, T]."""
        if not spk.is_floating_point():
            if spk.dim() == 2:
                spk = spk[:, 0]
            return self.emb_g(spk)[:, :, None]
        return torch.einsum("bts,sg->bgt", spk, self.emb_g.weight.to(spk.dtype))

    def _prenet(self, c, uv, vol, x_mask):
        x = self.pre(c.transpose(1, 2)) * x_mask + self.emb_uv(uv.long()).transpose(1, 2)
        if self.vol_embedding and vol is not None:
            x = x + self.emb_vol(vol[..., None]).transpose(1, 2)
        return x

    def forward(self, c, f0, uv, spec, spk, c_lengths, vol=None, deterministic: bool = False,
                generator: torch.Generator | None = None):
        """The training forward: c [B, T, ssl], f0 / uv [B, T], spec [B, T, F],
        spk [B], c_lengths [B], vol [B, T] (read with ``vol_embedding``).
        Returns (wav [B, segment*hop, 1], ids_slice [B], spec_mask [B, T, 1],
        (z, z_p, m_p, logs_p, m_q, logs_q) [B, T, C], pred_lf0, norm_lf0,
        lf0 [B, T, 1]).

        ``deterministic`` (the JAX module's switch): no dropout, no noise, no
        random f0 scale, every slice at frame 0. Otherwise every draw comes
        from ``generator``.
        """
        if not deterministic and generator is None:
            raise ValueError("the stochastic training forward needs a generator")
        gen = None if deterministic else generator
        g = self._speaker_embedding(spk)
        x_mask = sequence_mask(c_lengths, c.shape[1])[:, None, :].to(c.dtype)  # [B, 1, T]
        x = self._prenet(c, uv, vol, x_mask)
        if self.use_automatic_f0_prediction:
            lf0 = f0_to_lf0(f0)[..., None]  # [B, T, 1]
            norm_lf0 = normalize_f0(lf0, x_mask.transpose(1, 2), uv, generator=gen)
            pred_lf0 = self.f0_decoder(x, norm_lf0.transpose(1, 2), x_mask, spk_emb=g,
                                       drop_generator=gen).transpose(1, 2)
        else:
            lf0 = norm_lf0 = pred_lf0 = torch.zeros((), device=c.device)
        # prior stats only: the reference's unused prior sample is not drawn
        _, m_p, logs_p = self.enc_p(x, x_mask, f0_to_coarse(f0), drop_generator=gen)
        z, m_q, logs_q, spec_mask = self.enc_q(spec.transpose(1, 2), c_lengths, g=g, generator=gen)
        z_p = self.flow(z, spec_mask, g=g, drop_generator=gen)
        z_cl = z.transpose(1, 2)
        if deterministic:
            ids_slice = torch.zeros(c.shape[0], dtype=torch.int32, device=c.device)
            z_slice, pitch_slice = z_cl[:, : self.segment_size], f0[:, : self.segment_size]
        else:
            z_slice, pitch_slice, ids_slice = rand_slice_segments_with_pitch(
                z_cl, f0, c_lengths, self.segment_size, gen)
        o = self.dec(z_slice.transpose(1, 2), pitch_slice, g=g, generator=gen)
        stats = tuple(t.transpose(1, 2) for t in (z, z_p, m_p, logs_p, m_q, logs_q))
        return (o.transpose(1, 2), ids_slice, spec_mask.transpose(1, 2), stats, pred_lf0,
                norm_lf0, lf0)

    @torch.no_grad()
    def infer_pre(self, c, f0, uv, spk, noise_scale: float = 0.35, predict_f0: bool = False,
                  sample_noise: bool = True, lengths=None, generator=None, vol=None):
        """``infer`` up to the vocoder: (z [B, inter, T] masked, f0 [B, T], g)."""
        g = self._speaker_embedding(spk)
        if lengths is None:
            lengths = torch.full((c.shape[0],), c.shape[1], device=c.device)
        x_mask = sequence_mask(lengths, c.shape[1])[:, None, :].to(c.dtype)  # [B, 1, T]
        x = self._prenet(c, uv, vol, x_mask)

        if self.use_automatic_f0_prediction and predict_f0:
            lf0 = f0_to_lf0(f0)[..., None]  # [B, T, 1]
            norm_lf0 = normalize_f0(lf0, x_mask.transpose(1, 2), uv)
            pred_lf0 = self.f0_decoder(x, norm_lf0.transpose(1, 2), x_mask, spk_emb=g)
            f0 = lf0_to_f0(pred_lf0)[:, 0]

        z_p, _m, _logs = self.enc_p(x, x_mask, f0_to_coarse(f0), noise_scale=noise_scale,
                                    generator=generator, sample_noise=sample_noise)
        z = self.flow(z_p, x_mask, g=g, reverse=True)
        return z * x_mask, f0, g

    @torch.no_grad()
    def infer(self, c, f0, uv, spk, noise_scale: float = 0.35, predict_f0: bool = False,
              sample_noise: bool = True, lengths=None, generator=None, vol=None):
        """(wav [B, T*hop, 1], f0 [B, T]); ``vol`` [B, T] is the per-frame
        volume a ``vol_embedding`` model reads. With ``sample_noise`` the prior
        noise and the source's random phases and noise come from
        ``generator`` (a freshly seeded one when None); without it the
        output is deterministic."""
        if sample_noise and generator is None:
            generator = torch.Generator(device=c.device)
            generator.seed()
        z, f0, g = self.infer_pre(c, f0, uv, spk, noise_scale, predict_f0, sample_noise,
                                  lengths, generator, vol)
        o = self.dec(z, f0, g=g, generator=generator if sample_noise else None)
        return o.transpose(1, 2), f0
