"""so-vits-svc 4.1's synthesizer in plain PyTorch, float32: the benchmark's
reference for what the program's synthesizer computes.

It follows so-vits-svc's ``models.py``, ``modules/attentions.py``,
``modules/modules.py``, ``modules/flows.py`` and
``vdecoder/hifigan/models.py`` (NSF-HiFiGAN), with their parameter names,
so one seeded state dict loads into it and into the program alike. No
kernel, no cache, no batching: attention is the dense softmax with Shaw's
windowed relative tables, every conv is ``torch.nn.functional``, weight
norm is g * v / ||v|| at every call.

Where the published model draws random numbers (dropout, the f0 random
scale, the posterior and prior noise, the segment offsets, the harmonic
source's initial phases and noise), the draws come from one explicit
``torch.Generator`` in the order the models run them, so a run with the
same generator state draws the same numbers:

- dropout keeps an element where ``rand >= p`` and scales it by 1 / (1 - p);
- the attention's dropout acts on the probabilities [B, H, T, T];
- the source draws its initial phases U(0, 1) [B, 9, 1, 1] (the
  fundamental's set to 0), then its noise N(0, 1) [B, 9, T, upp].

Departures from so-vits-svc, each shared with the program under test:
the harmonic phase is summed per frame (f0 is constant over a hop) in
float64, not as a float32 cumulative sum over samples; keys and queries
beyond a row's length are masked as so-vits-svc masks them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LRELU = 0.1


def dropout(x, p, gen):
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def sequence_mask(lengths, t):
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).float()


class WNConv(nn.Module):
    """weight_norm(conv): ``weight_g`` per output channel (per input channel
    for a transposed conv), ``weight_v``, ``bias``."""

    def __init__(self, c_in, c_out, k, stride=1, padding=0, dilation=1, groups=1,
                 transposed=False, dims=1, bias=True):
        super().__init__()
        ks = (k,) if dims == 1 else tuple(k)
        shape = (c_in, c_out, *ks) if transposed else (c_out, c_in // groups, *ks)
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.empty((shape[0],) + (1,) * (len(shape) - 1)))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.transposed, self.dims = transposed, dims

    def weight(self):
        v = self.weight_v
        norm = torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True)
        return self.weight_g * v / norm

    def forward(self, x):
        w = self.weight()
        if self.transposed:
            return F.conv_transpose1d(x, w, self.bias, self.stride, self.padding)
        if self.dims == 2:
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        return F.conv1d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)


class LayerNorm(nn.Module):
    """Channel LayerNorm on [B, C, T] (``gamma``, ``beta``)."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma, self.beta,
                            self.eps).transpose(1, -1)


def gated(x, cond):
    a, b = torch.chunk(x + cond, 2, dim=1)
    return torch.tanh(a) * torch.sigmoid(b)


class MultiHeadAttention(nn.Module):
    def __init__(self, channels, n_heads, window=None, p_dropout=0.0):
        super().__init__()
        self.h, self.d, self.window, self.p = n_heads, channels // n_heads, window, p_dropout
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        if window is not None:
            self.emb_rel_k = nn.Parameter(torch.empty(1, 2 * window + 1, self.d))
            self.emb_rel_v = nn.Parameter(torch.empty(1, 2 * window + 1, self.d))

    def _band(self, t):
        """[T, T] index into the (2w+1) table for key - query offsets in the
        window, and the mask of those pairs."""
        idx = torch.arange(t)
        off = idx[None, :] - idx[:, None] + self.window
        inside = (off >= 0) & (off <= 2 * self.window)
        return off.clamp(0, 2 * self.window), inside

    def forward(self, x, mask, causal=False, gen=None):
        """x [B, C, T]; mask [B, T] (1 = a real frame)."""
        b, c, t = x.shape
        h, d = self.h, self.d
        q = self.conv_q(x).view(b, h, d, t).transpose(2, 3) / math.sqrt(d)
        k = self.conv_k(x).view(b, h, d, t).transpose(2, 3)
        v = self.conv_v(x).view(b, h, d, t).transpose(2, 3)
        scores = q @ k.transpose(2, 3)
        if self.window is not None:
            off, inside = self._band(t)
            off, inside = off.to(x.device), inside.to(x.device)
            rel = q @ self.emb_rel_k[0].t()  # [B, H, T, 2w+1]
            scores = scores + torch.gather(rel, 3, off.expand(b, h, t, t)) * inside
        keep = mask[:, None, :, None] * mask[:, None, None, :] > 0
        if causal:
            keep = keep & torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, -1e4)
        p = torch.softmax(scores, dim=-1)
        if gen is not None and self.p > 0.0:
            drop = torch.rand((b, h, t, t), generator=gen, device=x.device) >= self.p
            p = p * drop / (1.0 - self.p)
        out = p @ v
        if self.window is not None:
            band = torch.zeros(b, h, t, 2 * self.window + 1, device=x.device)
            band.scatter_add_(3, off.expand(b, h, t, t), p * inside)
            out = out + band @ self.emb_rel_v[0]
        return self.conv_o(out.transpose(2, 3).reshape(b, c, t))


class FFN(nn.Module):
    def __init__(self, c, filt, k, causal=False, p_dropout=0.0):
        super().__init__()
        self.p = p_dropout
        self.conv_1 = nn.Conv1d(c, filt, k)
        self.conv_2 = nn.Conv1d(filt, c, k)
        self.pad = (k - 1, 0) if causal else ((k - 1) // 2, k // 2)

    def forward(self, x, x_mask, gen=None):
        x = torch.relu(self.conv_1(F.pad(x * x_mask, self.pad)))
        x = dropout(x, self.p, gen)
        return self.conv_2(F.pad(x * x_mask, self.pad)) * x_mask


class Encoder(nn.Module):
    """Post-LN stack with windowed relative attention (``attentions.Encoder``)."""

    def __init__(self, c, filt, heads, layers, k, window=4, p_dropout=0.0):
        super().__init__()
        self.p = p_dropout
        self.attn_layers = nn.ModuleList(MultiHeadAttention(c, heads, window, p_dropout)
                                         for _ in range(layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(c) for _ in range(layers))
        self.ffn_layers = nn.ModuleList(FFN(c, filt, k, p_dropout=p_dropout) for _ in range(layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(c) for _ in range(layers))

    def forward(self, x, x_mask, gen=None):
        x = x * x_mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                     self.norm_layers_2):
            y = attn(x, x_mask[:, 0], gen=gen)
            x = n1(x + dropout(y, self.p, gen))
            x = n2(x + dropout(ffn(x, x_mask, gen), self.p, gen))
        return x * x_mask


class FFT(nn.Module):
    """Causal stack (``attentions.FFT``); with ``isflow`` gated on g per layer."""

    def __init__(self, c, filt, heads, layers, k, p_dropout=0.0, isflow=False, gin=0):
        super().__init__()
        self.p, self.c = p_dropout, c
        if isflow:
            self.cond_layer = WNConv(gin, 2 * c * layers, 1)
            self.cond_pre = nn.Conv1d(c, 2 * c, 1)
        self.self_attn_layers = nn.ModuleList(MultiHeadAttention(c, heads, None, p_dropout)
                                              for _ in range(layers))
        self.norm_layers_0 = nn.ModuleList(LayerNorm(c) for _ in range(layers))
        self.ffn_layers = nn.ModuleList(FFN(c, filt, k, causal=True, p_dropout=p_dropout)
                                        for _ in range(layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(c) for _ in range(layers))

    def forward(self, x, x_mask, gen=None, g=None):
        g_all = self.cond_layer(g) if g is not None and hasattr(self, "cond_layer") else None
        c = self.c
        x = x * x_mask
        for i, (attn, n0, ffn, n1) in enumerate(zip(self.self_attn_layers, self.norm_layers_0,
                                                    self.ffn_layers, self.norm_layers_1)):
            if g_all is not None:
                x = gated(self.cond_pre(x), g_all[:, i * 2 * c:(i + 1) * 2 * c])
            y = attn(x, torch.ones_like(x_mask[:, 0]), causal=True, gen=gen)
            x = n0(x + dropout(y, self.p, gen))
            x = n1(x + dropout(ffn(x, x_mask, gen), self.p, gen))
        return x * x_mask


class WN(nn.Module):
    def __init__(self, c, k, dil_rate, layers, gin=0):
        super().__init__()
        self.c, self.layers = c, layers
        self.cond_layer = WNConv(gin, 2 * c * layers, 1) if gin else None
        self.in_layers = nn.ModuleList(
            WNConv(c, 2 * c, k, dilation=dil_rate**i, padding=(k - 1) * dil_rate**i // 2)
            for i in range(layers))
        self.res_skip_layers = nn.ModuleList(
            WNConv(c, c if i == layers - 1 else 2 * c, 1) for i in range(layers))

    def forward(self, x, x_mask, g=None, gen=None):
        c = self.c
        g_all = self.cond_layer(g) if g is not None and self.cond_layer is not None else None
        out = torch.zeros_like(x)
        for i in range(self.layers):
            acts = gated(self.in_layers[i](x),
                         g_all[:, i * 2 * c:(i + 1) * 2 * c] if g_all is not None else 0.0)
            rs = self.res_skip_layers[i](acts)
            if i < self.layers - 1:
                x = (x + rs[:, :c]) * x_mask
                out = out + rs[:, c:]
            else:
                out = out + rs
        return out * x_mask


class Coupling(nn.Module):
    """Mean-only affine coupling: pre -> enc -> post shifts the second half."""

    def __init__(self, channels, hidden, enc):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Conv1d(self.half, hidden, 1)
        self.enc = enc
        self.post = nn.Conv1d(hidden, self.half, 1)

    def forward(self, x, x_mask, g=None, reverse=False, gen=None):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        if isinstance(self.enc, FFT):
            h = self.enc(h, x_mask, gen, g=g)
        else:
            h = self.enc(h, x_mask, g=g, gen=gen)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], 1)


class Flip(nn.Module):
    def forward(self, x, *args, **kwargs):
        return torch.flip(x, [1])


class CouplingBlock(nn.Module):
    def __init__(self, couplings):
        super().__init__()
        self.flows = nn.ModuleList()
        for c in couplings:
            self.flows.append(c)
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse=False, gen=None):
        for f in (reversed(self.flows) if reverse else self.flows):
            x = f(x, x_mask, g=g, reverse=reverse, gen=gen)
        return x


class SourceNSF(nn.Module):
    """Harmonic sine source (fundamental + 8 harmonics), merged by a linear + tanh."""

    def __init__(self, sr, harmonics=8, sine_amp=0.1, noise_std=0.003):
        super().__init__()
        self.sr, self.h, self.sine_amp, self.noise_std = sr, harmonics + 1, sine_amp, noise_std
        self.l_linear = nn.Linear(harmonics + 1, 1)

    def forward(self, f0, upp, gen=None):
        b, t = f0.shape
        dev = f0.device
        mult = torch.arange(1, self.h + 1, dtype=torch.float32, device=dev)
        rad = (f0[:, None, :] * mult[None, :, None] / self.sr) % 1.0  # turns per sample
        adv = ((rad * upp) % 1.0).double()
        base = ((torch.cumsum(adv, -1) - adv) % 1.0).float()
        phase = base[..., None] + torch.arange(1, upp + 1, dtype=torch.float32, device=dev) * rad[..., None]
        if gen is not None:
            ini = torch.rand(b, self.h, 1, 1, generator=gen, device=dev)
            ini[:, 0] = 0.0
            phase = phase + ini
        sines = torch.sin(2 * math.pi * phase) * self.sine_amp
        uv = (f0 > 0).float()[:, None, :, None]
        if gen is not None:
            amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
            sines = sines * uv + amp * torch.randn(sines.shape, generator=gen, device=dev)
        else:
            sines = sines * uv
        merged = torch.einsum("bhtu,h->btu", sines, self.l_linear.weight[0]) + self.l_linear.bias
        return torch.tanh(merged.reshape(b, 1, t * upp))


class ResBlock1(nn.Module):
    def __init__(self, c, k, dils):
        super().__init__()
        self.convs1 = nn.ModuleList(WNConv(c, c, k, padding=(k - 1) * d // 2, dilation=d) for d in dils)
        self.convs2 = nn.ModuleList(WNConv(c, c, k, padding=(k - 1) // 2) for _ in dils)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU)), LRELU)) + x
        return x


class NSFHiFiGAN(nn.Module):
    def __init__(self, m, sr):
        super().__init__()
        rates, kernels = m["upsample_rates"], m["upsample_kernel_sizes"]
        ch0 = m["upsample_initial_channel"]
        self.upp = math.prod(rates)
        self.nk = len(m["resblock_kernel_sizes"])
        self.m_source = SourceNSF(sr)
        self.conv_pre = WNConv(m["inter_channels"], ch0, 7, padding=3)
        self.ups, self.noise_convs, self.resblocks = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(rates, kernels)):
            ch = ch0 // 2 ** (i + 1)
            self.ups.append(WNConv(2 * ch, ch, k, stride=u, padding=(k - u + 1) // 2, transposed=True))
            if i + 1 < len(rates):
                s = math.prod(rates[i + 1:])
                self.noise_convs.append(nn.Conv1d(1, ch, 2 * s, stride=s, padding=(s + 1) // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(m["resblock_kernel_sizes"], m["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = WNConv(ch, 1, 7, padding=3)
        self.cond = nn.Conv1d(m["gin_channels"], ch0, 1)

    def forward(self, x, f0, g, gen=None):
        har = self.m_source(f0, self.upp, gen)
        x = self.conv_pre(x) + self.cond(g)
        for i in range(len(self.ups)):
            x = self.ups[i](F.leaky_relu(x, LRELU)) + self.noise_convs[i](har)
            blocks = self.resblocks[i * self.nk:(i + 1) * self.nk]
            x = sum(blk(x) for blk in blocks) / self.nk
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))


F0_MEL_MIN = 1127.0 * math.log(1.0 + 50.0 / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + 1100.0 / 700.0)


def f0_to_coarse(f0):
    mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    a = 254.0 / (F0_MEL_MAX - F0_MEL_MIN)
    mel = torch.where(mel > 0, mel * a - (F0_MEL_MIN * a - 1.0), mel)
    c = torch.round(mel).long()
    c = c * (c > 0)
    c = c + (c < 1).long()
    c = c * (c < 256)
    return c + (c >= 256).long() * 255


def f0_to_lf0(f0):
    return 2595.0 * torch.log10(1.0 + f0 / 700.0) / 500.0


class Synthesizer(nn.Module):
    """so-vits-svc 4.1's ``SynthesizerTrn``: layouts as so-vits-svc's,
    channels-first; c [B, ssl, T], f0 / uv [B, T]."""

    def __init__(self, hps):
        super().__init__()
        m, d = hps["model"], hps["data"]
        hid, inter, filt = m["hidden_channels"], m["inter_channels"], m["filter_channels"]
        heads, layers, k, p = m["n_heads"], m["n_layers"], m["kernel_size"], m["p_dropout"]
        gin = m["gin_channels"]
        self.vol_embedding = bool(m.get("vol_embedding"))
        self.segment = hps["train"]["segment_size"] // d["hop_length"]
        self.emb_g = nn.Embedding(m["n_speakers"], gin)
        self.emb_uv = nn.Embedding(2, hid)
        if self.vol_embedding:
            self.emb_vol = nn.Linear(1, hid)
        self.pre = nn.Conv1d(m["ssl_dim"], hid, 5, padding=2)
        self.enc_p = nn.Module()
        self.enc_p.f0_emb = nn.Embedding(256, hid)
        self.enc_p.enc_ = Encoder(hid, filt, heads, layers, k, p_dropout=p)
        self.enc_p.proj = nn.Conv1d(hid, 2 * inter, 1)
        self.enc_q = nn.Module()
        self.enc_q.pre = nn.Conv1d(d["filter_length"] // 2 + 1, hid, 1)
        self.enc_q.enc = WN(hid, 5, 1, 16, gin)
        self.enc_q.proj = nn.Conv1d(hid, 2 * inter, 1)
        if m.get("use_transformer_flow"):
            couplings = [Coupling(inter, hid, FFT(hid, filt, heads, m["n_layers_trans_flow"], 5, p,
                                                  isflow=True, gin=gin))
                         for _ in range(m["n_flow_layer"])]
        else:
            couplings = [Coupling(inter, hid, WN(hid, 5, 1, m["n_flow_layer"], gin)) for _ in range(4)]
        self.flow = CouplingBlock(couplings)
        self.f0_decoder = nn.Module()
        fd = self.f0_decoder
        fd.prenet = nn.Conv1d(hid, hid, 3, padding=1)
        fd.decoder = FFT(hid, filt, heads, layers, k, p)
        fd.proj = nn.Conv1d(hid, 1, 1)
        fd.f0_prenet = nn.Conv1d(1, hid, 3, padding=1)
        fd.cond = nn.Conv1d(gin, hid, 1)
        self.dec = NSFHiFiGAN(m, d["sampling_rate"])

    def _prenet(self, c, uv, vol, x_mask):
        x = self.pre(c) * x_mask + self.emb_uv(uv.long()).transpose(1, 2)
        if self.vol_embedding and vol is not None:
            x = x + self.emb_vol(vol[..., None]).transpose(1, 2)
        return x

    def _enc_p(self, x, x_mask, f0, gen=None):
        x = x + self.enc_p.f0_emb(f0_to_coarse(f0)).transpose(1, 2)
        x = self.enc_p.enc_(x * x_mask, x_mask, gen)
        return torch.chunk(self.enc_p.proj(x) * x_mask, 2, dim=1)

    def infer(self, c, f0, uv, spk, lengths, noise_scale, gen, vol=None):
        """Serving: (audio [B, 1, T*hop])."""
        g = self.emb_g(spk)[:, :, None]
        x_mask = sequence_mask(lengths, c.shape[2])[:, None]
        x = self._prenet(c, uv, vol, x_mask)
        m, logs = self._enc_p(x, x_mask, f0)
        eps = torch.randn(m.shape, generator=gen, device=m.device)
        z_p = (m + eps * torch.exp(logs) * noise_scale) * x_mask
        z = self.flow(z_p, x_mask, g=g, reverse=True)
        return self.dec(z * x_mask, f0, g, gen)

    def forward(self, c, f0, uv, spec, spk, lengths, vol, gen):
        """Training: the random-slice forward (so-vits-svc ``SynthesizerTrn.forward``)."""
        g = self.emb_g(spk)[:, :, None]
        t = c.shape[2]
        x_mask = sequence_mask(lengths, t)[:, None]
        x = self._prenet(c, uv, vol, x_mask)
        lf0 = f0_to_lf0(f0)[:, None]  # [B, 1, T]
        uv_sum = uv.sum(1, keepdim=True)
        uv_sum = torch.where(uv_sum == 0, torch.full_like(uv_sum, 9999.0), uv_sum)
        mean = (lf0[:, 0] * uv).sum(1, keepdim=True) / uv_sum
        scale = torch.rand(f0.shape[0], 1, generator=gen, device=f0.device) * 0.4 + 0.8
        norm_lf0 = (lf0 - mean[:, None]) * scale[:, None] * x_mask
        fd = self.f0_decoder
        h = x.detach() + fd.cond(g) + fd.f0_prenet(norm_lf0)
        h = fd.prenet(h) * x_mask
        pred_lf0 = fd.proj(fd.decoder(h * x_mask, x_mask, gen)) * x_mask
        m_p, logs_p = self._enc_p(x, x_mask, f0, gen)
        q = self.enc_q
        hq = q.enc(q.pre(spec) * x_mask, x_mask, g=g)
        m_q, logs_q = torch.chunk(q.proj(hq) * x_mask, 2, dim=1)
        z = (m_q + torch.randn(m_q.shape, generator=gen, device=m_q.device) * torch.exp(logs_q)) * x_mask
        z_p = self.flow(z, x_mask, g=g, gen=gen)
        u = torch.rand(c.shape[0], generator=gen, device=c.device)
        ids = torch.clamp((u * (lengths - self.segment + 1).float()).int(), min=0)
        idx = ids.long()[:, None] + torch.arange(self.segment, device=c.device)[None, :]
        z_slice = torch.gather(z, 2, idx[:, None].expand(-1, z.shape[1], -1))
        pitch = torch.gather(f0, 1, idx)
        o = self.dec(z_slice, pitch, g, gen)
        return o, ids, x_mask, (z, z_p, m_p, logs_p, m_q, logs_q), pred_lf0, lf0
