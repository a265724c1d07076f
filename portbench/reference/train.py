"""so-vits-svc 4.1's GAN training step in plain PyTorch, float32: the
multi-period + scale discriminator (``models.py``), the losses
(``modules/losses.py``) and ``train.py``'s inner loop, with torch's AdamW
as so-vits-svc builds it (weight decay 0.01, one tensor at a time).

``step`` takes a batch in so-vits-svc's channels-first layout and the
step's generator; every random draw of the generator's forward comes from
it (``nets.Synthesizer.forward``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .audio import mel_basis, spec_to_mel, spectrogram
from .nets import WNConv

LRELU = 0.1
PERIODS = (2, 3, 5, 7, 11)
P_CHANNELS = (32, 128, 512, 1024)
S_SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
           (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))


class DiscP(nn.Module):
    def __init__(self, period):
        super().__init__()
        self.period = period
        ins = (1,) + P_CHANNELS
        self.convs = nn.ModuleList(WNConv(a, b, (5, 1), (3, 1), (2, 0), dims=2)
                                   for a, b in zip(ins[:-1], ins[1:]))
        self.convs.append(WNConv(1024, 1024, (5, 1), (1, 1), (2, 0), dims=2))
        self.conv_post = WNConv(1024, 1, (3, 1), (1, 1), (1, 0), dims=2)

    def forward(self, x):
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
            t = x.shape[-1]
        x = x.view(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscS(nn.Module):
    def __init__(self):
        super().__init__()
        ins = (1,) + tuple(s[0] for s in S_SPECS)
        self.convs = nn.ModuleList(WNConv(a, c, k, s, p, groups=g)
                                   for a, (c, k, s, g, p) in zip(ins, S_SPECS))
        self.conv_post = WNConv(1024, 1, 3, padding=1)

    def forward(self, x):
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class Discriminator(nn.Module):
    """``MultiPeriodDiscriminator``: slot 0 the scale discriminator, then periods 2-11."""

    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscS()] + [DiscP(p) for p in PERIODS])

    def forward(self, y, y_hat):
        out = [], [], [], []
        for d in self.discriminators:
            r, fr = d(y)
            g, fg = d(y_hat)
            for lst, v in zip(out, (r, g, fr, fg)):
                lst.append(v)
        return out


def d_loss(real, fake):
    return sum(torch.mean((1 - r) ** 2) + torch.mean(g ** 2) for r, g in zip(real, fake))


def g_loss(fake):
    return sum(torch.mean((1 - g) ** 2) for g in fake)


def fm_loss(fr, fg):
    return 2 * sum(torch.mean(torch.abs(r.detach() - g)) for dr, dg in zip(fr, fg) for r, g in zip(dr, dg))


def kl_loss(z_p, logs_q, m_p, logs_p, mask):
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2 * logs_p)
    return torch.sum(kl * mask) / torch.sum(mask)


def adamw(params, hps):
    t = hps["train"]
    return torch.optim.AdamW(params, lr=t["learning_rate"], betas=tuple(t["betas"]), eps=t["eps"],
                             weight_decay=0.01, foreach=False)


def step(net_g, net_d, opt_g, opt_d, batch: dict, hps, gen) -> dict:
    """One so-vits-svc step: D on (y, y_hat detached), then G against the
    updated D. ``batch``: c [B, ssl, T], f0 / uv / volume [B, T], spec [B, F, T],
    wav [B, 1, L], spk / lengths [B]. Returns the losses as floats."""
    d = hps["data"]
    hop, seg = d["hop_length"], hps["train"]["segment_size"]
    o, ids, x_mask, (z, z_p, m_p, logs_p, m_q, logs_q), pred_lf0, lf0 = net_g(
        batch["c"], batch["f0"], batch["uv"], batch["spec"], batch["spk"], batch["lengths"],
        batch["volume"] if net_g.vol_embedding else None, gen)
    idx = ids.long()[:, None] * hop + torch.arange(seg, device=o.device)[None]
    y = torch.gather(batch["wav"], 2, idx[:, None])
    real, fake, _, _ = net_d(y, o.detach())
    loss_d = d_loss(real, fake)
    opt_d.zero_grad(set_to_none=True)
    loss_d.backward()
    opt_d.step()
    for p in net_d.parameters():
        p.requires_grad_(False)
    basis = torch.from_numpy(mel_basis(d["sampling_rate"], d["filter_length"], d["n_mel_channels"],
                                       d["mel_fmin"], d["mel_fmax"])).to(o.device)
    with torch.no_grad():
        mel = spec_to_mel(batch["spec"], basis)
        fidx = ids.long()[:, None] + torch.arange(seg // hop, device=o.device)[None]
        y_mel = torch.gather(mel, 2, fidx[:, None].expand(-1, mel.shape[1], -1))
    y_hat_mel = spec_to_mel(spectrogram(o[:, 0], d["filter_length"], hop, d["win_length"]), basis)
    _, fake, fr, fg = net_d(y, o)
    for p in net_d.parameters():
        p.requires_grad_(True)
    t = hps["train"]
    loss_mel = F.l1_loss(y_hat_mel, y_mel) * t["c_mel"]
    loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, x_mask) * t["c_kl"]
    loss_fm = fm_loss(fr, fg)
    loss_gen = g_loss(fake)
    loss_lf0 = F.mse_loss(pred_lf0, lf0)
    total = loss_gen + loss_fm + loss_mel + loss_kl + loss_lf0
    opt_g.zero_grad(set_to_none=True)
    total.backward()
    opt_g.step()
    return {"loss/g/total": total, "loss/g/mel": loss_mel, "loss/g/kl": loss_kl,
            "loss/g/fm": loss_fm, "loss/g/gen": loss_gen, "loss/g/lf0": loss_lf0,
            "loss/d/total": loss_d}
