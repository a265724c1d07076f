"""GAN and VAE losses (counterpart of ``sovits_tpu/train/losses.py``;
so-vits-svc ``modules/losses.py``), reduced in float32."""

from __future__ import annotations

import torch


def discriminator_loss(real_outputs, fake_outputs):
    """LSGAN D loss: sum over discriminators of mean (1 - D(y))^2 + mean D(y_hat)^2."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outputs, fake_outputs):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(fake_outputs):
    """LSGAN G loss: sum of mean (1 - D(y_hat))^2."""
    losses = [torch.mean((1.0 - dg.float()) ** 2) for dg in fake_outputs]
    return sum(losses), losses


def feature_loss(fmap_real, fmap_fake):
    """L1 feature matching over all discriminator layers, times 2; the real
    side carries no gradient."""
    loss = 0.0
    for dr, dg in zip(fmap_real, fmap_fake):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, normaliser: torch.Tensor | None = None):
    """Masked KL(q || p) after the flow; inputs [B, T, C], z_mask [B, T, 1].
    The normaliser is the sum of the [B, T, 1] mask, not times channels,
    unless ``normaliser`` is given (a data-parallel rank's share of the
    global batch's mask sum)."""
    z_p, logs_q, m_p, logs_p, z_mask = (t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if normaliser is None else normaliser)
