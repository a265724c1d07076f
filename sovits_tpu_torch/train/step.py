"""One GAN training step (counterpart of ``sovits_tpu/train/step.py``;
so-vits-svc ``train.py``'s inner loop).

1. One generator forward: a random slice of the latent, the posterior
   sample, dropout; every draw from the step's generator.
2. The D step on (y, y_hat detached), LSGAN loss, AdamW.
3. The G step against the *updated* D, from the same forward:
   mel L1 * c_mel + KL * c_kl + feature matching + LSGAN + lf0 MSE.
Both global gradient norms are logged; nothing is clipped (so-vits-svc's
``clip_grad_value_`` with no value only measures the norm).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dsp.sequence import slice_segments
from ..dsp.stft import mel_spectrogram, spec_to_mel
from .losses import discriminator_loss, feature_loss, generator_loss, kl_loss
from .optim import global_norm


def train_step(net_g, net_d, optim_g, optim_d, batch: dict, hps,
               generator: torch.Generator | None = None, deterministic: bool = False) -> dict:
    """Update both nets once from ``batch`` (the data pipeline's layout:
    c [B, T, ssl], f0 / uv [B, T], spec [B, T, F], spk [B], lengths [B],
    wav [B, T*hop, 1], volume [B, T], which a ``vol_embedding`` model
    reads). Returns the step's metrics as 0-d tensors."""
    d = hps.data
    hop = d.hop_length
    mel_kw = dict(n_fft=d.filter_length, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
                  fmin=d.mel_fmin, fmax=d.mel_fmax)
    y_hat, ids_slice, spec_mask, (z, z_p, m_p, logs_p, m_q, logs_q), pred_lf0, _norm_lf0, lf0 = net_g(
        batch["c"], batch["f0"], batch["uv"], batch["spec"], batch["spk"], batch["lengths"],
        vol=batch.get("volume"),
        deterministic=deterministic, generator=generator,
    )
    y_seg = slice_segments(batch["wav"], ids_slice * hop, hps.train.segment_size)

    # ---- D step on the detached generator output
    net_d.requires_grad_(True)
    y_d_r, y_d_g, _, _ = net_d(y_seg, y_hat.detach())
    loss_disc, _, _ = discriminator_loss(y_d_r, y_d_g)
    optim_d.zero_grad(set_to_none=True)
    loss_disc.backward()
    grad_norm_d = global_norm(net_d.parameters())
    optim_d.step()

    # ---- G step against the updated D; D's weights take no gradient here
    net_d.requires_grad_(False)
    with torch.no_grad():
        y_mel = slice_segments(spec_to_mel(batch["spec"], **mel_kw), ids_slice,
                               hps.train.segment_size // hop)
    y_hat_mel = mel_spectrogram(y_hat[..., 0], hop_length=hop, win_length=d.win_length, **mel_kw)
    _, y_d_g, fmap_r, fmap_g = net_d(y_seg, y_hat)
    net_d.requires_grad_(True)
    loss_mel = F.l1_loss(y_hat_mel, y_mel) * hps.train.c_mel
    loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, spec_mask) * hps.train.c_kl
    loss_fm = feature_loss(fmap_r, fmap_g)
    loss_gen, _ = generator_loss(y_d_g)
    if hps.model.use_automatic_f0_prediction:
        loss_lf0 = F.mse_loss(pred_lf0, lf0)
    else:
        loss_lf0 = torch.zeros((), device=y_hat.device)
    total = loss_gen + loss_fm + loss_mel + loss_kl + loss_lf0
    optim_g.zero_grad(set_to_none=True)
    total.backward()
    grad_norm_g = global_norm(net_g.parameters())
    optim_g.step()
    return {
        "loss/g/total": total.detach(), "loss/g/mel": loss_mel.detach(),
        "loss/g/kl": loss_kl.detach(), "loss/g/fm": loss_fm.detach(),
        "loss/g/gen": loss_gen.detach(), "loss/g/lf0": loss_lf0.detach(),
        "loss/d/total": loss_disc.detach(), "grad_norm_d": grad_norm_d, "grad_norm_g": grad_norm_g,
    }
