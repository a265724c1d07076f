"""One GAN training step (counterpart of ``sovits_tpu/train/step.py``;
so-vits-svc ``train.py``'s inner loop).

1. One generator forward: a random slice of the latent, the posterior
   sample, dropout; every draw from the step's generator.
2. The D step on (y, y_hat detached), LSGAN loss, AdamW.
3. The G step against the *updated* D, from the same forward:
   mel L1 * c_mel + KL * c_kl + feature matching + LSGAN + lf0 MSE.
Both global gradient norms are logged; nothing is clipped (so-vits-svc's
``clip_grad_value_`` with no value only measures the norm).

Under data parallelism (``mesh``; the nets wrapped in DDP, or sharded by
``parallel.shard_params``) each rank holds its rows of the global batch.
The gradients are averaged over the ranks, so every loss must be a mean
whose average over the ranks is the global batch's: the KL's masked sum is
divided by the mask sum over the whole batch, and the metrics are averaged
over the "data" axis, as the JAX step's are over the global batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from ..dsp.sequence import slice_segments
from ..dsp.stft import mel_spectrogram, spec_to_mel
from ..parallel.mesh import data_size
from ..utils import annotate
from .losses import discriminator_loss, feature_loss, generator_loss, kl_loss
from .optim import global_norm


def _unwrapped(net):
    """The module under a DDP wrapper (FSDP2 shards the module itself)."""
    return net.module if isinstance(net, DistributedDataParallel) else net


def _data_mean(values: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Each value averaged over the mesh's "data" axis, in one all-reduce."""
    n = data_size(mesh)
    if n == 1:
        return values
    stacked = torch.stack([v.float() for v in values])
    dist.all_reduce(stacked, group=mesh["data"].get_group())
    return list(stacked / n)


def train_step(net_g, net_d, optim_g, optim_d, batch: dict, hps,
               generator: torch.Generator | None = None, deterministic: bool = False,
               mesh=None) -> dict:
    """Update both nets once from ``batch`` (the data pipeline's layout:
    c [B, T, ssl], f0 / uv [B, T], spec [B, T, F], spk [B], lengths [B],
    wav [B, T*hop, 1], volume [B, T], which a ``vol_embedding`` model
    reads). Returns the step's metrics as 0-d tensors. With a ``mesh``
    (``parallel.make_mesh``) ``batch`` is this rank's rows, the nets are
    DDP-wrapped or FSDP-sharded, and the metrics are the global batch's."""
    d = hps.data
    hop = d.hop_length
    mel_kw = dict(n_fft=d.filter_length, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
                  fmin=d.mel_fmin, fmax=d.mel_fmax)
    with annotate("train.g_forward"):
        y_hat, ids_slice, spec_mask, (z, z_p, m_p, logs_p, m_q, logs_q), pred_lf0, _norm_lf0, lf0 = net_g(
            batch["c"], batch["f0"], batch["uv"], batch["spec"], batch["spk"], batch["lengths"],
            vol=batch.get("volume"),
            deterministic=deterministic, generator=generator,
        )
        y_seg = slice_segments(batch["wav"], ids_slice * hop, hps.train.segment_size)

    # ---- D step on the detached generator output
    with annotate("train.d_step"):
        net_d.requires_grad_(True)
        y_d_r, y_d_g, _, _ = net_d(y_seg, y_hat.detach())
        loss_disc, _, _ = discriminator_loss(y_d_r, y_d_g)
        optim_d.zero_grad(set_to_none=True)
        loss_disc.backward()
        grad_norm_d = global_norm(net_d.parameters())
        optim_d.step()

    # ---- G step against the updated D; D's weights take no gradient here.
    # A DDP wrapper would wait for D gradients that never come: call its module
    with annotate("train.g_step"):
        d_module = _unwrapped(net_d)
        d_module.requires_grad_(False)
        with torch.no_grad():
            y_mel = slice_segments(spec_to_mel(batch["spec"], **mel_kw), ids_slice,
                                   hps.train.segment_size // hop)
        y_hat_mel = mel_spectrogram(y_hat[..., 0], hop_length=hop, win_length=d.win_length, **mel_kw)
        _, y_d_g, fmap_r, fmap_g = d_module(y_seg, y_hat)
        d_module.requires_grad_(True)
        loss_mel = F.l1_loss(y_hat_mel, y_mel) * hps.train.c_mel
        # the KL's normaliser is the global batch's mask sum (rows differ in
        # length); times the data ranks, as their gradients are averaged
        mask_sum = None
        n_data = data_size(mesh)
        if n_data > 1:
            mask_sum = spec_mask.float().sum()
            dist.all_reduce(mask_sum, group=mesh["data"].get_group())
            mask_sum = mask_sum / n_data
        loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, spec_mask, mask_sum) * hps.train.c_kl
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
    losses = {"loss/g/total": total, "loss/g/mel": loss_mel, "loss/g/kl": loss_kl,
              "loss/g/fm": loss_fm, "loss/g/gen": loss_gen, "loss/g/lf0": loss_lf0,
              "loss/d/total": loss_disc}
    means = _data_mean([v.detach() for v in losses.values()], mesh)
    return {**dict(zip(losses, means)), "grad_norm_d": grad_norm_d, "grad_norm_g": grad_norm_g}
