"""Unit2Mel: units + f0 + volume (+ speaker, + aug shift) -> mel by
diffusion (counterpart of ``sovits_tpu/models/diffusion/unit2mel.py``;
so-vits-svc ``diffusion/unit2mel.py``).

The condition is a sum of linear embeddings; the decoder is the diffusion
WaveNet driven by a :class:`DiffusionSchedule`. Parameter names are
so-vits-svc's (``unit_embed``, ``f0_embed``, ``volume_embed``,
``aug_shift_embed``, ``spk_embed``, ``decoder.denoise_fn.*``); its
``GaussianDiffusion`` also stores the schedule's tables as buffers, which
the port recomputes from the config (``train/diffusion.py`` drops them on
load). The public layouts are so-vits-svc's and the JAX package's: units
[B, T, C], f0 and volume [B, T], mel [B, T, M]; the decoder runs channels
first.
"""

from __future__ import annotations

import torch
from torch import nn

from . import gaussian
from .gaussian import DiffusionSchedule
from .wavenet import DiffusionWaveNet


class Unit2Mel(nn.Module):
    def __init__(self, input_channel: int = 768, n_spk: int = 1, use_pitch_aug: bool = False,
                 out_dims: int = 128, n_layers: int = 20, n_chans: int = 384,
                 n_hidden: int = 256, timesteps: int = 1000, k_step_max: int = 1000,
                 spec_min: float = -12.0, spec_max: float = 2.0):
        super().__init__()
        self.n_spk = n_spk
        self.use_pitch_aug = use_pitch_aug
        self.out_dims = out_dims
        self.timesteps = timesteps
        k = k_step_max if 0 < k_step_max < timesteps else timesteps
        self.schedule = DiffusionSchedule(timesteps=timesteps, k_step=k, spec_min=spec_min,
                                          spec_max=spec_max)
        self.unit_embed = nn.Linear(input_channel, n_hidden)
        self.f0_embed = nn.Linear(1, n_hidden)
        self.volume_embed = nn.Linear(1, n_hidden)
        if use_pitch_aug:
            self.aug_shift_embed = nn.Linear(1, n_hidden, bias=False)
        if n_spk is not None and n_spk > 1:
            self.spk_embed = nn.Embedding(n_spk, n_hidden)
        self.decoder = nn.ModuleDict(
            {"denoise_fn": DiffusionWaveNet(out_dims, n_layers, n_chans, n_hidden)})

    def condition(self, units: torch.Tensor, f0: torch.Tensor, volume: torch.Tensor,
                  spk_id: torch.Tensor | None = None,
                  aug_shift: torch.Tensor | None = None) -> torch.Tensor:
        """units [B, T, C], f0 [B, T] Hz, volume [B, T]; spk_id an integer
        [B] id, a static mix [B, S] or a per-frame mix [B, T, S]; aug_shift
        [B] semitones -> the condition [B, T, H]."""
        x = (self.unit_embed(units) + self.f0_embed(torch.log(1.0 + f0 / 700.0)[..., None])
             + self.volume_embed(volume[..., None]))
        if self.n_spk is not None and self.n_spk > 1 and spk_id is not None:
            if not spk_id.is_floating_point():
                x = x + self.spk_embed(spk_id)[:, None, :]
            elif spk_id.dim() == 2:  # static mix [B, S]
                x = x + (spk_id @ self.spk_embed.weight)[:, None, :]
            else:  # per-frame mix [B, T, S]
                x = x + torch.einsum("bts,sh->bth", spk_id, self.spk_embed.weight)
        if self.use_pitch_aug and aug_shift is not None:
            x = x + self.aug_shift_embed(aug_shift[..., None] / 5.0)[:, None, :]
        return x

    def forward(self, units, f0, volume, spk_id=None, aug_shift=None,
                gt_spec: torch.Tensor | None = None, infer: bool = True, infer_speedup: int = 10,
                method: str | None = "dpm-solver++", k_step: int = 300,
                generator: torch.Generator | None = None,
                batch_rows: tuple[int, int] | None = None) -> torch.Tensor:
        """Inference (``infer``): the mel [B, T, M], by shallow diffusion
        from ``gt_spec`` [B, T, M] at ``k_step``, or by full diffusion from
        noise when ``gt_spec`` is None. Training: the noise-prediction MSE at
        a random step below ``k_step_max``. Noise and steps come from
        ``generator`` (a CPU generator). ``batch_rows`` (first row, global
        batch size) marks a data-parallel rank's rows of a global batch: the
        steps and noise are drawn for the global batch and its rows kept,
        so the ranks together draw what one process would."""
        sched = self.schedule
        cond = self.condition(units, f0, volume, spk_id, aug_shift).transpose(1, 2)
        denoise_fn = self.decoder["denoise_fn"]
        if not infer:
            spec = sched.norm_spec(gt_spec.transpose(1, 2))
            b = spec.shape[0]
            first, total = batch_rows or (0, b)
            t = torch.randint(0, sched.k_step, (total,), generator=generator)[first : first + b]
            noise = gaussian.randn((total, *spec.shape[1:]), generator, spec.device)[first : first + b]
            return sched.p_losses(denoise_fn, spec, t.to(spec.device), cond, noise)
        if gt_spec is not None and k_step > sched.k_step:
            raise ValueError("shallow diffusion k_step exceeds the model's k_step_max "
                             f"({k_step} > {sched.k_step})")  # unit2mel.py:141-145
        if gt_spec is None and sched.k_step != self.timesteps:
            raise ValueError("a k_step_max-limited model can only run shallow diffusion")
        mel = sched.sample(denoise_fn, cond, self.out_dims,
                           None if gt_spec is None else gt_spec.transpose(1, 2), k_step,
                           infer_speedup, method, generator)
        return mel.transpose(1, 2)
