"""Time-sharded NSF-HiFiGAN decode (counterpart of
``sovits_tpu/parallel/sequence.py``).

The vocoder is a pure conv pipeline, so a time shard of a song needs only
a halo of its neighbours' frames, the decoder's receptive field, to
reproduce the monolithic decode. Each of ``n`` ranks holds ``T_f / n``
frames of the latent and f0:

- halo exchange: a rank sends its edge frames to its left and right
  neighbours by ``batch_isend_irecv``; a shard at the song's edge gets
  zeros there (as ``ppermute`` gives the JAX package);
- sine-phase continuity: the NSF source's phase is an exclusive sum over
  frames, so the ranks ``all_gather_into_tensor`` their per-shard phase
  sums [B, 9] and each starts its oscillator at the exclusive prefix,
  rewound over its left halo;
- each rank decodes its haloed chunk (:func:`decode_local`) and keeps its
  central ``T_local * upp`` samples.

With the noise on, the source's draws are counter-based per absolute
frame (``SourceModuleHnNSF``'s ``noise_frames``), so the sharded decode
equals the monolithic decode with the same seed. Within the halo of the
song's two edges the outer shards see zero frames and an f0 of 0 where the
monolithic decode sees its convs' zero padding: there, and only there, the
two may differ (the JAX package's edge-zone contract).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.nsf_hifigan import frame_advance

HARMONICS = 9


def _frame_adv(f0: torch.Tensor, sample_rate: int, upp: int, h: int = HARMONICS) -> torch.Tensor:
    """Per-frame phase advance (turns) per harmonic: f0 [B, T_f] -> [B, H, T_f]."""
    harmonics = torch.arange(1, h + 1, dtype=torch.float32, device=f0.device)
    rad = (f0.float()[:, None, :] * harmonics[None, :, None] / sample_rate) % 1.0
    return frame_advance(rad, upp)


def phase_sum(f0: torch.Tensor, sample_rate: int, upp: int) -> torch.Tensor:
    """The phase (turns, float64) that frames ``f0`` [B, T_f] advance: [B, H]."""
    return _frame_adv(f0, sample_rate, upp).double().sum(-1)


def required_halo_frames(generator) -> int:
    """One-sided receptive field of the decode, in input frames, by the JAX
    package's formula: conv_pre, then per stage the transposed upsample,
    the noise conv and the longest resblock chain, then conv_post, each at
    its stage's rate and brought back to the frame rate."""
    reach = 3.0  # conv_pre: k=7, symmetric padding, at frame rate
    c = 1.0  # cumulative upsample factor at the current stage's input
    rates = list(generator.upsample_rates)
    full = float(np.prod(rates))
    rb = max(sum((rk - 1) // 2 * (d + 1) for d in dil)
             for rk, dil in zip(generator.kernel_sizes, generator.dilation_sizes))
    for i, (u, k) in enumerate(zip(rates, generator.upsample_kernel_sizes)):
        reach += float(-(-((k - u) // 2) // u)) / c
        c *= u
        if i + 1 < len(rates):
            reach += float(np.prod(rates[i + 1:])) / full  # noise conv over the full-rate source
        reach += rb / c
    reach += 3.0 / full  # conv_post: k=7 at sample rate
    return int(np.ceil(reach))


def decode_local(generator, x_ext: torch.Tensor, f0_ext: torch.Tensor, g: torch.Tensor | None,
                 phase0: torch.Tensor, halo: int, frame_offset: int, total_frames: int,
                 noise: torch.Generator | None = None) -> torch.Tensor:
    """One shard's decode: its chunk with ``halo`` frames on each side,
    x_ext [B, C, T_local + 2 halo], f0_ext [B, T_local + 2 halo], the phase
    [B, 9] (turns) accumulated before its first central frame, and that
    frame's absolute index ``frame_offset``. Returns the central
    ``T_local * upp`` samples [B, 1, T_local * upp]. ``noise`` (a seeded
    generator) turns the source's noise on, drawn per absolute frame."""
    upp = generator.upp
    t_local = x_ext.shape[-1] - 2 * halo
    phase0_ext = phase0.double() - phase_sum(f0_ext[:, :halo], generator.sampling_rate, upp)
    wav = generator(x_ext, f0_ext, g, generator=noise, phase0=phase0_ext,
                    noise_frames=(frame_offset - halo, total_frames) if noise is not None else None)
    return wav[:, :, halo * upp : (halo + t_local) * upp]


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: [n, *t.shape]. Gathered
    into one tensor along dim 0, the layout both NCCL and gloo take."""
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.view(n, *t.shape)


def _check_backend(group, x: torch.Tensor) -> None:
    backend = dist.get_backend(group)
    want = "nccl" if x.is_cuda else "gloo"
    if backend != want:
        raise RuntimeError(f"sharded_decode: {x.device.type} tensors need a {want} group, "
                           f"not {backend}")


def _exchange_halos(t: torch.Tensor, halo: int, group, rank: int, n: int) -> tuple:
    """(left halo, right halo) of ``t`` [..., T_local]: the left neighbour's
    last ``halo`` frames and the right neighbour's first, zeros at the
    song's edges."""
    left = torch.zeros(*t.shape[:-1], halo, dtype=t.dtype, device=t.device)
    right = torch.zeros_like(left)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, t[..., :halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, left, peer, group)]
    if rank + 1 < n:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, t[..., -halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, right, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return left, right


def sharded_decode(generator, x: torch.Tensor, f0: torch.Tensor, g: torch.Tensor | None,
                   group=None, halo: int | None = None, seed: int | None = None) -> torch.Tensor:
    """Time-sharded decode of this rank's frames: x [B, C, T_local], f0
    [B, T_local], g [B, gin, 1] (the same on every rank). Returns this
    rank's samples [B, 1, T_local * upp]; concatenated in rank order they
    are the song. ``group`` is the process group over the song's shards
    (the default group when None; with no process group at all the world
    is this one rank); NCCL for CUDA tensors, gloo for CPU tensors.
    ``seed`` turns the source's noise on (counter-based, the same draws as
    a monolithic decode seeded alike); None decodes deterministically."""
    needed = required_halo_frames(generator)
    halo = needed if halo is None else halo
    assert halo >= needed, (f"halo={halo} frames does not cover the generator's receptive "
                            f"field ({needed} frames): shard seams would be wrong")
    distributed = dist.is_initialized()
    if distributed:
        group = group or dist.group.WORLD
        _check_backend(group, x)
        n, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        n, rank = 1, 0
    t_local = x.shape[-1]
    assert t_local >= halo, f"each shard's {t_local} frames must hold the {halo}-frame halo"
    upp, sr = generator.upp, generator.sampling_rate

    local_sum = phase_sum(f0, sr, upp)  # [B, H]
    sums = local_sum[None]
    if distributed:
        sums = _all_gather(local_sum, group, n)
    phase0 = sums[:rank].sum(0) if rank else torch.zeros_like(local_sum)

    if distributed:
        x_l, x_r = _exchange_halos(x, halo, group, rank, n)
        f0_l, f0_r = _exchange_halos(f0, halo, group, rank, n)
    else:
        x_l = x_r = torch.zeros(*x.shape[:-1], halo, dtype=x.dtype, device=x.device)
        f0_l = f0_r = torch.zeros(*f0.shape[:-1], halo, dtype=f0.dtype, device=f0.device)
    x_ext = torch.cat([x_l, x, x_r], dim=-1)
    f0_ext = torch.cat([f0_l, f0, f0_r], dim=-1)
    noise = None
    if seed is not None:
        noise = torch.Generator(device=x.device).manual_seed(seed)
    return decode_local(generator, x_ext, f0_ext, g, phase0, halo, rank * t_local, n * t_local,
                        noise)


def gather_time(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's samples [B, 1, S] joined along time on every rank."""
    if not dist.is_initialized():
        return local
    group = group or dist.group.WORLD
    return torch.cat(list(_all_gather(local, group, dist.get_world_size(group))), dim=-1)
