"""AdamW and the learning-rate schedule (counterpart of the optimizer in
``sovits_tpu/train/step.py`` and ``trainer.py::epoch_lr``).

so-vits-svc trains both nets with ``torch.optim.AdamW(lr, betas, eps)`` and
torch's default weight decay 0.01; the JAX package matches it with
``optax.adamw(weight_decay=0.01)``: the same update, decoupled decay on
every parameter. Its ``packed_adamw`` exists to cut the TPU's per-leaf
launch floor and is not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def make_optimizer(params, hps) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=hps.train.learning_rate, betas=tuple(hps.train.betas),
                             eps=hps.train.eps, weight_decay=0.01)


def epoch_lr(hps, epoch: int) -> float:
    """Warm-up, then per-epoch exponential decay (epochs count from 1)."""
    base = hps.train.learning_rate
    warmup = hps.train.warmup_epochs or 0
    if warmup and epoch <= warmup:
        return base / warmup * epoch
    return base * (hps.train.lr_decay ** max(epoch - 1, 0))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def global_norm(params) -> torch.Tensor:
    """L2 norm of all gradients (so-vits-svc's clip_grad_value_ with no
    clipping only measures it). Gradients sharded by FSDP (DTensors) count
    whole: their shards' squared sums are summed over the mesh dims they
    are sharded on."""
    from torch.distributed.tensor import DTensor

    grads = [p.grad for p in params if p.grad is not None]
    plain = [g for g in grads if not isinstance(g, DTensor)]
    sharded = [g for g in grads if isinstance(g, DTensor)]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in plain])) \
        if plain else None
    if not sharded:
        return norm
    squares: dict = {}
    for g in sharded:
        dims = tuple(i for i, p in enumerate(g.placements) if p.is_shard())
        key = (id(g.device_mesh), dims)
        local = g.to_local().float().pow(2).sum()
        squares[key] = (g.device_mesh, dims, squares[key][2] + local if key in squares else local)
    total = torch.zeros((), device=sharded[0].to_local().device)
    for mesh, dims, sq in squares.values():
        for dim in dims:
            dist.all_reduce(sq, group=mesh.get_group(dim))
        total = total + sq
    if norm is not None:
        total = total + norm.float() ** 2
    return torch.sqrt(total)
