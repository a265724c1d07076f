"""Dropout from an explicit generator (the JAX package's ``nn.Dropout``
with a ``dropout`` rng): with no generator it is the identity, which is how
inference and the deterministic training forward run.

Both forms compute what the JAX package computes in the input's type. JAX
rounds the Python scalar ``1 - p`` to the array's type before it divides
(weak typing), so the divisor here is ``1 - p`` in that type: 0.8984375 in
bf16 for p = 0.1, not 0.9, and a kept bf16 value is ``x / 0.8984375``
rounded once.
"""

from __future__ import annotations

import torch


def _keep_prob(p: float, dtype: torch.dtype, device) -> torch.Tensor:
    """``1 - p`` rounded to ``dtype``, as a 0-d tensor on ``device`` (a CPU
    Python scalar would let CUDA's division multiply by its reciprocal)."""
    return torch.tensor(1.0 - p, dtype=dtype, device=device)


def keep_mask(shape, p: float, generator: torch.Generator, device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The attention's keep/(1-p) mask, float32: 0, or 1/(1-p) with
    probability 1-p. Its values are the JAX package's in ``dtype`` (q's
    type): ``keep.astype(dtype) / (1 - p)``, so 1.109375 in bf16 at p = 0.1
    and float32's 1/0.9 in float32. Storage stays float32 for every type,
    which is what the attention kernels take."""
    keep = torch.rand(shape, generator=generator, device=device) >= p
    return (keep.to(dtype) / _keep_prob(p, dtype, device)).float()


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``select(keep, x / (1 - p), 0)`` in x's type."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / _keep_prob(p, x.dtype, x.device), 0.0)
