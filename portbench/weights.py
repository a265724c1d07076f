"""Seeded weights, made on the device in a few large draws.

The state dict's names and shapes come from the plain reference's modules
(so-vits-svc's and fairseq's checkpoint layouts, which the program loads
too), built on the meta device. Every float tensor is drawn from one
generator on the device:

- conv and linear weights (``weight``, a weight norm's ``weight_v``) and
  biases: uniform in +-sqrt(2 / fan_in) (variance 2 / (3 fan_in)), so that
  the units and the latent move the audio without saturating it (at
  +-sqrt(3 / fan_in) the transformer-flow model's audio sat at an RMS of
  0.87 and hardly moved with its units); a transposed conv's fan-in is
  in_channels * kernel / stride;
- a weight norm's gain ``weight_g``: the norm of ``weight_v``, so that the
  effective weight is the drawn one;
- embeddings N(0, 1); Shaw tables N(0, 1 / head size);
- norm layers' scales 1 and shifts 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn



def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed and a tag."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF] + list(tag.encode())
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def meta(build) -> nn.Module:
    """``build()`` on the meta device: names and shapes without storage."""
    with torch.device("meta"):
        return build()


def _owner(model: nn.Module, name: str) -> nn.Module:
    mod = model
    for part in name.split(".")[:-1]:
        mod = getattr(mod, part)
    return mod


def _rule(model: nn.Module, name: str, shape: tuple, sd_shapes: dict) -> tuple[str, float]:
    """(kind, scale) of one tensor: kind "uniform" (bound scale), "normal"
    (std scale), "norm_of" (the gain of a weight norm), "const" (value scale)."""
    leaf = name.rsplit(".", 1)[-1]
    owner = _owner(model, name)
    if leaf == "weight_g":
        return "norm_of", 0.0
    if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)) or leaf in ("gamma", "beta"):
        return "const", 1.0 if leaf in ("weight", "gamma") else 0.0
    if isinstance(owner, nn.Embedding):
        return "normal", 1.0
    if leaf in ("emb_rel_k", "emb_rel_v"):
        return "normal", shape[-1] ** -0.5
    prefix = name[: -len(leaf)]
    wname = prefix + ("weight_v" if prefix + "weight_v" in sd_shapes else "weight")
    wshape = sd_shapes[wname]
    fan_in = math.prod(wshape[1:])
    if getattr(owner, "transposed", False):
        fan_in = wshape[0] * wshape[2] / owner.stride
    return "uniform", math.sqrt(2.0 / fan_in)


@torch.no_grad()
def seeded_state_dict(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of ``model`` (a meta module) drawn from ``seed`` on ``device``."""
    sd_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    rules = {k: _rule(model, k, s, sd_shapes) for k, s in sd_shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict[str, torch.Tensor] = {}
    for kind, draw in (("uniform", lambda n: torch.rand(n, generator=gen, device=device) * 2 - 1),
                       ("normal", lambda n: torch.randn(n, generator=gen, device=device))):
        names = [k for k, r in rules.items() if r[0] == kind]
        flat = draw(sum(math.prod(sd_shapes[k]) for k in names))
        start = 0
        for k in names:
            n = math.prod(sd_shapes[k])
            out[k] = flat[start:start + n].view(sd_shapes[k]) * rules[k][1]
            start += n
    for k, (kind, scale) in rules.items():
        if kind == "const":
            out[k] = torch.full(sd_shapes[k], scale, device=device)
        elif kind == "norm_of":
            v = out[k[: -len("weight_g")] + "weight_v"]
            g_shape = sd_shapes[k]
            dims = tuple(i for i, s in enumerate(g_shape) if s == 1)
            out[k] = torch.linalg.vector_norm(v, dim=dims, keepdim=True)
    return {k: out[k] for k in sd_shapes}
