"""Build the synthesizer from a so-vits-svc config (counterpart of
``sovits_tpu/models/factory.py``), and seeded random weights for runs
without a trained checkpoint."""

from __future__ import annotations

import torch
from torch import nn

from sovits_tpu import config as scfg

from ..nn.attention import MultiHeadAttention
from ..nn.conv import WeightNormed, WNConvTranspose1d
from ..nn.norm import LayerNorm
from ..nn.resblocks import ResBlock1
from .synthesizer import Synthesizer

# config options this port does not implement, with the value it runs
_UNSUPPORTED = {
    "vol_embedding": False,
    "use_transformer_flow": False,
    "use_depthwise_conv": False,
    "flow_share_parameter": False,
    "resblock": "1",
    "vocoder_name": "nsf-hifigan",
}
# Synthesizer kwargs of the JAX package that inference here does not use
_TRAINING_ONLY = ("segment_size", "p_dropout", "n_layers_trans_flow")


def synthesizer_kwargs(hps) -> dict:
    """Config -> Synthesizer kwargs (the JAX package's mapping); raises
    NotImplementedError naming any option outside what the port runs."""
    kw = scfg.synthesizer_kwargs(hps)
    for name, value in _UNSUPPORTED.items():
        got = kw.pop(name)
        if type(value)(got) != value:
            raise NotImplementedError(f"model.{name}={got!r} is not supported by the port")
    for name in _TRAINING_ONLY:
        kw.pop(name)
    return kw


def build_synthesizer(hps, device: torch.device | str) -> Synthesizer:
    """The inference synthesizer for ``hps``, in eval mode on ``device``."""
    return Synthesizer(**synthesizer_kwargs(hps)).to(device).eval()


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter from ``generator`` (a CPU generator), with
    the distributions the reference initialises with: torch's uniform
    +-1/sqrt(fan_in) for convs and linears, N(0, 0.01) for the vocoder's
    upsampling and resblock convs, N(0, 1) embeddings, N(0, d^-1/2) Shaw
    tables, unit LayerNorms. Weight norm starts at g = ||v||."""

    def fill(p: torch.Tensor, sample: torch.Tensor) -> None:
        p.copy_(sample.to(p.dtype))

    def uniform(p, bound):
        fill(p, (torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def normal(p, std):
        fill(p, torch.randn(p.shape, generator=generator) * std)

    small = set()
    for mod in model.modules():
        if isinstance(mod, ResBlock1):
            small.update(id(c) for c in mod.modules())
    for mod in model.modules():
        if isinstance(mod, WeightNormed):
            fan_in = mod.weight_v.shape[1] * mod.weight_v.shape[2]
            if isinstance(mod, WNConvTranspose1d) or id(mod) in small:
                normal(mod.weight_v, 0.01)
            else:
                uniform(mod.weight_v, fan_in**-0.5)
            mod.weight_g.copy_(mod._norm(mod.weight_v))
            if mod.bias is not None:
                uniform(mod.bias, fan_in**-0.5)
            mod.fold_weight_norm()
        elif isinstance(mod, (nn.Conv1d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            uniform(mod.weight, fan_in**-0.5)
            if mod.bias is not None:
                uniform(mod.bias, fan_in**-0.5)
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 1.0)
        elif isinstance(mod, (LayerNorm, nn.LayerNorm, nn.GroupNorm)):
            for name, p in mod.named_parameters():
                fill(p, torch.ones_like(p) if name in ("gamma", "weight") else torch.zeros_like(p))
        elif isinstance(mod, MultiHeadAttention) and mod.window_size is not None:
            normal(mod.emb_rel_k, mod.k_channels**-0.5)
            normal(mod.emb_rel_v, mod.k_channels**-0.5)
    return model
