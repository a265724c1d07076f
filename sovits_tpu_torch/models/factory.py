"""Build the synthesizer and discriminator from a so-vits-svc config
(counterpart of ``sovits_tpu/models/factory.py``), and seeded random
weights for runs without a trained checkpoint."""

from __future__ import annotations

import torch
from torch import nn

from .. import config as scfg

from ..nn.attention import MultiHeadAttention
from ..nn.conv import WeightNormed, WNConvTranspose1d, set_compute_dtype
from ..nn.norm import LayerNorm
from ..nn.resblocks import ResBlock1, ResBlock2
from ..nn.snake import SnakeBeta
from .discriminator import MultiPeriodDiscriminator
from .nsf_hifigan import Generator
from .synthesizer import Synthesizer


def build_synthesizer(hps, device: torch.device | str, *, fused_tail: bool,
                      dtype: torch.dtype = torch.float32) -> Synthesizer:
    """The synthesizer for ``hps`` on ``device``, computing in ``dtype``
    (parameters stay float32), with every model option of the config. Each
    caller decides the vocoder tail: ``Svc`` keeps the fused one
    (``fused_tail=True``; only a resblock-"1" generator with plain convs has
    one), the trainer the plain convs (``False``), as the JAX trainer does."""
    model = Synthesizer(**scfg.synthesizer_kwargs(hps), fused_tail=fused_tail, dtype=dtype)
    return model.to(device).eval()


def build_decoder(hps, device: torch.device | str, *, fused_tail: bool = True,
                  dtype: torch.dtype = torch.float32) -> Generator:
    """The synthesizer's vocoder alone: the same class and keywords as
    ``Synthesizer.dec`` (the Snake generator for "nsf-snake-hifigan"), so a
    synthesizer's ``dec.*`` state dict loads into it strictly. Serving keeps
    the fused tail, so K3 runs in a time-sharded decode too."""
    kw = scfg.synthesizer_kwargs(hps)
    snake = kw["vocoder_name"] == "nsf-snake-hifigan"
    dec = Generator(kw["sampling_rate"], kw["inter_channels"], kw["resblock_kernel_sizes"],
                    kw["resblock_dilation_sizes"], kw["upsample_rates"],
                    kw["upsample_initial_channel"], kw["upsample_kernel_sizes"], kw["gin_channels"],
                    fused_tail=fused_tail, resblock=kw["resblock"],
                    separable=kw["use_depthwise_conv"] and not snake, snake=snake)
    set_compute_dtype(dec, dtype)
    return dec.to(device).eval()


def build_discriminator(hps, device: torch.device | str,
                        dtype: torch.dtype = torch.float32) -> MultiPeriodDiscriminator:
    """so-vits-svc's MultiPeriodDiscriminator, computing in ``dtype``
    (parameters stay float32). ``model.disc_tiny`` is the JAX package's
    small-test knob (not a reference option): periods (2, 3) and narrow
    towers."""
    kw = {}
    if hps.model.get("disc_tiny"):
        kw = dict(periods=(2, 3), p_channels=(8, 16, 32, 64),
                  s_specs=((8, 15, 1, 1, 7), (16, 41, 4, 4, 20), (32, 41, 4, 4, 20),
                           (64, 5, 1, 1, 2)))
    return MultiPeriodDiscriminator(bool(hps.model.use_spectral_norm), dtype=dtype, **kw).to(device)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter from ``generator`` (a CPU generator), with
    the distributions the reference initialises with: torch's uniform
    +-1/sqrt(fan_in) for convs and linears (a separable conv's depthwise
    part included), N(0, 0.01) for the vocoder's upsampling and resblock
    convs, N(0, 1) embeddings, N(0, d^-1/2) Shaw tables, unit LayerNorms.
    Weight norm starts at g = ||v||. The F0 decoder's causal attention
    starts with conv_k equal to conv_q (so-vits-svc's proximal_init).
    What the reference starts at zero is drawn too, so that a random model
    runs every path: the flows' ``post`` convs take the uniform draw, and
    Snake's log-scale alpha and beta N(0, 0.1). The f0 nets' parts: GRUs
    and transposed convs take torch's uniform draw, BatchNorm scale
    N(1, 0.1), shift and running mean N(0, 0.1), running variance U(0.5,
    1.5), FCPE's performer projections N(0, 1)."""

    def fill(p: torch.Tensor, sample: torch.Tensor) -> None:
        p.copy_(sample.to(p.dtype))

    def uniform(p, bound):
        fill(p, (torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def normal(p, std):
        fill(p, torch.randn(p.shape, generator=generator) * std)

    small = set()
    for mod in model.modules():
        if isinstance(mod, (ResBlock1, ResBlock2)):
            small.update(id(c) for c in mod.modules() if getattr(c, "groups", 1) == 1)
    for mod in model.modules():
        if isinstance(mod, WeightNormed):
            fan_in = mod.weight_v[0].numel()
            if isinstance(mod, WNConvTranspose1d) or id(mod) in small:
                normal(mod.weight_v, 0.01)
            else:
                uniform(mod.weight_v, fan_in**-0.5)
            mod.weight_g.copy_(mod._norm(mod.weight_v))
            if mod.bias is not None:
                uniform(mod.bias, fan_in**-0.5)
            mod.fold_weight_norm()
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            weight = getattr(mod, "weight_orig", mod.weight)  # spectral norm's raw weight
            fan_in = weight[0].numel()
            uniform(weight, fan_in**-0.5)
            if mod.bias is not None:
                uniform(mod.bias, fan_in**-0.5)
        elif isinstance(mod, nn.ConvTranspose2d):  # weight (in, out, kh, kw): fan-in out x kh x kw
            uniform(mod.weight, mod.weight[0].numel() ** -0.5)
        elif isinstance(mod, nn.GRU):
            for p in mod.parameters():
                uniform(p, mod.hidden_size**-0.5)
        elif isinstance(mod, nn.BatchNorm2d):
            normal(mod.weight, 0.1)
            mod.weight += 1.0
            normal(mod.bias, 0.1)
            normal(mod.running_mean, 0.1)
            fill(mod.running_var, 0.5 + torch.rand(mod.running_var.shape, generator=generator))
        elif hasattr(mod, "projection_matrix"):
            normal(mod.projection_matrix, 1.0)
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 1.0)
        elif isinstance(mod, (LayerNorm, nn.LayerNorm, nn.GroupNorm)):
            for name, p in mod.named_parameters():
                fill(p, torch.ones_like(p) if name in ("gamma", "weight") else torch.zeros_like(p))
        elif isinstance(mod, MultiHeadAttention) and mod.window_size is not None:
            normal(mod.emb_rel_k, mod.k_channels**-0.5)
            normal(mod.emb_rel_v, mod.k_channels**-0.5)
        elif isinstance(mod, SnakeBeta):
            normal(mod.alpha, 0.1)
            normal(mod.beta, 0.1)
    if getattr(model, "f0_decoder", None) is not None:
        for attn in model.f0_decoder.decoder.self_attn_layers:
            attn.conv_k.load_state_dict(attn.conv_q.state_dict())
    return model
