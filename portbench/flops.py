"""Model FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference on the meta device: the work the model needs,
whatever implements it (matrix products and convolutions; elementwise
work is not counted).

A request's count is fitted as a + b T + c T^2 in its length T from three
counted lengths, exact for what these models do (convolutions linear in T,
attention quadratic), so the window's many lengths cost three passes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import contentvec, nets
from portbench.reference import train as ref_train


def count(fn) -> float:
    with FlopCounterMode(display=False) as mode:
        fn()
    return float(mode.get_total_flops())


def _quadratic(fn, lengths) -> np.ndarray:
    ys = [count(lambda n=n: fn(n)) for n in lengths]
    return np.polyfit(np.asarray(lengths, np.float64), np.asarray(ys), 2)


def serving_flops(cfg: dict, chunk_samples: list[int]) -> float:
    """FLOPs of the speech encoder and the synthesizer over chunks of these
    lengths (samples at the model rate), unpadded."""
    d = cfg["data"]
    sr, hop = d["sampling_rate"], d["hop_length"]
    with torch.device("meta"):
        synth = nets.Synthesizer(cfg).eval()
        enc = contentvec.ContentVec(cfg["speech_encoder"]).eval()
    ssl = cfg["model"]["ssl_dim"]

    def synth_call(t):
        with torch.no_grad(), torch.device("meta"):
            synth.infer(torch.zeros(1, ssl, t), torch.full((1, t), 200.0), torch.ones(1, t),
                        torch.zeros(1, dtype=torch.long), torch.full((1,), t), 0.4, None,
                        vol=torch.zeros(1, t))

    def enc_call(n):
        with torch.no_grad(), torch.device("meta"):
            enc(torch.zeros(1, n))

    s_fit = _quadratic(synth_call, (256, 512, 1024))
    e_fit = _quadratic(enc_call, (32000, 80000, 160000))
    frames = np.asarray([n // hop for n in chunk_samples], np.float64)
    samples16 = np.asarray([int(np.ceil(n * 16000 / sr)) for n in chunk_samples], np.float64)
    return float(np.polyval(s_fit, frames).sum() + np.polyval(e_fit, samples16).sum())


def training_flops(cfg: dict, batch: int, frames: int) -> float:
    """FLOPs of one GAN step (G forward and backward, D forward and backward
    on the D step and through the G step) at ``batch`` rows of ``frames``."""
    d = cfg["data"]
    hop, n_fft = d["hop_length"], d["filter_length"]
    with torch.device("meta"):
        g = nets.Synthesizer(cfg).train()
        disc = ref_train.Discriminator()
        for p in list(g.parameters()) + list(disc.parameters()):
            p.requires_grad_(True)
    ssl = cfg["model"]["ssl_dim"]

    def step():
        with torch.device("meta"):
            o, ids, x_mask, (z, z_p, m_p, logs_p, m_q, logs_q), pred, lf0 = g(
                torch.zeros(batch, ssl, frames), torch.full((batch, frames), 200.0),
                torch.ones(batch, frames), torch.zeros(batch, n_fft // 2 + 1, frames),
                torch.zeros(batch, dtype=torch.long), torch.full((batch,), frames),
                torch.zeros(batch, frames), None)
            y = torch.zeros_like(o)
            real, fake, _, _ = disc(y, o.detach())
            ref_train.d_loss(real, fake).backward()
            _, fake, fr, fg = disc(y, o)
            loss = ref_train.g_loss(fake) + ref_train.fm_loss(fr, fg) + (z_p - m_p).pow(2).mean() \
                + (pred - lf0).pow(2).mean() + o.abs().mean()
            loss.backward()

    return count(step)
