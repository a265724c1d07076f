"""Diffusion ONNX export: the four MoeSS artifacts of the port's Unit2Mel
(counterpart of ``sovits_tpu/export/onnx_diffusion.py``; so-vits-svc
diffusion/onnx_export.py:135-235, diffusion/diffusion_onnx.py:482-570):

- ``{name}_encoder.onnx``  (hubert, mel2ph, f0, volume, spk_mix) -> the
  Unit2Mel condition track ``mel_pred`` [1, n_hidden, T]
- ``{name}_denoise.onnx``  (noise [1,1,M,T], time int64 [1],
  condition [1,H,T]) -> ``noise_pred`` (the WaveNet denoiser)
- ``{name}_pred.onnx``     (noise, noise_pred, time, time_prev) ->
  ``noise_pred_o`` (the PLMS x-prediction arithmetic with the
  alphas_cumprod table baked in, diffusion_onnx.py:473-480)
- ``{name}_after.onnx``    x [1,1,M,T] -> ``mel_out`` [1,M,T]
  (denormalize, diffusion_onnx.py:170-183)

MoeSS drives the PLMS loop runtime-side (the predict_stage0-3 arithmetic
on the noise history); the tests replay that loop through these graphs
against the port's ``DiffusionSchedule.sample_plms``. The builders read
the module's parameters in their torch layouts (Linear [out, in], Conv1d
[Co, Ci, k], ONNX's own).
"""

from __future__ import annotations

import numpy as np
from torch import nn

from . import onnx_proto as P
from .onnx_graph import GraphBuilder
from .onnx_synth import _np


def _dense(g: GraphBuilder, x, lin: nn.Linear, hint):
    """Linear as MatMul + Add."""
    y = g.matmul(x, g.init(np.ascontiguousarray(_np(lin.weight).T), hint + "_w"))
    return g.add(y, g.init(_np(lin.bias), hint + "_b"))


def _conv(g: GraphBuilder, x, conv: nn.Conv1d, hint):
    return g.conv1d(x, _np(conv.weight), _np(conv.bias), pads=(conv.padding[0], conv.padding[0]),
                    hint=hint)


def build_encoder_onnx(model) -> bytes:
    """The Unit2Mel condition track (onnx_export.py:84-107 contract).

    Inputs (batch 1): hubert [1, Tu, C], mel2ph [1, T] int64 (1-based; 0
    hits the zero pad frame), f0 [1, T], volume [1, T], and, when n_spk > 1,
    a per-frame ``spk_mix`` [T, n_spk] (CharaMix). Output ``mel_pred``
    [1, n_hidden, T].
    """
    g = GraphBuilder("sovits_tpu_torch_diffusion_encoder")
    n_spk = model.n_spk or 1
    n_hidden = model.unit_embed.out_features
    hubert = g.input("hubert", [1, "Tu", model.unit_embed.in_features])
    mel2ph = g.input("mel2ph", [1, "T"], P.DT_INT64)
    f0 = g.input("f0", [1, "T"])
    volume = g.input("volume", [1, "T"])

    # units[mel2ph]: one zero frame padded at the front, gathered along time
    upad = g.pad(hubert, [0, 1, 0, 0, 0, 0])  # [1, Tu+1, C]
    units = g.gather(upad, g.squeeze(mel2ph, [0]), axis=1)  # [1, T, C]

    x = _dense(g, units, model.unit_embed, "unit_embed")
    lf0 = g.n("Log", [g.add(g.const_f32([1.0]), g.div(g.unsqueeze(f0, [2]), g.const_f32([700.0])))])
    x = g.add(x, _dense(g, lf0, model.f0_embed, "f0_embed"))
    x = g.add(x, _dense(g, g.unsqueeze(volume, [2]), model.volume_embed, "volume_embed"))
    if n_spk > 1:
        spk_mix = g.input("spk_mix", ["T", n_spk])
        mix = g.matmul(spk_mix, g.init(_np(model.spk_embed.weight), "spk_table"))  # [T, H]
        x = g.add(x, g.unsqueeze(mix, [0]))
    g.output("mel_pred", [1, n_hidden, "T"])
    g.n_named("Identity", [g.transpose(x, [0, 2, 1])], ["mel_pred"])
    return g.model_bytes()


def build_denoise_onnx(model) -> bytes:
    """The DiffusionWaveNet as the MoeSS ``denoise`` graph
    (diffusion_onnx.py:129-176 topology)."""
    g = GraphBuilder("sovits_tpu_torch_diffusion_denoise")
    dn = model.decoder["denoise_fn"]
    c = dn.n_chans
    out_dims = model.out_dims
    n_hidden = model.unit_embed.out_features
    noise = g.input("noise", [1, 1, out_dims, "T"])
    time = g.input("time", [1], P.DT_INT64)
    cond = g.input("condition", [1, n_hidden, "T"])

    x = g.relu(_conv(g, g.squeeze(noise, [1]), dn.input_projection, "in_proj"))

    # the sinusoidal step embedding (wavenet.py:16-28)
    half = c // 2
    freqs = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1))).astype(np.float32)
    ang = g.mul(g.cast(g.unsqueeze(time, [1]), P.DT_FLOAT), g.init(freqs[None, :], "freqs"))
    emb = g.concat([g.n("Sin", [ang]), g.n("Cos", [ang])], axis=1)  # [1, c]
    emb = _dense(g, emb, dn.mlp[0], "mlp1")
    emb = g.mul(emb, g.tanh(g.n("Softplus", [emb])))  # mish
    emb = _dense(g, emb, dn.mlp[2], "mlp2")  # [1, c]

    skips = None
    for i, layer in enumerate(dn.residual_layers):
        step = _dense(g, emb, layer.diffusion_projection, f"l{i}_step")
        y = _conv(g, g.add(x, g.unsqueeze(step, [2])), layer.dilated_conv, f"l{i}_dil")
        y = g.add(y, _conv(g, cond, layer.conditioner_projection, f"l{i}_cond"))
        gate, filt = g.split(y, axis=1, sizes=[c, c])
        y = _conv(g, g.mul(g.sigmoid(gate), g.tanh(filt)), layer.output_projection, f"l{i}_out")
        residual, skip = g.split(y, axis=1, sizes=[c, c])
        x = g.div(g.add(x, residual), g.const_f32([np.sqrt(2.0)]))
        skips = skip if skips is None else g.add(skips, skip)

    x = g.div(skips, g.const_f32([np.sqrt(float(len(dn.residual_layers)))]))
    x = g.relu(_conv(g, x, dn.skip_projection, "skip_proj"))
    x = _conv(g, x, dn.output_projection, "out_proj")
    g.output("noise_pred", [1, 1, out_dims, "T"])
    g.n_named("Identity", [g.unsqueeze(x, [1])], ["noise_pred"])
    return g.model_bytes()


def build_pred_onnx(model) -> bytes:
    """The PLMS x-prediction arithmetic (diffusion_onnx.py:473-480
    get_x_pred) with the schedule's alphas_cumprod baked in."""
    sched = model.schedule
    g = GraphBuilder("sovits_tpu_torch_diffusion_pred")
    x1 = g.input("noise", [1, 1, model.out_dims, "T"])
    noise_t = g.input("noise_pred", [1, 1, model.out_dims, "T"])
    t1 = g.input("time", [1], P.DT_INT64)
    t_prev = g.input("time_prev", [1], P.DT_INT64)

    ac = g.init(np.asarray(sched.alphas_cumprod, np.float32), "alphas_cumprod")
    a_t = g.reshape(g.gather(ac, t1), shape_vals=[1, 1, 1, 1])
    a_prev = g.reshape(g.gather(ac, t_prev), shape_vals=[1, 1, 1, 1])
    a_t_sq = g.n("Sqrt", [a_t])
    a_prev_sq = g.n("Sqrt", [a_prev])
    one = g.const_f32([1.0])
    term_x = g.div(one, g.mul(a_t_sq, g.add(a_t_sq, a_prev_sq)))
    denom = g.mul(a_t_sq, g.add(g.n("Sqrt", [g.mul(g.sub(one, a_prev), a_t)]),
                                g.n("Sqrt", [g.mul(g.sub(one, a_t), a_prev)])))
    inner = g.sub(g.mul(term_x, x1), g.mul(g.div(one, denom), noise_t))
    out = g.add(x1, g.mul(g.sub(a_prev, a_t), inner))
    g.output("noise_pred_o", [1, 1, model.out_dims, "T"])
    g.n_named("Identity", [out], ["noise_pred_o"])
    return g.model_bytes()


def build_after_onnx(model) -> bytes:
    """The denormalization tail (diffusion_onnx.py:170-183 AfterDiffusion)."""
    sched = model.schedule
    g = GraphBuilder("sovits_tpu_torch_diffusion_after")
    y = g.squeeze(g.input("x", [1, 1, model.out_dims, "T"]), [1])  # [1, M, T]
    span = float(sched.spec_max - sched.spec_min)
    y = g.add(g.mul(g.div(g.add(y, g.const_f32([1.0])), g.const_f32([2.0])), g.const_f32([span])),
              g.const_f32([float(sched.spec_min)]))
    g.output("mel_out", [1, model.out_dims, "T"])
    g.n_named("Identity", [y], ["mel_out"])
    return g.model_bytes()


def build_diffusion_onnx(model) -> dict[str, bytes]:
    """All four MoeSS diffusion artifacts of a Unit2Mel, keyed by suffix."""
    return {
        "encoder": build_encoder_onnx(model),
        "denoise": build_denoise_onnx(model),
        "pred": build_pred_onnx(model),
        "after": build_after_onnx(model),
    }
