"""The port's Synthesizer -> ONNX with the reference's MoeSS io contract
(counterpart of ``sovits_tpu/export/onnx_synth.py``; so-vits-svc
onnxexport/model_onnx_speaker_mix.py:334-365 + onnx_export.py:24-110):

inputs  c [1, T, ssl], f0 [1, T], mel2ph [1, T], uv [1, T],
        noise [1, inter, T], sid ([1] int64, or [T, S] f32 with CharaMix),
        vol [1, T] (only when vol_embedding)
output  audio [1, 1, T*hop]

Semantics follow the reference's export-time model, not the training model:
c is gathered by mel2ph over a front-padded frame axis, the prior is
z_p = m_p + noise * exp(logs_p) with the CALLER-provided noise (the
noise_scale lives in the consumer), x_mask is all ones (dropped: every mask
multiply is the identity), and predict_f0 is False (MoeSS drives f0).

The builder reads the port's modules directly: their parameters carry
so-vits-svc's channels-first layouts, which are ONNX's (Conv [Co, Ci/g, k],
ConvTranspose [Ci, Co, k]); weight norm is folded to g * v / ||v|| in
float32. 1x1 convs on the [1, T, C] attention stream become MatMuls. Batch
is fixed at 1 (MoeSS calls it that way); the frame axis is dynamic.
Exported: the nsf-hifigan vocoder with resblock "1" and plain convs; the
Snake vocoder, resblock "2" and depthwise convs raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.attention import FFT
from ..nn.conv import WeightNormed
from ..nn.resblocks import ResBlock1
from . import onnx_proto as P
from .onnx_graph import GraphBuilder

F0_BIN = 256
F0_MEL_MIN = 1127.0 * np.log(1.0 + 50.0 / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1.0 + 1100.0 / 700.0)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def _weight(conv: nn.Module) -> np.ndarray:
    """A conv's kernel in its torch layout, weight norm folded in float32."""
    if isinstance(conv, WeightNormed):
        with torch.no_grad():
            g, v = conv.weight_g.float(), conv.weight_v.float()
            return _np(g * v / conv._norm(v))
    return _np(conv.weight)


def _bias(mod: nn.Module) -> np.ndarray | None:
    return None if mod.bias is None else _np(mod.bias)


# ---------------------------------------------------------------------------
# module builders (g: GraphBuilder; x names are value names in the graph)
# ---------------------------------------------------------------------------


def _conv(g: GraphBuilder, x_ncw: str, conv: nn.Module, pads, stride=1, dilation=1,
          group=1, hint="conv") -> str:
    return g.conv1d(x_ncw, _weight(conv), _bias(conv), pads=pads, stride=stride,
                    dilation=dilation, group=group, hint=hint)


def _dense(g: GraphBuilder, x_ntc: str, conv: nn.Module) -> str:
    """A 1x1 conv on [1, T, C] as MatMul (+ Add)."""
    y = g.matmul(x_ntc, g.init(np.ascontiguousarray(_weight(conv)[:, :, 0].T), "dw"))
    if conv.bias is not None:
        y = g.add(y, g.init(_bias(conv), "db"))
    return y


def _layer_norm(g: GraphBuilder, x_ntc: str, norm: nn.Module) -> str:
    # opset 16 ReduceMean takes axes as an attribute (moved to input in 18)
    m = g.n("ReduceMean", [x_ntc], axes=[-1], keepdims=1)
    d = g.sub(x_ntc, m)
    var = g.n("ReduceMean", [g.mul(d, d)], axes=[-1], keepdims=1)
    y = g.div(d, g.n("Sqrt", [g.add(var, g.const_f32(norm.eps, "eps"))]))
    y = g.mul(y, g.init(_np(norm.gamma), "ln_g"))
    return g.add(y, g.init(_np(norm.beta), "ln_b"))


def _rel_emb_matrix(g: GraphBuilder, t_range: str, emb: np.ndarray, window: int) -> str:
    """[T, T, d] matrix E[i, j] = emb[j - i + w] masked to |j - i| <= w."""
    row = g.unsqueeze(t_range, [1])  # [T, 1]
    col = g.unsqueeze(t_range, [0])  # [1, T]
    diff = g.sub(col, row)  # [T, T] int64
    idx = g.add(
        g.n("Clip", [diff, g.const_i64(-window, "lo"), g.const_i64(window, "hi")]),
        g.const_i64(window, "w"),
    )
    gathered = g.gather(g.init(emb, "rel"), idx, axis=0)
    in_band = g.n("Less", [g.n("Abs", [diff]), g.const_i64(window + 1, "w1")])
    mask = g.unsqueeze(g.cast(in_band, P.DT_FLOAT), [2])  # [T, T, 1]
    return g.mul(gathered, mask)


def _attention(g: GraphBuilder, x: str, attn: nn.Module, causal: bool, t_range: str) -> str:
    """MultiHeadAttention with an all-ones padding mask; x [1, T, C]."""
    n_heads, dh = attn.n_heads, attn.k_channels
    c = n_heads * dh
    window = attn.window_size

    def heads(t):
        return g.transpose(g.reshape(t, [0, 0, n_heads, dh]), [0, 2, 1, 3])

    q = g.mul(heads(_dense(g, x, attn.conv_q)), g.const_f32(1.0 / np.sqrt(dh), "scale"))
    k = heads(_dense(g, x, attn.conv_k))
    v = heads(_dense(g, x, attn.conv_v))
    scores = g.matmul(q, g.transpose(k, [0, 1, 3, 2]))  # [1, H, T, T]
    if window is not None:
        embm_k = _rel_emb_matrix(g, t_range, _np(attn.emb_rel_k[0]), window)
        scores = g.add(scores, g.einsum("bhtd,tsd->bhts", [q, embm_k]))
    if causal:
        fut = g.n("Greater", [g.unsqueeze(t_range, [0]), g.unsqueeze(t_range, [1])])  # j > i
        scores = g.n("Where", [fut, g.const_f32(-1e4, "neg"), scores])
    p = g.softmax(scores, axis=-1)
    out = g.matmul(p, v)  # [1, H, T, dh]
    if window is not None:
        embm_v = _rel_emb_matrix(g, t_range, _np(attn.emb_rel_v[0]), window)
        out = g.add(out, g.einsum("bhts,tsd->bhtd", [p, embm_v]))
    out = g.reshape(g.transpose(out, [0, 2, 1, 3]), [0, 0, c])
    return _dense(g, out, attn.conv_o)


def _ffn(g: GraphBuilder, x: str, ffn: nn.Module) -> str:
    y = g.transpose(x, [0, 2, 1])
    y = g.relu(_conv(g, y, ffn.conv_1, ffn.pad, hint="ffn1"))
    y = _conv(g, y, ffn.conv_2, ffn.pad, hint="ffn2")
    return g.transpose(y, [0, 2, 1])


def _encoder(g: GraphBuilder, x: str, enc: nn.Module, t_range: str) -> str:
    """nn.attention.Encoder (post-LN, windowed relative attention); x [1, T, C]."""
    for attn, norm1, ffn, norm2 in zip(enc.attn_layers, enc.norm_layers_1, enc.ffn_layers,
                                      enc.norm_layers_2):
        x = _layer_norm(g, g.add(x, _attention(g, x, attn, False, t_range)), norm1)
        x = _layer_norm(g, g.add(x, _ffn(g, x, ffn)), norm2)
    return x


def _gated(g: GraphBuilder, x_ncw: str, cond_ncw: str, h: int) -> str:
    a, b = g.split(g.add(x_ncw, cond_ncw), axis=1, sizes=[h, h])
    return g.mul(g.tanh(a), g.sigmoid(b))


def _wavenet(g: GraphBuilder, x_ncw: str, wn: nn.Module, g_ncw: str | None) -> str:
    """nn.wavenet.WN in NCW (masks dropped: all ones)."""
    h = wn.hidden_channels
    g_all = None
    if g_ncw is not None and wn.cond_layer is not None:
        g_all = _conv(g, g_ncw, wn.cond_layer, (0, 0), hint="wn_cond")
    out = None
    for i, (in_layer, rs_layer) in enumerate(zip(wn.in_layers, wn.res_skip_layers)):
        pad = in_layer.padding
        x_in = _conv(g, x_ncw, in_layer, (pad, pad), dilation=in_layer.dilation, hint=f"wn_in{i}")
        cond = (g.slice_(g_all, [i * 2 * h], [(i + 1) * 2 * h], [1]) if g_all is not None
                else g.const_f32(0.0, "zero"))
        rs = _conv(g, _gated(g, x_in, cond, h), rs_layer, (0, 0), hint=f"wn_rs{i}")
        if i < wn.n_layers - 1:
            res, skip = g.split(rs, axis=1, sizes=[h, h])
            x_ncw = g.add(x_ncw, res)
            out = skip if out is None else g.add(out, skip)
        else:
            out = rs if out is None else g.add(out, rs)
    return out


def _fft_stack(g: GraphBuilder, x: str, fft: nn.Module, g_ncw: str | None, t_range: str) -> str:
    """nn.attention.FFT (causal, flow conditioning); x [1, T, C]."""
    h = fft.hidden_channels
    g_all = None
    if g_ncw is not None and hasattr(fft, "cond_layer"):
        g_all = _conv(g, g_ncw, fft.cond_layer, (0, 0), hint="fft_cond")
    for i, (attn, norm0, ffn, norm1) in enumerate(zip(
            fft.self_attn_layers, fft.norm_layers_0, fft.ffn_layers, fft.norm_layers_1)):
        if g_all is not None:
            xc = g.transpose(_conv(g, g.transpose(x, [0, 2, 1]), fft.cond_pre, (0, 0),
                                   hint="fft_pre"), [0, 2, 1])
            g_l = g.transpose(g.slice_(g_all, [i * 2 * h], [(i + 1) * 2 * h], [1]), [0, 2, 1])
            a, b = g.split(g.add(xc, g_l), axis=2, sizes=[h, h])
            x = g.mul(g.tanh(a), g.sigmoid(b))
        x = _layer_norm(g, g.add(x, _attention(g, x, attn, True, t_range)), norm0)
        x = _layer_norm(g, g.add(x, _ffn(g, x, ffn)), norm1)
    return x


def _flow_reverse(g: GraphBuilder, x_ncw: str, flow: nn.Module, channels: int, g_ncw: str,
                  t_range: str) -> str:
    """flow(z_p, reverse=True): the couplings and flips in reverse order."""
    half = channels // 2
    rev = g.const_i64(list(range(channels - 1, -1, -1)), "flip")
    for coupling in reversed(flow.flows[0::2]):
        x_ncw = g.gather(x_ncw, rev, axis=1)
        x0 = g.slice_(x_ncw, [0], [half], [1])
        x1 = g.slice_(x_ncw, [half], [channels], [1])
        h = _conv(g, x0, coupling.pre, (0, 0), hint="cpl_pre")
        if isinstance(coupling.enc, FFT):
            h = g.transpose(_fft_stack(g, g.transpose(h, [0, 2, 1]), coupling.enc, g_ncw, t_range),
                            [0, 2, 1])
        else:
            h = _wavenet(g, h, coupling.enc, g_ncw)
        x1 = g.sub(x1, _conv(g, h, coupling.post, (0, 0), hint="cpl_post"))
        x_ncw = g.concat([x0, x1], axis=1)
    return x_ncw


def _f0_coarse(g: GraphBuilder, f0: str) -> str:
    """dsp/f0.f0_to_coarse: mel-scale bins in [1, 255]."""
    mel = g.mul(
        g.n("Log", [g.add(g.const_f32(1.0, "one"), g.div(f0, g.const_f32(700.0, "c700")))]),
        g.const_f32(1127.0, "c1127"),
    )
    a = (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN)
    b = F0_MEL_MIN * a - 1.0
    scaled = g.sub(g.mul(mel, g.const_f32(a, "a")), g.const_f32(b, "b"))
    mel = g.n("Where", [g.n("Greater", [mel, g.const_f32(0.0, "z")]), scaled, mel])
    coarse = g.n("Clip", [g.n("Round", [mel]), g.const_f32(1.0, "cl"), g.const_f32(255.0, "ch")])
    return g.cast(coarse, P.DT_INT64)


def _sine_source(g: GraphBuilder, f0: str, source: nn.Module, upp: int) -> str:
    """The deterministic SourceModuleHnNSF: f0 [1, T] -> har_source
    [1, 1, T*upp]. No random phases or additive noise (the reference's ONNX
    SineGen drops randomness at export too)."""
    w = _np(source.l_linear.weight[0])  # [H]
    h = len(w)
    harmonics = np.arange(1, h + 1, dtype=np.float32).reshape(1, h, 1)
    f0_h = g.mul(g.unsqueeze(f0, [1]), g.init(harmonics, "harm"))  # [1, H, T]
    rad = g.div(f0_h, g.const_f32(float(source.sampling_rate), "sr"))
    rad = g.sub(rad, g.n("Floor", [rad]))  # % 1.0
    frame_adv = g.mul(rad, g.const_f32(float(upp), "upp"))
    frame_adv = g.sub(frame_adv, g.n("Floor", [frame_adv]))
    base = g.sub(g.cumsum(frame_adv, axis=2), frame_adv)  # exclusive cumsum
    offsets = np.arange(1, upp + 1, dtype=np.float32).reshape(1, 1, 1, upp)
    phase = g.add(g.unsqueeze(base, [3]), g.mul(g.unsqueeze(rad, [3]), g.init(offsets, "offsets")))
    sines = g.mul(g.n("Sin", [g.mul(phase, g.const_f32(2.0 * np.pi, "twopi"))]),
                  g.const_f32(source.sine_amp, "amp"))
    uv = g.cast(g.n("Greater", [f0, g.const_f32(source.voiced_threshold, "vth")]), P.DT_FLOAT)
    sines = g.mul(sines, g.unsqueeze(uv, [1, 3]))  # [1, H, T, upp]
    merged = g.einsum("bhtu,h->btu", [sines, g.init(w, "merge_w")])
    merged = g.add(merged, g.const_f32(float(_np(source.l_linear.bias)[0]), "merge_b"))
    return g.tanh(g.reshape(merged, [1, 1, -1]))  # [1, 1, T*upp]


def _generator(g: GraphBuilder, z_ncw: str, f0: str, dec: nn.Module, g_ncw: str) -> str:
    """The NSF-HiFiGAN Generator in NCW."""
    har = _sine_source(g, f0, dec.m_source, dec.upp)
    x = _conv(g, z_ncw, dec.conv_pre, (3, 3), hint="dec_pre")
    if dec.cond is not None:
        x = g.add(x, _conv(g, g_ncw, dec.cond, (0, 0), hint="dec_cond"))
    nk = len(dec.kernel_sizes)
    for i in range(len(dec.ups)):
        up, noise_conv = dec.ups[i], dec.noise_convs[i]
        x = g.conv_transpose1d(g.leaky_relu(x, 0.1), _weight(up), _bias(up), stride=up.stride,
                               padding=up.padding, hint=f"up{i}")
        pad = noise_conv.padding[0]
        xs = _conv(g, har, noise_conv, (pad, pad), stride=noise_conv.stride[0], hint=f"noise{i}")
        x = g.add(x, xs)
        acc = None
        for j, block in enumerate(dec.resblocks[i * nk : (i + 1) * nk]):
            xr = x
            for c1, c2 in zip(block.convs1, block.convs2):
                xt = _conv(g, g.leaky_relu(xr, 0.1), c1, (c1.padding, c1.padding),
                           dilation=c1.dilation, hint=f"rb{i}{j}c1")
                xt = _conv(g, g.leaky_relu(xt, 0.1), c2, (c2.padding, c2.padding),
                           hint=f"rb{i}{j}c2")
                xr = g.add(xt, xr)
            acc = xr if acc is None else g.add(acc, xr)
        x = g.div(acc, g.const_f32(float(nk), "nk"))
    x = _conv(g, g.leaky_relu(x, 0.01), dec.conv_post, (3, 3), hint="dec_post")
    return g.tanh(x)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def build_synthesizer_onnx(model: nn.Module, hps, chara_mix: bool | None = None) -> bytes:
    """The SoVits ONNX model bytes of the port's ``Synthesizer`` for ``hps``."""
    m = hps.model
    dec = model.dec
    if dec.snake:
        raise NotImplementedError("ONNX export covers the nsf-hifigan vocoder; the Snake "
                                  "vocoder stays on the torch.export path")
    if not all(isinstance(b, ResBlock1) and isinstance(b.convs1[0], WeightNormed)
               for b in dec.resblocks):
        raise NotImplementedError("ONNX export covers resblock \"1\" with plain convs; resblock "
                                  "\"2\" and depthwise convs stay on the torch.export path")
    n_spk = int(m.n_speakers)
    if chara_mix is None:
        chara_mix = n_spk > 1
    inter = int(m.inter_channels)

    g = GraphBuilder("sovits_tpu_torch")
    c = g.input("c", [1, "T", int(m.ssl_dim)])
    f0 = g.input("f0", [1, "T"])
    mel2ph = g.input("mel2ph", [1, "T"], P.DT_INT64)
    uv = g.input("uv", [1, "T"])
    noise = g.input("noise", [1, inter, "T"])
    sid = g.input("sid", ["T", n_spk]) if chara_mix else g.input("sid", [1], P.DT_INT64)
    vol = g.input("vol", [1, "T"]) if model.vol_embedding else None

    t_frames = g.squeeze(g.shape_dim(mel2ph, 1), [0])  # scalar T
    t_range = g.n("Range", [g.init(np.asarray(0, np.int64), "r0"), g.cast(t_frames, P.DT_INT64),
                            g.init(np.asarray(1, np.int64), "r1")])

    # c gathered by mel2ph over a front-padded frame axis
    c_flat = g.squeeze(g.pad(c, [0, 1, 0, 0, 0, 0]), [0])  # [T+1, ssl]
    c_sel = g.unsqueeze(g.gather(c_flat, g.squeeze(mel2ph, [0]), axis=0), [0])  # [1, T, ssl]

    # speaker conditioning [1, gin, Tg]
    spk_table = g.init(_np(model.emb_g.weight), "spk_table")  # [S, gin]
    if chara_mix:
        g_ncw = g.unsqueeze(g.transpose(g.matmul(sid, spk_table), [1, 0]), [0])  # [1, gin, T]
    else:
        g_ncw = g.unsqueeze(g.transpose(g.gather(spk_table, sid, axis=0), [1, 0]), [0])  # [1, gin, 1]

    # prenet: pre(c) + emb_uv (+ emb_vol)
    x_ncw = _conv(g, g.transpose(c_sel, [0, 2, 1]), model.pre, (2, 2), hint="prenet")
    uv_idx = g.squeeze(g.cast(uv, P.DT_INT64), [0])  # [T]
    uv_emb = g.gather(g.init(_np(model.emb_uv.weight), "uv_table"), uv_idx, axis=0)  # [T, H]
    x_ncw = g.add(x_ncw, g.unsqueeze(g.transpose(uv_emb, [1, 0]), [0]))
    if vol is not None:
        v_emb = g.add(g.matmul(g.unsqueeze(vol, [2]), g.init(_np(model.emb_vol.weight.t()), "vol_w")),
                      g.init(_np(model.emb_vol.bias), "vol_b"))  # [1, T, H]
        x_ncw = g.add(x_ncw, g.transpose(v_emb, [0, 2, 1]))

    # enc_p: f0 embedding + relative-attention encoder + proj
    ep = model.enc_p
    coarse = g.squeeze(_f0_coarse(g, f0), [0])  # [T]
    f0_emb = g.unsqueeze(g.gather(g.init(_np(ep.f0_emb.weight), "f0_table"), coarse, axis=0), [0])
    x_ntc = _encoder(g, g.add(g.transpose(x_ncw, [0, 2, 1]), f0_emb), ep.enc_, t_range)
    stats = _conv(g, g.transpose(x_ntc, [0, 2, 1]), ep.proj, (0, 0), hint="enc_proj")
    m_p, logs_p = g.split(stats, axis=1, sizes=[inter, inter])
    z_p = g.add(m_p, g.mul(noise, g.exp(logs_p)))

    z = _flow_reverse(g, z_p, model.flow, inter, g_ncw, t_range)
    audio = _generator(g, z, f0, dec, g_ncw)
    g.n_named("Identity", [audio], ["audio"])
    g.output("audio", [1, 1, "T_samples"])
    return g.model_bytes(opset=16)


def moevs_config(hps, name: str, chara_mix: bool) -> dict:
    """MoeSS sidecar (onnx_export.py:113-131)."""
    spk = list(getattr(hps, "spk", {}).keys()) if hasattr(hps, "spk") else []
    gin = int(hps.model.gin_channels)
    vec_lay = "layer-12" if gin == 768 else "layer-9"
    return {
        "Folder": name,
        "Name": name,
        "Type": "SoVits",
        "Rate": int(hps.data.sampling_rate),
        "Hop": int(hps.data.hop_length),
        "Hubert": f"vec-{gin}-{vec_lay}",
        "SoVits4": True,
        "SoVits3": False,
        "CharaMix": bool(chara_mix),
        "Volume": bool(getattr(hps.model, "vol_embedding", False)),
        "HiddenSize": gin,
        "Characters": spk,
        "Cluster": "",
    }
