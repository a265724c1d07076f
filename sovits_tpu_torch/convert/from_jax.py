"""Carry the JAX package's parameters into the port (numpy only).

``synthesizer`` is the inverse of ``sovits_tpu/convert/from_torch.py::
synthesizer``: a flax param tree -> a so-vits-svc ``SynthesizerTrn``
state_dict (weight-normed convs as weight_g / weight_v).
``multi_period_discriminator`` is the inverse of ``from_torch.py::
multi_period_discriminator`` (weight-normed); ``unit2mel`` of
``from_torch.py::unit2mel`` (the diffusion model), and ``generator`` with no
``cond`` of ``nsf_hifigan_generator`` for a standalone vocoder. ``wav2vec2`` is the
inverse of ``sovits_tpu/encoders/convert.py::from_fairseq_hubert``: flax
Wav2Vec2Encoder params -> a fairseq HuBERT state_dict; ``whisper``, ``wavlm``
and ``dphubert`` are the inverses of the JAX encoders' converters
(``convert_whisper_encoder``, ``convert_wavlm_state_dict``,
``convert_dphubert_state_dict``) into each checkpoint's names. ``rmvpe``, ``fcpe``
and ``crepe`` are the inverses of the JAX f0 nets' ``convert_*_state_dict``:
flax params (and batch stats) -> the published checkpoints' state_dicts.
Values come back as numpy arrays; load them with ``{k: torch.from_numpy(v)}``.

Layout maps (flax -> torch):
- Conv1d        kernel (kw, in, out)  -> weight (out, in, kw)
- separable     depth / point         -> depth_conv / point_conv
- Conv2d        kernel (kh, kw, in, out) -> weight_v (out, in, kh, kw)
- ConvT1d       kernel (kw, in, out)  -> weight_v (in, out, kw)
- weight norm   g (out,) / g_in (in,) -> weight_g (n, 1, 1)
- Dense 1x1     kernel (in, out)      -> weight (out, in, 1)
- Linear        kernel (in, out)      -> weight (out, in)
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    return np.array(x, order="C")  # a writable copy: torch.from_numpy shares it


def _put(sd: dict, prefix: str, params: dict) -> None:
    for k, v in params.items():
        sd[prefix + k] = v


def conv1d(p: dict) -> dict:
    out = {"weight": _np(np.transpose(p["kernel"], (2, 1, 0)))}
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def conv1d_wn(p: dict) -> dict:
    out = {
        "weight_v": _np(np.transpose(p["kernel"], (2, 1, 0))),
        "weight_g": _np(np.asarray(p["g"]).reshape(-1, 1, 1)),
    }
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def conv1d_maybe_wn(p: dict) -> dict:
    return conv1d_wn(p) if "g" in p else conv1d(p)


def conv2d_wn(p: dict) -> dict:
    out = {
        "weight_v": _np(np.transpose(p["kernel"], (3, 2, 0, 1))),
        "weight_g": _np(np.asarray(p["g"]).reshape(-1, 1, 1, 1)),
    }
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def conv_transpose1d_wn(p: dict) -> dict:
    out = {
        "weight_v": _np(np.transpose(p["kernel"], (1, 2, 0))),
        "weight_g": _np(np.asarray(p["g_in"]).reshape(-1, 1, 1)),
    }
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def conv1x1_from_dense(p: dict) -> dict:
    out = {"weight": _np(np.transpose(p["kernel"], (1, 0))[:, :, None])}
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def linear(p: dict) -> dict:
    out = {"weight": _np(np.transpose(p["kernel"], (1, 0)))}
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def _count(p: dict, stem: str) -> int:
    return sum(1 for k in p if k.startswith(stem) and k[len(stem):].isdigit())


def conv1d_any(p: dict) -> dict:
    """A plain, weight-normed or separable (``depth`` / ``point``) conv."""
    if "depth" in p:
        return {f"{part}_conv.{k}": v for part in ("depth", "point")
                for k, v in conv1d_maybe_wn(p[part]).items()}
    return conv1d_maybe_wn(p)


def wavenet(sd: dict, prefix: str, p: dict) -> None:
    if "cond" in p:
        _put(sd, prefix + "cond_layer.", conv1d_wn(p["cond"]))
    for i in range(_count(p, "in_")):
        _put(sd, prefix + f"in_layers.{i}.", conv1d_wn(p[f"in_{i}"]))
        _put(sd, prefix + f"res_skip_layers.{i}.", conv1d_wn(p[f"res_skip_{i}"]))


def mha(sd: dict, prefix: str, p: dict) -> None:
    for name, torch_name in (("query", "conv_q"), ("key", "conv_k"), ("value", "conv_v"), ("out", "conv_o")):
        _put(sd, prefix + torch_name + ".", conv1x1_from_dense(p[name]))
    if "emb_rel_k" in p:
        sd[prefix + "emb_rel_k"] = _np(p["emb_rel_k"])
        sd[prefix + "emb_rel_v"] = _np(p["emb_rel_v"])


def _layer_norm(p: dict) -> dict:
    return {"gamma": _np(p["scale"]), "beta": _np(p["bias"])}


def _ffn(sd: dict, prefix: str, p: dict) -> None:
    _put(sd, prefix + "conv_1.", conv1d(p["conv1"]))
    _put(sd, prefix + "conv_2.", conv1d(p["conv2"]))


def attn_encoder(sd: dict, prefix: str, p: dict) -> None:
    for i in range(_count(p, "attn_")):
        mha(sd, prefix + f"attn_layers.{i}.", p[f"attn_{i}"])
        _put(sd, prefix + f"norm_layers_1.{i}.", _layer_norm(p[f"norm1_{i}"]))
        _ffn(sd, prefix + f"ffn_layers.{i}.", p[f"ffn_{i}"])
        _put(sd, prefix + f"norm_layers_2.{i}.", _layer_norm(p[f"norm2_{i}"]))


def attn_fft(sd: dict, prefix: str, p: dict) -> None:
    if "cond" in p:
        _put(sd, prefix + "cond_layer.", conv1d_wn(p["cond"]))
        _put(sd, prefix + "cond_pre.", conv1d(p["cond_pre"]))
    for i in range(_count(p, "attn_")):
        mha(sd, prefix + f"self_attn_layers.{i}.", p[f"attn_{i}"])
        _put(sd, prefix + f"norm_layers_0.{i}.", _layer_norm(p[f"norm0_{i}"]))
        _ffn(sd, prefix + f"ffn_layers.{i}.", p[f"ffn_{i}"])
        _put(sd, prefix + f"norm_layers_1.{i}.", _layer_norm(p[f"norm1_{i}"]))


def _snake(sd: dict, prefix: str, p: dict) -> None:
    sd[prefix + "act.alpha"] = _np(p["act"]["alpha"])
    sd[prefix + "act.beta"] = _np(p["act"]["beta"])


def coupling_block(sd: dict, prefix: str, p: dict, transformer: bool) -> None:
    """ResidualCouplingBlock / TransformerCouplingBlock: couplings at
    ``flows.{0,2,4,...}``; a shared inner net (``shared_wn`` / ``shared_enc``)
    under ``wn.`` and, as so-vits-svc's state_dict holds it, under every
    coupling's ``enc.``."""
    inner = attn_fft if transformer else wavenet
    shared = p.get("shared_enc", p.get("shared_wn"))
    if shared is not None:
        inner(sd, prefix + "wn.", shared)
    for i in range(_count(p, "coupling_")):
        cp = p[f"coupling_{i}"]
        where = f"{prefix}flows.{2 * i}."
        _put(sd, where + "pre.", conv1d(cp["pre"]))
        inner(sd, where + "enc.", cp["enc"] if shared is None else shared)
        _put(sd, where + "post.", conv1d(cp["post"]))


def resblock(sd: dict, prefix: str, p: dict) -> None:
    """ResBlock1 / ResBlock2, plain or separable, and their Snake variants."""
    for name, value in p.items():
        stem, j = name.rsplit("_", 1)
        j = int(j)
        if stem.startswith("act"):  # Snake's: act1_j / act2_j alternate, act_j in order
            slot = {"act1": 2 * j, "act2": 2 * j + 1, "act": j}[stem]
            _snake(sd, f"{prefix}activations.{slot}.", value)
        else:
            convs = {"conv1": "convs1", "conv2": "convs2", "conv": "convs"}[stem]
            _put(sd, f"{prefix}{convs}.{j}.", conv1d_any(value))


def generator(sd: dict, prefix: str, p: dict) -> None:
    """NSF-HiFiGAN or its Snake variant (``snake_{i}`` / ``snake_post``)."""
    _put(sd, prefix + "conv_pre.", conv1d_wn(p["conv_pre"]))
    _put(sd, prefix + "conv_post.", conv1d_wn(p["conv_post"]))
    sd[prefix + "m_source.l_linear.weight"] = _np(np.transpose(p["m_source"]["merge_kernel"], (1, 0)))
    sd[prefix + "m_source.l_linear.bias"] = _np(p["m_source"]["merge_bias"])
    if "cond" in p:
        _put(sd, prefix + "cond.", conv1d(p["cond"]))
    if "snake_post" in p:
        _snake(sd, prefix + "snake_post.", p["snake_post"])
    n_kernels = _count(p, "resblock_0_")
    for i in range(_count(p, "up_")):
        _put(sd, prefix + f"ups.{i}.", conv_transpose1d_wn(p[f"up_{i}"]))
        _put(sd, prefix + f"noise_convs.{i}.", conv1d(p[f"noise_conv_{i}"]))
        if f"snake_{i}" in p:
            _snake(sd, prefix + f"snakes.{i}.", p[f"snake_{i}"])
        for j in range(n_kernels):
            resblock(sd, prefix + f"resblocks.{i * n_kernels + j}.", p[f"resblock_{i}_{j}"])


def synthesizer(params: dict, hps) -> dict:
    """flax Synthesizer params -> so-vits-svc SynthesizerTrn state_dict
    (numpy), for every model option: the volume embedding, the WN or
    transformer flow with or without a shared inner net, and the NSF or
    Snake generator with ResBlock1 or ResBlock2, plain or separable."""
    sd: dict = {}
    sd["emb_g.weight"] = _np(params["emb_g"]["embedding"])
    sd["emb_uv.weight"] = _np(params["emb_uv"]["embedding"])
    if "emb_vol" in params:
        _put(sd, "emb_vol.", linear(params["emb_vol"]))
    _put(sd, "pre.", conv1d(params["pre"]))
    enc_p = params["enc_p"]
    sd["enc_p.f0_emb.weight"] = _np(enc_p["f0_emb"]["embedding"])
    attn_encoder(sd, "enc_p.enc_.", enc_p["enc"])
    _put(sd, "enc_p.proj.", conv1d(enc_p["proj"]))
    if "enc_q" in params:  # a compressed release model has no posterior encoder
        enc_q = params["enc_q"]
        _put(sd, "enc_q.pre.", conv1d(enc_q["pre"]))
        wavenet(sd, "enc_q.enc.", enc_q["enc"])
        _put(sd, "enc_q.proj.", conv1d(enc_q["proj"]))
    coupling_block(sd, "flow.", params["flow"], bool(hps.model.use_transformer_flow))
    if "f0_decoder" in params:
        fd = params["f0_decoder"]
        for name in ("prenet", "proj", "f0_prenet", "cond"):
            _put(sd, f"f0_decoder.{name}.", conv1d(fd[name]))
        attn_fft(sd, "f0_decoder.decoder.", fd["decoder"])
    generator(sd, "dec.", params["dec"])
    return sd


def diffusion_wavenet(sd: dict, prefix: str, p: dict) -> None:
    """DiffusionWaveNet params -> so-vits-svc ``diffusion/wavenet.py``
    WaveNet keys (the inverse of ``from_torch.py::diffusion_wavenet``)."""
    _put(sd, prefix + "input_projection.", conv1d(p["input_projection"]))
    _put(sd, prefix + "mlp.0.", linear(p["mlp1"]))
    _put(sd, prefix + "mlp.2.", linear(p["mlp2"]))
    _put(sd, prefix + "skip_projection.", conv1d(p["skip_projection"]))
    _put(sd, prefix + "output_projection.", conv1d(p["output_projection"]))
    for i in range(_count(p, "layer_")):
        lp, where = p[f"layer_{i}"], f"{prefix}residual_layers.{i}."
        _put(sd, where + "dilated_conv.", conv1d(lp["dilated_conv"]))
        _put(sd, where + "diffusion_projection.", linear(lp["diffusion_projection"]))
        _put(sd, where + "conditioner_projection.", conv1d(lp["conditioner_projection"]))
        _put(sd, where + "output_projection.", conv1d(lp["output_projection"]))


def unit2mel(params: dict) -> dict:
    """flax Unit2Mel params -> so-vits-svc Unit2Mel state_dict (numpy),
    without GaussianDiffusion's schedule buffers (the inverse of
    ``from_torch.py::unit2mel``)."""
    sd: dict = {}
    for name in ("unit_embed", "f0_embed", "volume_embed"):
        _put(sd, name + ".", linear(params[name]))
    if "aug_shift_embed" in params:
        _put(sd, "aug_shift_embed.", linear(params["aug_shift_embed"]))
    if "spk_embed" in params:
        sd["spk_embed.weight"] = _np(params["spk_embed"]["embedding"])
    diffusion_wavenet(sd, "decoder.denoise_fn.", params["denoiser"])
    return sd


def unflatten_params(flat: dict) -> dict:
    """A flat {"a/b/c": array} dict (the JAX package's ``.npz`` release
    format, ``sovits_tpu/cli/tools.py::flatten_params``) -> a nested tree."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def multi_period_discriminator(params: dict) -> dict:
    """flax MultiPeriodDiscriminator params (weight norm) -> so-vits-svc
    state_dict (numpy): slot 0 the scale discriminator, then the period ones
    in the order of their periods."""
    sd: dict = {}
    periods = sorted(int(k[len("disc_p"):]) for k in params if k.startswith("disc_p"))
    for slot, (name, conv) in enumerate([("disc_s", conv1d_wn)]
                                        + [(f"disc_p{p}", conv2d_wn) for p in periods]):
        d = params[name]
        for i in range(_count(d, "conv_")):
            _put(sd, f"discriminators.{slot}.convs.{i}.", conv(d[f"conv_{i}"]))
        _put(sd, f"discriminators.{slot}.conv_post.", conv(d["conv_post"]))
    return sd


def wav2vec2(params: dict, cfg) -> dict:
    """flax Wav2Vec2Encoder params -> fairseq HuBERT state_dict (numpy)."""
    fe = params["feature_extractor"]
    sd: dict = {}
    for i in range(_count(fe, "conv_")):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = _np(np.transpose(fe[f"conv_{i}"]["kernel"], (2, 1, 0)))
    sd["feature_extractor.conv_layers.0.2.weight"] = _np(fe["group_norm"]["scale"])
    sd["feature_extractor.conv_layers.0.2.bias"] = _np(fe["group_norm"]["bias"])
    sd["layer_norm.weight"] = _np(params["feat_norm"]["scale"])
    sd["layer_norm.bias"] = _np(params["feat_norm"]["bias"])
    _put(sd, "post_extract_proj.", linear(params["feat_proj"]))
    pc = params["pos_conv"]
    sd["encoder.pos_conv.0.weight_v"] = _np(np.transpose(pc["kernel"], (2, 1, 0)))
    sd["encoder.pos_conv.0.weight_g"] = _np(np.asarray(pc["g_k"]).reshape(1, 1, -1))
    sd["encoder.pos_conv.0.bias"] = _np(pc["bias"])
    sd["encoder.layer_norm.weight"] = _np(params["encoder_norm"]["scale"])
    sd["encoder.layer_norm.bias"] = _np(params["encoder_norm"]["bias"])
    d = cfg.d_model
    for i in range(_count(params, "layer_")):
        lp = params[f"layer_{i}"]
        pre = f"encoder.layers.{i}."
        att = lp["self_attn"]
        for name, torch_name in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj")):
            sd[pre + f"self_attn.{torch_name}.weight"] = _np(np.asarray(att[name]["kernel"]).reshape(d, d).T)
            sd[pre + f"self_attn.{torch_name}.bias"] = _np(np.asarray(att[name]["bias"]).reshape(d))
        sd[pre + "self_attn.out_proj.weight"] = _np(np.asarray(att["out"]["kernel"]).reshape(d, d).T)
        sd[pre + "self_attn.out_proj.bias"] = _np(att["out"]["bias"])
        _put(sd, pre + "fc1.", linear(lp["fc1"]))
        _put(sd, pre + "fc2.", linear(lp["fc2"]))
        for name, torch_name in (("norm1", "self_attn_layer_norm"), ("norm2", "final_layer_norm")):
            sd[pre + f"{torch_name}.weight"] = _np(lp[name]["scale"])
            sd[pre + f"{torch_name}.bias"] = _np(lp[name]["bias"])
    if "final_proj" in params:
        _put(sd, "final_proj.", linear(params["final_proj"]))
    return sd


def _ln(p: dict) -> dict:
    return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}


def _pos_conv(kernel, g, bias) -> dict:
    """A weight-normed positional conv, norm over dim 2: g (kw,) -> (1, 1, kw)."""
    return {"weight_v": _np(np.transpose(kernel, (2, 1, 0))),
            "weight_g": _np(np.asarray(g).reshape(1, 1, -1)), "bias": _np(bias)}


def whisper(params: dict) -> dict:
    """flax WhisperAudioEncoder params -> openai-whisper's ``encoder.*``
    state_dict (numpy; the inverse of ``sovits_tpu/encoders/whisper.py::
    convert_whisper_encoder``), without the positional embedding, which
    both packages recompute."""
    sd: dict = {}
    for name in ("conv1", "conv2"):
        _put(sd, f"encoder.{name}.", conv1d(params[name]))
    _put(sd, "encoder.ln_post.", _ln(params["ln_post"]))
    for i in range(_count(params, "block_")):
        bp, pre = params[f"block_{i}"], f"encoder.blocks.{i}."
        for name in ("query", "key", "value", "out"):
            _put(sd, f"{pre}attn.{name}.", linear(bp["attn"][name]))
        _put(sd, pre + "attn_ln.", _ln(bp["attn_ln"]))
        _put(sd, pre + "mlp_ln.", _ln(bp["mlp_ln"]))
        _put(sd, pre + "mlp.0.", linear(bp["fc1"]))
        _put(sd, pre + "mlp.2.", linear(bp["fc2"]))
    return sd


def wavlm(params: dict, dims) -> dict:
    """flax WavLMEncoder params -> a WavLM ``model`` state_dict (numpy; the
    inverse of ``sovits_tpu/encoders/wavlm.py::convert_wavlm_state_dict``):
    fairseq's trunk names, ``self_attn.grep_linear`` / ``grep_a`` per layer
    and layer 0's ``relative_attention_bias``."""
    fe = params["feature_extractor"]
    sd: dict = {}
    for i in range(_count(fe, "conv_")):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = _np(np.transpose(fe[f"conv_{i}"]["kernel"], (2, 1, 0)))
    _put(sd, "feature_extractor.conv_layers.0.2.", _ln(fe["group_norm"]))
    _put(sd, "layer_norm.", _ln(params["feat_norm"]))
    _put(sd, "post_extract_proj.", linear(params["feat_proj"]))
    pc = params["pos_conv"]
    _put(sd, "encoder.pos_conv.0.", _pos_conv(pc["kernel"], pc["g_k"], pc["bias"]))
    _put(sd, "encoder.layer_norm.", _ln(params["encoder_norm"]))
    sd["encoder.layers.0.self_attn.relative_attention_bias.weight"] = _np(params["rel_attn_bias"])
    for i in range(dims.n_layers):
        lp, pre = params[f"layer_{i}"], f"encoder.layers.{i}."
        att = lp["self_attn"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "grep_linear"):
            _put(sd, f"{pre}self_attn.{name}.", linear(att[name]))
        sd[pre + "self_attn.grep_a"] = _np(att["grep_a"])
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            _put(sd, f"{pre}{name}.", _ln(lp[name]))
        _put(sd, pre + "fc1.", linear(lp["fc1"]))
        _put(sd, pre + "fc2.", linear(lp["fc2"]))
    return sd


def dphubert(params: dict, cfg: dict) -> dict:
    """flax DPHubertEncoder params -> a DPHuBERT ``state_dict`` (numpy; the
    inverse of ``sovits_tpu/encoders/dphubert.py::convert_dphubert_state_dict``):
    torchaudio's wav2vec2 names, a pruned layer without its attention or
    feed-forward entries."""
    sd: dict = {}
    for i in range(len(cfg["extractor_conv_layer_config"])):
        _put(sd, f"feature_extractor.conv_layers.{i}.conv.", conv1d(params[f"conv_{i}"]))
    if "group_norm" in params:
        _put(sd, "feature_extractor.conv_layers.0.layer_norm.", _ln(params["group_norm"]))
    _put(sd, "encoder.feature_projection.layer_norm.", _ln(params["proj_norm"]))
    _put(sd, "encoder.feature_projection.projection.", linear(params["proj"]))
    _put(sd, "encoder.transformer.pos_conv_embed.conv.",
         _pos_conv(params["pos_kernel"], params["pos_g"], params["pos_bias"]))
    _put(sd, "encoder.transformer.layer_norm.", _ln(params["encoder_norm"]))
    for i in range(cfg["encoder_num_layers"]):
        pre = f"encoder.transformer.layers.{i}."
        if f"l{i}_q" in params:
            for name, torch_name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                     ("out", "out_proj")):
                _put(sd, f"{pre}attention.{torch_name}.", linear(params[f"l{i}_{name}"]))
        _put(sd, pre + "layer_norm.", _ln(params[f"l{i}_ln1"]))
        if f"l{i}_fc1" in params:
            _put(sd, pre + "feed_forward.intermediate_dense.", linear(params[f"l{i}_fc1"]))
            _put(sd, pre + "feed_forward.output_dense.", linear(params[f"l{i}_fc2"]))
        _put(sd, pre + "final_layer_norm.", _ln(params[f"l{i}_ln2"]))
    return sd


def _conv2d(p: dict) -> dict:
    """Conv2d kernel (kh, kw, in, out) -> weight (out, in, kh, kw)."""
    out = {"weight": _np(np.transpose(p["kernel"], (3, 2, 0, 1)))}
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def _batch_norm(p: dict, s: dict) -> dict:
    return {"weight": _np(p["scale"]), "bias": _np(p["bias"]), "running_mean": _np(s["mean"]),
            "running_var": _np(s["var"])}


def rmvpe(variables: dict) -> dict:
    """flax RmvpeNet params and batch stats -> the published rmvpe.pt
    state_dict (numpy; the inverse of ``sovits_tpu/f0/rmvpe.py::
    convert_rmvpe_state_dict``). The transposed convs' ``up_kernel`` (kh,
    kw, in, out), which the JAX module flips as it runs, becomes the
    ConvTranspose2d weight (in, out, kh, kw), unflipped. BatchNorm's
    ``num_batches_tracked`` is left out: torch fills it on load."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def conv_block(prefix: str, bp: dict, bs: dict) -> None:
        _put(sd, prefix + "conv.0.", _conv2d(bp["conv1"]))
        _put(sd, prefix + "conv.1.", _batch_norm(bp["bn1"], bs["bn1"]))
        _put(sd, prefix + "conv.3.", _conv2d(bp["conv2"]))
        _put(sd, prefix + "conv.4.", _batch_norm(bp["bn2"], bs["bn2"]))
        if "shortcut" in bp:
            _put(sd, prefix + "shortcut.", _conv2d(bp["shortcut"]))

    _put(sd, "unet.encoder.bn.", _batch_norm(p["in_bn"], s["in_bn"]))
    for stem, where in (("enc_", "unet.encoder.layers."), ("inter_", "unet.intermediate.layers.")):
        for i in range(_count(p, stem)):
            lp, ls = p[f"{stem}{i}"], s[f"{stem}{i}"]
            for j in range(_count(lp, "block_")):
                conv_block(f"{where}{i}.conv.{j}.", lp[f"block_{j}"], ls[f"block_{j}"])
    for i in range(_count(p, "dec_")):
        lp, ls, pre = p[f"dec_{i}"], s[f"dec_{i}"], f"unet.decoder.layers.{i}."
        sd[pre + "conv1.0.weight"] = _np(np.transpose(lp["up_kernel"], (2, 3, 0, 1)))
        _put(sd, pre + "conv1.1.", _batch_norm(lp["bn1"], ls["bn1"]))
        for j in range(_count(lp, "block_")):
            conv_block(f"{pre}conv2.{j}.", lp[f"block_{j}"], ls[f"block_{j}"])
    _put(sd, "cnn.", _conv2d(p["cnn"]))
    gru = p["gru"]
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            torch_name = ("weight_" if name[0] == "w" else "bias_") + name[2:]
            sd[f"fc.0.gru.{torch_name}_l0{suffix}"] = _np(gru[f"{name}_{direction}"])
    _put(sd, "fc.1.", linear(p["fc"]))
    return sd


def fcpe(params: dict, f0_min: float = 32.70, f0_max: float = 1975.5) -> dict:
    """flax FcpeNet params -> the published fcpe.pt state_dict (numpy; the
    inverse of ``sovits_tpu/f0/fcpe.py::convert_fcpe_state_dict``), with the
    reference's ``cent_table`` and ``gaussian_blurred_cent_mask`` buffers,
    which the JAX converter does not read."""
    from ..f0.fcpe import cent_table

    sd: dict = {}
    _put(sd, "stack.0.", conv1d(params["stack0"]))
    sd["stack.1.weight"], sd["stack.1.bias"] = _np(params["stack_gn"]["scale"]), _np(params["stack_gn"]["bias"])
    _put(sd, "stack.3.", conv1d(params["stack3"]))
    sd["norm.weight"], sd["norm.bias"] = _np(params["norm"]["scale"]), _np(params["norm"]["bias"])
    sd["dense_out.weight_v"] = _np(np.transpose(params["out_v"], (1, 0)))
    sd["dense_out.weight_g"] = _np(np.asarray(params["out_g"]).reshape(-1, 1))
    sd["dense_out.bias"] = _np(params["out_b"])
    n_out = sd["dense_out.bias"].shape[0]
    sd["cent_table"] = cent_table(f0_min, f0_max, n_out)
    sd["gaussian_blurred_cent_mask"] = np.asarray(1200.0 * np.log2(f0_max / 10.0), np.float32)
    for i in range(_count(params, "layer_")):
        lp, pre = params[f"layer_{i}"], f"decoder._layers.{i}."
        sd[pre + "norm.weight"], sd[pre + "norm.bias"] = _np(lp["norm"]["scale"]), _np(lp["norm"]["bias"])
        att = lp["attn"]
        for name in ("to_q", "to_k", "to_v", "to_out"):
            _put(sd, f"{pre}attn.{name}.", linear(att[name]))
        sd[pre + "attn.fast_attention.projection_matrix"] = _np(att["projection_matrix"])
        conf, cpre = lp["conformer"], pre + "conformer.net."
        sd[cpre + "0.weight"], sd[cpre + "0.bias"] = _np(conf["norm"]["scale"]), _np(conf["norm"]["bias"])
        _put(sd, cpre + "2.", conv1x1_from_dense(conf["pw1"]))
        sd[cpre + "4.conv.weight"] = _np(np.transpose(conf["dw_kernel"], (2, 1, 0)))
        sd[cpre + "4.conv.bias"] = _np(conf["dw_bias"])
        _put(sd, cpre + "6.", conv1x1_from_dense(conf["pw2"]))
    return sd


def crepe(variables: dict) -> dict:
    """flax CrepeNet params and batch stats -> a torchcrepe state_dict
    (numpy; the inverse of ``sovits_tpu/f0/crepe.py::
    convert_crepe_state_dict``): conv kernels (kw, in, out) -> Conv2d
    weights (out, in, kw, 1)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for i in range(1, 7):
        sd[f"conv{i}.weight"] = _np(np.transpose(p[f"conv{i}"]["kernel"], (2, 1, 0))[..., None])
        sd[f"conv{i}.bias"] = _np(p[f"conv{i}"]["bias"])
        _put(sd, f"conv{i}_BN.", _batch_norm(p[f"bn{i}"], s[f"bn{i}"]))
    _put(sd, "classifier.", linear(p["classifier"]))
    return sd
