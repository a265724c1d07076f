"""Model export (counterpart of ``sovits_tpu/cli/export.py``; so-vits-svc
onnx_export.py), with the JAX CLI's flags and ``-d`` for the device:

    python -m sovits_tpu_torch.cli.export -m logs/44k/G_0.pth -c configs/config.json -o model.pt2
    python -m sovits_tpu_torch.cli.export -m G_0.pth -c config.json -o model.onnx --onnx
    python -m sovits_tpu_torch.cli.export -m model_0.pt -c diffusion.yaml -o proj --onnx --diffusion

- Default: ``torch.export`` of ``Synthesizer.infer`` with ``sample_noise``
  off at a static ``--t-frames`` (as the JAX package's ``jax.export`` is
  static), saved by ``torch.export.save`` as ``.pt2`` with a sidecar json.
  The program's inputs are c [1, T, ssl], f0 [1, T], uv [1, T], spk [1]
  (int64), and vol [1, T] for a ``vol_embedding`` model; its output is the
  audio [1, T*hop, 1]. The rel-pos attention forward and the ResBlock trio
  are the operators ``sovits::rel_attention_fwd`` and
  ``sovits::resblock_trio`` in the graph, so the loaded program launches
  the CUDA kernels on the card (and runs their plain versions on the CPU).
  ``load_exported`` loads it; it imports the port's ops first.
- ``--onnx``: the MoeSS-contract ONNX synthesizer (export/onnx_synth.py)
  and its MoeVS sidecar; ``--onnx --diffusion``: the four MoeSS diffusion
  artifacts from so-vits-svc's ``model_<step>.pt`` (what ``train_diff``
  writes) or the JAX trainer's ``.npz``. Every artifact is loaded and run
  through the port's ONNX runtime on the device before it is written.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..nn.conv import WeightNormed


class _Infer(torch.nn.Module):
    """``Synthesizer.infer`` with the noise off, returning the audio, on a
    copy of the model that holds only what it reads: the weight norms folded
    for good, and neither the posterior encoder nor the f0 decoder (the
    program does not predict f0)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = copy.deepcopy(model).requires_grad_(False)
        self.model.enc_q = self.model.f0_decoder = None
        for module in self.model.modules():
            if isinstance(module, WeightNormed):
                module.freeze_weight_norm()

    def forward(self, c, f0, uv, spk, vol=None):
        return self.model.infer(c, f0, uv, spk, sample_noise=False, vol=vol)[0]


def example_inputs(hps, t_frames: int, device) -> tuple:
    """The program's inputs at ``t_frames`` on ``device`` (zeros; spk 0)."""
    dev = torch.device(device)
    args = (
        torch.zeros(1, t_frames, hps.model.ssl_dim, device=dev),
        torch.zeros(1, t_frames, device=dev),
        torch.zeros(1, t_frames, device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev),
    )
    if hps.model.vol_embedding:
        args += (torch.zeros(1, t_frames, device=dev),)
    return args


def export_program(model: torch.nn.Module, hps, t_frames: int) -> torch.export.ExportedProgram:
    """``torch.export`` of the synthesizer's noise-free ``infer`` at a static
    ``t_frames``, on the model's device, from a copy of the model (``model``
    is left as it was). Traced under ``no_grad`` (``infer`` runs without
    gradients: the graph then needs no grad-mode switch)."""
    device = next(model.parameters()).device
    with torch.no_grad():
        program = torch.export.export(_Infer(model), example_inputs(hps, t_frames, device))
    _drop_noop_casts(program)
    return program


def _drop_noop_casts(program: torch.export.ExportedProgram) -> None:
    """Remove from the graph the casts of a tensor to its own type, which
    every ``.to(dtype)`` of the compute-type modules leaves there, and the
    metadata assert traced beside each: no-ops on the traced types that
    cost the loaded program a Python call each (two per cast)."""
    graph = program.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and not node.kwargs.get("copy", False)
              and node.args[0].meta["val"].dtype == node.meta["val"].dtype
              and all(user.op != "output" for user in node.users)):  # the signature names outputs
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def export_synthesizer(model_path: str, config_path: str, out_path: str, t_frames: int = 512,
                       device: str = "cuda") -> torch.export.ExportedProgram:
    from ..infer.svc import Svc

    svc = Svc(model_path, config_path, device=device)
    hps = svc.hps
    t0 = time.perf_counter()
    program = export_program(svc.model, hps, t_frames)
    torch.export.save(program, out_path)
    meta = {
        "Folder": Path(out_path).stem,
        "Name": Path(out_path).stem,
        "Type": "SoVits",
        "Rate": hps.data.sampling_rate,
        "Hop": hps.data.hop_length,
        "Hubert": hps.model.speech_encoder,
        "SoVits4": True,
        "Characters": list(svc.spk2id.keys()),
        "t_frames": t_frames,
    }
    Path(out_path).with_suffix(".json").write_text(json.dumps(meta, indent=2))
    size = Path(out_path).stat().st_size / 1e6
    print(f"wrote {out_path} ({size:.1f} MB, {time.perf_counter() - t0:.1f} s) + sidecar json")
    return program


def load_exported(path: str) -> torch.nn.Module:
    """The saved program as a module (``torch.export.load(path).module()``),
    its parameters frozen; call it under ``torch.no_grad()``."""
    from ..ops import attention, fused_stage  # noqa: F401  (registers the sovits ops)

    module = torch.export.load(path).module()
    return module.requires_grad_(False)


def export_synthesizer_onnx(model_path: str, config_path: str, out_path: str,
                            device: str = "cuda") -> None:
    """The MoeSS-contract ONNX synthesizer and its MoeVS sidecar, loaded and
    run through the port's ONNX runtime on ``device`` before writing."""
    from ..export.onnx_run import run_model
    from ..export.onnx_synth import build_synthesizer_onnx, moevs_config
    from ..infer.svc import Svc

    svc = Svc(model_path, config_path, device=device)
    hps = svc.hps
    chara_mix = len(svc.spk2id) > 1
    data = build_synthesizer_onnx(svc.model, hps, chara_mix=chara_mix)

    t = 16
    feeds = {
        "c": np.zeros((1, t, hps.model.ssl_dim), np.float32),
        "f0": np.full((1, t), 220.0, np.float32),
        "mel2ph": np.arange(1, t + 1, dtype=np.int64)[None],
        "uv": np.ones((1, t), np.float32),
        "noise": np.zeros((1, hps.model.inter_channels, t), np.float32),
        "sid": (np.full((t, hps.model.n_speakers), 1.0 / max(len(svc.spk2id), 1), np.float32)
                if chara_mix else np.zeros((1,), np.int64)),
    }
    if hps.model.vol_embedding:
        feeds["vol"] = np.zeros((1, t), np.float32)
    audio = run_model(data, feeds, device)["audio"]
    assert np.isfinite(audio).all() and audio.shape[-1] > 0

    Path(out_path).write_bytes(data)
    meta = moevs_config(hps, Path(out_path).stem, chara_mix)
    meta["Characters"] = list(svc.spk2id.keys())
    Path(out_path).with_suffix(".json").write_text(json.dumps(meta, indent=2))
    print(f"wrote {out_path} ({len(data) / 1e6:.1f} MB) + MoeVS sidecar json")


def load_unit2mel(model_path: str, config_path: str, device: str = "cuda"):
    """A diffusion model from so-vits-svc's ``model_<step>.pt`` or the JAX
    trainer's ``.npz``; the mel width is read from the checkpoint."""
    from ..convert import from_jax
    from ..train.diffusion import load_diffusion_config, load_npz_unit2mel, load_torch_unit2mel

    args = load_diffusion_config(config_path)
    if model_path.endswith(".npz"):
        tree = from_jax.unflatten_params(dict(np.load(model_path)))
        mel_dims = int(tree["denoiser"]["input_projection"]["kernel"].shape[1])
        return load_npz_unit2mel(model_path, args, mel_dims, device)
    sd = torch.load(model_path, map_location="cpu", weights_only=False)["model"]
    mel_dims = int(sd["decoder.denoise_fn.input_projection.weight"].shape[1])
    return load_torch_unit2mel(model_path, args, mel_dims, device)


def export_diffusion_onnx(model_path: str, config_path: str, out_prefix: str,
                          device: str = "cuda") -> None:
    """The four MoeSS diffusion artifacts ({prefix}_encoder/_denoise/_pred/
    _after.onnx), each loaded and run through the port's ONNX runtime on
    ``device`` before writing."""
    from ..export.onnx_diffusion import build_diffusion_onnx
    from ..export.onnx_run import run_model

    model = load_unit2mel(model_path, config_path, device)
    graphs = build_diffusion_onnx(model)

    t = 8
    n_spk = model.n_spk or 1
    feeds_enc = {
        "hubert": np.zeros((1, t, model.unit_embed.in_features), np.float32),
        "mel2ph": np.arange(1, t + 1, dtype=np.int64)[None],
        "f0": np.full((1, t), 220.0, np.float32),
        "volume": np.zeros((1, t), np.float32),
    }
    if n_spk > 1:
        feeds_enc["spk_mix"] = np.full((t, n_spk), 1.0 / n_spk, np.float32)
    cond = run_model(graphs["encoder"], feeds_enc, device)["mel_pred"]
    noise = np.zeros((1, 1, model.out_dims, t), np.float32)
    tt = np.asarray([1], np.int64)
    pred = run_model(graphs["denoise"], {"noise": noise, "time": tt, "condition": cond},
                     device)["noise_pred"]
    x = run_model(graphs["pred"], {"noise": noise, "noise_pred": pred, "time": tt, "time_prev": tt},
                  device)["noise_pred_o"]
    mel = run_model(graphs["after"], {"x": x}, device)["mel_out"]
    assert np.isfinite(mel).all()

    for suffix, data in graphs.items():
        out = f"{out_prefix}_{suffix}.onnx"
        Path(out).write_bytes(data)
        print(f"wrote {out} ({len(data) / 1e6:.1f} MB)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="export the synthesizer (torch.export .pt2 or ONNX) or the diffusion model (ONNX)"
    )
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("-c", "--config_path", default="configs/config.json")
    parser.add_argument("-o", "--output", default="model.pt2")
    parser.add_argument("--t-frames", type=int, default=512)
    parser.add_argument("--onnx", action="store_true",
                        help="emit a MoeSS-contract ONNX model instead of a .pt2 program")
    parser.add_argument(
        "--diffusion", action="store_true",
        help="export the shallow-diffusion model (-m diffusion ckpt, -c diffusion.yaml); with "
        "--onnx, emits the four MoeSS artifacts {output}_encoder/_denoise/_pred/_after.onnx",
    )
    parser.add_argument("-d", "--device", default="cuda")
    args = parser.parse_args(argv)
    if args.diffusion:
        if not args.onnx:
            raise SystemExit("--diffusion currently requires --onnx")
        prefix = args.output
        for ext in (".onnx", ".pt2"):
            if prefix.endswith(ext):
                prefix = prefix[: -len(ext)]
        export_diffusion_onnx(args.model_path, args.config_path, prefix, args.device)
    elif args.onnx:
        out = args.output
        if out.endswith(".pt2"):
            out = out[: -len(".pt2")] + ".onnx"
        export_synthesizer_onnx(args.model_path, args.config_path, out, args.device)
    else:
        export_synthesizer(args.model_path, args.config_path, args.output, args.t_frames, args.device)


if __name__ == "__main__":
    main()
