"""Inference CLI (counterpart of ``sovits_tpu/cli/infer.py``), with
so-vits-svc's inference_main.py flags:

  python -m sovits_tpu_torch.cli.infer -m logs/44k/G_0.pth -c configs/config.json \\
      -n raw/song.wav -t 0 -s speaker0 -f0p dio

Each song goes through ``Svc.slice_inference`` and is written as
``results/<name>_<trans>key_<speaker>_sovits_<f0 predictor>.wav`` (``auto``
in place of the key with -a). Runs on the CUDA card unless ``-d`` names
another device. ``-shd`` refines each chunk by shallow diffusion (``-dm``
the diffusion model, ``-dc`` its config, ``-ks`` the depth, ``-se`` a second
encoding of the synthesizer's audio), ``-od`` diffuses from the input alone,
``-eh`` re-vocodes through the NSF-HiFiGAN enhancer (``-eak`` its key).
``-f0p crepe/rmvpe/fcpe`` reach ``get_f0_predictor`` as in the JAX CLI,
which has no flag for their weights: without them the first chunk raises
FileNotFoundError. ``-cm`` names a cluster model (``-cr`` the blend ratio,
``-fr`` feature retrieval), passed to ``Svc`` as the JAX CLI passes it. The
one flag for what the port does not run, the sequence-sharded decode
(``-ss``), stops the program before any model loads.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
from scipy.io import wavfile

from ..infer.svc import Svc
from ..train.data import load_wav


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sovits_tpu_torch inference")
    # core (inference_main.py:19-33)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-c", "--config_path", default="configs/config.json")
    p.add_argument("-cl", "--clip", type=float, default=0)
    p.add_argument("-n", "--clean_names", nargs="+", required=True)
    p.add_argument("-t", "--trans", type=int, nargs="+", default=[0])
    p.add_argument("-s", "--spk_list", nargs="+", default=[0])
    p.add_argument("-a", "--auto_predict_f0", action="store_true")
    p.add_argument("-cm", "--cluster_model_path", default="")
    p.add_argument("-cr", "--cluster_infer_ratio", type=float, default=0)
    p.add_argument("-lg", "--linear_gradient", type=float, default=0)
    p.add_argument("-f0p", "--f0_predictor", default="pm",
                   choices=["pm", "dio", "harvest", "yin", "crepe", "rmvpe", "fcpe"])
    # optional (inference_main.py:35-48)
    p.add_argument("-eh", "--enhance", action="store_true")
    p.add_argument("-shd", "--shallow_diffusion", action="store_true")
    p.add_argument("-usm", "--use_spk_mix", action="store_true")
    p.add_argument("-lea", "--loudness_envelope_adjustment", type=float, default=1)
    p.add_argument("-fr", "--feature_retrieval", action="store_true")
    p.add_argument("-dm", "--diffusion_model_path", default="logs/44k/diffusion/model_0.pt")
    p.add_argument("-dc", "--diffusion_config_path", default="configs/diffusion.yaml")
    p.add_argument("-ks", "--k_step", type=int, default=100)
    p.add_argument("-se", "--second_encoding", action="store_true")
    p.add_argument("-od", "--only_diffusion", action="store_true")
    # misc (inference_main.py:50-57)
    p.add_argument("-sd", "--slice_db", type=int, default=-40)
    p.add_argument("-d", "--device", default="cuda")
    p.add_argument("-ns", "--noice_scale", type=float, default=0.4)
    p.add_argument("-p", "--pad_seconds", type=float, default=0.5)
    p.add_argument("-wf", "--wav_format", default="flac")
    p.add_argument("-lgr", "--linear_gradient_retain", type=float, default=0.75)
    p.add_argument("-eak", "--enhancer_adaptive_key", type=int, default=0)
    p.add_argument("-ft", "--f0_filter_threshold", type=float, default=0.05)
    p.add_argument("-ss", "--seq_shard", type=int, default=0,
                   help="the JAX package's sequence-sharded decode; not supported by the port")
    return p


def unsupported(args) -> list[str]:
    """The flags in ``args`` that ask for what the port does not run."""
    return ["-ss/--seq_shard"] if args.seq_shard != 0 else []


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    bad = unsupported(args)
    if bad:
        raise SystemExit("not supported by the port: " + ", ".join(bad))

    diffusion = args.shallow_diffusion or args.only_diffusion
    svc = Svc(args.model_path, args.config_path, cluster_model_path=args.cluster_model_path or None,
              feature_retrieval=args.feature_retrieval, shallow_diffusion=args.shallow_diffusion,
              only_diffusion=args.only_diffusion,
              diffusion_model_path=args.diffusion_model_path if diffusion else None,
              diffusion_config_path=args.diffusion_config_path, nsf_hifigan_enhance=args.enhance,
              device=args.device)
    out_dir = Path("results")
    out_dir.mkdir(exist_ok=True)
    for name in args.clean_names:
        wav, sr = load_wav(name)
        for tran in args.trans:
            for spk in args.spk_list:
                if args.use_spk_mix:
                    from ..infer.spkmix import EXAMPLE_SPK_MIX_MAP

                    spk = EXAMPLE_SPK_MIX_MAP  # edit infer/spkmix.py's map
                audio = svc.slice_inference(
                    wav.astype(np.float32), sr, spk, tran, slice_db=args.slice_db,
                    cluster_infer_ratio=args.cluster_infer_ratio,
                    auto_predict_f0=args.auto_predict_f0, noice_scale=args.noice_scale,
                    pad_seconds=args.pad_seconds, clip_seconds=args.clip,
                    lg_num=args.linear_gradient, lgr_num=args.linear_gradient_retain,
                    f0_predictor=args.f0_predictor, cr_threshold=args.f0_filter_threshold,
                    k_step=args.k_step, second_encoding=args.second_encoding,
                    loudness_envelope_adjustment=args.loudness_envelope_adjustment,
                    use_spk_mix=args.use_spk_mix, enhancer_adaptive_key=args.enhancer_adaptive_key,
                )
                key = "auto" if args.auto_predict_f0 else f"{tran}key"
                out = out_dir / f"{Path(name).stem}_{key}_{spk}_sovits_{args.f0_predictor}.wav"
                wavfile.write(out, svc.target_sample, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
                print(f"wrote {out}")


if __name__ == "__main__":
    main()
