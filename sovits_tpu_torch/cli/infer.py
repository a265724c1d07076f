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
``-fr`` feature retrieval), passed to ``Svc`` as the JAX CLI passes it.

``-ss N`` converts each song whole through ``Svc.infer_seq_parallel``: one
prior/flow pass and one vocoder decode time-sharded over N ranks, no
slicer. Under ``torchrun --nproc_per_node N`` each rank runs on
``cuda:LOCAL_RANK`` and decodes its shard, and rank 0 alone writes the
files; without torchrun the decode runs on one rank. It is the plain VITS
decode only, so -shd, -od, -eh, -usm and -lea other than 1 are refused.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch
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
    p.add_argument(
        "-ss", "--seq_shard", type=int, default=0,
        help="time-shard the vocoder decode over N ranks and run the whole song as one "
        "dispatch (skips the slicer loop). Plain VITS decode only: incompatible with "
        "-shd/-od/-eh/-usm/-lea. Audio within the decoder's receptive field of the song "
        "edges may deviate slightly from the chunked decode (edge-zone contract; see "
        "Svc.infer_seq_parallel)",
    )
    return p


def seq_shard_conflicts(args) -> list[str]:
    """The flags that ``--seq_shard``'s plain VITS decode cannot honour."""
    incompatible = [
        ("--shallow_diffusion", args.shallow_diffusion),
        ("--only_diffusion", args.only_diffusion),
        ("--enhance", args.enhance),
        ("--use_spk_mix", args.use_spk_mix),
        ("--loudness_envelope_adjustment != 1", args.loudness_envelope_adjustment != 1),
    ]
    return [flag for flag, on in incompatible if on]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    writer = True
    device = args.device
    if args.seq_shard:
        # the seq-parallel decode never runs the shallow-diffusion, enhancer or
        # loudness stages or speaker mixes: refuse them instead of dropping them
        bad = seq_shard_conflicts(args)
        if bad:
            raise SystemExit("--seq_shard runs the plain VITS decode only and cannot be "
                             "combined with: " + ", ".join(bad))
        from ..parallel import mesh

        device_type = torch.device(device).type
        if mesh.init_process_group(device_type):  # under torchrun: a rank per card
            device = mesh.local_device(device_type)
            writer = mesh.rank() == 0

    diffusion = args.shallow_diffusion or args.only_diffusion
    svc = Svc(args.model_path, args.config_path, cluster_model_path=args.cluster_model_path or None,
              feature_retrieval=args.feature_retrieval, shallow_diffusion=args.shallow_diffusion,
              only_diffusion=args.only_diffusion,
              diffusion_model_path=args.diffusion_model_path if diffusion else None,
              diffusion_config_path=args.diffusion_config_path, nsf_hifigan_enhance=args.enhance,
              device=device)
    out_dir = Path("results")
    if writer:
        out_dir.mkdir(exist_ok=True)
    for name in args.clean_names:
        wav, sr = load_wav(name)
        for tran in args.trans:
            for spk in args.spk_list:
                if args.use_spk_mix:
                    from ..infer.spkmix import EXAMPLE_SPK_MIX_MAP

                    spk = EXAMPLE_SPK_MIX_MAP  # edit infer/spkmix.py's map
                key = "auto" if args.auto_predict_f0 else f"{tran}key"
                out = out_dir / f"{Path(name).stem}_{key}_{spk}_sovits_{args.f0_predictor}.wav"
                if args.seq_shard:
                    audio, _, _ = svc.infer_seq_parallel(
                        spk, tran, wav.astype(np.float32), sr, n_shards=args.seq_shard,
                        cluster_infer_ratio=args.cluster_infer_ratio,
                        auto_predict_f0=args.auto_predict_f0, noice_scale=args.noice_scale,
                        f0_predictor=args.f0_predictor, cr_threshold=args.f0_filter_threshold,
                    )
                    if writer:
                        wavfile.write(out, svc.target_sample,
                                      (np.clip(audio, -1, 1) * 32767).astype(np.int16))
                        print(f"wrote {out}")
                    continue
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
                wavfile.write(out, svc.target_sample, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
                print(f"wrote {out}")


if __name__ == "__main__":
    main()
