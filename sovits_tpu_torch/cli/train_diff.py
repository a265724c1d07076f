"""Diffusion training CLI (counterpart of ``sovits_tpu/cli/train_diff.py``;
so-vits-svc ``train_diff.py``):

    python -m sovits_tpu_torch.cli.train_diff -c configs/diffusion.yaml

The mel width is the vocoder's (``vocoder.config``, else the config.json
beside ``vocoder.ckpt``, else the 44.1 kHz NSF-HiFiGAN's 128), as
so-vits-svc reads it from its vocoder. Runs on the CUDA card unless
``--device`` says otherwise; under ``torchrun --nproc_per_node N`` it trains
data-parallel, one rank per card.
"""

from __future__ import annotations

import argparse
import logging

from ..models.diffusion.vocoder import NsfHifiGANVocoder
from ..parallel.mesh import launch_mesh
from ..train.diffusion import load_diffusion_config, train_diffusion


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", default="./configs/diffusion.yaml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = load_diffusion_config(args.config)
    device, mesh = launch_mesh(args.device)
    voc = cfg.vocoder
    mels = NsfHifiGANVocoder(str(voc.ckpt), voc.config.to_dict() if voc.config else None,
                             device, weights=False).dimension
    return train_diffusion(cfg, max_steps=args.max_steps, vocoder_dim=mels, device=device,
                           mesh=mesh)


if __name__ == "__main__":
    main()
