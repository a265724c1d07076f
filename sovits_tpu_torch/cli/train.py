"""Training CLI: ``python -m sovits_tpu_torch.cli.train -c config.json -m 44k``.

Flags as so-vits-svc's train.py: -c/--config JSON, -m/--model experiment
name under ./logs/. Runs on the CUDA card unless --device says otherwise.
Under ``torchrun --nproc_per_node N`` it trains data-parallel, one rank per
card (``cuda:LOCAL_RANK``), the batch split over the ranks.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .. import config as scfg
from ..parallel.mesh import launch_mesh
from ..train.trainer import train


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the SVC synthesizer (GAN)")
    parser.add_argument("-c", "--config", default="./configs/config.json")
    parser.add_argument("-m", "--model", required=True, help="experiment name")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    model_dir = Path("./logs") / args.model
    saved = model_dir / "config.json"
    hps = scfg.load_config(saved if saved.exists() and not Path(args.config).exists() else args.config)
    device, mesh = launch_mesh(args.device)
    train(hps, model_dir, max_steps=args.max_steps, device=device, mesh=mesh)


if __name__ == "__main__":
    main()
