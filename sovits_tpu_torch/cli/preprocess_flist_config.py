"""Write the filelists and config.json of a resampled dataset (counterpart of
``sovits_tpu/cli/preprocess_flist_config.py``; so-vits-svc
``preprocess_flist_config.py``):

    python -m sovits_tpu_torch.cli.preprocess_flist_config --speech_encoder vec768l12

Walks ``dataset/44k/<speaker>``, holds out 2 validation clips per speaker
(the ``random.seed(1234)`` shuffle), and writes the filelists and a config
wired to the speech encoder (``ssl_dim`` and ``gin_channels`` from
``ENCODER_DIMS``) with the ``--vol_aug``, ``--tiny`` and
``--use_transformer_flow`` options and the speaker map. File work only, so
the tool takes no device.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from .. import config as scfg


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_list", default="./filelists/train.txt")
    parser.add_argument("--val_list", default="./filelists/val.txt")
    parser.add_argument("--source_dir", default="./dataset/44k")
    parser.add_argument("--speech_encoder", default="vec768l12")
    parser.add_argument("--vol_aug", action="store_true")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--use_transformer_flow", action="store_true")
    parser.add_argument("--config_out", default="./configs/config.json")
    args = parser.parse_args(argv)

    random.seed(1234)
    spk_map: dict[str, int] = {}
    train, val = [], []
    for idx, spk_dir in enumerate(sorted(p for p in Path(args.source_dir).iterdir() if p.is_dir())):
        spk_map[spk_dir.name] = idx
        paths = sorted(str(p) for p in spk_dir.glob("*.wav"))
        random.shuffle(paths)
        val.extend(paths[:2])
        train.extend(paths[2:])
    random.shuffle(train)

    Path(args.train_list).parent.mkdir(parents=True, exist_ok=True)
    Path(args.train_list).write_text("\n".join(train) + "\n")
    Path(args.val_list).write_text("\n".join(val) + "\n")

    cfg = scfg.tiny_config() if args.tiny else scfg.default_config()
    cfg.data["training_files"] = args.train_list
    cfg.data["validation_files"] = args.val_list
    cfg.model["speech_encoder"] = args.speech_encoder
    ssl = scfg.ENCODER_DIMS.get(args.speech_encoder, 768)
    cfg.model["ssl_dim"] = ssl
    cfg.model["gin_channels"] = min(ssl, 768)  # preprocess_flist_config.py:96-107
    cfg.model["n_speakers"] = len(spk_map)
    cfg.model["use_transformer_flow"] = args.use_transformer_flow
    cfg.train["vol_aug"] = args.vol_aug
    cfg.model["vol_embedding"] = args.vol_aug
    cfg["spk"] = scfg.HParams(**spk_map)
    scfg.save_config(cfg, args.config_out)
    print(f"wrote {args.config_out} ({len(spk_map)} speakers, {len(train)} train / {len(val)} val)")


if __name__ == "__main__":
    main()
