"""Release tools for a trained ``G_*.pth`` (counterpart of
``sovits_tpu/cli/tools.py``; so-vits-svc ``compress_model.py`` and
``utils.mix_model``):

    python -m sovits_tpu_torch.cli.tools compress -i logs/44k/G_30400.pth -o release.pth --half
    python -m sovits_tpu_torch.cli.tools mix -i a.pth b.pth -r 50 50 -o mix.pth

- ``compress`` drops the training-only posterior encoder (``enc_q.*``) and
  the optimizer; ``--half`` casts the floating tensors to bfloat16, as the
  JAX package's tool does. ``Svc`` loads the result.
- ``mix`` blends the ``model`` tensors of several checkpoints, convexly
  (softmax of rates / 100, mode 0) or linearly (rates / 100, mode 1), in
  float64, each cast back to its type; the rest of the file is the first
  checkpoint's ("static timbre mixing").

File work on the host, so the tools take no device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def compress(argv=None) -> Path:
    parser = argparse.ArgumentParser(description="compress a checkpoint for release")
    parser.add_argument("-i", "--input", required=True, help="G_*.pth")
    parser.add_argument("-o", "--output", required=True, help="output .pth")
    parser.add_argument("--half", action="store_true", help="cast to bfloat16")
    args = parser.parse_args(argv)

    ckpt = _load(args.input)
    model = {k: v for k, v in ckpt["model"].items() if not k.startswith("enc_q.")}
    if args.half:
        model = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in model.items()}
    torch.save({"model": model, "iteration": ckpt.get("iteration", 0),
                "learning_rate": ckpt.get("learning_rate")}, args.output)
    size = Path(args.output).stat().st_size / 1e6
    print(f"wrote {args.output} ({size:.1f} MB)")
    return Path(args.output)


def mix(argv=None) -> Path:
    parser = argparse.ArgumentParser(description="blend model checkpoints")
    parser.add_argument("-i", "--inputs", nargs="+", required=True)
    parser.add_argument("-r", "--rates", nargs="+", type=float, required=True)
    parser.add_argument("-o", "--output", default="output_mix.pth")
    parser.add_argument("--mode", type=int, default=0, help="0: convex (softmax of rates), 1: linear")
    args = parser.parse_args(argv)
    if len(args.inputs) != len(args.rates):
        parser.error("one rate per input")

    rates = np.asarray(args.rates, np.float64) / 100.0
    if args.mode == 0:
        rates = np.exp(rates) / np.exp(rates).sum()
    ckpts = [_load(p) for p in args.inputs]
    out = ckpts[0]
    out["model"] = {k: sum(float(r) * c["model"][k].double() for r, c in zip(rates, ckpts)).to(v.dtype)
                    for k, v in ckpts[0]["model"].items()}
    torch.save(out, args.output)
    print(f"wrote {args.output}")
    return Path(args.output)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = argv[0] if argv else ""
    if cmd == "compress":
        return compress(argv[1:])
    if cmd == "mix":
        return mix(argv[1:])
    print("usage: python -m sovits_tpu_torch.cli.tools {compress|mix} ...")
    return None


if __name__ == "__main__":
    main()
