"""Time the attention backward kernel (K2, ``csrc/rel_attention_bwd.cu``) at
the fp32 training step's shapes, then in bf16 at bench.py's bf16 step's, with
``chip_smoke.py``'s own harness (``times_training_attention``, then
``times_bf16_backward``: CUDA events and the profiler's device time of each
of K2's two passes, beside the plain version's events), so that another
tree of the port (a parent, unpacked anywhere) is timed exactly as this one:

    python sovits_tpu_torch/tools/time_attention_bwd.py [TREE]

TREE (default: this repository) is the directory whose ``sovits_tpu_torch``
is timed. Run it as a script, not with ``-m``: ``-m`` would import this
repository's package first. Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def use_tree(argv: list[str] | None = None):
    """Put TREE (argv[0], default this repository) first for
    ``sovits_tpu_torch``, switch TF32 off, print the card and the tree;
    returns ``chip_smoke``, whose timing functions then time that tree."""
    argv = sys.argv[1:] if argv is None else argv
    tree = Path(argv[0]).resolve() if argv else REPO
    sys.path.insert(0, str(REPO))
    import chip_smoke  # puts REPO first on sys.path; imports no sovits_tpu_torch at module level

    import torch

    if "sovits_tpu_torch" in sys.modules:
        raise SystemExit("sovits_tpu_torch was imported before the tree was chosen: run this as a script")
    sys.path.insert(0, str(tree))
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool times the kernel on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"tree: {tree}", flush=True)
    return chip_smoke


def main(argv: list[str] | None = None) -> dict:
    chip_smoke = use_tree(argv)
    return {**chip_smoke.times_training_attention(), **chip_smoke.times_bf16_backward()}


if __name__ == "__main__":
    main()
