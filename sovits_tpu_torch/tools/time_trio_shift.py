"""Time the trio staging microbench kernel (K4, ``csrc/trio_shift.cu``) at
the TPU tool's defaults (C 128, T 55104) with ``chip_smoke.py``'s own
harness (``phase_trio_shift``: the microbench's check and CUDA events, then
the profiler's device time and launch of each variant), so that another
tree of the port (a parent, unpacked anywhere) is timed exactly as this one:

    python sovits_tpu_torch/tools/time_trio_shift.py [TREE]

TREE (default: this repository) is the directory whose ``sovits_tpu_torch``
is timed. Run it as a script, not with ``-m``. Prints the card's name and
power limit first.
"""

from __future__ import annotations


def main(argv: list[str] | None = None) -> list[dict]:
    from time_attention_bwd import use_tree  # beside this script, which runs as a script

    return use_tree(argv).phase_trio_shift()


if __name__ == "__main__":
    main()
