"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``sovits_tpu`` (compared whole: ``sovits_tpu_torch`` is the
program), and the plain reference nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from portbench import harness
from portbench_tiny import tiny_run
for kind in ("serve", "train"):
    run = tiny_run(kind, seconds=0.5, limits=__import__("collections").defaultdict(float))
    harness.driver(run.traffic).run(run)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import flops, peaks, signals, weights
from portbench.reference import audio, contentvec, nets, train
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"))],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_drivers_load_neither_jax_nor_the_jax_package():
    loaded = _loaded(DRIVE)
    assert "sovits_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "sovits_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "sovits_tpu", "sovits_tpu_torch"}
