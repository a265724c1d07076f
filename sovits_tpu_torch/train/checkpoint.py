"""so-vits-svc checkpoints (counterpart of ``sovits_tpu/train/checkpoint.py``).

``G_{step}.pth`` / ``D_{step}.pth`` hold ``model`` (the state_dict),
``optimizer`` (its state_dict), ``learning_rate`` and ``iteration`` (the
epoch, as so-vits-svc writes it); the step is the number in the file name.
This is the layout the JAX package's ``load_torch_generator`` /
``load_torch_discriminator`` read, so a model trained here loads there.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


def checkpoint_paths(model_dir: str | Path, prefix: str, suffix: str = ".pth") -> list[Path]:
    """``{prefix}_{step}{suffix}`` files in ``model_dir``, by step."""
    found = []
    for p in Path(model_dir).glob(f"{prefix}_*{suffix}"):
        m = re.fullmatch(rf"{prefix}_(\d+){re.escape(suffix)}", p.name)
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def step_of(path: str | Path) -> int:
    return int(Path(path).stem.rsplit("_", 1)[1])


def save_checkpoint(model, optimizer, learning_rate: float, epoch: int, path: str | Path) -> None:
    torch.save({"model": model.state_dict(), "iteration": epoch,
                "optimizer": optimizer.state_dict(), "learning_rate": learning_rate}, path)


def load_checkpoint(path: str | Path, model, optimizer=None) -> int:
    """Load the model (keys missing from the file or of another shape keep
    their current values, with a warning, as so-vits-svc's pretrained
    workflow does) and, when given, the optimizer. Returns the epoch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    saved = ckpt["model"]
    state = model.state_dict()
    for key, value in state.items():
        if key in saved and saved[key].shape == value.shape:
            state[key] = saved[key]
        else:
            logger.warning("%s: %s missing or of another shape; keeping the current value", path, key)
    model.load_state_dict(state)
    if optimizer is not None and "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt.get("iteration", 0))


def clean_checkpoints(model_dir: str | Path, keep: int) -> None:
    """Keep the newest ``keep`` G_/D_ checkpoints of each kind (all if keep <= 0)."""
    if keep <= 0:
        return
    for prefix in ("G", "D"):
        for old in checkpoint_paths(model_dir, prefix)[:-keep]:
            old.unlink()
