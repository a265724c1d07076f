"""The training loop (counterpart of ``sovits_tpu/train/trainer.py``;
so-vits-svc ``train.py``): epochs with the per-epoch learning rate,
``metrics.jsonl`` logging, checkpoints and resume, ``max_steps``.

Validation synthesis and TensorBoard images are not ported yet.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

import torch

from .. import config as scfg
from ..models import factory
from . import checkpoint as ckpt
from .data import FeatureDataset, batch_iterator
from .optim import epoch_lr, make_optimizer, set_learning_rate
from .step import train_step

logger = logging.getLogger("sovits_tpu_torch.train")


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}


def train(hps, model_dir: str | Path, max_steps: int | None = None,
          device: torch.device | str = "cuda", on_step=None):
    """Train from ``hps.data.training_files``, resuming from the newest
    ``G_*.pth`` / ``D_*.pth`` in ``model_dir``. ``on_step(step, metrics)``
    is called after every step (metrics as 0-d tensors on the device).
    Returns (net_g, net_d)."""
    device = torch.device(device)
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    scfg.save_config(hps, model_dir / "config.json")
    seed = hps.train.seed
    init = torch.Generator().manual_seed(seed)
    # the trainer decodes through the plain ResBlock1 convs, as the JAX trainer
    # does: the fused trio's backward recomputes the whole tail forward
    net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False), init)
    net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"), init)
    net_g, net_d = net_g.to(device).train(), net_d.to(device).train()
    optim_g = make_optimizer(net_g.parameters(), hps)
    optim_d = make_optimizer(net_d.parameters(), hps)

    step, start_epoch = 0, 1
    g_paths, d_paths = ckpt.checkpoint_paths(model_dir, "G"), ckpt.checkpoint_paths(model_dir, "D")
    if g_paths and d_paths:
        step = ckpt.step_of(g_paths[-1])
        start_epoch = ckpt.load_checkpoint(g_paths[-1], net_g, optim_g) + 1
        ckpt.load_checkpoint(d_paths[-1], net_d, optim_d)
        logger.info("resumed at step %d, epoch %d", step, start_epoch)
    elif hps.train.pretrained_g:
        ckpt.load_checkpoint(hps.train.pretrained_g, net_g)
        if hps.train.pretrained_d:
            ckpt.load_checkpoint(hps.train.pretrained_d, net_d)
        logger.info("loaded pretrained checkpoints")

    dataset = FeatureDataset(hps.data.training_files, hps)
    batch_size = hps.train.batch_size
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    generator = torch.Generator(device=device)
    start_step, t_start = step, time.perf_counter()
    # the data order restarts from hps.train.seed at every start, a resume
    # included, as the JAX trainer's does; the dropout generator is reseeded per step
    with open(model_dir / "metrics.jsonl", "a") as mlog, \
            contextlib.closing(batch_iterator(dataset, batch_size, seed=seed)) as batches:
        for epoch in range(start_epoch, (hps.train.epochs or 1) + 1):
            lr = epoch_lr(hps, epoch)
            set_learning_rate(optim_g, lr)
            set_learning_rate(optim_d, lr)
            for _ in range(steps_per_epoch):
                batch = next(batches)
                generator.manual_seed(seed + step)  # the same draws after a resume
                metrics = train_step(net_g, net_d, optim_g, optim_d, _to_device(batch, device), hps,
                                     generator=generator)
                step += 1
                if on_step is not None:
                    on_step(step, metrics)
                if step % hps.train.log_interval == 0:
                    vals = {k: float(v) for k, v in metrics.items()}
                    vals["learning_rate"] = lr
                    vals["steps_per_sec"] = (step - start_step) / (time.perf_counter() - t_start)
                    mlog.write(json.dumps({"step": step, **vals}) + "\n")
                    mlog.flush()
                    logger.info("step %d: %s", step, {k: round(v, 4) for k, v in vals.items()})
                done = max_steps is not None and step >= max_steps
                if done or step % hps.train.eval_interval == 0:
                    for prefix, net, opt in (("G", net_g, optim_g), ("D", net_d, optim_d)):
                        ckpt.save_checkpoint(net, opt, hps.train.learning_rate, epoch,
                                             model_dir / f"{prefix}_{step}.pth")
                    ckpt.clean_checkpoints(model_dir, hps.train.keep_ckpts or 3)
                if done:
                    return net_g, net_d
            logger.info("epoch %d done (%.1f s)", epoch, time.perf_counter() - t_start)
    return net_g, net_d
