"""The training loop (counterpart of ``sovits_tpu/train/trainer.py``;
so-vits-svc ``train.py``): epochs with the per-epoch learning rate,
logging (``metrics.jsonl``, and TensorBoard when it imports), validation
synthesis at every ``eval_interval``, checkpoints and resume,
``max_steps``. With a mesh (``parallel.make_mesh``, one process per card
under ``torchrun``) it trains data-parallel: every rank reads the same
batches and takes its rows, both nets run under DDP, and rank 0 alone
writes checkpoints, logs and evaluations.
"""

from __future__ import annotations

import contextlib
import json
import logging
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import config as scfg
from ..dsp.stft import mel_spectrogram
from ..models import factory
from ..parallel.mesh import data_rank, data_size, rank, shard_batch
from ..utils import annotated
from . import checkpoint as ckpt
from .data import FeatureDataset, batch_iterator
from .optim import epoch_lr, make_optimizer, set_learning_rate
from .step import train_step

logger = logging.getLogger("sovits_tpu_torch.train")


class MetricsLogger:
    """A ``metrics.jsonl`` file always, and TensorBoard scalars, audio and
    images when ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: Path):
        log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(log_dir / "metrics.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir=str(log_dir))
        except Exception as exc:  # not installed, or an install that fails to load: optional
            logger.info("TensorBoard off (%s); logging to metrics.jsonl only", exc)
            self.tb = None

    def scalars(self, step: int, values: dict):
        rec = {"step": step, **{k: float(v) for k, v in values.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), step)

    def audio(self, step: int, tag: str, wav: np.ndarray, sr: int):
        if self.tb:
            self.tb.add_audio(tag, wav.reshape(1, -1), step, sample_rate=sr)

    def image(self, step: int, tag: str, matrix: np.ndarray):
        """A spectrogram or f0 curve [F, T] as an RGB image (so-vits-svc's
        plot_spectrogram_to_numpy without matplotlib)."""
        if not self.tb:
            return
        m = np.asarray(matrix, np.float32)
        lo, hi = float(m.min()), float(m.max())
        norm = (m - lo) / (hi - lo + 1e-8)
        # simple 3-stop colormap (dark blue -> teal -> yellow)
        r = np.clip(norm * 2 - 1, 0, 1)
        g = np.clip(norm * 1.5, 0, 1) * 0.9
        b = np.clip(1 - norm, 0.1, 1)
        img = np.stack([r, g, b], axis=0)  # [3, F, T]
        self.tb.add_image(tag, img[:, ::-1], step)  # low freqs at the bottom

    def close(self):
        self.jsonl.close()
        if self.tb:
            self.tb.close()


def _record_git_hash(model_dir: Path) -> None:
    """so-vits-svc's check_git_hash: pin the code revision next to the
    checkpoints, warn when resuming with other code."""
    try:
        cur = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):  # no git, or it hung
        return
    if not cur:
        return
    path = model_dir / "githash"
    if path.exists():
        saved = path.read_text().strip()
        if saved != cur:
            logger.warning("git hash mismatch: saved %s vs current %s", saved[:8], cur[:8])
    else:
        path.write_text(cur)


@annotated("train.to_device")
def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}


def _data_parallel(net: torch.nn.Module, mesh, device: torch.device) -> torch.nn.Module:
    """``net`` under DDP over the whole mesh (ranks along "model" hold the
    same rows, as the JAX trainer replicates its state over the mesh); the
    net itself without a mesh."""
    if mesh is None:
        return net
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(net, device_ids=[device] if device.type == "cuda" else None,
                                   broadcast_buffers=False)


def train(hps, model_dir: str | Path, max_steps: int | None = None,
          device: torch.device | str = "cuda", on_step=None, mesh=None):
    """Train from ``hps.data.training_files``, resuming from the newest
    ``G_*.pth`` / ``D_*.pth`` in ``model_dir``. ``on_step(step, metrics)``
    is called after every step (metrics as 0-d tensors on the device, the
    global batch's). ``mesh`` trains data-parallel over its ranks: the
    batch size must split over its "data" axis. Returns (net_g, net_d),
    the modules without their DDP wrappers."""
    device = torch.device(device)
    model_dir = Path(model_dir)
    n_data = data_size(mesh)
    batch_size = hps.train.batch_size
    assert batch_size % n_data == 0, (batch_size, n_data)
    main = rank() == 0
    if main:
        model_dir.mkdir(parents=True, exist_ok=True)
        scfg.save_config(hps, model_dir / "config.json")
        _record_git_hash(model_dir)
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
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    generator = torch.Generator(device=device)
    step_g, step_d = _data_parallel(net_g, mesh, device), _data_parallel(net_d, mesh, device)
    # a data rank's draws differ from the others': its rank goes into the seed
    rank_seed = data_rank(mesh) << 32
    start_step, t_start = step, time.perf_counter()
    # the data order restarts from hps.train.seed at every start, a resume
    # included, as the JAX trainer's does; the dropout generator is reseeded per step
    logger_cm = contextlib.closing(MetricsLogger(model_dir)) if main else contextlib.nullcontext()
    with logger_cm as mlog, \
            contextlib.closing(batch_iterator(dataset, batch_size, seed=seed)) as batches:
        for epoch in range(start_epoch, (hps.train.epochs or 1) + 1):
            lr = epoch_lr(hps, epoch)
            set_learning_rate(optim_g, lr)
            set_learning_rate(optim_d, lr)
            for _ in range(steps_per_epoch):
                batch = shard_batch(next(batches), mesh)
                generator.manual_seed(seed + step + rank_seed)  # the same draws after a resume
                metrics = train_step(step_g, step_d, optim_g, optim_d, _to_device(batch, device), hps,
                                     generator=generator, mesh=mesh)
                step += 1
                if on_step is not None:
                    on_step(step, metrics)
                done = max_steps is not None and step >= max_steps
                if main:
                    _log_and_save(hps, model_dir, mlog, step, epoch, lr, metrics, done, start_step,
                                  t_start, (("G", net_g, optim_g), ("D", net_d, optim_d)))
                if done:
                    if mesh is not None:  # the checkpoints are on disk for every rank
                        dist.barrier()
                    return net_g, net_d
            logger.info("epoch %d done (%.1f s)", epoch, time.perf_counter() - t_start)
    return net_g, net_d


def _log_and_save(hps, model_dir: Path, mlog: MetricsLogger, step: int, epoch: int, lr: float,
                  metrics: dict, done: bool, start_step: int, t_start: float, nets: tuple) -> None:
    """Rank 0's work after a step: the metrics every ``log_interval``, the
    checkpoints at every ``eval_interval`` and at the last step, the
    evaluation at every ``eval_interval``."""
    if step % hps.train.log_interval == 0:
        vals = {k: float(v) for k, v in metrics.items()}
        vals["learning_rate"] = lr
        vals["steps_per_sec"] = (step - start_step) / (time.perf_counter() - t_start)
        mlog.scalars(step, vals)
        logger.info("step %d: %s", step, {k: round(v, 4) for k, v in vals.items()})
    evaluate = step % hps.train.eval_interval == 0
    if done or evaluate:
        for prefix, net, opt in nets:
            ckpt.save_checkpoint(net, opt, hps.train.learning_rate, epoch,
                                 model_dir / f"{prefix}_{step}.pth")
        ckpt.clean_checkpoints(model_dir, hps.train.keep_ckpts or 3)
    if evaluate:  # not at a max_steps save off the interval, as in JAX
        _evaluate(hps, nets[0][1], mlog, step)


def _evaluate(hps, net_g, mlog: MetricsLogger, step: int) -> None:
    """Synthesise the first two validation clips (so-vits-svc train.py's
    evaluate) with the prior noise off, up to ``pad_to_frames`` frames each;
    log the audio and each clip's log-mel L1 against its recording. The
    training net decodes (plain ResBlock convs), switched to eval mode for
    the synthesis and back after it."""
    try:
        val = FeatureDataset(hps.data.validation_files, hps, vol_aug=False)
    except FileNotFoundError:
        return
    if len(val) == 0:
        return
    d = hps.data
    mel_kw = dict(n_fft=d.filter_length, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
                  hop_length=d.hop_length, win_length=d.win_length, fmin=d.mel_fmin, fmax=d.mel_fmax)
    device = next(net_g.parameters()).device
    net_g.eval()
    try:
        for i in range(min(2, len(val))):
            item = val.load_utterance(val.paths[i])
            t = min(item["f0"].shape[0], d.pad_to_frames or 800)
            put = lambda x: torch.from_numpy(np.ascontiguousarray(x[None, :t])).to(device)  # noqa: E731
            wav, _ = net_g.infer(put(item["c"]), put(item["f0"]), put(item["uv"]),
                                 torch.tensor([item["spk"]], device=device),
                                 vol=put(item["volume"]) if item["volume"] is not None else None,
                                 sample_noise=False)
            wav = wav[:, :, 0]
            mlog.audio(step, f"gen/audio_{i}", wav[0].cpu().numpy(), d.sampling_rate)
            gt_mel = mel_spectrogram(torch.from_numpy(item["wav"][None, : t * d.hop_length]).to(device),
                                     **mel_kw)
            gen_mel = mel_spectrogram(wav, **mel_kw)
            tmin = min(gt_mel.shape[1], gen_mel.shape[1])
            mel_l1 = float(torch.mean(torch.abs(gt_mel[:, :tmin] - gen_mel[:, :tmin])))
            mlog.scalars(step, {f"eval/mel_l1_{i}": mel_l1})
    finally:
        net_g.train()
