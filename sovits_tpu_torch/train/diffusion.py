"""The diffusion model: its configuration, loading and training
(counterpart of ``sovits_tpu/train/diffusion.py``; so-vits-svc
``diffusion/unit2mel.py::load_model_vocoder``, ``train_diff.py``,
``diffusion/solver.py``, ``diffusion/data_loaders.py`` and
``diffusion/logger/saver.py``).

The config schema is so-vits-svc's ``configs_template/diffusion_template
.yaml``, merged over :data:`DIFFUSION_DEFAULTS`. A model loads from a
so-vits-svc checkpoint ({"model": state_dict}) or from the ``.npz`` of
flattened flax params that the JAX package's diffusion trainer writes.
:func:`train_diffusion` writes so-vits-svc's checkpoint,
``model_{step}.pt``, which both loaders read.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import HParams
from ..dsp.audio import repeat_expand
from ..models.diffusion import Unit2Mel
from ..parallel.mesh import data_rank, data_size, rank
from . import checkpoint as ckpt_lib
from .data import load_filelist
from .trainer import MetricsLogger

logger = logging.getLogger("sovits_tpu_torch.train_diff")

DIFFUSION_DEFAULTS = {
    "data": {
        "sampling_rate": 44100,
        "block_size": 512,
        "duration": 2,
        "encoder": "vec768l12",
        "encoder_sample_rate": 16000,
        "encoder_hop_size": 320,
        "encoder_out_channels": 768,
        "training_files": "filelists/train.txt",
        "validation_files": "filelists/val.txt",
        "unit_interpolate_mode": "nearest",
    },
    "model": {
        "type": "Diffusion",
        "n_layers": 20,
        "n_chans": 512,
        "n_hidden": 256,
        "use_pitch_aug": True,
        "timesteps": 1000,
        "k_step_max": 0,
        "n_spk": 1,
    },
    "vocoder": {"type": "nsf-hifigan", "ckpt": "pretrain/nsf_hifigan/model"},
    "infer": {"speedup": 10, "method": "dpm-solver++"},
    "env": {"expdir": "logs/44k/diffusion"},
    "train": {
        "batch_size": 48,
        "epochs": 100000,
        "interval_log": 10,
        "interval_val": 2000,
        "interval_force_save": 5000,
        "lr": 1e-4,
        "decay_step": 100000,
        "gamma": 0.5,
        "weight_decay": 0,
        "cache_all_data": True,
    },
    "spk": {},
}


def load_diffusion_config(path: str | Path) -> HParams:
    """A diffusion config merged over the defaults. JSON text (valid YAML)
    is read with ``json``; other YAML needs PyYAML, and without it this
    raises ImportError."""
    text = Path(path).read_text()
    try:
        loaded = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        loaded = yaml.safe_load(text)
    cfg = copy.deepcopy(DIFFUSION_DEFAULTS)

    def merge(dst, src):
        for k, v in (src or {}).items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(cfg, loaded)
    return HParams(**cfg)


def build_unit2mel(args: HParams, vocoder_dim: int = 128,
                   device: torch.device | str = "cuda") -> Unit2Mel:
    m = args.model
    model = Unit2Mel(
        input_channel=args.data.encoder_out_channels,
        n_spk=m.n_spk,
        use_pitch_aug=bool(m.use_pitch_aug),
        out_dims=vocoder_dim,
        n_layers=m.n_layers,
        n_chans=m.n_chans,
        n_hidden=m.n_hidden,
        timesteps=m.timesteps or 1000,
        k_step_max=m.k_step_max or 0,
    )
    return model.to(device).eval()


def load_torch_unit2mel(path: str | Path, args: HParams, vocoder_dim: int = 128,
                        device: torch.device | str = "cuda") -> Unit2Mel:
    """A so-vits-svc diffusion checkpoint ({"model": state_dict}), loaded
    strictly apart from GaussianDiffusion's schedule buffers
    (``decoder.betas``, ``decoder.spec_min`` ...), which the port recomputes
    from the config."""
    model = build_unit2mel(args, vocoder_dim, device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(_unit2mel_state(ckpt["model"]), strict=True)
    return model


def load_npz_unit2mel(path: str | Path, args: HParams, vocoder_dim: int = 128,
                      device: torch.device | str = "cuda") -> Unit2Mel:
    """The JAX diffusion trainer's ``model_<step>.npz`` (flattened flax
    params), through the weight bridge."""
    from ..convert import from_jax

    model = build_unit2mel(args, vocoder_dim, device)
    tree = from_jax.unflatten_params(dict(np.load(path)))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax.unit2mel(tree).items()},
                          strict=True)
    return model


class DiffusionDataset:
    """The diffusion artifacts of each wav of ``filelist``
    (data_loaders.py:54-287): ``.soft.npy`` units, ``.f0.npy``,
    ``.vol.npy``, ``.mel.npy``, and the optional ``.aug_mel.npy`` /
    ``.aug_vol.npy``. An example is a random ``duration``-second crop padded
    to a fixed frame count; with probability 0.5 it is the aug variant,
    whose f0 is scaled by 2^(keyshift/12). ``example`` draws from its numpy
    generator in the JAX package's order, so one seed gives the same
    examples in both."""

    def __init__(self, filelist: str, args: HParams, cache_all_data: bool | None = None):
        self.paths = load_filelist(filelist)
        self.args = args
        self.hop = args.data.block_size
        self.frames = int(args.data.duration * args.data.sampling_rate / self.hop)
        self.spk_map = dict(args.spk.items() if args.spk else [])
        self.use_aug = bool(args.model.use_pitch_aug)
        # the full-RAM cache (data_loaders.py:127-205, config cache_all_data)
        if cache_all_data is None:
            cache_all_data = bool(args.train.cache_all_data)
        self._cache = {p: self._load(p) for p in self.paths} if cache_all_data else None

    def _load(self, path: str) -> tuple:
        f0, _uv = np.load(path + ".f0.npy", allow_pickle=True)
        f0 = np.asarray(f0, np.float32)
        vol = np.load(path + ".vol.npy").astype(np.float32)
        mel = np.load(path + ".mel.npy").astype(np.float32)  # [T, M]
        units = np.load(path + ".soft.npy").astype(np.float32).T  # [T_u, H]
        aug = None
        if self.use_aug and Path(path + ".aug_mel.npy").exists():
            aug_mel, keyshift = np.load(path + ".aug_mel.npy", allow_pickle=True)
            aug_vol = np.load(path + ".aug_vol.npy").astype(np.float32)
            aug = (np.asarray(aug_mel, np.float32), float(keyshift), aug_vol)
        return f0, vol, mel, units, aug

    def __len__(self):
        return len(self.paths)

    def example(self, index: int, rng: np.random.Generator) -> dict:
        path = self.paths[index]
        f0, vol, mel, units, aug = self._cache[path] if self._cache is not None else self._load(path)
        aug_shift = 0.0
        if aug is not None and rng.random() < 0.5:
            aug_mel, keyshift, aug_vol = aug
            mel, vol = aug_mel, aug_vol
            f0 = f0 * 2 ** (keyshift / 12.0)
            aug_shift = keyshift

        t = min(len(f0), mel.shape[0], len(vol))
        if units.shape[0] != t:
            units = repeat_expand(torch.from_numpy(units), t,
                                  self.args.data.unit_interpolate_mode).numpy()
        f0, vol, mel, units = f0[:t], vol[:t], mel[:t], units[:t]
        if t > self.frames:
            s = rng.integers(0, t - self.frames + 1)
            f0, vol, mel, units = (x[s: s + self.frames] for x in (f0, vol, mel, units))

        def pad(x):
            return np.pad(x, [(0, self.frames - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

        return {"units": pad(units), "f0": pad(f0), "volume": pad(vol), "mel": pad(mel),
                "aug_shift": np.float32(aug_shift),
                "spk": np.int32(self.spk_map.get(Path(path).parent.name, 0))}


def _batch(examples: list[dict], device: torch.device) -> dict:
    batch = {k: torch.from_numpy(np.stack([e[k] for e in examples])) for k in examples[0]}
    batch["spk"] = batch["spk"].long()
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _loss(model: Unit2Mel, batch: dict, generator: torch.Generator,
          batch_rows: tuple[int, int] | None = None) -> torch.Tensor:
    return model(batch["units"], batch["f0"], batch["volume"], spk_id=batch["spk"],
                 aug_shift=batch["aug_shift"], gt_spec=batch["mel"], infer=False,
                 generator=generator, batch_rows=batch_rows)


def staircase_lr(args: HParams, count: int) -> float:
    """The learning rate of the update after ``count`` updates: lr times
    gamma^floor(count / decay_step) (so-vits-svc's StepLR stepped once an
    update; ``optax.exponential_decay(staircase=True)`` in the JAX
    package)."""
    return args.train.lr * args.train.gamma ** (count // args.train.decay_step)


def fresh_unit2mel(args: HParams, vocoder_dim: int, device: torch.device | str) -> Unit2Mel:
    """A Unit2Mel at so-vits-svc's initialisation, drawn from a fixed seed:
    torch's defaults, Kaiming-normal denoiser convs and a zero output
    projection (diffusion/wavenet.py)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_unit2mel(args, vocoder_dim, "cpu")
        denoiser = model.decoder["denoise_fn"]
        for module in denoiser.modules():
            if isinstance(module, torch.nn.Conv1d):
                torch.nn.init.kaiming_normal_(module.weight)
        torch.nn.init.zeros_(denoiser.output_projection.weight)
    return model.to(device)


def train_diffusion(args: HParams, expdir: str | Path | None = None,
                    max_steps: int | None = None, vocoder_dim: int = 128,
                    resume: bool = True, device: torch.device | str = "cuda",
                    mesh=None) -> Unit2Mel:
    """Train Unit2Mel on the preprocessed artifacts of
    ``args.data.training_files`` (so-vits-svc diffusion/solver.py:93-199),
    on one device: AdamW with the staircase decay, the noise-prediction
    loss, an abort on a NaN/Inf loss, ``loss/diffusion`` and
    ``steps_per_sec`` every ``interval_log`` steps, a checkpoint plus the
    validation loss and RTF every ``interval_val`` steps and at the last
    one, ``interval_force_save`` milestones that retention never deletes
    beside the newest ``keep_ckpts``, and a resume from the newest
    ``model_{step}.pt`` in ``expdir`` with its optimizer and data order.

    The data order draws from ``default_rng(1234)`` as the JAX trainer's
    does; each step's diffusion steps and noise from a CPU generator
    seeded with the step. Returns the model.

    ``mesh`` (``parallel.make_mesh``) trains data-parallel, as the JAX
    trainer does over its mesh: the batch is rounded down to a multiple of
    the "data" axis (at least one row a rank), every rank draws the same
    global batch and keeps its rows, the steps and noise are drawn for the
    global batch, the model runs under DDP, the logged loss is the global
    batch's, and rank 0 alone writes checkpoints, logs and validations."""
    device = torch.device(device)
    expdir = Path(expdir or args.env.expdir)
    n_data = data_size(mesh)
    main = rank() == 0
    if main:
        expdir.mkdir(parents=True, exist_ok=True)
    mlog = MetricsLogger(expdir) if main else None
    batch_size = args.train.batch_size
    batch_size = max(batch_size - batch_size % n_data, n_data)
    rows = (data_rank(mesh) * (batch_size // n_data), batch_size)
    dataset = DiffusionDataset(args.data.training_files, args)
    val_files = args.data.validation_files
    val_dataset = (DiffusionDataset(val_files, args, cache_all_data=False)
                   if val_files and Path(val_files).exists() else None)

    rng = np.random.default_rng(1234)
    dataset.example(0, rng)  # the JAX trainer draws its init example here
    model = fresh_unit2mel(args, vocoder_dim, device).train()
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.train.lr,
                                  weight_decay=args.train.weight_decay or 0.0)
    order, pos, step = rng.permutation(len(dataset)), 0, 0
    found = ckpt_lib.checkpoint_paths(expdir, "model", ".pt") if resume else []
    if found:
        step = ckpt_lib.step_of(found[-1])
        ckpt = torch.load(found[-1], map_location="cpu", weights_only=False)
        model.load_state_dict(_unit2mel_state(ckpt["model"]), strict=True)
        if "optimizer" in ckpt:
            optimizer.load_state_dict(ckpt["optimizer"])
        if "data_state" in ckpt:
            rng.bit_generator.state = ckpt["data_state"]["rng"]
            order, pos = np.asarray(ckpt["data_state"]["order"]), ckpt["data_state"]["pos"]
        logger.info("resumed diffusion training from step %d", step)

    interval_val = args.train.interval_val or 2000
    force_save = args.train.interval_force_save or 0
    keep = int(args.train.keep_ckpts or 3)

    def save(step):
        _save(expdir, step, model, optimizer,
              {"rng": rng.bit_generator.state, "order": order.tolist(), "pos": pos})
        milestone = (lambda s: s % force_save == 0) if force_save else (lambda s: s == 0)
        for p in ckpt_lib.checkpoint_paths(expdir, "model", ".pt")[:-keep]:
            if not milestone(ckpt_lib.step_of(p)):
                p.unlink()

    @torch.no_grad()
    def validate(step):
        if val_dataset is None:
            return
        vrng, gen = np.random.default_rng(0), torch.Generator()
        losses = []
        for i in range(min(len(val_dataset), 8)):
            gen.manual_seed(0)  # the same noise for every example and every validation
            losses.append(float(_loss(model, _batch([val_dataset.example(i, vrng)], device), gen)))
        rtf = measure_rtf(model, val_dataset, args, n_clips=1)
        mlog.scalars(step, {"loss/val_diffusion": float(np.mean(losses)), "val_rtf": rtf})

    start_step, t0 = step, time.perf_counter()
    gen = torch.Generator()
    step_model = model
    if mesh is not None:
        from torch.nn.parallel import DistributedDataParallel

        step_model = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None, broadcast_buffers=False)
    try:
        while max_steps is None or step < max_steps:
            idxs = []
            while len(idxs) < batch_size:
                if pos >= len(order):
                    order, pos = rng.permutation(len(dataset)), 0
                idxs.append(order[pos])
                pos += 1
            examples = [dataset.example(i, rng) for i in idxs]
            batch = _batch(examples[rows[0] : rows[0] + batch_size // n_data], device)
            for group in optimizer.param_groups:
                group["lr"] = staircase_lr(args, step)
            gen.manual_seed(1234 + step)
            loss = _loss(step_model, batch, gen, rows)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            step += 1
            loss = loss.detach().clone()
            if n_data > 1:
                dist.all_reduce(loss, group=mesh["data"].get_group())
                loss = loss / n_data
            loss_val = float(loss)
            if not np.isfinite(loss_val):
                raise RuntimeError(f"NaN/Inf loss at step {step}: aborting (solver.py:136)")
            if not main:
                continue
            if step % (args.train.interval_log or 10) == 0:
                rate = (step - start_step) / (time.perf_counter() - t0)  # this run's steps only
                mlog.scalars(step, {"loss/diffusion": loss_val, "steps_per_sec": rate})
            at_end = max_steps is not None and step >= max_steps
            if step % interval_val == 0 or at_end:
                save(step)
                model.eval()
                validate(step)
                model.train()
            elif force_save and step % force_save == 0:
                save(step)
    finally:
        if mlog is not None:
            mlog.close()
    if mesh is not None:  # the checkpoints are on disk for every rank
        dist.barrier()
    return model


# GaussianDiffusion's buffers (so-vits-svc diffusion/diffusion.py:88-115),
# which its strict load_state_dict expects in a checkpoint
_SCHEDULE_BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                     "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
                     "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                     "posterior_variance", "posterior_log_variance_clipped",
                     "posterior_mean_coef1", "posterior_mean_coef2")


def _schedule_buffers(model: Unit2Mel) -> dict[str, torch.Tensor]:
    s = model.schedule
    ac = s.alphas_cumprod
    ac_prev = np.append(1.0, ac[:-1])
    tables = {"betas": s.betas, "alphas_cumprod": ac, "alphas_cumprod_prev": ac_prev,
              "sqrt_alphas_cumprod": np.sqrt(ac), "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - ac),
              "log_one_minus_alphas_cumprod": np.log(1.0 - ac),
              "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / ac),
              "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / ac - 1.0),
              "posterior_variance": s.posterior_variance,
              "posterior_log_variance_clipped": s.posterior_log_variance,
              "posterior_mean_coef1": s.posterior_mean_coef1,
              "posterior_mean_coef2": s.posterior_mean_coef2}
    out = {f"decoder.{k}": torch.tensor(tables[k], dtype=torch.float32) for k in _SCHEDULE_BUFFERS}
    out["decoder.spec_min"] = torch.full((1, 1, 1), s.spec_min)
    out["decoder.spec_max"] = torch.full((1, 1, 1), s.spec_max)
    return out


def _unit2mel_state(sd: dict) -> dict:
    """A checkpoint's ``model`` entry without GaussianDiffusion's buffers,
    which the port recomputes from the config."""
    return {k: v.float() for k, v in sd.items()
            if not k.startswith("decoder.") or k.startswith("decoder.denoise_fn.")}


def _save(expdir: Path, step: int, model: Unit2Mel, optimizer=None, data_state=None) -> Path:
    """so-vits-svc's diffusion checkpoint (logger/saver.py:102-117),
    ``model_{step}.pt`` = {"global_step", "model", "optimizer"}, the model's
    state with the schedule's buffers, and the data order to resume."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    payload = {"global_step": step, "model": {**state, **_schedule_buffers(model)}}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    if data_state is not None:
        payload["data_state"] = data_state
    path = expdir / f"model_{step}.pt"
    torch.save(payload, path)
    return path


@torch.no_grad()
def measure_rtf(model: Unit2Mel, dataset: DiffusionDataset, args: HParams, n_clips: int = 3) -> float:
    """Validation RTF (diffusion/solver.py:54-59): shallow diffusion of
    ``n_clips`` examples at k_step min(100, timesteps) with the config's
    sampler, seconds of compute per second of audio."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    rtfs = []
    for i in range(min(n_clips, len(dataset))):
        ex = dataset.example(i, rng)
        seconds = len(ex["f0"]) * args.data.block_size / args.data.sampling_rate
        batch = _batch([ex], device)
        t0 = time.perf_counter()
        model(batch["units"], batch["f0"], batch["volume"], spk_id=batch["spk"],
              gt_spec=batch["mel"], infer=True, infer_speedup=args.infer.speedup,
              method=args.infer.method, k_step=min(100, args.model.timesteps or 1000),
              generator=torch.Generator().manual_seed(i))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rtfs.append((time.perf_counter() - t0) / seconds)
    return float(np.mean(rtfs))
