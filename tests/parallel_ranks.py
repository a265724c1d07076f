"""The ranks of tests/test_torch_parallel.py: four CPU processes over gloo.

This module imports torch and the port only, never JAX: spawned ranks
import it, and the test module holds their results, written to files,
against references it computes once. Builders shared with the test (the
tiny training config, seeded nets, the global batch, the diffusion corpus)
live here so both sides make the same objects.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
# the generator of test_torch_modules.py::test_generator_with_fused_trio_stages: its
# stages of width 128 and 64 run the fused trio (its plain version on the CPU)
DECODER_KW = dict(sampling_rate=8000, inter_channels=24, upsample_rates=(8, 2),
                  upsample_kernel_sizes=(16, 4), upsample_initial_channel=256, gin_channels=16)
DECODE_FRAMES = WORLD * 24
NOISE_SEED = 7
UNVOICED = (30, 45)  # frames with f0 = 0 in the noise-on decode
# tests/tiny.py's TINY_OVERRIDES with test_torch_train.py's TRAIN_OVERRIDES
GAN_OVERRIDES = {
    "train.segment_size": 256, "train.batch_size": WORLD, "data.sampling_rate": 8000,
    "data.filter_length": 128, "data.hop_length": 64, "data.win_length": 128,
    "data.n_mel_channels": 20, "data.mel_fmax": 4000, "data.pad_to_frames": 16,
    "model.inter_channels": 16, "model.hidden_channels": 16, "model.filter_channels": 32,
    "model.n_layers": 2, "model.upsample_rates": [4, 4, 4], "model.upsample_kernel_sizes": [8, 8, 8],
    "model.upsample_initial_channel": 32, "model.gin_channels": 16, "model.ssl_dim": 24,
    "model.n_speakers": 4, "model.n_flow_layer": 2, "model.disc_tiny": True,
    "model.use_automatic_f0_prediction": True, "train.log_interval": 1,
}
LENGTHS = (16, 11, 14, 8)  # the global batch's rows differ in length
FSDP_MIN_SIZE = 16
DIFF_MELS = 16


def decode_inputs() -> dict:
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1, DECODER_KW["inter_channels"], DECODE_FRAMES)) * 0.3).astype(np.float32)
    f0 = rng.uniform(80, 300, (1, DECODE_FRAMES)).astype(np.float32)
    g = (rng.standard_normal((1, DECODER_KW["gin_channels"], 1)) * 0.2).astype(np.float32)
    f0_unvoiced = f0.copy()
    f0_unvoiced[:, UNVOICED[0] : UNVOICED[1]] = 0.0
    return dict(x=x, f0=f0, g=g, f0_unvoiced=f0_unvoiced)


def gan_hps():
    from sovits_tpu_torch import config as scfg

    return scfg.default_config(**GAN_OVERRIDES)


def gan_nets(hps):
    """Seeded training nets (the trainer's build: plain vocoder convs)."""
    from sovits_tpu_torch.models import factory

    init = torch.Generator().manual_seed(0)
    net_g = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=False), init)
    net_d = factory.init_random_(factory.build_discriminator(hps, "cpu"), init)
    return net_g.train(), net_d.train()


def gan_batch(hps) -> dict:
    rng = np.random.default_rng(7)
    b, t = len(LENGTHS), hps.data.pad_to_frames
    n_freq = hps.data.filter_length // 2 + 1
    mask = (np.arange(t)[None] < np.asarray(LENGTHS)[:, None]).astype(np.float32)
    return dict(
        c=rng.standard_normal((b, t, hps.model.ssl_dim)).astype(np.float32) * mask[..., None],
        f0=rng.uniform(100, 300, (b, t)).astype(np.float32) * mask,
        uv=(rng.random((b, t)) > 0.2).astype(np.float32) * mask,
        spec=np.abs(rng.standard_normal((b, t, n_freq))).astype(np.float32) * mask[..., None],
        spk=np.array([0, 1, 2, 3]),
        lengths=np.array(LENGTHS),
        wav=(rng.standard_normal((b, t * hps.data.hop_length, 1)) * 0.1).astype(np.float32),
    )


def gan_step(net_g, net_d, batch: dict, hps, mesh=None) -> tuple[dict, tuple]:
    """One deterministic train_step; (its metrics as floats, the two optimizers)."""
    from sovits_tpu_torch.train.optim import make_optimizer
    from sovits_tpu_torch.train.step import train_step

    opt_g, opt_d = make_optimizer(net_g.parameters(), hps), make_optimizer(net_d.parameters(), hps)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = train_step(net_g, net_d, opt_g, opt_d, t, hps, deterministic=True, mesh=mesh)
    return {k: float(v) for k, v in metrics.items()}, (opt_g, opt_d)


def grads(net) -> dict:
    """Every gradient as numpy, whole (an FSDP shard is gathered)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in net.named_parameters():
        if p.grad is not None:
            g = p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad
            out[name] = g.detach().numpy().copy()
    return out


def diffusion_config(root: Path):
    import copy

    from sovits_tpu_torch.train.diffusion import DIFFUSION_DEFAULTS, HParams

    cfg = copy.deepcopy(DIFFUSION_DEFAULTS)
    cfg["data"].update(sampling_rate=8000, block_size=64, duration=0.4, encoder_out_channels=24,
                       training_files=str(root / "train.txt"), validation_files="")
    cfg["model"].update(n_layers=2, n_chans=16, n_hidden=16)
    cfg["train"].update(batch_size=WORLD, interval_log=1, interval_val=1000, cache_all_data=True)
    return HParams(**cfg)


def write_diffusion_corpus(root: Path) -> None:
    """Six clips' diffusion artifacts of unequal lengths (numpy only)."""
    rng = np.random.default_rng(5)
    paths = []
    for i, frames in enumerate((40, 55, 70, 48, 62, 90)):
        p = str(root / f"clip{i}.wav")
        f0 = rng.uniform(100, 300, frames).astype(np.float32)
        np.save(p + ".f0.npy", np.stack([f0, np.ones(frames, np.float32)]))
        np.save(p + ".vol.npy", rng.random(frames).astype(np.float32) * 0.3)
        np.save(p + ".mel.npy", rng.uniform(-10, 1, (frames, DIFF_MELS)).astype(np.float32))
        np.save(p + ".soft.npy", rng.standard_normal((24, frames)).astype(np.float32))
        paths.append(p)
    (root / "train.txt").write_text("\n".join(paths) + "\n")


def diffusion_step(root: Path, expdir: Path, mesh=None) -> tuple[float, dict]:
    """One train_diffusion step; (its loss on this rank, the gradients)."""
    from sovits_tpu_torch.train import diffusion

    seen = []
    real = diffusion._loss

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    diffusion._loss = spy
    try:
        model = diffusion.train_diffusion(diffusion_config(root), expdir=expdir, max_steps=1,
                                          vocoder_dim=DIFF_MELS, device="cpu", mesh=mesh)
    finally:
        diffusion._loss = real
    return float(seen[0].detach()), grads(model)


def _rank_linear(rank: int) -> torch.nn.Module:
    """A small module whose weights differ on every rank."""
    torch.manual_seed(100 + rank)
    return torch.nn.Linear(3, 2)


def flat_params(module: torch.nn.Module) -> np.ndarray:
    return torch.cat([p.detach().flatten() for p in module.parameters()]).numpy()


def _shard_slices(t: np.ndarray, rank: int) -> torch.Tensor:
    n = t.shape[-1] // WORLD
    return torch.from_numpy(np.ascontiguousarray(t[..., rank * n : (rank + 1) * n]))


def run(rank: int, root: str) -> None:
    """One rank: the time-sharded decode (noise off and on), a DDP GAN step
    on a (4, 1) mesh, an FSDP GAN step on a (2, 2) mesh, and a DDP
    diffusion step; results to ``root/rank<r>.pt``."""
    import sys

    from torch.distributed.tensor import distribute_tensor
    from torch.nn.parallel import DistributedDataParallel as DDP

    from sovits_tpu_torch.models.nsf_hifigan import Generator
    from sovits_tpu_torch.parallel import (data_sharding, make_mesh, replicate_tree, replicated,
                                           shard_batch, shard_params, tree_shardings)
    from sovits_tpu_torch.parallel.sequence import sharded_decode

    sys.modules["torch.utils.tensorboard"] = None  # TensorBoard is optional; importing it costs ~7 s
    torch.set_num_threads(1)
    root = Path(root)
    mesh = make_mesh(WORLD, 1, "cpu", init_method=f"file://{root / 'store'}", rank=rank,
                     world_size=WORLD)
    out = {}

    dec = Generator(**DECODER_KW, fused_tail=True).eval()
    dec.load_state_dict(torch.load(root / "decoder.pt"), strict=True)
    inp = decode_inputs()
    with torch.no_grad():
        x, g = _shard_slices(inp["x"], rank), torch.from_numpy(inp["g"])
        out["decode"] = sharded_decode(dec, x, _shard_slices(inp["f0"], rank), g).numpy()
        out["decode_noise"] = sharded_decode(dec, x, _shard_slices(inp["f0_unvoiced"], rank), g,
                                             seed=NOISE_SEED).numpy()

    hps = gan_hps()
    batch = gan_batch(hps)
    # the JAX package's placement helpers: rank 0's module everywhere, and
    # P("data") rows as shard_batch takes them
    local = replicate_tree(_rank_linear(rank), mesh)
    out["replicated"] = flat_params(local)
    spec = torch.from_numpy(batch["spec"])
    out["data_sharding_rows"] = bool(torch.equal(
        distribute_tensor(spec, mesh, data_sharding(mesh)).to_local(),
        torch.from_numpy(shard_batch(batch, mesh)["spec"])))
    out["replicated_whole"] = bool(torch.equal(
        distribute_tensor(spec, mesh, replicated(mesh)).to_local(), spec))
    net_g, net_d = gan_nets(hps)
    out["ddp_metrics"], _ = gan_step(DDP(net_g), DDP(net_d), shard_batch(batch, mesh), hps, mesh)
    out["ddp_grads_g"], out["ddp_grads_d"] = grads(net_g), grads(net_d)

    mesh22 = make_mesh(2, 2, "cpu")
    net_g, net_d = gan_nets(hps)
    specs = tree_shardings(net_g, 2, FSDP_MIN_SIZE)
    shard_params(net_g, mesh22, FSDP_MIN_SIZE)
    shard_params(net_d, mesh22, FSDP_MIN_SIZE)
    out["fsdp_metrics"], (opt_g, _) = gan_step(net_g, net_d, shard_batch(batch, mesh22), hps, mesh22)
    out["fsdp_grads_g"], out["fsdp_grads_d"] = grads(net_g), grads(net_d)
    shards = {}
    for name, p in net_g.named_parameters():
        if specs[name] is None:
            continue
        dim = specs[name].dim
        state = opt_g.state[p]
        shards[name] = dict(dim=dim, full=p.shape[dim], placement=str(p.placements[-1]),
                            local=[t.to_local().shape[dim] for t in (p, state["exp_avg"],
                                                                     state["exp_avg_sq"])])
    out["fsdp_shards"] = shards

    out["diffusion_loss"], out["diffusion_grads"] = diffusion_step(root, root / "diff_ddp", mesh)
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


def start(root: Path):
    """Start the four ranks; they run while the caller does other work."""
    return torch.multiprocessing.start_processes(run, args=(str(root),), nprocs=WORLD, join=False,
                                                 start_method="spawn")


def join(root: Path, procs) -> list[dict]:
    """Wait for the ranks (a rank's error is raised here); their results in
    rank order."""
    while not procs.join():
        pass
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def stop(procs) -> None:
    """End any rank still running."""
    for proc in procs.processes:
        if proc.is_alive():
            proc.terminate()
        proc.join()
