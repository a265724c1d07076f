"""Look at ``chip_smoke.py``'s ``[pipeline]`` card-vs-CPU diffusion step in
the smoke's own process: runs the smoke's ``main`` with that comparison
preceded by (a) the smoke's batch on the card six times in place, cuDNN's
deterministic flag off three times and on three times (bitwise equality
with the first repeat), against the CPU in fp32 and in float64, and (b)
32 other batches on ``model_100/200/210.pt``, card against CPU fp32, with
the CPU on its own ReLU branches and on the card's
(``chip_smoke._relu_branches``); and
with (a) again after the shallow-diffusion request's K3 launches, before
and after ``torch.cuda.empty_cache()``. Prints ``[diag]`` lines; needs one
card:

    python sovits_tpu_torch/tools/diffusion_grad_check.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke as c  # noqa: E402
from sovits_tpu_torch.models.diffusion import wavenet  # noqa: E402

ORIG_EMB = wavenet.sinusoidal_pos_emb
STATE = {}


def grads(path, args, examples, dev, gen_seed=9, dtype=torch.float32, sides=None):
    """(loss, {parameter: gradient in float64 on the CPU}, the ReLU record)
    of one training step of the checkpoint at ``path`` on ``examples``, on
    ``dev`` in ``dtype``, its steps and noise from a CPU generator seeded
    ``gen_seed``, on the ReLU branches ``sides`` when given."""
    from sovits_tpu_torch.train import diffusion as tdiff

    wavenet.sinusoidal_pos_emb = lambda t, dim: ORIG_EMB(t, dim).to(dtype)
    try:
        model = tdiff.load_torch_unit2mel(path, args, c._mels(args), dev).to(dtype).train()
        record, _ = c._relu_branches(model, sides)
        batch = {k: (v.to(dtype) if v.is_floating_point() else v)
                 for k, v in tdiff._batch(examples, torch.device(dev)).items()}
        loss = tdiff._loss(model, batch, torch.Generator().manual_seed(gen_seed))
        loss.backward()
        return (loss.item(), {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()},
                record)
    finally:
        wavenet.sinusoidal_pos_emb = ORIG_EMB


def table(card, ref):
    """Per tensor, worst first: (max-abs error over ref's peak, name, max-abs
    error, ref's peak)."""
    rows = sorted((((card[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30)).item(), k,
                   (card[k] - ref[k]).abs().max().item(), ref[k].abs().max().item()) for k in ref)[::-1]
    return rows


def fmt(r):
    return f"{r[1].replace('decoder.denoise_fn.', '')} rel {r[0]:.3e} abs {r[2]:.3e} peak {r[3]:.3e}"


def smoke_batch(where):
    """(a): the smoke's own batch and checkpoint, six times on the card."""
    from sovits_tpu_torch.train import diffusion as tdiff

    config, ckpt = STATE["config"], STATE["ckpt"]
    args = tdiff.load_diffusion_config(config)
    ds = tdiff.DiffusionDataset(args.data.training_files, args)
    rng = np.random.default_rng(4)
    examples = [ds.example(i, rng) for i in range(c.DIFF_CARD_BATCH)]
    if "cpu" not in STATE:
        STATE["cpu"] = grads(ckpt, args, examples, "cpu")
        STATE["cpu64"] = grads(ckpt, args, examples, "cpu", dtype=torch.float64)
        r = table(STATE["cpu"][1], STATE["cpu64"][1])
        print(f"[diag] {where}: cpu32 vs cpu64 worst {fmt(r[0])}; loss {STATE['cpu'][0]:.9f} "
              f"{STATE['cpu64'][0]:.9f}", flush=True)
    ref = STATE["cpu"][1]
    first = None
    for det in (False, False, False, True, True, True):
        torch.backends.cudnn.deterministic = det
        loss, g, _ = grads(ckpt, args, examples, "cuda")
        same = first is not None and all(torch.equal(g[k], first[k]) for k in g)
        first = first or g
        r, r64 = table(g, ref), table(g, STATE["cpu64"][1])
        print(f"[diag] {where}: det {det} loss_rel {abs(loss - STATE['cpu'][0]) / STATE['cpu'][0]:.2e} "
              f"bitwise_as_first {same} worst {fmt(r[0])} | next {fmt(r[1])} | vs64 {fmt(r64[0])}", flush=True)
    torch.backends.cudnn.deterministic = False


def other_batches():
    """(b): 32 other batches and noise seeds on three checkpoints, the CPU
    on its own ReLU branches, then on the card's."""
    from sovits_tpu_torch.train import diffusion as tdiff

    args = tdiff.load_diffusion_config(STATE["config"])
    ds = tdiff.DiffusionDataset(args.data.training_files, args)
    expdir = STATE["ckpt"].parent
    worst_all, replayed_all = [], []
    for name, seeds in (("model_200.pt", range(10, 34)), ("model_100.pt", range(34, 38)),
                        ("model_210.pt", range(38, 42))):
        for s in seeds:
            rng = np.random.default_rng(s)
            idx = rng.permutation(len(ds))[: c.DIFF_CARD_BATCH]
            examples = [ds.example(int(i), rng) for i in idx]
            lc, gc, sides = grads(expdir / name, args, examples, "cuda", gen_seed=s)
            l3, g3, _ = grads(expdir / name, args, examples, "cpu", gen_seed=s)
            _, gr, moved = grads(expdir / name, args, examples, "cpu", gen_seed=s, sides=sides)
            r, rr = table(gc, g3), table(gc, gr)
            worst_all.append(r[0][0])
            replayed_all.append(rr[0][0])
            print(f"[diag] {name} seed {s} loss_rel {abs(lc - l3) / l3:.2e} own branches: worst {fmt(r[0])} "
                  f"| the card's: worst {fmt(rr[0])} | moved {moved}", flush=True)
    for what, w in (("own branches", worst_all), ("the card's branches", replayed_all)):
        print(f"[diag] other batches, {what}: {len(w)}, max worst {max(w):.3e}, "
              f"over 1e-4: {sum(x > 1e-4 for x in w)}", flush=True)


def guarded(*fns):
    """Each of fns in turn; a failure is printed and the smoke goes on."""
    import traceback

    t0 = time.perf_counter()
    for fn in fns:
        try:
            fn()
        except Exception:
            traceback.print_exc()
            print("[diag] FAILED", flush=True)
    print(f"[diag] seconds {time.perf_counter() - t0:.1f}", flush=True)


def main():
    real_cmp, real_train = c.diffusion_card_vs_cpu, c.phase_train

    def cmp(config, ckpt):
        STATE.update(config=config, ckpt=Path(ckpt))
        guarded(lambda: smoke_batch("after train_diff and the release requests"), other_batches)
        return real_cmp(config, ckpt)

    def train(*a, **k):
        guarded(lambda: smoke_batch("after the shallow-diffusion request"), torch.cuda.empty_cache,
                lambda: smoke_batch("after the shallow-diffusion request and empty_cache"))
        return real_train(*a, **k)

    c.diffusion_card_vs_cpu, c.phase_train = cmp, train
    c.PIPELINE_LIMIT_S = 600  # room for the look, which runs inside the phase
    c.main()


if __name__ == "__main__":
    main()
