"""Training: so-vits-svc's GAN steps as the program's ``train()`` loop runs
them (``cli/train.py``): ``train_step`` on ``batch_iterator(FeatureDataset)``
batches, each moved to the card by the trainer's ``_to_device``, with the
step's generator reseeded to ``train.seed + step``, under AdamW at the
first epoch's learning rate.

Set-up writes a seeded corpus under ``TMPDIR`` in the layout
``FeatureDataset`` reads (``<wav>``, ``.soft.npy`` units at the encoder's
50 Hz, ``.f0.npy`` (f0, uv) from the pitch the audio was made with,
``.spec.npy`` from the reference's STFT, ``.vol.npy`` for a volume model),
builds both nets with the seed's weights and their optimizers, and runs the
first three steps: they compile and plan every kernel, and they are the
steps the reference follows. The window then steps until ``--seconds``
have passed; ``train_samples_per_s`` is every row of every step with a
finite loss over the window's length (the card synchronised at its end). A
step with a non-finite loss counts as failed, and a run with a failed step
is not correct.

What is checked, after the window, against the plain reference run from
the same weights on the same three batches with the same generator seeds
(``reference/train.py``):

- ``loss_rel_gap``: each of the three steps' losses (G total, mel, KL,
  feature matching, adversarial, lf0; D total), worst relative gap;
- ``grad_gap``: the first step's gradient of each tensor as the optimizer
  holds it (AdamW's first moment over 1 - beta1), the gap of its norm to
  the reference's over the larger of that norm and the net's median one;
- ``change_gap``: each tensor's change over the three steps, the same way;
- ``data_mismatch``: rows of the three batches that are not a crop of one
  corpus utterance (its units stretched to the f0 frames, its spectrogram,
  volume and audio, scaled alike under volume augmentation), or not
  padded with zeros, or that repeat.

Tensors whose first gradient in the reference is under a thousandth of
their net's median are left out of the last two: they move by round-off
alone (a key's bias under softmax).
"""

from __future__ import annotations

import gc
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile

from portbench import flops as flop_count
from portbench import signals, weights
from portbench.reference import audio as ref_audio
from portbench.reference import nets
from portbench.reference import train as ref_train

LOSSES = ("loss/g/total", "loss/g/mel", "loss/g/kl", "loss/g/fm", "loss/g/gen", "loss/g/lf0",
          "loss/d/total")
CHECKED_STEPS = 3


def hparams(run, filelist: Path):
    from sovits_tpu_torch import config as scfg

    cfg = {k: run.cfg[k] for k in ("train", "data", "model", "spk")}
    hps = scfg.HParams(**cfg)
    hps.train["batch_size"] = run.traffic["batch"]
    hps.data["pad_to_frames"] = run.traffic["frames"]
    hps.data["training_files"] = str(filelist)
    hps.data["validation_files"] = str(filelist)
    return hps


def write_corpus(run, root: Path) -> tuple[Path, list[dict]]:
    """The seeded corpus under ``root``, and each utterance's features."""
    t, d = run.traffic, run.cfg["data"]
    hop, sr = d["hop_length"], d["sampling_rate"]
    rng = np.random.default_rng(signals.STRUCTURE_SEED)
    lengths = [int(math.exp(rng.uniform(math.log(t["utterance_seconds"][0]),
                                        math.log(t["utterance_seconds"][1]))) * sr) // hop * hop
               for _ in range(t["utterances"])]
    speakers = sorted(run.cfg["spk"], key=run.cfg["spk"].get)
    clips = signals.synthesize([(n, [(0, n)]) for n in lengths], weights.subseed(run.seed, "corpus"),
                               run.device, len(speakers), pitch_hz=t["pitch_hz"])
    gen = torch.Generator(device=run.device).manual_seed(weights.subseed(run.seed, "units"))
    ssl = run.cfg["model"]["ssl_dim"]
    out, lines = [], []
    for i, clip in enumerate(clips):
        n = len(clip.audio)
        frames = n // hop
        folder = root / speakers[clip.speaker]
        folder.mkdir(parents=True, exist_ok=True)
        path = str(folder / f"u{i:03d}.wav")
        wavfile.write(path, sr, clip.audio)
        f0 = clip.phrases[0].f0(np.arange(frames) * hop / sr).astype(np.float32)
        np.save(path + ".f0.npy", np.stack([f0, np.ones(frames, np.float32)]))
        n16 = int(np.ceil(n * 16000 / sr))
        units = torch.randn(ssl, (n16 - 400) // 320 + 1, generator=gen, device=run.device)
        np.save(path + ".soft.npy", units.cpu().numpy())
        wav = torch.from_numpy(clip.audio).to(run.device)[None]
        spec = ref_audio.spectrogram(wav, d["filter_length"], hop, d["win_length"])[0]
        np.save(path + ".spec.npy", spec.cpu().numpy())
        vol = ref_audio.volume(clip.audio, hop, frames)
        if run.cfg["model"].get("vol_embedding"):
            np.save(path + ".vol.npy", vol)
        stretched = ref_audio.stretch(units.t(), frames)
        out.append({"f0": f0, "c": stretched.cpu().numpy(), "wav": clip.audio, "vol": vol,
                    "spk": clip.speaker, "frames": frames})
        lines.append(path)
    filelist = root / "train.txt"
    filelist.write_text("\n".join(lines) + "\n")
    return filelist, out


def _norms(tensors) -> torch.Tensor:
    tensors = list(tensors)
    return torch.stack(torch._foreach_norm(tensors)) if tensors else torch.zeros(0)


class Program:
    """The program's training step object: both nets, their optimizers,
    the batch feed and the step's generator."""

    def __init__(self, run, hps):
        from sovits_tpu_torch.models import factory
        from sovits_tpu_torch.train import data, optim, trainer
        from sovits_tpu_torch.train.step import train_step

        dev = run.device
        self.hps, self.dev, self.train_step, self.to_device = hps, dev, train_step, trainer._to_device
        with torch.device(dev):
            self.net_g = factory.build_synthesizer(hps, dev, fused_tail=False)
            self.net_d = factory.build_discriminator(hps, dev)
        self.net_g.load_state_dict(seeded(run, "G"))
        self.net_d.load_state_dict(seeded(run, "D"))
        self.net_g.train()
        self.net_d.train()
        self.optim_g = optim.make_optimizer(self.net_g.parameters(), hps)
        self.optim_d = optim.make_optimizer(self.net_d.parameters(), hps)
        lr = optim.epoch_lr(hps, 1)
        optim.set_learning_rate(self.optim_g, lr)
        optim.set_learning_rate(self.optim_d, lr)
        self.batches = data.batch_iterator(data.FeatureDataset(hps.data.training_files, hps),
                                           hps.train.batch_size, seed=hps.train.seed)
        self.generator = torch.Generator(device=dev)
        self.step_no = 0

    def next_batch(self) -> dict:
        return next(self.batches)

    def step(self, batch: dict) -> dict:
        self.generator.manual_seed(self.hps.train.seed + self.step_no)
        metrics = self.train_step(self.net_g, self.net_d, self.optim_g, self.optim_d,
                                  self.to_device(batch, self.dev), self.hps, generator=self.generator)
        self.step_no += 1
        return metrics

    def named(self):
        return [("G", self.net_g, self.optim_g), ("D", self.net_d, self.optim_d)]

    def close(self):
        self.batches.close()


def seeded(run, net: str) -> dict:
    build = (lambda: nets.Synthesizer(run.cfg)) if net == "G" else ref_train.Discriminator
    return weights.seeded_state_dict(weights.meta(build), weights.subseed(run.seed, net), run.device)


def first_grads(nets_opts, beta1: float) -> dict:
    """Per net: names and the norms of the first gradient as AdamW holds it."""
    out = {}
    for tag, net, opt in nets_opts:
        named = [(n, p) for n, p in net.named_parameters() if p in opt.state]
        out[tag] = ([n for n, _ in named], _norms(opt.state[p]["exp_avg"] for _, p in named) / (1 - beta1))
    return out


def changes(nets_opts, start: dict) -> dict:
    """Per net: names and the norms of each tensor's change since ``start``."""
    out = {}
    for tag, net, _ in nets_opts:
        named = list(net.named_parameters())
        out[tag] = ([n for n, _ in named],
                    _norms(torch._foreach_sub([p.detach() for _, p in named], [start[tag][n] for n, _ in named])))
    return out


def reference_steps(run, hps, batches: list[dict], tf32: bool = False) -> dict:
    """The reference's three steps: losses, first gradients, changes."""
    dev = run.device
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        g = nets.Synthesizer(run.cfg).to(dev).train()
        d = ref_train.Discriminator().to(dev).train()
        start = {"G": seeded(run, "G"), "D": seeded(run, "D")}
        g.load_state_dict(start["G"])
        d.load_state_dict(start["D"])
        opt_g, opt_d = ref_train.adamw(g.parameters(), run.cfg), ref_train.adamw(d.parameters(), run.cfg)
        losses, grads = [], None
        for i, b in enumerate(batches):
            t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            batch = {"c": t["c"].transpose(1, 2), "f0": t["f0"], "uv": t["uv"],
                     "spec": t["spec"].transpose(1, 2), "wav": t["wav"].transpose(1, 2), "spk": t["spk"],
                     "lengths": t["lengths"], "volume": t["volume"]}
            gen = torch.Generator(device=dev).manual_seed(hps.train.seed + i)
            step = ref_train.step(g, d, opt_g, opt_d, batch, run.cfg, gen)
            losses.append({k: float(v.detach()) for k, v in step.items()})
            if i == 0:
                grads = first_grads([("G", g, opt_g), ("D", d, opt_d)], run.cfg["train"]["betas"][0])
        return {"losses": losses, "grads": grads, "changes": changes([("G", g, None), ("D", d, None)], start)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers of the step comparison (module docstring)."""
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-6)
                   for p, r in zip(prog["losses"], ref["losses"]) for k in LOSSES)
    out = {"loss_rel_gap": loss_gap, "grad_gap": 0.0, "change_gap": 0.0}
    for tag in ("G", "D"):
        rg_names, rg = ref["grads"][tag]
        rg = dict(zip(rg_names, rg.double().cpu().tolist()))
        median = float(np.median(list(rg.values())))
        moving = {n for n, v in rg.items() if v >= 1e-3 * median}
        for key, ref_key in (("grad_gap", "grads"), ("change_gap", "changes")):
            names, vals = prog[ref_key][tag]
            got = dict(zip(names, vals.double().cpu().tolist()))
            rn, rv = ref[ref_key][tag]
            want = dict(zip(rn, rv.double().cpu().tolist()))
            if set(got) != set(want):
                out[key] = math.inf
                continue
            med = float(np.median([want[n] for n in moving]))
            out[key] = max([out[key]] + [abs(got[n] - want[n]) / max(want[n], med) for n in moving])
    return out


def data_mismatch(batches: list[dict], corpus: list[dict], hop: int, run) -> int:
    """Rows that are not a sound crop of one corpus utterance, or that repeat."""
    d = run.cfg["data"]
    bad, seen = 0, set()
    for b in batches:
        for r in range(b["f0"].shape[0]):
            n = int(b["lengths"][r])
            f0 = b["f0"][r]
            found = None
            for ui, u in enumerate(corpus):
                if u["spk"] != int(b["spk"][r]) or u["frames"] < n:
                    continue
                for s in np.flatnonzero(u["f0"][: u["frames"] - n + 1] == f0[0]):
                    if np.array_equal(u["f0"][s:s + n], f0[:n]):
                        found = (ui, int(s))
                        break
                if found:
                    break
            if found is None:
                bad += 1
                continue
            u, s = corpus[found[0]], found[1]
            wav = b["wav"][r, : n * hop, 0]
            base = u["wav"][s * hop:(s + n) * hop]
            gain = float(np.abs(wav).max() / max(np.abs(base).max(), 1e-12))
            exact = gain == 1.0
            ok = (np.array_equal(b["uv"][r, :n], np.ones(n, np.float32))
                  and np.array_equal(b["c"][r, :n], u["c"][s:s + n])
                  and np.allclose(wav, base * gain, rtol=1e-5, atol=1e-7)
                  and all(not np.any(b[k][r, n:]) for k in ("c", "f0", "uv", "spec", "volume"))
                  and not np.any(b["wav"][r, n * hop:]))
            if run.cfg["model"].get("vol_embedding"):
                ok = ok and np.allclose(b["volume"][r, :n], u["vol"][s:s + n] * gain, rtol=1e-4, atol=1e-7)
            full = torch.from_numpy(u["wav"] * np.float32(gain)).to(run.device)[None]
            want = ref_audio.spectrogram(full, d["filter_length"], hop, d["win_length"])[0, :, s:s + n].T
            got = torch.from_numpy(b["spec"][r, :n]).to(run.device)
            ok = ok and float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) < \
                (1e-6 if exact else 1e-4)
            key = (found, round(gain, 6))
            ok = ok and key not in seen
            seen.add(key)
            bad += not ok
    return bad


def first_steps(run, prog) -> tuple[dict, float]:
    """The first steps through the window's own call and feed, with what
    the reference follows kept: the batches, the losses, the first
    gradients, the changes. Returns them and the seconds the keeping took."""
    beta1 = run.cfg["train"]["betas"][0]
    captured, check_s = {"losses": [], "batches": []}, 0.0
    start = None
    for i in range(CHECKED_STEPS):
        batch = prog.next_batch()
        metrics = prog.step(batch)
        t1 = time.perf_counter()
        if start is None:
            start = {"G": seeded(run, "G"), "D": seeded(run, "D")}
        captured["batches"].append(batch)
        captured["losses"].append({k: metrics[k].detach() for k in LOSSES})
        if i == 0:
            captured["grads"] = first_grads(prog.named(), beta1)
        if i == CHECKED_STEPS - 1:
            captured["changes"] = changes(prog.named(), start)
        check_s += time.perf_counter() - t1
    return captured, check_s


def release() -> None:
    """Hand the freed program's memory back, so the reference's peak is its own."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def calibrate(run) -> dict:
    """The readings that set the limits, in one process: the program's on
    this seed, the control's (the reference in TF32 in the program's place)
    and the planted faults' (the reference on half of each batch; the state
    left unchanged reads 1 on ``change_gap`` by its definition)."""
    with tempfile.TemporaryDirectory() as tmp:
        filelist, corpus = write_corpus(run, Path(tmp))
        hps = hparams(run, filelist)
        prog = Program(run, hps)
        captured, _ = first_steps(run, prog)
        prog.close()
        del prog
        release()
    captured["losses"] = [{k: float(v) for k, v in s.items()} for s in captured["losses"]]
    ref = reference_steps(run, hps, captured["batches"])
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in captured["batches"]]
    return {"program": gaps(captured, ref),
            "control": gaps(reference_steps(run, hps, captured["batches"], tf32=True), ref),
            "half_batch": gaps(reference_steps(run, hps, half), ref)}


def run(run) -> None:
    dev = run.device
    with tempfile.TemporaryDirectory() as tmp:
        filelist, corpus = write_corpus(run, Path(tmp))
        run.mark("corpus written")
        hps = hparams(run, filelist)
        prog = Program(run, hps)
        run.mark("program built")
        # the first steps: warm-up, and what the reference follows
        captured, check_s = first_steps(run, prog)
        run.mark("first steps done")
        if dev == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - run.t0 - check_s
        losses, lengths, spans = [], [], {"data_wait": 0.0}
        seconds = min(run.seconds, run.traffic["trace_seconds"]) if run.trace else run.seconds

        ends = []

        def window():
            t_start = time.perf_counter()
            while True:
                t1 = time.perf_counter()
                with torch.profiler.record_function("portbench.data_wait"):
                    batch = prog.next_batch()
                spans["data_wait"] += time.perf_counter() - t1
                if run.trace:
                    lengths.append(batch["lengths"].copy())
                with torch.profiler.record_function("portbench.step"):
                    losses.append(prog.step(batch)["loss/g/total"].detach())
                ends.append(time.perf_counter())
                if ends[-1] - t_start >= seconds:
                    break
            if dev == "cuda":
                torch.cuda.synchronize()
            return time.perf_counter() - t_start

        if run.trace:
            from portbench.harness import Profiled

            with Profiled(record_shapes=False) as prof:
                run.window_s = window()
            run.trace_events = prof.events()
        else:
            run.window_s = window()
        steps = len(losses)
        gaps_s = np.diff(ends)
        if len(gaps_s):
            run.notes.append("host s between step launches: p10 %.4f p50 %.4f p90 %.4f max %.4f" % tuple(
                np.quantile(gaps_s, [0.1, 0.5, 0.9]).tolist() + [float(gaps_s.max())]))
        run.attempted = steps
        run.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        run.e2e = {"setup_s": setup_s,
                   "train_samples_per_s": (steps - run.failed) * hps.train.batch_size / run.window_s}
        if dev == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        run.layer.update(spans=spans, steps=steps, lengths=lengths, batch=hps.train.batch_size,
                         frames=hps.data.pad_to_frames)
        if run.trace:
            run.layer["model_flops"] = steps * flop_count.training_flops(
                run.cfg, hps.train.batch_size, hps.data.pad_to_frames)
        captured["losses"] = [{k: float(v) for k, v in s.items()} for s in captured["losses"]]
        prog.close()
        del prog
        release()
        run.mark("window closed")
        ref = reference_steps(run, hps, captured["batches"])
        numbers = gaps(captured, ref)
        numbers["data_mismatch"] = data_mismatch(captured["batches"], corpus, run.cfg["data"]["hop_length"], run)
        run.mark("check done")
    for name, value in numbers.items():
        run.compare(name, value)
