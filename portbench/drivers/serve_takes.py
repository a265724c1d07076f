"""Serving vocal takes: one client converts a list of takes one after
another (closed loop), as the infer CLI converts a folder of takes or one
web-UI user works through a queue.

Entry: ``Svc.slice_inference`` with the traffic file's arguments (the
CLI's defaults: slicing at -40 dB, noise scale 0.4, 0.5 s of padding, no
forced clips, no cluster, no diffusion, no enhancer, loudness 1). The
takes come from ``signals``: a pool of ``pool`` takes whose sizes are the
same for every seed, converted in the seed's order, round after round.

Set-up converts every take of the pool once, so every shape the window
meets is planned and every kernel built before it opens. The window then
converts takes until ``--seconds`` have passed; ``audio_s_per_s`` is all
the audio seconds converted soundly over the window's length, ``rtf_p95``
the 95th percentile over those takes of wall time over audio seconds. A
take that raises or comes out unsound counts as failed, and a run with a
failed take is not correct.

What is checked (``check``), on ``check_takes`` of the window's takes drawn
from the seed, the longest among them, as the window converted them (each
take's first conversion is kept until the window closes): the program's
output, and the program's state at two boundaries, ``Svc._run_synth_batch``
(the chunks' features and their converted audio) and the synthesizer's
``infer`` (each dispatch's tensors and the generator's state before it).
The reference follows the program step by step from that state where the
steps cannot be reproduced from the take alone (DIO's f0, the dispatch's
noise), and checks each step by itself:

- ``chunk_input_max_abs``: each chunk's padded audio against the reference slicer's;
- ``join_max_abs``: the take's output against the reference's join of the chunks' audio;
- ``dispatch_mismatch``: chunks whose features or audio are not those of a dispatch row;
- ``units_rel_err``: the chunks' units against the reference ContentVec on the
  reference's 16 kHz resampling of the chunk (worst chunk, relative RMS);
- ``f0_off_share``: share of voiced frames (3 frames inside a phrase) where
  the f0 is unvoiced or more than 50 cents off the pitch the take was made with;
- ``vol_rel_err`` (a volume model): each chunk's volume feature against the reference's;
- ``synth_rel_err``: every dispatch replayed by the reference synthesizer from its
  inputs and generator state; the worst real row's relative RMS error.
"""

from __future__ import annotations

import gc
import inspect
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import flops as flop_count
from portbench import signals, weights
from portbench.reference import audio as ref_audio
from portbench.reference import contentvec, nets


def so_vits_config(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("train", "data", "model", "spk")}


class Recorder:
    """Wraps one Svc's batch step and its synthesizer's ``infer``: counts
    padded frames always, keeps the tensors of a checked take while ``keep``."""

    def __init__(self, svc):
        self.keep = False
        self.items = self.outs = None
        self.dispatches: list[dict] = []
        self.real_frames = self.synth_frames = 0
        batch, infer = svc._run_synth_batch, svc.model.infer
        sig = inspect.signature(infer)

        def run_synth_batch(items, *a, **k):
            outs = batch(items, *a, **k)
            self.real_frames += sum(int(it["n_frames"]) for it in items)
            if self.keep:
                self.items, self.outs = items, outs
            return outs

        def synth_infer(*a, **k):
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            args = {}
            for name, value in bound.arguments.items():
                if sig.parameters[name].kind is inspect.Parameter.VAR_KEYWORD:
                    args.update(value)
                else:
                    args[name] = value
            gen = args.get("generator")
            state = gen.get_state() if self.keep and gen is not None else None
            out = infer(*a, **k)
            self.synth_frames += args["c"].shape[0] * args["c"].shape[1]
            if self.keep:
                self.dispatches.append({**args, "state": state, "audio": out[0]})
            return out

        svc._run_synth_batch = run_synth_batch
        svc.model.infer = synth_infer


def build(run, tmp: Path):
    """The program's Svc with the seed's weights and its speech encoder."""
    from sovits_tpu_torch.encoders.factory import SpeechEncoder
    from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from sovits_tpu_torch.infer.svc import Svc

    cfg, dev = run.cfg, run.device
    (tmp / "config.json").write_text(json.dumps(so_vits_config(cfg)))
    sd = weights.seeded_state_dict(weights.meta(lambda: nets.Synthesizer(cfg)),
                                   weights.subseed(run.seed, "G"), dev)
    torch.save({"model": sd, "iteration": 0}, tmp / "G_0.pth")
    del sd
    run.mark("weights written")
    enc = cfg["speech_encoder"]
    wcfg = Wav2Vec2Config(d_model=enc["d_model"], n_layers=enc["n_layers"], n_heads=enc["n_heads"],
                          ffn_dim=enc["ffn_dim"], conv_layers=tuple(map(tuple, enc["conv_layers"])),
                          output_layer=enc["output_layer"], pos_conv_kernel=enc["pos_conv_kernel"],
                          pos_conv_groups=enc["pos_conv_groups"])
    with torch.device(dev):
        net = Wav2Vec2Encoder(wcfg)
    net.load_state_dict(weights.seeded_state_dict(weights.meta(lambda: contentvec.ContentVec(enc)),
                                                  weights.subseed(run.seed, "encoder"), dev))
    run.mark("encoder built")
    with torch.device(dev):  # the synthesizer's modules made on the card, not moved there
        return Svc(str(tmp / "G_0.pth"), str(tmp / "config.json"),
                   encoder=SpeechEncoder(enc["name"], net, dev), device=dev)


def takes(run) -> list[signals.Clip]:
    t = run.traffic
    layouts = signals.take_layouts(t["pool"], *t["take_seconds"], phrase_s=t["phrase_seconds"],
                                   gap_s=t["gap_seconds"])
    return signals.synthesize(layouts, weights.subseed(run.seed, "takes"), run.device,
                              run.cfg["model"]["n_speakers"], pitch_hz=t["pitch_hz"])


def convert(svc, clip, t: dict) -> np.ndarray:
    return svc.slice_inference(clip.audio, signals.SR, clip.speaker, t["tran"], slice_db=t["slice_db"],
                               noice_scale=t["noice_scale"], pad_seconds=t["pad_seconds"],
                               clip_seconds=t["clip_seconds"], lg_num=t["lg_num"],
                               f0_predictor=t["f0_predictor"])


def unsound(out, want: int) -> str:
    """What is off in a converted take's length (``want``, so-vits-svc's
    piece by piece), finiteness or level ("" if nothing)."""
    out = np.asarray(out)
    if out.shape != (want,):
        return f"length {out.shape} for {want}"
    if not np.isfinite(out).all():
        return f"{int((~np.isfinite(out)).sum())} samples not finite"
    rms, peak = float(np.sqrt(np.mean(out.astype(np.float64) ** 2))), float(np.abs(out).max())
    if not (1e-4 < rms and peak <= 1.0):
        return f"level: rms {rms}, peak {peak}"
    return ""


def synced(spent: dict, key: str, fn):
    """``fn`` with its host seconds between synchronises added to ``spent[key]``."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def call(*a, **k):
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{key}"):
            out = fn(*a, **k)
        sync()
        spent[key] += time.perf_counter() - t0
        return out
    return call


def window(run, svc, rec: Recorder, clips, order) -> tuple[list, dict, dict, list]:
    """Convert takes until ``seconds`` have passed. Returns each completed
    take's (audio s, wall s), each take's first capture, the spans, and
    each take's output (or why it raised), judged once the window has closed."""
    t = run.traffic
    spans = {"frontend": 0.0, "synth": 0.0, "chunk_samples": []}
    if run.trace:
        prepare = svc._prepare_chunk

        def prepare_counted(speaker, tran, wav, *a, **k):
            spans["chunk_samples"].append(len(wav))
            return prepare(speaker, tran, wav, *a, **k)

        svc._prepare_chunk = synced(spans, "frontend", prepare_counted)
        svc._run_synth_batch = synced(spans, "synth", svc._run_synth_batch)
    seconds = min(run.seconds, t["trace_seconds"]) if run.trace else run.seconds
    done, captures, outputs = [], {}, []
    start = time.perf_counter()
    i = 0
    while True:
        k = order[i % len(order)]
        i += 1
        rec.keep = k not in captures
        rec.dispatches = []
        t1 = time.perf_counter()
        try:
            with torch.profiler.record_function("portbench.take"):
                out = convert(svc, clips[k], t)
        except Exception as exc:  # a failed take counts against the run and is reported
            out = f"raised {type(exc).__name__}: {exc}"
        t2 = time.perf_counter()
        done.append((len(clips[k].audio) / signals.SR, t2 - t1))
        outputs.append((k, out))
        if rec.keep and not isinstance(out, str):
            captures[k] = {"take": k, "out": out, "items": rec.items, "outs": rec.outs,
                           "dispatches": rec.dispatches}
        if t2 - start >= seconds:
            run.window_s = t2 - start
            break
    rec.keep = False
    return done, captures, spans, outputs


def rates(done: list, faults: list, window_s: float) -> tuple[float, float, float]:
    """(audio s, audio_s_per_s, rtf_p95) of a window's takes, each (audio s,
    wall s) with its fault ("" if sound): only sound takes count, as no
    audio came of the others (with none sound, the tail is every take's)."""
    sound = [d for d, fault in zip(done, faults) if not fault]
    audio_s = sum(a for a, _ in sound)
    return audio_s, audio_s / window_s, p95([w / a for a, w in sound or done])


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((got - want).double()) / torch.linalg.vector_norm(want.double()))


class Reference:
    """The plain reference on ``device``, from the seed's weights."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.device = cfg, device
        self.synth = nets.Synthesizer(cfg).to(device).eval()
        self.synth.load_state_dict(weights.seeded_state_dict(
            weights.meta(lambda: nets.Synthesizer(cfg)), weights.subseed(seed, "G"), device))
        self.enc = contentvec.ContentVec(cfg["speech_encoder"]).to(device).eval()
        self.enc.load_state_dict(weights.seeded_state_dict(
            weights.meta(lambda: contentvec.ContentVec(cfg["speech_encoder"])),
            weights.subseed(seed, "encoder"), device))

    @torch.no_grad()
    def replay(self, d: dict) -> torch.Tensor:
        """A dispatch's audio [B, L] from its inputs and its generator's state."""
        gen = torch.Generator(device=self.device)
        gen.set_state(d["state"])
        vol = d.get("vol")
        return self.synth.infer(d["c"].float().transpose(1, 2), d["f0"].float(), d["uv"].float(),
                                d["spk"], d["lengths"], d["noise_scale"], gen,
                                vol=vol.float() if vol is not None else None)[:, 0]

    @torch.no_grad()
    def units(self, chunk: np.ndarray, frames: int) -> torch.Tensor:
        sr = self.cfg["data"]["sampling_rate"]
        u = contentvec.units(self.enc, ref_audio.resample(chunk, sr, 16000), self.device)
        return ref_audio.stretch(u, frames)


def f0_off(it: dict, clip, start: int, pad: int, hop: int, scale: float = 1.0) -> tuple[int, int]:
    """(frames off, frames judged) of one chunk's f0: judged are the frames
    3 frames inside a phrase; off is unvoiced, or more than 50 cents from
    the pitch the take was made with. ``scale`` plants a transposition."""
    n = int(it["n_frames"])
    true = clip.f0_at(start - pad + np.arange(n) * hop, margin=3 * hop)
    ok = ~np.isnan(true)
    f0 = np.asarray(it["f0"], np.float64)[ok] * scale
    cents = 1200 * np.abs(np.log2(np.maximum(f0, 1e-3) / true[ok]))
    return int(np.sum((np.asarray(it["uv"])[ok] < 0.5) | (cents > 50))), int(ok.sum())


def f0_share(run, captures: list, clips, scale: float = 1.0) -> float:
    d = run.cfg["data"]
    pad = int(d["sampling_rate"] * run.traffic["pad_seconds"])
    off = judged = 0
    for cap in captures:
        clip = clips[cap["take"]]
        starts = [a for sil, a, _ in ref_audio.slice_bounds(clip.audio, d["sampling_rate"]) if not sil]
        for it, start in zip(cap["items"] or [], starts):
            o, j = f0_off(it, clip, start, pad, d["hop_length"], scale)
            off, judged = off + o, judged + j
    return off / max(judged, 1)


def check(run, captures: list, clips, ref: Reference) -> dict:
    """The numbers of ``check`` (module docstring), worst over the checked takes."""
    t, d = run.traffic, run.cfg["data"]
    sr, hop = d["sampling_rate"], d["hop_length"]
    pad = int(sr * t["pad_seconds"])
    out = {"chunk_input_max_abs": 0.0, "join_max_abs": 0.0, "dispatch_mismatch": 0,
           "units_rel_err": 0.0, "f0_off_share": 0.0, "synth_rel_err": 0.0}
    vol_model = bool(run.cfg["model"].get("vol_embedding"))
    if vol_model:
        out["vol_rel_err"] = 0.0
    for cap in captures:
        clip = clips[cap["take"]]
        if cap["out"] is None or cap["items"] is None:
            return {k: math.inf for k in out}
        chunks = ref_audio.chunk_inputs(clip.audio, sr, t["pad_seconds"])
        items, outs = cap["items"], cap["outs"]
        if len(items) != len(chunks):
            return {k: math.inf for k in out}
        joined = ref_audio.join(clip.audio, sr, outs, t["pad_seconds"])
        if joined.shape != np.shape(cap["out"]):
            return {k: math.inf for k in out}
        out["join_max_abs"] = max(out["join_max_abs"], float(np.abs(joined - cap["out"]).max()))
        rows = [(dd, r) for dd in cap["dispatches"] for r in range(dd["c"].shape[0])]
        for it, o, chunk in zip(items, outs, chunks):
            n = int(it["n_frames"])
            out["chunk_input_max_abs"] = max(out["chunk_input_max_abs"],
                                             float(np.abs(np.asarray(it["wav"]) - chunk).max()))
            f0 = torch.as_tensor(np.asarray(it["f0"], np.float32))
            c = torch.as_tensor(np.asarray(it["c"], np.float32))
            match = [(dd, r) for dd, r in rows
                     if int(dd["lengths"][r]) == n and torch.equal(dd["f0"][r, :n].float().cpu(), f0)
                     and torch.equal(dd["c"][r, :n].float().cpu(), c)
                     and torch.equal(dd["audio"][r, :n * hop, 0].float().cpu(),
                                     torch.as_tensor(np.asarray(o, np.float32)))]
            out["dispatch_mismatch"] += not match
            want_u = ref.units(chunk, len(chunk) // hop)
            if want_u.shape[0] != n:
                out["dispatch_mismatch"] += 1
                continue
            out["units_rel_err"] = max(out["units_rel_err"], rel_rms(c.to(ref.device), want_u))
            if vol_model:
                want_v = torch.as_tensor(ref_audio.volume(chunk, hop, n))
                out["vol_rel_err"] = max(out["vol_rel_err"],
                                         rel_rms(torch.as_tensor(np.asarray(it["vol"], np.float32)), want_v))
        for dd in cap["dispatches"]:
            got = ref.replay(dd)
            for r in range(dd["c"].shape[0]):
                n = int(dd["lengths"][r]) * hop
                out["synth_rel_err"] = max(out["synth_rel_err"],
                                           rel_rms(dd["audio"][r, :n, 0].float(), got[r, :n]))
    out["f0_off_share"] = f0_share(run, captures, clips)
    return out if captures else {k: math.inf for k in out}


def control(captures: list, clips, ref: "Reference", cfg: dict, pad_seconds: float) -> dict:
    """The control's readings: the reference computed in TF32 put in the
    program's place, against the reference in float32, on the same state."""
    hop = cfg["data"]["hop_length"]
    out = {"units_rel_err": 0.0, "synth_rel_err": 0.0}
    for cap in captures:
        for chunk in ref_audio.chunk_inputs(clips[cap["take"]].audio, cfg["data"]["sampling_rate"], pad_seconds):
            frames = len(chunk) // hop
            want = ref.units(chunk, frames)
            with tf32():
                got = ref.units(chunk, frames)
            out["units_rel_err"] = max(out["units_rel_err"], rel_rms(got, want))
        for dd in cap["dispatches"]:
            want = ref.replay(dd)
            with tf32():
                got = ref.replay(dd)
            for r in range(dd["c"].shape[0]):
                n = int(dd["lengths"][r]) * hop
                out["synth_rel_err"] = max(out["synth_rel_err"], rel_rms(got[r, :n], want[r, :n]))
    return out


class tf32:
    """TF32 on for matrix products and cuDNN inside the block."""

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old
        return False


def calibrate(run) -> dict:
    """The readings that set the limits, in one process: the program's and
    the control's on this seed's checked takes, each converted once."""
    with tempfile.TemporaryDirectory() as tmp:
        svc = build(run, Path(tmp))
    clips = takes(run)
    rec = Recorder(svc)
    captures = {}
    for k in range(len(clips)):
        rec.keep, rec.dispatches = True, []
        out = convert(svc, clips[k], run.traffic)
        captures[k] = {"take": k, "out": out, "items": rec.items, "outs": rec.outs,
                       "dispatches": rec.dispatches}
    sample = [captures[k] for k in checked_takes(captures, clips, run.seed, run.traffic["check_takes"])]
    del svc, rec, captures
    gc.collect()
    torch.cuda.empty_cache()
    ref = Reference(run.cfg, run.seed, run.device)
    program = check(run, sample, clips, ref)
    return {"program": program,
            "control": control(sample, clips, ref, run.cfg, run.traffic["pad_seconds"]),
            "f0_a_semitone_up": {"f0_off_share": f0_share(run, sample, clips, 2 ** (1 / 12))}}


def checked_takes(captures: dict, clips, seed: int, n: int) -> list[int]:
    """The takes to check: the longest the window converted, and others
    drawn from the seed among those it converted."""
    done = sorted(captures)
    if not done:
        return []
    longest = max(done, key=lambda k: len(clips[k].audio))
    rest = [k for k in done if k != longest]
    rng = np.random.default_rng(weights.subseed(seed, "check"))
    return [longest] + [rest[i] for i in rng.permutation(len(rest))[: n - 1]]


def run(run) -> None:
    dev = run.device
    with tempfile.TemporaryDirectory() as tmp:
        svc = build(run, Path(tmp))
    run.mark("program built")
    clips = takes(run)
    order = signals.order(len(clips), run.seed)
    run.mark("takes made")
    for clip in clips:  # warm-up: every take of the pool once
        convert(svc, clip, run.traffic)
    run.mark("warm-up done")
    rec = Recorder(svc)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - run.t0
    if run.trace:
        from portbench.harness import Profiled

        with Profiled() as prof:
            done, captures, spans, outputs = window(run, svc, rec, clips, order)
        run.trace_events = prof.events()
    else:
        done, captures, spans, outputs = window(run, svc, rec, clips, order)
    lengths, faults = {}, []
    for k, out in outputs:
        if k not in lengths:
            lengths[k] = ref_audio.out_length(clips[k].audio, signals.SR)
        faults.append(out if isinstance(out, str) else unsound(out, lengths[k]))
        run.attempted += 1
        run.failed += bool(faults[-1])
        if faults[-1] and run.failed <= 5:
            run.notes.append(f"take {k} failed: {faults[-1]}")
    del outputs
    audio_s, rate, tail = rates(done, faults, run.window_s)
    run.e2e = {"setup_s": setup_s, "audio_s_per_s": rate, "rtf_p95": tail}
    if dev == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    run.layer.update(spans=spans, audio_s=audio_s, real_frames=rec.real_frames,
                     synth_frames=rec.synth_frames, takes=len(done))
    if run.trace:
        run.layer["model_flops"] = flop_count.serving_flops(run.cfg, spans["chunk_samples"])
    sample = checked_takes(captures, clips, run.seed, run.traffic["check_takes"])
    captures = [captures[k] for k in sample]
    del svc, rec
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    run.mark("window closed")
    numbers = check(run, captures, clips, Reference(run.cfg, run.seed, dev))
    run.mark("check done")
    for name, value in numbers.items():
        run.compare(name, value)
