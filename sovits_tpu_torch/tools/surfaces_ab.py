"""A/B measurements behind three choices of the serving and export surfaces,
each pair taken in one process on the card, with ``chip_smoke.py``'s
full-width fp32 model and harness:

1. host us per K1 launch: the operator defined by ``torch.library.custom_op``
   (a Python autograd wrapper around the kernel) against the
   ``torch.library.Library`` operator the port defines and the direct launch;
2. the 10 s request (``Svc.infer``) on the main thread, on a fresh thread
   each time (what a thread-per-connection server does) and on one
   long-lived worker thread (what ``serving/api.py`` does);
3. the exported synthesizer at 512 frames: traced as it was first written
   (the weight-norm fold in the graph, the whole state), frozen only
   (``cli/export._Infer``), and as ``export_program`` ships it (frozen, no
   no-op casts), against the live ``Synthesizer.infer``: walls in turns,
   one profiled call each, and the aten ops each call dispatches.

    python sovits_tpu_torch/tools/surfaces_ab.py

Run it as a script on a CUDA machine; it prints the card's name and power
limit first and one ``[ab]`` line per measurement.
"""

from __future__ import annotations

import statistics
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parents[2]


def _smoke():
    """``chip_smoke`` (at the root of the repository), whose harness this uses."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def custom_op_dispatch(calls: int = 2000) -> dict:
    """Host us per K1 launch through a ``custom_op`` around the kernel, the
    port's operator and the direct launch, at chip_smoke.dispatch_cost's
    shapes: best of 3 rounds of back-to-back calls, in turns."""
    from sovits_tpu_torch.ops import attention as A

    @torch.library.custom_op("sovits_ab::rel_attention_fwd", mutates_args=())
    def wrapped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_k: torch.Tensor | None,
                rel_v: torch.Tensor | None, key_mask: torch.Tensor | None, drop_mask: torch.Tensor | None,
                window: int, causal: bool, want_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
        return A._launch_fwd(q, k, v, rel_k, rel_v, key_mask, drop_mask, window, causal, want_lse)

    g = torch.Generator().manual_seed(77)
    q, k, v = (torch.randn(2, 128, 96, generator=g).cuda() for _ in range(3))
    rk, rv = (0.1 * torch.randn(9, 96, generator=g).cuda() for _ in range(2))
    km = torch.ones(2, 128, device="cuda")
    fns = {"custom_op": lambda: wrapped(q, k, v, rk, rv, km, None, 4, False, False),
           "library_op": lambda: A.rel_attention_fwd(q, k, v, rk, rv, km, None, 4, False, False),
           "direct": lambda: A._launch_fwd(q, k, v, rk, rv, km, None, 4, False, False)}
    us = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(3):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            us[name].append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
    return {f"{name}_us": f"{min(v):.2f}" for name, v in us.items()}


def request_threads(svc, rounds: int = 6) -> dict:
    """ms of the fp32 10 s Svc.infer on the main thread, on a fresh thread
    each time and on one worker thread, in turns (after one warm call on
    the worker and one on a fresh thread)."""
    c = _smoke()
    sr = svc.target_sample
    clip = c.bench_signal(c.SECONDS, sr)

    def request() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.infer(0, 0, clip, sr=sr, f0_predictor="dio")
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def fresh_thread() -> float:
        box = {}
        thread = threading.Thread(target=lambda: box.setdefault("ms", request()))
        thread.start()
        thread.join()
        return box["ms"]

    ms = {"main": [], "fresh_thread": [], "one_worker": []}
    with ThreadPoolExecutor(max_workers=1) as worker:
        worker.submit(request).result()
        fresh_thread()
        for _ in range(rounds):
            ms["main"].append(request())
            ms["fresh_thread"].append(fresh_thread())
            ms["one_worker"].append(worker.submit(request).result())
    return {f"{k}_median_ms": f"{statistics.median(v):.2f}" for k, v in ms.items()} | {
        f"{k}_ms": [f"{x:.1f}" for x in v] for k, v in ms.items()}


class _Unfrozen(torch.nn.Module):
    """The export wrapper as first written: the live model itself, so the
    trace folds every weight norm in the graph and saves the whole state."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, c_, f0, uv, spk, vol=None):
        return self.model.infer(c_, f0, uv, spk, sample_noise=False, vol=vol)[0]


def _aten_ops(fn) -> int:
    """aten ops that reach the dispatcher during one call of fn."""
    seen = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return seen[0]


def exports(svc) -> None:
    from sovits_tpu_torch.cli import export as E

    c = _smoke()
    hps, model = svc.hps, svc.model
    example = E.example_inputs(hps, c.EXPORT_FRAMES, "cuda")
    programs = {}
    for name, build in (("unfrozen", lambda: torch.export.export(_Unfrozen(model), example)),
                        ("frozen_only", lambda: torch.export.export(E._Infer(model), example)),
                        ("shipped", lambda: E.export_program(model, hps, c.EXPORT_FRAMES))):
        t0 = time.perf_counter()
        with torch.no_grad():
            program = build()
        programs[name] = program.module()
        c.log("ab", export=name, export_s=f"{time.perf_counter() - t0:.2f}", state_tensors=len(program.state_dict),
              graph_nodes=sum(n.op == "call_function" for n in program.graph.nodes))
    args = c._synth_inputs(hps, c.EXPORT_FRAMES, seed=90)
    calls = {name: (lambda m=m: m(*args)) for name, m in programs.items()}
    calls["live"] = lambda: model.infer(*args, sample_noise=False)[0]
    with torch.no_grad():
        want = calls["live"]()
        errs = {name: (calls[name]() - want).abs().max().item() for name in programs}
        walls = c._walls(calls, reps=9)
        for name, fn in calls.items():
            c.log("ab", program=name, wall_ms=f"{1e3 * walls[name]:.3f}", profiled=c._kernel_profile(fn),
                  aten_ops=_aten_ops(fn), max_abs_err_vs_live=errs.get(name, 0.0))
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"an exported program differs from the live synthesizer: {errs}")


def main() -> None:
    c = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    c.phase_device()
    c.phase_build()
    c.log("ab", what="K1 host us per launch", **custom_op_dispatch())
    with tempfile.TemporaryDirectory() as tmp:
        svc = c.build_svc(Path(tmp), "cuda")
        c.log("ab", what="fp32 10 s Svc.infer by thread", **request_threads(svc))
        exports(svc)
    c.log("ab", seconds=f"{time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
