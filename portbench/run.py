"""Run one cell of the benchmark once and print its result line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``sovits_tpu_torch``)
beside ``portbench/`` and ``BENCHMARK.json``. The cell's files are found by
the names in ``BENCHMARK.json`` (``harness.py`` says where). With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and a ``breakdown``. Standard error ends
with every number that decides ``correct``, each beside its limit; the last
line of standard output is the result as one JSON object.

Exits 2 without a result when the machine has no CUDA card, or fewer than
the cell asks for; 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed places inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)

from portbench import harness  # noqa: E402


def set_host_threads(n: int) -> None:
    """The traffic's host threads for every pool (OpenMP, MKL, OpenBLAS,
    torch's intra-op), set before torch and numpy load."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(n)
    import torch

    torch.set_num_threads(n)


def set_precision() -> None:
    """The configurations' precision: float32 with TF32 off, for matrix
    products and cuDNN alike."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def execute(bench: dict, run: harness.Run) -> dict:
    """Drive the cell and build its result (without the checks on the machine)."""
    set_precision()
    harness.driver(run.traffic).run(run)
    e2e, layer = harness.reported(bench, run.workload["name"])
    if run.trace:
        metrics = harness.read_layer_metrics(run, layer)
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]} for m in e2e}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": None, "count": run.workload["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if run.trace and run.trace_events is not None:
        device["busy_s"] = harness.busy_s(run.trace_events)
        device["window_s"] = run.window_s
        result["breakdown"] = harness.breakdown(run.trace_events)
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in run.judged()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload, cfg, traffic, limits = harness.cell_files(ROOT, bench, args.workload)
    set_host_threads(traffic["host_threads"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"needs {workload['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    run = harness.Run(workload, cfg, traffic, limits, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0=T0)
    run.mark("torch imported")
    result = execute(bench, run)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["device"]["power_limit"] = harness.power_limit()
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    for line in run.notes:
        print(line, file=sys.stderr)
    print(f"card: {result['device']['kind']}, {result['device']['power_limit']}", file=sys.stderr)
    for name, v, lim in run.judged():
        print(f"compared {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'OVER'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
