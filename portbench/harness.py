"""What every cell shares: the run's context, loading a cell's files by
name, the profiler window and its reduction (device busy time, idle gaps,
kernels launched inside a host range), the check on loaded modules, and
the result line.

A cell is ``BENCHMARK.json``'s workload: a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``,
whose ``kind`` names ``drivers/<kind>.py``) and the limits its outputs are
held to (``limits/<workload>.json``). A per-layer metric is
``metrics/<name>.py`` with ``read(run) -> float | None``.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sovits_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_module(path: Path, name: str | None = None):
    """Import the file at ``path`` under a name of its own."""
    spec = importlib.util.spec_from_file_location(name or f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


@dataclass
class Run:
    """One run of one cell: what the driver is given and what it reports."""

    workload: dict
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float = field(default_factory=time.perf_counter)
    # filled by the driver
    e2e: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    compared: list = field(default_factory=list)  # (name, value, limit)
    notes: list = field(default_factory=list)  # lines for standard error
    window_s: float = 0.0
    layer: dict = field(default_factory=dict)  # what the per-layer readers read
    trace_events: list | None = None

    def mark(self, what: str) -> None:
        """Note how far into the run a step of set-up ended."""
        self.notes.append(f"{what}: {time.perf_counter() - self.t0:.2f} s into the run")

    def compare(self, name: str, value: float):
        """Hold ``value`` to this cell's limit of that name (larger is worse)."""
        self.compared.append((name, float(value), float(self.limits[name])))

    def judged(self) -> list:
        """Every number that decides ``correct`` with its limit: the failed
        takes or steps (none allowed), then the driver's comparisons."""
        return [("failed", float(self.failed), 0.0)] + self.compared

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(v == v and v <= lim for _, v, lim in self.judged())


class Profiled:
    """A torch.profiler window (host ops with shapes, device activity)
    whose chrome trace is read back once it closes."""

    def __init__(self, record_shapes: bool = True):
        import torch

        self.torch = torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            record_shapes=record_shapes)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def events(self) -> list[dict]:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def device_intervals(events: list[dict]) -> list[tuple[float, float]]:
    """Merged [start, end) microsecond intervals in which the device ran something."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS)
    merged: list[list[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def launched_within(events: list[dict], ranges: list[tuple[int, float, float]]) -> list[list[dict]]:
    """For each host range (thread id, start, end), the device events whose
    launch (a runtime call, matched by its correlation id) lies inside it."""
    runtime = sorted(((e["tid"], e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})))
    by_corr: dict = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "correlation" in e.get("args", {}):
            by_corr.setdefault(e["args"]["correlation"], []).append(e)
    keys = [(t, ts) for t, ts, _ in runtime]
    out = []
    for tid, start, end in ranges:
        lo = bisect.bisect_left(keys, (tid, start))
        hi = bisect.bisect_right(keys, (tid, end))
        out.append([k for _, _, c in runtime[lo:hi] for k in by_corr.get(c, [])])
    return out


def host_ranges(events: list[dict], name: str, cat: str | None = None) -> list[dict]:
    return [e for e in events if e.get("name") == name and (cat is None or e.get("cat") == cat)]


def breakdown(events: list[dict]) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the innermost host range open at its middle."""
    per: dict = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            per[e["name"]] = per.get(e["name"], 0.0) + e["dur"] * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    busy = device_intervals(events)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:])), reverse=True)[:10]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
    named = []
    for dur, mid in gaps:
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = min(inside, key=lambda e: e["dur"])["name"] if inside else "no host range"
        named.append([name, dur * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def busy_s(events: list[dict], start_us: float | None = None, end_us: float | None = None) -> float:
    total = 0.0
    for s, e in device_intervals(events):
        if start_us is not None:
            s, e = max(s, start_us), min(e, end_us)
        total += max(0.0, e - s)
    return total * 1e-6


def cell_files(root: Path, bench: dict, name: str) -> tuple[dict, dict, dict, dict]:
    """(workload, config, traffic, limits) of the cell ``name``."""
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == workload["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    cfg["name"] = conf["name"]
    traffic = json.loads((HERE / "traffic" / f"{workload['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return workload, cfg, traffic, limits


def driver(traffic: dict):
    return load_module(HERE / "drivers" / f"{traffic['kind']}.py", f"portbench_driver_{traffic['kind']}")


def reported(bench: dict, name: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics that cell ``name`` reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def read_layer_metrics(run: Run, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
