"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
for Hopper (``sm_90a``) into ``build/sovits_tpu_torch/lib<name>-<hash>.so``
at the repository root, where ``<hash>`` covers the source and the flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing here runs
at import time: the CPU tests import every module, and a machine without
nvcc only fails when a kernel is actually requested.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sovits_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# name -> {C symbol: argtypes}; every symbol returns a cudaError_t as int
SIGNATURES = {
    "rel_attention": {
        "sovits_rel_attention_fwd": [_P] * 7 + [_I] * 5 + [_P],
    },
    "resblock_trio": {
        "sovits_resblock_trio": [_P] * 4 + [_I] * 4 + [_IP] * 3 + [_P],
    },
}


@dataclass
class KernelLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    ptxas_log: str


_LOADED: dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): cannot build the CUDA kernels")


def load(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log = ""
    seconds = 0.0
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    lib = ctypes.CDLL(str(out))
    for sym, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED[name] = KernelLibrary(name, lib, out, seconds, log)
    return _LOADED[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
