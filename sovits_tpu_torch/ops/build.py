"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
for Hopper (``sm_90a``) into ``build/sovits_tpu_torch/lib<name>-<hash>.so``
at the repository root, where ``<hash>`` covers the source, the headers
(``*.cuh``) beside it and the flags, so an edited source or header is
rebuilt and an unchanged one is reused; the compiler's log (registers and
spills from ``-Xptxas -v``) is kept beside it as ``.log``. Nothing here runs
at import time: the CPU tests import every module, and a machine without
nvcc only fails when a kernel is actually requested. ``load_all`` starts one
nvcc per source at once, so building every kernel takes as long as the
slowest one. The port's WORLD library (``native/``) builds with g++ through
the same helpers.
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
        "sovits_rel_attention_fwd": [_P] * 9 + [_I] * 6 + [_P],
    },
    "rel_attention_bwd": {
        "sovits_rel_attention_bwd": [_P] * 16 + [_I] * 10 + [_P],
    },
    "resblock_trio": {
        "sovits_resblock_trio": [_P] * 5 + [_I] * 4 + [_IP] * 4 + [_I] * 5 + [_P],
    },
    "trio_shift": {
        "sovits_trio_shift": [_P] * 3 + [_I] * 7 + [_P],
    },
}


@dataclass
class KernelLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    ptxas_log: str  # nvcc's output when it was built (-Xptxas -v), read back on reuse


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


def library_path(source: Path, flags) -> Path:
    """``build/sovits_tpu_torch/lib<stem>-<hash of source, headers and flags>.so``."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def start_build(compiler: list[str], source: Path, out: Path):
    """Start ``compiler -o <tmp> source`` in the background; pass the
    result to :func:`finish_build`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([*compiler, "-o", str(tmp), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, source, tmp, out, time.perf_counter()


def log_path(out: Path) -> Path:
    """The compiler log kept beside a built library (``lib<stem>-<hash>.log``)."""
    return out.with_suffix(".log")


def finish_build(pending) -> tuple[float, str]:
    """Wait for a build; move it and its compiler log into place. Returns
    (seconds, compiler log)."""
    proc, source, tmp, out, t0 = pending
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n{log}")
    tmp_log = tmp.with_suffix(".log.tmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path(out))  # the log first: a library in place always has its log
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return time.perf_counter() - t0, log


def bind(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load a built library and type its symbols: {symbol: (argtypes, restype)}."""
    lib = ctypes.CDLL(str(path))
    for sym, (argtypes, restype) in signatures.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_all(names=tuple(SIGNATURES)) -> dict[str, KernelLibrary]:
    """Build (if needed, all nvcc processes at once) and load the kernels."""
    pending = {}
    for name in names:
        source = CSRC / f"{name}.cu"
        out = library_path(source, NVCC_FLAGS)
        if name not in _LOADED and not out.exists():
            pending[name] = start_build([_nvcc(), *NVCC_FLAGS], source, out)
    built = {name: finish_build(p) for name, p in pending.items()}
    for name in names:
        if name in _LOADED:
            continue
        out = library_path(CSRC / f"{name}.cu", NVCC_FLAGS)
        lib = bind(out, {sym: (argtypes, ctypes.c_int) for sym, argtypes in SIGNATURES[name].items()})
        if name in built:
            seconds, log = built[name]
        else:  # reused: its log as it was built, or "" for a library built without one
            seconds, log = 0.0, log_path(out).read_text() if log_path(out).exists() else ""
        _LOADED[name] = KernelLibrary(name, lib, out, seconds, log)
    return {name: _LOADED[name] for name in names}


def load(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return _LOADED[name] if name in _LOADED else load_all((name,))[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
