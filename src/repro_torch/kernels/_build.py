"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source exposes a plain C interface and compiles on its
own into a shared library under ``build/repro_torch/`` at the repository
root (or ``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source, the
local headers it includes (``#include "x.cuh"``, followed recursively) and
the flags, at first use, so a changed header builds a new library.  No PyTorch headers are included, so a build takes
seconds.  :func:`build_all` starts one ``nvcc`` per source, all at once.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

__all__ = ["SOURCES", "Built", "build_all", "load", "build_dir", "NVCC_RUNS"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"ax_matmul": CSRC / "ax_matmul.cu", "tuning_sweep": CSRC / "tuning_sweep.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Built(NamedTuple):
    path: Path
    report: str       # nvcc's -Xptxas -v output: registers, shared memory, spills
    seconds: float    # 0.0 when the library was already built


_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
NVCC_RUNS = {"count": 0}   # nvcc processes started in this process


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built with the CUDA toolkit on the machine with the card")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _with_headers(src: Path) -> List[Path]:
    """``src`` and every local header it includes, recursively, in first
    inclusion order."""
    seen: List[Path] = []
    todo = [src.resolve()]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for inc in _LOCAL_INCLUDE.findall(f.read_bytes()):
            h = (f.parent / inc.decode()).resolve()
            if h.exists():
                todo.append(h)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in _with_headers(SOURCES[name]):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, Built]:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together; raises with the compiler's output if one
    fails."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done, running = {}, {}
        for name in names:
            lib = _target(name)
            rep = lib.with_suffix(".ptxas.txt")
            if lib.exists() and rep.exists():
                done[name] = Built(lib, rep.read_text(), 0.0)
                continue
            tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            NVCC_RUNS["count"] += 1
            running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True),
                             tmp, lib, rep, time.perf_counter())
        for name, (proc, tmp, lib, rep, t0) in running.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
            rep.write_text(log)
            os.replace(tmp, lib)
            done[name] = Built(lib, log, secs)
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build_all([name])[name].path))
        return lib
