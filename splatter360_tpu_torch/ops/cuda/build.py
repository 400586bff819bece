"""Build the port's CUDA sources into shared libraries with a plain C ABI.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a on first use into
`csrc/build/` (listed in .gitignore), named by a hash of its source, the
`csrc/` headers it includes and the flags, so a stale library is never
loaded, and bound with ctypes. `build_all` starts one nvcc per source at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("composite_fwd", "composite_bwd", "composite_fwd_unfused", "composite_bwd_unfused")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _source_files(name: str) -> list[Path]:
    """`<name>.cu` and every `csrc/` header it includes, directly or not."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [CSRC / h for h in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)]
    return seen


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(name):
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Compile every source not yet built, all nvcc processes at once.
    Returns the compiler logs (registers, shared memory, spills)."""
    started = {name: _start(name) for name in SOURCES}
    for name, s in started.items():
        _finish(name, s)
    return dict(build_logs)


def load(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        _finish(name, _start(name))
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]
