"""Build a CUDA source of ``csrc/`` with nvcc and bind it with ctypes.

Each kernel source has a plain C interface (no PyTorch headers), so nvcc
takes seconds. The library goes into the package's ``_build/`` (gitignored),
named by a hash of the source, the ``csrc/`` headers it includes and the
flags (``build_key``), at the kernel's first use: nothing is prebuilt and
nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_includes(source: Path) -> List[Path]:
    """The files next to ``source`` that it includes with ``#include "..."``,
    and theirs in turn, each once, in the order first met."""
    seen, todo = [], [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            dep = source.parent / name.decode()
            if dep.exists() and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def build_key(source: Path, flags=NVCC_FLAGS) -> str:
    """Hash of the source, of each header it includes from its directory
    (``local_includes``) and of the flags: a change to any of them names a
    new library."""
    h = hashlib.sha256()
    for path in [source] + local_includes(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def build(source: Path) -> Tuple[Path, float, str]:
    """Compile ``source`` for sm_90a into ``_build/``, named by
    ``build_key``. Returns (library path, build seconds (0 when already
    built), nvcc's output incl. ptxas -v)."""
    key = build_key(source)
    lib = BUILD_DIR / f"{source.stem}_{key[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                       capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{source.name}: nvcc failed (rc {r.returncode})"
                           f":\n{r.stdout}{r.stderr}")
    log.write_text(r.stdout + r.stderr)
    os.replace(tmp, lib)
    return lib, dt, r.stdout + r.stderr


def load(source: Path) -> ctypes.CDLL:
    path, _, _ = build(source)
    return ctypes.CDLL(str(path))
