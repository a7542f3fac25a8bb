"""ctypes bindings for the native (C++) data runtime: record store,
threaded batch gather, shuffler, background prefetcher (counterpart of
pytorch_camvid_tpu/data/native.py over the same ``native/*.cpp``).

The port builds ``native/recordstore.cpp`` and ``native/loader.cpp`` with
``g++ -O3 -shared -fPIC -pthread`` into the package's gitignored
``_build/``, named by a hash of the two sources and the flags (as
``ops/cuda_build.py`` names the kernels), at first use: never when the
module is imported, and never into ``native/``. Every entry point keeps
the JAX module's numpy fallback for a host without a toolchain;
``native_available()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
SOURCES = ("recordstore.cpp", "loader.cpp")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)

_lib = None
_build_error: Optional[str] = None


def build_key() -> str:
    """Hash of the two sources and the flags: a change to any of them
    names a new library."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes()
                 + b"\0")
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()


def build() -> Path:
    """Compile the library into ``_build/`` unless it is there; returns
    its path. Raises RuntimeError when there is no compiler or it fails."""
    lib = BUILD_DIR / f"libcamvid_native_{build_key()[:16]}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                        *(str(NATIVE_DIR / s) for s in SOURCES)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc {r.returncode}):\n{r.stderr}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    sig = {
        "rs_write": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_u8p),
                                    _u64p, ctypes.c_uint64]),
        "rs_open": (ctypes.c_void_p, [ctypes.c_char_p]),
        "rs_count": (ctypes.c_uint64, [ctypes.c_void_p]),
        "rs_length": (ctypes.c_uint64, [ctypes.c_void_p, ctypes.c_uint64]),
        "rs_read": (ctypes.c_uint64, [ctypes.c_void_p, ctypes.c_uint64,
                                      _u8p]),
        "rs_close": (None, [ctypes.c_void_p]),
        "ld_gather": (None, [_u8p, ctypes.c_uint64, _u64p, ctypes.c_uint64,
                             _u8p, ctypes.c_int]),
        "ld_permutation": (None, [ctypes.c_uint64, ctypes.c_uint64, _u64p]),
        "pf_start": (ctypes.c_void_p, [_u8p, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_int]),
        "pf_next": (ctypes.c_uint64, [ctypes.c_void_p, _u8p]),
        "pf_stop": (None, [ctypes.c_void_p]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _load():
    """The bound library, built at the first call; None (the numpy
    fallback) when it cannot be built. A failed build is not retried."""
    global _lib, _build_error
    if _lib is None and _build_error is None:
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
    return _lib


def native_available() -> bool:
    """True when the native library runs, False on the numpy fallback."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native library is not available (None when it is, or
    before the first use)."""
    return _build_error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


# ------------------------------------------------------------ record store

class RecordStore:
    """Single-file mmap record store (the reference's LMDB cache)."""

    @staticmethod
    def write(path: str, records: List[bytes]):
        lib = _load()
        if lib is None:  # numpy fallback: the same file format
            with open(path, "wb") as f:
                f.write(b"CVRS0001")
                f.write(struct.pack("<Q", len(records)))
                off = 16 + 16 * len(records)
                for r in records:
                    f.write(struct.pack("<QQ", off, len(r)))
                    off += len(r)
                for r in records:
                    f.write(r)
            return
        n = len(records)
        bufs = (_u8p * n)()
        lens = (ctypes.c_uint64 * n)()
        keep = []
        for i, r in enumerate(records):
            arr = np.frombuffer(r, np.uint8)
            keep.append(arr)
            bufs[i] = _ptr(arr)
            lens[i] = len(r)
        rc = lib.rs_write(path.encode(), bufs, lens, n)
        if rc != 0:
            raise IOError(f"rs_write failed: {rc}")

    def __init__(self, path: str):
        self._lib = _load()
        self._path = path
        if self._lib is not None:
            self._h = self._lib.rs_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open record store {path}")
            self._n = int(self._lib.rs_count(self._h))
        else:  # numpy fallback reader
            self._mm = np.memmap(path, np.uint8, "r")
            if bytes(self._mm[:8]) != b"CVRS0001":
                raise IOError(f"{path} is not a record store")
            self._n = struct.unpack("<Q", bytes(self._mm[8:16]))[0]
            self._idx = np.frombuffer(bytes(self._mm[16:16 + 16 * self._n]),
                                      np.uint64).reshape(self._n, 2)
            self._h = None

    def __len__(self):
        return self._n

    def __getitem__(self, i: int) -> bytes:
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        if self._h is not None:
            ln = int(self._lib.rs_length(self._h, i))
            out = np.empty(ln, np.uint8)
            got = self._lib.rs_read(self._h, i, _ptr(out))
            if got != ln:
                raise IOError(f"rs_read returned {got} of {ln} bytes")
            return out.tobytes()
        off, ln = (int(v) for v in self._idx[i])
        return bytes(self._mm[off: off + ln])

    def close(self):
        if self._h is not None:
            self._lib.rs_close(self._h)
            self._h = None


# ------------------------------------------------------------------ gather

def gather_batch(data: np.ndarray, indices: np.ndarray,
                 out: Optional[np.ndarray] = None,
                 nthreads: int = 0) -> np.ndarray:
    """Threaded ``out[i] = data[indices[i]]`` over the leading axis.
    ``out``: a C-contiguous array of the batch's shape and dtype (e.g. a
    numpy view of a pinned tensor), or None for a new one."""
    data = np.ascontiguousarray(data)
    idx = np.asarray(indices)
    if idx.size and (idx.min() < 0 or idx.max() >= len(data)):
        raise IndexError(f"gather indices outside [0, {len(data)})")
    shape = (len(idx),) + data.shape[1:]
    if out is None:
        out = np.empty(shape, data.dtype)
    elif (out.shape != shape or out.dtype != data.dtype
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous {data.dtype} {shape}")
    lib = _load()
    if lib is None:
        np.take(data, idx, axis=0, out=out)
        return out
    itemsize = int(np.prod(data.shape[1:])) * data.dtype.itemsize
    idx = np.ascontiguousarray(idx, np.uint64)
    lib.ld_gather(_ptr(data), itemsize, idx.ctypes.data_as(_u64p), len(idx),
                  _ptr(out), nthreads)
    return out


def permutation(n: int, seed: int) -> np.ndarray:
    """Deterministic native Fisher-Yates shuffle of [0, n)."""
    lib = _load()
    if lib is None:
        return np.random.default_rng(seed).permutation(n).astype(np.uint64)
    out = np.empty(n, np.uint64)
    lib.ld_permutation(n, seed, out.ctypes.data_as(_u64p))
    return out


class NativePrefetcher:
    """Background-thread batch prefetcher over a packed dataset array."""

    def __init__(self, data: np.ndarray, batch: int, seed: int = 0,
                 shuffle: bool = True):
        self._lib = _load()
        self._data = np.ascontiguousarray(data)
        self._batch = batch
        self._item_shape = data.shape[1:]
        self._itemsize = int(np.prod(data.shape[1:])) * data.dtype.itemsize
        self._dtype = data.dtype
        if self._lib is None:
            self._perm = permutation(len(data), seed) if shuffle \
                else np.arange(len(data), dtype=np.uint64)
            self._pos = 0
            self._h = None
        else:
            self._h = self._lib.pf_start(
                _ptr(self._data), len(data), self._itemsize, batch, seed,
                1 if shuffle else 0)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is None:
            if self._pos >= len(self._data):
                raise StopIteration
            idx = self._perm[self._pos: self._pos + self._batch]
            self._pos += len(idx)
            return np.take(self._data, idx.astype(np.int64), axis=0)
        out = np.empty((self._batch,) + self._item_shape, self._dtype)
        n = int(self._lib.pf_next(self._h, _ptr(out)))
        if n == 0:
            raise StopIteration
        return out[:n]

    def close(self):
        if self._h is not None:
            self._lib.pf_stop(self._h)
            self._h = None
