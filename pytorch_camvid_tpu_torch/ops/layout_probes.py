"""The six layout probes of ``tools/mosaic_probes.py`` on hand-written Hopper
kernels (``csrc/layout_probes.cu``): can a kernel read a staged tile at a
row or width offset that is not aligned, and at what cost.

- ``row_slice(x, start, n)``: ``x[start:start+n]`` (M1 in f32, M2 in bf16),
  staged in shared memory from the 8-row boundary below ``start`` and read
  there at the unaligned row, by blocks of 8 rows x 256 bytes spread over
  the card (``rows_grid``).
- ``row_slice_dynamic(x, s, n)``: the same at an offset held in an int32
  device tensor ``s`` of one element (M3), which the kernel reads and the
  host never does; clamped to [0, rows - n], as ``lax.dynamic_slice``
  clamps.
- ``row_slice_matmul(x, w, start, n=32)``: ``x[start:start+n] @ w`` in f32
  on the tensor cores (split TF32, three ``mma.sync`` per product), fed
  from a shared tile at the unaligned row, one block per 32 rows x 8
  columns, its loads issued at once, its warps' partial sums added in a
  fixed order (M4: the same bits on every call).
- ``roll_rows(x, shift)``: ``torch.roll(x, shift, 0)`` through shared
  memory (M5, f32 and bf16).
- ``sum_width_shifts(xp, w)``: ``xp[:, 0:w] + xp[:, 1:w+1] + xp[:, 2:w+2]``
  for xp (H, Wp, C) f32, from three bulk async copies per tile at width
  offsets 0, 1 and 2 of the one array, completing on an mbarrier (M6).

Each wrapper checks what the function takes (2-D or 3-D shape, dtype,
ranges; for M6 C a multiple of 4, the bulk copy's 16-byte rule) on every
device, so the CPU run takes the inputs the card does. A CPU tensor then
goes to the plain version (the ``*_plain`` functions); a CUDA tensor
launches the kernel or raises; any other device raises. Each wrapper counts
its launches in ``.launches``. M1, M2, M3, M5 and M6 are bit-equal to their
plain versions; M4 agrees with the f32 product to ~1e-6 relative.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorch_camvid_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "layout_probes.cu"
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_STATIC, _DYNAMIC, _ROLL = 0, 1, 2   # layout_rows' modes
ROWS_MODES = {"static": _STATIC, "dynamic": _DYNAMIC, "roll": _ROLL}
ROWS_PER_BLOCK, ROW_TILE_BYTES = 8, 256   # rows_kernel's block: RB x CT
WIDTH_OFFSETS = (0, 1, 2)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.layout_rows.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.layout_slice_matmul.argtypes = [p] * 3 + [i] * 5 + [p]
    lib.layout_sum_width_shifts.argtypes = [p] * 2 + [i] * 7 + [p]
    for fn in (lib.layout_rows, lib.layout_slice_matmul,
               lib.layout_sum_width_shifts):
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------- plain versions

def row_slice_plain(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    return x[start:start + n].clone()


def row_slice_dynamic_plain(x: torch.Tensor, s: torch.Tensor,
                            n: int) -> torch.Tensor:
    """Rows s .. s+n-1 with s clamped to [0, rows - n]; no host sync."""
    first = s.long().clamp(0, x.shape[0] - n)
    return x.index_select(0, first + torch.arange(n, device=x.device))


def row_slice_matmul_plain(x: torch.Tensor, w: torch.Tensor, start: int,
                           n: int = 32) -> torch.Tensor:
    return x[start:start + n] @ w


def roll_rows_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, 0)


def sum_width_shifts_plain(xp: torch.Tensor, w: int) -> torch.Tensor:
    return xp[:, 0:w] + xp[:, 1:w + 1] + xp[:, 2:w + 2]


def rows_grid(rows: int, cols: int, dtype: torch.dtype, n: int,
              mode: str = "static") -> dict:
    """The grid ``layout_rows`` launches for an (rows, cols) x of ``dtype``
    and n output rows (``mode``: "static", "dynamic" or "roll", where n is
    rows): blocks of ``ROWS_PER_BLOCK`` output rows along x by
    ``ROW_TILE_BYTES`` columns of bytes along y. Returns the grid and each
    block's output rows and byte columns, [first, last) per index."""
    if mode not in ROWS_MODES or (mode == "roll" and n != rows):
        raise ValueError(f"rows_grid: mode {mode!r} with n {n} of {rows}")
    row_bytes = cols * torch.empty((), dtype=dtype).element_size()
    gx = -(-n // ROWS_PER_BLOCK)
    gy = -(-row_bytes // ROW_TILE_BYTES)
    return {"grid": (gx, gy),
            "rows": [(i * ROWS_PER_BLOCK, min(n, (i + 1) * ROWS_PER_BLOCK))
                     for i in range(gx)],
            "bytes": [(j * ROW_TILE_BYTES,
                       min(row_bytes, (j + 1) * ROW_TILE_BYTES))
                      for j in range(gy)]}


# ------------------------------------------------------------- checks

def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the caller runs the plain version); True for
    CUDA tensors the kernel can take; raises otherwise."""
    x = tensors[0]
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: a tensor is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             f"16-byte aligned")
    return True


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name} takes a 2-D (rows, cols) x, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16, got {x.dtype}")
    if x.shape[1] * x.element_size() % 16 or min(x.shape) == 0:
        raise ValueError(f"{name}: a row must be a non-zero multiple of 16 "
                         f"bytes, got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] >= 2 ** 31 or x.shape[1] * x.element_size() >= 2 ** 31:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")


def _check_count(name: str, x: torch.Tensor, n: int) -> None:
    if not 0 < n <= x.shape[0]:
        raise ValueError(f"{name}: n = {n} rows of {x.shape[0]}")


def _launch(op: str, *args) -> None:
    """One launch of the kernel of ``op`` (``rows``, ``slice_matmul`` or
    ``sum_width_shifts``): ``args`` in the C function's order, tensors
    passing their pointers; raises on a CUDA error."""
    x = args[0]
    fn = getattr(_library(), f"layout_{op}")
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(x.device):
        err = fn(*c_args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layout probe {op} launch failed: CUDA error "
                           f"{err} at {tuple(x.shape)} {x.dtype}")


# ----------------------------------------------------------- wrappers

def row_slice(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """x[start:start+n] of a 2-D f32 or bf16 x (M1, M2)."""
    _check_rows("row_slice", x)
    _check_count("row_slice", x, n)
    if not 0 <= start <= x.shape[0] - n:
        raise ValueError(f"row_slice: rows {start}..{start + n} of "
                         f"{x.shape[0]}")
    if not _on_cuda("row_slice", x):
        return row_slice_plain(x, start, n)
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    _launch("rows", x, out, None, _STATIC, _DTYPES[x.dtype], x.shape[0],
            x.shape[1], n, start)
    row_slice.launches += 1
    return out


def row_slice_dynamic(x: torch.Tensor, s: torch.Tensor,
                      n: int) -> torch.Tensor:
    """n rows of x from the offset in ``s`` (int32, one element, on x's
    device), clamped to [0, rows - n] (M3)."""
    _check_rows("row_slice_dynamic", x)
    _check_count("row_slice_dynamic", x, n)
    if s.dtype != torch.int32 or s.numel() != 1:
        raise TypeError(f"row_slice_dynamic: s must be one int32, got "
                        f"{s.dtype} {tuple(s.shape)}")
    if not _on_cuda("row_slice_dynamic", x, s):
        return row_slice_dynamic_plain(x, s, n)
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    _launch("rows", x, out, s, _DYNAMIC, _DTYPES[x.dtype], x.shape[0],
            x.shape[1], n, 0)
    row_slice_dynamic.launches += 1
    return out


def roll_rows(x: torch.Tensor, shift: int) -> torch.Tensor:
    """torch.roll(x, shift, 0) of a 2-D f32 or bf16 x (M5)."""
    _check_rows("roll_rows", x)
    if not _on_cuda("roll_rows", x):
        return roll_rows_plain(x, shift)
    out = torch.empty_like(x)
    rows = x.shape[0]
    _launch("rows", x, out, None, _ROLL, _DTYPES[x.dtype], rows,
            x.shape[1], rows, shift % rows)
    roll_rows.launches += 1
    return out


def row_slice_matmul(x: torch.Tensor, w: torch.Tensor, start: int,
                     n: int = 32) -> torch.Tensor:
    """x[start:start+n] @ w in f32: x (rows, K), w (K, N), K and N
    multiples of 4 (M4)."""
    name = "row_slice_matmul"
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{name} takes f32 x and w, got {x.dtype} and "
                        f"{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x (rows, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    rows, k = x.shape
    cols = w.shape[1]
    if k % 4 or cols % 4 or min(k, cols) == 0 or max(rows, k, cols) >= 2**31:
        raise ValueError(f"{name}: K and N must be non-zero multiples of 4, "
                         f"got {tuple(x.shape)} @ {tuple(w.shape)}")
    _check_count(name, x, n)
    if not 0 <= start <= rows - n:
        raise ValueError(f"{name}: rows {start}..{start + n} of {rows}")
    if not _on_cuda(name, x, w):
        return row_slice_matmul_plain(x, w, start, n)
    out = torch.empty((n, cols), dtype=torch.float32, device=x.device)
    _launch("slice_matmul", x, w, out, rows, k, cols, start, n)
    row_slice_matmul.launches += 1
    return out


def sum_width_shifts(xp: torch.Tensor, w: int) -> torch.Tensor:
    """xp[:, 0:w] + xp[:, 1:w+1] + xp[:, 2:w+2] of an (H, Wp, C) f32 xp,
    C a multiple of 4 (M6)."""
    name = "sum_width_shifts"
    if xp.dtype != torch.float32:
        raise TypeError(f"{name} takes f32, got {xp.dtype}")
    if xp.dim() != 3:
        raise ValueError(f"{name} takes (H, Wp, C), got {tuple(xp.shape)}")
    h, wp, c = xp.shape
    if c % 4 or c == 0:
        raise ValueError(f"{name}: C = {c}: a bulk copy at width offset d "
                         f"starts C * 4 * d bytes in, which must be a "
                         f"multiple of 16, so C must be a multiple of 4")
    if c * 4 > 16384 or h == 0 or not 0 < w <= wp - 2 or h * wp * c >= 2**31:
        raise ValueError(f"{name}: unsupported xp {tuple(xp.shape)}, w {w}")
    if not _on_cuda(name, xp):
        return sum_width_shifts_plain(xp, w)
    out = torch.empty((h, w, c), dtype=torch.float32, device=xp.device)
    _launch("sum_width_shifts", xp, out, h, wp, c, w, *WIDTH_OFFSETS)
    sum_width_shifts.launches += 1
    return out


# JSON name of each wrapper's kernel (chip_smoke.py)
KERNELS = {"layout_probes.row_slice": row_slice,
           "layout_probes.row_slice_dynamic": row_slice_dynamic,
           "layout_probes.row_slice_matmul": row_slice_matmul,
           "layout_probes.roll_rows": roll_rows,
           "layout_probes.sum_width_shifts": sum_width_shifts}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


reset_launches()
