"""Hand-written CUDA kernels of the port and their loader.

The source (deblock.cu: the kernels, their host launchers and C entry
points) is compiled for sm_90a at first use by one ``nvcc -shared`` into
``build/kernels/jm_tpu_torch_kernels.so`` under the repository root
(git-ignored), rebuilt when the source is newer, and loaded with ctypes:
no file of the build includes PyTorch's headers. Nothing is built or
loaded at module import time, so the CPU tests can import this module.

Every wrapper checks its inputs (device, dtype, shape, contiguity and
the alignment of the vector reads), allocates its outputs and the
kernel's zeroed scratch, launches once on the current stream of the
inputs' card, raises if the launch failed, and adds the launch to
``launches``: K1 under "deblock_luma", K2 (4:2:0 chroma) under
"deblock_chroma", K2-422 (4:2:2 chroma) under "deblock_chroma422". The
wrappers pick the kernel from the planes' dtype: uint8 planes take the
8-bit kernels, int16 planes (9- to 14-bit pictures, ops/consts
.plane_dtype) their >8-bit variants, counted under "deblock_luma16",
"deblock_chroma16" and "deblock_chroma422_16". The input planes are left
as they are. A wrapper given CPU
tensors raises: the plain PyTorch versions live beside their callers
(ops/deblock.py ``deblock_plain``).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent
SOURCE = _SRC / "deblock.cu"
BUILD_DIR = _SRC.parents[1] / "build" / "kernels"
LIBRARY = "jm_tpu_torch_kernels.so"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

launches = {"deblock_luma": 0, "deblock_chroma": 0, "deblock_chroma422": 0,
            "deblock_luma16": 0, "deblock_chroma16": 0,
            "deblock_chroma422_16": 0}
build_seconds = None            # wall time of the build + load, once
_lib = None
_grid_sms = {}                  # the card's SM count, by device index

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of the C entry points, after their leading plane pointers
# and stride: the six per-MB arrays, bs_v, bs_h, [qpc_cb, qpc_cr,]
# scratch, then the int arguments, then the stream
_ENTRY_POINTS = {
    "jm_deblock_luma": [_P, _P, _I] + [_P] * 9 + [_I] * 3 + [_P],
    "jm_deblock_chroma": [_P] * 4 + [_I] + [_P] * 11 + [_I] * 4 + [_P],
    "jm_deblock_luma16": [_P, _P, _I] + [_P] * 9 + [_I] * 4 + [_P],
    "jm_deblock_chroma16": [_P] * 4 + [_I] + [_P] * 11 + [_I] * 6 + [_P],
}


class KernelBuildError(RuntimeError):
    """nvcc did not compile the kernels; the message holds its command and
    standard error."""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelBuildError("no CUDA toolkit found (CUDA_HOME, nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(build_dir=BUILD_DIR, nvcc: str | None = None) -> Path:
    """Compile deblock.cu into ``build_dir/LIBRARY`` unless that file is
    newer than the source; returns its path. Processes that build at once
    take turns on an exclusive lock of ``build_dir/lock``; nvcc writes a
    temporary file that replaces the library only when complete."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / LIBRARY
    with open(build_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=build_dir)
        os.close(fd)
        cmd = [nvcc or _nvcc(), *NVCC_FLAGS, str(SOURCE), "-o", tmp]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise KernelBuildError(f"cannot run {cmd[0]}: {e}") from e
            if proc.returncode:
                raise KernelBuildError(
                    f"{' '.join(cmd)} exited with {proc.returncode}:\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load():
    """Build (first call) and load the kernels' library; returns it."""
    global _lib, build_seconds
    if _lib is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.jm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.jm_cuda_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - t0
        _lib = lib
    return _lib


def _grid(mb_h: int, device) -> int:
    """One CTA per MB row, at most one per SM: a CTA that finishes its row
    takes the next unclaimed one."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _grid_sms:
        _grid_sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return min(mb_h, _grid_sms[idx])


def _launch(key: str, entry: str, device, *args) -> None:
    """One launch of the C entry point `entry` on the current stream of
    `device` (tensors given as their data pointers); raises if it failed,
    else counts it under launches[key]."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err:
        raise RuntimeError(f"{key}: launch failed: "
                           f"{lib.jm_cuda_error_string(err).decode()}")
    launches[key] += 1


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _aligned(t: torch.Tensor, align: int, name: str) -> None:
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned (the "
                         f"kernels' vector reads)")


def _check(t: torch.Tensor, dtype: torch.dtype, shape, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor required, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_mb_args(bs_v, bs_h, per_mb, mb_w: int, mb_h: int, device):
    _check(bs_v, torch.int8, (4 * mb_h, 4 * mb_w), "bs_v")
    _aligned(bs_v, 4, "bs_v")       # bS rows are read 4 entries at a time
    _check(bs_h, torch.int8, (4 * mb_h, 4 * mb_w), "bs_h")
    names = ("qp", "disable", "a_off", "b_off", "slice_id", "transform8x8")
    for name, t in zip(names, per_mb):
        _check(t, torch.int32, (mb_w * mb_h,), name)
    for t in (bs_v, bs_h, *per_mb):
        if t.device != device:
            raise ValueError(f"inputs on {t.device} and {device}")


def _scratch(mb_h: int, device) -> torch.Tensor:
    """The persistent kernels' (1 + mb_h,) int32 scratch, zeroed on the
    current stream: the row ticket, then one progress counter per MB row."""
    return torch.zeros(1 + mb_h, dtype=torch.int32, device=device)


# the launch keys of the chroma kernels by crows, then (8-bit, >8-bit)
_CHROMA_KEYS = {2: ("deblock_chroma", "deblock_chroma16"),
                4: ("deblock_chroma422", "deblock_chroma422_16")}


def _check_depth(dtype: torch.dtype, bd: int, name: str) -> bool:
    """Whether planes of ``dtype`` at bit depth bd take the >8-bit
    variant (int16, bd 8..14) or the 8-bit kernel (uint8, bd 8)."""
    if dtype == torch.uint8 and bd == 8:
        return False
    if dtype == torch.int16 and 8 <= bd <= 14:
        return True
    raise ValueError(f"{name}: {dtype} planes at bit depth {bd} (uint8 at "
                     f"8 bits, int16 at 8-14)")


def deblock_luma(Y, bs_v, bs_h, qp, disable, a_off, b_off, slice_id,
                 transform8x8, *, mb_w: int, mb_h: int,
                 bd: int = 8) -> torch.Tensor:
    """K1: luma deblock of Y (16 mb_h, 16 mb_w) uint8, or K1-HBD of Y
    int16 of bd bits, one persistent launch; returns a new plane. Per-MB
    arguments are (N,) int32, bs_v / bs_h (4 mb_h, 4 mb_w) int8 (see
    ops/deblock.deblock)."""
    per_mb = (qp, disable, a_off, b_off, slice_id, transform8x8)
    hbd = _check_depth(Y.dtype, bd, "Y")
    _check(Y, Y.dtype, (16 * mb_h, 16 * mb_w), "Y")
    _check_mb_args(bs_v, bs_h, per_mb, mb_w, mb_h, Y.device)
    _aligned(Y, 16, "Y")     # MB row interiors are read as 16-byte vectors
    out = torch.empty_like(Y)
    scratch = _scratch(mb_h, Y.device)
    args = (*_ptrs(Y, out), Y.stride(0), *_ptrs(*per_mb, bs_v, bs_h,
                                                 scratch), mb_w, mb_h)
    grid = _grid(mb_h, Y.device)
    if hbd:
        _launch("deblock_luma16", "jm_deblock_luma16", Y.device, *args, bd,
                grid)
    else:
        _launch("deblock_luma", "jm_deblock_luma", Y.device, *args, grid)
    return out


def deblock_chroma(U, V, bs_v, bs_h, qp, disable, a_off, b_off, slice_id,
                   transform8x8, qpc_cb, qpc_cr, *, mb_w: int, mb_h: int,
                   crows: int = 2, bd: int = 8):
    """Cb and Cr deblock of U, V (4 crows mb_h, 8 mb_w), one persistent
    launch: K2 at 4:2:0 (crows 2), K2-422 at 4:2:2 (crows 4) on uint8
    planes, their >8-bit variants on int16 planes of bd bits, counted
    under their own keys. qpc_cb / qpc_cr (52 + QpBdOffsetY,) int32 QPY ->
    QPc tables (convert.qpc_tables; (52,) for uint8 planes). Returns new
    (U, V)."""
    if crows not in (2, 4):
        raise ValueError(f"crows {crows}: 2 (4:2:0) or 4 (4:2:2)")
    per_mb = (qp, disable, a_off, b_off, slice_id, transform8x8)
    shape = (4 * crows * mb_h, 8 * mb_w)
    hbd = _check_depth(U.dtype, bd, "U")
    _check(U, U.dtype, shape, "U")
    _check(V, U.dtype, shape, "V")
    n_tab = qpc_cb.shape[0] if qpc_cb.dim() == 1 else -1
    if not hbd and n_tab != 52 or (n_tab - 52) % 6 or not 52 <= n_tab <= 88:
        raise ValueError(f"qpc_cb: {tuple(qpc_cb.shape)} entries, expected "
                         f"52 + QpBdOffsetY (52 for uint8 planes)")
    _check(qpc_cb, torch.int32, (n_tab,), "qpc_cb")
    _check(qpc_cr, torch.int32, (n_tab,), "qpc_cr")
    _check_mb_args(bs_v, bs_h, per_mb, mb_w, mb_h, U.device)
    if V.device != U.device or qpc_cb.device != U.device \
            or qpc_cr.device != U.device:
        raise ValueError("U, V and the QPc tables must share a device")
    # MB row interiors are read as 8-byte (uint8) or 16-byte (int16)
    # vectors
    _aligned(U, 16 if hbd else 8, "U")
    _aligned(V, 16 if hbd else 8, "V")
    out_u = torch.empty_like(U)
    out_v = torch.empty_like(V)
    key = _CHROMA_KEYS[crows][hbd]
    scratch = _scratch(mb_h, U.device)
    args = (*_ptrs(U, V, out_u, out_v), U.stride(0),
            *_ptrs(*per_mb, bs_v, bs_h, qpc_cb, qpc_cr, scratch), mb_w,
            mb_h, 4 * crows)
    grid = _grid(mb_h, U.device)
    if hbd:
        _launch(key, "jm_deblock_chroma16", U.device, *args, bd, n_tab - 52,
                grid)
    else:
        _launch(key, "jm_deblock_chroma", U.device, *args, grid)
    return out_u, out_v
