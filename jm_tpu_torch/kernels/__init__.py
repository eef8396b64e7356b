"""Hand-written CUDA kernels of the port and their loader.

The sources (deblock.cu, plain C++ interface; deblock_bind.cpp, the one
file that includes torch/extension.h) are compiled for sm_90a at first
use with ``torch.utils.cpp_extension.load`` into ``build/kernels`` under
the repository root (git-ignored). Nothing is built or imported at
module import time, so the CPU tests can import this module.

Every wrapper checks its inputs, allocates its outputs and the kernel's
zeroed scratch, launches once, and adds the kernel launches it made to
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

import os
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent
BUILD_DIR = _SRC.parents[1] / "build" / "kernels"

launches = {"deblock_luma": 0, "deblock_chroma": 0, "deblock_chroma422": 0,
            "deblock_luma16": 0, "deblock_chroma16": 0,
            "deblock_chroma422_16": 0}
build_seconds = None            # wall time of the build, once built
_ext = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def load():
    """Build (first call) and return the extension module."""
    global _ext, build_seconds
    if _ext is None:
        from torch.utils.cpp_extension import load as _load
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        _ext = _load(
            name="jm_tpu_torch_kernels",
            sources=[str(_SRC / "deblock.cu"), str(_SRC / "deblock_bind.cpp")],
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O2"],
            extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
            verbose=False)
        build_seconds = time.perf_counter() - t0
    return _ext


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
    out = torch.empty_like(Y)
    scratch = _scratch(mb_h, Y.device)
    if hbd:
        launches["deblock_luma16"] += load().deblock_luma16(
            Y, out, scratch, bs_v, bs_h, *per_mb, mb_w, mb_h, bd)
    else:
        launches["deblock_luma"] += load().deblock_luma(
            Y, out, scratch, bs_v, bs_h, *per_mb, mb_w, mb_h)
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
    out_u = torch.empty_like(U)
    out_v = torch.empty_like(V)
    key = _CHROMA_KEYS[crows][hbd]
    scratch = _scratch(mb_h, U.device)
    if hbd:
        launches[key] += load().deblock_chroma16(
            U, V, out_u, out_v, scratch, bs_v, bs_h, *per_mb, qpc_cb,
            qpc_cr, mb_w, mb_h, 4 * crows, bd)
    else:
        launches[key] += load().deblock_chroma(
            U, V, out_u, out_v, scratch, bs_v, bs_h, *per_mb, qpc_cb,
            qpc_cr, mb_w, mb_h, 4 * crows)
    return out_u, out_v
