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
input planes are left as they are. A wrapper given CPU
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

launches = {"deblock_luma": 0, "deblock_chroma": 0, "deblock_chroma422": 0}
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


def deblock_luma(Y, bs_v, bs_h, qp, disable, a_off, b_off, slice_id,
                 transform8x8, *, mb_w: int, mb_h: int) -> torch.Tensor:
    """K1: luma deblock of Y (16 mb_h, 16 mb_w) uint8, one persistent
    launch; returns a new plane. Per-MB arguments are (N,) int32, bs_v /
    bs_h (4 mb_h, 4 mb_w) int8 (see ops/deblock.deblock)."""
    per_mb = (qp, disable, a_off, b_off, slice_id, transform8x8)
    _check(Y, torch.uint8, (16 * mb_h, 16 * mb_w), "Y")
    _check_mb_args(bs_v, bs_h, per_mb, mb_w, mb_h, Y.device)
    out = torch.empty_like(Y)
    launches["deblock_luma"] += load().deblock_luma(
        Y, out, _scratch(mb_h, Y.device), bs_v, bs_h, *per_mb, mb_w, mb_h)
    return out


def deblock_chroma(U, V, bs_v, bs_h, qp, disable, a_off, b_off, slice_id,
                   transform8x8, qpc_cb, qpc_cr, *, mb_w: int, mb_h: int,
                   crows: int = 2):
    """Cb and Cr deblock of U, V (4 crows mb_h, 8 mb_w) uint8, one
    persistent launch: K2 at 4:2:0 (crows 2), K2-422 at 4:2:2 (crows 4),
    counted under their own keys. qpc_cb / qpc_cr (52,) int32 QP -> QPc
    tables. Returns new (U, V)."""
    if crows not in (2, 4):
        raise ValueError(f"crows {crows}: 2 (4:2:0) or 4 (4:2:2)")
    per_mb = (qp, disable, a_off, b_off, slice_id, transform8x8)
    shape = (4 * crows * mb_h, 8 * mb_w)
    _check(U, torch.uint8, shape, "U")
    _check(V, torch.uint8, shape, "V")
    _check(qpc_cb, torch.int32, (52,), "qpc_cb")
    _check(qpc_cr, torch.int32, (52,), "qpc_cr")
    _check_mb_args(bs_v, bs_h, per_mb, mb_w, mb_h, U.device)
    if V.device != U.device or qpc_cb.device != U.device \
            or qpc_cr.device != U.device:
        raise ValueError("U, V and the QPc tables must share a device")
    out_u = torch.empty_like(U)
    out_v = torch.empty_like(V)
    key = "deblock_chroma" if crows == 2 else "deblock_chroma422"
    launches[key] += load().deblock_chroma(
        U, V, out_u, out_v, _scratch(mb_h, U.device), bs_v, bs_h, *per_mb,
        qpc_cb, qpc_cr, mb_w, mb_h, 4 * crows)
    return out_u, out_v
