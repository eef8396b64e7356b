"""The port's host C++ runtime, jm_torch_native, and its loader.

The sources beside this file (jm_native.cpp: BitReader, CabacEngine,
EBSP <-> RBSP; jm_enc.cpp: the CAVLC slice serializer; jm_dec.cpp: the
CAVLC slice parser, the intra reconstruction and the encoder's Intra4x4
MB coder) are the port's own copy of jm_tpu's native/ runtime, without
its deblock (the card deblocks), with the Intra4x4 coder and the motion
search's fractional refinement (jm_enc.cpp subpel_refine) added. They
include only Python.h and are compiled with g++ at first use into
``build/native`` under the repository root (git-ignored), and rebuilt
when a source is newer than the module. Nothing is built at import time.

A failed compile or import raises; nothing falls back to the Python
twins. Which path each slice or picture took is explicit at the call
sites (an I_PCM MB keeps the Python path, by a check) and is counted in
``routes``:
  serialize  encoder/syntax.serialize_slice: native / python
  parse      decoder/mb_parse.MBParser: native / python, and rerun (the
             C parser stopped at an I_PCM MB and the Python parser ran
             the slice again)
  recon      decoder/recon.Reconstructor: native / python (pictures with
             intra MBs)
  cabac      decoder/mb_parse_cabac.MBParserCABAC: the slice's arithmetic
             decoder, native / python
  dp         data-partitioned slices, which only the Python MBWriter /
             MBParser handle (as in jm_tpu): serialize
             (encoder/syntax.serialize_slice_dp) / parse
  b          B slices, whose MB layer only the Python writers and parsers
             handle (as in jm_tpu): serialize (encoder/syntax
             .serialize_slice, encoder/syntax_cabac.serialize_slice_cabac)
             / parse (both parsers; a CABAC B slice also counts its
             arithmetic decoder under cabac)
  yuv422     CAVLC I / P slices of 4:2:2 pictures, which the Python
             MBParser parses (as in jm_tpu; the C parser is 4:2:0): parse
  sp         SP slices, whose MB layer is a P slice's and takes the P
             slice's route (counted there too): serialize (encoder/syntax
             .serialize_slice, serialize_slice_dp) / parse (MBParser)
"""

from __future__ import annotations

import fcntl
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
import time
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("jm_native.cpp", "jm_enc.cpp", "jm_dec.cpp")
BUILD_DIR = SRC_DIR.parents[1] / "build" / "native"
MODULE = "jm_torch_native"

routes = {"serialize": {"native": 0, "python": 0},
          "parse": {"native": 0, "python": 0, "rerun": 0},
          "recon": {"native": 0, "python": 0},
          "cabac": {"native": 0, "python": 0},
          "dp": {"serialize": 0, "parse": 0},
          "b": {"serialize": 0, "parse": 0},
          "yuv422": {"parse": 0},
          "sp": {"serialize": 0, "parse": 0}}
build_seconds = None        # wall time of load()'s build + import, once
_mod = None


class NativeBuildError(RuntimeError):
    """The C++ runtime did not compile; the message holds the compiler's
    command and standard error."""


def reset_routes() -> None:
    for kind in routes.values():
        for k in kind:
            kind[k] = 0


def build(build_dir=BUILD_DIR, cxx: str = "g++") -> Path:
    """Compile the sources into ``build_dir/jm_torch_native<EXT_SUFFIX>``
    unless that file is newer than every source; returns its path.
    Several processes may build at once (test workers): each takes an
    exclusive lock on ``build_dir/lock``, and the compiler writes a
    temporary file that replaces the module only when complete, so no
    process imports a half-written module."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / (MODULE + sysconfig.get_config_var("EXT_SUFFIX"))
    srcs = [SRC_DIR / s for s in SOURCES]
    with open(build_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime
                                for s in srcs):
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=build_dir)
        os.close(fd)
        # no FP contraction: sp_levels sums its double costs as Python
        cmd = [cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
               "-ffp-contract=off",
               f"-I{sysconfig.get_paths()['include']}", *map(str, srcs),
               "-o", tmp]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise NativeBuildError(f"cannot run {cxx}: {e}") from e
            if proc.returncode:
                raise NativeBuildError(
                    f"{' '.join(cmd)} exited with {proc.returncode}:\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load():
    """Build (first call) and import the module, with the normative
    tables installed from the port's own modules; returns it."""
    global _mod, build_seconds
    if _mod is None:
        t0 = time.perf_counter()
        spec = importlib.util.spec_from_file_location(MODULE, build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _install_tables(mod)
        build_seconds = time.perf_counter() - t0
        _mod = mod
    return _mod


def _pad2(rows, width, dtype):
    out = np.zeros((len(rows), width), dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _install_tables(mod) -> None:
    """The CABAC state machine (common/cabac_tables.py), the CAVLC code
    tables (common/cavlc_tables.py) for the serializer, the CAVLC peek
    LUTs (decoder/cavlc.py) for the parser and the cbp -> codeNum inverse
    of common/picture.CBP_MAP_CHROMA, as jm_tpu/native/__init__.py
    installs jm_tpu's; and the quarter-pel plane selection of
    ops/consts.QPEL_TAB with the planes' PAD, for subpel_refine."""
    from ..common import cabac_tables as CT
    from ..common import cavlc_tables as C
    from ..common.picture import CBP_MAP_CHROMA
    from ..decoder import cavlc as DC
    from ..ops.consts import PAD, QPEL_TAB

    c = np.ascontiguousarray
    mod.set_cabac_tables(c(CT.RANGE_LPS, np.uint8),
                         c(CT.NEXT_STATE_MPS, np.uint8),
                         c(CT.NEXT_STATE_LPS, np.uint8))
    cbp_inv = np.zeros((2, 48), np.uint8)
    for i, (ci, cp) in enumerate(CBP_MAP_CHROMA):
        cbp_inv[0, int(ci)] = i
        cbp_inv[1, int(cp)] = i
    mod.set_cavlc_tables({
        "ct_len": c(C._CT_LEN, np.uint8),
        "ct_cod": c(C._CT_COD, np.uint16),
        "ctdc_len": c(C._CT_DC_LEN, np.uint8),
        "ctdc_cod": c(C._CT_DC_COD, np.uint16),
        "tz_len": _pad2(C._TZ_LEN, 16, np.uint8),
        "tz_cod": _pad2(C._TZ_COD, 16, np.uint16),
        "tzdc0_len": _pad2(C._TZ_DC_LEN[0], 4, np.uint8),
        "tzdc0_cod": _pad2(C._TZ_DC_COD[0], 4, np.uint16),
        "tzdc1_len": _pad2(C._TZ_DC_LEN[1], 8, np.uint8),
        "tzdc1_cod": _pad2(C._TZ_DC_COD[1], 8, np.uint16),
        "run_len": _pad2(C._RUN_LEN, 15, np.uint8),
        "run_cod": _pad2(C._RUN_COD, 15, np.uint16),
        "cbp_inv_chroma": cbp_inv,
    })
    mod.set_cavlc_dec_tables(
        [c(t, np.int32) for t in DC.CT_LUT], [c(DC.CT_DC_LUT[0], np.int32)],
        [c(t, np.int32) for t in DC.TZ_LUT],
        [c(t, np.int32) for t in DC.TZ_DC_LUT[0]],
        [c(t, np.int32) for t in DC.RUN_LUT])
    qpel = np.zeros((16, 6), np.int32)
    for (xf, yf), row in QPEL_TAB.items():
        qpel[xf + 4 * yf] = row
    mod.set_qpel_tab(qpel, PAD)
