"""Annex-A level conformance tables and checks.

Capability parity with lencod/src/conformance.c (tables :21-40,
getLevelIdx, level_check called from lencod.c:512, getMaxMvLen /
update_mv_limits) — new implementation keyed by level_idc.
"""

from __future__ import annotations

from dataclasses import dataclass

# level_idc order: 1, 1b, 1.1, 1.2, 1.3, 2, 2.1, 2.2, 3, 3.1, 3.2,
#                  4, 4.1, 4.2, 5, 5.1, 5.2, 6, 6.1, 6.2
_LEVELS = (10, 9, 11, 12, 13, 20, 21, 22, 30, 31, 32,
           40, 41, 42, 50, 51, 52, 60, 61, 62)
_MAX_FS = (99, 99, 396, 396, 396, 396, 792, 1620, 1620, 3600, 5120,
           8192, 8192, 8704, 22080, 36864, 36864, 139264, 139264, 139264)
_MAX_MBPS = (1485, 1485, 3000, 6000, 11880, 11880, 19800, 20250, 40500,
             108000, 216000, 245760, 245760, 522240, 589824, 983040,
             2073600, 4177920, 8355840, 16711680)
_MAX_BR = (64, 128, 192, 384, 768, 2000, 4000, 4000, 10000, 14000, 20000,
           20000, 50000, 50000, 135000, 240000, 240000, 240000, 480000,
           800000)
_MAX_CPB = (175, 350, 500, 1000, 2000, 2000, 4000, 4000, 10000, 14000,
            20000, 25000, 62500, 62500, 135000, 240000, 240000, 240000,
            480000, 800000)
_MIN_CR = (2, 2, 2, 2, 2, 2, 2, 2, 2, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2, 2)
# Annex A MaxDpbMbs (table A-1)
_MAX_DPB_MBS = (396, 396, 900, 2376, 2376, 2376, 4752, 8100, 8100, 18000,
                20480, 32768, 32768, 34816, 110400, 184320, 184320, 696320,
                696320, 696320)
# vertical MV integer-pel limits per level (conformance.c LEVELVMVLIMIT)
_VMV_LIMIT = ((-63, 63), (-63, 63), (-127, 127), (-127, 127), (-127, 127),
              (-127, 127), (-255, 255), (-255, 255), (-255, 255),
              (-511, 511), (-511, 511), (-511, 511), (-511, 511),
              (-511, 511), (-511, 511), (-511, 511), (-511, 511),
              (-8191, 8191), (-8191, 8191), (-8191, 8191))


@dataclass
class LevelLimits:
    level_idc: int
    max_fs: int           # frame size, MBs
    max_mbps: int         # MBs / second
    max_br: int           # kbit/s (1200-bit units for non-high profiles)
    max_cpb: int
    min_cr: int
    max_dpb_mbs: int
    vmv: tuple            # vertical MV range, integer pel


def level_limits(level_idc: int, is_1b: bool = False) -> LevelLimits:
    lv = 9 if (level_idc == 11 and is_1b) else level_idc
    try:
        i = _LEVELS.index(lv)
    except ValueError:
        raise ValueError(f"unknown level_idc {level_idc}") from None
    return LevelLimits(level_idc, _MAX_FS[i], _MAX_MBPS[i], _MAX_BR[i],
                       _MAX_CPB[i], _MIN_CR[i], _MAX_DPB_MBS[i],
                       _VMV_LIMIT[i])


def max_dpb_frames(level_idc: int, frame_size_mbs: int) -> int:
    """getDpbSize twin: DPB capacity in frames, clipped to [1, 16]."""
    lim = level_limits(level_idc)
    return max(1, min(lim.max_dpb_mbs // max(frame_size_mbs, 1), 16))


def level_check(width_mb: int, height_mb: int, frame_rate: float,
                level_idc: int, num_ref_frames: int = 1) -> None:
    """lencod level_check twin: raises ValueError on violation."""
    lim = level_limits(level_idc)
    fs = width_mb * height_mb
    if fs > lim.max_fs:
        raise ValueError(
            f"frame size {fs} MBs exceeds level {level_idc/10:.1f} "
            f"MaxFs {lim.max_fs}")
    if fs * frame_rate > lim.max_mbps:
        raise ValueError(
            f"MB rate {fs * frame_rate:.0f}/s exceeds level "
            f"{level_idc/10:.1f} MaxMBPS {lim.max_mbps}")
    if num_ref_frames > max_dpb_frames(level_idc, fs):
        raise ValueError(
            f"{num_ref_frames} reference frames exceed level "
            f"{level_idc/10:.1f} DPB capacity "
            f"{max_dpb_frames(level_idc, fs)}")


def minimum_level(width_mb: int, height_mb: int, frame_rate: float,
                  num_ref_frames: int = 1) -> int:
    """Smallest level_idc passing level_check (auto level selection)."""
    for lv in _LEVELS:
        if lv == 9:
            continue
        try:
            level_check(width_mb, height_mb, frame_rate, lv, num_ref_frames)
            return lv
        except ValueError:
            continue
    raise ValueError("no level fits this configuration")
