"""Bjontegaard-delta quality harness, the port's copy of
jm_tpu/tools/bdrate.py: the port's encoder (on the card unless
run_ours / main are given device="cpu") against JM lencod.

Implements the standard BD-rate / BD-PSNR measures (cubic fit of
PSNR -> log10(rate), integrated over the overlapping PSNR interval) and
a runner that encodes the same clip at a QP ladder with both encoders
under matched settings (JM's encoder_baseline.cfg parameters).

Usage:
    python -m jm_tpu_torch.tools.bdrate --input clip.yuv [--size 176x144]
        [--qps 24,28,32,36] [--frames 3]
        [--jm-bin .refbuild/bin/lencod.exe] [--jm-run .refbuild/run]
        [--preset best|fast|fast_rd] [--json out.json]

The JM side (run_jm) runs a lencod binary built from the reference
sources; none ships with the repository, so no test runs it. bd_rate,
bd_psnr and run_ours are held against jm_tpu's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np


def psnr_y(a: np.ndarray, b: np.ndarray) -> float:
    d = (a.astype(np.int64) - b.astype(np.int64)) ** 2
    mse = d.mean()
    return 10.0 * np.log10(255.0 * 255.0 / mse) if mse else 99.0


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """BD-rate in percent (negative = test saves rate vs anchor)."""
    la, lt = np.log10(rate_anchor), np.log10(rate_test)
    pa = np.polyfit(psnr_anchor, la, 3)
    pt = np.polyfit(psnr_test, lt, 3)
    lo = max(min(psnr_anchor), min(psnr_test))
    hi = min(max(psnr_anchor), max(psnr_test))
    ia = np.polyint(pa)
    it = np.polyint(pt)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float((10 ** (avg_t - avg_a) - 1) * 100)


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """BD-PSNR in dB (positive = test better at equal rate)."""
    la, lt = np.log10(rate_anchor), np.log10(rate_test)
    pa = np.polyfit(la, psnr_anchor, 3)
    pt = np.polyfit(lt, psnr_test, 3)
    lo = max(min(la), min(lt))
    hi = min(max(la), max(lt))
    ia = np.polyint(pa)
    it = np.polyint(pt)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float(avg_t - avg_a)


def read_yuv(path, w, h, n):
    raw = open(path, "rb").read()
    fs = w * h * 3 // 2
    out = []
    for i in range(min(n, len(raw) // fs)):
        b = raw[i * fs:(i + 1) * fs]
        out.append((np.frombuffer(b[:w * h], np.uint8).reshape(h, w),
                    np.frombuffer(b[w * h:w * h + w * h // 4],
                                  np.uint8).reshape(h // 2, w // 2),
                    np.frombuffer(b[w * h + w * h // 4:],
                                  np.uint8).reshape(h // 2, w // 2)))
    return out


PRESETS = {
    # the best settings: encoder_baseline.cfg search params + RDOQ
    "best": dict(num_ref=5, search_range=32, rdo=1, sub8x8=True, rdoq=1),
    # md_low single-ref (the device-pipeline configuration); the port's
    # device route defaults to device_rd=True, jm_tpu's to False
    "fast": dict(num_ref=1, search_range=16, rdo=0, pipeline="device",
                 device_rd=False),
    # the device RD tier (ops/enc_rd.py), the main path's configuration
    "fast_rd": dict(num_ref=1, search_range=16, rdo=0,
                    pipeline="device", device_rd=True),
}


def run_ours(frames, w, h, qp, preset: str, device="cuda"):
    """(bits, mean luma PSNR) of the port's encoder on frames at qp under
    PRESETS[preset], on device."""
    from ..encoder.encoder import Encoder, EncoderConfig
    cfg = EncoderConfig(width=w, height=h, qp=qp, **PRESETS[preset])
    enc = Encoder(cfg, device=device)
    bs = b"".join(enc.encode_frame(*f) for f in frames)
    bs += enc.flush()
    recs = sorted(enc.results, key=lambda r: r["disp"])
    p = np.mean([psnr_y(f[0], r["frame"].Y)
                 for f, r in zip(frames, recs)])
    return len(bs) * 8, float(p)


def run_jm(yuv_path, frames, w, h, qp, jm_bin, jm_run):
    """(bits, mean luma PSNR) of JM lencod (jm_bin, run in jm_run with its
    encoder_baseline.cfg) on the clip at qp."""
    with tempfile.TemporaryDirectory() as td:
        out264 = os.path.join(td, "jm.264")
        rec = os.path.join(td, "jm_rec.yuv")
        cmd = [os.path.abspath(jm_bin), "-d", "encoder_baseline.cfg",
               "-p", f"InputFile={os.path.abspath(yuv_path)}",
               "-p", f"SourceWidth={w}", "-p", f"SourceHeight={h}",
               "-p", f"FramesToBeEncoded={len(frames)}",
               "-p", f"QPISlice={qp}", "-p", f"QPPSlice={qp}",
               "-p", f"OutputFile={out264}", "-p", f"ReconFile={rec}"]
        subprocess.run(cmd, cwd=jm_run, check=True,
                       stdout=subprocess.DEVNULL)
        bits = os.path.getsize(out264) * 8
        recf = read_yuv(rec, w, h, len(frames))
        p = np.mean([psnr_y(f[0], r[0]) for f, r in zip(frames, recf)])
    return bits, float(p)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--size", default="176x144")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--qps", default="24,28,32,36")
    ap.add_argument("--jm-bin", default=".refbuild/bin/lencod.exe")
    ap.add_argument("--jm-run", default=".refbuild/run")
    ap.add_argument("--preset", default="best", choices=sorted(PRESETS))
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    w, h = map(int, args.size.split("x"))
    qps = [int(q) for q in args.qps.split(",")]
    frames = read_yuv(args.input, w, h, args.frames)

    ours, jm = [], []
    for qp in qps:
        ob, op = run_ours(frames, w, h, qp, args.preset, device=device)
        jb, jp = run_jm(args.input, frames, w, h, qp, args.jm_bin,
                        args.jm_run)
        ours.append((ob, op))
        jm.append((jb, jp))
        print(f"QP{qp}: ours {ob:7d} bits {op:6.3f} dB | "
              f"JM {jb:7d} bits {jp:6.3f} dB")
    bdr = bd_rate([b for b, _ in jm], [p for _, p in jm],
                  [b for b, _ in ours], [p for _, p in ours])
    bdp = bd_psnr([b for b, _ in jm], [p for _, p in jm],
                  [b for b, _ in ours], [p for _, p in ours])
    print(f"BD-rate vs JM (preset={args.preset}): {bdr:+.2f}%  "
          f"BD-PSNR: {bdp:+.3f} dB")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"qps": qps, "ours": ours, "jm": jm,
                       "bd_rate_pct": bdr, "bd_psnr_db": bdp,
                       "preset": args.preset}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
