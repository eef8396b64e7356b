"""Encoder CLI: JM lencod twin, the port's copy of jm_tpu/tools/lencod.py.

Mirrors the reference encoder's main loop (lencod/src/lencod.c:355
encode_sequence, image.c:1398 ReportFirstframe/ReportI/ReportP per-frame
lines, report.c:246 report() summary) over the port's encoder, on the
card unless main is given device="cpu". Accepts reference `.cfg` files unchanged (unsupported
params are ignored with a notice; unsupported *features* raise).

    python -m jm_tpu_torch.tools.lencod -d encoder.cfg [-f more.cfg]
        [-p Name=Value] [-ckpt state.ckpt [-resume]]

With NumberOfViews = 2 the View1ConfigFile's InputFile is the dependent
view; its ReconFile is read and never written, and the recon file and the
PSNR cover view 0, as in jm_tpu.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..config import EncoderParams, load_params
from ..encoder.encoder import Encoder
from ..metrics import ms_ssim, psnr, ssim


def read_yuv420_frames(path: str, w: int, h: int, n: int, start: int = 0,
                       chroma_format: int = 1):
    """Planar YUV reader: 4:2:0 (default) or 4:2:2 (chroma w/2 x h)."""
    ch, cw = (h, w // 2) if chroma_format == 2 else (h // 2, w // 2)
    csz = ch * cw
    fsz = w * h + 2 * csz
    frames = []
    with open(path, "rb") as fh:
        fh.seek(start * fsz)
        for _ in range(n):
            raw = fh.read(fsz)
            if len(raw) < fsz:
                break
            a = np.frombuffer(raw, np.uint8)
            frames.append((a[:w * h].reshape(h, w),
                           a[w * h:w * h + csz].reshape(ch, cw),
                           a[w * h + csz:].reshape(ch, cw)))
    return frames


def _parse_cli(argv):
    d_file, f_files, p_overrides = None, [], []
    ckpt, resume = None, False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-d":
            d_file = argv[i + 1]; i += 2
        elif a == "-f":
            f_files.append(argv[i + 1]); i += 2
        elif a == "-p":
            p_overrides.append(argv[i + 1]); i += 2
        elif a == "-ckpt":        # GOP-granular job checkpoint
            ckpt = argv[i + 1]; i += 2
        elif a == "-resume":      # continue from -ckpt state
            resume = True; i += 1
        elif a in ("-h", "--help"):
            print(__doc__)
            raise SystemExit(0)
        else:
            raise SystemExit(f"unknown option {a} (use -d/-f/-p/-ckpt"
                             "/-resume)")
    return d_file, tuple(f_files), tuple(p_overrides), ckpt, resume


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    d_file, f_files, p_overrides, ckpt_path, resume = _parse_cli(argv)
    prm: EncoderParams = load_params(EncoderParams, d_file, f_files,
                                     p_overrides)
    prm.validate()
    if prm.ignored:
        print(f" Note: {len(prm.ignored)} unimplemented config parameters "
              "accepted and ignored.")

    # packed / >8-bit sources (lcommon/src/input.c deinterleave_*):
    # Interleaved=1 + PixelFormat select packed 4:2:2 (UYVY/YUY2/YVYU/
    # V210); SourceBitDepthLuma>8 selects 16-bit-LE planar samples
    interleaved = int(prm.extra.get("Interleaved", 0))
    pix_fmt = int(prm.extra.get("PixelFormat", 0)) if interleaved else None
    src_bd = int(prm.extra.get("SourceBitDepthLuma", 8))
    if interleaved or src_bd > 8:
        from .input import read_frames
        frames = read_frames(prm.InputFile, prm.SourceWidth,
                             prm.SourceHeight, prm.FramesToBeEncoded,
                             start=prm.StartFrame,
                             chroma_format=prm.YUVFormat
                             if prm.YUVFormat in (1, 2) else 1,
                             bit_depth=src_bd, pixel_format=pix_fmt)
        if src_bd > 8 or pix_fmt == 4:
            raise SystemExit(" >8-bit ENCODING is not implemented yet "
                             "(the decoder is); rescale the source or "
                             "use an 8-bit input")
        if pix_fmt is not None and prm.YUVFormat != 2:
            raise SystemExit(" packed sources are 4:2:2; set YUVFormat=2")
    else:
        frames = read_yuv420_frames(prm.InputFile, prm.SourceWidth,
                                    prm.SourceHeight,
                                    prm.FramesToBeEncoded,
                                    prm.StartFrame,
                                    chroma_format=prm.YUVFormat
                                    if prm.YUVFormat in (1, 2) else 1)
    if len(frames) < prm.FramesToBeEncoded:
        print(f"Incorrect FramesToBeEncoded: actual number is "
              f"{len(frames):>6} frames!")

    cfg = prm.to_encoder_config()
    cfg.qp = prm.QPISlice
    cfg.qp_p = prm.QPPSlice

    # MVC stereo: the View1ConfigFile supplies the dependent view's
    # InputFile/ReconFile (lencod.c second-view config; tuning params of
    # the second view are accepted-and-shared with view 0)
    frames1 = []
    v1_recon_path = ""
    if prm.NumberOfViews == 2:
        from ..config import parse_cfg_text
        v1_input = ""
        if prm.View1ConfigFile:
            with open(prm.View1ConfigFile, encoding="latin-1") as fh:
                kv1 = parse_cfg_text(fh.read())
            v1_input = kv1.get("InputFile", "")
            v1_recon_path = kv1.get("ReconFile", "")
        frames1 = read_yuv420_frames(
            v1_input, prm.SourceWidth, prm.SourceHeight,
            prm.FramesToBeEncoded, prm.StartFrame,
            chroma_format=prm.YUVFormat if prm.YUVFormat in (1, 2) else 1)
        if len(frames1) < len(frames):
            raise SystemExit("view-1 input shorter than view 0")
    start_at = 0
    if resume:
        import os

        from ..encoder import checkpoint as CK
        enc, start_at, nbytes = CK.load(ckpt_path, device=device)
        # a killed run leaves the partial stream at OutputFile+'.part'
        # (written alongside each checkpoint); a completed-then-resumed
        # run has OutputFile itself
        part = prm.OutputFile + ".part"
        src = part if os.path.exists(part) else prm.OutputFile
        with open(src, "rb") as fh:
            prior = fh.read(nbytes)     # truncate any partial GOP tail
    else:
        enc = Encoder(cfg, device=device)

    print(" Frame     Bit/pic    QP   SnrY    SnrU    SnrV    "
          "Time(ms)  Frm  Ref")
    out = bytearray()
    if resume:
        out += prior
    recon = bytearray()
    tot_bits = 0
    snr_acc = np.zeros(3)
    ssim_acc = np.zeros(3)
    msssim_acc = np.zeros(3)
    t_seq0 = time.time()
    if int(prm.extra.get("ExplicitSeqCoding", 0)):
        # script-file-driven coding order (lencod explicit_seq.c)
        from ..encoder.gop import (encode_explicit_seq,
                                   parse_explicit_seq_file)
        seq_file = prm.extra.get("ExplicitSeqFile", "explicit_seq.txt")
        with open(seq_file, encoding="latin-1") as fh:
            entries = parse_explicit_seq_file(fh.read())
        for chunk in encode_explicit_seq(enc, frames, entries):
            out += chunk
    else:
        for i, (Y, U, V) in enumerate(frames):
            if i < start_at:
                continue
            if ckpt_path and i > start_at:  # also re-checkpoint resumed runs
                from ..encoder import checkpoint as CK
                if CK.checkpointable(enc):
                    with open(prm.OutputFile + ".part", "wb") as fh:
                        fh.write(out)
                    CK.save(enc, ckpt_path, len(out))
            out += enc.encode_frame(Y, U, V,
                                    view1=frames1[i] if frames1 else None)
        out += enc.flush()
    t_seq = time.time() - t_seq0
    qp_of = {"I": prm.QPISlice, "P": prm.QPPSlice, "B": prm.QPBSlice}
    n_met = 0                  # results carrying recon (not ckpt-restored)
    for r in sorted(enc.results, key=lambda r: r["disp"]):
        idx = r["disp"]
        rec = r.get("frame")
        if rec is None:
            # checkpoint-restored entry: bits survive, recon was dropped
            tot_bits += r["bits"]
            continue
        n_met += 1
        Y, U, V = frames[idx]
        s = (psnr(Y, rec.Y), psnr(U, rec.U), psnr(V, rec.V))
        snr_acc += s
        if prm.DistortionSSIM:
            ssim_acc += (ssim(Y, rec.Y, overlap=prm.SSIMOverlapSize),
                         ssim(U, rec.U, overlap=prm.SSIMOverlapSize),
                         ssim(V, rec.V, overlap=prm.SSIMOverlapSize))
        if prm.DistortionMSSSIM:
            msssim_acc += (ms_ssim(Y, rec.Y, overlap=prm.SSIMOverlapSize),
                           ms_ssim(U, rec.U, overlap=prm.SSIMOverlapSize),
                           ms_ssim(V, rec.V, overlap=prm.SSIMOverlapSize))
        bits = r["bits"]
        tot_bits += bits
        label = {"I": "IDR", "P": " P ", "B": " B "}[r["type"]]
        qp_show = r.get("qp", qp_of[r["type"]])
        print(f"{idx:05d}({label}) {bits:7d}  {qp_show:3d} "
              f"{s[0]:7.3f} {s[1]:7.3f} {s[2]:7.3f}          -  FRM "
              f"{min(idx, cfg.num_ref):4d}")
        if prm.ReconFile:
            recon += rec.Y.tobytes() + rec.U.tobytes() + rec.V.tobytes()

    if prm.NumberLeakyBuckets > 0:     # HRD leaky-bucket params
        from ..encoder.leaky_bucket import calc_buffer, write_buffer
        per_pic = [r["bits"] for r in sorted(enc.results,
                                             key=lambda r: r["disp"])]
        buckets = calc_buffer(per_pic, prm.FrameRate,
                              n_buckets=prm.NumberLeakyBuckets)
        write_buffer(prm.LeakyBucketParamFile, buckets)
        print(f" Leaky bucket params ({len(buckets)}) written to "
              f"{prm.LeakyBucketParamFile}")
    if prm.OutFileMode == 1:           # RTP dump container (lencod rtp.c)
        from ..bitstream.rtp import annexb_to_rtp
        out = annexb_to_rtp(bytes(out))
    with open(prm.OutputFile, "wb") as fh:
        fh.write(out)
    if ckpt_path:
        import os
        try:                               # completed: drop the partial file
            os.remove(prm.OutputFile + ".part")
        except OSError:
            pass
    if prm.ReconFile:
        with open(prm.ReconFile, "wb") as fh:
            fh.write(recon)

    n_all = max(len(frames), 1)
    n = max(n_met, 1)          # PSNR averages cover measured frames only
    print("-" * 64)
    print(f" Total encoding time for the seq.  : {t_seq:8.3f} sec "
          f"({n_all / t_seq:.2f} fps)")
    print(f" Y PSNR (dB)                       : {snr_acc[0] / n:8.3f}")
    print(f" U PSNR (dB)                       : {snr_acc[1] / n:8.3f}")
    print(f" V PSNR (dB)                       : {snr_acc[2] / n:8.3f}")
    if prm.DistortionSSIM:
        print(f" Y/U/V SSIM                        : "
              f"{ssim_acc[0] / n:7.4f} {ssim_acc[1] / n:7.4f} "
              f"{ssim_acc[2] / n:7.4f}")
    if prm.DistortionMSSSIM:
        print(f" Y/U/V MS-SSIM                     : "
              f"{msssim_acc[0] / n:7.4f} {msssim_acc[1] / n:7.4f} "
              f"{msssim_acc[2] / n:7.4f}")
    print(f" Total bits                        : {tot_bits} ")
    print(f" Bit rate (kbit/s)  @ {prm.FrameRate:.2f} Hz     : "
          f"{tot_bits * prm.FrameRate / n_all / 1000:.2f}")
    if prm.StatsFile:
        with open(prm.StatsFile, "a", encoding="ascii") as fh:
            fh.write(f"bits={tot_bits} frames={n} "
                     f"snr_y={snr_acc[0] / n:.3f} snr_u={snr_acc[1] / n:.3f} "
                     f"snr_v={snr_acc[2] / n:.3f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
