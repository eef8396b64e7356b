"""Decoder CLI: JM ldecod twin, the port's copy of jm_tpu/tools/ldecod.py,
on the card unless main is given device="cpu":

    python -m jm_tpu_torch.tools.ldecod -d decoder.cfg | -i in.264
        -o out.yuv [-r ref.yuv]

Both views of an MVC stream go into the one output file, sorted by POC
(a stable sort: view 0 before view 1 at each POC), as in jm_tpu.

Parity with ldecod/src/ldecod.c (main/Report) + image.c:1132 find_snr:
decodes an Annex-B stream to planar YUV in output (POC) order, optionally
computing per-frame PSNR against a reference YUV. Accepts the reference
decoder.cfg (ldecod/inc/configfile.h param set; extras ignored) or
positional/-i/-o/-r arguments.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..config import DecoderParams, load_params
from ..decoder.decoder import H264Decoder
from ..metrics import psnr


def _parse_cli(argv):
    d_file, f_files, p_overrides = None, [], []
    pos = []
    i = 0
    opts = {}
    while i < len(argv):
        a = argv[i]
        if a == "-d":
            d_file = argv[i + 1]; i += 2
        elif a == "-f":
            f_files.append(argv[i + 1]); i += 2
        elif a == "-p":
            p_overrides.append(argv[i + 1]); i += 2
        elif a == "-i":
            opts["InputFile"] = argv[i + 1]; i += 2
        elif a == "-o":
            opts["OutputFile"] = argv[i + 1]; i += 2
        elif a == "-r":
            opts["RefFile"] = argv[i + 1]; i += 2
        elif a in ("-h", "--help"):
            print(__doc__)
            raise SystemExit(0)
        elif not a.startswith("-"):
            pos.append(a); i += 1
        else:
            raise SystemExit(f"unknown option {a} (use -d/-f/-p/-i/-o/-r)")
    # bare positional like the reference: ldecod file.264
    if pos and "InputFile" not in opts:
        opts["InputFile"] = pos[0]
    return d_file, tuple(f_files), tuple(p_overrides), opts


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    d_file, f_files, p_overrides, opts = _parse_cli(argv)
    prm: DecoderParams = load_params(DecoderParams, d_file, f_files,
                                     p_overrides)
    for k, v in opts.items():
        setattr(prm, k, v)

    t0 = time.time()
    dec = H264Decoder(device=device, conceal_mode=prm.ConcealMode)
    with open(prm.InputFile, "rb") as fh:
        data = fh.read()
    if prm.FileFormat == 1:            # RTP dump container (ldecod rtp.c)
        from ..bitstream.rtp import rtp_to_annexb
        data = rtp_to_annexb(data)
    frames = dec.decode_annexb(data)
    frames.sort(key=lambda f: f.poc)
    dt = time.time() - t0
    for m in dec.sei_messages:
        desc = {0: "buffering_period", 1: "pic_timing", 2: "pan_scan_rect",
                5: "user_data_unregistered", 6: "recovery_point",
                9: "scene_info", 45: "frame_packing"}.get(
            m.payload_type, f"type {m.payload_type}")
        extra = ""
        if m.payload_type == 5 and "data" in m.fields:
            extra = " " + repr(m.fields["data"][:40])
        print(f" SEI: {desc} ({len(m.payload)} bytes){extra}")

    ref_data = None
    if prm.RefFile:
        try:
            ref_data = open(prm.RefFile, "rb").read()
        except OSError:
            print(f" Note: reference file {prm.RefFile} not found - "
                  "no SNR computation")

    with open(prm.OutputFile, "wb") as fh:
        print(" Frame    POC   QP  SnrY    SnrU    SnrV")
        for i, f in enumerate(frames):
            fh.write(f.Y.tobytes())
            if prm.WriteUV:
                fh.write(f.U.tobytes())
                fh.write(f.V.tobytes())
            line = f"{i:05d}  {f.poc:5d}    -"
            if ref_data is not None:
                h, w = f.Y.shape
                ch, cw = f.U.shape
                fsz = h * w + 2 * ch * cw
                r = np.frombuffer(ref_data[i * fsz:(i + 1) * fsz], np.uint8)
                if r.size == fsz:
                    ry = r[:h * w].reshape(h, w)
                    ru = r[h * w:h * w + ch * cw].reshape(ch, cw)
                    rv = r[h * w + ch * cw:].reshape(ch, cw)
                    line += (f" {psnr(ry, f.Y):7.3f} {psnr(ru, f.U):7.3f}"
                             f" {psnr(rv, f.V):7.3f}")
            print(line)
    n = len(frames)
    st = dec.stats
    print("-" * 48)
    print(f" Slices: {st['slices']}  MBs: I4 {st['mb_intra4']} "
          f"I8 {st['mb_intra8']} I16 {st['mb_intra16']} "
          f"inter {st['mb_inter']} skip {st['mb_skip']} "
          f"ipcm {st['mb_ipcm']}")
    for t in sorted(st["nal_bits"]):
        name = {1: "slice", 5: "IDR", 6: "SEI", 7: "SPS", 8: "PPS"}.get(
            t, f"nal{t}")
        print(f"  {name:>6}: {st['nal_count'][t]:4d} NALUs "
          f"{st['nal_bits'][t]:8d} bits")
    print(f" Total Frames: {n:3d}  decode time: {dt:7.3f} sec "
          f"({n / dt if dt > 0 else 0.0:.2f} fps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
