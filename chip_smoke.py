"""Chip smoke test of the PyTorch/CUDA port (jm_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card name and power limit; build the port's host C++ runtime from
     jm_tpu_torch/native (g++, into build/native) and the CUDA kernels
     from jm_tpu_torch/kernels (into build/kernels), and time both builds;
  2. kernels: the luma (K1) and chroma (K2) deblock kernels, one
     persistent launch per picture each, against their plain PyTorch
     versions on the card, over random pictures with random bS 0..4,
     per-MB QP 0..51, disable_deblocking_filter_idc 0/1/2 with several
     slice ids, non-zero alpha/beta offsets and 8x8 transform MBs;
     bit-exact required at 1080p (three variants), at 3840x2160 (135 MB
     rows, more than the card's SMs: CTAs take a second row), at 16x16,
     32x1088, 1920x16 and 16x1088 (mb_w 1, mb_w 2, mb_h 1, one column),
     and over 50 repeated launches at 1080p (a race in the row-progress
     counters shows only now and then); CUDA-event times at 1080p (median
     of 7 runs of 20 back-to-back calls, after warm-up) beside each
     kernel's bound and beside the same kernel with every bS zero (the
     dependency chain with no filtering) and the plain version's time
     (its checking call on that 1080p case, by CUDA events), and the
     chain's two step costs,
     with every bS zero: one MB row of 120 MBs (1920x16: an in-row step)
     and one MB column of 68 rows (16x1088: a handoff between rows);
  3. encode: Encoder(...).encode_stream on the 17-frame 1080p IPPP
     sequence (QP 28, search range 16) with the kernel launch counters
     reset just before and read just after: one launch per kernel and
     frame;
  4. cross-check: the first two frames (IDR + P) encoded again on the
     CPU (by a worker) with the plain versions must give the same
     payloads and deblocked reconstruction;
  5. torch.profiler over one P frame: wall and device-busy time, idle
     share and the ops with the most device time;
  6. decode on the card: after a warm-up decode of the first 3 frames,
     H264Decoder(device="cuda").decode_annexb of the whole 17-frame
     stream of phase 3, with the kernel launch counters reset just before
     and read just after: every frame must equal the encoder's deblocked
     recon byte for byte, and each kernel is launched once per picture.
     Prints frames/s, IDR ms, P ms, the host parse / host intra recon /
     device-stage split, and a torch.profiler view of the decode of the
     IDR and of one P picture (the kernels' device time inside it).
     Then the JM goldens tests/golden/ipp3.264 and qp20.264, decoded on
     the card, must equal their _rec.yuv (JM ldecod's output);
  7. decode cross-check: the first two frames (IDR + P) decoded on the
     CPU (plain deblock) must equal the CUDA decode;
  8. md_low: the 17-frame sequence encoded with device_rd=False, one
     launch per kernel and frame, frames/s and IDR / P ms, the P frames
     serialized on the host (packer overflow); IDR + P encoded again on
     the CPU (by a worker, checked after phase 14) must give the same
     payloads and recon; torch.profiler over one md_low P frame's pipe;
  9. a scene cut: the first CUT_FRAMES frames with frame 2 replaced by
     independent content (another seed), so that the pipe's intra
     speculation fails and the frame is finished on the per-frame path
     (device encode reused, host intra re-encode, mixed deblock on the
     card); the launch count must be one per frame, plus one per
     fallback, plus one per re-dispatched next frame. Prints the intra
     MBs re-encoded and each fallback frame's wall split (pipe,
     download, host re-encode, device deblock + prep_ref, serialize,
     re-dispatch); the same frames on the CPU (by a worker, checked
     after phase 14) must give the same payloads and recon;
 10. the scene-cut stream decoded on the card (mixed P pictures): every
     frame equal to the encoder's recon, one launch per kernel and
     picture;
 11. the all-modes RD tier, p_mode_rd_device(top_modes=4), at 1080p on
     the card against device="cpu" on the same inputs, every field
     equal, with its device ms beside the pruned tier's;
 12. CABAC encode: the first N_CABAC frames with entropy="cabac" and
     cabac_adapt_init (the per-frame path for every frame), one launch
     per kernel and frame, every deblocked recon equal to phase 3's (the
     entropy coder changes no decision); frames/s, IDR and P ms, and per
     frame the device encode, download + host commit, device deblock +
     prep_ref and host CABAC serialize (ms per MB), the cabac_init_idc of
     each P slice, and the CABAC bytes beside phase 3's CAVLC bytes of
     the same frames;
 13. CABAC decode on the card: phase 12's stream, every frame equal to
     the encoder's recon, one launch per kernel and picture, the parse /
     host recon / device split per picture; then JM lencod's CABAC
     golden tests/golden/cabac_pp.264 (I/P/P, two references) on the
     card against its _rec.yuv;
 14. host runtime: the native C++ runtime against its Python twins at
     1080p, each timed: the CAVLC serializer on phase 3's IDR and on one
     of phase 8's packer-overflow P pictures (bytes equal to each other
     and to the slice the phase emitted), the CAVLC parser on phase 3's
     IDR and first P slice (every PictureData array equal), the intra
     recon of that IDR (planes equal), and the CABAC parse of phase 12's
     IDR with the native and the Python CabacEngine (arrays equal);
 15. low latency at 1080p: the first LL_FRAMES frames with one MB row
     per slice (68 slices), frame-level rate control at 8 Mbit/s and POC
     type 2 (the per-frame path: the IDR's 68 slices through the serial
     host intra encoder, each P at its own QP), one launch per kernel and
     picture; frames/s, each picture's QP, bytes and slices, the IDR's
     host intra encode in ms per MB, and each frame's split (device
     encode, host intra encode, download + host commit, device deblock +
     prep_ref, serialize); the stream decoded on the card equal to the
     recon; the IDR and the first two P frames encoded on the CPU with
     the same bytes and QPs;
 16. FMO at CIF (352x288, N_CIF frames): map type 1 with two slice
     groups, slices of at most 1500 bytes (slice_mode 2: pictures
     re-coded until they fit), md_low, qp 28 / qp_p 30, POC type 1; one
     launch per kernel and picture, every slice within its limit, the
     codings per picture, and the stream decoded on the card equal to
     the recon;
 17. CABAC at CIF with 22 MBs per slice, cabac_adapt_init and rate
     control at 1 Mbit/s, encoded and decoded on the card as phase 16;
     then JM's FMO goldens fmo_t1 / fmo_t3 / fmo_t5d1 / fmo_t6 decoded on
     the card against their _rec.yuv;
 18. a resilient 1080p stream through encode_stream (RES_FRAMES frames,
     the per-frame path): data partitions, a long-term anchor every 2nd
     picture (frame 3 predicts from frame 1, past the long-term frame 2),
     VUI timing and a 16-byte user-data SEI; one launch per kernel and
     frame, frames/s, each P frame's split (device encode, download +
     host commit, device deblock + prep_ref, the Python DP serializer),
     the bytes of partitions A / B / C; IDR + 3 P encoded on the CPU
     with the same bytes and recon; decoded on the card (partitioned
     slices on the Python parser) equal to the recon, with the user data
     in sei_messages;
 19. redundant pictures through encode_frame + flush (the only route
     that writes them, as in jm_tpu): a redundant coding after every 2nd
     P at QP + 4, with POC-based MMCO; one launch per kernel and primary
     picture (the redundant codings are not deblocked); each P frame's
     split and its redundant coding's device encode, download + commit,
     serialize and bytes; IDR + 3 P (two redundant codings) encoded on
     the CPU with the same bytes and recon; decoded on the card equal to
     the recon (the redundant codings discarded), and again with frame
     2's primary dropped: its redundant coding decoded instead, the
     first LOSSY_CPU pictures equal to the CPU decode of the same lossy
     stream's first LOSSY_CPU pictures;
 20. the loop filter off (deblock=False, the per-frame path): no kernel
     launch in the encode, frames/s beside phase 3's, the decode on the
     card equal to the recon with its launches counted;
 21. JM's data-partitioned goldens on the card: dp1.264 equal to its
     _rec.yuv and to the CPU decode, cif_dp.264 (MMCO, five references)
     to the CPU decode; frames/s and the per-picture parse split;
 22. B pictures at 1080p: the first B_FRAMES frames through encode_frame
     with num_b=1, CABAC, QP 28 (qp_b 30), SR 16, coded I0 P2 B1; one
     launch per kernel and picture (K1/K2 deblock the non-reference B
     too), frames/s, each picture's ms and bytes, the B picture's split
     (device SAD tables of both lists, the serial host MB loop in ms per
     MB, device deblock + prep_ref, the host CABAC serializer in ms per
     MB) and its MB decisions (direct, skip, list 0, list 1, bi, intra);
     the same frames encoded on the CPU give the same bytes and recon;
 23. B decode on the card: phase 22's stream, every frame equal to the
     encoder's recon, one launch per kernel and picture, the per-picture
     split (parse, intra recon, device B recon + bS + K1/K2 + prep_ref),
     the B parse in ms per MB; then JM's B goldens cavlc_b, main3, main9,
     main9t (temporal direct) and poc1b (POC type 1) against their
     _rec.yuv in POC order, and cif_main (CABAC CIF, 19 B pictures)
     against the CPU decode, each with one launch per kernel and picture
     and its frames/s;
 24. GOP variants at CIF: GOP_FRAMES frames, num_b 3 as a dyadic pyramid,
     intra_period 2 (anchors: the third is an open-GOP I), the recovery
     point SEI and CRA marking, CAVLC, through encode_frame; one launch
     per kernel and picture, the pictures' bytes and split; decoded on
     the card equal to the recon with one recovery point per open-GOP I;
     the IDR and the first mini-GOP (GOP_CPU frames) encoded on the CPU
     with the same bytes and recon;
 25. weighted P at 1080p: the first WP_FRAMES frames as a fade to black
     (luma scaled by 1 - WP_FADE k, chroma pulled toward 128 alike),
     QP 28, SR 16, CAVLC (Main), weighted_pred 1, through
     encode_stream: one launch per kernel and picture; the IDR and P
     ms, the weighted P picture's split (reference download, estimate,
     device quadrant SAD table, the serial host P coder's MB loop in ms
     per MB, device deblock + prep_ref, serialize), its MB decisions,
     table and bytes; both pictures encoded on the CPU with the same
     bytes and recon;
 26. weighted CIF streams of the fade's top-left 352x288 (WP_CIF): (a)
     num_b 1, CABAC, weighted P and explicit weighted B; (b) a pyramid
     of 3 Bs with implicit weights, CAVLC; (c) weighted P with the LMS
     estimate and wp_mcprec (each P picture coded, and deblocked, three
     times); each with frames/s, the per-picture split, bytes and
     launches, and encoded on the CPU with the same bytes and recon;
 27. weighted decode on the card: the streams of phases 25-26, each
     equal to its encoder's recon and to its CPU decode, one launch per
     kernel and picture; JM's goldens wp_p (explicit P), wp_bi
     (implicit B) and wp_both (explicit P and B) against their
     _rec.yuv, with the parse and device ms of each picture; CUDA-event
     ms of the weighted inter_recon_p / inter_recon_b at 1080p beside
     the unweighted ones on the same motion;
 28. the host pipeline and the High profile at 1080p: the first
     HIGH_FRAMES frames, QP 28, SR 16, CAVLC, pipeline="host",
     transform8x8, through encode_stream: one launch per kernel and
     picture, both slices serialized natively; the IDR's ms (the host
     IntraPicture, ms per MB) and the P's split (device quadrant SAD
     table, the host MB loop in ms per MB by part, device deblock +
     prep_ref, the native serializer), the MB decisions with the MBs
     coded 8x8, the bytes beside phase 3's first two pictures; both
     pictures encoded on the CPU with the same bytes and recon;
 29. CIF host-pipeline streams of the top-left 352x288 (HIGH_CIF): (a)
     jm_tpu's default configuration, IPP; (b) CABAC, transform8x8,
     num_b 1; (c) scaling_matrix 3 with the spec's default lists, the
     default offsets, adaptive rounding and transform8x8; each with
     frames/s, the per-picture split, bytes and launches, and encoded on
     the CPU with the same bytes and recon;
 30. High decode on the card: the streams of phases 28-29, each equal to
     its encoder's recon and to its CPU decode, one launch per kernel
     and picture, every CAVLC 8x8 slice parsed and every Intra8x8
     picture reconstructed natively; JM's goldens high8x8, high8x8c and
     high8x8sm against their _rec.yuv with frames/s and the per-picture
     parse / intra recon / device split; CUDA-event ms of
     p_dec_residuals at 1080p without and with every MB's 8x8 transform
     on the same levels;
 31. the host coders' motion options at 1080p: the first MOTION_FRAMES
     frames, QP 28, SR 16, CAVLC, the device pipeline with num_ref 2 and
     EPZS with HME, through encode_stream: the IDR and the first P on
     the device route (one active reference), the second P by the host
     P coder with two references; one launch per kernel and picture;
     each picture's ms, the host P's split and ms per MB by part, its
     searcher's SAD evaluations per MB, its partitions from reference 1,
     its bytes beside phase 3's second P; all three pictures encoded on
     the CPU with the same bytes and recon;
 32. CIF streams of the top-left 352x288 (MOTION_CIF): (a) pipeline
     "host", num_ref 2, sub8x8, transform8x8, CAVLC, with the 4x4 SAD
     tables' build and download; (b) UMHex, num_ref 2, SAD in the
     fractional search, CABAC, num_b 1; (c) UMHex simple with long-term
     references (long_term_period 3), num_ref 2; (d) basic-unit rate
     control (one CIF MB row per unit) with its QPs and the MBs of the
     QP fault it copies from jm_tpu; (e) the explicit sequence script of
     tests/test_explicit_seq.py with num_ref 2; each with frames/s, the
     per-picture split, bytes and launches, and encoded on the CPU with
     the same bytes and recon;
 33. their decodes on the card: each equal to its CPU decode and, but
     (d), to its encoder's recon; (d)'s MBs that differ from the recon
     counted; one launch per kernel and picture;
 34. the RD tiers on the device route at 1080p: the first RD_FRAMES
     frames (IDR + 2 P) with rd_cfg()'s RD CAVLC, rd_picture_decision
     and rdoq with rdoq_dc, rdoq_cr and rdoq_dc_cr, through
     encode_stream (off the pipe): each P coded on the device at QP,
     QP - 1 and QP + 1, each coding committed on the host (its intra MBs
     trellis-coded), deblocked by K1/K2 and serialized, the least frame
     J shipped; one launch per kernel and coding (1 + 3 + 3); each
     coding's QP, bytes, J and wall ms and the intra MBs re-encoded; all
     three pictures encoded on the CPU with the same bytes and recon;
 35. the host RD tiers at QCIF (176x144, the top-left of the sequence,
     pipeline "host", RD_QCIF_FRAMES frames each, RD_QCIF): (a) CAVLC,
     rdo 1, enable_ipcm 1 and the four trellis flags at QP 12, with a new
     seeded noise patch in each frame, where I_PCM wins MBs; (b) CABAC,
     rdo 2, the trellis flags, transform8x8, num_b 1; (c) rdo 3 with two
     simulated lossy decoders at 5 % loss; (d) CABAC, enable_ipcm 2,
     num_b 1; (e) CAVLC, rdo 4, rd_picture_decision; each with frames/s,
     the per-picture split and host MB loop in ms per MB, MB classes,
     I_PCM MBs and codings, one launch per kernel and coding, the CAVLC
     slices with I_PCM on the Python serializer, and encoded on the CPU
     with the same bytes and recon;
 36. their decodes on the card: each equal to its encoder's recon and
     to its CPU decode, one launch per kernel and picture, the pictures
     with I_PCM MBs on the Python parser (CAVLC) and intra recon;
 37. K2-422, the chroma kernel at 4:2:2 (kernels.deblock_chroma with
     crows 4: 16 chroma lines per MB), against deblock_chroma_plain on
     the card, bit for bit, at 1080p 4:2:2 (chroma 960x1088 a plane) in
     the three parameter variants, at 3840x2160, at the four edge
     shapes and over REPEATS launches; CUDA-event times at 1080p (median
     of 7 runs of 20 calls) beside its bound, its all-bS-zero chain and
     the plain twin (its checking call at 1080p);
 38. 4:2:2 encodes, every picture on the host coders (as in jm_tpu):
     the first frame at 1080p with 4:2:2 chroma (to_422: Cb / Cr the
     even / odd columns of each luma row), CAVLC, QP 28, an IDR through
     IntraPicture: one launch each of K1 and K2-422, its ms and ms per
     MB, its bytes, its deblock held against deblock_plain on the card
     on the same pre-deblock planes; then the CIF 4:2:2 streams of
     Y422_CIF, (a) CAVLC IPP and (b) CABAC IbP with transform8x8 and
     scaling_matrix 3, each with frames/s, the per-picture split,
     bytes and launches; all encoded again on the CPU with the same
     bytes and recon;
 39. 4:2:2 decodes on the card: phase 38's streams, each equal to its
     encoder's recon and to its CPU decode, one launch each of K1 and
     K2-422 per picture, the CAVLC I / P slices on the Python parser
     (route "yuv422", as in jm_tpu); JM's goldens y422 (CABAC IPB, 8x8)
     and y422c (CAVLC IPP) against their _rec.yuv, and cif_422 (30 CIF
     frames) against the sha256 of ldecod's output, each with frames/s
     and the per-picture parse / host recon / device split;
 40. the >8-bit deblock kernels (int16 planes: K1-HBD, K2-HBD and
     K2-422-HBD, counted under deblock_luma16, deblock_chroma16 and
     deblock_chroma422_16) against the plain twins on the card, bit for
     bit, at 1080p in the three parameter variants at 10 bits (the
     mixed one over REPEATS launches) and the mixed one at 14 bits, and
     at the four edge shapes at 10 and 14 bits, with per-MB QPY from
     -QpBdOffsetY to 51 and chroma QP offsets; at 1080p 10 bits each
     variant's CUDA-event time beside its bound (2 bytes a sample), its
     all-bS-zero chain and the plain twin (its checking call);
 41. High 10 decodes on the card: phase 3's first HBD_FRAMES pictures
     under a High 10 SPS (reheaded: profile 110, 10-bit luma and
     chroma; other pictures than the 8-bit decode, fixed by the spec):
     one launch each of K1-HBD and K2-HBD per picture and no 8-bit
     kernel, every CAVLC slice on the native parser, the intra recon on
     the Python walk; frames/s and the per-picture parse / intra recon /
     device split; every frame equal to the CPU decode (a worker's); the
     same for phase 38's CIF 4:2:2 stream (a) under a 10-bit profile-122
     SPS (K1-HBD and K2-422-HBD); JM's goldens hi10c (CAVLC) and hi10
     (CABAC, B pictures) against their _rec.yuv (uint16);
 42. lossless decodes on the card: JM's goldens lossless (CAVLC) and
     lossless_cabac (profile 244, every MB at QP 0: transform bypass and
     intra DPCM), whose sha256 must equal the one tier-1 holds against
     jm_tpu's decode (LOSSLESS_SHA256), one launch of K1 and K2 a
     picture;
 43. K1 and K2 at the field shapes, a 1080p field (1920x544) and a CIF
     field (352x144), with field boundary strengths (ops/deblock
     compute_bs(field=True): bS 3 on the horizontal MB edges next to
     intra MBs, the vertical MV limit 2) and mixed per-MB parameters,
     against their plain twins on the card, bit for bit (over REPEATS
     launches at the 1080p field); CUDA-event times beside the bound,
     the all-bS-zero chain and the plain twins; the same for K1-HBD and
     K2-HBD (10 bits), K2-422 and K2-422-HBD (10 bits) at both field
     shapes (over 10 launches at the 1080p field);
 44. field coding (pic_interlace 1; every field on the host coders, as
     in jm_tpu): the sequence's first frame at 1080p as a field pair (an
     IDR top field through IntraPicture, a P bottom field through the
     host P coder against it), then FIELD_CIF_FRAMES CIF frames with
     num_ref 2 (P fields of up to four reference fields, both
     parities); one launch each of K1 and K2 per field picture, each
     field's ms, ms per MB and bytes, the P fields' MB decisions; the
     payloads and every field's recon equal the CPU run (a worker's);
     each stream decoded on the card: every frame equal to the woven
     recon and to the CPU decode, one launch each of K1 and K2 per field
     picture, frames/s and the per-field split;
 45. JM's field goldens on the card: field1 and fieldcab (CAVLC and
     CABAC frame pictures under an SPS that allows fields, cropped in
     units of 4 rows) and field2 (field pictures, four reference frames)
     against their _rec.yuv, cif_field (60 CIF field pictures) against
     the sha256 of ldecod's output; one launch each of K1 and K2 per
     picture;
 46. K1 and K2 at 1080p on the boundary strengths of an SP picture
     (ops/deblock compute_bs(sp_slice=): bS 4 on every MB edge, 3 on every
     inner edge, the filter on everywhere: the kernels' worst case) over
     REPEATS launches, and of a half-SP picture (two of three slices SP,
     the mixed per-MB parameters), against their plain twins on the card,
     bit for bit; CUDA-event times beside the bound, the all-bS-zero
     chain and the plain twins;
 47. SP switching pictures (sp_periodicity; the I and P pictures on the
     device route, each SP picture on the host P coder, as in jm_tpu):
     the sequence's first SP_FRAMES frames at 1080p with sp_periodicity
     2, qp_sp 30, qp_sp2 32 (a device IDR, a device P, a host SP picture)
     and the CIF streams of SP_CIF (a: 9 frames, sp_periodicity 3; b: 6
     frames, sp_periodicity 2, num_b 1); one launch each of K1 and K2 per
     picture, each picture's ms and bytes, each SP picture's ms per MB
     and MB loop split (search, commit, the SP levels); the payloads and
     recon equal the CPU run (a worker's); each stream decoded on the
     card equal to the recon and to the CPU decode, one launch each of K1
     and K2 per picture, the SP slices on the native parser (route "sp");
     JM's goldens sp1 against its _rec.yuv and cif_sp against the sha256
     of ldecod's output; the CUDA-event ms of ops/dec.sp_recon on every
     MB of a 1080p picture;
 48. concealment (H264Decoder(conceal_mode=1 / 2)) on the card: phase 3's
     first CONCEAL_1080P pictures with picture 3 dropped (a frame_num gap:
     one frame concealed whole), and a CIF stream of 4 slices per picture
     encoded on the card with an IDR slice and a P slice dropped, a slice
     cut mid-payload and a picture dropped; each decode equal to the CPU
     decode of the same bytes (a worker's) with the same
     concealed_count, one launch each of K1 and K2 per reconstructed
     picture (none for a frame concealed whole), frames/s and the
     concealment's ms;
 49. MVC stereo at 1080p (num_views 2 on phase 3's device route: view 0
     the device I frame and device P, every view-1 picture the host P
     coder, as in jm_tpu): the sequence's first MVC_FRAMES frames as view
     0 and the same frames shifted MVC_SHIFT luma columns as view 1, an
     anchor access unit (view 1 from view 0 alone) and a non-anchor one
     (view 0, then view 1's reference, behind the inter-view command);
     one launch each of K1 and K2 per picture of each view; each access
     unit's ms and bytes, each view-1 picture's ms and ms per MB, the NAL
     20 bytes against the NAL 1 / 5 bytes; the payloads and the recon of
     both views equal the CPU run (a worker's); the stream decoded on the
     card: each view equal to its recon, one launch each of K1 and K2 per
     picture, frames/s per view;
 50. CIF stereo streams of the top-left 352x288 (MVC_CIF): (a) IPPP, 6
     frames, intra_period 3 (two anchors); (b) num_b 1, CABAC, num_ref 2,
     view1_qp_offset 2, 5 frames (view-1 B pictures); each as phase 49;
 51. JM lencod's stereo golden stereo_jm.264 decoded on the card, each
     view's sha256 equal to JM's recon; the port's lencod
     (jm_tpu_torch.tools.lencod.main) on a CIF stereo cfg of
     MVC_TOOLS_FRAMES frames with a View1ConfigFile, then ldecod on its
     stream, on the card: the stream, the recon (view 0; lencod writes
     no view-1 recon, as jm_tpu's) and the decoded YUV (both views in
     one file, sorted by POC) equal the same run on the CPU (a
     worker's), one launch each of K1 and K2 per picture in each;
 52. MB-row sharding (EncoderConfig.sp_shards, parallel/sp_pipeline.py):
     the sequence's first SHARD_FRAMES frames with md_low through
     encode_frame, unsharded and with sp_shards 2 and 4 over card_mesh
     (the cards torch sees in turn; on one card its entries repeat
     cuda:0 and the bands run one after another): the payloads and recon
     of each equal the unsharded stream's, sp_steps the P pictures, one
     launch each of K1 and K2 per picture, each stream decoded on the
     card equal to its recon; sp_shards 8, which does not divide the 68
     MB rows, takes the unsharded step (sp_steps 0, the same bytes); each
     P picture's ms against the unsharded one's; the md_low step alone
     (CUDA events): p_frame_step against p_frame_step_sharded (equal
     fields) and the halo assembly's share;
 53. the GOP pipeline (parallel/gop_pipeline.encode_gops_parallel): the
     first GOP_PAR_FRAMES frames with intra_period GOP_PAR_PERIOD in each
     configuration of GOP_PAR (n_dp 2: md_low; n_dp 2 x n_sp 2 with
     sp_shards 2; device_rd) on card_mesh, equal to the serial
     encode_frame stream on the card, results in display order with its
     recon, one launch each of K1 and K2 per picture; each GOP's wall and
     whether its I frame replayed the CUDA graphs cached by ops/intra;
 54. wide search on the host coders: CIF pipeline="host" I P P streams
     at search ranges WIDE_RANGES (24, 32) through encode_frame, each
     equal to its CPU run (a worker's), one launch each of K1 and K2 per
     picture, decoded on the card equal to its recon, the host P
     picture's ms per MB against search range 16; lencod on a CIF cfg
     with SearchRange 32, then ldecod, on the card: stream, recon and
     decoded YUV equal the CPU run (a worker's);
 55. the port's host tools (jm_tpu_torch/tools), each against the same
     run on the CPU (a worker's): (a) trace.trace_stream of phase 3's
     first TRACE_NALUS NAL units (SPS, PPS, the IDR, the first P; the IDR
     reconstructed and deblocked on the card when the P starts, the last
     picture parsed only, as in jm_tpu's trace), the text equal, its line
     count, sha256 and seconds; (b) bdrate.run_ours of the first
     TOOLS_FRAMES CIF frames at TOOLS_QPS for the presets fast (md_low)
     and fast_rd, the (bits, PSNR) pairs equal, with the BD-rate and
     BD-PSNR of fast_rd against fast; (c) those frames written as RGB
     TIFF files (imgio.yuv420_to_rgb, write_tiff), read back
     (read_tiff_sequence) and encoded on the card, the bytes equal; (d)
     that stream packed into an RTP dump, rtp_loss with RTP_LOSS (20 %,
     2 leading packets kept, seed 7) and rtpdump, the lossy stream
     decoded on the card with conceal_mode=1: the "lost packet" lines,
     the packet count and the frames equal; one launch each of K1 and
     K2 per picture reconstructed on each path.
 56. field pictures at 4:2:2 and above 8 bits, and concealment of 4:2:2
     and >8-bit pictures, as jm_tpu decodes them, each decode on the
     card equal to a CPU worker's decode of the same bytes with the
     same concealed_count, and one launch of each kernel of the
     stream's format and bit depth per field or reconstructed picture:
     (a) phase 44's 1080p field pair under a High 10 SPS (K1-HBD and
     K2-HBD at the 1080p field shape); (b) Y422_FIELD_PICTURES 352x144
     4:2:2 pictures encoded on the card and re-framed as the fields of
     two CIF frames (reframed_fields), at 8 bits (K1, K2-422) and under
     a 10-bit profile-122 SPS (K1-HBD, K2-422-HBD); (c) phase 48's lossy
     CIF stream under a High 10 SPS and a 4:2:2 CIF stream of 4 slices a
     picture encoded on the card with the same losses, each decoded with
     conceal_mode 1 and 2.
The wall seconds of each group of phases are printed after phase 56.
The CPU references of phases 4-56 (the encodes on the CPU, the CPU
decodes of the lossy streams, of the DP goldens, cif_main, the weighted,
High, motion-option, RD, 4:2:2, field, SP, stereo and wide-search
streams, the lencod / ldecod runs, the host tools' runs) run in
CPU_WORKERS worker processes, started before the kernel build and
stopped before the closing lines, while the card works through the
phases, queued in the order of the phase that checks each; one more
worker takes the CPU decodes of phases 41, 48 and 56, which can start
only once phases 3, 38, 44 and 48 have made their streams (phase 56's
own streams' decodes go to the CPU_WORKERS, idle by then).
Phases 3, 6, 8-13 and 15-20 run on the native runtime, as the entry
points do by default: each prints the runtime's route counters (reset
just before its run) and fails unless every CAVLC slice was serialized
and parsed, every intra picture reconstructed and every CABAC slice
decoded by the native runtime, but the data-partitioned slices of
phase 18 and the B slices of phases 22-39, which only the Python
serializers and parsers handle (routes "dp" and "b"), the CAVLC I /
P slices and pictures with an I_PCM MB of phases 35-36 (the Python
serializer, parser and intra recon), and the CAVLC I / P slices of the
4:2:2 streams of phases 39 and 41 (the Python parser, route "yuv422";
their serialization is native); the >8-bit pictures of phase 41 take
the Python intra recon (the native one is 8-bit).

``python3 chip_smoke.py --from 18`` builds (phase 1) and runs phases
18-54 alone, ``--from 22`` phases 22-54, ``--from 25`` phases 25-54,
``--from 28`` phases 28-54, ``--from 31`` phases 31-54, ``--from 34``
phases 34-54, ``--from 37`` phases 37-54, ``--from 40`` phases 40-54
(after encoding phase 3's first HBD_FRAMES pictures and phase 38's
CIF stream (a) on the card), ``--from 43`` phases 43-54, ``--from 46``
phases 46-54 (after encoding phase 3's first CONCEAL_1080P pictures),
``--from 49`` phases 49-54, ``--from 52`` phases 52-54, each then
phase 55 (after encoding phase 3's first two pictures on the card) and
phase 56, ``--from 55`` phases 55-56 and ``--from 56`` phase 56 alone
(from 47 on, after encoding phase 44's 1080p field pair and phase 48's
CIF stream on the card), without the closing JSON lines (a quicker
check of those phases while they are developed). The
last line of
standard output is {"ok": true, "device": {...}}; the line before it
holds the per-kernel numbers as JSON.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from jm_tpu_torch import kernels  # noqa: E402
from jm_tpu_torch import native  # noqa: E402
from jm_tpu_torch.common.tables import chroma_qp  # noqa: E402
from jm_tpu_torch.common.types import SliceType  # noqa: E402
from jm_tpu_torch.decoder.decoder import H264Decoder  # noqa: E402
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig  # noqa: E402
from jm_tpu_torch.ops.deblock import (  # noqa: E402
    deblock_chroma_plain, deblock_luma_plain, deblock_plain)

W, H = 1920, 1088
N_FRAMES = 17
CUT_FRAMES = 4       # frames of the scene-cut stream (frame 2 replaced)
N_CABAC = 4          # frames of the CABAC stream (phases 12-13)
LL_FRAMES = 4        # frames of the low-latency stream (phase 15)
N_CIF = 5            # frames of the CIF streams (phases 16-17)
RES_FRAMES = 5       # frames of the 1080p streams of phases 18-20
LOSSY_CPU = 4        # pictures of phase 19's lossy stream decoded on the CPU
B_FRAMES = 3         # frames of the 1080p B stream (phases 22-23): I0 P2 B1
GOP_FRAMES = 13      # frames of the CIF GOP stream (phase 24)
GOP_CPU = 5          # of them encoded on the CPU: the IDR + first mini-GOP
# JM's B goldens held against their _rec.yuv (phase 23; cif_main against
# the CPU decode)
B_GOLDENS = ("cavlc_b", "main3", "main9", "main9t", "poc1b")
WP_FRAMES = 2        # frames of the 1080p weighted P stream (phase 25)
WP_FADE = 0.05       # the fade's step per frame (phases 25-26)
# phase 26's CIF configurations of the fade: (label, frames, keywords)
WP_CIF = (("a", 3, dict(num_b=1, entropy="cabac", weighted_pred=1,
                        weighted_bipred=1)),
          ("b", 5, dict(num_b=3, hierarchical=1, weighted_bipred=2)),
          ("c", 2, dict(weighted_pred=1, wp_method=1, wp_mcprec=1)))
# JM's weighted prediction goldens (phase 27)
WP_GOLDENS = ("wp_p", "wp_bi", "wp_both")
HIGH_FRAMES = 2      # frames of the 1080p host-pipeline High stream (28)
# phase 29's CIF host-pipeline streams: (label, frames, EncoderConfig
# keywords; "defaults" stands for the spec's default scaling lists with
# the default quant offsets)
HIGH_CIF = (("a", 3, {}),
            ("b", 3, dict(entropy="cabac", transform8x8=True, num_b=1)),
            ("c", 3, dict(scaling_matrix=3, transform8x8=True,
                          adaptive_rounding=True, defaults=True)))
HIGH_GOLDENS = ("high8x8", "high8x8c", "high8x8sm")
MOTION_FRAMES = 3    # frames of the 1080p motion-option stream (31)
# phase 32's CIF streams: (label, frames, EncoderConfig keywords); (e) is
# the explicit sequence script (EXPLICIT_SCRIPT), (d) basic-unit RC
MOTION_CIF = (("a", 3, dict(pipeline="host", num_ref=2, sub8x8=True,
                            transform8x8=True)),
              ("b", 5, dict(search_mode=1, num_ref=2, subpel_satd=False,
                            entropy="cabac", num_b=1)),
              ("c", 3, dict(search_mode=2, long_term_period=3, num_ref=2)),
              ("d", 4, dict(rc_enable=True, rc_bitrate=1_000_000.0,
                            rc_basic_unit=22)),
              ("e", 5, dict(num_b=1, num_ref=2)))
EXPLICIT_SCRIPT = """Sequence { FrameCount : 5
Frame { SeqNumber : 0 SliceType : I IDRPicture : 1 Reference : 1 }
Frame { SeqNumber : 2 SliceType : P Reference : 1 }
Frame { SeqNumber : 1 SliceType : B Reference : 0 }
Frame { SeqNumber : 4 SliceType : P Reference : 1 }
Frame { SeqNumber : 3 SliceType : B Reference : 1 } }"""
DEVICE = "cuda"
# the kernels' edge shapes (one MB, mb_w 2, mb_h 1, one MB column), each
# with a parameter variant ("mixed" may switch the one MB off), and 2160p
# (135 rows)
EDGE_SHAPES = ((16, 16, "plain"), (32, 1088, "mixed"), (1920, 16, "mixed"),
               (16, 1088, "mixed"))
UHD = (3840, 2160)
REPEATS = 50
QP = 28
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate
# integer operations of one filtered edge line, read off the filter
# formulas (deblock.cu luma_line / chroma_line, normal and strong paths)
LUMA_LINE_OPS = 60
CHROMA_LINE_OPS = 25
RD_FRAMES = 3        # frames of the 1080p rd_picture_decision stream (34)
RDOQ_ALL = dict(rdoq=1, rdoq_dc=1, rdoq_cr=1, rdoq_dc_cr=1)
RD_QCIF_FRAMES = 3   # frames of each QCIF host RD stream (35)
# phase 35's QCIF host RD streams: (label, QP, EncoderConfig keywords,
# whether a new noise patch is pasted into each frame)
RD_QCIF = (("a", 12, dict(RDOQ_ALL, rdo=1, enable_ipcm=1), True),
           ("b", QP, dict(RDOQ_ALL, rdo=2, entropy="cabac",
                          transform8x8=True, num_b=1), False),
           ("c", QP, dict(rdo=3, num_decoders=2, loss_rate_a=5), False),
           ("d", QP, dict(enable_ipcm=2, entropy="cabac", num_b=1), False),
           ("e", QP, dict(rdo=4, rd_picture_decision=True), False))
# phase 38's CIF 4:2:2 streams: (label, frames, EncoderConfig keywords)
Y422_CIF = (("a", 3, {}),
            ("b", 3, dict(entropy="cabac", num_b=1, transform8x8=True,
                          scaling_matrix=3)))
Y422_GOLDENS = ("y422", "y422c")      # JM's 4:2:2 goldens (phase 39)
# sha256 of JM ldecod's output of tests/golden/cif_422.264 (30 CIF 4:2:2
# frames; tests/test_cif_conformance.py records it)
CIF_422_SHA256 = ("1b12ba64b1981f0edb4705ee4d3daf4bdde030e0877fb77b5dc0"
                  "64198d75d2a3")


def make_sequence(seed: int = 0):
    """The 1080p sequence of bench.py: low-pass filtered noise with global
    motion (deterministic; seed 0 is bench.py's)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H + 96, W + 96)).astype(np.float32)
    k = np.ones(9) / 9
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = np.clip(base * 1.8, 0, 255).astype(np.uint8)
    frames = []
    for i in range(N_FRAMES):
        Y = base[3 * i:3 * i + H, 2 * i:2 * i + W].copy()
        frames.append((Y, Y[::2, ::2].copy(), Y[1::2, ::2].copy()))
    return frames


def cuda_ms(fn, reps: int = 7, inner: int = 1) -> float:
    """CUDA-event time of one fn() call in ms, after one warm-up call: the
    median over `reps` runs of `inner` back-to-back calls, each run's time
    divided by `inner` (so that a short kernel is not timed as the host's
    enqueue latency)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def deblock_case(rng, mb_w: int, mb_h: int, variant: str, crows: int = 2):
    """Random picture + per-MB deblock parameters on the card; chroma
    planes of 4 crows rows per MB (crows 2: 4:2:0, 4: 4:2:2)."""
    n = mb_w * mb_h
    dev = DEVICE
    Y = rng.integers(0, 256, (16 * mb_h, 16 * mb_w), np.uint8)
    U = rng.integers(0, 256, (4 * crows * mb_h, 8 * mb_w), np.uint8)
    V = rng.integers(0, 256, (4 * crows * mb_h, 8 * mb_w), np.uint8)
    # low-amplitude content over the top three quarters, so the filter
    # thresholds pass and the normal and strong filters both run
    for P in (Y, U, V):
        r = 3 * P.shape[0] // 4
        P[:r] = (P[:r] // 20) + 100
    bs_v = rng.integers(0, 5, (4 * mb_h, 4 * mb_w)).astype(np.int8)
    bs_h = rng.integers(0, 5, (4 * mb_h, 4 * mb_w)).astype(np.int8)
    bs_v[:, 0] = 0
    bs_h[0, :] = 0
    qp = rng.integers(0, 52, n).astype(np.int32)
    if variant == "mixed":
        disable = rng.integers(0, 3, n).astype(np.int32)
        sid = (np.arange(n) * 3 // n).astype(np.int32)       # 3 slices
        a_off = rng.integers(-6, 7, n).astype(np.int32)
        b_off = rng.integers(-6, 7, n).astype(np.int32)
        t8 = (rng.random(n) < 0.3).astype(np.int32)
    elif variant == "disable2":
        disable = np.full(n, 2, np.int32)
        sid = (np.arange(n) // (n // 4 + 1)).astype(np.int32)  # 4 slices
        a_off = np.full(n, 3, np.int32)
        b_off = np.full(n, -2, np.int32)
        t8 = np.zeros(n, np.int32)
    else:                                       # plain: disable 0, no offs
        disable = np.zeros(n, np.int32)
        sid = np.zeros(n, np.int32)
        a_off = np.zeros(n, np.int32)
        b_off = np.zeros(n, np.int32)
        t8 = np.zeros(n, np.int32)
    qpc_cb = np.array([chroma_qp(q, -2) for q in range(52)], np.int32)
    qpc_cr = np.array([chroma_qp(q, 3) for q in range(52)], np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    per_mb = tuple(t(a) for a in (qp, disable, a_off, b_off, sid, t8))
    return (t(Y), t(U), t(V), t(bs_v), t(bs_h), per_mb, t(qpc_cb), t(qpc_cr))


def check_case(rng, w: int, h: int, variant: str, repeats: int = 1):
    """K1 and K2 against their plain versions on one random picture of
    w x h, `repeats` launches each (every output must equal the plain
    one). Returns (case, max |err| luma, chroma, samples changed, the
    plain versions' CUDA-event ms (luma, chroma) of this one call)."""
    mb_w, mb_h = w // 16, h // 16
    case = deblock_case(rng, mb_w, mb_h, variant)
    Y, U, V, bs_v, bs_h, per_mb, cb, cr = case
    args = (bs_v, bs_h, *per_mb)
    py, ms_y = event_ms(lambda: deblock_luma_plain(Y, *args, mb_w=mb_w,
                                                   mb_h=mb_h))
    (pu, pv), ms_c = event_ms(lambda: deblock_chroma_plain(
        U, V, *args, cb, cr, mb_w=mb_w, mb_h=mb_h))
    y0, u0, v0 = Y.clone(), U.clone(), V.clone()
    err_y = err_c = 0
    for _ in range(repeats):
        ky = kernels.deblock_luma(Y, *args, mb_w=mb_w, mb_h=mb_h)
        ku, kv = kernels.deblock_chroma(U, V, *args, cb, cr,
                                        mb_w=mb_w, mb_h=mb_h)
        err_y = max(err_y, int((ky.int() - py.int()).abs().max()))
        err_c = max(err_c, int((ku.int() - pu.int()).abs().max()),
                    int((kv.int() - pv.int()).abs().max()))
    torch.cuda.synchronize()
    if not (torch.equal(Y, y0) and torch.equal(U, u0) and torch.equal(V, v0)):
        raise AssertionError(f"deblock {w}x{h} {variant}: input modified")
    changed = (int((py != Y).sum()), int((pu != U).sum())
               + int((pv != V).sum()))
    print(f"deblock {w}x{h} {variant} x{repeats}: luma max|err| {err_y}, "
          f"chroma max|err| {err_c}, samples changed (luma, chroma) "
          f"{changed}", flush=True)
    if err_y or err_c:
        raise AssertionError(f"deblock kernels differ from the plain "
                             f"version ({w}x{h} {variant})")
    return case, err_y, err_c, changed, (ms_y, ms_c)


def chain_steps(rng) -> None:
    """Prints the cost of one step of each kernel's dependency chain, with
    every bS zero: one MB row (1920x16, 120 MBs one after the other in one
    CTA) and one MB column (16x1088, 68 rows, each handed to the next
    through the progress counters)."""
    for w, h in ((1920, 16), (16, 1088)):
        mb_w, mb_h = w // 16, h // 16
        Y, U, V, bs_v, _, per_mb, cb, cr = deblock_case(rng, mb_w, mb_h,
                                                        "plain")
        z = torch.zeros_like(bs_v)
        ms_y = cuda_ms(lambda: kernels.deblock_luma(
            Y, z, z, *per_mb, mb_w=mb_w, mb_h=mb_h), inner=20)
        ms_c = cuda_ms(lambda: kernels.deblock_chroma(
            U, V, z, z, *per_mb, cb, cr, mb_w=mb_w, mb_h=mb_h), inner=20)
        n = max(mb_w, mb_h)
        print(f"chain step {w}x{h} (all bS 0, {n} steps): luma "
              f"{ms_y:.4f} ms = {ms_y / n * 1e3:.3f} us/step, chroma "
              f"{ms_c:.4f} ms = {ms_c / n * 1e3:.3f} us/step", flush=True)


def filtered_lines(bs_v, bs_h, per_mb, mb_w: int, mb_h: int,
                   crows: int = 2):
    """(luma, chroma) filter lines these inputs switch on: bS > 0 and the
    edge enabled (disable != 1; left / top MB edges off at the picture
    border, or across slices with disable 2; 8x8-transform inner edges,
    which at 4:2:2 (crows 4) switch no chroma edge off: its horizontal
    chroma edges are at every luma edge, its vertical ones 16 lines
    tall)."""
    qp, dis, _ao, _bo, sid, t8 = (a.reshape(mb_h, mb_w) for a in per_mb)
    on = dis != 1
    sid_l = torch.cat([sid[:, :1], sid[:, :-1]], 1)
    sid_t = torch.cat([sid[:1], sid[:-1]], 0)
    col = torch.arange(mb_w, device=qp.device)[None]
    row = torch.arange(mb_h, device=qp.device)[:, None]
    left = on & (col > 0) & ~((dis == 2) & (sid_l != sid))
    top = on & (row > 0) & ~((dis == 2) & (sid_t != sid))
    inner = on & (t8 == 0)

    def edges(bs, first, axis, mid=inner):
        b = (bs > 0).reshape(mb_h, 4, mb_w, 4).permute(0, 2, 1, 3)
        e = b if axis == 1 else b.transpose(2, 3)      # [mb, line blk, edge]
        en = torch.stack([first, mid, on, mid], -1)[:, :, None, :]
        return e & en

    ev = edges(bs_v, left, 1)
    eh = edges(bs_h, top, 0)
    luma = 4 * int(ev.sum() + eh.sum())
    if crows == 2:
        chroma = 2 * 2 * int(ev[..., 0::2].sum() + eh[..., 0::2].sum())
    else:
        chroma = 2 * (4 * int(ev[..., 0::2].sum())
                      + 2 * int(edges(bs_h, top, 0, on).sum()))
    return luma, chroma


class IdrTimedEncoder(Encoder):
    """The port's Encoder with the wall time of its IDR frames summed in
    idr_seconds (an IDR ends in host downloads, so it ends synchronized;
    the timer synchronizes at its start). ``host_slices`` keeps the first
    I and the first P picture serialized on the host, with the arguments
    of that serialize_slice call (phase 14: pictures of one slice)."""

    idr_seconds = 0.0

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.host_slices = {}

    def _picture_nals(self, pic, slice_type, poc, qp, plan, sizes=None,
                      **hdr):
        kw = {k: v for k, v in hdr.items() if k != "nal_ref_idc"}
        if kw.get("idr") is None:
            kw["idr"] = slice_type == SliceType.I
        kw.update(slice_type=slice_type, frame_num=self.frame_num, qp=qp,
                  poc_lsb=poc % 256, idr_pic_id=self.idr_pic_id)
        self.host_slices.setdefault(slice_type.name, (pic, kw))
        return super()._picture_nals(pic, slice_type, poc, qp, plan, sizes,
                                     **hdr)

    def _encode_i(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return super()._encode_i(*a, **kw)
        finally:
            self.idr_seconds += time.perf_counter() - t0


def profile_p_frame(enc, frame, cfg, label: str = "P frame"):
    """torch.profiler over one P frame (p_frame_rd_pipe against the
    encoder's last reference, with cfg's P tier): wall time, device busy
    time, idle share, and the ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from jm_tpu_torch.encoder.encoder import lambda_me, lambda_mode4
    from jm_tpu_torch.ops.enc import p_frame_rd_pipe
    packed = enc._upload(frame)

    def one():
        out, _ = p_frame_rd_pipe(
            packed, *enc.refs[0].state, cfg.qp, enc.qpc, lambda_me(cfg.qp),
            lambda_mode4(cfg.qp), enc.qpc_cb, enc.qpc_cr, mb_w=enc.mb_w,
            mb_h=enc.mb_h, sr=cfg.search_range, max_words=enc.max_words,
            rd=cfg.device_rd)
        return out["words_ext"].cpu()

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events are the kernels and copies themselves (the
    # aten ops that launched them carry the same time again)
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy_ms = sum(dev_us(e) for e in evs) / 1e3
    n_launch = sum(e.count for e in evs)
    print(f"{label} profile: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{n_launch} device ops", flush=True)
    for e in sorted(evs, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}",
              flush=True)
    for e in evs:
        if "deblock" in e.key:
            print(f"  deblock: {dev_us(e) / 1e3:.4f} ms x{e.count} "
                  f"{e.key[:60]} ({dev_us(e) / 1e3 / busy_ms:.4f} of the "
                  f"device time, {dev_us(e) / 1e3 / wall_ms:.4f} of the "
                  f"wall)", flush=True)


def device_profile(fn, label: str) -> None:
    """torch.profiler over fn(): wall and device-busy time, idle share,
    and the deblock kernels' device time and launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy_ms = sum(dev_us(e) for e in evs) / 1e3
    print(f"{label} profile: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in evs)} device ops", flush=True)
    for e in sorted(evs, key=dev_us, reverse=True)[:6]:
        print(f"  {dev_us(e) / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}",
              flush=True)
    for e in evs:
        if "deblock" in e.key:
            print(f"  deblock: {dev_us(e) / 1e3:.4f} ms x{e.count} "
                  f"{e.key[:60]}", flush=True)


def check_frames(got, want, label: str) -> None:
    """Decoded frames against (Y, U, V) planes, byte for byte."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} frames, expected "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for k, plane in enumerate("YUV"):
            if not np.array_equal(getattr(g, plane), w[k]):
                raise AssertionError(f"{label}: frame {i} {plane} differs")


def check_routes(label: str, dp=None, b=None, other=None,
                 **native_counts) -> None:
    """Print the native runtime's route counters of the run just made
    (reset just before it) and check them: native_counts gives, per kind
    (serialize, parse, recon, cabac), how many slices or pictures must
    have taken the native route; none may have taken another but as
    other gives ({kind: {route: count}}: the Python routes of slices and
    pictures with an I_PCM MB). dp gives the data-partitioned slices
    serialized / parsed (the Python route of kind "dp"; none unless
    given), b the B slices (the Python route of kind "b")."""
    print(f"{label}: native runtime routes {native.routes}", flush=True)
    for kind, counts in native.routes.items():
        if kind in ("dp", "b"):
            want = {"serialize": 0, "parse": 0,
                    **((dp if kind == "dp" else b) or {})}
            if counts != want:
                raise AssertionError(f"{label}: {kind} routes {counts}, "
                                     f"expected {want}")
            continue
        want = {"native": native_counts.get(kind, 0),
                **(other or {}).get(kind, {})}
        if any(v != want.get(k, 0) for k, v in counts.items()):
            raise AssertionError(f"{label}: {kind} routes {counts}, "
                                 f"expected {want} and no other")


def decode_phase(payloads, enc):
    """Phase 6: the 1080p stream decoded on the card, held against the
    encoder's recon; returns (decoded frames, per-kernel launches)."""
    data = b"".join(payloads)
    H264Decoder(device="cuda").decode_annexb(b"".join(payloads[:3]))
    torch.cuda.synchronize()
    dec = H264Decoder(device="cuda")
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(data)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    check_frames(out, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], f"decode {W}x{H}")
    pics = dec.pictures
    check_routes(f"decode {W}x{H}", parse=len(out), recon=sum(
        r["path"] != "inter" for r in pics))
    p_ms = [r["seconds"] * 1e3 for r in pics[1:]]
    split = {k: sum(r[k] for r in pics) for k in
             ("parse_s", "host_recon_s", "device_s")}
    print(f"decode {W}x{H} {''.join(r['type'][0] for r in pics)} "
          f"({[r['path'] for r in pics][:2]}...): {len(out) / total_s:.2f} "
          f"frames/s, {total_s * 1e3 / len(out):.1f} ms/frame (IDR "
          f"{pics[0]['seconds'] * 1e3:.1f} ms, P {statistics.mean(p_ms):.1f}"
          f" ms avg, {min(p_ms):.1f}..{max(p_ms):.1f}), launches {launches}",
          flush=True)
    print(f"decode split over {len(out)} pictures: host parse "
          f"{split['parse_s']:.3f} s, host intra recon "
          f"{split['host_recon_s']:.3f} s, device stages (wall, incl. "
          f"uploads and the download sync) {split['device_s']:.3f} s; IDR: "
          f"parse {pics[0]['parse_s'] * 1e3:.1f} ms, intra recon "
          f"{pics[0]['host_recon_s'] * 1e3:.1f} ms, device "
          f"{pics[0]['device_s'] * 1e3:.1f} ms; P avg: parse "
          f"{statistics.mean(r['parse_s'] for r in pics[1:]) * 1e3:.1f} ms, "
          f"device "
          f"{statistics.mean(r['device_s'] for r in pics[1:]) * 1e3:.1f} ms",
          flush=True)
    for name, cnt in launches.items():
        if cnt != len(out):
            raise AssertionError(f"decode: {name} launched {cnt} times, "
                                 f"expected once for each of {len(out)} "
                                 f"pictures")
    prof_dec = H264Decoder(device="cuda")
    device_profile(lambda: prof_dec.decode_annexb(payloads[0]), "decode IDR")
    device_profile(lambda: prof_dec.decode_annexb(payloads[1]),
                   "decode one P")
    for name in ("ipp3", "qp20"):
        decode_golden(name)
    return out, launches


def decode_golden(name: str, dec=None) -> list:
    """A JM golden stream tests/golden/<name>.264 decoded on the card must
    equal JM ldecod's output <name>_rec.yuv (in output order: POC order,
    which is the decode order of streams without B pictures; 4:2:0 or
    4:2:2 as the stream says; uint16 samples above 8 bits). dec: the
    decoder to use (a new one by default). Returns the decoded frames."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "tests", "golden", f"{name}.264")
    with open(path, "rb") as f:
        got = (dec or H264Decoder(device=DEVICE)).decode_annexb(f.read())
    out = got
    got = sorted(got, key=lambda fr: fr.poc)
    rec = np.fromfile(path[:-4] + "_rec.yuv", got[0].Y.dtype)
    h, w = got[0].Y.shape
    ch = got[0].U.shape[0]                  # h / 2 (4:2:0) or h (4:2:2)
    cs = ch * (w // 2)
    fs = w * h + 2 * cs
    want = [(rec[i * fs:i * fs + w * h].reshape(h, w),
             rec[i * fs + w * h:i * fs + w * h + cs].reshape(ch, w // 2),
             rec[i * fs + w * h + cs:(i + 1) * fs].reshape(ch, w // 2))
            for i in range(rec.size // fs)]
    check_frames(got, want, f"decode {name}.264")
    print(f"decode {name}.264 on the card: {len(got)} frames equal "
          f"JM ldecod's {name}_rec.yuv", flush=True)
    return out


class SplitTimedEncoder(IdrTimedEncoder):
    """IdrTimedEncoder that also times, with the card synchronized at each
    step's ends, every P dispatch (by display index: the speculative one,
    then a re-dispatch) and each step of the per-frame P path (download,
    host commit with the intra re-encode, device deblock + prep_ref,
    serialize) by display index. Synchronizing undoes the overlap of a
    dispatch with the previous frame's finalize; the stream is the same."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.split = {}

    def _timed(self, disp, name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        self.split.setdefault(disp, {}).setdefault(name, []).append(
            time.perf_counter() - t0)
        return out

    def _dispatch(self, *a):
        return self._timed(self.display_idx - 1, "pipe", super()._dispatch,
                           *a)

    def _finish_p(self, core, disp, *a, **kw):
        self._disp = disp
        return super()._finish_p(core, disp, *a, **kw)

    def _encode_p_host(self, packed, frame, disp, *a, **kw):
        self._disp = disp
        return super()._encode_p_host(packed, frame, disp, *a, **kw)

    def _download_core(self, *a):
        return self._timed(self._disp, "download", super()._download_core,
                           *a)

    def _commit_p(self, *a):
        return self._timed(self._disp, "host_intra", super()._commit_p, *a)

    def _deblock_p(self, *a):
        return self._timed(self._disp, "deblock_prep", super()._deblock_p,
                           *a)

    def _serialize_p(self, *a, **kw):
        return self._timed(self._disp, "serialize", super()._serialize_p,
                           *a, **kw)


def timed_encode(cfg, frames, cls=IdrTimedEncoder):
    """Encode frames on the card with the launch counters reset just
    before and read just after; returns (encoder, payloads, launches,
    seconds)."""
    enc = cls(cfg, device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    payloads = enc.encode_stream(frames)
    torch.cuda.synchronize()
    return enc, payloads, launch_counts(cfg.chroma_format == 2), \
        time.perf_counter() - t0


def md_low_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=False)


def md_low_phase(frames):
    """Phase 8: the sequence with md_low (its IDR + P are held against the
    CPU encode after phase 14); returns (encoder, payloads, per-kernel
    launches)."""
    cfg = md_low_cfg()
    enc, payloads, launches, total_s = timed_encode(cfg, frames)
    n = len(frames)
    p_ms = (total_s - enc.idr_seconds) / (n - 1) * 1e3
    print(f"encode md_low 1080p {''.join(r['type'] for r in enc.results)}: "
          f"{n / total_s:.2f} frames/s, {total_s * 1e3 / n:.1f} ms/frame "
          f"(IDR {enc.idr_seconds * 1e3:.1f} ms, P {p_ms:.1f} ms avg), "
          f"{sum(map(len, payloads))} stream bytes, launches {launches}; "
          f"{len(enc.ovf)} of {n - 1} P frames serialized on the host "
          f"(packer overflow)", flush=True)
    check_routes("md_low", serialize=1 + len(enc.ovf))
    if enc.fallbacks:
        raise AssertionError(f"md_low: unexpected fallbacks {enc.fallbacks}")
    for name, cnt in launches.items():
        if cnt != n:
            raise AssertionError(f"md_low: {name} launched {cnt} times, "
                                 f"expected once for each of {n} frames")
    profile_p_frame(enc, frames[-1], cfg, "md_low P frame (pipe only)")
    return enc, payloads, launches


def cut_frames(frames):
    """The scene cut: the first CUT_FRAMES frames, frame 2 from another
    sequence."""
    cut = list(frames[:CUT_FRAMES])
    cut[2] = make_sequence(seed=1)[2]
    return cut


def rd_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True)


def scene_cut_phase(frames):
    """Phase 9: the scene cut (held against the CPU encode after phase
    14); returns (encoder, payloads, launches)."""
    cut = cut_frames(frames)
    enc, payloads, launches, total_s = timed_encode(rd_cfg(), cut,
                                                    SplitTimedEncoder)
    check_routes("scene cut",
                 serialize=1 + len(enc.fallbacks) + len(enc.ovf))
    if 2 not in enc.fallbacks:
        raise AssertionError(f"scene cut: frame 2 did not fall back "
                             f"({enc.fallbacks})")
    want = CUT_FRAMES + len(enc.fallbacks) + enc.redispatches
    print(f"scene cut 1080p {CUT_FRAMES} frames: {total_s:.1f} s, "
          f"fallbacks at frames {enc.fallbacks}, {enc.redispatches} "
          f"re-dispatches, launches {launches} (expected {want} each: "
          f"{CUT_FRAMES} frames + {len(enc.fallbacks)} mixed deblocks + "
          f"{enc.redispatches} re-dispatched)", flush=True)
    for name, cnt in launches.items():
        if cnt != want:
            raise AssertionError(f"scene cut: {name} launched {cnt} times, "
                                 f"expected {want}")
    n_mbs = (W // 16) * (H // 16)
    for r in enc.results:
        d = r["disp"]
        if d not in enc.fallbacks:
            continue
        sp = {k: sum(v) * 1e3 for k, v in enc.split[d].items()}
        spec = enc.split[d]["pipe"][0] * 1e3
        redis = enc.split.get(d + 1, {}).get("pipe", [])
        redis_ms = redis[1] * 1e3 if len(redis) > 1 else None
        wall = spec + sum(sp[k] for k in ("download", "host_intra",
                                          "deblock_prep", "serialize"))
        print(f"fallback frame {d}: {r['intra_mbs']} of {n_mbs} MBs "
              f"re-encoded intra; speculative pipe {spec:.1f} ms, download "
              f"{sp['download']:.1f} ms, host re-encode "
              f"{sp['host_intra']:.1f} ms "
              f"({sp['host_intra'] / r['intra_mbs']:.3f} ms/MB), device "
              f"deblock + prep_ref {sp['deblock_prep']:.1f} ms, serialize "
              f"{sp['serialize']:.1f} ms, re-dispatch of frame {d + 1} "
              f"{'none' if redis_ms is None else f'{redis_ms:.1f} ms'}; "
              f"{wall + (redis_ms or 0):.1f} ms in all", flush=True)
    return enc, payloads, launches


def cut_decode_phase(enc, payloads):
    """Phase 10: the scene-cut stream decoded on the card; returns the
    per-kernel launches."""
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(b"".join(payloads))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    check_frames(out, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], "scene-cut decode")
    check_routes("scene-cut decode", parse=len(out), recon=sum(
        r["path"] != "inter" for r in dec.pictures))
    paths = [r["path"] for r in dec.pictures]
    if "mixed" not in paths:
        raise AssertionError(f"scene-cut decode: no mixed picture ({paths})")
    print(f"decode scene cut on the card: frames equal the encoder's recon; "
          f"{total_s:.1f} s; per picture " + ", ".join(
              f"{r['type'][0]}/{r['path']} {r['seconds'] * 1e3:.1f} ms "
              f"(parse {r['parse_s'] * 1e3:.1f}, intra recon "
              f"{r['host_recon_s'] * 1e3:.1f}, device "
              f"{r['device_s'] * 1e3:.1f})" for r in dec.pictures)
          + f"; launches {launches}", flush=True)
    for name, cnt in launches.items():
        if cnt != len(out):
            raise AssertionError(f"scene-cut decode: {name} launched {cnt} "
                                 f"times for {len(out)} pictures")
    return launches


class CabacTimedEncoder(SplitTimedEncoder):
    """SplitTimedEncoder that also times, by display index, each whole
    frame (``encode_frame``, "frame"), each host serialization of a
    picture's slices, I or P ("slice"), and each host intra encode of a
    multi-slice I picture ("i_host"); every frame takes the per-frame
    path (CABAC, slices, rate control)."""

    def encode_frame(self, *planes):
        return self._timed(self.display_idx, "frame", super().encode_frame,
                           *planes)

    units = 0                    # slice NAL units serialized (with re-codes)

    def _picture_nals(self, pic, slice_type, poc, qp, plan, sizes=None,
                      **hdr):
        self.units += len(plan)
        return self._timed(self.display_idx - 1, "slice",
                           super()._picture_nals, pic, slice_type, poc, qp,
                           plan, sizes, **hdr)

    def _intra_host(self, *a):
        return self._timed(self.display_idx - 1, "i_host",
                           super()._intra_host, *a)


def cabac_phase(frames, enc, payloads):
    """Phase 12: the first N_CABAC frames with CABAC, held against phase
    3's encoder `enc` and its CAVLC payloads; returns (encoder, payloads,
    launches)."""
    frames = frames[:N_CABAC]
    cfg = EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                        device_rd=True, entropy="cabac",
                        cabac_adapt_init=True)
    cab, cab_payloads, launches, total_s = timed_encode(cfg, frames,
                                                        CabacTimedEncoder)
    check_routes("CABAC encode (the CABAC writer is Python)")
    for name, cnt in launches.items():
        if cnt != N_CABAC:
            raise AssertionError(f"CABAC: {name} launched {cnt} times, "
                                 f"expected once for each of {N_CABAC} "
                                 f"frames")
    for i, (a, b) in enumerate(zip(cab.results, enc.results)):
        for plane in "YUV":
            if not np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane)):
                raise AssertionError(f"CABAC frame {i} {plane}: recon "
                                     f"differs from the CAVLC encode's")
    if not cab_payloads[0].startswith(b"\x00\x00\x00\x01\x67\x4d"):
        raise AssertionError("CABAC stream does not start with a Main SPS")
    n_mbs = (W // 16) * (H // 16)
    sp = {d: {k: sum(v) * 1e3 for k, v in cab.split[d].items()}
          for d in range(N_CABAC)}
    p_ms = [sp[d]["frame"] for d in range(1, N_CABAC)]
    cavlc_bytes = sum(map(len, payloads[:N_CABAC]))
    cabac_bytes = sum(map(len, cab_payloads))
    print(f"encode CABAC {W}x{H} {''.join(r['type'] for r in cab.results)}: "
          f"{N_CABAC / total_s:.3f} frames/s (IDR {sp[0]['frame']:.1f} ms, "
          f"P {statistics.mean(p_ms):.1f} ms avg, synchronized steps); "
          f"cabac_init_idc of the P slices "
          f"{[r['cabac_init_idc'] for r in cab.results[1:]]}; {cabac_bytes} "
          f"CABAC bytes against {cavlc_bytes} CAVLC bytes of the same "
          f"frames and recon (phase 3), ratio "
          f"{cabac_bytes / cavlc_bytes:.4f}; launches {launches}; recon of "
          f"every frame equal to phase 3's", flush=True)
    for d in range(N_CABAC):
        t = sp[d]
        ser = t["slice"]
        host = sum(t.get(k, 0.0) for k in ("download", "host_intra"))
        dev = t["frame"] - ser - host - t.get("deblock_prep", 0.0)
        print(f"CABAC frame {d} ({cab.results[d]['type']}, "
              f"{len(cab_payloads[d])} B against {len(payloads[d])} B "
              f"CAVLC): wall {t['frame']:.1f} ms = device encode "
              f"{dev:.1f} ms (upload, i_frame_step or p_frame_step; the IDR "
              f"with its deblock and downloads), download + host commit "
              f"{host:.1f} ms, device deblock + prep_ref "
              f"{t.get('deblock_prep', 0.0):.1f} ms, host CABAC serialize "
              f"{ser:.1f} ms ({ser / n_mbs:.3f} ms/MB"
              f"{', 3 init models tried' if d else ''})", flush=True)
    return cab, cab_payloads, launches


def cabac_decode_phase(cab, cab_payloads):
    """Phase 13: phase 12's CABAC stream decoded on the card, then the
    cabac_pp golden; returns the per-kernel launches of the first."""
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(b"".join(cab_payloads))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    check_frames(out, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in cab.results], "CABAC decode")
    check_routes("CABAC decode", cabac=len(out), recon=sum(
        r["path"] != "inter" for r in dec.pictures))
    for name, cnt in launches.items():
        if cnt != len(out):
            raise AssertionError(f"CABAC decode: {name} launched {cnt} "
                                 f"times for {len(out)} pictures")
    n_mbs = (W // 16) * (H // 16)
    print(f"decode CABAC {W}x{H} on the card: frames equal the encoder's "
          f"recon; {len(out) / total_s:.3f} frames/s; per picture " +
          ", ".join(f"{r['type'][0]}/{r['path']} {r['seconds'] * 1e3:.1f} "
                    f"ms (parse {r['parse_s'] * 1e3:.1f} = "
                    f"{r['parse_s'] * 1e3 / n_mbs:.3f} ms/MB, intra recon "
                    f"{r['host_recon_s'] * 1e3:.1f}, device "
                    f"{r['device_s'] * 1e3:.1f})" for r in dec.pictures)
          + f"; launches {launches}", flush=True)
    decode_golden("cabac_pp")
    return launches


def rd_full_phase(enc, frames) -> None:
    """Phase 11: p_mode_rd_device(top_modes=4) on the card against the
    CPU, on the inputs of the P frame of frames[-1] against the recon of
    frames[-2] (the phase-3 encoder's)."""
    from jm_tpu_torch.encoder.encoder import lambda_me
    from jm_tpu_torch.ops import enc as E
    from jm_tpu_torch.ops import enc_rd as RD
    mb_w, mb_h = W // 16, H // 16
    n = mb_w * mb_h
    qp, lam = QP, lambda_me(QP)
    qpc = chroma_qp(QP, 0)
    dev = DEVICE
    prev = enc.results[-2]["frame"]
    ref = E.prep_ref(*(torch.as_tensor(p, device=dev)
                       for p in (prev.Y, prev.U, prev.V)))
    Y, U, V = (torch.as_tensor(p, device=dev) for p in frames[-1])
    ar = torch.arange(n, device=dev)
    mb_xy = torch.stack([(ar % mb_w) * 16, (ar // mb_w) * 16], dim=1)
    orig_q = E.mb_tiles(Y, mb_h, mb_w, 16).reshape(n, 2, 8, 2, 8) \
        .permute(0, 1, 3, 2, 4).reshape(n, 4, 8, 8).to(torch.int32)
    int_mv, _ = E.me_int_sweep(Y, ref[0][0], mb_w, mb_h, 16, lam)
    pred = E.approx_pred_field(int_mv[:, 0], mb_w, mb_h)
    mv_q, cost_q, win = E.qpel_refine_dense(ref[0], orig_q, int_mv, pred,
                                            lam, mb_xy, 16)
    mode_satd = torch.stack(
        [cost_q[:, list(jobs)].sum(dim=1) + lam * int(E.MODE_BITS[m])
         for m, jobs in enumerate(E.MODE_JOBS)], dim=1).to(torch.int32)
    args = (*ref, win, mv_q, int_mv, pred, orig_q,
            E.mb_tiles(U, mb_h, mb_w, 8), E.mb_tiles(V, mb_h, mb_w, 8),
            mb_xy, qp, qpc)
    kw = dict(mb_w=mb_w, mb_h=mb_h, sr=16)
    got = RD.p_mode_rd_device(*args, **kw, top_modes=4)
    full_ms = cuda_ms(lambda: RD.p_mode_rd_device(*args, **kw, top_modes=4),
                      reps=3)
    pruned_ms = cuda_ms(lambda: RD.p_mode_rd_device(
        *args, **kw, mode_satd=mode_satd, top_modes=2), reps=3)
    t0 = time.perf_counter()
    cpu_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    want = RD.p_mode_rd_device(*cpu_args, **kw, top_modes=4)
    cpu_s = time.perf_counter() - t0
    for key, w in want.items():
        if not torch.equal(w, got[key].cpu()):
            raise AssertionError(f"p_mode_rd_device(top_modes=4): {key} "
                                 f"differs between the card and the CPU")
    modes = torch.bincount(got["inter_mode"].long(), minlength=4).tolist()
    print(f"all-modes RD 1080p: every field equal to device=\"cpu\" "
          f"({cpu_s:.1f} s on the CPU); device {full_ms:.1f} ms, pruned "
          f"top-2 tier {pruned_ms:.1f} ms (CUDA events, median of 3); "
          f"winners by mode (skip/16x16 share mode 0) {modes}", flush=True)


def _ms(fn):
    """(fn(), its wall time in ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _same_arrays(a, b, label: str) -> None:
    """Every numpy array of two PictureData (and the I_PCM samples)
    equal."""
    fa = {k: v for k, v in vars(a).items() if isinstance(v, np.ndarray)}
    fb = {k: v for k, v in vars(b).items() if isinstance(v, np.ndarray)}
    if fa.keys() != fb.keys():
        raise AssertionError(f"{label}: PictureData fields differ")
    for k in fa:
        if not np.array_equal(fa[k], fb[k]):
            raise AssertionError(f"{label}: {k} differs")
    if a.ipcm_luma.keys() != b.ipcm_luma.keys():
        raise AssertionError(f"{label}: I_PCM MBs differ")


def _slices(data: bytes):
    """(SPS map, PPS map, slice NAL units) of a stream."""
    from jm_tpu_torch.bitstream.nal import NalUnitType, split_annexb
    from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
    sps_map, pps_map, slices = {}, {}, []
    for u in split_annexb(data):
        if u.nal_unit_type == NalUnitType.SPS:
            sps = parse_sps(u.rbsp)
            sps_map[sps.seq_parameter_set_id] = sps
        elif u.nal_unit_type == NalUnitType.PPS:
            pps = parse_pps(u.rbsp, sps_map)
            pps_map[pps.pic_parameter_set_id] = pps
        elif u.nal_unit_type in (NalUnitType.SLICE, NalUnitType.IDR):
            slices.append(u)
    return sps_map, pps_map, slices


def _parse_twice(unit, sps_map, pps_map, parser):
    """One slice parsed by parser(pic, ctx, reader, native=...) on the
    native runtime and on the Python twins (PyBitReader, native=False);
    returns [(picture, ms)] for both, and the PPS."""
    from jm_tpu_torch.bitstream.bitreader import PyBitReader
    from jm_tpu_torch.common.picture import PictureData
    from jm_tpu_torch.decoder.header import parse_slice_header
    from jm_tpu_torch.decoder.mb_parse import SliceContext
    out = []
    for nat in (True, False):
        hdr, br = parse_slice_header(unit, sps_map, pps_map)
        pps = pps_map[hdr.pic_parameter_set_id]
        sps = sps_map[pps.seq_parameter_set_id]
        if not nat:
            pos, br = br.pos, PyBitReader(unit.rbsp)
            br.pos = pos
        pic = PictureData(sps.pic_width_in_mbs, sps.frame_height_in_mbs)
        ctx = SliceContext(hdr, sps, pps, 0)
        _, ms = _ms(lambda: parser(pic, ctx, br,
                                   native=nat).parse_slice_data())
        out.append((pic, ms))
    return out, pps


def host_runtime_phase(enc, payloads, low_enc, low_payloads, cab_payloads):
    """Phase 14: the native runtime against its Python twins at 1080p,
    each side timed once (wall ms on the host)."""
    from jm_tpu_torch.bitstream.nal import NalUnitType, annexb_bytes
    from jm_tpu_torch.decoder.mb_parse import MBParser
    from jm_tpu_torch.decoder.mb_parse_cabac import MBParserCABAC
    from jm_tpu_torch.decoder.recon import Reconstructor
    from jm_tpu_torch.encoder.syntax import serialize_slice
    n_mbs = (W // 16) * (H // 16)
    for label, e, emitted, key, nal_type in (
            ("IDR of phase 3", enc, payloads, "I", NalUnitType.IDR),
            ("packer-overflow P of phase 8", low_enc, low_payloads, "P",
             NalUnitType.SLICE)):
        if key not in e.host_slices:
            raise AssertionError(f"serialize {label}: no such picture was "
                                 f"serialized on the host")
        pic, kw = e.host_slices[key]
        got, ms_n = _ms(lambda: serialize_slice(pic, e.sps, e.pps, **kw))
        want, ms_p = _ms(lambda: serialize_slice(pic, e.sps, e.pps, **kw,
                                                 native=False))
        if got != want:
            raise AssertionError(f"serialize {label}: native and Python "
                                 f"bytes differ")
        if annexb_bytes(3, nal_type, got) not in b"".join(emitted):
            raise AssertionError(f"serialize {label}: not the slice the "
                                 f"phase emitted")
        print(f"host runtime, CAVLC serialize {label} ({len(got)} B): "
              f"native {ms_n:.1f} ms, Python {ms_p:.1f} ms "
              f"({ms_p / ms_n:.1f}x), bytes equal", flush=True)
    sps_map, pps_map, units = _slices(payloads[0] + payloads[1])
    for label, unit in zip(("IDR", "P"), units):
        ((nat, ms_n), (twin, ms_p)), pps = _parse_twice(unit, sps_map,
                                                        pps_map, MBParser)
        _same_arrays(nat, twin, f"CAVLC parse {label}")
        print(f"host runtime, CAVLC parse of phase 3's {label}: native "
              f"{ms_n:.1f} ms ({ms_n / n_mbs * 1e3:.2f} us/MB), Python "
              f"{ms_p:.1f} ms ({ms_p / ms_n:.1f}x), every PictureData "
              f"array equal", flush=True)
        if label == "IDR":
            idr, idr_pps = nat, pps
    got, ms_n = _ms(lambda: Reconstructor(idr, idr_pps).run(None))
    want, ms_p = _ms(lambda: Reconstructor(idr, idr_pps).run(
        None, native=False))
    for a, b in zip(got, want):
        if not np.array_equal(a, b):
            raise AssertionError("intra recon: native and Python planes "
                                 "differ")
    print(f"host runtime, intra recon of phase 3's IDR (decode_residuals "
          f"included): native {ms_n:.1f} ms, Python {ms_p:.1f} ms "
          f"({ms_p / ms_n:.1f}x), planes equal", flush=True)
    sps_map, pps_map, units = _slices(cab_payloads[0])
    ((nat, ms_n), (twin, ms_p)), _ = _parse_twice(units[0], sps_map,
                                                  pps_map, MBParserCABAC)
    _same_arrays(nat, twin, "CABAC parse IDR")
    print(f"host runtime, CABAC parse of phase 12's IDR: native "
          f"CabacEngine {ms_n:.1f} ms ({ms_n / n_mbs:.3f} ms/MB), Python "
          f"CabacEngine {ms_p:.1f} ms ({ms_p / ms_n:.2f}x), every "
          f"PictureData array equal", flush=True)


def card_decode(payloads, enc, label: str, cabac: bool = False,
                dp_parse: int = 0, dec=None, once_per_picture: bool = True,
                b_parse: int = 0, ipcm=()):
    """An encoder's stream decoded on the card with the launch and route
    counters reset just before: every frame equal to the encoder's recon,
    each kernel launched once per picture (unless once_per_picture is
    False: then only counted), every slice parsed (and every picture
    with intra MBs reconstructed) by the native runtime, but dp_parse
    data-partitioned slices, b_parse B slices and a 4:2:2 stream's CAVLC
    I / P slices (route "yuv422") by the Python parser (a
    CABAC B slice's arithmetic decoder is the native one), and the
    pictures with an I_PCM MB (ipcm: their types, one slice each): a
    CAVLC I or P slice parsed again by the Python parser after the
    native one stopped at the I_PCM MB, the picture's intra recon the
    Python walk. dec: the decoder to use (a new one by default). Returns
    the per-kernel launches."""
    dec = dec or H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(b"".join(payloads))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts(enc.cfg.chroma_format == 2)
    check_frames(out, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], label)
    units = sum(r["slices"] for r in enc.results) - dp_parse
    recon = sum(r["path"] != "inter" for r in dec.pictures)
    rerun = 0 if cabac else sum(t != "B" for t in ipcm)
    # 4:2:2 CAVLC I / P slices: the Python parser, as in jm_tpu
    y422 = 0 if cabac or enc.cfg.chroma_format == 1 else units - b_parse
    check_routes(label, **({"cabac": units} if cabac
                           else {"parse": units - b_parse - rerun - y422}),
                 recon=recon - len(ipcm), dp={"parse": dp_parse},
                 b={"parse": b_parse},
                 other={"parse": {"rerun": rerun},
                        "recon": {"python": len(ipcm)},
                        "yuv422": {"parse": y422}})
    for name, cnt in launches.items():
        if once_per_picture and cnt != len(out):
            raise AssertionError(f"{label}: {name} launched {cnt} times for "
                                 f"{len(out)} pictures")
    print(f"{label} on the card: {len(out)} frames ({units + dp_parse} "
          f"slices) equal "
          f"the encoder's recon; {len(out) / total_s:.3f} frames/s; per "
          f"picture " + ", ".join(
              f"{r['type'][0]}/{r['path']} {r['seconds'] * 1e3:.1f} ms "
              f"(parse {r['parse_s'] * 1e3:.1f}, intra recon "
              f"{r['host_recon_s'] * 1e3:.1f}, device "
              f"{r['device_s'] * 1e3:.1f})" for r in dec.pictures)
          + f"; launches {launches}", flush=True)
    return launches


def per_frame_report(enc, payloads, label: str) -> None:
    """Each picture's QP, bytes and slices, and its wall split on the
    per-frame path (steps synchronized): device encode (upload,
    i_frame_step or p_frame_step, rate control's MAD, the IDR's deblock
    and downloads), host intra encode (multi-slice I), download + host
    commit, device deblock + prep_ref, host serialize."""
    for r, pay in zip(enc.results, payloads):
        d = r["disp"]
        t = {k: sum(v) * 1e3 for k, v in enc.split[d].items()}
        host = t.get("download", 0.0) + t.get("host_intra", 0.0)
        steps = host + t.get("i_host", 0.0) + t.get(
            "deblock_prep", 0.0) + t["slice"]
        print(f"{label} frame {d} {r['type']} QP {r['qp']}: {len(pay)} B, "
              f"{r['slices']} slices, wall {t['frame']:.1f} ms = device "
              f"encode {t['frame'] - steps:.1f} ms, host intra encode "
              f"{t.get('i_host', 0.0):.1f} ms, download + host commit "
              f"{host:.1f} ms, device deblock + prep_ref "
              f"{t.get('deblock_prep', 0.0):.1f} ms, serialize "
              f"{t['slice']:.1f} ms", flush=True)


def launch_counts(fmt422: bool = False) -> dict:
    """The kernel launches since the last reset on an 8-bit path: K1's and
    those of the chroma kernel of the picture format (K2 at 4:2:0, K2-422
    at 4:2:2 with fmt422); no other kernel (the other format's chroma
    kernel, a >8-bit variant) may have been launched."""
    keys = ("deblock_luma",
            "deblock_chroma422" if fmt422 else "deblock_chroma")
    out = dict(kernels.launches)
    extra = {k: v for k, v in out.items() if k not in keys and v}
    if extra:
        raise AssertionError(f"kernels {extra} launched on an 8-bit "
                             f"{'4:2:2' if fmt422 else '4:2:0'} path")
    return {k: out[k] for k in keys}


def check_launches(launches, n: int, label: str) -> None:
    for name, cnt in launches.items():
        if cnt != n:
            raise AssertionError(f"{label}: {name} launched {cnt} times, "
                                 f"expected once for each of {n} pictures")


# The CPU references of phases 8-27 (encodes of their first pictures,
# decodes) run in CPU_WORKERS worker processes while the card works
# through those phases: on the card's host they take about half of the
# phases' wall time when run in line. The workers run at a lower
# scheduling priority (WORKER_NICE) than the process that drives the
# card, which waits for a reference only when it checks it.
CPU_WORKERS = 3
WORKER_NICE = 10
# when each CPU reference arrived (perf_counter seconds), by name
CPU_DONE = {}


def _worker_init() -> None:
    os.nice(WORKER_NICE)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // CPU_WORKERS))


def cpu_encode(cfg, frames, per_frame: bool = False):
    """The frames encoded on the CPU, through encode_frame when per_frame
    else encode_stream: (payloads, recon (Y, U, V) of each picture, QPs,
    fallbacks)."""
    enc = Encoder(cfg, device="cpu")
    payloads = ([enc.encode_frame(*f) for f in frames] if per_frame
                else enc.encode_stream(frames))
    return (payloads, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], [r["qp"] for r in enc.results],
            enc.fallbacks)


def cpu_decode(data: bytes):
    """The stream decoded on the CPU: (Y, U, V) of each picture."""
    return [(f.Y, f.U, f.V)
            for f in H264Decoder(device="cpu").decode_annexb(data)]


def drop_primary(payloads, k: int) -> bytes:
    """The stream of payloads with picture k's first NAL unit (its
    primary slice) left out: picture k keeps its redundant coding."""
    units = payloads[k].split(b"\x00\x00\x00\x01")[1:]
    return (b"".join(payloads[:k]) + b"\x00\x00\x00\x01" + units[1]
            + b"".join(payloads[k + 1:]))


def cpu_redundant(cfg, frames):
    """Phase 19's CPU reference: the frames encoded through encode_frame
    and the decode of that stream with picture 2's primary dropped."""
    out = cpu_encode(cfg, frames, per_frame=True)
    return out + (cpu_decode(drop_primary(out[0], 2)),)


def golden_bytes(name: str) -> bytes:
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "tests", "golden", f"{name}.264"),
              "rb") as f:
        return f.read()


def start_cpu_references(pool, frames, first: int, tools_dir: str) -> dict:
    """Submit the CPU references of phases first..44 (4, 18, 22, 25, 28,
    31, 34, 37, 40, 43, 46, 49 or 52; with first 40 or later those of
    phases 47-54 that run too, else sp_cpu_jobs, mvc_cpu_jobs and
    wide_cpu_jobs after phase 39; tools_dir: phase 51's and 54's
    directory) to the worker pool in the order of the phase that
    checks each (phases 8-9's after phase 14), so that the pool finishes
    each before the card needs it (PR 15 runs 2-3, with the long 1080p
    host encodes of phases 28 and 34 first, waited 24.2 / 44.9 s for phase
    19's); returns their AsyncResults by name."""
    jobs = []                   # (the phase that checks it, name, fn, args)
    if first <= 4:
        jobs += [(4, "main", cpu_encode, (rd_cfg(), frames[:2]))]
    if first <= 8:
        jobs += [(14, "scene_cut", cpu_encode, (rd_cfg(),
                                                cut_frames(frames))),
                 (14, "md_low", cpu_encode, (md_low_cfg(), frames[:2])),
                 (15, "low_latency", cpu_encode, (low_latency_cfg(),
                                                  frames[:3]))]
    if first <= 18:
        jobs += [(18, "resilient", cpu_encode, (resilient_cfg(),
                                                frames[:4])),
                 (19, "redundant", cpu_redundant, (redundant_cfg(),
                                                   frames[:LOSSY_CPU]))]
        jobs += [(21, name, cpu_decode, (golden_bytes(name),))
                 for name in ("dp1", "cif_dp")]
    if first <= 22:
        jobs += [(22, "b_encode", cpu_encode, (b_cfg(), frames[:B_FRAMES],
                                               True)),
                 (23, "cif_main", cpu_decode, (golden_bytes("cif_main"),)),
                 (24, "gop", cpu_encode, (gop_cfg(), cif(frames, GOP_CPU),
                                          True))]
    if first <= 25:
        jobs += [(25, "wp_p", cpu_encode, (wp_cfg(),
                                           fade(frames[:WP_FRAMES])))]
        jobs += [(26, f"wp_cif_{label}", cpu_encode,
                  (wp_cif_cfg(kw), cif(fade(frames[:n]), n)))
                 for label, n, kw in WP_CIF]
    if first <= 28:
        jobs += [(28, "high", cpu_encode, (high_cfg(),
                                           frames[:HIGH_FRAMES]))]
        jobs += [(29, f"high_cif_{label}", cpu_encode,
                  (high_cif_cfg(kw), cif(frames, n)))
                 for label, n, kw in HIGH_CIF]
    if first <= 31:
        jobs += [(31, "motion", cpu_encode, (motion_cfg(),
                                             frames[:MOTION_FRAMES]))]
        jobs += [(32, f"motion_cif_{label}",
                  cpu_explicit if label == "e" else cpu_encode,
                  (motion_cif_cfg(kw), cif(frames, n)))
                 for label, n, kw in MOTION_CIF]
    if first <= 34:
        jobs += [(34, "rdpd", cpu_encode, (rdpd_cfg(), frames[:RD_FRAMES]))]
        jobs += [(35, f"rd_qcif_{label}", cpu_encode,
                  (rd_qcif_cfg(qp, kw), qcif_frames(frames, patch)))
                 for label, qp, kw, patch in RD_QCIF]
    if first <= 37:
        jobs += [(38, "y422", cpu_encode, (y422_cfg(), to_422(frames[:1])))]
        jobs += [(38, f"y422_cif_{label}", cpu_encode,
                  (y422_cif_cfg(kw), to_422(cif(frames, n))))
                 for label, n, kw in Y422_CIF]
    if first <= 43:
        jobs += [(44, "field_1080p", cpu_field, (field_cfg(), frames[:1])),
                 (44, "field_cif", cpu_field,
                  (field_cif_cfg(), cif(frames, FIELD_CIF_FRAMES)))]
    jobs.sort(key=lambda j: j[0])
    refs = {name: pool.apply_async(fn, args, callback=_arrived(name))
            for _, name, fn, args in jobs}
    if 40 <= first <= 46:
        refs.update(sp_cpu_jobs(pool, frames))
    if 40 <= first <= 49:
        refs.update(mvc_cpu_jobs(pool, frames, tools_dir))
    if 40 <= first <= 52:
        refs.update(wide_cpu_jobs(pool, frames, tools_dir))
    return refs


def sp_cpu_jobs(pool, frames) -> dict:
    """The CPU references of phases 47-48, submitted to the worker pool:
    a full run submits them after phase 39, so that the CPU decodes that
    phases 30-39 submit do not queue behind them (PR 17 run 2, with them
    submitted first, waited 54.1 s for phase 30's); returns their
    AsyncResults by name."""
    jobs = [("sp_1080p", cpu_sp, (sp_cfg(), frames[:SP_FRAMES]))]
    jobs += [(f"sp_cif_{label}", cpu_sp, (sp_cif_cfg(kw), cif(frames, n)))
             for label, n, kw in SP_CIF]
    jobs += [("conceal_cif", cpu_conceal_cif,
              (conceal_cif_cfg(), cif(frames, CONCEAL_CIF_FRAMES)))]
    return {name: pool.apply_async(fn, args, callback=_arrived(name))
            for name, fn, args in jobs}


def _arrived(name: str):
    """A pool callback that notes when the CPU reference `name` arrived."""
    def note(_result):
        CPU_DONE[name] = time.perf_counter()
    return note


def check_cpu_encode(label: str, job, payloads, enc, n: int) -> tuple:
    """The first n pictures of the CPU reference `job` (cpu_encode's
    result, waited for here) against the card's payloads, recon, QPs and
    fallbacks; returns the result."""
    t0 = time.perf_counter()
    out = job.get()
    cpu_payloads, recon, qps, fallbacks = out[:4]
    for i in range(n):
        if cpu_payloads[i] != payloads[i]:
            raise AssertionError(f"{label} frame {i}: CPU and CUDA payloads "
                                 f"differ")
        for k, plane in enumerate("YUV"):
            if not np.array_equal(recon[i][k],
                                  getattr(enc.results[i]["frame"], plane)):
                raise AssertionError(f"{label} frame {i} {plane}: recon "
                                     f"differs")
    if qps[:n] != [r["qp"] for r in enc.results[:n]]:
        raise AssertionError(f"{label}: CPU and CUDA QPs differ")
    if fallbacks != [d for d in enc.fallbacks if d < n]:
        raise AssertionError(f"{label}: fallbacks {fallbacks} on the CPU")
    print(f"cross-check {label}: the CPU's payloads, recon and QPs of "
          f"{n} pictures equal the CUDA run (CPU worker; waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def low_latency_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, slice_mode=1,
                         slice_argument=W // 16, rc_enable=True,
                         rc_bitrate=8_000_000.0, frame_rate=30.0,
                         poc_type=2)


def resilient_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, data_partition=1,
                         long_term_period=2, enable_vui=True,
                         sei_user_data=bytes(range(16)))


def redundant_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, redundant_period=2,
                         redundant_qp_off=4, poc_mem_mgmt=1)


def low_latency_phase(frames, cpu_ref):
    """Phase 15: the low-latency 1080p stream (one MB row per slice, rate
    control at 8 Mbit/s, POC type 2), held against its CPU reference
    cpu_ref (IDR + 2 P); returns (encode launches, decode launches)."""
    frames = frames[:LL_FRAMES]
    n = len(frames)
    cfg = low_latency_cfg()
    enc, payloads, launches, total_s = timed_encode(cfg, frames,
                                                    CabacTimedEncoder)
    slices = [r["slices"] for r in enc.results]
    if slices != [H // 16] * n:
        raise AssertionError(f"low latency: slices per picture {slices}")
    check_routes("low-latency encode", serialize=sum(slices))
    check_launches(launches, n, "low-latency encode")
    n_mbs = (W // 16) * (H // 16)
    host_ms = sum(enc.split[0]["i_host"]) * 1e3
    print(f"encode low latency 1080p {''.join(r['type'] for r in enc.results)}"
          f" ({H // 16} slices of one MB row, RC 8 Mbit/s, POC type 2): "
          f"{n / total_s:.3f} frames/s, {sum(map(len, payloads))} stream "
          f"bytes, QPs {[r['qp'] for r in enc.results]}, bytes "
          f"{[len(p) for p in payloads]}, launches {launches}; IDR host "
          f"intra encode {host_ms:.0f} ms = {host_ms / n_mbs:.3f} ms/MB",
          flush=True)
    per_frame_report(enc, payloads, "low latency")
    dec_launches = card_decode(payloads, enc, "decode low latency 1080p")
    check_cpu_encode("low latency IDR + 2 P", cpu_ref, payloads, enc, 3)
    return launches, dec_launches


def cif(frames, n: int):
    """The top-left 352x288 of the first n frames."""
    return [(Y[:288, :352].copy(), U[:144, :176].copy(), V[:144, :176].copy())
            for Y, U, V in frames[:n]]


def fmo_phase(frames):
    """Phase 16: FMO type 1 (2 groups) with slices of at most 1500 bytes,
    md_low, qp_p, POC type 1, at CIF; returns (encode launches, decode
    launches)."""
    from jm_tpu_torch.bitstream.nal import split_annexb
    frames = cif(frames, N_CIF)
    cfg = EncoderConfig(width=352, height=288, qp=28, qp_p=30,
                        search_range=16, device_rd=False, num_slice_groups=2,
                        slice_group_map_type=1, slice_mode=2,
                        slice_argument=1500, poc_type=1)
    enc, payloads, launches, total_s = timed_encode(cfg, frames,
                                                    CabacTimedEncoder)
    check_routes("FMO encode", serialize=enc.units)
    check_launches(launches, N_CIF, "FMO encode")
    sizes = [len(u.rbsp) for u in split_annexb(b"".join(payloads))
             if u.nal_unit_type in (1, 5)]
    if max(sizes) + 1 > 1500:
        raise AssertionError(f"FMO: a slice of {max(sizes) + 1} bytes")
    tries = {r["disp"]: len(enc.split[r["disp"]]["slice"])
             for r in enc.results}
    print(f"encode FMO CIF {''.join(r['type'] for r in enc.results)} (type "
          f"1, 2 groups, slices <= 1500 B, md_low, qp 28 / qp_p 30, POC "
          f"type 1): {N_CIF / total_s:.3f} frames/s, QPs "
          f"{[r['qp'] for r in enc.results]}, bytes "
          f"{[len(p) for p in payloads]}, slices "
          f"{[r['slices'] for r in enc.results]}, codings per picture "
          f"{list(tries.values())}, largest slice RBSP {max(sizes)} B, "
          f"launches {launches}", flush=True)
    per_frame_report(enc, payloads, "FMO")
    return launches, card_decode(payloads, enc, "decode FMO CIF")


def cabac_rc_phase(frames):
    """Phase 17: CABAC with two MB rows per slice and rate control at
    1 Mbit/s, at CIF; returns (encode launches, decode launches)."""
    frames = cif(frames, N_CIF)
    cfg = EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                        device_rd=True, entropy="cabac",
                        cabac_adapt_init=True, slice_mode=1,
                        slice_argument=22, rc_enable=True,
                        rc_bitrate=1_000_000.0)
    enc, payloads, launches, total_s = timed_encode(cfg, frames,
                                                    CabacTimedEncoder)
    check_routes("CABAC slices + RC encode (the CABAC writer is Python)")
    check_launches(launches, N_CIF, "CABAC slices + RC encode")
    print(f"encode CABAC slices + RC CIF "
          f"{''.join(r['type'] for r in enc.results)} (22 MBs per slice, "
          f"1 Mbit/s): {N_CIF / total_s:.3f} frames/s, QPs "
          f"{[r['qp'] for r in enc.results]}, bytes "
          f"{[len(p) for p in payloads]}, cabac_init_idc of the P slices "
          f"{[r['cabac_init_idc'] for r in enc.results[1:]]}, launches "
          f"{launches}", flush=True)
    per_frame_report(enc, payloads, "CABAC slices + RC")
    return launches, card_decode(payloads, enc,
                                 "decode CABAC slices + RC CIF", cabac=True)


def nal_bytes(payloads, types) -> int:
    """Bytes of the NAL units of the given types (start codes excluded)."""
    from jm_tpu_torch.bitstream.nal import split_annexb
    return sum(len(u.rbsp) + 1 for u in split_annexb(b"".join(payloads))
               if u.nal_unit_type in types)


def resilient_phase(frames, cpu_ref):
    """Phase 18: a resilient 1080p stream through encode_stream (the
    per-frame path): data partitions, a long-term anchor every 2nd
    picture, VUI timing and a 16-byte user-data SEI, held against its CPU
    reference cpu_ref (IDR + 3 P); returns (encode launches, decode
    launches)."""
    frames = frames[:RES_FRAMES]
    n = len(frames)
    cfg = resilient_cfg()
    user_data = cfg.sei_user_data
    enc, payloads, launches, total_s = timed_encode(cfg, frames,
                                                    CabacTimedEncoder)
    check_routes("resilient encode", serialize=1, dp={"serialize": n - 1})
    check_launches(launches, n, "resilient encode")
    # frame 3 predicts from frame 1, past the long-term frame 2
    if [r.get("ref_poc") for r in enc.results[1:4]] != [0, 2, 2]:
        raise AssertionError(f"resilient: references "
                             f"{[r.get('ref_poc') for r in enc.results]}")
    parts = {k: nal_bytes(payloads, (t,)) for k, t in (("A", 2), ("B", 3),
                                                      ("C", 4))}
    print(f"encode resilient 1080p {''.join(r['type'] for r in enc.results)}"
          f" (data partitions, long-term every 2nd picture, VUI, SEI): "
          f"{n / total_s:.3f} frames/s, {sum(map(len, payloads))} stream "
          f"bytes, bytes {[len(p) for p in payloads]}, partitions A / B / C "
          f"{parts['A']} / {parts['B']} / {parts['C']} B, references (POC) "
          f"{[r.get('ref_poc') for r in enc.results[1:]]}, launches "
          f"{launches}", flush=True)
    per_frame_report(enc, payloads, "resilient (serialize = DP, Python)")
    check_cpu_encode("resilient IDR + 3 P", cpu_ref, payloads, enc, 4)
    dec = H264Decoder(device=DEVICE)
    dec_launches = card_decode(payloads, enc, "decode resilient 1080p",
                               dp_parse=n - 1, dec=dec)
    ud = [m.fields["data"] for m in dec.sei_messages if m.payload_type == 5]
    if ud != [user_data]:
        raise AssertionError(f"resilient: SEI user data {ud}")
    print(f"decode resilient: the SEI's user data {ud[0].hex()} in "
          f"sei_messages", flush=True)
    return launches, dec_launches


class RedundantTimedEncoder(CabacTimedEncoder):
    """CabacTimedEncoder that also times each device P encode ("p_step":
    the primary's, then the redundant coding's) and each redundant
    slice's serialization ("red_serialize")."""

    def _p_step(self, *a, **kw):
        return self._timed(self.display_idx - 1, "p_step", super()._p_step,
                           *a, **kw)

    def _serialize_redundant(self, *a):
        return self._timed(self.display_idx - 1, "red_serialize",
                           super()._serialize_redundant, *a)


def redundant_phase(frames, cpu_ref):
    """Phase 19: redundant pictures through encode_frame + flush (the only
    route that writes them, as in jm_tpu): a redundant coding after every
    2nd P picture at QP + 4, with POC-based MMCO, held against its CPU
    reference cpu_ref (the first LOSSY_CPU pictures and the decode of
    that stream with picture 2's primary dropped); returns (encode
    launches, decode launches)."""
    from jm_tpu_torch.bitstream.nal import split_annexb
    frames = frames[:RES_FRAMES]
    n = len(frames)
    enc = RedundantTimedEncoder(redundant_cfg(), device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    payloads = [enc.encode_frame(*f) for f in frames] + [enc.flush()]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    n_red = (n - 1) // 2
    check_routes("redundant encode", serialize=n + n_red)
    check_launches(launches, n, "redundant encode (primaries only)")
    red_bytes = {}
    for d, pay in enumerate(payloads[:n]):
        units = split_annexb(pay)
        red = [u for u in units if u.nal_unit_type == 1 and u.nal_ref_idc == 0]
        if len(red) != (1 if d and d % 2 == 0 else 0):
            raise AssertionError(f"redundant: frame {d} has {len(red)} "
                                 f"redundant slices")
        if red:
            red_bytes[d] = len(red[0].rbsp) + 1
    print(f"encode redundant 1080p {''.join(r['type'] for r in enc.results)}"
          f" (redundant coding after every 2nd P at QP {QP + 4}, MMCO 1 by "
          f"POC): {n / total_s:.3f} frames/s, {sum(map(len, payloads))} "
          f"stream bytes, redundant slices {red_bytes} B, launches "
          f"{launches}", flush=True)
    for r in enc.results[1:]:
        d = r["disp"]
        t = {k: [x * 1e3 for x in v] for k, v in enc.split[d].items()}
        line = (f"redundant frame {d}: wall {t['frame'][0]:.1f} ms; primary "
                f"device encode {t['p_step'][0]:.1f} ms, download + commit "
                f"{t['download'][0] + t['host_intra'][0]:.1f} ms, deblock + "
                f"prep {t['deblock_prep'][0]:.1f} ms, serialize "
                f"{t['slice'][0]:.1f} ms")
        if d in red_bytes:
            line += (f"; redundant device encode {t['p_step'][1]:.1f} ms, "
                     f"download + commit "
                     f"{t['download'][1] + t['host_intra'][1]:.1f} ms, "
                     f"serialize {t['red_serialize'][0]:.1f} ms, "
                     f"{red_bytes[d]} B")
        print(line, flush=True)
    cpu_lossy = check_cpu_encode(
        "redundant IDR + 3 P (two redundant codings)", cpu_ref, payloads, enc,
        LOSSY_CPU)[4]
    dec_launches = card_decode(payloads, enc, "decode redundant 1080p "
                               "(redundant codings discarded)")
    # the first primary that has a redundant coding is lost
    t0 = time.perf_counter()
    got = H264Decoder(device=DEVICE).decode_annexb(drop_primary(payloads, 2))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if len(got) != n:
        raise AssertionError(f"lossy redundant decode: {len(got)} frames")
    check_frames(got[:LOSSY_CPU], cpu_lossy, "lossy redundant decode")
    diff = int(np.abs(got[2].Y.astype(np.int16)
                      - enc.results[2]["frame"].Y.astype(np.int16)).max())
    print(f"decode redundant with frame 2's primary lost: {n} frames on the "
          f"card in {card_s * 1e3:.1f} ms, the first {LOSSY_CPU} equal to "
          f"the CPU decode of the same stream's first {LOSSY_CPU} pictures; "
          f"frame 2 from its redundant coding, max |diff| {diff} against "
          f"the primary's recon", flush=True)
    return launches, dec_launches


def deblock_off_phase(frames, rd_fps: float):
    """Phase 20: the loop filter off (deblock=False, the per-frame path);
    returns (encode launches, decode launches)."""
    frames = frames[:RES_FRAMES]
    n = len(frames)
    cfg = EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                        device_rd=True, deblock=False)
    enc, payloads, launches, total_s = timed_encode(cfg, frames,
                                                    CabacTimedEncoder)
    check_routes("loop filter off encode", serialize=n)
    if any(launches.values()):
        raise AssertionError(f"loop filter off: encode launches {launches}")
    print(f"encode loop filter off 1080p "
          f"{''.join(r['type'] for r in enc.results)}: {n / total_s:.3f} "
          f"frames/s (phase 3, the pipe with the filter on: "
          f"{'not run' if rd_fps is None else f'{rd_fps:.3f}'}), "
          f"{sum(map(len, payloads))} stream bytes, launches {launches}",
          flush=True)
    per_frame_report(enc, payloads, "loop filter off")
    dec_launches = card_decode(payloads, enc, "decode loop filter off 1080p",
                               once_per_picture=False)
    return launches, dec_launches


def dp_golden_phase(cpu_refs) -> None:
    """Phase 21: JM's data-partitioned goldens on the card: dp1.264 equal
    to its _rec.yuv and the CPU decode, cif_dp.264 (MMCO) to the CPU
    decode (cpu_refs[name]); frames/s and the parse split."""
    for name in ("dp1", "cif_dp"):
        data = golden_bytes(name)
        H264Decoder(device=DEVICE).decode_annexb(data)        # warm-up
        torch.cuda.synchronize()
        dec = H264Decoder(device=DEVICE)
        native.reset_routes()
        t0 = time.perf_counter()
        got = dec.decode_annexb(data)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        routes = {k: dict(v) for k, v in native.routes.items()}
        t0 = time.perf_counter()
        check_frames(got, cpu_refs[name].get(), f"decode {name}")
        cpu_s = time.perf_counter() - t0
        if name == "dp1":
            decode_golden(name)
        p = [r for r in dec.pictures if r["type"] == "P"]
        print(f"decode {name}.264 on the card: {len(got)} frames equal the "
              f"CPU decode (CPU worker; waited {cpu_s:.1f} s); "
              f"{len(got) / total_s:.3f} "
              f"frames/s; P pictures: parse "
              f"{np.mean([r['parse_s'] for r in p]) * 1e3:.1f} ms, intra "
              f"recon {np.mean([r['host_recon_s'] for r in p]) * 1e3:.1f} "
              f"ms, device {np.mean([r['device_s'] for r in p]) * 1e3:.1f} "
              f"ms, wall {np.mean([r['seconds'] for r in p]) * 1e3:.1f} ms "
              f"on average; routes {routes}", flush=True)


# ---- 22-24: B pictures --------------------------------------------------

def b_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, num_b=1, entropy="cabac")


def gop_cfg():
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         device_rd=True, num_b=3, hierarchical=1,
                         intra_period=2, sei_recovery_point=True,
                         mmco_policy="cra")


class BTimedEncoder(SplitTimedEncoder):
    """SplitTimedEncoder that also times each coded picture ("picture"),
    anchor or B, by display index (the steps synchronized)."""

    def _emit_anchor(self, frame, disp, **kw):
        return self._timed(disp, "picture", super()._emit_anchor, frame,
                           disp, **kw)

    def _emit_b(self, frame, disp, *a, **kw):
        return self._timed(disp, "picture", super()._emit_b, frame, disp,
                           *a, **kw)


def b_encode(cfg, frames):
    """frames encoded on the card (with B pictures encode_stream takes
    encode_frame for each frame: the calls that close a group return the
    anchor and its Bs), with nothing left for flush; returns
    timed_encode's (encoder, payload of each call, launches, seconds)."""
    out = timed_encode(cfg, frames, BTimedEncoder)
    if out[0].flush():
        raise AssertionError("B encode: frames left for flush")
    return out


def b_report(enc, label: str) -> None:
    """Each picture of a B stream (coding order): type, QP, bytes, wall ms
    and its split: a P picture's download + host commit, device deblock +
    prep_ref and serialize; a B picture's device SAD tables, host MB loop
    and host serializer (ms per MB), device deblock + prep_ref, and its
    MB decisions."""
    n_mbs = enc.mb_w * enc.mb_h
    for r in enc.results:
        d = r["disp"]
        t = {k: sum(v) * 1e3 for k, v in enc.split.get(d, {}).items()}
        line = (f"{label} picture {d} {r['type']}"
                f"{' (reference)' if r.get('ref') else ''} QP {r['qp']}: "
                f"{r['bits'] // 8} B, {t.get('picture', 0.0):.1f} ms")
        if r["type"] == "P":
            line += (f" (download + host commit "
                     f"{t.get('download', 0) + t.get('host_intra', 0):.1f}"
                     f" ms, device deblock + prep_ref "
                     f"{t.get('deblock_prep', 0.0):.1f} ms, serialize "
                     f"{t.get('serialize', 0.0):.1f} ms)")
        elif r["type"] == "B":
            sp = {k: v * 1e3 for k, v in r["split"].items()}
            line += (f" = device SAD tables {sp['sad_s']:.1f} ms, host MB "
                     f"loop {sp['host_mb_s']:.1f} ms "
                     f"({sp['host_mb_s'] / n_mbs:.3f} ms/MB), device "
                     f"deblock + prep_ref {sp['deblock_s']:.1f} ms, host "
                     f"serialize {sp['serialize_s']:.1f} ms "
                     f"({sp['serialize_s'] / n_mbs:.3f} ms/MB); MBs "
                     f"{r['mix']}")
        print(line, flush=True)


def b_encode_phase(frames, cpu_ref):
    """Phase 22: I0 P2 B1 at 1080p, CABAC, through encode_frame, held
    against the CPU encode cpu_ref; returns (encoder, payloads,
    launches)."""
    frames = frames[:B_FRAMES]
    enc, payloads, launches, total_s = b_encode(b_cfg(), frames)
    types = "".join(r["type"] for r in enc.results)
    if types != "IPB":
        raise AssertionError(f"B encode: pictures {types}")
    check_routes("B encode (the CABAC writer is Python)", b={"serialize": 1})
    check_launches(launches, len(types), "B encode")
    print(f"encode B 1080p {types} (coding order; CABAC, num_b 1, QP {QP} / "
          f"qp_b {enc.results[-1]['qp']}, SR 16): "
          f"{len(frames) / total_s:.3f} frames/s, "
          f"{sum(map(len, payloads))} stream bytes, launches {launches}",
          flush=True)
    b_report(enc, "B encode 1080p")
    check_cpu_encode("B encode I + P + B", cpu_ref, payloads, enc,
                     len(frames))
    return enc, payloads, launches


def b_parse_ms_per_mb(dec, n_mbs: int) -> float:
    b = [r["parse_s"] for r in dec.pictures if r["type"] == "B"]
    return sum(b) * 1e3 / (len(b) * n_mbs)


def b_ops_timing() -> None:
    """CUDA-event times at 1080p of the B path's tensor stages (candidates
    for hand kernels, not kernels): the decoder's inter_recon_b against
    inter_recon_p on the same random motion (two references, pdir 0..2,
    MVs within +-16 pixels), and the B coder's full_search_sad16 of one
    list at SR 16."""
    from jm_tpu_torch.ops.dec import inter_recon_b, inter_recon_p
    from jm_tpu_torch.ops.enc import full_search_sad16, prep_ref
    rng = np.random.default_rng(5)
    mb_w, mb_h = W // 16, H // 16
    n = mb_w * mb_h

    def t(a):
        return torch.as_tensor(a, device=DEVICE)

    states = [prep_ref(*(t(rng.integers(0, 256, s, dtype=np.uint8))
                         for s in ((H, W), (H // 2, W // 2),
                                   (H // 2, W // 2)))) for _ in range(2)]
    stacks = tuple(torch.stack([st[i] for st in states]) for i in range(3))
    mv = t(rng.integers(-64, 65, (n, 16, 2)).astype(np.int32))
    mv1 = t(rng.integers(-64, 65, (n, 16, 2)).astype(np.int32))
    r0 = t(np.zeros((n, 4), np.int32))
    r1 = t(np.ones((n, 4), np.int32))
    pdir = t(rng.integers(0, 3, (n, 4)).astype(np.int8))
    res_l = t(np.zeros((n, 16, 4, 4), np.int32))
    res_c = t(np.zeros((n, 2, 4, 4, 4), np.int32))
    inter = t(np.ones(n, bool))
    ms_p = cuda_ms(lambda: inter_recon_p(mv, r0, res_l, res_c, *stacks,
                                         inter, mb_w=mb_w, mb_h=mb_h))
    ms_b = cuda_ms(lambda: inter_recon_b(mv, mv1, r0, r1, pdir, res_l,
                                         res_c, *stacks, inter, mb_w=mb_w,
                                         mb_h=mb_h))
    src = t(rng.integers(0, 256, (H, W), dtype=np.uint8))
    ms_sad = cuda_ms(lambda: full_search_sad16(src, states[0][0][0], mb_w,
                                               mb_h, 16), reps=3)
    print(f"B tensor stages at {W}x{H} (CUDA events, median): "
          f"inter_recon_b {ms_b:.3f} ms (inter_recon_p on the same motion "
          f"{ms_p:.3f} ms), full_search_sad16 one list SR 16 {ms_sad:.3f} ms",
          flush=True)


def b_decode_phase(enc, payloads, cpu_refs):
    """Phase 23: phase 22's stream decoded on the card, then JM's B goldens
    (against their _rec.yuv; cif_main against the CPU decode); returns
    (the stream's launches, the goldens' launches summed)."""
    dec = H264Decoder(device=DEVICE)
    launches = card_decode(payloads, enc, "decode B 1080p", cabac=True,
                           dec=dec, b_parse=1)
    n_mbs = (W // 16) * (H // 16)
    b = [r for r in dec.pictures if r["type"] == "B"][0]
    print(f"decode B 1080p: the B picture's parse {b['parse_s'] * 1e3:.1f} "
          f"ms ({b_parse_ms_per_mb(dec, n_mbs):.3f} ms/MB), device B "
          f"recon + bS + K1/K2 + prep_ref + download "
          f"{b['device_s'] * 1e3:.1f} ms, intra recon "
          f"{b['host_recon_s'] * 1e3:.1f} ms", flush=True)
    b_ops_timing()
    total = {}
    for name in B_GOLDENS + ("cif_main",):
        data = golden_bytes(name)
        dec = H264Decoder(device=DEVICE)
        kernels.reset_launches()
        native.reset_routes()
        t0 = time.perf_counter()
        if name == "cif_main":
            got = dec.decode_annexb(data)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t1 = time.perf_counter()
            check_frames(got, cpu_refs[name].get(), f"decode {name}")
            what = (f"equal the CPU decode (CPU worker; waited "
                    f"{time.perf_counter() - t1:.1f} s)")
        else:
            got = decode_golden(name, dec)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            what = f"equal {name}_rec.yuv"
        gl = launch_counts()
        check_launches(gl, len(got), f"decode {name}")
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        mbs = got[0].Y.size // 256
        print(f"decode {name}.264 on the card "
              f"({''.join(r['type'][0] for r in dec.pictures)}): "
              f"{len(got)} frames {what}; {len(got) / dt:.3f} frames/s; B "
              f"parse {b_parse_ms_per_mb(dec, mbs):.3f} ms/MB; launches "
              f"{gl}; routes {native.routes}", flush=True)
    return launches, total


def gop_phase(frames, cpu_ref):
    """Phase 24: the CIF GOP variants (a dyadic pyramid of 3 Bs, an
    open-GOP I every 2nd anchor with its recovery point SEI, CRA
    marking), encoded and decoded on the card, the IDR and first
    mini-GOP held against the CPU encode cpu_ref; returns (encode
    launches, decode launches)."""
    frames = cif(frames, GOP_FRAMES)
    enc, payloads, launches, total_s = b_encode(gop_cfg(), frames)
    types = "".join(r["type"] for r in enc.results)
    if types != "IPBBBIBBBPBBB":
        raise AssertionError(f"GOP: pictures {types}")
    n_b = types.count("B")
    check_routes("GOP encode", serialize=len(types) - n_b,
                 b={"serialize": n_b})
    check_launches(launches, len(types), "GOP encode")
    print(f"encode GOP CIF {types} (coding order; num_b 3 as a pyramid, "
          f"an open-GOP I every 2nd anchor with a recovery point SEI, CRA "
          f"marking, CAVLC): {len(frames) / total_s:.3f} frames/s, "
          f"{sum(map(len, payloads))} stream bytes, reference Bs "
          f"{[r['disp'] for r in enc.results if r.get('ref')]}, QPs "
          f"{[r['qp'] for r in enc.results]}, launches {launches}",
          flush=True)
    b_report(enc, "GOP CIF")
    dec = H264Decoder(device=DEVICE)
    dec_launches = card_decode(payloads, enc, "decode GOP CIF", dec=dec,
                               b_parse=n_b)
    points = [m for m in dec.sei_messages if m.payload_type == 6]
    if len(points) != types[1:].count("I"):
        raise AssertionError(f"GOP: {len(points)} recovery point SEIs")
    check_cpu_encode("GOP IDR + first mini-GOP", cpu_ref, payloads, enc,
                     GOP_CPU)
    return launches, dec_launches


def b_phases(frames, cpu_refs):
    """Phases 22-24; returns the launches of each of their paths by name
    (b, b_decode, b_goldens_decode, gop, gop_decode)."""
    out = {}
    enc, payloads, out["b"] = b_encode_phase(frames, cpu_refs["b_encode"])
    out["b_decode"], out["b_goldens_decode"] = b_decode_phase(
        enc, payloads, cpu_refs)
    out["gop"], out["gop_decode"] = gop_phase(frames, cpu_refs["gop"])
    return out


# ---- 25-27: weighted prediction -----------------------------------------

def fade(frames, step: float = WP_FADE):
    """A fade to black: frame k's luma scaled by 1 - step k, its chroma
    pulled toward 128 by the same factor."""
    out = []
    for k, (Y, U, V) in enumerate(frames):
        f = 1.0 - step * k
        out.append(tuple(
            np.clip(c + (p.astype(np.float64) - c) * f, 0, 255)
            .astype(np.uint8) for p, c in ((Y, 0.0), (U, 128.0),
                                           (V, 128.0))))
    return out


def wp_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, weighted_pred=1)


def wp_cif_cfg(kw):
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         device_rd=True, **kw)


def wp_report(enc, label: str) -> None:
    """Each picture of a weighted stream (coding order): type, QP, bytes,
    wall ms, and a host-coded picture's split (reference download,
    estimate, device SAD table, host MB loop in ms per MB, device deblock
    + prep_ref, host serialize), its MB decisions, the host P coder's MB
    loop by part (partition search, skip candidate, intra, inter commit;
    ms per MB) and its tables."""
    n_mbs = enc.mb_w * enc.mb_h
    names = (("download_s", "reference download"), ("estimate_s",
             "estimate"), ("sad_s", "device SAD table"), ("host_mb_s",
             "host MB loop"), ("deblock_s", "device deblock + prep_ref"),
             ("serialize_s", "host serialize"))
    for r in enc.results:
        d = r["disp"]
        t = sum(enc.split.get(d, {}).get("picture", [0.0])) * 1e3
        line = (f"{label} picture {d} {r['type']}"
                f"{' (reference)' if r.get('ref') else ''} QP {r['qp']}: "
                f"{r['bits'] // 8} B, {t:.1f} ms")
        if "split" in r:
            sp = {k: v * 1e3 for k, v in r["split"].items()}
            line += " = " + ", ".join(
                f"{name} {sp[k]:.1f} ms" for k, name in names if k in sp)
            line += (f" ({sp['host_mb_s'] / n_mbs:.3f} ms/MB in the MB "
                     f"loop); MBs {r['mix']}")
            if r.get("mb_parts"):
                line += "; MB loop parts " + ", ".join(
                    f"{k} {v * 1e3 / n_mbs:.3f}"
                    for k, v in r["mb_parts"].items()) + " ms/MB"
            if r.get("wp_l0") is not None:
                line += f"; table {r['wp_l0']}"
        print(line, flush=True)


def wp_p_phase(frames, cpu_ref, pool):
    """Phase 25: the fade's IDR and weighted P picture at 1080p through
    encode_stream (CAVLC, Main), held against the CPU encode cpu_ref;
    returns (encoder, payloads, launches, the CPU decode job of the
    stream)."""
    frames = fade(frames[:WP_FRAMES])
    enc, payloads, launches, total_s = b_encode(wp_cfg(), frames)
    types = "".join(r["type"] for r in enc.results)
    if types != "IP":
        raise AssertionError(f"WP P: pictures {types}")
    check_routes("WP P encode", serialize=2)
    check_launches(launches, 2, "WP P encode")
    t = {d: sum(enc.split[d]["picture"]) * 1e3 for d in (0, 1)}
    print(f"encode WP P 1080p {types} (fade {WP_FADE} per frame, CAVLC "
          f"Main, weighted_pred 1, QP {QP}, SR 16): IDR {t[0]:.1f} ms, "
          f"P {t[1]:.1f} ms, {sum(map(len, payloads))} stream bytes (the "
          f"P picture {len(payloads[1])} B); launches {launches}",
          flush=True)
    wp_report(enc, "WP P 1080p")
    check_cpu_encode("WP P IDR + P", cpu_ref, payloads, enc, 2)
    return enc, payloads, launches, pool.apply_async(
        cpu_decode, (b"".join(payloads),))


def wp_cif_phase(frames, cpu_refs, pool) -> list:
    """Phase 26: the fade's top-left 352x288 under WP_CIF's three
    configurations, each through encode_stream on the card, one launch
    per kernel and coding of a picture (wp_mcprec codes each P picture
    three times), held against its CPU encode; returns per
    configuration (label, encoder, payloads, launches, the CPU decode
    job of the stream)."""
    out = []
    for label, n, kw in WP_CIF:
        enc, payloads, launches, total_s = b_encode(
            wp_cif_cfg(kw), cif(fade(frames[:n]), n))
        types = "".join(r["type"] for r in enc.results)
        n_b = types.count("B")
        trials = 3 if kw.get("wp_mcprec") else 1
        n_ser = (types.count("I") + trials * types.count("P")
                 if kw.get("entropy") != "cabac" else 0)
        check_routes(f"WP CIF ({label})", serialize=n_ser,
                     b={"serialize": n_b})
        # wp_mcprec codes (and deblocks, for its J) each P picture
        # three times
        check_launches(launches, len(types) + (trials - 1) *
                       types.count("P"), f"WP CIF ({label})")
        print(f"encode WP CIF ({label}) {types} (coding order; {kw}): "
              f"{n / total_s:.3f} frames/s, {sum(map(len, payloads))} "
              f"stream bytes, launches {launches}", flush=True)
        wp_report(enc, f"WP CIF ({label})")
        check_cpu_encode(f"WP CIF ({label})", cpu_refs[f"wp_cif_{label}"],
                         payloads, enc, len(types))
        out.append((label, enc, payloads, launches, pool.apply_async(
            cpu_decode, (b"".join(payloads),))))
    return out


def wp_ops_timing() -> None:
    """CUDA-event times at 1080p of the weighted device recon against the
    unweighted one on the same random motion (two references, pdir
    0..2, MVs within +-16 pixels; random weights and offsets, logWD 5):
    inter_recon_p and inter_recon_b, median of 7."""
    from jm_tpu_torch.ops.dec import inter_recon_b, inter_recon_p
    from jm_tpu_torch.ops.enc import prep_ref
    rng = np.random.default_rng(6)
    mb_w, mb_h = W // 16, H // 16
    n = mb_w * mb_h

    def t(a):
        return torch.as_tensor(a, device=DEVICE)

    states = [prep_ref(*(t(rng.integers(0, 256, s, dtype=np.uint8))
                         for s in ((H, W), (H // 2, W // 2),
                                   (H // 2, W // 2)))) for _ in range(2)]
    stacks = tuple(torch.stack([st[i] for st in states]) for i in range(3))
    mv = t(rng.integers(-64, 65, (n, 16, 2)).astype(np.int32))
    mv1 = t(rng.integers(-64, 65, (n, 16, 2)).astype(np.int32))
    r0 = t(np.zeros((n, 4), np.int32))
    r1 = t(np.ones((n, 4), np.int32))
    pdir = t(rng.integers(0, 3, (n, 4)).astype(np.int8))
    res_l = t(np.zeros((n, 16, 4, 4), np.int32))
    res_c = t(np.zeros((n, 2, 4, 4, 4), np.int32))
    inter = t(np.ones(n, bool))
    wp = (t(rng.integers(-128, 128, (n, 4, 3)).astype(np.int32)),
          t(rng.integers(-128, 128, (n, 4, 3)).astype(np.int32)),
          t(rng.integers(-128, 128, (n, 4, 3)).astype(np.int32)),
          t(rng.integers(-128, 128, (n, 4, 3)).astype(np.int32)),
          t(np.full((n, 2), 5, np.int32)))
    kw = dict(mb_w=mb_w, mb_h=mb_h)
    ms = {}
    for name, weights in (("p", None), ("p_wp", wp), ("b", None),
                          ("b_wp", wp)):
        if name.startswith("p"):
            ms[name] = cuda_ms(lambda w=weights: inter_recon_p(
                mv, r0, res_l, res_c, *stacks, inter, wp=w, **kw))
        else:
            ms[name] = cuda_ms(lambda w=weights: inter_recon_b(
                mv, mv1, r0, r1, pdir, res_l, res_c, *stacks, inter, wp=w,
                **kw))
    print(f"WP tensor stages at {W}x{H} (CUDA events, median of 7): "
          f"inter_recon_p weighted {ms['p_wp']:.3f} ms (unweighted "
          f"{ms['p']:.3f} ms), inter_recon_b weighted {ms['b_wp']:.3f} ms "
          f"(unweighted {ms['b']:.3f} ms)", flush=True)


def wp_decode_phase(streams) -> dict:
    """Phase 27: the streams of phases 25-26 decoded on the card, each
    equal to its encoder's recon and to its CPU decode, one launch per
    kernel and picture; the goldens wp_p, wp_bi, wp_both against their
    _rec.yuv; the weighted stages timed. streams: (label, encoder,
    payloads, CPU decode job). Returns the launches of each decode by
    name (wp_p_decode, wp_cif_<label>_decode, wp_goldens_decode)."""
    out = {}
    for label, enc, payloads, job in streams:
        n_b = sum(r["type"] == "B" for r in enc.results)
        cabac = enc.cfg.entropy == "cabac"
        dec = H264Decoder(device=DEVICE)
        out[f"{label}_decode"] = card_decode(
            payloads, enc, f"decode {label}", cabac=cabac, dec=dec,
            b_parse=n_b)
        t0 = time.perf_counter()
        cpu = job.get()
        got = [(r["frame"].Y, r["frame"].U, r["frame"].V)
               for r in enc.results]
        if len(cpu) != len(got) or any(
                not np.array_equal(a[k], b[k]) for a, b in zip(cpu, got)
                for k in range(3)):
            raise AssertionError(f"decode {label}: the CPU decode differs")
        print(f"decode {label}: the CPU decode equals the card's (CPU "
              f"worker; waited {time.perf_counter() - t0:.1f} s)",
              flush=True)
    total = {}
    for name in WP_GOLDENS:
        dec = H264Decoder(device=DEVICE)
        kernels.reset_launches()
        native.reset_routes()
        t0 = time.perf_counter()
        got = decode_golden(name, dec)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gl = launch_counts()
        check_launches(gl, len(got), f"decode {name}")
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        print(f"decode {name}.264 on the card "
              f"({''.join(r['type'][0] for r in dec.pictures)}): "
              f"{len(got)} frames equal {name}_rec.yuv; "
              f"{len(got) / dt:.3f} frames/s; per picture " + ", ".join(
                  f"{r['type'][0]} parse {r['parse_s'] * 1e3:.1f} ms, "
                  f"device {r['device_s'] * 1e3:.1f} ms"
                  for r in dec.pictures) + f"; launches {gl}", flush=True)
    out["wp_goldens_decode"] = total
    wp_ops_timing()
    return out


def wp_phases(frames, cpu_refs, pool) -> dict:
    """Phases 25-27, their streams' CPU decodes submitted to pool;
    returns the launches of each of their paths by name (wp_p,
    wp_cif_a..c, each also with _decode, wp_goldens_decode)."""
    out = {}
    enc, payloads, out["wp_p"], job = wp_p_phase(frames, cpu_refs["wp_p"],
                                                 pool)
    streams = [("wp_p", enc, payloads, job)]
    for label, cenc, cpay, launches, cjob in wp_cif_phase(frames, cpu_refs,
                                                          pool):
        out[f"wp_cif_{label}"] = launches
        streams.append((f"wp_cif_{label}", cenc, cpay, cjob))
    out.update(wp_decode_phase(streams))
    return out


# ---- 28-30: the host pipeline and the High profile ------------------------

def high_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         pipeline="host", transform8x8=True)


def high_cif_cfg(kw):
    """A HIGH_CIF configuration: jm_tpu's defaults (pipeline "host") at
    352x288 with kw; with "defaults", the spec's default scaling lists
    (Tables 7-3 / 7-4, raster order) and the default quant offsets."""
    kw = dict(kw)
    if kw.pop("defaults", False):
        from jm_tpu_torch.decoder import parset
        from jm_tpu_torch.encoder import qmatrix
        kw.update(
            scaling_lists4=tuple(tuple(qmatrix.from_zigzag4(
                parset.DEFAULT_4x4_INTRA if i < 3 else
                parset.DEFAULT_4x4_INTER)) for i in range(6)),
            scaling_lists8=tuple(tuple(qmatrix.from_zigzag8(lst)) for lst in (
                parset.DEFAULT_8x8_INTRA, parset.DEFAULT_8x8_INTER)),
            offset_matrix=tuple(tuple(map(tuple, m.tolist()))
                                for m in qmatrix.default_offsets()))
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         pipeline="host", **kw)


def high_report(enc, label: str) -> None:
    """wp_report's lines, then the IDR's host intra encode in ms per MB
    and the MBs coded with the 8x8 transform."""
    wp_report(enc, label)
    n_mbs = enc.mb_w * enc.mb_h
    idr = sum(enc.split[0]["picture"]) * 1e3
    t8 = sum(r["mix"]["t8"] for r in enc.results if "mix" in r)
    print(f"{label}: IDR host intra encode {idr:.1f} ms = "
          f"{idr / n_mbs:.3f} ms/MB; {t8} inter MBs coded with the 8x8 "
          f"transform", flush=True)


def high_1080p_phase(frames, cpu_ref, main_payloads, pool):
    """Phase 28: the first HIGH_FRAMES frames at 1080p, pipeline "host",
    the 8x8 transform, CAVLC, QP 28, SR 16, through encode_stream: one
    launch per kernel and picture, both CAVLC 8x8 slices serialized
    natively, the IDR's and the P's ms and split, the bytes beside phase
    3's first pictures (main_payloads; None when phase 3 did not run),
    held against the CPU encode cpu_ref; returns (encoder, payloads,
    launches, the CPU decode job of the stream)."""
    frames = frames[:HIGH_FRAMES]
    enc, payloads, launches, total_s = b_encode(high_cfg(), frames)
    types = "".join(r["type"] for r in enc.results)
    if types != "IP":
        raise AssertionError(f"High 1080p: pictures {types}")
    check_routes("High 1080p encode", serialize=2)
    check_launches(launches, 2, "High 1080p encode")
    t = {d: sum(enc.split[d]["picture"]) * 1e3 for d in (0, 1)}
    main = ("phase 3 did not run" if main_payloads is None else
            f"phase 3's device RD pipe: {len(main_payloads[0])} + "
            f"{len(main_payloads[1])} B")
    print(f"encode High 1080p {types} (pipeline host, transform8x8, "
          f"CAVLC High, QP {QP}, SR 16): IDR {t[0]:.1f} ms, P {t[1]:.1f} "
          f"ms, {len(payloads[0])} + {len(payloads[1])} B ({main}); "
          f"launches {launches}", flush=True)
    high_report(enc, "High 1080p")
    check_cpu_encode("High 1080p IDR + P", cpu_ref, payloads, enc, 2)
    return enc, payloads, launches, pool.apply_async(
        cpu_decode, (b"".join(payloads),))


def high_cif_phase(frames, cpu_refs, pool) -> list:
    """Phase 29: the CIF host-pipeline streams of HIGH_CIF, each through
    encode_stream on the card with one launch per kernel and picture,
    frames/s, the per-picture split, bytes, held against its CPU encode;
    returns per stream (label, encoder, payloads, launches, the CPU
    decode job of the stream)."""
    out = []
    for label, n, kw in HIGH_CIF:
        enc, payloads, launches, total_s = b_encode(high_cif_cfg(kw),
                                                    cif(frames, n))
        types = "".join(r["type"] for r in enc.results)
        n_b = types.count("B")
        cabac = kw.get("entropy") == "cabac"
        check_routes(f"High CIF ({label})",
                     serialize=0 if cabac else len(types),
                     b={"serialize": n_b})
        check_launches(launches, len(types), f"High CIF ({label})")
        print(f"encode High CIF ({label}) {types} (coding order; pipeline "
              f"host, {kw}): {n / total_s:.3f} frames/s, "
              f"{sum(map(len, payloads))} stream bytes "
              f"{[len(p) for p in payloads]}, profile "
              f"{enc.sps.profile_idc}, launches {launches}", flush=True)
        high_report(enc, f"High CIF ({label})")
        check_cpu_encode(f"High CIF ({label})", cpu_refs[f"high_cif_{label}"],
                         payloads, enc, len(types))
        out.append((f"high_cif_{label}", enc, payloads, launches,
                    pool.apply_async(cpu_decode, (b"".join(payloads),))))
    return out


def high_ops_timing() -> None:
    """CUDA-event times at 1080p of ops/dec.p_dec_residuals on the same
    seeded levels without and with every MB's 8x8 transform (the inter
    scaling lists flat), median of 7."""
    from jm_tpu_torch.common.types import PPS
    from jm_tpu_torch.convert import qpc_tables
    from jm_tpu_torch.decoder.recon import build_inv_scale, build_inv_scale8
    from jm_tpu_torch.ops.dec import p_dec_residuals
    rng = np.random.default_rng(7)
    n = (W // 16) * (H // 16)

    def t(a):
        return torch.as_tensor(a, device=DEVICE)

    def levels(shape):
        a = rng.integers(-20, 21, shape).astype(np.int32)
        return a * (rng.random(shape) < 0.2)

    pps = PPS(scaling_list_4x4=[[16] * 16] * 6,
              scaling_list_8x8=[[16] * 64] * 6)
    tab4 = build_inv_scale(pps)
    tabs = tuple(t(tab4[i]) for i in (3, 4, 5)) + qpc_tables(pps, DEVICE)
    args = (t(levels((n, 16, 16))), t(levels((n, 2, 4))),
            t(levels((n, 2, 4, 16))), t(np.full(n, QP, np.int32)))
    kw = dict(mb_w=W // 16, mb_h=H // 16)
    t8 = dict(luma_coef8=t(levels((n, 4, 64))),
              transform8x8=t(np.ones(n, bool)),
              tab8=t(build_inv_scale8(pps)[1]))
    ms4 = cuda_ms(lambda: p_dec_residuals(*args, *tabs, **kw))
    ms8 = cuda_ms(lambda: p_dec_residuals(*args, *tabs, **kw, **t8))
    print(f"High tensor stage at {W}x{H} (CUDA events, median of 7): "
          f"p_dec_residuals {ms4:.3f} ms without 8x8 MBs, {ms8:.3f} ms with "
          f"every MB's 8x8 transform", flush=True)


def high_decode_phase(streams) -> dict:
    """Phase 30: the streams of phases 28-29 decoded on the card, each
    equal to its encoder's recon and to its CPU decode, one launch per
    kernel and picture, every CAVLC I / P slice parsed and every intra
    picture reconstructed by the native runtime; JM's goldens high8x8,
    high8x8c and high8x8sm against their _rec.yuv with frames/s and the
    per-picture split; p_dec_residuals timed. streams: (label, encoder,
    payloads, CPU decode job). Returns the launches of each decode by
    name (<label>_decode, high_goldens_decode)."""
    out = {}
    for label, enc, payloads, job in streams:
        n_b = sum(r["type"] == "B" for r in enc.results)
        dec = H264Decoder(device=DEVICE)
        out[f"{label}_decode"] = card_decode(
            payloads, enc, f"decode {label}",
            cabac=enc.cfg.entropy == "cabac", dec=dec, b_parse=n_b)
        t0 = time.perf_counter()
        cpu = job.get()
        got = [(r["frame"].Y, r["frame"].U, r["frame"].V)
               for r in enc.results]
        if len(cpu) != len(got) or any(
                not np.array_equal(a[k], b[k]) for a, b in zip(cpu, got)
                for k in range(3)):
            raise AssertionError(f"decode {label}: the CPU decode differs")
        print(f"decode {label}: the CPU decode equals the card's (CPU "
              f"worker; waited {time.perf_counter() - t0:.1f} s)",
              flush=True)
    total = {}
    for name in HIGH_GOLDENS:
        dec = H264Decoder(device=DEVICE)
        kernels.reset_launches()
        native.reset_routes()
        t0 = time.perf_counter()
        got = decode_golden(name, dec)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gl = launch_counts()
        check_launches(gl, len(got), f"decode {name}")
        r = native.routes
        if r["parse"]["python"] or r["parse"]["rerun"] or \
                r["recon"]["python"] or not r["recon"]["native"]:
            raise AssertionError(f"decode {name}: routes {r}")
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        print(f"decode {name}.264 on the card "
              f"({''.join(p['type'][0] for p in dec.pictures)}): "
              f"{len(got)} frames equal {name}_rec.yuv; "
              f"{len(got) / dt:.3f} frames/s; per picture " + ", ".join(
                  f"{p['type'][0]}/{p['path']} parse "
                  f"{p['parse_s'] * 1e3:.1f}, intra recon "
                  f"{p['host_recon_s'] * 1e3:.1f}, device "
                  f"{p['device_s'] * 1e3:.1f} ms" for p in dec.pictures)
              + f"; launches {gl}; routes {r}", flush=True)
    out["high_goldens_decode"] = total
    high_ops_timing()
    return out


def high_phases(frames, cpu_refs, pool, main_payloads) -> dict:
    """Phases 28-30; returns the launches of each of their paths by name
    (high, high_cif_a..c, each also with _decode, high_goldens_decode)."""
    out = {}
    enc, payloads, out["high"], job = high_1080p_phase(
        frames, cpu_refs["high"], main_payloads, pool)
    streams = [("high", enc, payloads, job)]
    for label, cenc, cpay, launches, cjob in high_cif_phase(frames, cpu_refs,
                                                            pool):
        out[label] = launches
        streams.append((label, cenc, cpay, cjob))
    out.update(high_decode_phase(streams))
    return out


# ---- 31-33: the host coders' motion options, basic-unit RC ---------------

def motion_cfg():
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         num_ref=2, search_mode=3, hme=True)


def motion_cif_cfg(kw):
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         **kw)


def explicit_encode(enc, frames):
    """The explicit sequence script over frames by the encoder enc:
    (enc, payload of each coded picture, launches, seconds), the counters
    reset just before."""
    from jm_tpu_torch.encoder.gop import (encode_explicit_seq,
                                          parse_explicit_seq_file)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    payloads = encode_explicit_seq(enc, frames,
                                   parse_explicit_seq_file(EXPLICIT_SCRIPT))
    if enc.device.type == "cuda":
        torch.cuda.synchronize()
    return enc, payloads, launch_counts(), time.perf_counter() - t0


def cpu_explicit(cfg, frames):
    """Phase 32 (e)'s CPU reference, as cpu_encode's result."""
    enc, payloads, _l, _s = explicit_encode(Encoder(cfg, device="cpu"),
                                            frames)
    return (payloads, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], [r["qp"] for r in enc.results],
            enc.fallbacks)


def motion_report(enc, label: str) -> None:
    """wp_report's lines, then for each host-coded P picture the
    searcher's SAD evaluations per MB, the partitions (and sub-8x8
    quadrants) coded from reference 1, and with basic units the MB QPs
    and the MBs whose QP is not sent (jm_tpu's fault, copied)."""
    wp_report(enc, label)
    n_mbs = enc.mb_w * enc.mb_h
    for r in enc.results:
        if r["type"] != "P" or "mix" not in r:
            continue
        line = (f"{label} picture {r['disp']} P (host): "
                f"{r['evals'] / n_mbs:.1f} searcher SAD evaluations per MB; "
                f"{r['ref1']} partitions from reference 1")
        if "mb_qps" in r:
            line += (f"; basic units: MB QPs {list(r['mb_qps'])}, "
                     f"{r['qp_unsent']} MBs whose QP is not sent")
        print(line, flush=True)


def motion_1080p_phase(frames, cpu_ref, main_payloads, pool):
    """Phase 31: the first MOTION_FRAMES frames at 1080p, pipeline
    "device", num_ref 2, EPZS with HME, through encode_stream (off the
    pipe: encode_frame): the IDR and the first P on the device route (one
    active reference), the second P by the host P coder with two; one
    launch per kernel and picture; the host P's ms per MB by part, its
    SAD evaluations per MB and partitions from reference 1, its bytes
    beside phase 3's second P (main_payloads; None when phase 3 did not
    run); held against the CPU encode cpu_ref. Returns (encoder,
    payloads, launches, the CPU decode job of the stream)."""
    frames = frames[:MOTION_FRAMES]
    enc, payloads, launches, total_s = b_encode(motion_cfg(), frames)
    types = "".join(r["type"] for r in enc.results)
    host = ["mix" in r for r in enc.results]
    if types != "IPP" or host != [False, False, True]:
        raise AssertionError(f"motion 1080p: pictures {types}, host {host}")
    check_routes("motion 1080p encode", serialize=3)
    check_launches(launches, 3, "motion 1080p encode")
    t = {d: sum(enc.split[d]["picture"]) * 1e3 for d in range(3)}
    main = ("phase 3 did not run" if main_payloads is None else
            f"phase 3's second P: {len(main_payloads[2])} B")
    print(f"encode motion 1080p {types} (num_ref 2, EPZS + HME, device "
          f"pipeline, QP {QP}, SR 16): IDR {t[0]:.1f} ms, P (device route) "
          f"{t[1]:.1f} ms, P (host, 2 references) {t[2]:.1f} ms; bytes "
          f"{[len(p) for p in payloads]} ({main}); launches {launches}",
          flush=True)
    motion_report(enc, "motion 1080p")
    check_cpu_encode("motion 1080p", cpu_ref, payloads, enc, 3)
    return enc, payloads, launches, pool.apply_async(
        cpu_decode, (b"".join(payloads),))


def motion_cif_phase(frames, cpu_refs, pool) -> list:
    """Phase 32: the CIF streams of MOTION_CIF on the card (through
    encode_stream; (e) through the explicit sequence coder), one launch
    per kernel and picture, frames/s, the per-picture split (with (a)
    the 4x4 tables' build and download), the searchers' evaluations, the
    partitions from reference 1, (d)'s QPs and the MBs of the copied QP
    fault, held against its CPU encode; returns per stream (label,
    encoder, payloads, launches, the CPU decode job of the stream)."""
    out = []
    for label, n, kw in MOTION_CIF:
        cfg = motion_cif_cfg(kw)
        if label == "e":
            enc, payloads, launches, total_s = explicit_encode(
                BTimedEncoder(cfg, device=DEVICE), cif(frames, n))
        else:
            enc, payloads, launches, total_s = b_encode(cfg, cif(frames, n))
        types = "".join(r["type"] for r in enc.results)
        n_b = types.count("B")
        cabac = kw.get("entropy") == "cabac"
        check_routes(f"motion CIF ({label})",
                     serialize=0 if cabac else len(types) - n_b,
                     b={"serialize": n_b})
        check_launches(launches, len(types), f"motion CIF ({label})")
        print(f"encode motion CIF ({label}) {types} (coding order; {kw}): "
              f"{len(types) / total_s:.3f} frames/s, "
              f"{sum(map(len, payloads))} stream bytes "
              f"{[len(p) for p in payloads]}, QPs "
              f"{[r['qp'] for r in enc.results]}, launches {launches}",
              flush=True)
        if kw.get("sub8x8"):
            side = 2 * 16 + 1
            print(f"motion CIF ({label}): the 4x4 SAD tables (int16, "
                  f"{396 * side * side * 16 * 2 / 1e6:.1f} MB a reference) "
                  f"built and downloaded in " + ", ".join(
                      f"{r['split']['sad_s'] * 1e3:.1f} ms (picture "
                      f"{r['disp']}, {kw['num_ref']} references)"
                      for r in enc.results if "split" in r
                      and r["type"] == "P"), flush=True)
        motion_report(enc, f"motion CIF ({label})")
        check_cpu_encode(f"motion CIF ({label})",
                         cpu_refs[f"motion_cif_{label}"], payloads, enc,
                         len(types))
        out.append((f"motion_cif_{label}", enc, payloads, launches,
                    pool.apply_async(cpu_decode, (b"".join(payloads),))))
    return out


def fault_decode(payloads, enc, label: str, job):
    """Phase 33 (d): the basic-unit stream decoded on the card, equal to
    its CPU decode (the decoders give the QP a skipped MB inherits, where
    the encoder deblocked with its unit's), one launch per kernel and
    picture; prints the MBs that differ from the recon. Returns the
    launches."""
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    out = dec.decode_annexb(b"".join(payloads))
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches(launches, len(out), label)
    check_frames(out, job.get(), label)
    mw = enc.mb_w
    differ = []
    for f, r in zip(out, enc.results):
        d = np.abs(f.Y.astype(np.int32) - r["frame"].Y.astype(np.int32))
        for p in "UV":
            c = np.abs(getattr(f, p).astype(np.int32)
                       - getattr(r["frame"], p).astype(np.int32))
            d = np.maximum(d, np.kron(c, np.ones((2, 2), np.int32)))
        mbs = d.reshape(enc.mb_h, 16, mw, 16).max(axis=(1, 3))
        differ.append(int((mbs > 0).sum()))
    print(f"{label} on the card: {len(out)} frames equal the CPU decode; "
          f"MBs that differ from the recon per picture {differ} (jm_tpu's "
          f"basic-unit QP fault, copied); launches {launches}", flush=True)
    return launches


def motion_decode_phase(streams) -> dict:
    """Phase 33: the streams of phases 31-32 decoded on the card, each
    equal to its CPU decode and, but (d), to its encoder's recon, one
    launch per kernel and picture. streams: (label, encoder, payloads,
    CPU decode job). Returns the launches of each decode by name."""
    out = {}
    for label, enc, payloads, job in streams:
        if label == "motion_cif_d":
            out[f"{label}_decode"] = fault_decode(payloads, enc,
                                                  f"decode {label}", job)
            continue
        n_b = sum(r["type"] == "B" for r in enc.results)
        out[f"{label}_decode"] = card_decode(
            payloads, enc, f"decode {label}",
            cabac=enc.cfg.entropy == "cabac", b_parse=n_b)
        t0 = time.perf_counter()
        cpu = job.get()
        got = [(r["frame"].Y, r["frame"].U, r["frame"].V)
               for r in enc.results]
        if len(cpu) != len(got) or any(
                not np.array_equal(a[k], b[k]) for a, b in zip(cpu, got)
                for k in range(3)):
            raise AssertionError(f"decode {label}: the CPU decode differs")
        print(f"decode {label}: the CPU decode equals the card's (CPU "
              f"worker; waited {time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def motion_phases(frames, cpu_refs, pool, main_payloads) -> dict:
    """Phases 31-33; returns the launches of each of their paths by name
    (motion, motion_cif_a..e, each also with _decode)."""
    out = {}
    enc, payloads, out["motion"], job = motion_1080p_phase(
        frames, cpu_refs["motion"], main_payloads, pool)
    streams = [("motion", enc, payloads, job)]
    for label, cenc, cpay, launches, cjob in motion_cif_phase(
            frames, cpu_refs, pool):
        out[label] = launches
        streams.append((label, cenc, cpay, cjob))
    out.update(motion_decode_phase(streams))
    return out


def rdpd_cfg():
    """Phase 34: rd_cfg() with rd_picture_decision and the four trellis
    flags."""
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, rd_picture_decision=True,
                         **RDOQ_ALL)


def rd_qcif_cfg(qp: int, kw):
    """A RD_QCIF configuration: pipeline "host" at 176x144, SR 16."""
    return EncoderConfig(width=176, height=144, qp=qp, search_range=16,
                         pipeline="host", **kw)


def qcif_frames(frames, patch: bool):
    """The top-left 176x144 of the first RD_QCIF_FRAMES frames (the size
    of JM's foreman clip); with patch a new seeded uniform-noise 32x32
    luma patch (16x16 chroma) at (32, 32) in each frame, where I_PCM wins
    MBs at a low QP."""
    rng = np.random.default_rng(9)
    out = []
    for Y, U, V in frames[:RD_QCIF_FRAMES]:
        Y, U, V = Y[:144, :176].copy(), U[:72, :88].copy(), V[:72, :88].copy()
        if patch:
            Y[32:64, 32:64] = rng.integers(0, 256, (32, 32), np.uint8)
            U[16:32, 16:32] = rng.integers(0, 256, (16, 16), np.uint8)
            V[16:32, 16:32] = rng.integers(0, 256, (16, 16), np.uint8)
        out.append((Y, U, V))
    return out


def ipcm_mbs(r) -> int:
    """The I_PCM MBs of a coded picture's results record."""
    return r.get("mix", r.get("mb_classes", {})).get("ipcm", 0)


def codings(enc) -> int:
    """Every coding of the encoder's pictures: one each, three for a
    picture of rd_picture_decision (each deblocked and serialized)."""
    return sum(len(r.get("trials", (None,))) for r in enc.results)


def rd_report(enc, label: str) -> None:
    """wp_report's lines, then each picture's MB classes and I_PCM MBs
    (an I picture's ms per MB over the whole picture), the intra MBs a
    device-route P re-encoded on the host (trellis-coded in CAVLC with
    rdoq), and with rd_picture_decision each coding's QP, bytes, frame J
    and wall ms beside the QP shipped."""
    wp_report(enc, label)
    n_mbs = enc.mb_w * enc.mb_h
    for r in enc.results:
        d = r["disp"]
        classes = r.get("mix", r.get("mb_classes", "(device route)"))
        line = (f"{label} picture {d} {r['type']} QP {r['qp']}: MB classes "
                f"{classes}, {ipcm_mbs(r)} I_PCM MBs")
        if r["type"] == "I":
            t = sum(enc.split.get(d, {}).get("picture", [0.0])) * 1e3
            line += f", {t / n_mbs:.3f} ms/MB over the picture"
        if "intra_mbs" in r and "mix" not in r:
            line += f", {r['intra_mbs']} intra MBs re-encoded on the host"
        if "trials" in r:
            line += "; codings " + ", ".join(
                f"QP {t['qp']}: {t['bytes']} B, J {t['j']:.1f}, "
                f"{t['ms']:.1f} ms" for t in r["trials"]) + \
                f"; QP {r['qp']} shipped"
        print(line, flush=True)


def rdpd_1080p_phase(frames, cpu_ref, pool):
    """Phase 34: the first RD_FRAMES frames at 1080p on the device route
    (RD, CAVLC) with rd_picture_decision and the trellis flags, through
    encode_stream (off the pipe): the IDR once, each P picture coded on
    the device at QP, QP - 1 and QP + 1, each coding committed on the
    host (its intra MBs trellis-coded), deblocked by K1/K2 and
    serialized; the least frame J shipped. One launch per kernel and
    coding; each coding's QP, bytes, J and wall ms; held against the CPU
    encode cpu_ref. Returns (encoder, payloads, launches, the CPU decode
    job of the stream)."""
    frames = frames[:RD_FRAMES]
    enc, payloads, launches, total_s = b_encode(rdpd_cfg(), frames)
    types = "".join(r["type"] for r in enc.results)
    trials = [len(r.get("trials", ())) for r in enc.results]
    if types != "IPP" or trials != [0, 3, 3] or any(
            "mix" in r for r in enc.results):
        raise AssertionError(f"rdpd 1080p: pictures {types}, codings "
                             f"{trials}, host-coded P pictures")
    n = codings(enc)
    check_routes("rdpd 1080p encode", serialize=n)
    check_launches(launches, n, "rdpd 1080p encode")
    t = [sum(enc.split[d]["picture"]) * 1e3 for d in range(RD_FRAMES)]
    print(f"encode rdpd 1080p {types} (device route, RD, CAVLC, QP {QP}, "
          f"SR 16, rd_picture_decision, rdoq with rdoq_dc / rdoq_cr / "
          f"rdoq_dc_cr): IDR {t[0]:.1f} ms, P {t[1]:.1f} / {t[2]:.1f} ms "
          f"for three codings each; bytes {[len(p) for p in payloads]}; "
          f"QPs {[r['qp'] for r in enc.results]}; launches {launches} "
          f"({n} codings)", flush=True)
    rd_report(enc, "rdpd 1080p")
    check_cpu_encode("rdpd 1080p", cpu_ref, payloads, enc, RD_FRAMES)
    return enc, payloads, launches, pool.apply_async(
        cpu_decode, (b"".join(payloads),))


def rd_qcif_phase(frames, cpu_refs, pool) -> list:
    """Phase 35: the QCIF host RD streams of RD_QCIF through encode_stream
    (pipeline "host": every picture by the serial host coders), one
    launch per kernel and coding, CAVLC I / P slices with an I_PCM MB on
    the Python serializer, frames/s, each picture's split, MB classes,
    I_PCM MBs and codings, held against its CPU encode; returns per
    stream (label, encoder, payloads, launches, the CPU decode job)."""
    out = []
    for label, qp, kw, patch in RD_QCIF:
        enc, payloads, launches, total_s = b_encode(
            rd_qcif_cfg(qp, kw), qcif_frames(frames, patch))
        types = "".join(r["type"] for r in enc.results)
        n_b = types.count("B")
        n = codings(enc)
        cabac = kw.get("entropy") == "cabac"
        pcm = 0 if cabac else sum(ipcm_mbs(r) > 0 for r in enc.results
                                  if r["type"] != "B")
        check_routes(f"RD QCIF ({label})",
                     serialize=0 if cabac else n - n_b - pcm,
                     other={"serialize": {"python": pcm}},
                     b={"serialize": n_b})
        check_launches(launches, n, f"RD QCIF ({label})")
        if kw.get("enable_ipcm") and not any(map(ipcm_mbs, enc.results)):
            raise AssertionError(f"RD QCIF ({label}): no I_PCM MB")
        print(f"encode RD QCIF ({label}) {types} (coding order; pipeline "
              f"host, QP {qp}, {kw}{', noise patch' if patch else ''}): "
              f"{len(types) / total_s:.3f} frames/s, "
              f"{sum(map(len, payloads))} stream bytes "
              f"{[len(p) for p in payloads]}, QPs "
              f"{[r['qp'] for r in enc.results]}, launches {launches} ({n} "
              f"codings)", flush=True)
        rd_report(enc, f"RD QCIF ({label})")
        check_cpu_encode(f"RD QCIF ({label})", cpu_refs[f"rd_qcif_{label}"],
                         payloads, enc, len(types))
        out.append((f"rd_qcif_{label}", enc, payloads, launches,
                    pool.apply_async(cpu_decode, (b"".join(payloads),))))
    return out


def rd_decode_phase(streams) -> dict:
    """Phase 36: the streams of phases 34-35 decoded on the card, each
    equal to its encoder's recon and to its CPU decode, one launch per
    kernel and picture; the pictures with I_PCM MBs handed to the Python
    parser (CAVLC I / P) and intra recon. streams: (label, encoder,
    payloads, CPU decode job). Returns the launches of each decode by
    name."""
    out = {}
    for label, enc, payloads, job in streams:
        n_b = sum(r["type"] == "B" for r in enc.results)
        out[f"{label}_decode"] = card_decode(
            payloads, enc, f"decode {label}",
            cabac=enc.cfg.entropy == "cabac", b_parse=n_b,
            ipcm=[r["type"] for r in enc.results if ipcm_mbs(r)])
        t0 = time.perf_counter()
        cpu = job.get()
        got = [(r["frame"].Y, r["frame"].U, r["frame"].V)
               for r in enc.results]
        if len(cpu) != len(got) or any(
                not np.array_equal(a[k], b[k]) for a, b in zip(cpu, got)
                for k in range(3)):
            raise AssertionError(f"decode {label}: the CPU decode differs")
        print(f"decode {label}: the CPU decode equals the card's (CPU "
              f"worker; waited {time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def rd_phases(frames, cpu_refs, pool) -> dict:
    """Phases 34-36; returns the launches of each of their paths by name
    (rdpd, rd_qcif_a..e, each also with _decode)."""
    out = {}
    enc, payloads, out["rdpd"], job = rdpd_1080p_phase(
        frames, cpu_refs["rdpd"], pool)
    streams = [("rdpd", enc, payloads, job)]
    for label, cenc, cpay, launches, cjob in rd_qcif_phase(frames, cpu_refs,
                                                           pool):
        out[label] = launches
        streams.append((label, cenc, cpay, cjob))
    out.update(rd_decode_phase(streams))
    return out


# ---- 37-39: 4:2:2 chroma (High 4:2:2) --------------------------------------

def to_422(frames):
    """Frames with 4:2:2 chroma made from their luma: Cb and Cr the even
    and odd columns of every luma row, (H, W / 2) each."""
    return [(Y, Y[:, ::2].copy(), Y[:, 1::2].copy()) for Y, _, _ in frames]


def y422_cfg():
    """Phase 38's 1080p configuration: chroma_format 2 (every picture on
    the host coders, as in jm_tpu), CAVLC, QP 28, SR 16."""
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         chroma_format=2)


def y422_cif_cfg(kw):
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         chroma_format=2, **kw)


def k2_422_phase(rng) -> dict:
    """Phase 37: K2-422 (kernels.deblock_chroma at crows 4) against
    deblock_chroma_plain on the card, bit for bit, at 1080p 4:2:2 (chroma
    960x1088 a plane) with the three parameter variants, at 3840x2160, at
    the edge shapes and over REPEATS launches; CUDA-event times at 1080p
    (median of 7 runs of 20 calls) beside its bound, its all-bS-zero chain
    and the plain twin. Returns K2-422's statistics."""
    cases = [(W, H, v, 1) for v in ("mixed", "disable2", "plain")]
    cases += [(*UHD, "mixed", 1)] + [(w, h, v, 1) for w, h, v in EDGE_SHAPES]
    cases += [(W, H, "mixed", REPEATS)]
    max_err = 0
    for w, h, variant, repeats in cases:
        mb_w, mb_h = w // 16, h // 16
        case = deblock_case(rng, mb_w, mb_h, variant, crows=4)
        _, U, V, bs_v, bs_h, per_mb, cb, cr = case
        args = (bs_v, bs_h, *per_mb)
        (pu, pv), plain_ms = event_ms(lambda: deblock_chroma_plain(
            U, V, *args, cb, cr, mb_w=mb_w, mb_h=mb_h))
        u0, v0 = U.clone(), V.clone()
        err = 0
        for _ in range(repeats):
            ku, kv = kernels.deblock_chroma(U, V, *args, cb, cr, mb_w=mb_w,
                                            mb_h=mb_h, crows=4)
            err = max(err, int((ku.int() - pu.int()).abs().max()),
                      int((kv.int() - pv.int()).abs().max()))
        torch.cuda.synchronize()
        if not (torch.equal(U, u0) and torch.equal(V, v0)):
            raise AssertionError(f"K2-422 {w}x{h} {variant}: input modified")
        changed = int((pu != U).sum()) + int((pv != V).sum())
        print(f"deblock 4:2:2 {w}x{h} {variant} x{repeats}: K2-422 max|err| "
              f"{err}, chroma samples changed {changed}", flush=True)
        if err:
            raise AssertionError(f"K2-422 differs from the plain version "
                                 f"({w}x{h} {variant})")
        if h >= H and changed == 0:
            raise AssertionError(f"K2-422 {w}x{h} {variant}: unfiltered")
        max_err = max(max_err, err)
    mb_w, mb_h = W // 16, H // 16
    _, U, V, bs_v, bs_h, per_mb, cb, cr = case
    args = (bs_v, bs_h, *per_mb)
    zbs = torch.zeros_like(bs_v)
    lines = filtered_lines(bs_v, bs_h, per_mb, mb_w, mb_h, crows=4)[1]
    b = 2 * (U.numel() + V.numel()) + 6 * 4 * mb_w * mb_h \
        + 2 * bs_v.numel() + 2 * 52 * 4
    ops = CHROMA_LINE_OPS * lines
    t_bytes = b / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    kw = dict(mb_w=mb_w, mb_h=mb_h)
    s = {"ms": cuda_ms(lambda: kernels.deblock_chroma(
             U, V, *args, cb, cr, crows=4, **kw), inner=20),
         "chain_ms": cuda_ms(lambda: kernels.deblock_chroma(
             U, V, zbs, zbs, *per_mb, cb, cr, crows=4, **kw), inner=20),
         "single_ms": cuda_ms(lambda: kernels.deblock_chroma(
             U, V, *args, cb, cr, crows=4, **kw)),
         "plain_ms": plain_ms,         # the last (1080p) case's check
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bytes": b, "ops": ops, "max_err": max_err}
    print(f"deblock_chroma422 (K2-422) at {W}x{H} 4:2:2: {s['ms']:.4f} ms "
          f"(one call alone: {s['single_ms']:.4f} ms; all bS 0: "
          f"{s['chain_ms']:.4f} ms; plain {s['plain_ms']:.1f} ms), bound "
          f"{s['bound_ms'] * 1e3:.2f} us ({s['bound_by']}: {b} B, {ops} int "
          f"ops), 1 launch/picture", flush=True)
    return s


class Y422Encoder(BTimedEncoder):
    """BTimedEncoder keeping the arguments and the output of each call of
    the encoder's deblock (the pre-deblock planes and parameters)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.deblocks = []

    def _deblock(self, rec, pic):
        import jm_tpu_torch.encoder.encoder as EM
        orig = EM.deblock

        def spy(*a, **k):
            out = orig(*a, **k)
            self.deblocks.append((a, k, out))
            return out

        EM.deblock = spy
        try:
            return super()._deblock(rec, pic)
        finally:
            EM.deblock = orig


def y422_1080p_phase(frames, cpu_ref, pool):
    """Phase 38a: the first frame at 1080p 4:2:2, CAVLC, an IDR through
    encode_stream on the host route (IntraPicture): one launch each of K1
    and K2-422; its ms, ms per MB and bytes; its deblock (the kernels) held
    against deblock_plain on the card on the same pre-deblock planes and
    parameters; held against the CPU encode cpu_ref. Returns (encoder,
    payloads, launches, the CPU decode job of the stream)."""
    t0 = time.perf_counter()
    enc = Y422Encoder(y422_cfg(), device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    payloads = enc.encode_stream(to_422(frames[:1]))
    torch.cuda.synchronize()
    launches = launch_counts(True)
    if [r["type"] for r in enc.results] != ["I"] or len(enc.deblocks) != 1:
        raise AssertionError("4:2:2 1080p: not one deblocked IDR")
    check_routes("4:2:2 1080p encode", serialize=1)
    check_launches(launches, 1, "4:2:2 1080p encode")
    a, k, out = enc.deblocks[0]
    t1 = time.perf_counter()
    plain = deblock_plain(*a, **k)
    for p, q, name in zip(plain, out, "YUV"):
        if p.shape != q.shape or not torch.equal(p, q):
            raise AssertionError(f"4:2:2 1080p: deblock {name} differs from "
                                 f"the plain twins")
    plain_s = time.perf_counter() - t1
    n_mbs = enc.mb_w * enc.mb_h
    t = sum(enc.split[0]["picture"]) * 1e3
    print(f"encode 4:2:2 1080p IDR (host route: IntraPicture; CAVLC High "
          f"4:2:2, profile {enc.sps.profile_idc}, QP {QP}): {t:.1f} ms = "
          f"{t / n_mbs:.3f} ms/MB, {len(payloads[0])} B, MB classes "
          f"{enc.results[0]['mb_classes']}; launches {launches}; its "
          f"deblock equals deblock_plain's on the same pre-deblock planes "
          f"(plain twins {plain_s:.1f} s); phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check_cpu_encode("4:2:2 1080p IDR", cpu_ref, payloads, enc, 1)
    return enc, payloads, launches, pool.apply_async(
        cpu_decode, (b"".join(payloads),))


def y422_cif_phase(frames, cpu_refs, pool) -> list:
    """Phase 38b: the CIF 4:2:2 streams of Y422_CIF through encode_stream,
    each picture on the host coders, one launch each of K1 and K2-422 per
    picture, frames/s, the per-picture split and bytes, held against its
    CPU encode; returns per stream (label, encoder, payloads, launches,
    the CPU decode job of the stream)."""
    out = []
    for label, n, kw in Y422_CIF:
        enc, payloads, launches, total_s = b_encode(
            y422_cif_cfg(kw), to_422(cif(frames, n)))
        types = "".join(r["type"] for r in enc.results)
        n_b = types.count("B")
        cabac = kw.get("entropy") == "cabac"
        check_routes(f"4:2:2 CIF ({label})",
                     serialize=0 if cabac else len(types),
                     b={"serialize": n_b})
        check_launches(launches, len(types), f"4:2:2 CIF ({label})")
        print(f"encode 4:2:2 CIF ({label}) {types} (coding order; {kw}): "
              f"{n / total_s:.3f} frames/s, {sum(map(len, payloads))} "
              f"stream bytes {[len(p) for p in payloads]}, profile "
              f"{enc.sps.profile_idc}, launches {launches}", flush=True)
        high_report(enc, f"4:2:2 CIF ({label})")
        check_cpu_encode(f"4:2:2 CIF ({label})", cpu_refs[f"y422_cif_{label}"],
                         payloads, enc, len(types))
        out.append((f"y422_cif_{label}", enc, payloads, launches,
                    pool.apply_async(cpu_decode, (b"".join(payloads),))))
    return out


def y422_decode_phase(streams) -> dict:
    """Phase 39: the streams of phase 38 decoded on the card, each equal
    to its encoder's recon and to its CPU decode, one launch each of K1
    and K2-422 per picture, the CAVLC I / P slices on the Python parser
    (route "yuv422"); JM's goldens y422 and y422c against their _rec.yuv
    and cif_422 against the sha256 of ldecod's output, with frames/s and
    the per-picture parse / host recon / device split. streams: (label,
    encoder, payloads, CPU decode job). Returns the launches of each
    decode by name (<label>_decode, y422_goldens_decode)."""
    import hashlib
    out = {}
    for label, enc, payloads, job in streams:
        n_b = sum(r["type"] == "B" for r in enc.results)
        out[f"{label}_decode"] = card_decode(
            payloads, enc, f"decode {label}",
            cabac=enc.cfg.entropy == "cabac", b_parse=n_b)
        t0 = time.perf_counter()
        cpu = job.get()
        got = [(r["frame"].Y, r["frame"].U, r["frame"].V)
               for r in enc.results]
        if len(cpu) != len(got) or any(
                not np.array_equal(a[k], b[k]) for a, b in zip(cpu, got)
                for k in range(3)):
            raise AssertionError(f"decode {label}: the CPU decode differs")
        print(f"decode {label}: the CPU decode equals the card's (CPU "
              f"worker; waited {time.perf_counter() - t0:.1f} s)",
              flush=True)
    total = {}
    for name in Y422_GOLDENS + ("cif_422",):
        dec = H264Decoder(device=DEVICE)
        kernels.reset_launches()
        native.reset_routes()
        t0 = time.perf_counter()
        if name == "cif_422":
            got = dec.decode_annexb(golden_bytes(name))
            frames = sorted(got, key=lambda f: f.poc)
            sha = hashlib.sha256(b"".join(
                f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
                for f in frames)).hexdigest()
            if len(got) != 30 or sha != CIF_422_SHA256:
                raise AssertionError(f"decode cif_422: {len(got)} frames, "
                                     f"sha256 {sha}")
            what = "whose sha256 equals ldecod's output's"
        else:
            got = decode_golden(name, dec)
            what = f"equal {name}_rec.yuv"
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gl = launch_counts(True)
        check_launches(gl, len(got), f"decode {name}")
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        print(f"decode {name}.264 on the card "
              f"({''.join(p['type'][0] for p in dec.pictures)}): "
              f"{len(got)} frames {what}; {len(got) / dt:.3f} frames/s; "
              f"per picture " + ", ".join(
                  f"{p['type'][0]}/{p['path']} parse "
                  f"{p['parse_s'] * 1e3:.1f}, intra recon "
                  f"{p['host_recon_s'] * 1e3:.1f}, device "
                  f"{p['device_s'] * 1e3:.1f} ms" for p in dec.pictures)
              + f"; launches {gl}; routes {native.routes}", flush=True)
    out["y422_goldens_decode"] = total
    return out


def y422_phases(frames, cpu_refs, pool, rng) -> tuple:
    """Phases 37-39; returns (K2-422's statistics, the launches of each of
    the 4:2:2 paths by name: y422, y422_cif_a / b, each also with
    _decode, y422_goldens_decode; the payloads of CIF stream (a))."""
    stats = k2_422_phase(rng)
    out = {}
    enc, payloads, out["y422"], job = y422_1080p_phase(
        frames, cpu_refs["y422"], pool)
    streams = [("y422", enc, payloads, job)]
    for label, cenc, cpay, launches, cjob in y422_cif_phase(frames, cpu_refs,
                                                            pool):
        out[label] = launches
        streams.append((label, cenc, cpay, cjob))
    out.update(y422_decode_phase(streams))
    return stats, out, streams[1][2]


# ---------------------------------------------------------------------------
# phases 40-42: High 10 and lossless decoding, the >8-bit deblock kernels
# ---------------------------------------------------------------------------

HBD_DEPTHS = (10, 14)     # the bit depths of phase 40's kernel checks
HBD_FRAMES = 3            # IDR + 2 P of the re-headed phase-3 stream (41)
HBD_GOLDENS = ("hi10c", "hi10")      # JM's High 10 goldens (phase 41)
# sha256 of the lossless goldens' decode (Y, U, V of each frame in POC
# order, uint8), which tests/test_torch_lossless_decode.py holds against
# jm_tpu's decode (phase 42; both goldens code the same source frames)
LOSSLESS_SHA256 = {
    "lossless": ("b721aed52a9ba57916b9d22a1e84faca4d706ae69513e98a033e1f3e"
                 "5a288479"),
    "lossless_cabac": ("b721aed52a9ba57916b9d22a1e84faca4d706ae69513e98a03"
                       "3e1f3e5a288479")}
HBD_KEYS = {2: ("deblock_luma16", "deblock_chroma16"),
            4: ("deblock_luma16", "deblock_chroma422_16")}


def reheaded(data: bytes, profile: int, bit_depth: int = 8,
             bypass: int = 0) -> bytes:
    """The stream with each SPS written again by the port's write_sps, at
    profile 100 (122 at 4:2:2) with bit_depth_luma / chroma_minus8 =
    bit_depth - 8 and qpprime_y_zero_transform_bypass_flag = bypass, and
    its profile_idc byte set to ``profile`` (110 High 10, 244 High 4:4:4
    Predictive: their SPS layout at 4:2:0 is High's). The PPS and slices
    stay as they are: a valid stream whose pictures the spec fixes."""
    from jm_tpu_torch.bitstream.nal import (NalUnitType, annexb_bytes,
                                            split_annexb)
    from jm_tpu_torch.decoder.parset import parse_sps
    from jm_tpu_torch.encoder.syntax import write_sps
    out = []
    for nal in split_annexb(data):
        rbsp = nal.rbsp
        if nal.nal_unit_type == NalUnitType.SPS:
            sps = parse_sps(rbsp)
            sps.profile_idc = 122 if sps.chroma_format_idc == 2 else 100
            sps.bit_depth_luma_minus8 = bit_depth - 8
            sps.bit_depth_chroma_minus8 = bit_depth - 8
            sps.qpprime_y_zero_transform_bypass_flag = bypass
            rbsp = bytes([profile]) + write_sps(sps)[1:]
        out.append(annexb_bytes(nal.nal_ref_idc, nal.nal_unit_type, rbsp))
    return b"".join(out)


def hbd_launch_counts(crows: int = 2) -> dict:
    """The kernel launches since the last reset on a >8-bit path: K1-HBD's
    and those of the >8-bit chroma kernel of the format; no other kernel
    may have been launched."""
    keys = HBD_KEYS[crows]
    out = dict(kernels.launches)
    extra = {k: v for k, v in out.items() if k not in keys and v}
    if extra:
        raise AssertionError(f"kernels {extra} launched on a >8-bit "
                             f"{'4:2:2' if crows == 4 else '4:2:0'} path")
    return {k: out[k] for k in keys}


def hbd_case(rng, mb_w: int, mb_h: int, variant: str, bd: int,
             crows: int = 2):
    """deblock_case at bit depth bd: int16 planes of samples 0 ..
    (1 << bd) - 1 (the top three quarters low-amplitude, as deblock_case's
    scaled by 1 << (bd - 8) plus noise in the low bits), per-MB QPY drawn
    from -QpBdOffsetY .. 51, chroma offsets -2 / 3, the QPc tables from
    QPY -QpBdOffsetY (convert.qpc_tables' layout)."""
    Y, U, V, bs_v, bs_h, per_mb, _, _ = deblock_case(rng, mb_w, mb_h,
                                                     variant, crows)
    s = bd - 8
    off = 6 * s
    planes = []
    for P in (Y, U, V):
        p = P.cpu().numpy().astype(np.int32)
        hi = rng.integers(0, 1 << s, p.shape) if s else 0
        planes.append(torch.as_tensor(((p << s) | hi).astype(np.int16),
                                      device=DEVICE))
    n = mb_w * mb_h
    qp = torch.as_tensor(rng.integers(-off, 52, n).astype(np.int32),
                         device=DEVICE)
    cb, cr = (torch.as_tensor(np.array([chroma_qp(q, o, bd)
                                        for q in range(-off, 52)],
                                       np.int32), device=DEVICE)
              for o in (-2, 3))
    return (*planes, bs_v, bs_h, (qp,) + per_mb[1:], cb, cr)


def event_ms(fn):
    """fn() once, timed by CUDA events: (its result, ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def hbd_kernel_phase(rng) -> dict:
    """Phase 40: K1-HBD, K2-HBD and K2-422-HBD (kernels.deblock_luma /
    deblock_chroma on int16 planes) against the plain twins on the card,
    bit for bit: at 1080p with the three parameter variants at 10 bits
    (the mixed one over REPEATS launches) and the mixed one at 14 bits,
    and at the edge shapes of phases 2 and 37 at 10 and 14 bits; per-MB
    QPY from -QpBdOffsetY to 51. At 1080p 10 bits, mixed parameters:
    CUDA-event times (median of 7 runs of 20 calls), the all-bS-zero
    chain, the plain twin (the checking call, timed by events) and the
    bound. Returns each variant's statistics by launch key."""
    cases = [(W, H, "mixed", 10, REPEATS), (W, H, "disable2", 10, 1),
             (W, H, "plain", 10, 1), (W, H, "mixed", 14, 1)]
    cases += [(w, h, v, bd, 1) for bd in HBD_DEPTHS
              for w, h, v in EDGE_SHAPES]
    stats = {k: {"max_err": 0} for k in
             ("deblock_luma16", "deblock_chroma16", "deblock_chroma422_16")}
    for w, h, variant, bd, repeats in cases:
        mb_w, mb_h = w // 16, h // 16
        kw = dict(mb_w=mb_w, mb_h=mb_h)
        timed = (w, h, variant, bd) == (W, H, "mixed", 10)
        for crows in (2, 4):
            Y, U, V, bs_v, bs_h, per_mb, cb, cr = hbd_case(
                rng, mb_w, mb_h, variant, bd, crows)
            args = (bs_v, bs_h, *per_mb)
            kl, kc = HBD_KEYS[crows]
            plain = [(kc, lambda: deblock_chroma_plain(
                U, V, *args, cb, cr, bd=bd, **kw),
                lambda: kernels.deblock_chroma(
                    U, V, *args, cb, cr, crows=crows, bd=bd, **kw))]
            if crows == 2:
                plain.insert(0, (kl, lambda: (deblock_luma_plain(
                    Y, *args, bd=bd, **kw),), lambda: (kernels.deblock_luma(
                        Y, *args, bd=bd, **kw),)))
            ins = [p.clone() for p in (Y, U, V)]
            for key, pfn, kfn in plain:
                want, p_ms = event_ms(pfn)
                err = 0
                for _ in range(repeats):
                    got = kfn()
                    err = max(err, *(int((g.int() - p.int()).abs().max())
                                     for g, p in zip(got, want)))
                torch.cuda.synchronize()
                changed = sum(int((p != q).sum()) for p, q in
                              zip(want, (Y,) if key == kl else (U, V)))
                print(f"deblock {bd}-bit {w}x{h} "
                      f"{'4:2:2' if crows == 4 else '4:2:0'} {variant} "
                      f"x{repeats}: {key} max|err| {err}, samples changed "
                      f"{changed}", flush=True)
                if err:
                    raise AssertionError(f"{key} differs from the plain "
                                         f"twin ({w}x{h} {variant} {bd}-bit)")
                if h >= H and changed == 0:
                    raise AssertionError(f"{key} {w}x{h} {variant}: "
                                         f"unfiltered")
                stats[key]["max_err"] = max(stats[key]["max_err"], err)
                if timed:
                    stats[key]["plain_ms"] = p_ms
            if not all(torch.equal(a, b) for a, b in zip(ins, (Y, U, V))):
                raise AssertionError(f"{bd}-bit {w}x{h}: input modified")
            if timed:
                hbd_times(stats, (Y, U, V), args, (cb, cr), crows, kw)
    for key, s in stats.items():
        print(f"{key} at {W}x{H} 10 bits: {s['ms']:.4f} ms (one call "
              f"alone: {s['single_ms']:.4f} ms; all bS 0: "
              f"{s['chain_ms']:.4f} ms; plain {s['plain_ms']:.1f} ms), bound "
              f"{s['bound_ms'] * 1e3:.2f} us ({s['bound_by']}: {s['bytes']} "
              f"B, {s['ops']} int ops), 1 launch/picture", flush=True)
    return stats


def hbd_times(stats, planes, args, tabs, crows: int, kw) -> None:
    """Times of the >8-bit kernels of one format on the 1080p mixed case
    into stats: CUDA events, the all-bS-zero chain, the bound (2 bytes a
    sample read and written once, the bS and per-MB parameters and the
    QPc tables; integer ops of the filtered lines)."""
    Y, U, V = planes
    bs_v, bs_h, *per_mb = args
    z = torch.zeros_like(bs_v)
    mb_w, mb_h = kw["mb_w"], kw["mb_h"]
    lines_y, lines_c = filtered_lines(bs_v, bs_h, per_mb, mb_w, mb_h, crows)
    param_bytes = 6 * 4 * mb_w * mb_h + 2 * bs_v.numel()
    kl, kc = HBD_KEYS[crows]
    fns = [(kc, 2 * 2 * (U.numel() + V.numel()) + param_bytes
            + 2 * 4 * tabs[0].numel(), CHROMA_LINE_OPS * lines_c,
            lambda b: kernels.deblock_chroma(U, V, *b, *per_mb, *tabs,
                                             crows=crows, bd=10, **kw))]
    if crows == 2:
        fns.insert(0, (kl, 2 * 2 * Y.numel() + param_bytes,
                       LUMA_LINE_OPS * lines_y,
                       lambda b: kernels.deblock_luma(Y, *b, *per_mb,
                                                      bd=10, **kw)))
    for key, nbytes, ops, fn in fns:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        stats[key].update(
            ms=cuda_ms(lambda: fn((bs_v, bs_h)), inner=20),
            chain_ms=cuda_ms(lambda: fn((z, z)), inner=20),
            single_ms=cuda_ms(lambda: fn((bs_v, bs_h))),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, ops=ops)


def hbd_decode_phase(payloads, y422_payloads, jobs) -> dict:
    """Phase 41: the first HBD_FRAMES pictures of phase 3's stream with a
    High 10 SPS (reheaded: 10-bit luma and chroma, other pictures than
    the 8-bit decode) decoded on the card, with the launch and route
    counters reset just before: each >8-bit kernel once per picture, no
    8-bit kernel, every slice parsed by the native parser, the intra
    recon on the Python walk (the native one is 8-bit); every frame equal
    to the CPU decode of the same stream (jobs["hbd_1080p"], a worker's);
    frames/s and each picture's parse / host intra recon / device split.
    Then phase 38's CIF 4:2:2 stream (a) under a 10-bit profile-122 SPS
    (K1-HBD and K2-422-HBD once per picture, equal to jobs["hbd_422"]),
    and JM's High 10 goldens on the card against their _rec.yuv. Returns
    the launches by path (hbd_1080p_decode, hbd_422_decode,
    hbd_goldens_decode)."""
    out = {"hbd_1080p_decode": hbd_stream_decode(
        reheaded(b"".join(payloads[:HBD_FRAMES]), 110, 10),
        jobs["hbd_1080p"], "High 10 1080p", 2),
        "hbd_422_decode": hbd_stream_decode(
        reheaded(b"".join(y422_payloads), 122, 10), jobs["hbd_422"],
        "10-bit 4:2:2 CIF", 4)}
    total = {}
    for name in HBD_GOLDENS:
        kernels.reset_launches()
        dec = H264Decoder(device=DEVICE)
        t0 = time.perf_counter()
        got = decode_golden(name, dec)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gl = hbd_launch_counts()
        check_launches(gl, len(got), f"decode {name}")
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        print(f"decode {name}.264 (High 10, "
              f"{''.join(p['type'][0] for p in dec.pictures)}): "
              f"{len(got) / dt:.3f} frames/s; launches {gl}", flush=True)
    out["hbd_goldens_decode"] = total
    return out


def hbd_stream_decode(data: bytes, cpu_job, label: str, crows: int) -> dict:
    """One >8-bit stream decoded on the card (phase 41), checked and
    reported; returns its launches."""
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(data)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = hbd_launch_counts(crows)
    check_launches(launches, len(out), f"{label} decode")
    recon = sum(p["path"] != "inter" for p in dec.pictures)
    # the CAVLC slices: the native parser at 4:2:0, the Python one at
    # 4:2:2 (route "yuv422", as for 8 bits)
    check_routes(f"{label} decode", parse=len(out) if crows == 2 else 0,
                 other={"recon": {"python": recon},
                        "yuv422": {"parse": 0 if crows == 2 else len(out)}})
    if out[0].Y.dtype != np.uint16 or int(out[0].Y.max()) < 256:
        raise AssertionError(f"{label} decode: not 10-bit planes")
    print(f"decode {label} ({len(data)} B) on the card: {len(out)} "
          f"frames, {len(out) / total_s:.3f} frames/s; per picture "
          + ", ".join(
              f"{p['type'][0]}/{p['path']} {p['seconds'] * 1e3:.1f} ms "
              f"(parse {p['parse_s'] * 1e3:.1f}, intra recon "
              f"{p['host_recon_s'] * 1e3:.1f}, device "
              f"{p['device_s'] * 1e3:.1f})" for p in dec.pictures)
          + f"; launches {launches}", flush=True)
    t1 = time.perf_counter()
    check_frames(out, cpu_job.get(), f"{label} decode against the CPU")
    print(f"decode {label}: every frame equals the CPU decode (CPU "
          f"worker; waited {time.perf_counter() - t1:.1f} s)", flush=True)
    return launches


def lossless_phase() -> dict:
    """Phase 42: JM's lossless goldens (profile 244, every MB at QP 0:
    transform bypass, intra DPCM; CAVLC and CABAC I P P) decoded on the
    card: the sha256 of the frames equals the one tier-1 holds against
    jm_tpu's decode, one launch of K1 and K2 per picture. Returns the
    launches (lossless_goldens_decode)."""
    import hashlib
    total = {}
    for name, want in LOSSLESS_SHA256.items():
        dec = H264Decoder(device=DEVICE)
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = sorted(dec.decode_annexb(golden_bytes(name)),
                     key=lambda f: f.poc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sha = hashlib.sha256(b"".join(
            f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
            for f in got)).hexdigest()
        if sha != want:
            raise AssertionError(f"decode {name}: sha256 {sha}")
        gl = launch_counts()
        check_launches(gl, len(got), f"decode {name}")
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        print(f"decode {name}.264 on the card "
              f"({''.join(p['type'][0] for p in dec.pictures)}, "
              f"{'/'.join(p['path'] for p in dec.pictures)}): {len(got)} "
              f"frames whose sha256 equals jm_tpu's decode's; "
              f"{len(got) / dt:.3f} frames/s; launches {gl}", flush=True)
    return {"lossless_goldens_decode": total}


def hbd_phases(payloads, y422_payloads, jobs, rng) -> tuple:
    """Phases 40-42 (payloads: phase 3's, y422_payloads: phase 38's CIF
    (a); jobs: their CPU decodes, hbd_cpu_jobs); returns (the >8-bit
    kernels' statistics by launch key, the launches of phases 41-42's
    paths by name)."""
    stats = hbd_kernel_phase(rng)
    out = hbd_decode_phase(payloads, y422_payloads, jobs)
    out.update(lossless_phase())
    return stats, out


# ---------------------------------------------------------------------------
# phases 43-45: PAFF field pictures
# ---------------------------------------------------------------------------

# the field shapes of phase 43: a 1080p field (120x34 MBs) and a CIF field
# (22x9 MBs)
FIELD_SHAPES = ((1920, 544), (352, 144))
FIELD_CIF_FRAMES = 3      # frames of phase 44's CIF field stream
FIELD_GOLDENS = ("field1", "field2", "fieldcab")   # JM's goldens (45)
# sha256 of JM ldecod's output of tests/golden/cif_field.264 (60 CIF field
# pictures; tests/test_cif_conformance.py records it)
CIF_FIELD_SHA256 = ("2e476073972f719518765fd4a58b4a46c01335472864d9da"
                    "58bbb8332462fa10")


def field_cfg():
    """Phase 44's 1080p configuration: pic_interlace 1 (every frame two
    field pictures, each coded by the host coders, as in jm_tpu), CAVLC,
    QP 28, SR 16."""
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         pic_interlace=1)


def field_cif_cfg():
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         pic_interlace=1, num_ref=2)


def woven(results):
    """The (Y, U, V) frames woven from an encoder's field results (top,
    bottom, top, ...)."""
    out = []
    for top, bot in zip(results[0::2], results[1::2]):
        planes = []
        for p in "YUV":
            t, b = getattr(top["frame"], p), getattr(bot["frame"], p)
            w = np.empty((2 * t.shape[0], t.shape[1]), t.dtype)
            w[0::2], w[1::2] = t, b
            planes.append(w)
        out.append(tuple(planes))
    return out


def cpu_field(cfg, frames):
    """Phase 44's CPU reference: the frames encoded as field pairs on the
    CPU through encode_frame, then that stream decoded on the CPU:
    (payloads, each field's recon (Y, U, V), the decoded frames)."""
    enc = Encoder(cfg, device="cpu")
    payloads = [enc.encode_frame(*f) for f in frames]
    return (payloads, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], cpu_decode(b"".join(payloads)))


def field_bs(rng, mb_w: int, mb_h: int):
    """Field boundary strengths of a random field picture on the card
    (ops/deblock.compute_bs(field=True)): a fifth of the MBs intra, MVs
    within 3 quarter samples of each other (the field's vertical limit
    of 2 acts), four reference ids, sparse coefficients. Returns (bs_v,
    bs_h) and the frame rules' bS of the same picture."""
    from jm_tpu_torch.ops.deblock import compute_bs
    n = mb_w * mb_h
    intra = rng.random(n) < 0.2
    nnz = rng.integers(0, 3, (n, 16)) * (rng.random((n, 16)) < 0.3)
    mv = rng.integers(-3, 4, (n, 16, 2))
    mv[intra] = 0
    rid = rng.integers(0, 4, (n, 4))
    rid[intra] = -1
    t = lambda a: torch.as_tensor(np.asarray(a), device=DEVICE)  # noqa: E731
    args = (t(intra.astype(np.int8)), t(nnz.astype(np.int32)),
            t(np.zeros(n, np.int32)), t(mv.astype(np.int32)),
            t(np.zeros((n, 16, 2), np.int32)), t(rid.astype(np.int64)),
            t(np.full((n, 4), -1, np.int64)), mb_w, mb_h)
    return compute_bs(*args, field=True), compute_bs(*args)


def field_kernel_phase(rng) -> dict:
    """Phase 43: K1 and K2 at the field shapes (1920x544, 352x144) with
    field bS (bS 3 on the horizontal MB edges next to intra MBs, the
    vertical MV limit 2) and the mixed per-MB parameters, against their
    plain twins on the card, bit for bit, over REPEATS launches at the
    1080p field; CUDA-event times (median of 7 runs of 20 calls) beside
    the bound, the all-bS-zero chain and the plain twins' checking call.
    Returns the statistics by shape and kernel."""
    stats = {}
    for w, h in FIELD_SHAPES:
        mb_w, mb_h = w // 16, h // 16
        Y, U, V, _, _, per_mb, cb, cr = deblock_case(rng, mb_w, mb_h,
                                                     "mixed")
        (bs_v, bs_h), (fv, fh) = field_bs(rng, mb_w, mb_h)
        mb_rows = bs_h[4::4].cpu().numpy()
        if not ((mb_rows == 3).any() and not (mb_rows == 4).any()
                and bool((fh[4::4] == 4).any())
                and not torch.equal(bs_v, fv)):
            raise AssertionError(f"field bS {w}x{h}: the field rules do "
                                 f"not show")
        args = (bs_v, bs_h, *per_mb)
        kw = dict(mb_w=mb_w, mb_h=mb_h)
        py, ms_y = event_ms(lambda: deblock_luma_plain(Y, *args, **kw))
        (pu, pv), ms_c = event_ms(lambda: deblock_chroma_plain(
            U, V, *args, cb, cr, **kw))
        repeats = REPEATS if h > 200 else 1
        err_y = err_c = 0
        for _ in range(repeats):
            ky = kernels.deblock_luma(Y, *args, **kw)
            ku, kv = kernels.deblock_chroma(U, V, *args, cb, cr, **kw)
            err_y = max(err_y, int((ky.int() - py.int()).abs().max()))
            err_c = max(err_c, int((ku.int() - pu.int()).abs().max()),
                        int((kv.int() - pv.int()).abs().max()))
        torch.cuda.synchronize()
        changed = (int((py != Y).sum()),
                   int((pu != U).sum()) + int((pv != V).sum()))
        print(f"deblock field {w}x{h} x{repeats}: luma max|err| {err_y}, "
              f"chroma max|err| {err_c}, samples changed (luma, chroma) "
              f"{changed}, bS 3 / 4 on horizontal MB edges "
              f"{int((mb_rows == 3).sum())} / {int((mb_rows == 4).sum())}",
              flush=True)
        if err_y or err_c or min(changed) == 0:
            raise AssertionError(f"deblock field {w}x{h}: the kernels "
                                 f"differ from the plain twins, or filter "
                                 f"nothing")
        lines_y, lines_c = filtered_lines(bs_v, bs_h, per_mb, mb_w, mb_h)
        n = mb_w * mb_h
        param_bytes = 6 * 4 * n + 2 * bs_v.numel()
        zbs = torch.zeros_like(bs_v)
        for name, b, ops, kfn, zfn, p_ms, err in (
                ("deblock_luma", 2 * Y.numel() + param_bytes,
                 LUMA_LINE_OPS * lines_y,
                 lambda: kernels.deblock_luma(Y, *args, **kw),
                 lambda: kernels.deblock_luma(Y, zbs, zbs, *per_mb, **kw),
                 ms_y, err_y),
                ("deblock_chroma", 2 * (U.numel() + V.numel())
                 + param_bytes + 2 * 52 * 4, CHROMA_LINE_OPS * lines_c,
                 lambda: kernels.deblock_chroma(U, V, *args, cb, cr, **kw),
                 lambda: kernels.deblock_chroma(U, V, zbs, zbs, *per_mb, cb,
                                                cr, **kw), ms_c, err_c)):
            t_bytes = b / HBM_BYTES_PER_S * 1e3
            t_ops = ops / INT_OPS_PER_S * 1e3
            s = {"ms": cuda_ms(kfn, inner=20),
                 "chain_ms": cuda_ms(zfn, inner=20), "plain_ms": p_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "max_err": err}
            stats[(w, h, name)] = s
            print(f"{name} at the {w}x{h} field: {s['ms']:.4f} ms (all bS "
                  f"0: {s['chain_ms']:.4f} ms; plain {p_ms:.1f} ms), bound "
                  f"{s['bound_ms'] * 1e3:.2f} us ({s['bound_by']}: {b} B, "
                  f"{ops} int ops)", flush=True)
    return stats


# phase 43's variants at the field shapes: (chroma rows per MB / 4, bit
# depth) -> the kernels it checks (K1-HBD and K2-HBD; K2-422; K2-422-HBD)
FIELD_VARIANTS = {(2, 10): ("deblock_luma16", "deblock_chroma16"),
                  (4, 8): ("deblock_chroma422",),
                  (4, 10): ("deblock_chroma422_16",)}


def field_variant_kernel_phase(rng) -> dict:
    """Phase 43's second part: K1-HBD, K2-HBD (10 bits, 4:2:0), K2-422
    (8 bits) and K2-422-HBD (10 bits) at the field shapes, on field bS
    (field_bs) with the mixed per-MB parameters (at 10 bits QPY from
    -QpBdOffsetY, hbd_case), against their plain twins on the card, bit
    for bit, over 10 launches at the 1080p field; CUDA-event times
    (median of 7 runs of 20 calls) beside the bound, the all-bS-zero
    chain and the plain twins' checking call. Returns the statistics by
    (w, h, launch key)."""
    stats = {}
    for w, h in FIELD_SHAPES:
        mb_w, mb_h = w // 16, h // 16
        kw = dict(mb_w=mb_w, mb_h=mb_h)
        for (crows, bd), keys in FIELD_VARIANTS.items():
            if bd == 8:
                Y, U, V, _, _, per_mb, cb, cr = deblock_case(
                    rng, mb_w, mb_h, "mixed", crows)
            else:
                Y, U, V, _, _, per_mb, cb, cr = hbd_case(
                    rng, mb_w, mb_h, "mixed", bd, crows)
            (bs_v, bs_h), _ = field_bs(rng, mb_w, mb_h)
            args = (bs_v, bs_h, *per_mb)
            zbs = torch.zeros_like(bs_v)
            lines_y, lines_c = filtered_lines(bs_v, bs_h, per_mb, mb_w, mb_h,
                                              crows)
            param_bytes = 6 * 4 * mb_w * mb_h + 2 * bs_v.numel()
            size = 1 if bd == 8 else 2           # bytes a sample
            for key in keys:
                if key.startswith("deblock_luma"):
                    ins = (Y,)
                    pfn = lambda: (deblock_luma_plain(  # noqa: E731
                        Y, *args, bd=bd, **kw),)
                    kfn = lambda b: (kernels.deblock_luma(  # noqa: E731
                        Y, *b, *per_mb, bd=bd, **kw),)
                    nbytes = 2 * size * Y.numel() + param_bytes
                    ops = LUMA_LINE_OPS * lines_y
                else:
                    ins = (U, V)
                    pfn = lambda: deblock_chroma_plain(  # noqa: E731
                        U, V, *args, cb, cr, bd=bd, **kw)
                    kfn = lambda b: kernels.deblock_chroma(  # noqa: E731
                        U, V, *b, *per_mb, cb, cr, crows=crows, bd=bd, **kw)
                    nbytes = (2 * size * (U.numel() + V.numel()) + param_bytes
                              + 2 * 4 * cb.numel())
                    ops = CHROMA_LINE_OPS * lines_c
                want, p_ms = event_ms(pfn)
                err = 0
                for _ in range(10 if h > 200 else 1):
                    got = kfn((bs_v, bs_h))
                    err = max(err, *(int((g.int() - q.int()).abs().max())
                                     for g, q in zip(got, want)))
                torch.cuda.synchronize()
                changed = sum(int((q != i).sum()) for q, i in zip(want, ins))
                if err or not changed:
                    raise AssertionError(f"deblock field {w}x{h} {key}: "
                                         f"max|err| {err}, {changed} samples "
                                         f"changed")
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / INT_OPS_PER_S * 1e3
                st = {"ms": cuda_ms(lambda: kfn((bs_v, bs_h)), inner=20),
                      "chain_ms": cuda_ms(lambda: kfn((zbs, zbs)), inner=20),
                      "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else
                      "operations", "max_err": err}
                stats[(w, h, key)] = st
                print(f"{key} at the {w}x{h} field "
                      f"({'4:2:2' if crows == 4 else '4:2:0'}, {bd} bits): "
                      f"max|err| {err} against the plain twin, samples "
                      f"changed {changed}; {st['ms']:.4f} ms (all bS 0: "
                      f"{st['chain_ms']:.4f} ms; plain {p_ms:.1f} ms), bound "
                      f"{st['bound_ms'] * 1e3:.2f} us ({st['bound_by']}: "
                      f"{nbytes} B, {ops} int ops)", flush=True)
    return stats


class FieldTimedEncoder(Encoder):
    """The port's Encoder with each field picture's wall ms (the card
    synchronized at its ends) in ``field_ms``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.field_ms = []

    def _encode_field(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super()._encode_field(*a, **kw)
        torch.cuda.synchronize()
        self.field_ms.append((time.perf_counter() - t0) * 1e3)
        return out


def field_stream_phase(label: str, cfg, frames, job) -> dict:
    """One field stream of phase 44: frames encoded on the card through
    encode_stream (every field on the host coders), one launch each of
    K1 and K2 per field picture; each field's ms, ms per MB, bytes and
    the P fields' MB decisions; the payloads and each field's recon equal
    the CPU run (job: cpu_field's); then the stream decoded on the card:
    every frame equal to the woven recon and to the CPU decode, one
    launch each of K1 and K2 per field picture, every slice parsed
    natively. Returns the launches of the encode and of the decode, and
    the payloads."""
    enc = FieldTimedEncoder(cfg, device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    payloads = enc.encode_stream(frames)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    n_fields = 2 * len(frames)
    check_launches(launches, n_fields, f"{label} encode")
    check_routes(f"{label} encode", serialize=n_fields)
    n_mbs = enc.mb_w * enc.mb_h
    print(f"encode {label} ({cfg.width}x{cfg.height}, pic_interlace 1, "
          f"num_ref {cfg.num_ref}; fields of {enc.mb_w}x{enc.mb_h} MBs): "
          f"{len(frames) / total_s:.3f} frames/s, "
          f"{sum(map(len, payloads))} stream bytes "
          f"{[len(p) for p in payloads]}, launches {launches}", flush=True)
    for r, ms in zip(enc.results, enc.field_ms):
        print(f"  {label} field disp {r['disp']} parity {r['parity']} "
              f"{r['type']}: {r['bits'] // 8} B, {ms:.1f} ms = "
              f"{ms / n_mbs:.3f} ms/MB"
              + (f"; MBs {r['mix']}; MB loop parts (s) "
                 f"{ {k: round(v, 3) for k, v in r['mb_parts'].items()} }"
                 if "mix" in r else ""), flush=True)
    t0 = time.perf_counter()
    cpu_payloads, cpu_recon, cpu_frames = job.get()
    if cpu_payloads != payloads:
        raise AssertionError(f"{label}: CPU and CUDA payloads differ")
    for i, (r, rec) in enumerate(zip(enc.results, cpu_recon)):
        for k, p in enumerate("YUV"):
            if not np.array_equal(rec[k], getattr(r["frame"], p)):
                raise AssertionError(f"{label} field {i} {p}: recon differs")
    print(f"cross-check {label}: the CPU's payloads and the recon of "
          f"{n_fields} fields equal the CUDA run (CPU worker; waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(b"".join(payloads))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dec_launches = launch_counts()
    check_launches(dec_launches, n_fields, f"decode {label}")
    check_routes(f"decode {label}", parse=n_fields, recon=sum(
        p["path"] != "inter" for p in dec.pictures))
    check_frames(out, woven(enc.results), f"decode {label}")
    check_frames(out, cpu_frames, f"decode {label} against the CPU decode")
    print(f"decode {label} on the card: {len(out)} frames ({n_fields} "
          f"fields) equal the woven recon and the CPU decode; "
          f"{len(out) / dt:.3f} frames/s; per field " + ", ".join(
              f"{p['type'][0]}/{p['path']} {p['seconds'] * 1e3:.1f} ms "
              f"(parse {p['parse_s'] * 1e3:.1f}, intra recon "
              f"{p['host_recon_s'] * 1e3:.1f}, device "
              f"{p['device_s'] * 1e3:.1f})" for p in dec.pictures)
          + f"; launches {dec_launches}", flush=True)
    return launches, dec_launches, payloads


def field_golden_phase() -> dict:
    """Phase 45: JM's goldens field1 / fieldcab (CAVLC / CABAC frame
    pictures under an SPS that allows fields, cropped) and field2 (field
    pictures, four reference frames) on the card against their _rec.yuv,
    cif_field (60 CIF field pictures) against the sha256 of ldecod's
    output; one launch each of K1 and K2 per picture (field or frame),
    frames/s and the per-picture split. Returns the launches
    (field_goldens_decode)."""
    import hashlib
    total = {}
    for name in FIELD_GOLDENS + ("cif_field",):
        dec = H264Decoder(device=DEVICE)
        kernels.reset_launches()
        t0 = time.perf_counter()
        if name == "cif_field":
            got = sorted(dec.decode_annexb(golden_bytes(name)),
                         key=lambda f: f.poc)
            sha = hashlib.sha256(b"".join(
                f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
                for f in got)).hexdigest()
            if len(got) != 30 or sha != CIF_FIELD_SHA256:
                raise AssertionError(f"decode cif_field: {len(got)} frames, "
                                     f"sha256 {sha}")
            what = "whose sha256 equals ldecod's output's"
        else:
            got = decode_golden(name, dec)
            what = f"equal {name}_rec.yuv"
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gl = launch_counts()
        check_launches(gl, len(dec.pictures), f"decode {name}")
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        paths = {}
        for p in dec.pictures:
            paths[p["path"]] = paths.get(p["path"], 0) + 1
        print(f"decode {name}.264 on the card: {len(got)} frames "
              f"({len(dec.pictures)} pictures, {paths}) {what}; "
              f"{len(got) / dt:.3f} frames/s; parse "
              f"{sum(p['parse_s'] for p in dec.pictures) * 1e3:.1f} ms, "
              f"intra recon "
              f"{sum(p['host_recon_s'] for p in dec.pictures) * 1e3:.1f} "
              f"ms, device "
              f"{sum(p['device_s'] for p in dec.pictures) * 1e3:.1f} ms in "
              f"all; launches {gl}", flush=True)
    return {"field_goldens_decode": total}


def field_phases(frames, cpu_refs, rng) -> tuple:
    """Phases 43-45; returns (the kernels' statistics at the field shapes
    by (w, h, launch key), the launches of each field path by name:
    field_1080p, field_cif, each also with _decode, field_goldens_decode;
    the 1080p field pair's payloads)."""
    stats = field_kernel_phase(rng)
    # the variants draw from a generator of their own: the later phases'
    # random pictures stay those of the runs before them
    stats.update(field_variant_kernel_phase(np.random.default_rng(431)))
    out = {}
    out["field_1080p"], out["field_1080p_decode"], payloads = \
        field_stream_phase("field 1080p", field_cfg(), frames[:1],
                           cpu_refs["field_1080p"])
    out["field_cif"], out["field_cif_decode"], _ = field_stream_phase(
        "field CIF", field_cif_cfg(), cif(frames, FIELD_CIF_FRAMES),
        cpu_refs["field_cif"])
    out.update(field_golden_phase())
    return stats, out, payloads


# ---------------------------------------------------------------------------
# phases 46-48: SP switching pictures and concealment
# ---------------------------------------------------------------------------

SP_KW = dict(sp_periodicity=2, qp_sp=30, qp_sp2=32)
SP_FRAMES = 3             # phase 47's 1080p stream: device IDR, P, host SP
# phase 47's CIF SP streams: (label, frames, EncoderConfig keywords)
SP_CIF = (("a", 9, dict(SP_KW, sp_periodicity=3)),
          ("b", 6, dict(SP_KW, num_b=1)))
# sha256 of JM ldecod's output of tests/golden/cif_sp.264 (30 CIF frames,
# 5 SP pictures; tests/test_cif_conformance.py records it)
CIF_SP_SHA256 = ("a60dbb7782e35716463637f8360c6643b301c5b62564f7c02243"
                 "591eb32d75f3")
CONCEAL_1080P = 6         # phase 3's first pictures in phase 48 (3 lost)
CONCEAL_CIF_FRAMES = 6    # frames of phase 48's CIF stream, 4 slices each


def sp_cfg():
    """Phase 47's 1080p configuration: phase 3's device RD route, every
    second anchor an SP picture (the host P coder) at QP 30, QS 32."""
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, **SP_KW)


def sp_cif_cfg(kw):
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         device_rd=True, **kw)


def conceal_cif_cfg():
    """Phase 48's CIF configuration: 4 slices of 99 MBs per picture (the
    IDR on the host IntraPicture, the P pictures on the device route)."""
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         device_rd=True, slice_mode=1, slice_argument=99)


def cpu_sp(cfg, frames):
    """Phase 47's CPU reference: the frames encoded on the CPU through
    encode_stream, then that stream decoded on the CPU: (payloads, each
    picture's recon (Y, U, V), the decoded frames)."""
    enc = Encoder(cfg, device="cpu")
    payloads = enc.encode_stream(frames)
    payloads[-1] += enc.flush()
    return (payloads, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], cpu_decode(b"".join(payloads)))


def lossy_cif(payloads) -> bytes:
    """Phase 48's lossy CIF stream: of the 4 slices a picture, the IDR's
    second and picture 1's third dropped, picture 2's second cut in half
    and padded with 0xff bytes, picture 4 dropped whole (a frame_num
    gap)."""
    from jm_tpu_torch.bitstream.nal import annexb_bytes, split_annexb
    units = list(split_annexb(b"".join(payloads)))
    vcl = [i for i, u in enumerate(units) if u.nal_unit_type in (1, 5)]
    drop = {vcl[1], vcl[6]} | set(vcl[16:20])
    out = b""
    for i, u in enumerate(units):
        if i in drop:
            continue
        raw = annexb_bytes(u.nal_ref_idc, u.nal_unit_type, u.rbsp)
        if i == vcl[9]:
            raw = raw[:len(raw) // 2] + bytes([255] * 8)
        out += raw
    return out


def cpu_conceal_decode(data: bytes):
    """The lossy stream decoded on the CPU with conceal_mode 1 and 2:
    {mode: (frames (Y, U, V), concealed_count)}."""
    out = {}
    for mode in (1, 2):
        dec = H264Decoder(device="cpu", conceal_mode=mode)
        out[mode] = ([(f.Y, f.U, f.V) for f in dec.decode_annexb(data)],
                     dec.concealed_count)
    return out


def cpu_conceal_cif(cfg, frames):
    """Phase 48's CIF CPU reference: the stream encoded on the CPU, and
    its lossy version decoded on the CPU in both modes: (payloads,
    cpu_conceal_decode's result)."""
    payloads = Encoder(cfg, device="cpu").encode_stream(frames)
    return payloads, cpu_conceal_decode(lossy_cif(payloads))


def sp_bs(rng, mb_w: int, mb_h: int, sp):
    """Boundary strengths on the card of a random picture (a fifth of the
    MBs intra, small MVs, four reference ids, sparse coefficients) whose
    MBs sp ((N,) bool) lie in SP slices (ops/deblock.compute_bs
    (sp_slice=)): every edge of those MBs but the picture's border bS 4
    on MB edges, 3 inside."""
    from jm_tpu_torch.ops.deblock import compute_bs
    n = mb_w * mb_h
    intra = rng.random(n) < 0.2
    nnz = rng.integers(0, 3, (n, 16)) * (rng.random((n, 16)) < 0.3)
    mv = rng.integers(-3, 4, (n, 16, 2))
    mv[intra] = 0
    rid = rng.integers(0, 4, (n, 4))
    rid[intra] = -1
    t = lambda a: torch.as_tensor(np.asarray(a), device=DEVICE)  # noqa: E731
    return compute_bs(
        t(intra.astype(np.int8)), t(nnz.astype(np.int32)),
        t(np.zeros(n, np.int32)), t(mv.astype(np.int32)),
        t(np.zeros((n, 16, 2), np.int32)), t(rid.astype(np.int64)),
        t(np.full((n, 4), -1, np.int64)), mb_w, mb_h, sp_slice=t(sp))


def sp_kernel_phase(rng) -> dict:
    """Phase 46: K1 and K2 at 1080p on the bS of an SP picture (every MB
    in an SP slice, the filter on everywhere: every edge filtered, the
    strong filter on every MB edge, the kernels' worst case; REPEATS
    launches) and of a half-SP picture (the mixed per-MB parameters, the
    first and third of its three slices SP), against their plain twins on
    the card, bit for bit; CUDA-event times (median of 7 runs of 20
    calls) beside the bound, the all-bS-zero chain and the plain twins'
    checking call. Returns the statistics by (case, kernel)."""
    mb_w, mb_h = W // 16, H // 16
    n = mb_w * mb_h
    stats = {}
    for case, variant, repeats in (("sp", "plain", REPEATS),
                                   ("half_sp", "mixed", 1)):
        Y, U, V, _, _, per_mb, cb, cr = deblock_case(rng, mb_w, mb_h,
                                                     variant)
        sp = np.ones(n, bool) if case == "sp" else \
            per_mb[4].cpu().numpy() % 2 == 0
        bs_v, bs_h = sp_bs(rng, mb_w, mb_h, sp)
        spq = torch.as_tensor(np.repeat(np.repeat(
            sp.reshape(mb_h, mb_w), 4, 0), 4, 1), device=DEVICE)
        if not (bool((bs_v[:, 1:][spq[:, 1:]] >= 3).all())
                and bool((bs_h[1:][spq[1:]] >= 3).all())):
            raise AssertionError(f"SP bS ({case}): an edge of an SP MB "
                                 f"below 3")
        args = (bs_v, bs_h, *per_mb)
        kw = dict(mb_w=mb_w, mb_h=mb_h)
        py, ms_y = event_ms(lambda: deblock_luma_plain(Y, *args, **kw))
        (pu, pv), ms_c = event_ms(lambda: deblock_chroma_plain(
            U, V, *args, cb, cr, **kw))
        err_y = err_c = 0
        for _ in range(repeats):
            ky = kernels.deblock_luma(Y, *args, **kw)
            ku, kv = kernels.deblock_chroma(U, V, *args, cb, cr, **kw)
            err_y = max(err_y, int((ky.int() - py.int()).abs().max()))
            err_c = max(err_c, int((ku.int() - pu.int()).abs().max()),
                        int((kv.int() - pv.int()).abs().max()))
        torch.cuda.synchronize()
        changed = (int((py != Y).sum()),
                   int((pu != U).sum()) + int((pv != V).sum()))
        lines_y, lines_c = filtered_lines(bs_v, bs_h, per_mb, mb_w, mb_h)
        print(f"deblock {W}x{H} {case} x{repeats}: luma max|err| {err_y}, "
              f"chroma max|err| {err_c}, samples changed (luma, chroma) "
              f"{changed}, filtered lines (luma, chroma) "
              f"{(lines_y, lines_c)}, bS 4 / 3 edges "
              f"{int((bs_v == 4).sum() + (bs_h == 4).sum())} / "
              f"{int((bs_v == 3).sum() + (bs_h == 3).sum())}", flush=True)
        if err_y or err_c or min(changed) == 0:
            raise AssertionError(f"deblock {case}: the kernels differ from "
                                 f"the plain twins, or filter nothing")
        param_bytes = 6 * 4 * n + 2 * bs_v.numel()
        zbs = torch.zeros_like(bs_v)
        for name, b, ops, kfn, zfn, p_ms, err in (
                ("deblock_luma", 2 * Y.numel() + param_bytes,
                 LUMA_LINE_OPS * lines_y,
                 lambda: kernels.deblock_luma(Y, *args, **kw),
                 lambda: kernels.deblock_luma(Y, zbs, zbs, *per_mb, **kw),
                 ms_y, err_y),
                ("deblock_chroma", 2 * (U.numel() + V.numel())
                 + param_bytes + 2 * 52 * 4, CHROMA_LINE_OPS * lines_c,
                 lambda: kernels.deblock_chroma(U, V, *args, cb, cr, **kw),
                 lambda: kernels.deblock_chroma(U, V, zbs, zbs, *per_mb, cb,
                                                cr, **kw), ms_c, err_c)):
            t_bytes = b / HBM_BYTES_PER_S * 1e3
            t_ops = ops / INT_OPS_PER_S * 1e3
            s = {"ms": cuda_ms(kfn, inner=20),
                 "chain_ms": cuda_ms(zfn, inner=20), "plain_ms": p_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "max_err": err}
            stats[(case, name)] = s
            print(f"{name} on {case} bS at {W}x{H}: {s['ms']:.4f} ms (all "
                  f"bS 0: {s['chain_ms']:.4f} ms; plain {p_ms:.1f} ms), "
                  f"bound {s['bound_ms'] * 1e3:.2f} us ({s['bound_by']}: "
                  f"{b} B, {ops} int ops)", flush=True)
    return stats


class PictureTimedEncoder(Encoder):
    """The port's Encoder with each coded picture's wall ms (the card
    synchronized at its ends) in ``picture_ms``, in the order of
    ``results``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.picture_ms = []

    def _timed(self, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        self.picture_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def _emit_anchor(self, *a, **kw):
        return self._timed(super()._emit_anchor, *a, **kw)

    def _emit_b(self, *a, **kw):
        return self._timed(super()._emit_b, *a, **kw)


def sp_stream_phase(label: str, cfg, frames, job) -> dict:
    """One SP stream of phase 47: frames encoded on the card through
    encode_stream (the I and P pictures on the device route, the SP
    pictures on the host P coder, B pictures on the host B coder), one
    launch each of K1 and K2 per picture, every slice serialized
    natively; each picture's type, ms and bytes, each SP picture's ms per
    MB and MB loop split (search, skip, intra, commit, of it the SP
    levels and recon); the payloads and recon equal the CPU run (job:
    cpu_sp's); then the stream decoded on the card: every picture equal
    to the recon and to the CPU decode, one launch each of K1 and K2 per
    picture, every I / P / SP slice parsed natively. Returns the launches
    of the encode and of the decode."""
    enc = PictureTimedEncoder(cfg, device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    payloads = enc.encode_stream(frames)
    payloads[-1] += enc.flush()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    n_pic = len(enc.results)
    n_b = sum(r["type"] == "B" for r in enc.results)
    n_sp = sum(bool(r.get("sp")) for r in enc.results)
    launches = launch_counts()
    check_launches(launches, n_pic, f"{label} encode")
    check_routes(f"{label} encode", serialize=n_pic - n_b,
                 b={"serialize": n_b}, other={"sp": {"serialize": n_sp}})
    n_mbs = enc.mb_w * enc.mb_h
    print(f"encode {label} ({cfg.width}x{cfg.height}, sp_periodicity "
          f"{cfg.sp_periodicity}, QP {cfg.qp} / SP {cfg.qp_sp} / QS "
          f"{cfg.qp_sp2}, num_b {cfg.num_b}): {len(frames) / total_s:.3f} "
          f"frames/s, {sum(map(len, payloads))} stream bytes, launches "
          f"{launches}", flush=True)
    for r, ms in zip(enc.results, enc.picture_ms):
        kind = "SP" if r.get("sp") else r["type"]
        line = (f"  {label} disp {r['disp']} {kind}: {r['bits'] // 8} B, "
                f"{ms:.1f} ms")
        if "mb_parts" in r:
            parts = r["mb_parts"]
            line += (f" = {ms / n_mbs:.3f} ms/MB; MB loop (ms/MB) " + ", ".join(
                f"{k} {v / n_mbs * 1e3:.3f}" for k, v in parts.items())
                + f"; MBs {r['mix']}")
        print(line, flush=True)
    t0 = time.perf_counter()
    cpu_payloads, cpu_recon, cpu_frames = job.get()
    if cpu_payloads != payloads:
        raise AssertionError(f"{label}: CPU and CUDA payloads differ")
    for i, (r, rec) in enumerate(zip(enc.results, cpu_recon)):
        for k, p in enumerate("YUV"):
            if not np.array_equal(rec[k], getattr(r["frame"], p)):
                raise AssertionError(f"{label} picture {i} {p}: recon "
                                     f"differs")
    print(f"cross-check {label}: the CPU's payloads and the recon of "
          f"{n_pic} pictures equal the CUDA run (CPU worker; waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(b"".join(payloads))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dec_launches = launch_counts()
    check_launches(dec_launches, n_pic, f"decode {label}")
    check_routes(f"decode {label}", parse=n_pic - n_b, recon=sum(
        p["path"] != "inter" for p in dec.pictures), b={"parse": n_b},
        other={"sp": {"parse": n_sp}})
    check_frames(out, [(r["frame"].Y, r["frame"].U, r["frame"].V)
                       for r in enc.results], f"decode {label}")
    check_frames(out, cpu_frames, f"decode {label} against the CPU decode")
    print(f"decode {label} on the card: {len(out)} pictures equal the "
          f"recon and the CPU decode; {len(out) / dt:.3f} frames/s; "
          + ", ".join(f"{p['type']}/{p['path']} {p['seconds'] * 1e3:.1f} ms "
                      f"(parse {p['parse_s'] * 1e3:.1f}, intra recon "
                      f"{p['host_recon_s'] * 1e3:.1f}, device "
                      f"{p['device_s'] * 1e3:.1f})" for p in dec.pictures)
          + f"; launches {dec_launches}", flush=True)
    return launches, dec_launches


def sp_golden_phase() -> dict:
    """Phase 47's goldens: JM's sp1 (QCIF, 2 SP pictures) against its
    _rec.yuv and cif_sp (30 CIF pictures, 5 SP) against the sha256 of
    ldecod's output, on the card; one launch each of K1 and K2 per
    picture. Returns their launches (sp_goldens_decode)."""
    import hashlib
    total = {}
    for name in ("sp1", "cif_sp"):
        dec = H264Decoder(device=DEVICE)
        kernels.reset_launches()
        native.reset_routes()
        t0 = time.perf_counter()
        if name == "cif_sp":
            got = dec.decode_annexb(golden_bytes(name))
            sha = hashlib.sha256(b"".join(
                f.Y.tobytes() + f.U.tobytes() + f.V.tobytes()
                for f in got)).hexdigest()
            if len(got) != 30 or sha != CIF_SP_SHA256:
                raise AssertionError(f"decode cif_sp: {len(got)} frames, "
                                     f"sha256 {sha}")
            what = "whose sha256 equals ldecod's output's"
        else:
            got = decode_golden(name, dec)
            what = f"equal {name}_rec.yuv"
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gl = launch_counts()
        check_launches(gl, len(dec.pictures), f"decode {name}")
        n_sp = sum(p["type"] == "SP" for p in dec.pictures)
        check_routes(f"decode {name}", parse=len(dec.pictures), recon=sum(
            p["path"] != "inter" for p in dec.pictures),
            other={"sp": {"parse": n_sp}})
        for k, v in gl.items():
            total[k] = total.get(k, 0) + v
        print(f"decode {name}.264 on the card: {len(got)} frames ({n_sp} "
              f"SP) {what}; {len(got) / dt:.3f} frames/s; SP pictures "
              + ", ".join(f"{p['seconds'] * 1e3:.1f} ms (device "
                          f"{p['device_s'] * 1e3:.1f})"
                          for p in dec.pictures if p["type"] == "SP")
              + f"; launches {gl}", flush=True)
    return {"sp_goldens_decode": total}


def sp_recon_timing() -> None:
    """CUDA-event ms of ops/dec.sp_recon on every MB of a 1080p picture
    (random prediction and levels), beside p_dec_residuals' on the same
    levels: the SP stage's cost in a decode."""
    from jm_tpu_torch.ops import dec as D
    from jm_tpu_torch.ops.quant import FLAT_INV_SCALE_4x4
    rng = np.random.default_rng(47)
    mb_w, mb_h = W // 16, H // 16
    n = mb_w * mb_h
    t = lambda a: torch.as_tensor(np.asarray(a), device=DEVICE)  # noqa: E731
    planes = [t(rng.integers(0, 256, s).astype(np.uint8))
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    lc = t(rng.integers(-20, 21, (n, 16, 16)) * (rng.random((n, 16, 16))
                                                 < 0.2))
    cdc = t(rng.integers(-20, 21, (n, 2, 4)))
    cc = rng.integers(-20, 21, (n, 2, 4, 16)) * (rng.random((n, 2, 4, 16))
                                                 < 0.2)
    cc[..., 0] = 0
    cc = t(cc)
    qp, qs = t(np.full(n, 30, np.int32)), t(np.full(n, 32, np.int32))
    sw = t(np.zeros(n, bool))
    idx = t(np.arange(n, dtype=np.int64))
    ms_sp = cuda_ms(lambda: D.sp_recon(*(p.clone() for p in planes), idx, lc,
                                       cdc, cc, qp, qs, sw, mb_w=mb_w))
    tab = t(FLAT_INV_SCALE_4x4)
    qpc = t(np.array([chroma_qp(q, 0) for q in range(52)], np.int32))
    ms_res = cuda_ms(lambda: D.p_dec_residuals(lc, cdc, cc, qp, tab, tab,
                                               tab, qpc, qpc, mb_w=mb_w,
                                               mb_h=mb_h))
    print(f"sp_recon on every MB of a {W}x{H} picture: {ms_sp:.3f} ms "
          f"(p_dec_residuals on the same levels {ms_res:.3f} ms)",
          flush=True)


def sp_phases(frames, cpu_refs, rng) -> tuple:
    """Phases 46-47; returns (the kernels' statistics on the SP bS, the
    launches of each SP path by name: sp_1080p, sp_cif_a, sp_cif_b, each
    also with _decode, sp_goldens_decode)."""
    stats = sp_kernel_phase(rng)
    out = {}
    out["sp_1080p"], out["sp_1080p_decode"] = sp_stream_phase(
        "SP 1080p", sp_cfg(), frames[:SP_FRAMES], cpu_refs["sp_1080p"])
    for label, n, kw in SP_CIF:
        out[f"sp_cif_{label}"], out[f"sp_cif_{label}_decode"] = \
            sp_stream_phase(f"SP CIF ({label})", sp_cif_cfg(kw),
                            cif(frames, n), cpu_refs[f"sp_cif_{label}"])
    out.update(sp_golden_phase())
    sp_recon_timing()
    return stats, out


def conceal_decode(data: bytes, job_result, label: str,
                   counts=launch_counts) -> dict:
    """The lossy stream decoded on the card with conceal_mode 1 and 2:
    frames equal to the CPU decode (job_result: cpu_conceal_decode's), the
    same concealed_count; one launch each of K1 and K2 (the kernels that
    counts() reads: those of the stream's format and bit depth) per
    reconstructed picture (a picture with concealed MBs is deblocked
    before they are concealed; a whole concealed frame is a copy, not
    deblocked); frames/s and the concealment's ms. Returns the launches
    by mode."""
    out = {}
    for mode in (1, 2):
        dec = H264Decoder(device=DEVICE, conceal_mode=mode)
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = dec.decode_annexb(data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gl = counts()
        check_launches(gl, len(dec.pictures), f"{label} mode {mode}")
        want, count = job_result[mode]
        check_frames(got, want, f"{label} mode {mode} against the CPU")
        if dec.concealed_count != count:
            raise AssertionError(f"{label} mode {mode}: concealed "
                                 f"{dec.concealed_count}, the CPU {count}")
        n_frames = len(got) - len(dec.pictures)
        per_mb = [f"{p['conceal_s'] * 1e3:.1f}" for p in dec.pictures
                  if "conceal_s" in p]
        print(f"decode {label} with conceal_mode {mode} on the card: "
              f"{len(got)} frames ({len(dec.pictures)} decoded, {n_frames} "
              f"concealed whole) equal the CPU decode; concealed_count "
              f"{dec.concealed_count}; {len(got) / dt:.3f} frames/s; "
              f"concealment {dec.conceal_s * 1e3:.1f} ms in all"
              + (f" ({', '.join(per_mb)} ms in the pictures with lost MBs)"
                 if per_mb else "") + f"; launches {gl}", flush=True)
        out[mode] = gl
    return out


def conceal_phase(payloads, cif_frames, cpu_refs, job_1080p) -> tuple:
    """Phase 48: concealment on the card. Phase 3's first CONCEAL_1080P
    pictures with picture 3 dropped (a frame_num gap: one whole frame
    concealed), against the CPU decode of the same bytes (job_1080p, a
    worker's); a CIF stream of 4 slices per picture encoded on the card
    (its payloads equal the CPU's) with an IDR slice and a P slice
    dropped, a slice cut and a picture dropped (lossy_cif), against the
    CPU decode of that lossy stream (cpu_refs["conceal_cif"]); each in
    both modes (conceal_decode). Returns the launches by path and the CIF
    stream's payloads."""
    lossy = b"".join(payloads[:3] + payloads[4:CONCEAL_1080P])
    out = {}
    t0 = time.perf_counter()
    ref = job_1080p.get()
    print(f"conceal 1080p: CPU decodes arrived (waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    for mode, gl in conceal_decode(lossy, ref, "conceal 1080p").items():
        out[f"conceal_1080p_m{mode}_decode"] = gl
    enc = Encoder(conceal_cif_cfg(), device=DEVICE)
    kernels.reset_launches()
    t0 = time.perf_counter()
    cif_payloads = enc.encode_stream(cif_frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["conceal_cif"] = launch_counts()
    check_launches(out["conceal_cif"], len(cif_frames), "conceal CIF encode")
    cpu_payloads, ref = cpu_refs["conceal_cif"].get()
    if cpu_payloads != cif_payloads:
        raise AssertionError("conceal CIF: CPU and CUDA payloads differ")
    print(f"encode conceal CIF (4 slices a picture): "
          f"{len(cif_frames) / dt:.3f} frames/s, payloads equal the CPU's",
          flush=True)
    for mode, gl in conceal_decode(lossy_cif(cif_payloads), ref,
                                   "conceal CIF").items():
        out[f"conceal_cif_m{mode}_decode"] = gl
    return out, cif_payloads


# ---------------------------------------------------------------------------
# phases 49-51: MVC stereo (two views) and the lencod / ldecod entry points
# ---------------------------------------------------------------------------

MVC_SHIFT = 8             # view 1: the frames shifted 8 luma / 4 chroma columns
MVC_FRAMES = 2            # phase 49's 1080p access units: the anchor and one
                          # non-anchor P (both view-1 list forms)
# phase 50's CIF stereo streams: (label, frames, EncoderConfig keywords)
MVC_CIF = (("a", 6, dict(intra_period=3)),
           ("b", 5, dict(num_b=1, entropy="cabac", num_ref=2,
                         view1_qp_offset=2)))
MVC_TOOLS_FRAMES = 3      # phase 51's lencod run (CIF, two views)
# sha256 of JM lencod's recon of each view of tests/golden/stereo_jm.264
# (tests/test_mvc.py records them)
STEREO_JM_SHA256 = (
    "926b27db8b24cef65eb908831cdbaa65897d7f7642b0f000d12a0bfd6b524780",
    "93415fed2650ed80a41030a74f54b67c0a3d15cf2cad7f5cf4061d9d3c3759f7")


def view1_of(frames):
    """The dependent view: each frame shifted MVC_SHIFT luma columns."""
    k = MVC_SHIFT
    return [(np.roll(Y, -k, axis=1), np.roll(U, -k // 2, axis=1),
             np.roll(V, -k // 2, axis=1)) for Y, U, V in frames]


def mvc_cfg():
    """Phase 49's configuration: phase 3's device route with two views
    (view 0 takes the device I frame and device P; every view-1 picture
    the host P coder)."""
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=True, num_views=2)


def mvc_cif_cfg(kw):
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         device_rd=True, num_views=2, **kw)


def mvc_encode(enc, frames) -> list:
    """frames (view 0) and view1_of(frames) through encode_frame, flush's
    bytes added to the last call's: the payload of each call."""
    out = [enc.encode_frame(*f, view1=g)
           for f, g in zip(frames, view1_of(frames))]
    out[-1] += enc.flush()
    return out


def _recon(results) -> list:
    return [(r["frame"].Y, r["frame"].U, r["frame"].V) for r in results]


def cpu_mvc(cfg, frames):
    """Phases 49-50's CPU reference: (payloads, each view-0 picture's
    recon, each view-1 picture's recon), coding order."""
    enc = Encoder(cfg, device="cpu")
    payloads = mvc_encode(enc, frames)
    return payloads, _recon(enc.results), _recon(enc.results_v1)


def tools_sources(d: str, frames) -> str:
    """Phase 51's inputs in directory d: the two views' YUV files, the
    view-1 cfg and the encoder cfg (CIF, MVC_TOOLS_FRAMES frames, two
    views); returns the encoder cfg's path."""
    left = cif(frames, MVC_TOOLS_FRAMES)
    h, w = left[0][0].shape
    for name, fr in (("left.yuv", left), ("right.yuv", view1_of(left))):
        with open(os.path.join(d, name), "wb") as fh:
            for f in fr:
                fh.write(b"".join(np.ascontiguousarray(p).tobytes()
                                  for p in f))
    with open(os.path.join(d, "view1.cfg"), "w") as fh:
        fh.write(f'InputFile = "{d}/right.yuv"\n'
                 f'ReconFile = "{d}/rec1.yuv"\n')
    with open(os.path.join(d, "enc.cfg"), "w") as fh:
        fh.write(f'''InputFile = "{d}/left.yuv"
SourceWidth = {w}
SourceHeight = {h}
FramesToBeEncoded = {MVC_TOOLS_FRAMES}
QPISlice = {QP}
QPPSlice = {QP}
NumberOfViews = 2
View1ConfigFile = "{d}/view1.cfg"
''')
    return os.path.join(d, "enc.cfg")


def run_tools(cfg_path: str, out_dir: str, device: str) -> tuple:
    """lencod on cfg_path, then ldecod on its stream, writing into
    out_dir, on device (their reports captured); returns (stream, view-0
    recon, decoded YUV) bytes, and for lencod and ldecod each its wall
    seconds and its kernel launches (launch_counts, reset before each)."""
    import contextlib
    import io
    from jm_tpu_torch.tools import ldecod, lencod
    os.makedirs(out_dir, exist_ok=True)
    out = {k: os.path.join(out_dir, k) for k in ("out.264", "rec.yuv",
                                                   "dec.yuv", "stats.dat")}
    steps = []
    for main, argv in (
            (lencod.main, ["-d", cfg_path, "-p",
                           f"OutputFile={out['out.264']}", "-p",
                           f"ReconFile={out['rec.yuv']}", "-p",
                           f"StatsFile={out['stats.dat']}"]),
            (ldecod.main, ["-i", out["out.264"], "-o", out["dec.yuv"]])):
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, launch_counts()))
    files = []
    for k in ("out.264", "rec.yuv", "dec.yuv"):
        with open(out[k], "rb") as fh:
            files.append(fh.read())
    return tuple(files), steps


def cpu_tools(cfg_path: str, out_dir: str):
    """Phase 51's CPU reference: run_tools on the CPU."""
    return run_tools(cfg_path, out_dir, "cpu")[0]


def mvc_cpu_jobs(pool, frames, tools_dir: str) -> dict:
    """The CPU references of phases 49-51, submitted to the worker pool
    after the SP ones (a full run: after phase 39); returns their
    AsyncResults by name."""
    jobs = [("mvc", cpu_mvc, (mvc_cfg(), frames[:MVC_FRAMES]))]
    jobs += [(f"mvc_cif_{label}", cpu_mvc, (mvc_cif_cfg(kw), cif(frames, n)))
             for label, n, kw in MVC_CIF]
    cfg_path = tools_sources(tools_dir, frames)
    jobs += [("mvc_tools", cpu_tools,
              (cfg_path, os.path.join(tools_dir, "cpu")))]
    return {name: pool.apply_async(fn, args, callback=_arrived(name))
            for name, fn, args in jobs}


def mvc_stream_phase(label: str, cfg, frames, job) -> tuple:
    """One stereo stream of phases 49-50: frames (view 0) and
    view1_of(frames) encoded on the card through encode_frame + flush
    (view 0 on its route, every view-1 picture on the host coders), one
    launch each of K1 and K2 per picture of each view; each picture's
    ms and bytes, each view-1 picture's ms per MB, the NAL 20 bytes
    against the NAL 1 / 5 bytes; the payloads and each view's recon
    equal the CPU run (job: cpu_mvc's); then the stream decoded on the
    card: each view's frames equal to its recon, one launch each of K1
    and K2 per picture, frames/s per view. Returns the launches of the
    encode and of the decode."""
    enc = PictureTimedEncoder(cfg, device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    payloads = mvc_encode(enc, frames)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    pics = enc.results + enc.results_v1
    n_b = sum(r["type"] == "B" for r in pics)
    cabac = cfg.entropy == "cabac"
    launches = launch_counts()
    check_launches(launches, len(pics), f"{label} encode")
    check_routes(f"{label} encode", serialize=0 if cabac
                 else len(pics) - n_b, b={"serialize": n_b})
    n_mbs = enc.mb_w * enc.mb_h
    print(f"encode {label} ({cfg.width}x{cfg.height}, two views, QP "
          f"{cfg.qp}, num_b {cfg.num_b}, num_ref {cfg.num_ref}, "
          f"{cfg.entropy}, view1_qp_offset {cfg.view1_qp_offset}): "
          f"{len(frames) / total_s:.3f} access units/s, "
          f"{sum(map(len, payloads))} stream bytes (NAL 20 "
          f"{nal_bytes(payloads, (20,))} B against NAL 1 / 5 "
          f"{nal_bytes(payloads, (1, 5))} B), launches {launches}",
          flush=True)
    for r, ms in zip(enc.results, enc.picture_ms):
        print(f"  {label} access unit disp {r['disp']} {r['type']} "
              f"(both views): {r['bits'] // 8} B, {ms:.1f} ms", flush=True)
    for r in enc.results_v1:
        ms = r["seconds"] * 1e3
        print(f"  {label} view 1 disp {r['disp']} {r['type']}"
              f"{' (anchor)' if r['anchor'] else ''} QP {r['qp']}: "
              f"{r['bits'] // 8} B, {ms:.1f} ms = {ms / n_mbs:.3f} ms/MB",
              flush=True)
    t0 = time.perf_counter()
    cpu_payloads, rec0, rec1 = job.get()
    if cpu_payloads != payloads:
        raise AssertionError(f"{label}: CPU and CUDA payloads differ")
    for view, want, results in ((0, rec0, enc.results),
                                (1, rec1, enc.results_v1)):
        check_frames([r["frame"] for r in results], want,
                     f"{label} view {view} recon against the CPU")
    print(f"cross-check {label}: the CPU's payloads and the recon of both "
          f"views equal the CUDA run (CPU worker; waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(b"".join(payloads))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dec_launches = launch_counts()
    check_launches(dec_launches, len(pics), f"decode {label}")
    recon = sum(p["path"] != "inter" for p in dec.pictures)
    check_routes(f"decode {label}", **({"cabac": len(pics)} if cabac else
                                      {"parse": len(pics) - n_b}),
                 recon=recon, b={"parse": n_b})
    rates = []
    for view, results in ((0, enc.results), (1, enc.results_v1)):
        check_frames([f for f in out if f.view_id == view],
                     _recon(results), f"decode {label} view {view}")
        secs = sum(p["seconds"] for p in dec.pictures if p["view"] == view)
        rates.append(f"view {view} {len(results) / secs:.2f} frames/s")
    print(f"decode {label} on the card: {len(out)} frames, each view equal "
          f"to its recon; {len(out) / dt:.3f} frames/s ({', '.join(rates)});"
          f" " + ", ".join(f"v{p['view']} {p['type']}/{p['path']} "
                           f"{p['seconds'] * 1e3:.1f} ms" for p in
                           dec.pictures) + f"; launches {dec_launches}",
          flush=True)
    return launches, dec_launches


def mvc_golden_phase() -> dict:
    """Phase 51's golden: JM lencod's stereo_jm.264 (320x240, I / P / B,
    two views, JM 19.0's subset SPS layout) decoded on the card, each
    view's frames in POC order hashing to JM's recon (STEREO_JM_SHA256),
    one launch each of K1 and K2 per picture."""
    import hashlib
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = dec.decode_annexb(golden_bytes("stereo_jm"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gl = launch_counts()
    check_launches(gl, len(dec.pictures), "decode stereo_jm")
    for view, want in enumerate(STEREO_JM_SHA256):
        fr = sorted((f for f in got if f.view_id == view),
                    key=lambda f: f.poc)
        sha = hashlib.sha256(b"".join(f.Y.tobytes() + f.U.tobytes()
                                      + f.V.tobytes() for f in fr))
        if len(fr) != 3 or sha.hexdigest() != want:
            raise AssertionError(f"decode stereo_jm view {view}: {len(fr)} "
                                 f"frames, sha256 {sha.hexdigest()}")
    print(f"decode stereo_jm.264 on the card: {len(got)} frames, each "
          f"view's sha256 equal to JM's recon; {len(got) / dt:.3f} "
          f"frames/s; launches {gl}", flush=True)
    return {"mvc_golden_decode": gl}


def mvc_tools_phase(tools_dir: str, job) -> dict:
    """Phase 51's entry points: lencod (jm_tpu_torch.tools.lencod.main) on
    the stereo cfg of tools_sources, then ldecod on its stream, on the
    card; their stream, recon and decoded YUV equal the same run on the
    CPU (job: cpu_tools's); lencod writes no view-1 recon; one launch
    each of K1 and K2 per picture of each view in each."""
    cfg_path = os.path.join(tools_dir, "enc.cfg")
    out_dir = os.path.join(tools_dir, "card")
    (stream, rec, decoded), steps = run_tools(cfg_path, out_dir, DEVICE)
    for (_s, launches), name in zip(steps, ("lencod", "ldecod")):
        check_launches(launches, 2 * MVC_TOOLS_FRAMES, name)
    t0 = time.perf_counter()
    want = job.get()
    for name, a, b in zip(("stream", "recon", "decoded YUV"),
                          (stream, rec, decoded), want):
        if a != b:
            raise AssertionError(f"lencod / ldecod: the {name} differs "
                                 f"from the CPU run")
    if os.path.exists(os.path.join(tools_dir, "rec1.yuv")):
        raise AssertionError("lencod wrote the view-1 recon")
    if len(decoded) != 2 * len(rec):
        raise AssertionError(f"ldecod wrote {len(decoded)} bytes")
    print(f"lencod (CIF, two views, {MVC_TOOLS_FRAMES} frames, the host "
          f"pipeline) {steps[0][0]:.1f} s, {len(stream)} stream bytes, "
          f"launches {steps[0][1]}; ldecod {steps[1][0]:.2f} s, both views "
          f"in one file sorted by POC, launches {steps[1][1]}; stream, recon "
          f"and decoded YUV equal the CPU run (CPU worker; waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return {"mvc_lencod": steps[0][1], "mvc_ldecod": steps[1][1]}


def mvc_phases(frames, cpu_refs, tools_dir: str) -> dict:
    """Phases 49-51; returns the launches of each MVC path by name: mvc,
    mvc_cif_a, mvc_cif_b, each also with _decode, mvc_golden_decode,
    mvc_lencod, mvc_ldecod."""
    out = {}
    out["mvc"], out["mvc_decode"] = mvc_stream_phase(
        "MVC 1080p", mvc_cfg(), frames[:MVC_FRAMES], cpu_refs["mvc"])
    for label, n, kw in MVC_CIF:
        out[f"mvc_cif_{label}"], out[f"mvc_cif_{label}_decode"] = \
            mvc_stream_phase(f"MVC CIF ({label})", mvc_cif_cfg(kw),
                             cif(frames, n), cpu_refs[f"mvc_cif_{label}"])
    out.update(mvc_golden_phase())
    out.update(mvc_tools_phase(tools_dir, cpu_refs["mvc_tools"]))
    return out


# ---- phases 52-54: the parallel axes and the wide search -------------------

SHARD_FRAMES = 4          # frames of phase 52's MB-row sharded streams
SHARDS = (2, 4)           # their shard counts that divide mb_h 68
SHARDS_FALL = 8           # one that does not: the unsharded step runs
GOP_PAR_FRAMES = 6        # frames of phase 53's GOP streams
GOP_PAR_PERIOD = 3        # their intra_period (two closed GOPs)
# phase 53's configurations: (label, n_dp, n_sp, EncoderConfig keywords)
GOP_PAR = (("md_low", 2, 1, dict(device_rd=False)),
           ("md_low sp_shards 2", 2, 2, dict(device_rd=False, sp_shards=2)),
           ("device_rd", 2, 1, dict(device_rd=True)))
WIDE_FRAMES = 3           # frames of phase 54's CIF host streams (I P P)
WIDE_RANGES = (24, 32)    # their search ranges (16: the comparison)


def card_mesh(n: int) -> list:
    """n devices for a mesh: the cards torch sees in turn (one card: n
    entries of cuda:0, whose bands or GOPs then run one after another)."""
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


def graph_count() -> int:
    """The CUDA graphs of the I frame's waves held by ops/intra's cache."""
    from jm_tpu_torch.ops import intra
    return sum(len(st.graphs) for st in intra._GRAPH_STATES.values())


def framed_encode(label: str, cfg, frames, mesh):
    """frames through encode_frame + flush on the card (the encoder's
    _sp_mesh: mesh), each picture timed; one launch each of K1 and K2 per
    picture, every slice serialized natively. Returns (payloads, the
    encoder, the launches)."""
    enc = PictureTimedEncoder(cfg, device=DEVICE)
    enc._sp_mesh = mesh
    kernels.reset_launches()
    native.reset_routes()
    payloads = [enc.encode_frame(*f) for f in frames]
    payloads[-1] += enc.flush()
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches(launches, len(frames), f"{label} encode")
    check_routes(f"{label} encode", serialize=len(frames))
    return payloads, enc, launches


def sharded_cfg(shards: int):
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         device_rd=False, sp_shards=shards)


def _add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def sharded_step_timing(enc, frames) -> None:
    """The last P picture's device step alone (CUDA events, median of 3):
    ops/enc.p_frame_step against p_frame_step_sharded at each of SHARDS
    (equal fields required), and the halo assembly of its reference planes
    (_extend_band of Y, U and V: on one card each band's copy is the same
    tensor, so this is the concatenation and edge fix)."""
    from jm_tpu_torch.encoder.encoder import lambda_me, lambda_mode4
    from jm_tpu_torch.ops import enc as E
    from jm_tpu_torch.parallel import sp_pipeline as SP
    mb_w, mb_h = W // 16, H // 16
    packed = enc._upload(frames[-1])
    Y, U, V = enc._planes(packed)
    planes, padU, padV = enc.results[-2]["frame"].state
    p = E.PAD
    rY, rU, rV = planes[0, p:-p, p:-p], padU[p:-p, p:-p], padV[p:-p, p:-p]
    args = (QP, chroma_qp(QP, 0), lambda_me(QP), lambda_mode4(QP))
    want = E.p_frame_step(Y, U, V, planes, padU, padV, *args, mb_w=mb_w,
                          mb_h=mb_h, sr=16, rd=False)
    t_one = cuda_ms(lambda: E.p_frame_step(
        Y, U, V, planes, padU, padV, *args, mb_w=mb_w, mb_h=mb_h, sr=16,
        rd=False), reps=3)
    parts = [f"unsharded {t_one:.1f} ms"]
    for n in SHARDS:
        mesh = card_mesh(n)
        got = SP.p_frame_step_sharded(mesh, Y, U, V, rY, rU, rV, *args,
                                      mb_w=mb_w, mb_h=mb_h, sr=16)
        for k, v in want.items():
            if not torch.equal(got[k], v):
                raise AssertionError(f"p_frame_step_sharded ({n} shards): "
                                     f"{k} differs from p_frame_step")
        t_n = cuda_ms(lambda: SP.p_frame_step_sharded(
            mesh, Y, U, V, rY, rU, rV, *args, mb_w=mb_w, mb_h=mb_h, sr=16),
            reps=3)
        bh = H // n

        def halo():
            for plane, rows, e in ((rY, bh, SP.HALO + 3),
                                   (rU, bh // 2, SP.HALO // 2),
                                   (rV, bh // 2, SP.HALO // 2)):
                SP._extend_band([plane[i * rows:(i + 1) * rows].to(d)
                                 for i, d in enumerate(mesh)], mesh, e,
                                plane.shape[0])
        t_h = cuda_ms(halo, reps=3)
        parts.append(f"{n} shards {t_n:.1f} ms (halo assembly {t_h:.2f} ms "
                     f"= {t_h / t_n:.3f} of it)")
    print("md_low P step alone at 1080p (CUDA events; equal fields): "
          + ", ".join(parts), flush=True)


def sharded_phase(frames) -> dict:
    """Phase 52: the first SHARD_FRAMES frames with md_low through
    encode_frame, unsharded and with sp_shards 2 and 4 on card_mesh; each
    stream and recon equal the unsharded one's, sp_steps the P pictures,
    one launch each of K1 and K2 per picture, each stream's decode on the
    card equal to its recon; sp_shards 8 (68 MB rows) falls through:
    sp_steps 0, the same bytes. Returns the launches of the sharded
    encodes (sp), of their decodes (sp_decode) and of the fall-through
    (sp_fall_through)."""
    frames = frames[:SHARD_FRAMES]
    n_p = len(frames) - 1
    base, base_enc, _ = framed_encode("unsharded md_low 1080p",
                                       sharded_cfg(1), frames, None)
    rec = _recon(base_enc.results)
    p_ms = statistics.median(base_enc.picture_ms[1:])
    print(f"unsharded md_low 1080p (encode_frame): {sum(map(len, base))} "
          f"stream bytes, P picture {p_ms:.1f} ms (median of {n_p})",
          flush=True)
    out = {"sp": {}, "sp_decode": {}}
    for n in SHARDS + (SHARDS_FALL,):
        mesh = card_mesh(n)
        label = f"sp_shards {n} 1080p"
        payloads, enc, launches = framed_encode(label, sharded_cfg(n),
                                                 frames, mesh)
        want = n_p if (H // 16) % n == 0 else 0
        if enc.sp_steps != want:
            raise AssertionError(f"{label}: sp_steps {enc.sp_steps}, "
                                 f"expected {want}")
        if payloads != base:
            raise AssertionError(f"{label}: payloads differ from the "
                                 f"unsharded stream")
        check_frames([r["frame"] for r in enc.results], rec,
                     f"{label} recon")
        ms = statistics.median(enc.picture_ms[1:])
        print(f"{label} on {[str(d) for d in mesh]}: sp_steps "
              f"{enc.sp_steps}, payloads and recon equal the unsharded "
              f"stream; P picture {ms:.1f} ms (unsharded {p_ms:.1f} ms), "
              f"launches {launches}", flush=True)
        if want:
            out["sp"] = _add(out["sp"], launches)
            out["sp_decode"] = _add(out["sp_decode"], card_decode(
                payloads, enc, f"decode {label}"))
        else:
            out["sp_fall_through"] = launches
    sharded_step_timing(base_enc, frames)
    return out


class GopTimedEncoder(PictureTimedEncoder):
    """The GOP pipeline's encoders in phase 53: each notes in ``gops`` its
    wall seconds from construction to the end of flush, the CUDA graphs
    its I frame captured (0: it replayed the cached ones), its device
    and its sp_steps."""

    gops: list = []

    def __init__(self, *a, **kw):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        super().__init__(*a, **kw)
        self._graphs0 = graph_count()

    def flush(self):
        out = super().flush()
        torch.cuda.synchronize()
        GopTimedEncoder.gops.append({
            "s": time.perf_counter() - self._t0,
            "captured": graph_count() - self._graphs0,
            "device": str(self.device), "sp_steps": self.sp_steps})
        return out


def gop_par_cfg(**kw):
    return EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                         intra_period=GOP_PAR_PERIOD, **kw)


def gop_par_phase(frames) -> dict:
    """Phase 53: the first GOP_PAR_FRAMES frames through
    parallel/gop_pipeline.encode_gops_parallel in each configuration of
    GOP_PAR on card_mesh, against the serial encode_frame stream on the
    card (md_low with sp_shards 1, or device_rd): the same bytes, the
    results in display order with the serial recon, sp_steps the P
    pictures where sharded, one launch each of K1 and K2 per picture;
    each GOP's wall and whether its I frame replayed the cached CUDA
    graphs. Returns its launches (gop_parallel: "gop" is phase
    24's)."""
    from jm_tpu_torch.parallel import gop_pipeline
    frames = frames[:GOP_PAR_FRAMES]
    serial = {}
    for rd in (False, True):
        enc = Encoder(gop_par_cfg(device_rd=rd), device=DEVICE)
        kernels.reset_launches()
        t0 = time.perf_counter()
        data = b"".join(enc.encode_frame(*f) for f in frames) + enc.flush()
        torch.cuda.synchronize()
        check_launches(launch_counts(), len(frames), "serial GOP encode")
        serial[rd] = (data, _recon(enc.results), time.perf_counter() - t0)
        print(f"serial {'device_rd' if rd else 'md_low'} 1080p, intra_period "
              f"{GOP_PAR_PERIOD} (encode_frame): {len(data)} stream bytes, "
              f"{serial[rd][2]:.2f} s", flush=True)
    out = {}
    for label, n_dp, n_sp, kw in GOP_PAR:
        mesh = card_mesh(n_dp * n_sp)
        GopTimedEncoder.gops = []
        gop_pipeline.Encoder = GopTimedEncoder
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            data, results = gop_pipeline.encode_gops_parallel(
                frames, gop_par_cfg(**kw), n_dp=n_dp, n_sp=n_sp,
                devices=mesh)
            torch.cuda.synchronize()
        finally:
            gop_pipeline.Encoder = Encoder
        total_s = time.perf_counter() - t0
        launches = launch_counts()
        check_launches(launches, len(frames), f"GOP {label}")
        want, rec, serial_s = serial[kw["device_rd"]]
        if data != want:
            raise AssertionError(f"GOP {label}: payloads differ from the "
                                 f"serial stream")
        if [r["disp"] for r in results] != list(range(len(frames))):
            raise AssertionError(f"GOP {label}: results out of order")
        check_frames([r["frame"] for r in results], rec, f"GOP {label}")
        gops = GopTimedEncoder.gops
        steps = sum(g["sp_steps"] for g in gops)
        want_steps = len(frames) - len(gops) if kw.get("sp_shards", 1) > 1 \
            else 0
        if steps != want_steps:
            raise AssertionError(f"GOP {label}: sp_steps {steps}, expected "
                                 f"{want_steps}")
        print(f"GOP {label} (n_dp {n_dp}, n_sp {n_sp}) on "
              f"{[str(d) for d in mesh]}: {len(data)} bytes equal the "
              f"serial stream, {total_s:.2f} s (serial {serial_s:.2f} s), "
              f"sp_steps {steps}; " + ", ".join(
                  f"GOP {i} on {g['device']} {g['s']:.2f} s, I frame "
                  + ("replayed the cached graphs" if g["captured"] == 0
                     else f"captured {g['captured']} graphs")
                  for i, g in enumerate(gops))
              + f"; launches {launches}", flush=True)
        out["gop_parallel"] = _add(out.get("gop_parallel", {}), launches)
    return out


def wide_cfg(sr: int):
    return EncoderConfig(width=352, height=288, qp=QP, search_range=sr,
                         pipeline="host")


def wide_tools_sources(d: str, frames) -> str:
    """Phase 54's lencod input in directory d: the CIF frames' YUV file and
    a one-view cfg with SearchRange 32; returns the cfg's path."""
    os.makedirs(d, exist_ok=True)
    src = cif(frames, WIDE_FRAMES)
    with open(os.path.join(d, "wide.yuv"), "wb") as fh:
        for f in src:
            fh.write(b"".join(np.ascontiguousarray(p).tobytes() for p in f))
    with open(os.path.join(d, "wide.cfg"), "w") as fh:
        fh.write(f'''InputFile = "{d}/wide.yuv"
SourceWidth = 352
SourceHeight = 288
FramesToBeEncoded = {WIDE_FRAMES}
QPISlice = {QP}
QPPSlice = {QP}
SearchRange = {max(WIDE_RANGES)}
''')
    return os.path.join(d, "wide.cfg")


def wide_cpu_jobs(pool, frames, tools_dir: str) -> dict:
    """The CPU references of phase 54 (the CIF host streams at each of
    WIDE_RANGES, lencod on wide_tools_sources' cfg), submitted to the
    worker pool; returns their AsyncResults by name."""
    src = cif(frames, WIDE_FRAMES)
    d = os.path.join(tools_dir, "wide")
    jobs = [(f"wide_{sr}", cpu_encode, (wide_cfg(sr), src, True))
            for sr in WIDE_RANGES]
    jobs += [("wide_lencod", cpu_tools,
              (wide_tools_sources(d, frames), os.path.join(d, "cpu")))]
    return {name: pool.apply_async(fn, args, callback=_arrived(name))
            for name, fn, args in jobs}


def wide_phase(frames, cpu_refs, tools_dir: str) -> dict:
    """Phase 54: CIF host-pipeline IPP streams of WIDE_FRAMES frames at
    each of WIDE_RANGES through encode_frame on the card, each equal to
    its CPU run (a worker's), one launch each of K1 and K2 per picture,
    decoded on the card equal to its recon; the host P picture's ms per
    MB against a search range of 16; lencod on a CIF cfg with
    SearchRange 32, then ldecod, on the card: stream, recon and decoded
    YUV equal the CPU run, the decode equal to the recon. Returns the
    launches of the encodes (wide_search) and of the decodes
    (wide_search_decode)."""
    src = cif(frames, WIDE_FRAMES)
    n_mbs = 22 * 18
    out = {"wide_search": {}, "wide_search_decode": {}}
    per_mb = {}
    for sr in (16,) + WIDE_RANGES:
        label = f"CIF host SR {sr}"
        fr = src if sr in WIDE_RANGES else src[:2]
        payloads, enc, launches = framed_encode(label, wide_cfg(sr), fr,
                                                 None)
        per_mb[sr] = statistics.median(enc.picture_ms[1:]) / n_mbs
        print(f"encode {label} (encode_frame, I P{'P' * (len(fr) - 2)}): "
              f"{sum(map(len, payloads))} stream bytes, P pictures "
              + ", ".join(f"{ms:.1f} ms" for ms in enc.picture_ms[1:])
              + f" = {per_mb[sr]:.3f} ms/MB (SR 16: {per_mb[16]:.3f}), "
              f"launches {launches}", flush=True)
        if sr == 16:
            continue
        check_cpu_encode(label, cpu_refs[f"wide_{sr}"], payloads, enc,
                         len(fr))
        out["wide_search"] = _add(out["wide_search"], launches)
        out["wide_search_decode"] = _add(out["wide_search_decode"],
                                         card_decode(payloads, enc,
                                                     f"decode {label}"))
    d = os.path.join(tools_dir, "wide")
    (stream, rec, decoded), steps = run_tools(os.path.join(d, "wide.cfg"),
                                              os.path.join(d, "card"),
                                              DEVICE)
    for (_s, launches), name in zip(steps, ("lencod", "ldecod")):
        check_launches(launches, WIDE_FRAMES, f"{name} SearchRange 32")
    t0 = time.perf_counter()
    want = cpu_refs["wide_lencod"].get()
    for name, a, b in zip(("stream", "recon", "decoded YUV"),
                          (stream, rec, decoded), want):
        if a != b:
            raise AssertionError(f"lencod SearchRange 32: the {name} "
                                 f"differs from the CPU run")
    if decoded != rec:
        raise AssertionError("ldecod SearchRange 32: the decode differs "
                             "from lencod's recon")
    print(f"lencod SearchRange 32 (CIF, {WIDE_FRAMES} frames, the host "
          f"pipeline) {steps[0][0]:.1f} s, {len(stream)} stream bytes, "
          f"launches {steps[0][1]}; ldecod {steps[1][0]:.2f} s, equal to "
          f"the recon, launches {steps[1][1]}; stream, recon and decoded "
          f"YUV equal the CPU run (CPU worker; waited "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    out["wide_search"] = _add(out["wide_search"], steps[0][1])
    out["wide_search_decode"] = _add(out["wide_search_decode"], steps[1][1])
    return out


def parallel_phases(frames, cpu_refs, tools_dir: str) -> dict:
    """Phases 52-54; returns the launches of each path by name: sp,
    sp_decode, sp_fall_through, gop_parallel, wide_search,
    wide_search_decode."""
    out = sharded_phase(frames)
    out.update(gop_par_phase(frames))
    out.update(wide_phase(frames, cpu_refs, tools_dir))
    return out


TOOLS_FRAMES = 3          # frames of phase 55's CIF bdrate / TIFF streams
TOOLS_QPS = (24, 28, 32, 36)   # phase 55 (b)'s QP ladder
TOOLS_PRESETS = ("fast", "fast_rd")
# phase 55 (a)'s trace: phase 3's SPS, PPS, IDR and first P picture (the
# IDR reconstructed when the P starts)
TRACE_NALUS = 4
RTP_LOSS = ("20", "2", "--seed", "7")   # phase 55 (d): loss %, kept, seed


def trace_run(data: bytes, device: str) -> tuple:
    """Phase 55 (a)'s path: the trace of data's first TRACE_NALUS NAL
    units on device; returns (text, wall seconds)."""
    from jm_tpu_torch.tools import trace
    t0 = time.perf_counter()
    text = trace.trace_stream(data, max_nalus=TRACE_NALUS, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    return text, time.perf_counter() - t0


def bdrate_run(frames, device: str) -> tuple:
    """Phase 55 (b)'s path: tools.bdrate.run_ours of the first
    TOOLS_FRAMES CIF frames at each of TOOLS_QPS under each of
    TOOLS_PRESETS on device; returns the (bits, PSNR) pairs by preset
    and the wall seconds of each call."""
    from jm_tpu_torch.tools import bdrate
    src = cif(frames, TOOLS_FRAMES)
    out, secs = {p: [] for p in TOOLS_PRESETS}, []
    for p in TOOLS_PRESETS:
        for qp in TOOLS_QPS:
            t0 = time.perf_counter()
            out[p].append(bdrate.run_ours(src, 352, 288, qp, p,
                                          device=device))
            if device != "cpu":
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    return out, secs


def tiff_frames(frames, d: str):
    """Phase 55 (c)'s source: the first TOOLS_FRAMES CIF frames written
    as RGB TIFF files into d (imgio.yuv420_to_rgb, write_tiff) and read
    back as 4:2:0 frames (read_tiff_sequence). The sequence's chroma
    planes are copies of its luma, around 226: each is moved to a mean
    of 128 first, else the RGB saturates and the pictures come back
    nearly flat."""
    from jm_tpu_torch.tools import imgio
    os.makedirs(d, exist_ok=True)
    for i, (Y, U, V) in enumerate(cif(frames, TOOLS_FRAMES)):
        U, V = (np.clip(p.astype(np.int16) - int(p.mean()) + 128, 0,
                        255).astype(np.uint8) for p in (U, V))
        imgio.write_tiff(os.path.join(d, f"f{i:03d}.tif"),
                         imgio.yuv420_to_rgb(Y, U, V))
    return imgio.read_tiff_sequence(os.path.join(d, "f%03d.tif"),
                                    TOOLS_FRAMES)


def tiff_cfg():
    return EncoderConfig(width=352, height=288, qp=QP)


def rtp_run(data: bytes, d: str, device: str) -> tuple:
    """Phase 55 (d)'s path in directory d: data packed into an RTP dump
    (bitstream/rtp.annexb_to_rtp), tools.rtp_loss with RTP_LOSS, then
    tools.rtpdump on the lossy dump, and the lossy stream decoded with
    conceal_mode=1 on device; returns (rtp_loss's lines, the packets
    rtpdump reports, the decoded (Y, U, V) frames, the concealed count)."""
    import contextlib
    import io
    from jm_tpu_torch.bitstream.rtp import annexb_to_rtp, rtp_to_annexb
    from jm_tpu_torch.tools import rtp_loss, rtpdump
    os.makedirs(d, exist_ok=True)
    src, dst = os.path.join(d, "in.rtp"), os.path.join(d, "lossy.rtp")
    with open(src, "wb") as fh:
        fh.write(annexb_to_rtp(data))
    report = []
    for main, argv in ((rtp_loss.main, [src, dst, *RTP_LOSS]),
                       (rtpdump.main, [dst])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        if rc != 0:
            raise AssertionError(f"{main.__module__} {argv}: exit code {rc}")
        report.append(buf.getvalue())
    with open(dst, "rb") as fh:
        lossy = rtp_to_annexb(fh.read())
    dec = H264Decoder(device=device, conceal_mode=1)
    out = dec.decode_annexb(lossy)
    if device != "cpu":
        torch.cuda.synchronize()
    return (report[0].splitlines(), report[1].count("packet #"),
            [(f.Y, f.U, f.V) for f in out], dec.concealed_count)


def cpu_tiff_rtp(frames, d: str) -> tuple:
    """Phase 55 (c) and (d)'s CPU reference in directory d: the TIFF
    stream's payloads and scene-cut fallbacks, and rtp_run's result, on
    the CPU."""
    enc = Encoder(tiff_cfg(), device="cpu")
    payloads = enc.encode_stream(tiff_frames(frames, d))
    return payloads, enc.fallbacks, rtp_run(b"".join(payloads), d, "cpu")


def tools_cpu_jobs(pool, frames, payloads, tools_dir: str) -> dict:
    """The CPU references of phase 55, submitted to the worker pool (a
    full run: after phase 39, with phase 3's payloads); returns their
    AsyncResults by name."""
    d = os.path.join(tools_dir, "tools", "cpu")
    jobs = [("tools_trace", trace_run, (b"".join(payloads[:2]), "cpu")),
            ("tools_bdrate", bdrate_run, (frames[:TOOLS_FRAMES], "cpu")),
            ("tools_tiff_rtp", cpu_tiff_rtp, (frames[:TOOLS_FRAMES], d))]
    return {name: pool.apply_async(fn, args, callback=_arrived(name))
            for name, fn, args in jobs}


def tools_phase(frames, payloads, cpu_refs, tools_dir: str) -> dict:
    """Phase 55: the port's host tools on the card, each against its CPU
    run (a worker's): (a) the trace of phase 3's first TRACE_NALUS NAL
    units, (b) bdrate.run_ours of CIF frames over TOOLS_QPS for
    TOOLS_PRESETS, with the BD-rate / BD-PSNR of fast_rd against fast,
    (c) CIF frames through RGB TIFF files encoded on the card, (d) that
    stream through rtp_loss / rtpdump and decoded with concealment.
    Returns each path's kernel launches (tools_trace, tools_bdrate,
    tools_tiff, tools_rtp)."""
    import hashlib
    from jm_tpu_torch.tools import bdrate
    out = {}
    # (a) the trace: its Python parse, the recon and deblock on the card
    kernels.reset_launches()
    text, card_s = trace_run(b"".join(payloads[:2]), DEVICE)
    out["tools_trace"] = launch_counts()
    # the trace reconstructs each picture once the next one starts: the
    # last one is parsed, never finished (as in jm_tpu's trace)
    n_done = TRACE_NALUS - 3
    check_launches(out["tools_trace"], n_done, "trace")
    if "!! parse stopped" in text or text.count("== NALU") != TRACE_NALUS:
        raise AssertionError("trace: the parse stopped or NAL units missing")
    t0 = time.perf_counter()
    want, cpu_s = cpu_refs["tools_trace"].get()
    if text != want:
        raise AssertionError("trace: the card's text differs from the CPU "
                             "run's")
    print(f"trace of phase 3's first {TRACE_NALUS} NAL units (IDR + P, "
          f"{n_done} reconstructed): {len(text.splitlines())} lines, sha256 "
          f"{hashlib.sha256(text.encode()).hexdigest()}, card "
          f"{card_s:.2f} s (CPU worker {cpu_s:.2f} s), equal to the CPU "
          f"run (waited {time.perf_counter() - t0:.1f} s), launches "
          f"{out['tools_trace']}", flush=True)
    # (b) bdrate.run_ours on the device routes
    kernels.reset_launches()
    bd, secs = bdrate_run(frames[:TOOLS_FRAMES], DEVICE)
    out["tools_bdrate"] = launch_counts()
    check_launches(out["tools_bdrate"], len(TOOLS_PRESETS) * len(TOOLS_QPS)
                   * TOOLS_FRAMES, "bdrate run_ours")
    if bd != cpu_refs["tools_bdrate"].get()[0]:
        raise AssertionError("bdrate: the card's (bits, PSNR) differ from "
                             "the CPU run's")
    (rf, pf), (rr, pr) = (zip(*bd[p]) for p in TOOLS_PRESETS)
    print(f"bdrate run_ours (CIF, {TOOLS_FRAMES} frames, QPs {TOOLS_QPS}) "
          f"{sum(secs):.2f} s (each call " + ", ".join(
              f"{t:.2f}" for t in secs) + " s): " + "; ".join(
              f"{p} " + ", ".join(f"{b} bits {q:.4f} dB" for b, q in bd[p])
              for p in TOOLS_PRESETS)
          + f"; equal to the CPU run; BD-rate fast_rd vs fast "
          f"{bdrate.bd_rate(rf, pf, rr, pr):+.4f} %, BD-PSNR "
          f"{bdrate.bd_psnr(rf, pf, rr, pr):+.4f} dB, launches "
          f"{out['tools_bdrate']}", flush=True)
    # (c) TIFF files encoded on the card
    d = os.path.join(tools_dir, "tools", "card")
    src = tiff_frames(frames[:TOOLS_FRAMES], d)
    kernels.reset_launches()
    t0 = time.perf_counter()
    enc = Encoder(tiff_cfg(), device=DEVICE)
    tiff_payloads = enc.encode_stream(src)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    out["tools_tiff"] = launch_counts()
    # one launch a frame, one more for each scene-cut fallback's mixed
    # deblock and each re-dispatched next frame (phase 9)
    check_launches(out["tools_tiff"], TOOLS_FRAMES + len(enc.fallbacks)
                   + enc.redispatches, "TIFF encode")
    cpu_payloads, cpu_fallbacks, (lost, n_packets, frames_cpu,
                                  concealed) = cpu_refs["tools_tiff_rtp"].get()
    if tiff_payloads != cpu_payloads or enc.fallbacks != cpu_fallbacks:
        raise AssertionError("TIFF encode: the card's payloads or fallbacks "
                             "differ from the CPU run's")
    print(f"TIFF sequence (CIF, {TOOLS_FRAMES} frames, RGB through "
          f"yuv420_to_rgb / write_tiff / read_tiff_sequence) encoded on the "
          f"card in {card_s:.2f} s: {sum(map(len, tiff_payloads))} bytes, "
          f"equal to the CPU run, fallbacks at frames {enc.fallbacks}, "
          f"{enc.redispatches} re-dispatches, launches {out['tools_tiff']}",
          flush=True)
    # (d) rtp_loss, rtpdump and the concealed decode on the card
    kernels.reset_launches()
    got = rtp_run(b"".join(tiff_payloads), d, DEVICE)
    out["tools_rtp"] = launch_counts()
    if got[:2] != (lost, n_packets) or got[3] != concealed:
        raise AssertionError("rtp_loss / rtpdump: the card's run differs "
                             "from the CPU run's")
    check_frames([SimpleNamespace(Y=y, U=u, V=v) for y, u, v in got[2]],
                 frames_cpu, "RTP loss decode")
    decoded = len(got[2]) - concealed
    if not lost or not concealed or len(got[2]) != TOOLS_FRAMES:
        raise AssertionError(f"RTP loss: {lost}, {concealed} concealed of "
                             f"{len(got[2])} frames")
    check_launches(out["tools_rtp"], decoded, "RTP loss decode")
    print(f"rtp_loss {' '.join(RTP_LOSS)}: {'; '.join(lost)}; rtpdump "
          f"{n_packets} packets; decoded on the card with conceal_mode=1: "
          f"{len(got[2])} frames ({concealed} concealed) equal to the CPU "
          f"run, launches {out['tools_rtp']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 56: the decoder's last gaps against jm_tpu: field pictures at 4:2:2
# and above 8 bits, concealment of 4:2:2 and >8-bit pictures
# ---------------------------------------------------------------------------

Y422_FIELD_PICTURES = 4   # phase 56 (b): 352x144 4:2:2 pictures, 2 CIF frames


def rewritten_slice(nal, sps_map: dict, pps_map: dict, sps, **header) -> bytes:
    """The RBSP of slice NAL unit nal with its header written again under
    sps by the port's write_slice_header, the keywords header changed,
    its slice data kept bit for bit (tests/torch_streams.rewritten_slice
    is its test twin)."""
    from jm_tpu_torch.bitstream.bitwriter import BitWriter
    from jm_tpu_torch.decoder.header import parse_slice_header
    from jm_tpu_torch.encoder.syntax import write_slice_header
    h, br = parse_slice_header(nal, sps_map, pps_map)
    p = pps_map[h.pic_parameter_set_id]
    kw = dict(slice_type=h.slice_type, frame_num=h.frame_num,
              idr=h.is_idr, idr_pic_id=h.idr_pic_id, qp=h.qp(p),
              first_mb=h.first_mb_in_slice, poc_lsb=h.pic_order_cnt_lsb,
              num_ref_idx_l0=h.num_ref_idx_l0_active_minus1 + 1)
    kw.update(header)
    bw = BitWriter()
    write_slice_header(bw, sps, p, **kw)
    bits = np.unpackbits(np.frombuffer(nal.rbsp, np.uint8))
    stop = len(bits) - 1 - int(np.argmax(bits[::-1]))
    rest = bits[br.pos:stop]
    bw.append_bitstream(np.packbits(rest).tobytes(), len(rest))
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def reframed_fields(data: bytes) -> bytes:
    """A PAFF stream made of a stream of frame pictures: the SPS written
    again with frame_mbs_only_flag 0, mb_adaptive_frame_field_flag 0 and
    direct_8x8_inference_flag 1 (pic_height_in_map_units_minus1 kept: each
    W x H/2 picture becomes one field of a W x H frame), the k-th
    picture's slice headers written again as a field's (top for even k),
    frame_num k // 2, pic_order_cnt_lsb k, one active reference, the slice
    data kept bit for bit. The port's field coder is 4:2:0 only, as
    jm_tpu's: this makes 4:2:2 field streams of its 4:2:2 frame coders
    (tests/torch_streams.reframed_fields is its test twin)."""
    from jm_tpu_torch.bitstream.nal import (NalUnitType, annexb_bytes,
                                            split_annexb)
    from jm_tpu_torch.decoder.header import parse_slice_header
    from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
    from jm_tpu_torch.encoder.syntax import write_sps
    out, sps_map, pps_map, fields = [], {}, {}, {}
    k, last = -1, None
    for nal in split_annexb(data):
        rbsp = nal.rbsp
        t = nal.nal_unit_type
        if t == NalUnitType.SPS:
            s = parse_sps(rbsp)
            sps_map[s.seq_parameter_set_id] = s
            f = parse_sps(rbsp)
            f.frame_mbs_only_flag = 0
            f.mb_adaptive_frame_field_flag = 0
            f.direct_8x8_inference_flag = 1
            fields[f.seq_parameter_set_id] = f
            rbsp = write_sps(f)
        elif t == NalUnitType.PPS:
            p = parse_pps(rbsp, sps_map)
            pps_map[p.pic_parameter_set_id] = p
        elif t in (NalUnitType.SLICE, NalUnitType.IDR):
            h, _ = parse_slice_header(nal, sps_map, pps_map)
            key = (h.frame_num, h.pic_order_cnt_lsb, h.is_idr)
            if key != last:
                k, last = k + 1, key
            rbsp = rewritten_slice(
                nal, sps_map, pps_map,
                fields[pps_map[h.pic_parameter_set_id].seq_parameter_set_id],
                field_pic=1, bottom_field=k % 2, frame_num=k // 2,
                poc_lsb=k, num_ref_idx_l0=1)
        out.append(annexb_bytes(nal.nal_ref_idc, t, rbsp))
    return b"".join(out)


def y422_field_cfg():
    """Phase 56 (b)'s pictures: 352x144 (a CIF field), 4:2:2 on the host
    coders, QP 28, SR 16."""
    return EncoderConfig(width=352, height=144, qp=QP, search_range=16,
                         chroma_format=2)


def conceal_422_cfg():
    """Phase 56 (c)'s 4:2:2 CIF stream: 4 slices of 99 MBs a picture, as
    phase 48's (every 4:2:2 picture on the host coders)."""
    return EncoderConfig(width=352, height=288, qp=QP, search_range=16,
                         chroma_format=2, slice_mode=1, slice_argument=99)


def path_counts(crows: int, bd: int):
    """The launch counter reader of a path of chroma format crows (2
    4:2:0, 4 4:2:2) and bit depth bd: launch_counts or hbd_launch_counts,
    each failing on another kernel's launch."""
    if bd > 8:
        return lambda: hbd_launch_counts(crows)
    return lambda: launch_counts(crows == 4)


def gap_decode(data: bytes, cpu_job, label: str, crows: int, bd: int,
               n_fields: int) -> dict:
    """One field stream of phase 56 decoded on the card with the launch and
    route counters reset just before: every frame equal to the CPU
    worker's decode of the same bytes (cpu_job), one launch of each kernel
    of its format and bit depth per field picture; frames/s and each
    field's parse / host intra recon / device split. Returns the
    launches."""
    dec = H264Decoder(device=DEVICE)
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    out = dec.decode_annexb(data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = path_counts(crows, bd)()
    if len(dec.pictures) != n_fields or len(out) != n_fields // 2:
        raise AssertionError(f"{label}: {len(dec.pictures)} pictures, "
                             f"{len(out)} frames")
    check_launches(launches, n_fields, label)
    if bd > 8 and (out[0].Y.dtype != np.uint16 or
                   int(max(f.Y.max() for f in out)) < 256):
        raise AssertionError(f"{label}: not {bd}-bit planes")
    t1 = time.perf_counter()
    check_frames(out, cpu_job.get(), f"{label} against the CPU decode")
    print(f"decode {label} ({len(data)} B) on the card: {len(out)} frames "
          f"({n_fields} field pictures of {out[0].Y.shape[1] // 16}x"
          f"{out[0].Y.shape[0] // 32} MBs, chroma {out[0].U.shape}, "
          f"{out[0].Y.dtype}) equal the CPU decode (CPU worker; waited "
          f"{time.perf_counter() - t1:.1f} s); {len(out) / dt:.3f} frames/s;"
          f" per field " + ", ".join(
              f"{p['type'][0]}/{p['path']} {p['seconds'] * 1e3:.1f} ms "
              f"(parse {p['parse_s'] * 1e3:.1f}, intra recon "
              f"{p['host_recon_s'] * 1e3:.1f}, device "
              f"{p['device_s'] * 1e3:.1f})" for p in dec.pictures)
          + f"; launches {launches} = "
          + ", ".join(f"{v / n_fields:g}" for v in launches.values())
          + " per field picture", flush=True)
    return launches


def gap_cpu_job(pool, name: str, fn, data: bytes):
    """A CPU decode of phase 56 (fn: cpu_decode or cpu_conceal_decode of
    data) submitted to pool; returns its AsyncResult."""
    return pool.apply_async(fn, (data,), callback=_arrived(name))


def gap_phase(frames, field_payloads, cif_payloads, pool, jobs) -> dict:
    """Phase 56: field pictures at 4:2:2 and above 8 bits and concealment
    of 4:2:2 and >8-bit pictures, as jm_tpu decodes them, on the card,
    each decode equal to a CPU worker's decode of the same bytes with
    the same concealed_count: (a) phase 44's 1080p field pair
    under a High 10 SPS (K1-HBD and K2-HBD at the 1080p field shape);
    (b) Y422_FIELD_PICTURES 352x144 4:2:2 pictures encoded on the card
    (the host coders) and re-framed as the fields of 2 CIF frames
    (reframed_fields), at 8 bits (K1 and K2-422) and under a 10-bit
    profile-122 SPS (K1-HBD and K2-422-HBD); (c) phase 48's lossy CIF
    stream under a High 10 SPS, and a 4:2:2 CIF stream of 4 slices a
    picture encoded on the card with the same losses (lossy_cif), each in
    conceal_mode 1 and 2. jobs: the CPU decodes of (a) and of (c)'s 10-bit
    stream, submitted when their bytes were made (gap_a, gap_c10); the
    others go to pool here. Returns the launches by path."""
    out = {}
    # the streams the card encodes first, so that their CPU decodes run
    # while the card decodes (a) and (c) at 10 bits
    t0 = time.perf_counter()
    enc, y422_payloads, enc_launches, _ = timed_encode(
        y422_field_cfg(), to_422([tuple(p[:p.shape[0] // 2] for p in f)
                                  for f in cif(frames, Y422_FIELD_PICTURES)]))
    check_launches(enc_launches, Y422_FIELD_PICTURES,
                   "4:2:2 CIF fields encode")
    y8 = reframed_fields(b"".join(y422_payloads))
    y10 = reheaded(y8, 122, 10)
    jobs["gap_b8"] = gap_cpu_job(pool, "gap_b8", cpu_decode, y8)
    jobs["gap_b10"] = gap_cpu_job(pool, "gap_b10", cpu_decode, y10)
    enc422, c422_payloads, c422_launches, _ = timed_encode(
        conceal_422_cfg(), to_422(cif(frames, CONCEAL_CIF_FRAMES)))
    check_launches(c422_launches, CONCEAL_CIF_FRAMES, "4:2:2 conceal CIF "
                   "encode")
    lossy422 = lossy_cif(c422_payloads)
    jobs["gap_c422"] = gap_cpu_job(pool, "gap_c422", cpu_conceal_decode,
                                   lossy422)
    out["gap_y422_field_cif"] = enc_launches
    out["gap_y422_conceal_cif"] = c422_launches
    print(f"phase 56 encodes on the card: {Y422_FIELD_PICTURES} 352x144 "
          f"4:2:2 pictures ({sum(map(len, y422_payloads))} B) and "
          f"{CONCEAL_CIF_FRAMES} CIF 4:2:2 pictures of 4 slices "
          f"({sum(map(len, c422_payloads))} B), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # (a) the 1080p field pair at 10 bits
    out["gap_field10_1080p_decode"] = gap_decode(
        reheaded(b"".join(field_payloads), 110, 10), jobs["gap_a"],
        "High 10 1080p field pair", 2, 10, 2)
    # (c) the CIF lossy stream at 10 bits
    for mode, gl in conceal_decode(
            reheaded(lossy_cif(cif_payloads), 110, 10),
            jobs["gap_c10"].get(), "conceal CIF High 10",
            path_counts(2, 10)).items():
        out[f"gap_conceal10_cif_m{mode}_decode"] = gl
    # (b) the 4:2:2 CIF fields at 8 and 10 bits
    out["gap_y422_field_cif_decode"] = gap_decode(
        y8, jobs["gap_b8"], "4:2:2 CIF fields", 4, 8, Y422_FIELD_PICTURES)
    out["gap_y422_10_field_cif_decode"] = gap_decode(
        y10, jobs["gap_b10"], "4:2:2 10-bit CIF fields", 4, 10,
        Y422_FIELD_PICTURES)
    # (c) the 4:2:2 lossy CIF stream
    for mode, gl in conceal_decode(lossy422, jobs["gap_c422"].get(),
                                   "conceal CIF 4:2:2",
                                   path_counts(4, 8)).items():
        out[f"gap_conceal422_cif_m{mode}_decode"] = gl
    return out


def gap_early_jobs(hbd_pool, field_payloads=None, cif_payloads=None) -> dict:
    """Phase 56's CPU decodes whose bytes exist before it, submitted to
    hbd_pool as soon as phases 44 and 48 made them: (a) the 1080p field
    pair under a High 10 SPS (gap_a), (c) phase 48's lossy CIF stream under
    a High 10 SPS in both modes (gap_c10)."""
    jobs = {}
    if field_payloads is not None:
        jobs["gap_a"] = gap_cpu_job(
            hbd_pool, "gap_a", cpu_decode,
            reheaded(b"".join(field_payloads), 110, 10))
    if cif_payloads is not None:
        jobs["gap_c10"] = gap_cpu_job(
            hbd_pool, "gap_c10", cpu_conceal_decode,
            reheaded(lossy_cif(cif_payloads), 110, 10))
    return jobs


def later_phases(frames, rd_fps, cpu_refs):
    """Phases 18-21 with the CPU references cpu_refs; returns the
    launches of each of their paths by name (resilient, redundant,
    deblock_off, each also with _decode)."""
    out = {}
    for name, phase in (("resilient", resilient_phase),
                        ("redundant", redundant_phase)):
        out[name], out[f"{name}_decode"] = phase(frames, cpu_refs[name])
    out["deblock_off"], out["deblock_off_decode"] = deblock_off_phase(
        frames, rd_fps)
    dp_golden_phase(cpu_refs)
    return out


def cpu_pool(workers: int = CPU_WORKERS):
    """The worker processes of the CPU references (spawned: this process
    holds the card and threads)."""
    import multiprocessing
    return multiprocessing.get_context("spawn").Pool(
        workers, initializer=_worker_init)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build, with the CPU references of the later phases started in
    # the worker pool meanwhile --------------------------------------------
    clock = PhaseClock()
    native.load()
    print(f"native runtime build (g++, three sources) + import: "
          f"{native.build_seconds:.1f} s", flush=True)
    partial = sys.argv[1:] in (["--from", "18"], ["--from", "22"],
                               ["--from", "25"], ["--from", "28"],
                               ["--from", "31"], ["--from", "34"],
                               ["--from", "37"], ["--from", "40"],
                               ["--from", "43"], ["--from", "46"],
                               ["--from", "49"], ["--from", "52"],
                               ["--from", "55"], ["--from", "56"])
    first = int(sys.argv[2]) if partial else 4
    frames = make_sequence()
    pool = cpu_pool()
    # one more worker for the CPU decodes of phases 27 and 41, which can
    # start only once their streams are made (a job of the pool above
    # would queue behind all of its references); idle until then
    hbd_pool = cpu_pool(1)
    # phase 51's sources, cfg files and the runs' outputs (card, cpu)
    tools_dir = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        refs = start_cpu_references(pool, frames, first, tools_dir)
        kernels.load()
        print(f"kernel build: {kernels.build_seconds:.1f} s", flush=True)
        clock.lap("1")
        if partial:
            return partial_run(frames, pool, hbd_pool, refs, first, clock,
                               tools_dir)
        return full_run(frames, pool, hbd_pool, refs, smi, clock, tools_dir)
    finally:
        for p in (pool, hbd_pool):
            p.terminate()
            p.join()
        shutil.rmtree(tools_dir, ignore_errors=True)


def hbd_cpu_jobs(hbd_pool, payloads=None, y422_payloads=None) -> dict:
    """Phase 41's CPU decodes, submitted to hbd_pool: the re-headed 1080p
    High 10 stream (payloads: phase 3's; a full run submits it after
    phase 33, when most references have left the cores) and the
    re-headed 10-bit CIF 4:2:2 stream (y422_payloads: phase 38's CIF
    (a)); returns the jobs by name."""
    jobs = {}
    if payloads is not None:
        jobs["hbd_1080p"] = hbd_pool.apply_async(cpu_decode, (reheaded(
            b"".join(payloads[:HBD_FRAMES]), 110, 10),),
            callback=_arrived("hbd_1080p"))
    if y422_payloads is not None:
        jobs["hbd_422"] = hbd_pool.apply_async(cpu_decode, (reheaded(
            b"".join(y422_payloads), 122, 10),), callback=_arrived("hbd_422"))
    return jobs


def partial_run(frames, pool, hbd_pool, refs, first: int, clock,
                tools_dir: str) -> int:
    """Phases first..56 (18, 22, 25, 28, 31, 34, 37, 40, 43, 46, 49, 52,
    55 or 56) without the closing JSON lines; refs: their CPU references;
    clock: the PhaseClock of the run; tools_dir: phase 51's and 54's
    directory. From 40, phase 3's first HBD_FRAMES pictures and phase 38's
    CIF stream (a) are encoded on the card first; from 46, phase 3's
    first CONCEAL_1080P pictures; from 47, phase 56 encodes phase 44's
    1080p field pair and phase 48's CIF stream itself."""
    if first <= 18:
        later_phases(frames, None, refs)
        clock.lap("18-21")
    if first <= 22:
        b_phases(frames, refs)
        clock.lap("22-24")
    if first <= 25:
        wp_phases(frames, refs, hbd_pool)
        clock.lap("25-27")
    if first <= 28:
        high_phases(frames, refs, pool, None)
        clock.lap("28-30")
    if first <= 31:
        motion_phases(frames, refs, pool, None)
        clock.lap("31-33")
    if first <= 34:
        rd_phases(frames, refs, pool)
        clock.lap("34-36")
    if first <= 37:
        y422_cif_a = y422_phases(frames, refs, pool,
                                 np.random.default_rng(37))[2]
        refs.update(sp_cpu_jobs(pool, frames))
        refs.update(mvc_cpu_jobs(pool, frames, tools_dir))
        refs.update(wide_cpu_jobs(pool, frames, tools_dir))
        clock.lap("37-39")
    elif first <= 40:
        y422_cif_a = b_encode(y422_cif_cfg(Y422_CIF[0][2]),
                              to_422(cif(frames, Y422_CIF[0][1])))[1]
    if first <= 40:
        payloads = Encoder(rd_cfg(), device=DEVICE).encode_stream(
            frames[:HBD_FRAMES])
        jobs = hbd_cpu_jobs(hbd_pool, payloads, y422_cif_a)
        hbd_phases(payloads, y422_cif_a, jobs, np.random.default_rng(40))
        clock.lap("40-42")
    field_payloads = conceal_cif = None
    gap_jobs = {}
    if first <= 43:
        field_payloads = field_phases(frames, refs,
                                      np.random.default_rng(43))[2]
        gap_jobs.update(gap_early_jobs(hbd_pool,
                                       field_payloads=field_payloads))
        clock.lap("43-45")
    if first <= 46:
        payloads = Encoder(rd_cfg(), device=DEVICE).encode_stream(
            frames[:CONCEAL_1080P])
        conceal_job = conceal_cpu_job(hbd_pool, payloads)
        sp_phases(frames, refs, np.random.default_rng(46))
        clock.lap("46-47")
        conceal_cif = conceal_phase(payloads, cif(frames, CONCEAL_CIF_FRAMES),
                                    refs, conceal_job)[1]
        gap_jobs.update(gap_early_jobs(hbd_pool, cif_payloads=conceal_cif))
        clock.lap("48")
    if first <= 49:
        mvc_phases(frames, refs, tools_dir)
        clock.lap("49-51")
    if first <= 52:
        parallel_phases(frames, refs, tools_dir)
        clock.lap("52-54")
    if first <= 55:
        payloads = Encoder(rd_cfg(), device=DEVICE).encode_stream(frames[:2])
        refs.update(tools_cpu_jobs(pool, frames, payloads, tools_dir))
        tools_phase(frames, payloads, refs, tools_dir)
        clock.lap("55")
    if field_payloads is None:
        field_payloads = Encoder(field_cfg(), device=DEVICE).encode_stream(
            frames[:1])
        gap_jobs.update(gap_early_jobs(hbd_pool,
                                       field_payloads=field_payloads))
    if conceal_cif is None:
        conceal_cif = Encoder(conceal_cif_cfg(), device=DEVICE).encode_stream(
            cif(frames, CONCEAL_CIF_FRAMES))
        gap_jobs.update(gap_early_jobs(hbd_pool, cif_payloads=conceal_cif))
    gap_phase(frames, field_payloads, conceal_cif, pool, gap_jobs)
    clock.lap("56")
    clock.report()
    print(f"phases {first}-56 passed (partial run: no closing lines)")
    return 0


def conceal_cpu_job(hbd_pool, payloads):
    """Phase 48's CPU decodes of the lossy 1080p stream (phase 3's first
    CONCEAL_1080P pictures, picture 3 dropped), submitted to hbd_pool."""
    return hbd_pool.apply_async(cpu_conceal_decode, (b"".join(
        payloads[:3] + payloads[4:CONCEAL_1080P]),),
        callback=_arrived("conceal_1080p"))


class PhaseClock:
    """Wall seconds of each group of phases, from the end of the one
    before (the first from the clock's start), with the CPU seconds of
    this process (all its threads) over the same span: about one CPU
    second per wall second where the host coders set the pace."""

    def __init__(self):
        self.start = time.perf_counter()
        self.t0, self.laps = self.start, []
        self.cpu0 = time.process_time()

    def lap(self, phases: str) -> None:
        t, cpu = time.perf_counter(), time.process_time()
        self.laps.append((phases, t - self.t0, cpu - self.cpu0))
        self.t0, self.cpu0 = t, cpu

    def report(self) -> None:
        print("phase times: " + ", ".join(
            f"{p} {s:.1f} s" for p, s, _c in self.laps), flush=True)
        print("phase CPU (this process's CPU s): " + ", ".join(
            f"{p} {c:.1f} s" for p, _s, c in self.laps), flush=True)
        if CPU_DONE:
            print("CPU references arrived at (s from the clock's start): "
                  + ", ".join(f"{k} {t - self.start:.1f}" for k, t in
                              sorted(CPU_DONE.items(), key=lambda kv: kv[1])),
                  flush=True)


def full_run(frames, pool, hbd_pool, cpu_refs, smi: str, clock,
             tools_dir: str) -> int:
    """Phases 2-55 and the closing lines; cpu_refs: the CPU references of
    phases 4-55; hbd_pool: the worker of phase 41's and phase 48's CPU
    decodes; clock: the PhaseClock of the run, its first lap the builds;
    tools_dir: phase 51's and 54's directory."""
    # ---- 2. kernels against their plain versions ------------------------
    mb_w, mb_h = W // 16, H // 16
    rng = np.random.default_rng(1)
    kstats = {}
    max_err = {"deblock_luma": 0, "deblock_chroma": 0}
    cases = [(W, H, v, 1) for v in ("mixed", "disable2", "plain")]
    cases += [(*UHD, "mixed", 1)] + [(w, h, v, 1) for w, h, v in EDGE_SHAPES]
    cases += [(W, H, "mixed", REPEATS)]
    for w, h, variant, repeats in cases:
        case, err_y, err_c, changed, plain_ms = check_case(rng, w, h,
                                                           variant, repeats)
        max_err["deblock_luma"] = max(max_err["deblock_luma"], err_y)
        max_err["deblock_chroma"] = max(max_err["deblock_chroma"], err_c)
        if h >= H and min(changed) == 0:
            raise AssertionError(f"deblock {w}x{h} {variant}: a plane "
                                 f"unfiltered")
    # times on the last case: the main path's shapes, mixed parameters
    Y, U, V, bs_v, bs_h, per_mb, cb, cr = case
    args = (bs_v, bs_h, *per_mb)
    zbs = torch.zeros_like(bs_v)
    zargs = (zbs, zbs, *per_mb)
    lines_y, lines_c = filtered_lines(bs_v, bs_h, per_mb, mb_w, mb_h)
    n = mb_w * mb_h
    param_bytes = 6 * 4 * n + 2 * bs_v.numel()
    bytes_y = 2 * Y.numel() + param_bytes
    bytes_c = 2 * (U.numel() + V.numel()) + param_bytes + 2 * 52 * 4
    # the plain versions' ms: their checking call on this case
    for name, b, ops, kfn, zfn, p_ms in (
            ("deblock_luma", bytes_y, LUMA_LINE_OPS * lines_y,
             lambda: kernels.deblock_luma(Y, *args, mb_w=mb_w, mb_h=mb_h),
             lambda: kernels.deblock_luma(Y, *zargs, mb_w=mb_w, mb_h=mb_h),
             plain_ms[0]),
            ("deblock_chroma", bytes_c, CHROMA_LINE_OPS * lines_c,
             lambda: kernels.deblock_chroma(U, V, *args, cb, cr,
                                            mb_w=mb_w, mb_h=mb_h),
             lambda: kernels.deblock_chroma(U, V, *zargs, cb, cr,
                                            mb_w=mb_w, mb_h=mb_h),
             plain_ms[1])):
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        kstats[name] = {
            "ms": cuda_ms(kfn, inner=20), "chain_ms": cuda_ms(zfn, inner=20),
            "single_ms": cuda_ms(kfn),
            "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": b, "ops": ops}
    for name, s in kstats.items():
        print(f"{name}: {s['ms']:.4f} ms (one call alone: {s['single_ms']:.4f}"
              f" ms; all bS 0: {s['chain_ms']:.4f} ms; plain "
              f"{s['plain_ms']:.1f} ms), bound {s['bound_ms'] * 1e3:.2f}"
              f" us ({s['bound_by']}: {s['bytes']} B, {s['ops']} int ops), "
              f"1 launch/frame", flush=True)
    chain_steps(rng)
    clock.lap("2")

    # ---- 3. encode -----------------------------------------------------
    cfg = EncoderConfig(width=W, height=H, qp=QP, search_range=16,
                        device_rd=True)
    Encoder(cfg, device="cuda").encode_stream(frames[:2])      # warm-up
    torch.cuda.synchronize()
    enc = IdrTimedEncoder(cfg, device="cuda")
    kernels.reset_launches()
    native.reset_routes()
    t0 = time.perf_counter()
    payloads = enc.encode_stream(frames)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    check_routes("encode 1080p", serialize=1 + len(enc.ovf))
    idr_s = enc.idr_seconds
    rd_fps = N_FRAMES / total_s
    n_p = N_FRAMES - 1
    p_ms = (total_s - idr_s) / n_p * 1e3
    types = "".join(r["type"] for r in enc.results)
    print(f"encode 1080p {types}: {N_FRAMES / total_s:.2f} frames/s, "
          f"{total_s * 1e3 / N_FRAMES:.1f} ms/frame (IDR {idr_s * 1e3:.1f} "
          f"ms, P {p_ms:.1f} ms avg), {sum(map(len, payloads))} stream "
          f"bytes, launches {launches}; {len(enc.ovf)} P frames serialized "
          f"on the host (packer overflow)", flush=True)
    if len(payloads) != N_FRAMES or not payloads[0].startswith(
            b"\x00\x00\x00\x01\x67"):
        raise AssertionError("stream does not start with an SPS")
    for name, cnt in launches.items():
        if cnt != N_FRAMES:
            raise AssertionError(f"{name}: {cnt} launches, expected one "
                                 f"for each of {N_FRAMES} frames")
        kstats[name]["launches"] = cnt

    # ---- 4. CPU cross-check (IDR + P, encoded by a worker) ----------------
    check_cpu_encode("IDR + P", cpu_refs["main"], payloads, enc, 2)

    # ---- 5. where one P frame's time goes ----------------------------
    profile_p_frame(enc, frames[-1], cfg)

    # ---- 6. decode on the card ---------------------------------------
    decoded, dec_launches = decode_phase(payloads, enc)

    # ---- 7. decode cross-check (IDR + P on the CPU, in line: a job
    # submitted now would queue behind the later phases' references) ----
    t0 = time.perf_counter()
    cpu_out = H264Decoder(device="cpu").decode_annexb(b"".join(payloads[:2]))
    check_frames(cpu_out, [(f.Y, f.U, f.V) for f in decoded[:2]],
                 "decode cross-check")
    print(f"decode cross-check: CPU IDR + P equal the CUDA decode "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    clock.lap("3-7")

    # ---- 8-11. md_low, the scene cut, its decode, the all-modes RD
    low_enc, low_payloads, low_launches = md_low_phase(frames)
    cut_enc, cut_payloads, cut_launches = scene_cut_phase(frames)
    cut_dec_launches = cut_decode_phase(cut_enc, cut_payloads)
    rd_full_phase(enc, frames)
    clock.lap("8-11")

    # ---- 12-13. CABAC encode and decode ------------------------------
    cab, cab_payloads, cab_launches = cabac_phase(frames, enc, payloads)
    cab_dec_launches = cabac_decode_phase(cab, cab_payloads)

    # ---- 14. the host runtime against its Python twins -------------
    host_runtime_phase(enc, payloads, low_enc, low_payloads,
                       cab_payloads)
    # the CPU encodes of phases 8 and 9, made by the workers meanwhile
    check_cpu_encode("md_low IDR + P", cpu_refs["md_low"], low_payloads,
                     low_enc, 2)
    check_cpu_encode("scene cut", cpu_refs["scene_cut"], cut_payloads,
                     cut_enc, CUT_FRAMES)
    clock.lap("12-14")

    # ---- 15-17. slices, FMO, rate control, qp_p, POC types 1 / 2 ---
    ll_launches, ll_dec_launches = low_latency_phase(
        frames, cpu_refs["low_latency"])
    fmo_launches, fmo_dec_launches = fmo_phase(frames)
    crc_launches, crc_dec_launches = cabac_rc_phase(frames)
    for name in ("fmo_t1", "fmo_t3", "fmo_t5d1", "fmo_t6"):
        decode_golden(name)
    clock.lap("15-17")

    # ---- 18-21. data partitions, long-term anchors, redundant
    # pictures, the loop filter off, SEI / VUI; the DP goldens ------
    later = later_phases(frames, rd_fps, cpu_refs)
    clock.lap("18-21")

    # ---- 22-24. B pictures: 1080p encode and decode, the B goldens,
    # the CIF GOP variants ---------------------------------------------
    later.update(b_phases(frames, cpu_refs))
    clock.lap("22-24")

    # ---- 25-27. weighted prediction: the 1080p weighted P picture,
    # the CIF weighted P / B streams, their decode and the WP goldens (the
    # decodes' CPU references on hbd_pool's worker, idle until phase 33:
    # on the pool they queue behind every later phase's references)
    later.update(wp_phases(frames, cpu_refs, hbd_pool))
    clock.lap("25-27")

    # ---- 28-30. the host pipeline and the High profile: the 1080p
    # High picture pair, the CIF host streams, their decode and the
    # High goldens ---------------------------------------------------
    later.update(high_phases(frames, cpu_refs, pool, payloads))
    clock.lap("28-30")

    # ---- 31-33. the host coders' motion options and basic-unit RC:
    # the 1080p two-reference EPZS picture, the CIF streams (sub8x8,
    # UMHex, UMHex simple with long-term references, basic units,
    # the explicit sequence script), their decodes -------------------
    later.update(motion_phases(frames, cpu_refs, pool, payloads))
    hbd_jobs = hbd_cpu_jobs(hbd_pool, payloads)
    clock.lap("31-33")

    # ---- 34-36. the RD tiers: the 1080p device-route stream with
    # rd_picture_decision and the trellis, the QCIF host RD streams
    # (rdo 1-4, errdo, I_PCM, the trellis), their decodes --------------
    later.update(rd_phases(frames, cpu_refs, pool))
    clock.lap("34-36")

    # ---- 37-39. 4:2:2 chroma: K2-422 against its plain twin, the 1080p
    # 4:2:2 IDR and two CIF 4:2:2 streams on the host coders, their
    # decodes, the 4:2:2 goldens ------------------------------------------
    k422, y422, y422_cif_a = y422_phases(frames, cpu_refs, pool, rng)
    hbd_jobs.update(hbd_cpu_jobs(hbd_pool, y422_payloads=y422_cif_a))
    cpu_refs.update(sp_cpu_jobs(pool, frames))
    cpu_refs.update(mvc_cpu_jobs(pool, frames, tools_dir))
    cpu_refs.update(wide_cpu_jobs(pool, frames, tools_dir))
    cpu_refs.update(tools_cpu_jobs(pool, frames, payloads, tools_dir))
    k422["launches"] = y422["y422"]["deblock_chroma422"]
    kstats["deblock_chroma422"] = k422
    max_err["deblock_chroma422"] = k422["max_err"]
    later.update(y422)
    clock.lap("37-39")

    # ---- 40-42. High 10 and lossless: the >8-bit kernels against their
    # twins, the re-headed 1080p High 10 and CIF 4:2:2 10-bit decodes,
    # the High 10 and lossless goldens -----------------------------------
    khbd, hbd = hbd_phases(payloads, y422_cif_a, hbd_jobs, rng)
    conceal_job = conceal_cpu_job(hbd_pool, payloads)
    for key, path in (("deblock_luma16", "hbd_1080p_decode"),
                      ("deblock_chroma16", "hbd_1080p_decode"),
                      ("deblock_chroma422_16", "hbd_422_decode")):
        khbd[key]["launches"] = hbd[path][key]
        kstats[key] = khbd[key]
        max_err[key] = khbd[key]["max_err"]
    later.update(hbd)
    clock.lap("40-42")

    # ---- 43-45. PAFF field pictures: K1/K2 at the field shapes with field
    # bS, the 1080p field pair and a CIF field stream encoded and decoded
    # on the card, the field goldens ---------------------------------------
    kfield, fields, field_payloads = field_phases(frames, cpu_refs, rng)
    gap_jobs = gap_early_jobs(hbd_pool, field_payloads=field_payloads)
    for (w, h, name), s in kfield.items():
        kstats[name][f"field_{w}x{h}_ms"] = s["ms"]
        kstats[name][f"field_{w}x{h}_chain_ms"] = s["chain_ms"]
        max_err[name] = max(max_err[name], s["max_err"])
    later.update(fields)
    clock.lap("43-45")

    # ---- 46-47. SP switching pictures: K1/K2 on the bS of an SP and a
    # half-SP picture, the 1080p SP stream and two CIF SP streams encoded
    # and decoded on the card, the SP goldens ------------------------------
    ksp, sp = sp_phases(frames, cpu_refs, rng)
    for (case, name), s in ksp.items():
        kstats[name][f"{case}_1080p_ms"] = s["ms"]
        kstats[name][f"{case}_1080p_chain_ms"] = s["chain_ms"]
        max_err[name] = max(max_err[name], s["max_err"])
    later.update(sp)
    clock.lap("46-47")

    # ---- 48. concealment: phase 3's stream with a picture lost and a CIF
    # stream with lost and corrupt slices, decoded on the card ----------------
    conceal, conceal_cif = conceal_phase(
        payloads, cif(frames, CONCEAL_CIF_FRAMES), cpu_refs, conceal_job)
    later.update(conceal)
    gap_jobs.update(gap_early_jobs(hbd_pool, cif_payloads=conceal_cif))
    clock.lap("48")

    # ---- 49-51. MVC stereo: the 1080p anchor and non-anchor access
    # units, two CIF stereo streams, their decodes, JM's stereo golden,
    # lencod and ldecod on a stereo cfg ------------------------------------
    later.update(mvc_phases(frames, cpu_refs, tools_dir))
    clock.lap("49-51")

    # ---- 52-54. the parallel axes and the wide search: md_low sharded
    # by MB rows at 1080p, the GOP pipeline on a mesh of the card, the CIF
    # host streams at search ranges 24 / 32 and lencod at SearchRange 32,
    # their decodes ------------------------------------------------------
    later.update(parallel_phases(frames, cpu_refs, tools_dir))
    clock.lap("52-54")

    # ---- 55. the host tools: the trace of phase 3's IDR + P, bdrate's
    # run_ours on CIF frames, a TIFF sequence encoded, rtp_loss / rtpdump
    # and the concealed decode -----------------------------------------
    later.update(tools_phase(frames, payloads, cpu_refs, tools_dir))
    clock.lap("55")

    # ---- 56. the decoder's last gaps against jm_tpu: the 1080p field pair
    # at 10 bits, CIF 4:2:2 fields at 8 and 10 bits, the lossy CIF streams
    # at 10 bits and at 4:2:2 with concealment ----------------------------
    later.update(gap_phase(frames, field_payloads, conceal_cif, pool,
                           gap_jobs))
    clock.lap("56")
    clock.report()

    rows = []
    for name, line in (("deblock_luma", 213), ("deblock_chroma", 310),
                       ("deblock_chroma422", 310), ("deblock_luma16", 213),
                       ("deblock_chroma16", 310),
                       ("deblock_chroma422_16", 310)):
        s = kstats[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "jm_tpu_torch/kernels/deblock.cu",
            "replaces": f"jm_tpu/ops/deblock_pallas.py:{line}",
            "launches": s["launches"], "max_abs_err": max_err[name],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": None, "chain_ms": s["chain_ms"],
            **{k: v for k, v in s.items()
               if k.startswith(("field_", "sp_", "half_sp_"))},
            "decode_launches": dec_launches.get(name, 0),
            "md_low_launches": low_launches.get(name, 0),
            "scene_cut_launches": cut_launches.get(name, 0),
            "scene_cut_decode_launches": cut_dec_launches.get(name, 0),
            "cabac_launches": cab_launches.get(name, 0),
            "cabac_decode_launches": cab_dec_launches.get(name, 0),
            "low_latency_launches": ll_launches.get(name, 0),
            "low_latency_decode_launches": ll_dec_launches.get(name, 0),
            "fmo_launches": fmo_launches.get(name, 0),
            "fmo_decode_launches": fmo_dec_launches.get(name, 0),
            "cabac_slices_rc_launches": crc_launches.get(name, 0),
            "cabac_slices_rc_decode_launches": crc_dec_launches.get(name, 0),
            **{f"{k}_launches": v.get(name, 0)
               for k, v in later.items()}})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
