// In-loop deblocking filter (H.264 spec 8.7) for 4:2:0 and 4:2:2 frame
// pictures, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of jm_tpu/ops/deblock_pallas.py,
// both launched from deblock_pallas (:394):
//   _luma_kernel   (:213, pallas_call :416) -> K1 deblock_luma_rows
//   _chroma_kernel (:310, pallas_call :424) -> K2 deblock_chroma_rows<8>
// and computes bit for bit what they (and jm_tpu/ops/deblock_jax.py) do.
// K2-422, deblock_chroma_rows<16>, is the same kernel at 4:2:2, where the
// TPU kernel has no variant: it computes what jm_tpu's host loops do
// (jm_tpu/ops/deblock.py:297-380). K1 serves both formats.
//
// Both kernels are templates of the sample type as well: uint8_t for 8-bit
// pictures, int16_t for 9- to 14-bit ones (K1-HBD, K2-HBD, K2-422-HBD;
// jm_tpu deblocks those on the host, deblock_picture(bd=),
// jm_tpu/ops/deblock.py:227-380). The bit depth is a runtime argument
// (Depth): alpha, beta and tC0 are the tables' values times
// 1 << (bitDepth - 8) (spec 8.7.2.2), filtered samples clip at
// (1 << bitDepth) - 1, and the chroma QP tables start at QPY =
// -QpBdOffsetY (their entry QPY + qoff), where QPY may be negative. At
// uint8_t the depth is the compile-time constant (0, 255, 0), so the 8-bit
// kernels compile to what they were; the schedule is the same for both.
//
// Dependencies: MB (b, c) filters its 4 vertical edges left to right,
// then its 4 horizontal edges top to bottom (DeblockMb's order); its MB
// edges rewrite 3 samples of its left (b, c-1) and top (b-1, c)
// neighbours, and its top fringe is also rewritten by the left-edge filter
// of (b-1, c+1). lencod's DeblockFrame (loopFilter.c:112) walks whole MBs
// in 2:1 diagonals: (b, c) after row b-1 has filtered min(c+2, mb_w) MBs.
// Split into phases, the dependency is shorter: the vertical edges of
// (b, c) need only (b, c-1), and its horizontal edges need MB (b-1, c)
// final, i.e. the vertical edges of (b-1, c+1) done.
//
// What bounds it on the H100: not bytes (a 1080p 4:2:0 frame read and
// written once plus its bS and per-MB parameters is ~4.6 MB, 1.38 us at
// 3.35 TB/s; K2-422's two 960x1088 planes read and written ~4.2 MB) and
// not arithmetic (~1e8 integer ops), but the dependency chain. The 2:1
// wavefront walks mb_w + 2 (mb_h - 1) MB steps one after the other (254 at
// 1080p), 67 of which hand a row's progress from one SM to the next
// through L2; split into phases, the chain is mb_w + mb_h - 1 MB steps
// (187), again with 67 handoffs.
//
// This design keeps the whole chain in one launch per picture and makes
// each step short. Each CTA (one warp; lanes 0-15 are the 16 filter lines
// of luma, 0-7 Cb and 8-15 Cr of 4:2:0 chroma, 0-15 Cb and 16-31 Cr of
// 4:2:2 chroma) takes an MB row from a global
// ticket and walks it left to right. progress[b] counts the MBs of row b
// that are final: filtered, stored, and with their right fringe rewritten
// by the next MB's left edge (the last MB once filtered). So after the
// vertical edges of MB c the row publishes c, after its last MB mb_w, and
// the horizontal edges of (b, c) wait until progress[b-1] >= c+1. Rows
// are claimed in increasing order, so a CTA only ever waits on a row that
// a running CTA holds: no deadlock, whatever the grid size and residency,
// and no cooperative launch. Per MB:
//   - the interior comes from the unfiltered input plane (nothing writes
//     (b, c)'s samples before (b, c) starts), prefetched one MB ahead;
//   - the left 4 columns are what the CTA produced for (b, c-1), kept in
//     shared memory;
//   - the vertical edges need nothing of row b-1: they run, their left
//     fringe is stored and MB c-1 is published before the wait;
//   - after the wait, only the 4 rows above the MB come from the output
//     plane, through L2 (__ldcg: never the read-only or L1 path, which are
//     not coherent within a kernel);
//   - then the horizontal edges and the stores of every sample they
//     changed.
// A publish is a warp barrier and one release store; a wait is one lane
// polling with acquire loads, then a warp barrier. Each lane holds its
// filter line in registers; a shared-memory tile turns the rows of the
// vertical phase into the columns of the horizontal one. The input planes
// are never written; the output planes are written once per sample, plus
// the fringes that a later MB rewrites.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__constant__ int kAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9, 10,
    12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
    101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ int kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3, 3, 4,
    4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
    15, 15, 16, 16, 17, 17, 18, 18};
__constant__ int kTc0[3][52] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8,
     9, 10, 11, 13},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10,
     11, 12, 13, 15, 17},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13,
     14, 16, 18, 20, 23, 25}};

constexpr int kLanes = 16;                // threads per CTA
constexpr unsigned kMask = 0xffffu;       // ... as a warp mask
// A wait longer than this many polls (seconds) can only be a fault of the
// schedule: trap, so the launch fails instead of hanging the card.
constexpr int kMaxPolls = 1 << 24;

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The bit depth of a plane: shift = bitDepth - 8 of the thresholds, maxv =
// (1 << bitDepth) - 1, qoff = QpBdOffsetY, where the chroma QP tables
// hold QPY = 0.
struct Depth {
  int shift, maxv, qoff;
};

// The depth the kernel runs at: the argument for int16_t planes, the 8-bit
// constants for uint8_t ones (so that the compiler folds them).
template <typename T>
__device__ __forceinline__ Depth depth_of(Depth d) {
  return d;
}
template <>
__device__ __forceinline__ Depth depth_of<uint8_t>(Depth) {
  return {0, 255, 0};
}

// The chroma QP table entry of luma QP qp: clipped at 8 bits (every QP is
// 0..51 there), offset by QpBdOffsetY above.
template <typename T>
__device__ __forceinline__ int qpc_index(int qp, const Depth& d) {
  return sizeof(T) == 1 ? clip3(0, 51, qp) : qp + d.qoff;
}

// Per-MB state shared by the luma and chroma kernels.
struct MbParams {
  const int32_t* qp;
  const int32_t* disable;
  const int32_t* a_off;
  const int32_t* b_off;
  const int32_t* slice_id;
  const int32_t* t8;
  const int8_t* bs_v;   // (4 mb_h, 4 mb_w)
  const int8_t* bs_h;
  int mb_w;
  int mb_h;
};

// What one MB's edges need of the per-MB arrays (spec 8.7:
// disable_deblocking_filter_idc 1 switches the MB off, 2 stops at slice
// boundaries; the 8x8 transform switches the odd inner luma edges off).
struct MbEdges {
  bool on, left_ok, top_ok, inner;
  int qp, qp_l, qp_t, ao, bo;
};

__device__ __forceinline__ MbEdges load_mb(const MbParams& m, int b, int c) {
  const int addr = b * m.mb_w + c;
  const int dis = __ldg(m.disable + addr);
  const int sid = __ldg(m.slice_id + addr);
  MbEdges e;
  e.on = dis != 1;
  e.left_ok = e.on && c > 0 &&
              !(dis == 2 && __ldg(m.slice_id + addr - 1) != sid);
  e.top_ok = e.on && b > 0 &&
             !(dis == 2 && __ldg(m.slice_id + addr - m.mb_w) != sid);
  e.inner = e.on && __ldg(m.t8 + addr) == 0;
  e.qp = __ldg(m.qp + addr);
  e.qp_l = c > 0 ? __ldg(m.qp + addr - 1) : e.qp;
  e.qp_t = b > 0 ? __ldg(m.qp + addr - m.mb_w) : e.qp;
  e.ao = __ldg(m.a_off + addr);
  e.bo = __ldg(m.b_off + addr);
  return e;
}

// alpha, beta and tc0 of an edge line (spec 8.7.2.2).
struct Thresholds {
  int alpha, beta, tc0;
};

__device__ __forceinline__ Thresholds thresholds(int qp_p, int qp_q, int ao,
                                                 int bo, int bs, int shift) {
  const int qav = (qp_p + qp_q + 1) >> 1;
  const int ia = clip3(0, 51, qav + 2 * ao);
  const int ib = clip3(0, 51, qav + 2 * bo);
  return {kAlpha[ia] << shift, kBeta[ib] << shift,
          kTc0[clip3(1, 3, bs) - 1][ia] << shift};
}

// The 4 bS values of one 32-bit word of a bS array (values 0..4).
__device__ __forceinline__ int bs_byte(uint32_t w, int k) {
  return (int)(int8_t)(w >> (8 * k));
}

// One luma filter line across an edge: s[-4..-1] = p3..p0, s[0..3] =
// q0..q3, in a register array (the indices are constants once the edge
// loops are unrolled).
__device__ __forceinline__ void luma_line(int* s, int bs, Thresholds t,
                                          int maxv) {
  const int p0 = s[-1], p1 = s[-2], p2 = s[-3], p3 = s[-4];
  const int q0 = s[0], q1 = s[1], q2 = s[2], q3 = s[3];
  if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta &&
        abs(q1 - q0) < t.beta))
    return;
  const bool ap = abs(p2 - p0) < t.beta;
  const bool aq = abs(q2 - q0) < t.beta;
  int rp0, rp1 = p1, rp2 = p2, rq0, rq1 = q1, rq2 = q2;
  if (bs == 4) {
    const bool strong = abs(p0 - q0) < ((t.alpha >> 2) + 2);
    if (strong && ap) {
      rp0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      rp1 = (p2 + p1 + p0 + q0 + 2) >> 2;
      rp2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      rp0 = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (strong && aq) {
      rq0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      rq1 = (q2 + q1 + q0 + p0 + 2) >> 2;
      rq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      rq0 = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  } else {
    const int tc = t.tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    rp0 = clip3(0, maxv, p0 + delta);
    rq0 = clip3(0, maxv, q0 - delta);
    const int avg = (p0 + q0 + 1) >> 1;
    if (ap) rp1 = p1 + clip3(-t.tc0, t.tc0, (p2 + avg - 2 * p1) >> 1);
    if (aq) rq1 = q1 + clip3(-t.tc0, t.tc0, (q2 + avg - 2 * q1) >> 1);
  }
  s[-3] = rp2;
  s[-2] = rp1;
  s[-1] = rp0;
  s[0] = rq0;
  s[1] = rq1;
  s[2] = rq2;
}

// One chroma filter line: s[-2..-1] = p1 p0, s[0..1] = q0 q1; only p0 and
// q0 change, tc = tc0 + 1.
__device__ __forceinline__ void chroma_line(int* s, int bs, Thresholds t,
                                            int maxv) {
  const int p0 = s[-1], p1 = s[-2];
  const int q0 = s[0], q1 = s[1];
  if (!(abs(p0 - q0) < t.alpha && abs(p1 - p0) < t.beta &&
        abs(q1 - q0) < t.beta))
    return;
  if (bs == 4) {
    s[-1] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  } else {
    const int tc = t.tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    s[-1] = clip3(0, maxv, p0 + delta);
    s[0] = clip3(0, maxv, q0 - delta);
  }
}

__device__ __forceinline__ void unpack(uint32_t w, int* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (w >> (8 * k)) & 0xff;
}

// Two int16 samples (0..16383) of one 32-bit word.
__device__ __forceinline__ void unpack16(uint32_t w, int* v) {
  v[0] = w & 0xffff;
  v[1] = w >> 16;
}

// kN consecutive samples of a row (one MB's line: 16 luma, 8 chroma), read
// through the read-only path as aligned 16-byte vectors (8-byte for 8
// uint8 samples); the kernels prefetch them one MB ahead.
template <typename T, int kN>
struct Line;
template <>
struct Line<uint8_t, 16> {
  uint4 w;
  __device__ __forceinline__ void load(const uint8_t* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack_to(int* v) const {
    unpack(w.x, v);
    unpack(w.y, v + 4);
    unpack(w.z, v + 8);
    unpack(w.w, v + 12);
  }
};
template <>
struct Line<uint8_t, 8> {
  uint2 w;
  __device__ __forceinline__ void load(const uint8_t* p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void unpack_to(int* v) const {
    unpack(w.x, v);
    unpack(w.y, v + 4);
  }
};
template <>
struct Line<int16_t, 8> {
  uint4 w;
  __device__ __forceinline__ void load(const int16_t* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack_to(int* v) const {
    unpack16(w.x, v);
    unpack16(w.y, v + 2);
    unpack16(w.z, v + 4);
    unpack16(w.w, v + 6);
  }
};
template <>
struct Line<int16_t, 16> {
  Line<int16_t, 8> a, b;
  __device__ __forceinline__ void load(const int16_t* p) {
    a.load(p);
    b.load(p + 8);
  }
  __device__ __forceinline__ void unpack_to(int* v) const {
    a.unpack_to(v);
    b.unpack_to(v + 8);
  }
};

// Lane 0 of the CTA takes the next MB row; every lane of `mask` (the
// CTA's lanes) gets it.
__device__ __forceinline__ int next_row(int* ticket,
                                        unsigned mask = kMask) {
  int b = 0;
  if (threadIdx.x == 0) b = atomicAdd(ticket, 1);
  return __shfl_sync(mask, b, 0);
}

// Waits until `need` MBs of row b-1 are final. Lane 0 polls with acquire
// loads (`seen` keeps the last value it read, so a satisfied wait costs
// nothing); the warp barrier then orders every lane's later loads after
// that acquire.
__device__ __forceinline__ void wait_above(int* progress, int b, int need,
                                           int& seen,
                                           unsigned mask = kMask) {
  if (threadIdx.x == 0 && seen < need) {
    cuda::atomic_ref<int, cuda::thread_scope_device> above(progress[b - 1]);
    for (int polls = 0;; ++polls) {
      seen = above.load(cuda::memory_order_acquire);
      if (seen >= need) break;
      if (polls > kMaxPolls) __trap();
      __nanosleep(32);
    }
  }
  __syncwarp(mask);
}

// Publishes that `done` MBs of row b are final: every lane's stores, then
// the warp barrier, then one release store by lane 0. At device scope the
// release orders every store that the barrier ordered before it; a full
// __threadfence in front of it would order nothing more and stall the
// warp on every MB.
__device__ __forceinline__ void publish(int* progress, int b, int done,
                                        unsigned mask = kMask) {
  __syncwarp(mask);
  if (threadIdx.x == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> mine(progress[b]);
    mine.store(done, cuda::memory_order_release);
  }
}

// K1 (T uint8_t) and K1-HBD (T int16_t): luma. in / out (16 mb_h,
// 16 mb_w) planes of T with row pitch `stride` samples (16-byte aligned
// rows); d the bit depth (ignored at uint8_t); ticket (1,) and progress
// (mb_h,) int32, zero at launch. 16 threads per CTA, any grid size.
template <typename T>
__global__ void __launch_bounds__(kLanes)
    deblock_luma_rows(const T* __restrict__ in, T* out, int stride,
                      MbParams m, Depth depth, int* ticket, int* progress) {
  __shared__ int tile[16][17];   // the MB after its vertical edges
  __shared__ int left[16][4];    // columns 12-15 of the previous MB
  const Depth d = depth_of<T>(depth);
  const int t = threadIdx.x;
  const int bs_stride = 4 * m.mb_w;
  for (int b = next_row(ticket); b < m.mb_h; b = next_row(ticket)) {
    const T* in_row = in + (size_t)(16 * b + t) * stride;
    T* out_row = out + (size_t)(16 * b + t) * stride;
    T* out_col = out + (ptrdiff_t)(16 * b - 4) * stride + t;
    int seen = 0;
    Line<T, 16> nxt;
    nxt.load(in_row);
    for (int c = 0; c < m.mb_w; ++c) {
      const Line<T, 16> cur = nxt;
      if (c + 1 < m.mb_w) nxt.load(in_row + 16 * (c + 1));
      const MbEdges e = load_mb(m, b, c);
      const uint32_t bsv = __ldg(reinterpret_cast<const uint32_t*>(
          m.bs_v + (4 * b + (t >> 2)) * bs_stride + 4 * c));
      int bsh[4];
#pragma unroll
      for (int ey = 0; ey < 4; ++ey)
        bsh[ey] = __ldg(m.bs_h + (4 * b + ey) * bs_stride + 4 * c + (t >> 2));

      // vertical edges along row t: v = 4 left samples + 16 of the MB
      int v[20];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = c > 0 ? left[t][k] : 0;
      cur.unpack_to(v + 4);
#pragma unroll
      for (int ex = 0; ex < 4; ++ex) {
        const bool en = ex == 0 ? e.left_ok : ((ex & 1) ? e.inner : e.on);
        const int bs = bs_byte(bsv, ex);
        if (!en || bs <= 0) continue;
        luma_line(v + 4 + 4 * ex, bs,
                  thresholds(ex == 0 ? e.qp_l : e.qp, e.qp, e.ao, e.bo, bs,
                             d.shift),
                  d.maxv);
      }
      if (c > 0) {
#pragma unroll
        for (int k = 1; k < 4; ++k) out_row[16 * c - 4 + k] = (T)v[k];
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) tile[t][x] = v[4 + x];
      if (c > 0) publish(progress, b, c);     // MB c-1 is final

      // horizontal edges down column t: h = 4 samples above + 16 of the MB
      int h[20];
      if (b > 0) {
        wait_above(progress, b, c + 1, seen);
#pragma unroll
        for (int y = 0; y < 4; ++y)
          h[y] = __ldcg(out_col + (size_t)y * stride + 16 * c);
      } else {
        __syncwarp(kMask);
#pragma unroll
        for (int y = 0; y < 4; ++y) h[y] = 0;
      }
#pragma unroll
      for (int y = 0; y < 16; ++y) h[4 + y] = tile[y][t];
#pragma unroll
      for (int ey = 0; ey < 4; ++ey) {
        const bool en = ey == 0 ? e.top_ok : ((ey & 1) ? e.inner : e.on);
        const int bs = bsh[ey];
        if (!en || bs <= 0) continue;
        luma_line(h + 4 + 4 * ey, bs,
                  thresholds(ey == 0 ? e.qp_t : e.qp, e.qp, e.ao, e.bo, bs,
                             d.shift),
                  d.maxv);
      }
      if (b > 0) {
#pragma unroll
        for (int y = 1; y < 4; ++y)
          out_col[(size_t)y * stride + 16 * c] = (T)h[y];
      }
#pragma unroll
      for (int y = 4; y < 20; ++y)
        out_col[(size_t)y * stride + 16 * c] = (T)h[y];
      if (t >= 12) {
#pragma unroll
        for (int y = 0; y < 16; ++y) left[y][t - 12] = h[4 + y];
      }
      if (c + 1 == m.mb_w)
        publish(progress, b, m.mb_w);         // the last MB has no right
      else                                    // neighbour: final now
        __syncwarp(kMask);
    }
  }
}

// K2 (kRows 8, 4:2:0) and K2-422 (kRows 16, 4:2:2), of T uint8_t, and
// their >8-bit variants K2-HBD / K2-422-HBD (T int16_t): Cb and Cr. in_u /
// in_v / out_u / out_v (kRows mb_h, 8 mb_w) planes of T with row pitch
// `stride` samples (8-byte aligned rows at uint8_t, 16-byte at int16_t);
// qpc_cb / qpc_cr (52 + d.qoff,) QPY -> QPc from QPY -d.qoff; d the bit
// depth; ticket and progress as for K1. 2 kRows lanes per CTA. Vertical
// edges 0 and 2: lanes 0..kRows-1 filter the Cb lines, the rest the Cr
// lines (4:2:2 fills the warp), each line with the bS of its own luma
// line (chroma line l is luma line 16 l / kRows). Horizontal edges:
// lanes 0-7 Cb and 8-15 Cr columns, each down its whole column (the edges
// at chroma rows 0, 4, ... with the bS of luma edges 0, 2 at 4:2:0 and
// 0, 1, 2, 3 at 4:2:2; the 8x8 transform switches none of them off, so
// at 4:2:2 rows 4 and 12 run where luma edges 1 and 3 do not, ldecod
// loopFilter.c:488); at 4:2:2 lanes 16-31 wait at the barriers.
//
// The row-progress rule is K1's at both formats. A chroma filter line
// reads p1..q1 and changes only p0 and q0, so (b, c)'s top edge rewrites
// the last row of (b-1, c) and reads the one above it, and (b-1, c+1)'s
// left edge rewrites column 7 of (b-1, c) down all its lines, the last
// row included: the horizontal edges of (b, c) wait for progress[b-1] >=
// c+1, as at 4:2:0, and nothing of row b-1 touches (b-1, c) after that.
// The taller MB changes the lines each step carries, not the rule.
template <int kRows, typename T>
__global__ void __launch_bounds__(2 * kRows)
    deblock_chroma_rows(const T* __restrict__ in_u,
                        const T* __restrict__ in_v, T* out_u, T* out_v,
                        int stride, MbParams m,
                        const int32_t* __restrict__ qpc_cb,
                        const int32_t* __restrict__ qpc_cr, Depth depth,
                        int* ticket, int* progress) {
  static_assert(kRows == 8 || kRows == 16, "4:2:0 or 4:2:2");
  constexpr unsigned kWarp = kRows == 16 ? 0xffffffffu : kMask;
  constexpr int kLumaStep = 16 / kRows;   // luma lines per chroma line
  __shared__ int tile[2][kRows][9];   // the MBs after their vertical edges
  __shared__ int left[2][kRows][2];   // columns 6-7 of the previous MBs
  const Depth d = depth_of<T>(depth);
  const int t = threadIdx.x;
  // vertical phase: line l of component comp
  const int comp = t / kRows;
  const int l = t % kRows;
  // horizontal phase: column col of component hcomp (lanes 0-15)
  const bool hlane = t < 16;
  const int hcomp = (t >> 3) & 1;
  const int col = t & 7;
  const T* in = comp ? in_v : in_u;
  T* out = comp ? out_v : out_u;
  T* hout = hcomp ? out_v : out_u;
  const int32_t* tab = comp ? qpc_cr : qpc_cb;
  const int32_t* htab = hcomp ? qpc_cr : qpc_cb;
  const int bs_stride = 4 * m.mb_w;
  for (int b = next_row(ticket, kWarp); b < m.mb_h;
       b = next_row(ticket, kWarp)) {
    const T* in_row = in + (size_t)(kRows * b + l) * stride;
    T* out_row = out + (size_t)(kRows * b + l) * stride;
    T* out_col = hout + (ptrdiff_t)(kRows * b - 2) * stride + col;
    int seen = 0;
    Line<T, 8> nxt;
    nxt.load(in_row);
    for (int c = 0; c < m.mb_w; ++c) {
      const Line<T, 8> cur = nxt;
      if (c + 1 < m.mb_w) nxt.load(in_row + 8 * (c + 1));
      const MbEdges e = load_mb(m, b, c);
      const uint32_t bsv = __ldg(reinterpret_cast<const uint32_t*>(
          m.bs_v + (4 * b + ((kLumaStep * l) >> 2)) * bs_stride + 4 * c));

      // vertical edges 0 and 2 along line l: 2 left samples + 8 of the MB
      {
        const int qpc = __ldg(tab + qpc_index<T>(e.qp, d));
        const int qpc_l = __ldg(tab + qpc_index<T>(e.qp_l, d));
        int v[10];
#pragma unroll
        for (int k = 0; k < 2; ++k) v[k] = c > 0 ? left[comp][l][k] : 0;
        cur.unpack_to(v + 2);
#pragma unroll
        for (int ex = 0; ex < 4; ex += 2) {
          const bool en = ex == 0 ? e.left_ok : e.on;
          const int bs = bs_byte(bsv, ex);
          if (!en || bs <= 0) continue;
          chroma_line(v + 2 + 2 * ex, bs,
                      thresholds(ex == 0 ? qpc_l : qpc, qpc, e.ao, e.bo, bs,
                                 d.shift),
                      d.maxv);
        }
        if (c > 0) out_row[8 * c - 1] = (T)v[1];
#pragma unroll
        for (int x = 0; x < 8; ++x) tile[comp][l][x] = v[2 + x];
      }
      if (c > 0) publish(progress, b, c, kWarp);   // MB c-1 is final

      // horizontal edges down column col: 2 samples above + kRows
      if (b > 0)
        wait_above(progress, b, c + 1, seen, kWarp);
      else
        __syncwarp(kWarp);
      if (hlane) {
        const int qpc = __ldg(htab + qpc_index<T>(e.qp, d));
        const int qpc_t = __ldg(htab + qpc_index<T>(e.qp_t, d));
        int h[2 + kRows];
        if (b > 0) {
#pragma unroll
          for (int y = 0; y < 2; ++y)
            h[y] = __ldcg(out_col + (size_t)y * stride + 8 * c);
        } else {
          h[0] = h[1] = 0;
        }
#pragma unroll
        for (int y = 0; y < kRows; ++y) h[2 + y] = tile[hcomp][y][col];
#pragma unroll
        for (int k = 0; k < kRows / 4; ++k) {
          const bool en = k == 0 ? e.top_ok : e.on;
          const int bs = __ldg(m.bs_h + (4 * b + kLumaStep * k) * bs_stride +
                               4 * c + (col >> 1));
          if (!en || bs <= 0) continue;
          chroma_line(h + 2 + 4 * k, bs,
                      thresholds(k == 0 ? qpc_t : qpc, qpc, e.ao, e.bo, bs,
                                 d.shift),
                      d.maxv);
        }
        if (b > 0) out_col[(size_t)stride + 8 * c] = (T)h[1];
#pragma unroll
        for (int y = 2; y < 2 + kRows; ++y)
          out_col[(size_t)y * stride + 8 * c] = (T)h[y];
        if (col >= 6) {
#pragma unroll
          for (int y = 0; y < kRows; ++y) left[hcomp][y][col - 6] = h[2 + y];
        }
      }
      if (c + 1 == m.mb_w)
        publish(progress, b, m.mb_w, kWarp);
      else
        __syncwarp(kWarp);
    }
  }
}

MbParams make_params(const int32_t* qp, const int32_t* disable,
                     const int32_t* a_off, const int32_t* b_off,
                     const int32_t* slice_id, const int32_t* t8,
                     const int8_t* bs_v, const int8_t* bs_h, int mb_w,
                     int mb_h) {
  MbParams m;
  m.qp = qp;
  m.disable = disable;
  m.a_off = a_off;
  m.b_off = b_off;
  m.slice_id = slice_id;
  m.t8 = t8;
  m.bs_v = bs_v;
  m.bs_h = bs_h;
  m.mb_w = mb_w;
  m.mb_h = mb_h;
  return m;
}

}  // namespace

// Host launchers: one launch per picture on `stream`, `grid` CTAs.
// scratch is (1 + mb_h,) int32 zeros: the row ticket, then progress.
// They do not check errors; the caller checks cudaGetLastError() right
// after each launch. The 16-bit launchers take the bit depth (8-14) and,
// for chroma, QpBdOffsetY (qoff: the tables hold 52 + qoff entries).
namespace {

template <typename T>
void launch_luma(const T* in, T* out, int stride, const MbParams& m,
                 Depth d, int* scratch, int grid, cudaStream_t stream) {
  deblock_luma_rows<T><<<grid, kLanes, 0, stream>>>(in, out, stride, m, d,
                                                    scratch, scratch + 1);
}

template <typename T>
void launch_chroma(const T* in_u, const T* in_v, T* out_u, T* out_v,
                   int stride, const MbParams& m, const int32_t* qpc_cb,
                   const int32_t* qpc_cr, Depth d, int* scratch, int rows,
                   int grid, cudaStream_t stream) {
  if (rows == 16)
    deblock_chroma_rows<16, T><<<grid, 32, 0, stream>>>(
        in_u, in_v, out_u, out_v, stride, m, qpc_cb, qpc_cr, d, scratch,
        scratch + 1);
  else
    deblock_chroma_rows<8, T><<<grid, 16, 0, stream>>>(
        in_u, in_v, out_u, out_v, stride, m, qpc_cb, qpc_cr, d, scratch,
        scratch + 1);
}

Depth make_depth(int bd, int qoff) {
  return {bd - 8, (1 << bd) - 1, qoff};
}

}  // namespace

void launch_deblock_luma(const uint8_t* in, uint8_t* out, int stride,
                         const int32_t* qp, const int32_t* disable,
                         const int32_t* a_off, const int32_t* b_off,
                         const int32_t* slice_id, const int32_t* t8,
                         const int8_t* bs_v, const int8_t* bs_h,
                         int* scratch, int mb_w, int mb_h, int grid,
                         cudaStream_t stream) {
  launch_luma(in, out, stride,
              make_params(qp, disable, a_off, b_off, slice_id, t8, bs_v,
                          bs_h, mb_w, mb_h),
              make_depth(8, 0), scratch, grid, stream);
}

void launch_deblock_chroma(const uint8_t* in_u, const uint8_t* in_v,
                           uint8_t* out_u, uint8_t* out_v, int stride,
                           const int32_t* qp, const int32_t* disable,
                           const int32_t* a_off, const int32_t* b_off,
                           const int32_t* slice_id, const int32_t* t8,
                           const int8_t* bs_v, const int8_t* bs_h,
                           const int32_t* qpc_cb, const int32_t* qpc_cr,
                           int* scratch, int mb_w, int mb_h, int rows,
                           int grid, cudaStream_t stream) {
  launch_chroma(in_u, in_v, out_u, out_v, stride,
                make_params(qp, disable, a_off, b_off, slice_id, t8, bs_v,
                            bs_h, mb_w, mb_h),
                qpc_cb, qpc_cr, make_depth(8, 0), scratch, rows, grid,
                stream);
}

void launch_deblock_luma16(const int16_t* in, int16_t* out, int stride,
                           const int32_t* qp, const int32_t* disable,
                           const int32_t* a_off, const int32_t* b_off,
                           const int32_t* slice_id, const int32_t* t8,
                           const int8_t* bs_v, const int8_t* bs_h,
                           int* scratch, int mb_w, int mb_h, int bd,
                           int grid, cudaStream_t stream) {
  launch_luma(in, out, stride,
              make_params(qp, disable, a_off, b_off, slice_id, t8, bs_v,
                          bs_h, mb_w, mb_h),
              make_depth(bd, 0), scratch, grid, stream);
}

void launch_deblock_chroma16(const int16_t* in_u, const int16_t* in_v,
                             int16_t* out_u, int16_t* out_v, int stride,
                             const int32_t* qp, const int32_t* disable,
                             const int32_t* a_off, const int32_t* b_off,
                             const int32_t* slice_id, const int32_t* t8,
                             const int8_t* bs_v, const int8_t* bs_h,
                             const int32_t* qpc_cb, const int32_t* qpc_cr,
                             int* scratch, int mb_w, int mb_h, int rows,
                             int bd, int qoff, int grid,
                             cudaStream_t stream) {
  launch_chroma(in_u, in_v, out_u, out_v, stride,
                make_params(qp, disable, a_off, b_off, slice_id, t8, bs_v,
                            bs_h, mb_w, mb_h),
                qpc_cb, qpc_cr, make_depth(bd, qoff), scratch, rows, grid,
                stream);
}

// C entry points for the Python loader (jm_tpu_torch/kernels/__init__.py,
// ctypes): each launches once on `stream` and returns cudaGetLastError()
// of that launch (0: launched). The caller has checked every argument.
extern "C" {

int jm_deblock_luma(const uint8_t* in, uint8_t* out, int stride,
                    const int32_t* qp, const int32_t* disable,
                    const int32_t* a_off, const int32_t* b_off,
                    const int32_t* slice_id, const int32_t* t8,
                    const int8_t* bs_v, const int8_t* bs_h, int* scratch,
                    int mb_w, int mb_h, int grid, void* stream) {
  launch_deblock_luma(in, out, stride, qp, disable, a_off, b_off, slice_id,
                      t8, bs_v, bs_h, scratch, mb_w, mb_h, grid,
                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int jm_deblock_chroma(const uint8_t* in_u, const uint8_t* in_v,
                      uint8_t* out_u, uint8_t* out_v, int stride,
                      const int32_t* qp, const int32_t* disable,
                      const int32_t* a_off, const int32_t* b_off,
                      const int32_t* slice_id, const int32_t* t8,
                      const int8_t* bs_v, const int8_t* bs_h,
                      const int32_t* qpc_cb, const int32_t* qpc_cr,
                      int* scratch, int mb_w, int mb_h, int rows, int grid,
                      void* stream) {
  launch_deblock_chroma(in_u, in_v, out_u, out_v, stride, qp, disable,
                        a_off, b_off, slice_id, t8, bs_v, bs_h, qpc_cb,
                        qpc_cr, scratch, mb_w, mb_h, rows, grid,
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int jm_deblock_luma16(const int16_t* in, int16_t* out, int stride,
                      const int32_t* qp, const int32_t* disable,
                      const int32_t* a_off, const int32_t* b_off,
                      const int32_t* slice_id, const int32_t* t8,
                      const int8_t* bs_v, const int8_t* bs_h, int* scratch,
                      int mb_w, int mb_h, int bd, int grid, void* stream) {
  launch_deblock_luma16(in, out, stride, qp, disable, a_off, b_off,
                        slice_id, t8, bs_v, bs_h, scratch, mb_w, mb_h, bd,
                        grid, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int jm_deblock_chroma16(const int16_t* in_u, const int16_t* in_v,
                        int16_t* out_u, int16_t* out_v, int stride,
                        const int32_t* qp, const int32_t* disable,
                        const int32_t* a_off, const int32_t* b_off,
                        const int32_t* slice_id, const int32_t* t8,
                        const int8_t* bs_v, const int8_t* bs_h,
                        const int32_t* qpc_cb, const int32_t* qpc_cr,
                        int* scratch, int mb_w, int mb_h, int rows, int bd,
                        int qoff, int grid, void* stream) {
  launch_deblock_chroma16(in_u, in_v, out_u, out_v, stride, qp, disable,
                          a_off, b_off, slice_id, t8, bs_v, bs_h, qpc_cb,
                          qpc_cr, scratch, mb_w, mb_h, rows, bd, qoff, grid,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

const char* jm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
