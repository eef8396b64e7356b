// In-loop deblocking filter (H.264 spec 8.7) for 4:2:0 frame pictures,
// hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of jm_tpu/ops/deblock_pallas.py:
//   _luma_kernel   (K1, launched from deblock_pallas) -> deblock_luma_wave
//   _chroma_kernel (K2, launched from deblock_pallas) -> deblock_chroma_wave
// and computes bit for bit what they (and jm_tpu/ops/deblock_jax.py) do.
//
// Dependency structure: MB (b, c) needs its left, top and top-right
// neighbours filtered first, so the frame is walked in waves
// w = 0 .. n_w-1 of MBs (b, w - 2b) (the 2:1 diagonals of lencod's
// DeblockFrame, loopFilter.c:112); MBs of one wave touch disjoint pixels.
//
// What bounds it on the H100: not bytes (a 1080p 4:2:0 frame read and
// written once plus its bS is ~4.6 MB, ~1.4 us at 3.35 TB/s) and not
// arithmetic (~1e8 integer ops), but the chain of n_w dependent waves
// (254 at 1080p), each of which must see the previous wave's writes.
//
// This design: one launch per wave on the caller's stream (stream order
// is the inter-wave barrier), one CTA per MB of the wave, planar uint8
// frame updated in place. Luma: 16 threads, one per filter line; each
// thread runs the 4 vertical edges along its row, __syncthreads, then the
// 4 horizontal edges down its column. Chroma: threads 0-7 filter Cb
// lines, 8-15 Cr lines, 2 vertical then 2 horizontal edges. alpha, beta
// and tc0 come from __constant__ tables indexed by the per-MB qp and
// offsets; every sample is widened to int before arithmetic. The launch
// chain costs ~one launch latency per wave; a persistent kernel with
// per-row progress counters would remove it and is later work.

#include <cuda_runtime.h>
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

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return x < lo ? lo : (x > hi ? hi : x);
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

// Edge enables of MB addr (spec 8.7: disable_deblocking_filter_idc 1
// switches the MB off, 2 stops at slice boundaries).
__device__ __forceinline__ void mb_enables(const MbParams& m, int b, int c,
                                           bool* on, bool* left_ok,
                                           bool* top_ok) {
  int addr = b * m.mb_w + c;
  int dis = m.disable[addr];
  int sid = m.slice_id[addr];
  *on = dis != 1;
  *left_ok = *on && c > 0 && !(dis == 2 && m.slice_id[addr - 1] != sid);
  *top_ok = *on && b > 0 && !(dis == 2 && m.slice_id[addr - m.mb_w] != sid);
}

// Indices into the threshold tables for one QP pair (spec 8.7.2.2).
__device__ __forceinline__ void edge_index(int qp_p, int qp_q, int ao,
                                           int bo, int* ia, int* ib) {
  int qav = (qp_p + qp_q + 1) >> 1;
  *ia = clip3(0, 51, qav + 2 * ao);
  *ib = clip3(0, 51, qav + 2 * bo);
}

// One luma filter line: s points at q0, step is the distance between
// neighbouring samples across the edge (1: vertical edge, stride:
// horizontal edge).
__device__ __forceinline__ void luma_line(uint8_t* s, int step, int bs,
                                          int alpha, int beta, int tc0) {
  int p0 = s[-step], p1 = s[-2 * step], p2 = s[-3 * step],
      p3 = s[-4 * step];
  int q0 = s[0], q1 = s[step], q2 = s[2 * step], q3 = s[3 * step];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta &&
        abs(q1 - q0) < beta))
    return;
  bool ap = abs(p2 - p0) < beta;
  bool aq = abs(q2 - q0) < beta;
  int rp0, rp1 = p1, rp2 = p2, rq0, rq1 = q1, rq2 = q2;
  if (bs == 4) {
    bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
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
    int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    rp0 = clip3(0, 255, p0 + delta);
    rq0 = clip3(0, 255, q0 - delta);
    if (ap) rp1 = p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1);
    if (aq) rq1 = q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1);
  }
  s[-3 * step] = (uint8_t)rp2;
  s[-2 * step] = (uint8_t)rp1;
  s[-step] = (uint8_t)rp0;
  s[0] = (uint8_t)rq0;
  s[step] = (uint8_t)rq1;
  s[2 * step] = (uint8_t)rq2;
}

// One chroma filter line (only p0 / q0 change, tc = tc0 + 1).
__device__ __forceinline__ void chroma_line(uint8_t* s, int step, int bs,
                                            int alpha, int beta, int tc0) {
  int p0 = s[-step], p1 = s[-2 * step];
  int q0 = s[0], q1 = s[step];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta &&
        abs(q1 - q0) < beta))
    return;
  int rp0, rq0;
  if (bs == 4) {
    rp0 = (2 * p1 + p0 + q1 + 2) >> 2;
    rq0 = (2 * q1 + q0 + p1 + 2) >> 2;
  } else {
    int tc = tc0 + 1;
    int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    rp0 = clip3(0, 255, p0 + delta);
    rq0 = clip3(0, 255, q0 - delta);
  }
  s[-step] = (uint8_t)rp0;
  s[0] = (uint8_t)rq0;
}

// K1: luma, one wave. grid.x = mb_h (lane b holds MB (b, w - 2b)),
// block = 16 threads.
__global__ void deblock_luma_wave(uint8_t* __restrict__ Y, int stride,
                                  MbParams m, int w) {
  int b = blockIdx.x;
  int c = w - 2 * b;
  if (c < 0 || c >= m.mb_w) return;
  int t = threadIdx.x;
  int addr = b * m.mb_w + c;
  bool on, left_ok, top_ok;
  mb_enables(m, b, c, &on, &left_ok, &top_ok);
  int qp = m.qp[addr], ao = m.a_off[addr], bo = m.b_off[addr];
  bool t8 = m.t8[addr] != 0;
  int bs_stride = 4 * m.mb_w;

  // vertical edges: thread t filters pixel row 16b + t
  uint8_t* row = Y + (size_t)(16 * b + t) * stride + 16 * c;
  for (int ex = 0; ex < 4; ++ex) {
    bool en = ex == 0 ? left_ok : ((ex & 1) ? on && !t8 : on);
    int bs = m.bs_v[(4 * b + (t >> 2)) * bs_stride + 4 * c + ex];
    if (!en || bs <= 0) continue;
    int ia, ib;
    edge_index(ex == 0 ? m.qp[addr - 1] : qp, qp, ao, bo, &ia, &ib);
    int tc0 = kTc0[clip3(1, 3, bs) - 1][ia];
    luma_line(row + 4 * ex, 1, bs, kAlpha[ia], kBeta[ib], tc0);
  }
  __syncthreads();
  // horizontal edges: thread t filters pixel column 16c + t
  uint8_t* col = Y + (size_t)(16 * b) * stride + 16 * c + t;
  for (int ey = 0; ey < 4; ++ey) {
    bool en = ey == 0 ? top_ok : ((ey & 1) ? on && !t8 : on);
    int bs = m.bs_h[(4 * b + ey) * bs_stride + 4 * c + (t >> 2)];
    if (!en || bs <= 0) continue;
    int ia, ib;
    edge_index(ey == 0 ? m.qp[addr - m.mb_w] : qp, qp, ao, bo, &ia, &ib);
    int tc0 = kTc0[clip3(1, 3, bs) - 1][ia];
    luma_line(col + (size_t)(4 * ey) * stride, stride, bs, kAlpha[ia],
              kBeta[ib], tc0);
  }
}

// K2: Cb and Cr, one wave. block = 16 threads: 0-7 Cb lines, 8-15 Cr.
__global__ void deblock_chroma_wave(uint8_t* __restrict__ U,
                                    uint8_t* __restrict__ V, int stride,
                                    MbParams m, const int32_t* qpc_cb,
                                    const int32_t* qpc_cr, int w) {
  int b = blockIdx.x;
  int c = w - 2 * b;
  if (c < 0 || c >= m.mb_w) return;
  int comp = threadIdx.x >> 3;
  int l = threadIdx.x & 7;
  uint8_t* P = comp ? V : U;
  const int32_t* tab = comp ? qpc_cr : qpc_cb;
  int addr = b * m.mb_w + c;
  bool on, left_ok, top_ok;
  mb_enables(m, b, c, &on, &left_ok, &top_ok);
  int qpc = tab[clip3(0, 51, m.qp[addr])];
  int ao = m.a_off[addr], bo = m.b_off[addr];
  int bs_stride = 4 * m.mb_w;

  uint8_t* row = P + (size_t)(8 * b + l) * stride + 8 * c;
  for (int ex = 0; ex < 4; ex += 2) {
    bool en = ex == 0 ? left_ok : on;
    int bs = m.bs_v[(4 * b + (l >> 1)) * bs_stride + 4 * c + ex];
    if (!en || bs <= 0) continue;
    int qpc_p = ex == 0 ? tab[clip3(0, 51, m.qp[addr - 1])] : qpc;
    int ia, ib;
    edge_index(qpc_p, qpc, ao, bo, &ia, &ib);
    int tc0 = kTc0[clip3(1, 3, bs) - 1][ia];
    chroma_line(row + 2 * ex, 1, bs, kAlpha[ia], kBeta[ib], tc0);
  }
  __syncthreads();
  uint8_t* col = P + (size_t)(8 * b) * stride + 8 * c + l;
  for (int ey = 0; ey < 4; ey += 2) {
    bool en = ey == 0 ? top_ok : on;
    int bs = m.bs_h[(4 * b + ey) * bs_stride + 4 * c + (l >> 1)];
    if (!en || bs <= 0) continue;
    int qpc_p = ey == 0 ? tab[clip3(0, 51, m.qp[addr - m.mb_w])] : qpc;
    int ia, ib;
    edge_index(qpc_p, qpc, ao, bo, &ia, &ib);
    int tc0 = kTc0[clip3(1, 3, bs) - 1][ia];
    chroma_line(col + (size_t)(2 * ey) * stride, stride, bs, kAlpha[ia],
                kBeta[ib], tc0);
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

// Host launchers: one wave each, on `stream`. They do not check errors;
// the caller checks cudaGetLastError() right after each launch.
void launch_deblock_luma_wave(uint8_t* Y, int stride, const int32_t* qp,
                              const int32_t* disable, const int32_t* a_off,
                              const int32_t* b_off, const int32_t* slice_id,
                              const int32_t* t8, const int8_t* bs_v,
                              const int8_t* bs_h, int mb_w, int mb_h, int w,
                              cudaStream_t stream) {
  MbParams m = make_params(qp, disable, a_off, b_off, slice_id, t8, bs_v,
                           bs_h, mb_w, mb_h);
  deblock_luma_wave<<<mb_h, 16, 0, stream>>>(Y, stride, m, w);
}

void launch_deblock_chroma_wave(uint8_t* U, uint8_t* V, int stride,
                                const int32_t* qp, const int32_t* disable,
                                const int32_t* a_off, const int32_t* b_off,
                                const int32_t* slice_id, const int32_t* t8,
                                const int8_t* bs_v, const int8_t* bs_h,
                                const int32_t* qpc_cb, const int32_t* qpc_cr,
                                int mb_w, int mb_h, int w,
                                cudaStream_t stream) {
  MbParams m = make_params(qp, disable, a_off, b_off, slice_id, t8, bs_v,
                           bs_h, mb_w, mb_h);
  deblock_chroma_wave<<<mb_h, 16, 0, stream>>>(U, V, stride, m, qpc_cb,
                                               qpc_cr, w);
}
