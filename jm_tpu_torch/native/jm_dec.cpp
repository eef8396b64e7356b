/* jm_torch_native, decoder part: the CAVLC slice parser and the intra
 * reconstruction.
 *
 * The port's copy of jm_tpu's native/jm_dec.cpp. The decoder's phase-1
 * parse is strictly bit-serial and MB-ordered, the one stage of the
 * two-phase decoder that is not a batched tensor program, so it runs
 * natively, filling the same picture-wide SoA arrays that the Python
 * MBParser of jm_tpu_torch/decoder/mb_parse.py fills; phase 2 (the
 * residual decode, inter recon and deblock) then runs on the card.
 *
 * Capability parity with ldecod/src/mb_read.c
 * (read_one_macroblock_{i,p}_slice_cavlc), read_comp_cavlc.c
 * (readCoeff4x4_CAVLC) and lcommon/src/mv_prediction.c; the twin of the
 * Python parser (the same bits consumed, the same array fills).
 *
 * Coverage: I/P slices, 4:2:0, CAVLC, optional FMO successor map,
 * 8x8 transform. Stops (status 1) on I_PCM; the caller reruns the Python
 * parser from the slice start.
 *
 * intra_recon reconstructs every I4/I8/I16 MB of a picture in place, in
 * raster order (twin of decoder/recon.py Reconstructor's intra loop),
 * given the spatial residuals and planes that already hold the inter MBs.
 *
 * encode_i4_mb codes one MB as Intra4x4 for the encoder's host coders
 * (twin of encoder/p_intra.py IntraMBCoder._encode_i4_mb under flat
 * quant without an RD tier or the trellis; its levels in the caller's
 * scan, the zig-zag or a field picture's field scan), on the same
 * predictors and inverse transform as intra_recon.
 *
 * The CAVLC peek-LUTs are installed from Python (set_cavlc_dec_tables,
 * compiled by decoder/cavlc.py from common/cavlc_tables.py), the single
 * source of truth.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

/* ------------------------------------------------------------------ */
/* installed CAVLC decode LUTs (payload<<8 | length, 0 = invalid)      */
/* ------------------------------------------------------------------ */

#define CT_W 16
#define TZ_W 9
#define RUN_W 11

static int32_t *g_ct[3];        /* coeff_token by nC class, 2^16 each  */
static int32_t *g_ct_dc;        /* 4:2:0 chroma-DC coeff_token         */
static int32_t *g_tz[15];       /* total_zeros, 2^9 each               */
static int32_t *g_tz_dc[3];     /* 4:2:0 chroma-DC total_zeros         */
static int32_t *g_run[7];       /* run_before, 2^11 each               */
static int g_dec_tables_ready = 0;

static int32_t *copy_lut(PyObject *seq, Py_ssize_t idx, Py_ssize_t want) {
    PyObject *row = PySequence_GetItem(seq, idx);
    if (!row) return NULL;
    Py_buffer v;
    if (PyObject_GetBuffer(row, &v, PyBUF_SIMPLE) < 0) {
        Py_DECREF(row);
        return NULL;
    }
    if (v.len != want * (Py_ssize_t)sizeof(int32_t)) {
        PyErr_Format(PyExc_ValueError, "LUT %zd: bad size %zd", idx, v.len);
        PyBuffer_Release(&v);
        Py_DECREF(row);
        return NULL;
    }
    int32_t *out = (int32_t *)malloc(v.len);
    memcpy(out, v.buf, v.len);
    PyBuffer_Release(&v);
    Py_DECREF(row);
    return out;
}

static PyObject *m_set_cavlc_dec_tables(PyObject *mod, PyObject *args) {
    PyObject *ct, *ct_dc, *tz, *tz_dc, *run;
    if (!PyArg_ParseTuple(args, "OOOOO", &ct, &ct_dc, &tz, &tz_dc, &run))
        return NULL;
    for (int i = 0; i < 3; i++)
        if (!(g_ct[i] = copy_lut(ct, i, 1 << CT_W))) return NULL;
    if (!(g_ct_dc = copy_lut(ct_dc, 0, 1 << CT_W))) return NULL;
    for (int i = 0; i < 15; i++)
        if (!(g_tz[i] = copy_lut(tz, i, 1 << TZ_W))) return NULL;
    for (int i = 0; i < 3; i++)
        if (!(g_tz_dc[i] = copy_lut(tz_dc, i, 1 << TZ_W))) return NULL;
    for (int i = 0; i < 7; i++)
        if (!(g_run[i] = copy_lut(run, i, 1 << RUN_W))) return NULL;
    g_dec_tables_ready = 1;
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* borrowed-buffer bit reader                                          */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *data;
    int64_t nbits;
    int64_t pos;
    int64_t stop;      /* bit index of rbsp_stop_one_bit (-1: none)   */
    int err;           /* 1 after overrun / invalid code               */
} Rd;

static void rd_init(Rd *r, const uint8_t *data, Py_ssize_t nbytes,
                    int64_t pos) {
    r->data = data;
    r->nbits = (int64_t)nbytes * 8;
    r->pos = pos;
    r->err = 0;
    Py_ssize_t last = nbytes - 1;
    while (last >= 0 && data[last] == 0) last--;
    if (last < 0) {
        r->stop = -1;
    } else {
        uint8_t b = data[last];
        int low = 0;
        while (!((b >> low) & 1)) low++;
        r->stop = (int64_t)last * 8 + (7 - low);
    }
}

static inline int rd_more(Rd *r) {
    return r->pos < r->stop;
}

static inline uint32_t rd_u(Rd *r, int n) {
    if (n == 0) return 0;
    if (r->pos + n > r->nbits) { r->err = 1; return 0; }
    int64_t p = r->pos;
    int64_t byte0 = p >> 3;
    int nbytes = (int)(((p & 7) + n + 7) >> 3);
    uint64_t acc = 0;
    for (int i = 0; i < nbytes; i++) acc = (acc << 8) | r->data[byte0 + i];
    int shift = nbytes * 8 - (int)(p & 7) - n;
    r->pos = p + n;
    return (uint32_t)((acc >> shift) & ((1ULL << n) - 1));
}

static inline int rd_flag(Rd *r) {
    if (r->pos >= r->nbits) { r->err = 1; return 0; }
    int64_t p = r->pos++;
    return (r->data[p >> 3] >> (7 - (p & 7))) & 1;
}

static inline int64_t rd_ue(Rd *r) {
    int zeros = 0;
    for (;;) {
        if (r->pos >= r->nbits) { r->err = 1; return 0; }
        if (rd_flag(r)) break;
        if (++zeros > 32) { r->err = 1; return 0; }
    }
    if (zeros == 0) return 0;
    return (((int64_t)1 << zeros) - 1) + rd_u(r, zeros);
}

static inline int64_t rd_se(Rd *r) {
    int64_t k = rd_ue(r);
    return (k & 1) ? ((k + 1) >> 1) : -(k >> 1);
}

static inline int rd_te(Rd *r, int rng) {
    if (rng == 1) return 1 - rd_flag(r);
    return (int)rd_ue(r);
}

static inline uint32_t rd_peek_pad(Rd *r, int n) {
    int64_t avail = r->nbits - r->pos;
    int64_t save = r->pos;
    uint32_t v;
    if (avail >= n) {
        v = rd_u(r, n);
        r->pos = save;
        return v;
    }
    if (avail <= 0) return 0;
    v = rd_u(r, (int)avail);
    r->pos = save;
    return v << (n - avail);
}

static inline int rd_zeros_until_one(Rd *r) {
    int n = 0;
    while (!rd_flag(r)) {
        if (r->err) return 0;
        if (++n > 32) { r->err = 1; return 0; }
    }
    return n;
}

static inline int rd_read_lut(Rd *r, const int32_t *lut, int width) {
    int32_t v = lut[rd_peek_pad(r, width)];
    if (v == 0) { r->err = 1; return 0; }
    r->pos += v & 0xFF;
    return v >> 8;
}

/* ------------------------------------------------------------------ */
/* CAVLC residual block decode (decoder/cavlc.py residual_block_cavlc) */
/* ------------------------------------------------------------------ */

/* nc >= 0: luma/chroma-AC classes; nc == -1: 4:2:0 chroma DC */
static int residual_block(Rd *r, int nc, int max_coeff, int32_t *out) {
    memset(out, 0, max_coeff * sizeof(int32_t));
    int total_coeff, trailing_ones;
    if (nc >= 8) {
        uint32_t code = rd_u(r, 6);
        trailing_ones = code & 3;
        total_coeff = code >> 2;
        if (total_coeff == 0 && trailing_ones == 3) {
            total_coeff = 0;
            trailing_ones = 0;
        } else {
            total_coeff += 1;
        }
    } else {
        const int32_t *lut = (nc >= 0)
            ? g_ct[nc < 2 ? 0 : (nc < 4 ? 1 : 2)]
            : g_ct_dc;
        int payload = rd_read_lut(r, lut, CT_W);
        total_coeff = payload >> 2;
        trailing_ones = payload & 3;
    }
    if (r->err || total_coeff == 0) return 0;

    int suffix_len = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;
    int32_t levels[16];
    for (int i = 0; i < total_coeff; i++) {
        if (i < trailing_ones) {
            levels[i] = 1 - 2 * rd_flag(r);
            continue;
        }
        int prefix = rd_zeros_until_one(r);
        if (r->err) return 0;
        int size;
        if (prefix == 14 && suffix_len == 0) size = 4;
        else if (prefix >= 15) size = prefix - 3;
        else size = suffix_len;
        int64_t level_code = (int64_t)(prefix < 15 ? prefix : 15)
                             << suffix_len;
        if (size > 0) level_code += rd_u(r, size);
        if (prefix >= 15 && suffix_len == 0) level_code += 15;
        if (prefix >= 16) level_code += ((int64_t)1 << (prefix - 3)) - 4096;
        if (i == trailing_ones && trailing_ones < 3) level_code += 2;
        int64_t level;
        if ((level_code & 1) == 0) level = (level_code + 2) >> 1;
        else level = -((level_code + 1) >> 1);
        levels[i] = (int32_t)level;
        if (suffix_len == 0) suffix_len = 1;
        int64_t a = level < 0 ? -level : level;
        if (a > (3LL << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }

    int total_zeros = 0;
    if (total_coeff < max_coeff) {
        if (max_coeff == 4)
            total_zeros = rd_read_lut(r, g_tz_dc[total_coeff - 1], TZ_W);
        else
            total_zeros = rd_read_lut(r, g_tz[total_coeff - 1], TZ_W);
        if (r->err) return 0;
    }

    int pos = total_coeff - 1 + total_zeros;
    int zeros_left = total_zeros;
    for (int i = 0; i < total_coeff; i++) {
        if (pos < 0 || pos >= max_coeff) { r->err = 1; return 0; }
        out[pos] = levels[i];
        if (i == total_coeff - 1) break;
        int run = 0;
        if (zeros_left > 0) {
            int zl = zeros_left < 7 ? zeros_left : 7;
            run = rd_read_lut(r, g_run[zl - 1], RUN_W);
            if (r->err) return 0;
        }
        zeros_left -= run;
        pos -= run + 1;
    }
    return total_coeff;
}

/* ------------------------------------------------------------------ */
/* picture SoA views                                                   */
/* ------------------------------------------------------------------ */

typedef struct {
    int n, mb_w;
    int8_t *mb_class;
    uint8_t *skip;              /* numpy bool */
    uint8_t *transform8x8;
    int8_t *i4_modes;           /* (n,16) */
    int8_t *i16_mode;
    int8_t *chroma_mode;
    int32_t *cbp;
    int32_t *qp;
    int32_t *slice_id;
    int32_t *luma_coef;         /* (n,16,16) */
    int32_t *luma_dc;           /* (n,16)    */
    int32_t *chroma_dc;         /* (n,2,4)   */
    int32_t *chroma_coef;       /* (n,2,4,16)*/
    int32_t *luma_coef8;        /* (n,4,64)  */
    int32_t *luma_nnz;          /* (n,16)    */
    int32_t *chroma_nnz;        /* (n,2,4)   */
    int32_t *mv;                /* (n,16,2)  */
    int8_t *ref_idx;            /* (n,4)     */
    int8_t *sub_mode;           /* (n,4)     */
    const int32_t *succ;        /* FMO next-mb map or NULL */
} Pic;

/* raster <-> z (coding) order of 4x4 blocks in a MB */
static const int RASTER2CODE[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                    8, 9, 12, 13, 10, 11, 14, 15};
static const int CODE2RASTER[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                    8, 9, 12, 13, 10, 11, 14, 15};
/* (these arrays are inverse permutations of each other and happen to be
 * self-inverse, matching common/predict_ctx.py CODE2RASTER/RASTER2CODE) */

/* spec Table 9-4 coded_block_pattern, codeNum -> (intra, inter), 4:2:0 */
static const uint8_t CBP_TAB[48][2] = {
    {47, 0}, {31, 16}, {15, 1}, {0, 2}, {23, 4}, {27, 8}, {29, 32}, {30, 3},
    {7, 5}, {11, 10}, {13, 12}, {14, 15}, {39, 47}, {43, 7}, {45, 11},
    {46, 13}, {16, 14}, {3, 6}, {5, 9}, {10, 31}, {12, 35}, {19, 37},
    {21, 42}, {26, 44}, {28, 33}, {35, 34}, {37, 36}, {42, 40}, {44, 39},
    {1, 43}, {2, 45}, {4, 46}, {8, 17}, {17, 18}, {18, 20}, {20, 24},
    {24, 19}, {6, 21}, {9, 26}, {22, 28}, {25, 23}, {32, 27}, {33, 29},
    {34, 30}, {36, 22}, {40, 25}, {38, 38}, {41, 41},
};

/* ------------------------------------------------------------------ */
/* neighbor / prediction context (common/predict_ctx.py twin)          */
/* ------------------------------------------------------------------ */

static inline int avail(const Pic *p, int naddr, int cur) {
    return naddr >= 0 && naddr < p->n
        && p->slice_id[naddr] == p->slice_id[cur];
}

static inline int left_addr(const Pic *p, int addr) {
    return (addr % p->mb_w) ? addr - 1 : -1;
}

static inline int combine_nc(int na, int aa, int nb, int ab) {
    if (aa && ab) return (na + nb + 1) >> 1;
    if (aa) return na;
    if (ab) return nb;
    return 0;
}

static int nc_luma(const Pic *p, int addr, int blk) {
    int bx = blk & 3, by = blk >> 2;
    int a_addr, a_blk, aa, b_addr, b_blk, ab;
    if (bx > 0) { a_addr = addr; a_blk = blk - 1; aa = 1; }
    else {
        a_addr = left_addr(p, addr); a_blk = blk + 3;
        aa = avail(p, a_addr, addr);
    }
    if (by > 0) { b_addr = addr; b_blk = blk - 4; ab = 1; }
    else {
        b_addr = addr - p->mb_w; b_blk = blk + 12;
        ab = avail(p, b_addr, addr);
    }
    return combine_nc(aa ? p->luma_nnz[a_addr * 16 + a_blk] : 0, aa,
                      ab ? p->luma_nnz[b_addr * 16 + b_blk] : 0, ab);
}

static int nc_chroma(const Pic *p, int addr, int comp, int blk) {
    int bx = blk & 1, by = blk >> 1;
    int a_addr, a_blk, aa, b_addr, b_blk, ab;
    if (bx > 0) { a_addr = addr; a_blk = blk - 1; aa = 1; }
    else {
        a_addr = left_addr(p, addr); a_blk = blk + 1;
        aa = avail(p, a_addr, addr);
    }
    if (by > 0) { b_addr = addr; b_blk = blk - 2; ab = 1; }
    else {
        b_addr = addr - p->mb_w; b_blk = blk + 2;
        ab = avail(p, b_addr, addr);
    }
    return combine_nc(
        aa ? p->chroma_nnz[(a_addr * 2 + comp) * 4 + a_blk] : 0, aa,
        ab ? p->chroma_nnz[(b_addr * 2 + comp) * 4 + b_blk] : 0, ab);
}

static int pred_intra4_mode(const Pic *p, int addr, int blk) {
    int bx = blk & 3, by = blk >> 2;
    int ma, mb, aa, ab;
    if (bx > 0) {
        ma = p->i4_modes[addr * 16 + blk - 1];
        aa = 1;
        if (p->mb_class[addr] != 1) ma = 2;
    } else {
        int a_addr = left_addr(p, addr);
        aa = avail(p, a_addr, addr);
        ma = aa ? p->i4_modes[a_addr * 16 + blk + 3] : -1;
        if (aa && p->mb_class[a_addr] != 1) ma = 2;
    }
    if (by > 0) {
        mb = p->i4_modes[addr * 16 + blk - 4];
        ab = 1;
        if (p->mb_class[addr] != 1) mb = 2;
    } else {
        int b_addr = addr - p->mb_w;
        ab = avail(p, b_addr, addr);
        mb = ab ? p->i4_modes[b_addr * 16 + blk + 12] : -1;
        if (ab && p->mb_class[b_addr] != 1) mb = 2;
    }
    if (!aa || !ab) return 2;
    return ma < mb ? ma : mb;
}

/* mv_neighbor: returns 1 if the (bx,by)-relative 4x4 block exists
 * (available); fills mv[2] and *ref (-1 = intra/no motion). */
static int mv_neighbor(const Pic *p, int addr, int bx, int by, int cur_blk,
                       int32_t mv[2], int *ref) {
    int mbx = addr % p->mb_w, mby = addr / p->mb_w;
    int gx = mbx * 4 + bx, gy = mby * 4 + by;
    if (gx < 0 || gy < 0 || gx >= p->mb_w * 4) return 0;
    int naddr = (gy >> 2) * p->mb_w + (gx >> 2);
    int nblk = (gy & 3) * 4 + (gx & 3);
    if (naddr == addr) {
        if (RASTER2CODE[nblk] >= RASTER2CODE[cur_blk]) return 0;
    } else {
        if (naddr > addr || !avail(p, naddr, addr)) return 0;
    }
    int q = (nblk >> 3) * 2 + ((nblk & 3) >> 1);
    int r = p->ref_idx[naddr * 4 + q];
    if (r < 0) {
        mv[0] = 0;
        mv[1] = 0;
        *ref = -1;
        return 1;
    }
    mv[0] = p->mv[(naddr * 16 + nblk) * 2];
    mv[1] = p->mv[(naddr * 16 + nblk) * 2 + 1];
    *ref = r;
    return 1;
}

static inline int32_t med3(int32_t a, int32_t b, int32_t c) {
    int32_t mx = a > b ? a : b;
    int32_t mn = a < b ? a : b;
    if (c > mx) return mx;
    if (c < mn) return mn;
    return c;
}

static void mv_pred(const Pic *p, int addr, int bx, int by, int bw, int bh,
                    int ref, int32_t out[2]) {
    int cur = by * 4 + bx;
    int32_t mva[2] = {0, 0}, mvb[2] = {0, 0}, mvc[2] = {0, 0};
    int refa = -2, refb = -2, refc = -2;
    int ha = mv_neighbor(p, addr, bx - 1, by, cur, mva, &refa);
    int hb = mv_neighbor(p, addr, bx, by - 1, cur, mvb, &refb);
    int hc = mv_neighbor(p, addr, bx + bw, by - 1, cur, mvc, &refc);
    if (!hc) {
        refc = -2;
        mvc[0] = mvc[1] = 0;
        hc = mv_neighbor(p, addr, bx - 1, by - 1, cur, mvc, &refc);
        if (!hc) { refc = -2; mvc[0] = mvc[1] = 0; }
    }
    if (!ha) { refa = -2; mva[0] = mva[1] = 0; }
    if (!hb) { refb = -2; mvb[0] = mvb[1] = 0; }

    if (bw == 4 && bh == 2) {          /* 16x8 */
        if (by == 0 && hb && refb == ref) { out[0] = mvb[0]; out[1] = mvb[1]; return; }
        if (by == 2 && ha && refa == ref) { out[0] = mva[0]; out[1] = mva[1]; return; }
    } else if (bw == 2 && bh == 4) {   /* 8x16 */
        if (bx == 0 && ha && refa == ref) { out[0] = mva[0]; out[1] = mva[1]; return; }
        if (bx == 2 && hc && refc == ref) { out[0] = mvc[0]; out[1] = mvc[1]; return; }
    }

    if (ha && !hb && !hc) { out[0] = mva[0]; out[1] = mva[1]; return; }
    int na = refa == ref, nb = refb == ref, nc = refc == ref;
    if (na + nb + nc == 1) {
        if (na) { out[0] = mva[0]; out[1] = mva[1]; }
        else if (nb) { out[0] = mvb[0]; out[1] = mvb[1]; }
        else { out[0] = mvc[0]; out[1] = mvc[1]; }
        return;
    }
    out[0] = med3(mva[0], mvb[0], mvc[0]);
    out[1] = med3(mva[1], mvb[1], mvc[1]);
}

static void skip_mv(const Pic *p, int addr, int32_t out[2]) {
    int32_t mva[2], mvb[2];
    int refa, refb;
    int ha = mv_neighbor(p, addr, -1, 0, 0, mva, &refa);
    int hb = mv_neighbor(p, addr, 0, -1, 0, mvb, &refb);
    if (!ha || !hb
        || (refa == 0 && mva[0] == 0 && mva[1] == 0)
        || (refb == 0 && mvb[0] == 0 && mvb[1] == 0)) {
        out[0] = 0;
        out[1] = 0;
        return;
    }
    mv_pred(p, addr, 0, 0, 4, 4, 0, out);
}

/* ------------------------------------------------------------------ */
/* MB parsing                                                          */
/* ------------------------------------------------------------------ */

typedef struct {
    Pic *p;
    Rd *r;
    int qp;                 /* running slice QP */
    int sid;
    int nref;
    int t8_flag;            /* pps transform_8x8_mode_flag */
    int qp_off;             /* QpBdOffsetY = 6 * bit_depth_luma_minus8 */
} Ctx;

/* spec 7.4.5: QPY wraps over [-QpBdOffsetY, 51]; the delta's range check
 * is jm_tpu's (mb_parse.py _read_qp_delta) */
static int read_qp_delta(Ctx *c, int addr) {
    int64_t dq = rd_se(c->r);
    if (c->r->err) return -1;
    const int off = c->qp_off;
    if (dq < -(27 + off / 2) || dq > 26 + off / 2) {
        PyErr_Format(PyExc_ValueError, "mb_qp_delta %lld out of range",
                     (long long)dq);
        return -1;
    }
    c->qp = (int)((c->qp + dq + 52 + 2 * off) % (52 + off)) - off;
    c->p->qp[addr] = c->qp;
    return 0;
}

static int read_luma_residual(Ctx *c, int addr, int cbp, int is_i16) {
    Pic *p = c->p;
    int32_t buf[16];
    if (is_i16) {
        int nc = nc_luma(p, addr, 0);
        residual_block(c->r, nc, 16, buf);
        if (c->r->err) return -1;
        memcpy(&p->luma_dc[addr * 16], buf, 16 * sizeof(int32_t));
    }
    for (int blk8 = 0; blk8 < 4; blk8++) {
        if (!(cbp & (1 << blk8))) continue;
        for (int sub = 0; sub < 4; sub++) {
            int blk = CODE2RASTER[blk8 * 4 + sub];
            int nc = nc_luma(p, addr, blk);
            int32_t *dst = &p->luma_coef[(addr * 16 + blk) * 16];
            int tc;
            if (is_i16) {
                tc = residual_block(c->r, nc, 15, buf);
                if (c->r->err) return -1;
                dst[0] = 0;
                memcpy(dst + 1, buf, 15 * sizeof(int32_t));
            } else {
                tc = residual_block(c->r, nc, 16, buf);
                if (c->r->err) return -1;
                memcpy(dst, buf, 16 * sizeof(int32_t));
            }
            p->luma_nnz[addr * 16 + blk] = tc;
        }
    }
    return 0;
}

static int read_luma_residual_8x8(Ctx *c, int addr, int cbp) {
    Pic *p = c->p;
    int32_t buf[16];
    for (int blk8 = 0; blk8 < 4; blk8++) {
        if (!(cbp & (1 << blk8))) continue;
        int by0 = (blk8 >> 1) * 2, bx0 = (blk8 & 1) * 2;
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++) {
                int blk = (by0 + dy) * 4 + bx0 + dx;
                int sub = 2 * dy + dx;
                int nc = nc_luma(p, addr, blk);
                int tc = residual_block(c->r, nc, 16, buf);
                if (c->r->err) return -1;
                p->luma_nnz[addr * 16 + blk] = tc;
                int32_t *dst = &p->luma_coef8[(addr * 4 + blk8) * 64];
                for (int i = 0; i < 16; i++)
                    if (buf[i]) dst[i * 4 + sub] = buf[i];
            }
    }
    return 0;
}

static int read_chroma_residual(Ctx *c, int addr, int cbp) {
    Pic *p = c->p;
    int32_t buf[16];
    int cbp_chroma = cbp >> 4;
    if (cbp_chroma & 3) {
        for (int comp = 0; comp < 2; comp++) {
            residual_block(c->r, -1, 4, buf);
            if (c->r->err) return -1;
            memcpy(&p->chroma_dc[(addr * 2 + comp) * 4], buf,
                   4 * sizeof(int32_t));
        }
    }
    if (cbp_chroma & 2) {
        for (int comp = 0; comp < 2; comp++)
            for (int blk = 0; blk < 4; blk++) {
                int nc = nc_chroma(p, addr, comp, blk);
                int tc = residual_block(c->r, nc, 15, buf);
                if (c->r->err) return -1;
                int32_t *dst =
                    &p->chroma_coef[((addr * 2 + comp) * 4 + blk) * 16];
                dst[0] = 0;
                memcpy(dst + 1, buf, 15 * sizeof(int32_t));
                p->chroma_nnz[(addr * 2 + comp) * 4 + blk] = tc;
            }
    }
    return 0;
}

/* returns 0 ok, -1 error, 1 unsupported (IPCM) */
static int parse_intra_mb(Ctx *c, int addr, int imb_type) {
    Pic *p = c->p;
    Rd *r = c->r;
    if (imb_type == 25) return 1;       /* IPCM: python fallback */
    if (imb_type == 0) {
        p->mb_class[addr] = 1;          /* MB_I4 */
        if (c->t8_flag) p->transform8x8[addr] = (uint8_t)rd_flag(r);
        if (p->transform8x8[addr]) {
            for (int q = 0; q < 4; q++) {
                int blk_tl = (q >> 1) * 8 + (q & 1) * 2;
                int pred = pred_intra4_mode(p, addr, blk_tl);
                int mode;
                if (rd_flag(r)) mode = pred;
                else {
                    int rem = rd_u(r, 3);
                    mode = rem < pred ? rem : rem + 1;
                }
                for (int dy = 0; dy < 2; dy++)
                    for (int dx = 0; dx < 2; dx++)
                        p->i4_modes[addr * 16 + blk_tl + dy * 4 + dx] =
                            (int8_t)mode;
            }
        } else {
            for (int ci = 0; ci < 16; ci++) {
                int blk = CODE2RASTER[ci];
                int pred = pred_intra4_mode(p, addr, blk);
                int mode;
                if (rd_flag(r)) mode = pred;
                else {
                    int rem = rd_u(r, 3);
                    mode = rem < pred ? rem : rem + 1;
                }
                p->i4_modes[addr * 16 + blk] = (int8_t)mode;
            }
        }
        p->chroma_mode[addr] = (int8_t)rd_ue(r);
        int64_t cbp_code = rd_ue(r);
        if (r->err) return -1;
        if (cbp_code >= 48) {
            PyErr_SetString(PyExc_ValueError, "invalid cbp code");
            return -1;
        }
        int cbp = CBP_TAB[cbp_code][0];
        p->cbp[addr] = cbp;
        if (cbp) {
            if (read_qp_delta(c, addr) < 0) return -1;
        } else {
            p->qp[addr] = c->qp;
        }
        if (p->transform8x8[addr]) {
            if (read_luma_residual_8x8(c, addr, cbp & 15) < 0) return -1;
        } else {
            if (read_luma_residual(c, addr, cbp, 0) < 0) return -1;
        }
        if (read_chroma_residual(c, addr, cbp) < 0) return -1;
    } else {
        p->mb_class[addr] = 2;          /* MB_I16 */
        int k = imb_type - 1;
        p->i16_mode[addr] = (int8_t)(k % 4);
        int cbp = (((k / 4) % 3) << 4) | (k >= 12 ? 15 : 0);
        p->cbp[addr] = cbp;
        p->chroma_mode[addr] = (int8_t)rd_ue(r);
        if (read_qp_delta(c, addr) < 0) return -1;
        if (read_luma_residual(c, addr, cbp & 15, 1) < 0) return -1;
        if (read_chroma_residual(c, addr, cbp) < 0) return -1;
    }
    if (r->err) return -1;
    return 0;
}

static void p_skip(Ctx *c, int addr) {
    Pic *p = c->p;
    p->mb_class[addr] = 0;
    p->skip[addr] = 1;
    for (int q = 0; q < 4; q++) p->ref_idx[addr * 4 + q] = 0;
    p->qp[addr] = c->qp;
    int32_t mv[2];
    skip_mv(p, addr, mv);
    for (int b = 0; b < 16; b++) {
        p->mv[(addr * 16 + b) * 2] = mv[0];
        p->mv[(addr * 16 + b) * 2 + 1] = mv[1];
    }
}

/* part geometry tables for P mb_type 0..2 */
static const int PARTS[3][2][4] = {
    /* mb_type 0: one 16x16 */
    {{0, 0, 4, 4}, {-1, 0, 0, 0}},
    /* mb_type 1: two 16x8 */
    {{0, 0, 4, 2}, {0, 2, 4, 2}},
    /* mb_type 2: two 8x16 */
    {{0, 0, 2, 4}, {2, 0, 2, 4}},
};

static const int SUBPARTS[4][4][4] = {
    {{0, 0, 2, 2}, {-1, 0, 0, 0}, {-1, 0, 0, 0}, {-1, 0, 0, 0}},
    {{0, 0, 2, 1}, {0, 1, 2, 1}, {-1, 0, 0, 0}, {-1, 0, 0, 0}},
    {{0, 0, 1, 2}, {1, 0, 1, 2}, {-1, 0, 0, 0}, {-1, 0, 0, 0}},
    {{0, 0, 1, 1}, {1, 0, 1, 1}, {0, 1, 1, 1}, {1, 1, 1, 1}},
};

/* returns 0 ok, -1 error, 1 unsupported */
static int parse_p_mb(Ctx *c, int addr, int mb_type) {
    Pic *p = c->p;
    Rd *r = c->r;
    int sub_types[4] = {0, 0, 0, 0};
    int have_sub = 0;

    if (mb_type <= 2) {
        p->mb_class[addr] = 0;
        int nparts = mb_type == 0 ? 1 : 2;
        int refs[2] = {0, 0};
        for (int i = 0; i < nparts; i++)
            refs[i] = (c->nref > 1) ? rd_te(r, c->nref - 1) : 0;
        if (r->err) return -1;
        for (int i = 0; i < nparts; i++) {
            const int *pt = PARTS[mb_type][i];
            for (int yy = pt[1]; yy < pt[1] + pt[3]; yy++)
                for (int xx = pt[0]; xx < pt[0] + pt[2]; xx++) {
                    int q = (yy >> 1) * 2 + (xx >> 1);
                    p->ref_idx[addr * 4 + q] = (int8_t)refs[i];
                }
        }
        for (int i = 0; i < nparts; i++) {
            const int *pt = PARTS[mb_type][i];
            int32_t mvd[2], pred[2];
            mvd[0] = (int32_t)rd_se(r);
            mvd[1] = (int32_t)rd_se(r);
            if (r->err) return -1;
            mv_pred(p, addr, pt[0], pt[1], pt[2], pt[3], refs[i], pred);
            int32_t mvx = pred[0] + mvd[0], mvy = pred[1] + mvd[1];
            for (int yy = pt[1]; yy < pt[1] + pt[3]; yy++)
                for (int xx = pt[0]; xx < pt[0] + pt[2]; xx++) {
                    p->mv[(addr * 16 + yy * 4 + xx) * 2] = mvx;
                    p->mv[(addr * 16 + yy * 4 + xx) * 2 + 1] = mvy;
                }
        }
    } else if (mb_type <= 4) {
        p->mb_class[addr] = 0;
        have_sub = 1;
        for (int q = 0; q < 4; q++) {
            sub_types[q] = (int)rd_ue(r);
            if (r->err) return -1;
            if (sub_types[q] > 3) {
                PyErr_SetString(PyExc_ValueError, "invalid sub_mb_type");
                return -1;
            }
            p->sub_mode[addr * 4 + q] = (int8_t)sub_types[q];
        }
        int refs[4] = {0, 0, 0, 0};
        if (mb_type == 3 && c->nref > 1)
            for (int q = 0; q < 4; q++) refs[q] = rd_te(r, c->nref - 1);
        if (r->err) return -1;
        for (int q = 0; q < 4; q++)
            p->ref_idx[addr * 4 + q] = (int8_t)refs[q];
        for (int q = 0; q < 4; q++) {
            int qx = (q & 1) * 2, qy = (q >> 1) * 2;
            int st = sub_types[q];
            for (int s = 0; s < 4; s++) {
                const int *sp = SUBPARTS[st][s];
                if (sp[0] < 0) break;
                int bx = qx + sp[0], by = qy + sp[1];
                int32_t mvd[2], pred[2];
                mvd[0] = (int32_t)rd_se(r);
                mvd[1] = (int32_t)rd_se(r);
                if (r->err) return -1;
                mv_pred(p, addr, bx, by, sp[2], sp[3], refs[q], pred);
                int32_t mvx = pred[0] + mvd[0], mvy = pred[1] + mvd[1];
                for (int yy = by; yy < by + sp[3]; yy++)
                    for (int xx = bx; xx < bx + sp[2]; xx++) {
                        p->mv[(addr * 16 + yy * 4 + xx) * 2] = mvx;
                        p->mv[(addr * 16 + yy * 4 + xx) * 2 + 1] = mvy;
                    }
            }
        }
    } else {
        return parse_intra_mb(c, addr, mb_type - 5);
    }

    int64_t cbp_code = rd_ue(r);
    if (r->err) return -1;
    if (cbp_code >= 48) {
        PyErr_SetString(PyExc_ValueError, "invalid cbp code");
        return -1;
    }
    int cbp = CBP_TAB[cbp_code][1];
    p->cbp[addr] = cbp;
    int allow8 = (mb_type <= 2)
        || (have_sub && sub_types[0] == 0 && sub_types[1] == 0
            && sub_types[2] == 0 && sub_types[3] == 0);
    if (c->t8_flag && (cbp & 15) && allow8)
        p->transform8x8[addr] = (uint8_t)rd_flag(r);
    if (cbp) {
        if (read_qp_delta(c, addr) < 0) return -1;
    } else {
        p->qp[addr] = c->qp;
    }
    if (p->transform8x8[addr]) {
        if (read_luma_residual_8x8(c, addr, cbp & 15) < 0) return -1;
    } else {
        if (read_luma_residual(c, addr, cbp & 15, 0) < 0) return -1;
    }
    if (read_chroma_residual(c, addr, cbp) < 0) return -1;
    if (r->err) return -1;
    return 0;
}

/* ------------------------------------------------------------------ */
/* module entry                                                        */
/* ------------------------------------------------------------------ */

typedef struct {
    Py_buffer view;
    int held;
} Held;

static void *want_arr(PyObject *dict, const char *key, Held *h, int *nheld,
                      Py_ssize_t want_len) {
    PyObject *o = PyDict_GetItemString(dict, key);
    if (!o) {
        PyErr_Format(PyExc_KeyError, "missing array '%s'", key);
        return NULL;
    }
    Held *slot = &h[*nheld];
    if (PyObject_GetBuffer(o, &slot->view, PyBUF_WRITABLE) < 0) return NULL;
    slot->held = 1;
    (*nheld)++;
    if (want_len >= 0 && slot->view.len != want_len) {
        PyErr_Format(PyExc_ValueError, "array '%s': expected %zd bytes, got %zd",
                     key, want_len, slot->view.len);
        return NULL;
    }
    return slot->view.buf;
}

/* parse_slice_cavlc(buffer, pos, params, arrays) -> (status, new_pos)
 * status: 0 = parsed, 1 = unsupported construct (no arrays touched
 * beyond what a deterministic Python re-parse rewrites identically). */
static PyObject *m_parse_slice_cavlc(PyObject *mod, PyObject *args) {
    PyObject *bufobj, *params, *arrays;
    long long pos0;
    if (!PyArg_ParseTuple(args, "OLOO", &bufobj, &pos0, &params, &arrays))
        return NULL;
    if (!g_dec_tables_ready) {
        PyErr_SetString(PyExc_RuntimeError, "CAVLC decode tables not set");
        return NULL;
    }

    Py_buffer data;
    if (PyObject_GetBuffer(bufobj, &data, PyBUF_SIMPLE) < 0) return NULL;

#define GETI(name) \
    PyObject *o_##name = PyDict_GetItemString(params, #name); \
    long long name = o_##name ? PyLong_AsLongLong(o_##name) : -1; \
    if ((name == -1 && PyErr_Occurred()) || !o_##name) { \
        if (!PyErr_Occurred()) \
            PyErr_Format(PyExc_KeyError, "missing param '%s'", #name); \
        PyBuffer_Release(&data); \
        return NULL; \
    }
    GETI(first_mb)
    GETI(n_mbs)
    GETI(mb_w)
    GETI(stype)          /* 0 = I, 1 = P */
    GETI(slice_id)
    GETI(qp)
    GETI(nref)
    GETI(t8)
    GETI(qp_bd_offset)
#undef GETI

    Held held[24];
    int nheld = 0;
    Pic pic;
    memset(&pic, 0, sizeof(pic));
    pic.n = (int)n_mbs;
    pic.mb_w = (int)mb_w;
    long long n = n_mbs;
    int ok = 1;
#define ARR(field, key, want) \
    if (ok && !(pic.field = (decltype(pic.field))want_arr( \
            arrays, key, held, &nheld, want))) ok = 0;
    ARR(mb_class, "mb_class", n)
    ARR(skip, "skip", n)
    ARR(transform8x8, "transform8x8", n)
    ARR(i4_modes, "i4_modes", n * 16)
    ARR(i16_mode, "i16_mode", n)
    ARR(chroma_mode, "chroma_mode", n)
    ARR(cbp, "cbp", n * 4)
    ARR(qp, "qp", n * 4)
    ARR(slice_id, "slice_id", n * 4)
    ARR(luma_coef, "luma_coef", n * 16 * 16 * 4)
    ARR(luma_dc, "luma_dc", n * 16 * 4)
    ARR(chroma_dc, "chroma_dc", n * 2 * 4 * 4)
    ARR(chroma_coef, "chroma_coef", n * 2 * 4 * 16 * 4)
    ARR(luma_coef8, "luma_coef8", n * 4 * 64 * 4)
    ARR(luma_nnz, "luma_nnz", n * 16 * 4)
    ARR(chroma_nnz, "chroma_nnz", n * 2 * 4 * 4)
    ARR(mv, "mv", n * 16 * 2 * 4)
    ARR(ref_idx, "ref_idx", n * 4)
    ARR(sub_mode, "sub_mode", n * 4)
#undef ARR
    PyObject *succ_o = PyDict_GetItemString(arrays, "succ");
    Py_buffer succ_v;
    int succ_held = 0;
    if (ok && succ_o && succ_o != Py_None) {
        if (PyObject_GetBuffer(succ_o, &succ_v, PyBUF_SIMPLE) < 0) ok = 0;
        else {
            succ_held = 1;
            pic.succ = (const int32_t *)succ_v.buf;
        }
    }

    int status = 0;
    long long addr = first_mb;
    if (ok) {
        Rd r;
        rd_init(&r, (const uint8_t *)data.buf, data.len, pos0);
        Ctx c;
        c.p = &pic;
        c.r = &r;
        c.qp = (int)qp;
        c.sid = (int)slice_id;
        c.nref = (int)nref;
        c.t8_flag = (int)t8;
        c.qp_off = (int)qp_bd_offset;

#define NEXT(a) (pic.succ ? pic.succ[a] : (a) + 1)
        if (stype == 0) {              /* I slice */
            for (;;) {
                pic.slice_id[addr] = c.sid;
                int64_t mb_type = rd_ue(&r);
                if (r.err) { ok = 0; break; }
                int st = parse_intra_mb(&c, addr, (int)mb_type);
                if (st < 0) { ok = 0; break; }
                if (st > 0) { status = 1; break; }
                addr = NEXT(addr);
                if (addr >= n || !rd_more(&r)) break;
            }
        } else {                       /* P slice */
            while (addr < n) {
                int64_t skip_run = rd_ue(&r);
                if (r.err) { ok = 0; break; }
                for (int64_t i = 0; i < skip_run; i++) {
                    if (addr >= n) {
                        PyErr_SetString(PyExc_ValueError,
                                        "mb_skip_run past end of picture");
                        ok = 0;
                        break;
                    }
                    pic.slice_id[addr] = c.sid;
                    p_skip(&c, addr);
                    addr = NEXT(addr);
                }
                if (!ok) break;
                if (addr >= n || !rd_more(&r)) break;
                pic.slice_id[addr] = c.sid;
                int64_t mb_type = rd_ue(&r);
                if (r.err) { ok = 0; break; }
                int st = parse_p_mb(&c, addr, (int)mb_type);
                if (st < 0) { ok = 0; break; }
                if (st > 0) { status = 1; break; }
                addr = NEXT(addr);
                if (!rd_more(&r)) break;
            }
        }
#undef NEXT
        if (!ok && !PyErr_Occurred())
            PyErr_Format(PyExc_ValueError,
                         "bitstream error in slice data at bit %lld "
                         "(mb %lld)", (long long)r.pos, (long long)addr);
        pos0 = r.pos;
    }

    for (int i = 0; i < nheld; i++) PyBuffer_Release(&held[i].view);
    if (succ_held) PyBuffer_Release(&succ_v);
    PyBuffer_Release(&data);
    if (!ok) return NULL;
    return Py_BuildValue("(iL)", status, pos0);
}

/* ------------------------------------------------------------------ */
/* intra reconstruction (decoder/recon.py intra paths, ops/intra.py)   */
/* ------------------------------------------------------------------ */

/* modes: 0 VERT 1 HOR 2 DC 3 DDL 4 DDR 5 VR 6 HD 7 VL 8 HU */

static void predict_i4(int mode, const int32_t *t, const int32_t *l,
                       int32_t m, int at, int al, int32_t p[4][4]) {
    int x, y;
    switch (mode) {
    case 0:
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) p[y][x] = t[x];
        break;
    case 1:
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) p[y][x] = l[y];
        break;
    case 2: {
        int32_t v;
        if (at && al)
            v = (t[0] + t[1] + t[2] + t[3] + l[0] + l[1] + l[2] + l[3]
                 + 4) >> 3;
        else if (at) v = (t[0] + t[1] + t[2] + t[3] + 2) >> 2;
        else if (al) v = (l[0] + l[1] + l[2] + l[3] + 2) >> 2;
        else v = 128;
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) p[y][x] = v;
        break;
    }
    case 3:
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++)
                p[y][x] = (x == 3 && y == 3)
                    ? (t[6] + 3 * t[7] + 2) >> 2
                    : (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2;
        break;
    case 4: {
        int32_t tt[9], ll[5];
        tt[0] = m;
        for (x = 0; x < 8; x++) tt[x + 1] = t[x];
        ll[0] = m;
        for (y = 0; y < 4; y++) ll[y + 1] = l[y];
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) {
                if (x > y)
                    p[y][x] = (tt[x - y - 1] + 2 * tt[x - y] + tt[x - y + 1]
                               + 2) >> 2;
                else if (x < y)
                    p[y][x] = (ll[y - x - 1] + 2 * ll[y - x] + ll[y - x + 1]
                               + 2) >> 2;
                else p[y][x] = (t[0] + 2 * m + l[0] + 2) >> 2;
            }
        break;
    }
    case 5: {
        int32_t tt[9], ll[5];
        tt[0] = m;
        for (x = 0; x < 8; x++) tt[x + 1] = t[x];
        ll[0] = m;
        for (y = 0; y < 4; y++) ll[y + 1] = l[y];
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) {
                int z = 2 * x - y;
                int k = x - (y >> 1);
                if (z >= 0 && (z & 1) == 0)
                    p[y][x] = (tt[k] + tt[k + 1] + 1) >> 1;
                else if (z >= 0)
                    p[y][x] = (tt[k - 1] + 2 * tt[k] + tt[k + 1] + 2) >> 2;
                else if (z == -1)
                    p[y][x] = (l[0] + 2 * m + t[0] + 2) >> 2;
                else
                    p[y][x] = (ll[y] + 2 * ll[y - 1] + ll[y - 2] + 2) >> 2;
            }
        break;
    }
    case 6: {
        int32_t tt[9], ll[5];
        tt[0] = m;
        for (x = 0; x < 8; x++) tt[x + 1] = t[x];
        ll[0] = m;
        for (y = 0; y < 4; y++) ll[y + 1] = l[y];
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) {
                int z = 2 * y - x;
                int k = y - (x >> 1);
                if (z >= 0 && (z & 1) == 0)
                    p[y][x] = (ll[k] + ll[k + 1] + 1) >> 1;
                else if (z >= 0)
                    p[y][x] = (ll[k - 1] + 2 * ll[k] + ll[k + 1] + 2) >> 2;
                else if (z == -1)
                    p[y][x] = (t[0] + 2 * m + l[0] + 2) >> 2;
                else
                    p[y][x] = (tt[x] + 2 * tt[x - 1] + tt[x - 2] + 2) >> 2;
            }
        break;
    }
    case 7:
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) {
                int k = x + (y >> 1);
                p[y][x] = (y & 1)
                    ? (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
                    : (t[k] + t[k + 1] + 1) >> 1;
            }
        break;
    case 8:
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) {
                int z = x + 2 * y;
                int k = y + (x >> 1);
                if (z > 5) p[y][x] = l[3];
                else if (z == 5) p[y][x] = (l[2] + 3 * l[3] + 2) >> 2;
                else if ((z & 1) == 0) p[y][x] = (l[k] + l[k + 1] + 1) >> 1;
                else p[y][x] = (l[k] + 2 * l[k + 1] + l[k + 2] + 2) >> 2;
            }
        break;
    default:
        for (y = 0; y < 4; y++)
            for (x = 0; x < 4; x++) p[y][x] = 128;
    }
}

static void predict_i8(int mode, const int32_t *t_in, const int32_t *l_in,
                       int32_t m_in, int at, int al, int ac,
                       int32_t p[8][8]) {
    int32_t t[16], l[8], ft[16], fl[8];
    int32_t m = m_in, fm = m_in;
    int x, y;
    for (x = 0; x < 16; x++) t[x] = t_in[x];
    for (y = 0; y < 8; y++) l[y] = l_in[y];
    /* reference filtering (spec 8.3.2.2.1) */
    if (at) {
        ft[0] = ac ? (m + 2 * t[0] + t[1] + 2) >> 2
                   : (3 * t[0] + t[1] + 2) >> 2;
        for (x = 1; x < 15; x++)
            ft[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2;
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2;
    }
    if (ac) {
        if (at && al) fm = (t[0] + 2 * m + l[0] + 2) >> 2;
        else if (at) fm = (3 * m + t[0] + 2) >> 2;
        else if (al) fm = (3 * m + l[0] + 2) >> 2;
        else fm = m;
    }
    if (al) {
        fl[0] = ac ? (m + 2 * l[0] + l[1] + 2) >> 2
                   : (3 * l[0] + l[1] + 2) >> 2;
        for (y = 1; y < 7; y++)
            fl[y] = (l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2;
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2;
    }
    if (at) for (x = 0; x < 16; x++) t[x] = ft[x];
    if (al) for (y = 0; y < 8; y++) l[y] = fl[y];
    m = ac ? fm : m;

    switch (mode) {
    case 0:
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) p[y][x] = t[x];
        break;
    case 1:
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) p[y][x] = l[y];
        break;
    case 2: {
        int32_t s = 0, v;
        if (at) for (x = 0; x < 8; x++) s += t[x];
        if (al) for (y = 0; y < 8; y++) s += l[y];
        if (at && al) v = (s + 8) >> 4;
        else if (at || al) v = (s + 4) >> 3;
        else v = 128;
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) p[y][x] = v;
        break;
    }
    case 3:
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++)
                p[y][x] = (x == 7 && y == 7)
                    ? (t[14] + 3 * t[15] + 2) >> 2
                    : (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2;
        break;
    case 4: {
        int32_t tt[17], ll[9];
        tt[0] = m;
        for (x = 0; x < 16; x++) tt[x + 1] = t[x];
        ll[0] = m;
        for (y = 0; y < 8; y++) ll[y + 1] = l[y];
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) {
                if (x > y)
                    p[y][x] = (tt[x - y - 1] + 2 * tt[x - y] + tt[x - y + 1]
                               + 2) >> 2;
                else if (x < y)
                    p[y][x] = (ll[y - x - 1] + 2 * ll[y - x] + ll[y - x + 1]
                               + 2) >> 2;
                else p[y][x] = (t[0] + 2 * m + l[0] + 2) >> 2;
            }
        break;
    }
    case 5: {
        int32_t tt[17], ll[9];
        tt[0] = m;
        for (x = 0; x < 16; x++) tt[x + 1] = t[x];
        ll[0] = m;
        for (y = 0; y < 8; y++) ll[y + 1] = l[y];
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) {
                int z = 2 * x - y;
                int k = x - (y >> 1);
                if (z >= 0 && (z & 1) == 0)
                    p[y][x] = (tt[k] + tt[k + 1] + 1) >> 1;
                else if (z >= 0)
                    p[y][x] = (tt[k - 1] + 2 * tt[k] + tt[k + 1] + 2) >> 2;
                else if (z == -1)
                    p[y][x] = (l[0] + 2 * m + t[0] + 2) >> 2;
                else
                    p[y][x] = (ll[y - 2 * x] + 2 * ll[y - 2 * x - 1]
                               + ll[y - 2 * x - 2] + 2) >> 2;
            }
        break;
    }
    case 6: {
        int32_t tt[17], ll[9];
        tt[0] = m;
        for (x = 0; x < 16; x++) tt[x + 1] = t[x];
        ll[0] = m;
        for (y = 0; y < 8; y++) ll[y + 1] = l[y];
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) {
                int z = 2 * y - x;
                int k = y - (x >> 1);
                if (z >= 0 && (z & 1) == 0)
                    p[y][x] = (ll[k] + ll[k + 1] + 1) >> 1;
                else if (z >= 0)
                    p[y][x] = (ll[k - 1] + 2 * ll[k] + ll[k + 1] + 2) >> 2;
                else if (z == -1)
                    p[y][x] = (t[0] + 2 * m + l[0] + 2) >> 2;
                else
                    p[y][x] = (tt[x - 2 * y] + 2 * tt[x - 2 * y - 1]
                               + tt[x - 2 * y - 2] + 2) >> 2;
            }
        break;
    }
    case 7:
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) {
                int k = x + (y >> 1);
                p[y][x] = (y & 1)
                    ? (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
                    : (t[k] + t[k + 1] + 1) >> 1;
            }
        break;
    case 8:
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) {
                int z = x + 2 * y;
                int k = y + (x >> 1);
                if (z > 13) p[y][x] = l[7];
                else if (z == 13) p[y][x] = (l[6] + 3 * l[7] + 2) >> 2;
                else if ((z & 1) == 0) p[y][x] = (l[k] + l[k + 1] + 1) >> 1;
                else p[y][x] = (l[k] + 2 * l[k + 1] + l[k + 2] + 2) >> 2;
            }
        break;
    default:
        for (y = 0; y < 8; y++)
            for (x = 0; x < 8; x++) p[y][x] = 128;
    }
}

static inline uint8_t clip255(int32_t v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

typedef struct {
    uint8_t *Y, *U, *V;
    int w, h, cw, ch;       /* luma and chroma plane dims */
    int mb_w, mb_h, n;
    int crows;              /* chroma 4x4-block rows per MB (2 or 4) */
    const int8_t *mb_class;
    const uint8_t *t8;
    const int8_t *i4_modes;
    const int8_t *i16_mode;
    const int8_t *chroma_mode;
    const int32_t *slice_id;
    const int32_t *res_l;   /* (n,16,4,4) */
    const int32_t *res_c;   /* (n,2,2*crows,4,4) */
} IR;

static inline int ir_mb_avail(const IR *q, int naddr, int addr) {
    if (naddr < 0 || naddr >= q->n) return 0;
    return q->slice_id[naddr] == q->slice_id[addr];
}

static int ir_block_avail(const IR *q, int addr, int gbx, int gby,
                          int cur_code) {
    if (gbx < 0 || gby < 0 || gbx >= q->mb_w * 4) return 0;
    int naddr = (gby >> 2) * q->mb_w + (gbx >> 2);
    if (naddr == addr) {
        int nblk = (gby & 3) * 4 + (gbx & 3);
        return RASTER2CODE[nblk] < cur_code;
    }
    if (naddr > addr) return 0;
    return ir_mb_avail(q, naddr, addr);
}

static void ir_chroma_intra(IR *q, int addr) {
    int mbx = addr % q->mb_w, mby = addr / q->mb_w;
    int mh = 4 * q->crows;                   /* 8 or 16 */
    int cx = mbx * 8, cy = mby * mh;
    int al = (mbx > 0) ? ir_mb_avail(q, addr - 1, addr) : 0;
    int at = ir_mb_avail(q, addr - q->mb_w, addr);
    int atl = (mbx > 0) ? ir_mb_avail(q, addr - q->mb_w - 1, addr) : 0;
    int mode = q->chroma_mode[addr];
    for (int comp = 0; comp < 2; comp++) {
        uint8_t *pl = comp ? q->V : q->U;
        int stride = q->cw;
        int32_t t[8] = {0}, l[16] = {0}, m = 0;
        if (at) for (int x = 0; x < 8; x++)
            t[x] = pl[(cy - 1) * stride + cx + x];
        if (al) for (int y = 0; y < mh; y++)
            l[y] = pl[(cy + y) * stride + cx - 1];
        if (atl) m = pl[(cy - 1) * stride + cx - 1];

        int32_t p[16][8];
        if (mode == 0) {                       /* DC, per 4x4 block */
            for (int by = 0; by < mh / 4; by++)
                for (int xo = 0; xo <= 4; xo += 4) {
                    int yo = by * 4;
                    int32_t ts = t[xo] + t[xo + 1] + t[xo + 2] + t[xo + 3];
                    int32_t ls = l[yo] + l[yo + 1] + l[yo + 2] + l[yo + 3];
                    int pos = (by == 0) ? (xo ? 1 : 0) : (xo ? 3 : 2);
                    int32_t v;
                    if (pos == 0 || pos == 3) {
                        if (at && al) v = (ts + ls + 4) >> 3;
                        else if (at) v = (ts + 2) >> 2;
                        else if (al) v = (ls + 2) >> 2;
                        else v = 128;
                    } else if (pos == 1) {
                        if (at) v = (ts + 2) >> 2;
                        else if (al) v = (ls + 2) >> 2;
                        else v = 128;
                    } else {
                        if (al) v = (ls + 2) >> 2;
                        else if (at) v = (ts + 2) >> 2;
                        else v = 128;
                    }
                    for (int yy = yo; yy < yo + 4; yy++)
                        for (int xx = xo; xx < xo + 4; xx++)
                            p[yy][xx] = v;
                }
        } else if (mode == 1) {
            for (int yy = 0; yy < mh; yy++)
                for (int xx = 0; xx < 8; xx++) p[yy][xx] = l[yy];
        } else if (mode == 2) {
            for (int yy = 0; yy < mh; yy++)
                for (int xx = 0; xx < 8; xx++) p[yy][xx] = t[xx];
        } else {                               /* plane */
            int h2 = mh / 2;
            int32_t tt[9], ll[17];
            tt[0] = m;
            for (int x = 0; x < 8; x++) tt[x + 1] = t[x];
            ll[0] = m;
            for (int y = 0; y < mh; y++) ll[y + 1] = l[y];
            int64_t hh = 0, vv = 0;
            for (int x = 0; x < 4; x++)
                hh += (int64_t)(x + 1) * (tt[5 + x] - tt[3 - x]);
            for (int y = 0; y < h2; y++)
                vv += (int64_t)(y + 1) * (ll[h2 + 1 + y] - ll[h2 - 1 - y]);
            int32_t a = 16 * (l[mh - 1] + t[7]);
            int32_t b = (int32_t)((34 * hh + 32) >> 6);
            int32_t c = (mh == 8)
                ? (int32_t)((17 * vv + 16) >> 5)
                : (int32_t)((5 * vv + 32) >> 6);
            for (int yy = 0; yy < mh; yy++)
                for (int xx = 0; xx < 8; xx++) {
                    int32_t v = (a + b * (xx - 3) + c * (yy - h2 + 1)
                                 + 16) >> 5;
                    p[yy][xx] = v < 0 ? 0 : (v > 255 ? 255 : v);
                }
        }
        const int32_t *rc = q->res_c
            + ((size_t)addr * 2 + comp) * (2 * q->crows) * 16;
        for (int yy = 0; yy < mh; yy++)
            for (int xx = 0; xx < 8; xx++) {
                int blk = (yy / 4) * 2 + (xx / 4);
                int32_t r = rc[blk * 16 + (yy & 3) * 4 + (xx & 3)];
                pl[(cy + yy) * stride + cx + xx] = clip255(p[yy][xx] + r);
            }
    }
}

static void ir_recon_i4(IR *q, int addr) {
    int mbx = addr % q->mb_w, mby = addr / q->mb_w;
    uint8_t *Y = q->Y;
    int stride = q->w;
    for (int code = 0; code < 16; code++) {
        int blk = CODE2RASTER[code];
        int by = blk >> 2, bx = blk & 3;
        int gx = mbx * 4 + bx, gy = mby * 4 + by;
        int x = gx * 4, y = gy * 4;
        int al = ir_block_avail(q, addr, gx - 1, gy, code);
        int at = ir_block_avail(q, addr, gx, gy - 1, code);
        int atl = ir_block_avail(q, addr, gx - 1, gy - 1, code);
        int atr = ir_block_avail(q, addr, gx + 1, gy - 1, code);
        int32_t t[8] = {0}, l[4] = {0}, m = 0;
        if (at) {
            for (int i = 0; i < 4; i++) t[i] = Y[(y - 1) * stride + x + i];
            if (atr)
                for (int i = 0; i < 4; i++)
                    t[4 + i] = Y[(y - 1) * stride + x + 4 + i];
            else
                for (int i = 0; i < 4; i++) t[4 + i] = t[3];
        }
        if (al) for (int i = 0; i < 4; i++) l[i] = Y[(y + i) * stride + x - 1];
        if (atl) m = Y[(y - 1) * stride + x - 1];
        int32_t p[4][4];
        predict_i4(q->i4_modes[addr * 16 + blk], t, l, m, at, al, p);
        const int32_t *rl = q->res_l + ((size_t)addr * 16 + blk) * 16;
        for (int yy = 0; yy < 4; yy++)
            for (int xx = 0; xx < 4; xx++)
                Y[(y + yy) * stride + x + xx] =
                    clip255(p[yy][xx] + rl[yy * 4 + xx]);
    }
    ir_chroma_intra(q, addr);
}

static void ir_recon_i8(IR *q, int addr) {
    int mbx = addr % q->mb_w, mby = addr / q->mb_w;
    uint8_t *Y = q->Y;
    int stride = q->w;
    for (int quad = 0; quad < 4; quad++) {
        int qy = quad >> 1, qx = quad & 1;
        int bx = qx * 2, by = qy * 2;
        int gx = mbx * 4 + bx, gy = mby * 4 + by;
        int x = gx * 4, y = gy * 4;
        int code = RASTER2CODE[by * 4 + bx];
        int al = ir_block_avail(q, addr, gx - 1, gy, code);
        int at = ir_block_avail(q, addr, gx, gy - 1, code);
        int atl = ir_block_avail(q, addr, gx - 1, gy - 1, code);
        int atr = ir_block_avail(q, addr, gx + 2, gy - 1, code);
        int32_t t[16] = {0}, l[8] = {0}, m = 0;
        if (at) {
            for (int i = 0; i < 8; i++) t[i] = Y[(y - 1) * stride + x + i];
            if (atr)
                for (int i = 0; i < 8; i++)
                    t[8 + i] = Y[(y - 1) * stride + x + 8 + i];
            else
                for (int i = 0; i < 8; i++) t[8 + i] = t[7];
        }
        if (al) for (int i = 0; i < 8; i++) l[i] = Y[(y + i) * stride + x - 1];
        if (atl) m = Y[(y - 1) * stride + x - 1];
        int32_t p[8][8];
        predict_i8(q->i4_modes[addr * 16 + by * 4 + bx], t, l, m, at, al,
                   atl, p);
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++) {
                int blk = (by + dy) * 4 + bx + dx;
                const int32_t *rl = q->res_l + ((size_t)addr * 16 + blk) * 16;
                for (int yy = 0; yy < 4; yy++)
                    for (int xx = 0; xx < 4; xx++)
                        Y[(y + dy * 4 + yy) * stride + x + dx * 4 + xx] =
                            clip255(p[dy * 4 + yy][dx * 4 + xx]
                                    + rl[yy * 4 + xx]);
            }
    }
    ir_chroma_intra(q, addr);
}

static void ir_recon_i16(IR *q, int addr) {
    int mbx = addr % q->mb_w, mby = addr / q->mb_w;
    int px = mbx * 16, py = mby * 16;
    uint8_t *Y = q->Y;
    int stride = q->w;
    int al = (mbx > 0) ? ir_mb_avail(q, addr - 1, addr) : 0;
    int at = ir_mb_avail(q, addr - q->mb_w, addr);
    int atl = (mbx > 0) ? ir_mb_avail(q, addr - q->mb_w - 1, addr) : 0;
    int32_t t[16] = {0}, l[16] = {0}, m = 0;
    if (at) for (int i = 0; i < 16; i++) t[i] = Y[(py - 1) * stride + px + i];
    if (al) for (int i = 0; i < 16; i++) l[i] = Y[(py + i) * stride + px - 1];
    if (atl) m = Y[(py - 1) * stride + px - 1];
    int mode = q->i16_mode[addr];
    int32_t p[16][16];
    if (mode == 0) {
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) p[y][x] = t[x];
    } else if (mode == 1) {
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) p[y][x] = l[y];
    } else if (mode == 2) {
        int32_t s = 0, v;
        if (at) for (int x = 0; x < 16; x++) s += t[x];
        if (al) for (int y = 0; y < 16; y++) s += l[y];
        if (at && al) v = (s + 16) >> 5;
        else if (at || al) v = (s + 8) >> 4;
        else v = 128;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) p[y][x] = v;
    } else {
        int32_t tt[17], ll[17];
        tt[0] = m;
        for (int x = 0; x < 16; x++) tt[x + 1] = t[x];
        ll[0] = m;
        for (int y = 0; y < 16; y++) ll[y + 1] = l[y];
        int64_t hh = 0, vv = 0;
        for (int x = 0; x < 8; x++)
            hh += (int64_t)(x + 1) * (tt[9 + x] - tt[7 - x]);
        for (int y = 0; y < 8; y++)
            vv += (int64_t)(y + 1) * (ll[9 + y] - ll[7 - y]);
        int32_t a = 16 * (l[15] + t[15]);
        int32_t b = (int32_t)((5 * hh + 32) >> 6);
        int32_t c = (int32_t)((5 * vv + 32) >> 6);
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) {
                int32_t v = (a + b * (x - 7) + c * (y - 7) + 16) >> 5;
                p[y][x] = v < 0 ? 0 : (v > 255 ? 255 : v);
            }
    }
    const int32_t *rl = q->res_l + (size_t)addr * 16 * 16;
    for (int y = 0; y < 16; y++)
        for (int x = 0; x < 16; x++) {
            int blk = (y / 4) * 4 + (x / 4);
            Y[(py + y) * stride + px + x] =
                clip255(p[y][x] + rl[blk * 16 + (y & 3) * 4 + (x & 3)]);
        }
    ir_chroma_intra(q, addr);
}

/* intra_recon(params, arrays): reconstruct all I4/I8/I16 MBs in place.
 * Caller guarantees inter MBs' pixels are already in the planes (device
 * seed) or absent (pure-intra picture), and that no IPCM MB exists. */
static PyObject *m_intra_recon(PyObject *mod, PyObject *args) {
    PyObject *params, *arrays;
    if (!PyArg_ParseTuple(args, "OO", &params, &arrays)) return NULL;

#define GETI(name) \
    PyObject *o_##name = PyDict_GetItemString(params, #name); \
    long long name = o_##name ? PyLong_AsLongLong(o_##name) : -1; \
    if ((name == -1 && PyErr_Occurred()) || !o_##name) { \
        if (!PyErr_Occurred()) \
            PyErr_Format(PyExc_KeyError, "missing param '%s'", #name); \
        return NULL; \
    }
    GETI(mb_w)
    GETI(mb_h)
    GETI(crows)
#undef GETI

    Held held[12];
    int nheld = 0;
    IR q;
    memset(&q, 0, sizeof(q));
    q.mb_w = (int)mb_w;
    q.mb_h = (int)mb_h;
    q.n = (int)(mb_w * mb_h);
    q.crows = (int)crows;
    q.w = q.mb_w * 16;
    q.h = q.mb_h * 16;
    q.cw = q.mb_w * 8;
    q.ch = q.mb_h * 4 * q.crows;
    long long n = q.n;
    int ok = 1;
#define ARR(field, key, want) \
    if (ok && !(q.field = (decltype(q.field))want_arr( \
            arrays, key, held, &nheld, want))) ok = 0;
    ARR(Y, "Y", (long long)q.w * q.h)
    ARR(U, "U", (long long)q.cw * q.ch)
    ARR(V, "V", (long long)q.cw * q.ch)
    ARR(mb_class, "mb_class", n)
    ARR(t8, "transform8x8", n)
    ARR(i4_modes, "i4_modes", n * 16)
    ARR(i16_mode, "i16_mode", n)
    ARR(chroma_mode, "chroma_mode", n)
    ARR(slice_id, "slice_id", n * 4)
    ARR(res_l, "res_l", n * 16 * 16 * 4)
    ARR(res_c, "res_c", n * 2 * (2 * crows) * 16 * 4)
#undef ARR
    if (ok) {
        for (int addr = 0; addr < q.n; addr++) {
            int cls = q.mb_class[addr];
            if (cls == 2) ir_recon_i16(&q, addr);
            else if (cls == 1) {
                if (q.t8[addr]) ir_recon_i8(&q, addr);
                else ir_recon_i4(&q, addr);
            }
        }
    }
    for (int i = 0; i < nheld; i++) PyBuffer_Release(&held[i].view);
    if (!ok) return NULL;
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* the encoder's Intra4x4 MB (encoder/p_intra.py IntraMBCoder            */
/* _encode_i4_mb without an RD tier, trellis or custom quant)            */
/* ------------------------------------------------------------------ */

/* forward core transform of a raster 4x4 (encoder/residual_np.py
 * np_forward4x4): the columns, then the rows */
static void fwd4x4(const int64_t d[16], int64_t out[16]) {
    int64_t t[16];
    for (int c = 0; c < 4; c++) {
        int64_t p0 = d[c] + d[12 + c], p1 = d[4 + c] + d[8 + c];
        int64_t m0 = d[c] - d[12 + c], m1 = d[4 + c] - d[8 + c];
        t[c] = p0 + p1;
        t[4 + c] = 2 * m0 + m1;
        t[8 + c] = p0 - p1;
        t[12 + c] = m0 - 2 * m1;
    }
    for (int r = 0; r < 4; r++) {
        const int64_t *a = t + 4 * r;
        int64_t p0 = a[0] + a[3], p1 = a[1] + a[2];
        int64_t m0 = a[0] - a[3], m1 = a[1] - a[2];
        out[4 * r] = p0 + p1;
        out[4 * r + 1] = 2 * m0 + m1;
        out[4 * r + 2] = p0 - p1;
        out[4 * r + 3] = m0 - 2 * m1;
    }
}

/* inverse core transform, unrounded (decoder/recon.py _np_inv4): the
 * rows, then the columns */
static void inv4x4(const int64_t d[16], int64_t out[16]) {
    int64_t f[16];
    for (int r = 0; r < 4; r++) {
        const int64_t *a = d + 4 * r;
        int64_t e0 = a[0] + a[2], e1 = a[0] - a[2];
        int64_t e2 = (a[1] >> 1) - a[3], e3 = a[1] + (a[3] >> 1);
        f[4 * r] = e0 + e3;
        f[4 * r + 1] = e1 + e2;
        f[4 * r + 2] = e1 - e2;
        f[4 * r + 3] = e0 - e3;
    }
    for (int c = 0; c < 4; c++) {
        int64_t g0 = f[c] + f[8 + c], g1 = f[c] - f[8 + c];
        int64_t g2 = (f[4 + c] >> 1) - f[12 + c];
        int64_t g3 = f[4 + c] + (f[12 + c] >> 1);
        out[c] = g0 + g3;
        out[4 + c] = g1 + g2;
        out[8 + c] = g1 - g2;
        out[12 + c] = g0 - g3;
    }
}

/* encode_i4_mb(params, arrays) -> (cost, cbp_luma): MB addr coded as
 * Intra4x4, block after block in coding order, each block's mode the
 * first candidate of least SAD + lam4 (mode != most probable), its
 * residual transformed, quantized (intra rounding, the flat MF table of
 * qp, "mf"), written in the order of "scan" (the 16 raster positions of
 * the zig-zag, or of the field scan in a field picture) with its nnz,
 * and reconstructed into Y with the flat inverse scale of qp ("vs")
 * before the next block. params: mb_w, mb_h, addr, qp, lam4; arrays: Y
 * (the recon plane), orig (the MB's 16x16 source), mb_class, i4_modes,
 * slice_id, luma_coef, luma_nnz (the PictureData's), mf, vs ((4, 4)
 * int32), scan ((16,) int32). */
static PyObject *m_encode_i4_mb(PyObject *mod, PyObject *args) {
    PyObject *params, *arrays;
    if (!PyArg_ParseTuple(args, "OO", &params, &arrays)) return NULL;
    long long v[5];
    const char *names[5] = {"mb_w", "mb_h", "addr", "qp", "lam4"};
    for (int i = 0; i < 5; i++) {
        PyObject *o = PyDict_GetItemString(params, names[i]);
        if (!o) {
            PyErr_Format(PyExc_KeyError, "missing param '%s'", names[i]);
            return NULL;
        }
        v[i] = PyLong_AsLongLong(o);
        if (v[i] == -1 && PyErr_Occurred()) return NULL;
    }
    int mb_w = (int)v[0], mb_h = (int)v[1], addr = (int)v[2];
    int qp = (int)v[3];
    int64_t lam4 = v[4];
    long long n = (long long)mb_w * mb_h;
    if (mb_w <= 0 || mb_h <= 0 || addr < 0 || addr >= n || qp < 0
            || qp > 51) {
        PyErr_SetString(PyExc_ValueError, "encode_i4_mb: bad params");
        return NULL;
    }
    Held held[11];
    int nheld = 0, ok = 1;
    IR q;
    Pic p;
    memset(&q, 0, sizeof(q));
    memset(&p, 0, sizeof(p));
    q.mb_w = p.mb_w = mb_w;
    q.n = p.n = (int)n;
    int stride = 16 * mb_w;
    uint8_t *Y = NULL;
    const uint8_t *orig = NULL;
    int32_t *coef = NULL, *nnz = NULL, *mf = NULL, *vs = NULL;
    const int32_t *zz = NULL;
#define ARR(dst, key, want) \
    if (ok && !(dst = (decltype(dst))want_arr(arrays, key, held, &nheld, \
                                                want))) ok = 0;
    ARR(Y, "Y", (long long)stride * 16 * mb_h)
    ARR(orig, "orig", 256)
    ARR(p.mb_class, "mb_class", n)
    ARR(p.i4_modes, "i4_modes", n * 16)
    ARR(p.slice_id, "slice_id", n * 4)
    ARR(coef, "luma_coef", n * 16 * 16 * 4)
    ARR(nnz, "luma_nnz", n * 16 * 4)
    ARR(mf, "mf", 16 * 4)
    ARR(vs, "vs", 16 * 4)
    ARR(zz, "scan", 16 * 4)
#undef ARR
    for (int k = 0; ok && k < 16; k++)
        if (zz[k] < 0 || zz[k] > 15) {
            PyErr_SetString(PyExc_ValueError, "encode_i4_mb: bad scan");
            ok = 0;
        }
    int64_t total = 0;
    int cbp = 0;
    if (ok) {
        q.slice_id = p.slice_id;
        int mbx = addr % mb_w, mby = addr / mb_w;
        int qbits = 15 + qp / 6, per = qp / 6;
        int64_t f = ((int64_t)1 << qbits) / 3;
        p.mb_class[addr] = 1;
        for (int code = 0; code < 16; code++) {
            int blk = CODE2RASTER[code];
            int by = blk >> 2, bx = blk & 3;
            int gx = mbx * 4 + bx, gy = mby * 4 + by;
            int x = gx * 4, y = gy * 4;
            int al = ir_block_avail(&q, addr, gx - 1, gy, code);
            int at = ir_block_avail(&q, addr, gx, gy - 1, code);
            int atl = ir_block_avail(&q, addr, gx - 1, gy - 1, code);
            int atr = ir_block_avail(&q, addr, gx + 1, gy - 1, code);
            int32_t t[8] = {0}, l[4] = {0}, m = 0;
            if (at) {
                for (int i = 0; i < 4; i++) t[i] = Y[(y - 1) * stride + x + i];
                for (int i = 0; i < 4; i++)
                    t[4 + i] = atr ? Y[(y - 1) * stride + x + 4 + i] : t[3];
            }
            if (al)
                for (int i = 0; i < 4; i++) l[i] = Y[(y + i) * stride + x - 1];
            if (atl) m = Y[(y - 1) * stride + x - 1];
            int mpm = pred_intra4_mode(&p, addr, blk);
            int cand[9], nc = 0;
            cand[nc++] = 2;                                   /* DC */
            if (at) { cand[nc++] = 0; cand[nc++] = 7; cand[nc++] = 3; }
            if (al) { cand[nc++] = 1; cand[nc++] = 8; }
            if (at && al && atl) {
                cand[nc++] = 4; cand[nc++] = 5; cand[nc++] = 6;
            }
            int32_t o[16];
            for (int yy = 0; yy < 4; yy++)
                for (int xx = 0; xx < 4; xx++)
                    o[yy * 4 + xx] = orig[(by * 4 + yy) * 16 + bx * 4 + xx];
            int64_t best = 0;
            int best_m = -1;
            int32_t best_p[4][4], pr[4][4];
            for (int i = 0; i < nc; i++) {
                predict_i4(cand[i], t, l, m, at, al, pr);
                int64_t c = cand[i] != mpm ? lam4 : 0;
                for (int k = 0; k < 16; k++) {
                    int32_t dlt = o[k] - pr[k >> 2][k & 3];
                    c += dlt < 0 ? -dlt : dlt;
                }
                if (best_m < 0 || c < best) {
                    best = c;
                    best_m = cand[i];
                    memcpy(best_p, pr, sizeof(pr));
                }
            }
            total += best;
            p.i4_modes[addr * 16 + blk] = (int8_t)best_m;
            int64_t d[16], w[16], r[16];
            for (int k = 0; k < 16; k++) d[k] = o[k] - best_p[k >> 2][k & 3];
            fwd4x4(d, w);
            int32_t *sc = coef + ((size_t)addr * 16 + blk) * 16;
            int tc = 0;
            for (int k = 0; k < 16; k++) {
                int pos = zz[k];
                int64_t a = w[pos] < 0 ? -w[pos] : w[pos];
                int64_t lev = (a * mf[pos] + f) >> qbits;
                sc[k] = (int32_t)(w[pos] < 0 ? -lev : lev);
                tc += sc[k] != 0;
                /* dequant (flat: ((c vs) << per + 8) >> 4, kept int32) */
                d[pos] = (int32_t)((((int64_t)sc[k] * vs[pos]) << per) + 8
                                   >> 4);
            }
            nnz[addr * 16 + blk] = tc;
            if (tc) cbp |= 1 << ((by >> 1) * 2 + (bx >> 1));
            inv4x4(d, r);
            for (int k = 0; k < 16; k++)
                Y[(y + (k >> 2)) * stride + x + (k & 3)] = clip255(
                    best_p[k >> 2][k & 3] + (int32_t)((r[k] + 32) >> 6));
        }
    }
    for (int i = 0; i < nheld; i++) PyBuffer_Release(&held[i].view);
    if (!ok) return NULL;
    return Py_BuildValue("(Li)", (long long)total, cbp);
}

static PyMethodDef dec_methods[] = {
    {"intra_recon", m_intra_recon, METH_VARARGS,
     "reconstruct all intra MBs of a picture in place"},
    {"encode_i4_mb", m_encode_i4_mb, METH_VARARGS,
     "code one MB as Intra4x4 (flat quant, SAD mode decision)"},
    {"set_cavlc_dec_tables", m_set_cavlc_dec_tables, METH_VARARGS,
     "install CAVLC decode peek-LUTs (ct, ct_dc, tz, tz_dc420, run)"},
    {"parse_slice_cavlc", m_parse_slice_cavlc, METH_VARARGS,
     "parse one I/P CAVLC slice into PictureData SoA arrays"},
    {NULL}
};

extern "C" int register_jm_torch_dec(PyObject *module) {
    for (PyMethodDef *def = dec_methods; def->ml_name; def++) {
        PyObject *fn = PyCFunction_New(def, NULL);
        if (!fn) return -1;
        if (PyModule_AddObject(module, def->ml_name, fn) < 0) {
            Py_DECREF(fn);
            return -1;
        }
    }
    return 0;
}
