/* jm_torch_native, encoder part: the CAVLC slice serializer, the host
 * motion search's integer arg-min and fractional refinement, and the host
 * coders' block motion compensation.
 *
 * The port's copy of jm_tpu's native/jm_enc.cpp without its
 * deblock_frame: the port deblocks every picture on the card (kernels/
 * deblock.cu K1/K2).
 *
 *   - cavlc_slice_data: serializes one slice's decided macroblocks from
 *     the SoA PictureData arrays (parity: lencod/src/macroblock.c
 *     write_macroblock:2810 + vlc.c writers; twin of the Python MBWriter
 *     of jm_tpu_torch/encoder/syntax.py, byte-identical output). The
 *     caller hands over the bits written so far (the slice header) and
 *     gets the whole RBSP back.
 *   - subpel_refine: the half- then quarter-pel refinement of one
 *     block's MV by SATD or SAD plus the mvd rate (twin of
 *     jm_tpu_torch/encoder/me.py subpel_refine, the same MV and cost);
 *     the host P and B coders call it for every partition;
 *   - int_search: the integer full search's arg-min over one MB's SAD
 *     table made on the card (twin of encoder/me.py int_rate_tab +
 *     spiral_rank_tab + best_int_mv_tiebreak, the same MV);
 *   - mc_blk: one block's quarter-pel luma and eighth-pel chroma
 *     predictions (twin of me.mc_luma_block and me.mc_chroma_block), the
 *     host coders' motion compensation of each 4x4 block;
 *   - quad_sad: an MB's four 8x8 quadrant SADs at one integer
 *     displacement (twin of the EPZS / UMHex searchers' _qsad in
 *     encoder/me_epzs.py);
 *   - sp_levels: the SP pictures' level decision over rows of transform
 *     coefficients (twin of encoder/residual_np.py sp_quant_coeffs).
 *
 * Normative VLC tables are installed from Python (set_cavlc_tables, from
 * common/cavlc_tables.py) so the port's tables remain the single source
 * of truth. Plain CPython C API + buffer protocol (no numpy C API); every
 * array's byte size is checked against the picture's MB count.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

/* ------------------------------------------------------------------ */
/* small helpers                                                       */
/* ------------------------------------------------------------------ */

typedef struct {
    Py_buffer view;
    int ok;
} Buf;

static int get_arr(PyObject *dict, const char *key, Buf *b, int writable) {
    PyObject *o = PyDict_GetItemString(dict, key);
    if (!o) {
        PyErr_Format(PyExc_KeyError, "missing array '%s'", key);
        return -1;
    }
    int flags = writable ? (PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE)
                         : PyBUF_C_CONTIGUOUS;
    if (PyObject_GetBuffer(o, &b->view, flags) < 0) return -1;
    b->ok = 1;
    return 0;
}

static void rel(Buf *b) {
    if (b->ok) { PyBuffer_Release(&b->view); b->ok = 0; }
}

static int check_len(const Buf *b, const char *key, Py_ssize_t want) {
    if (b->view.len != want) {
        PyErr_Format(PyExc_ValueError, "array '%s': expected %zd bytes, "
                     "got %zd", key, want, b->view.len);
        return -1;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* BitWriter                                                           */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *buf;
    size_t len, cap;
    uint64_t acc;
    int nacc;
    int err;
} BW;

static void bw_init(BW *w, const uint8_t *head, size_t headlen,
                    uint64_t acc, int nacc) {
    w->cap = headlen + 4096;
    w->buf = (uint8_t *)malloc(w->cap);
    memcpy(w->buf, head, headlen);
    w->len = headlen;
    w->acc = acc;
    w->nacc = nacc;
    w->err = 0;
}

static inline void bw_byte(BW *w, uint8_t v) {
    if (w->len == w->cap) {
        w->cap *= 2;
        w->buf = (uint8_t *)realloc(w->buf, w->cap);
    }
    w->buf[w->len++] = v;
}

static inline void bw_u(BW *w, uint32_t value, int n) {
    if (n == 0) return;
    if (n > 32 || (n < 32 && (value >> n))) { w->err = 1; return; }
    w->acc = (w->acc << n) | value;
    w->nacc += n;
    while (w->nacc >= 8) {
        w->nacc -= 8;
        bw_byte(w, (uint8_t)((w->acc >> w->nacc) & 0xFF));
    }
    w->acc &= (1ULL << w->nacc) - 1;
}

static inline void bw_ue(BW *w, uint32_t v) {
    uint32_t code = v + 1;
    int n = 32 - __builtin_clz(code);
    bw_u(w, 0, n - 1);
    bw_u(w, code, n);
}

static inline void bw_se(BW *w, int32_t v) {
    uint32_t k = v > 0 ? (uint32_t)(2 * v - 1) : (uint32_t)(-2 * v);
    bw_ue(w, k);
}

static inline void bw_te(BW *w, int32_t v, int rng) {
    if (rng == 1) bw_u(w, (uint32_t)(1 - v), 1);
    else bw_ue(w, (uint32_t)v);
}

static inline void bw_trailing(BW *w) {
    bw_u(w, 1, 1);
    if (w->nacc) bw_u(w, 0, 8 - w->nacc);
}

/* ------------------------------------------------------------------ */
/* CAVLC tables (installed from Python)                                */
/* ------------------------------------------------------------------ */

static uint8_t g_ct_len[3][4][17];
static uint16_t g_ct_cod[3][4][17];
static uint8_t g_ctdc_len[2][4][9];
static uint16_t g_ctdc_cod[2][4][9];
static uint8_t g_tz_len[15][16];
static uint16_t g_tz_cod[15][16];
static uint8_t g_tzdc0_len[3][4];
static uint16_t g_tzdc0_cod[3][4];
static uint8_t g_tzdc1_len[7][8];
static uint16_t g_tzdc1_cod[7][8];
static uint8_t g_run_len[7][15];
static uint16_t g_run_cod[7][15];
static uint8_t g_cbp_inv_chroma[2][48];   /* [intra/inter][cbp] -> codeNum */
static int g_tables_set = 0;

static int copy_tab(PyObject *dict, const char *key, void *dst,
                    size_t bytes, int is16) {
    Buf b = {{0}, 0};
    if (get_arr(dict, key, &b, 0) < 0) return -1;
    if ((size_t)b.view.len != bytes * (is16 ? 2 : 1)) {
        PyErr_Format(PyExc_ValueError, "table '%s': wrong size", key);
        rel(&b);
        return -1;
    }
    memcpy(dst, b.view.buf, b.view.len);
    rel(&b);
    return 0;
}

static PyObject *py_set_cavlc_tables(PyObject *self, PyObject *arg) {
    if (!PyDict_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected dict of arrays");
        return NULL;
    }
    if (copy_tab(arg, "ct_len", g_ct_len, sizeof g_ct_len, 0) < 0 ||
        copy_tab(arg, "ct_cod", g_ct_cod, sizeof g_ct_cod / 2, 1) < 0 ||
        copy_tab(arg, "ctdc_len", g_ctdc_len, sizeof g_ctdc_len, 0) < 0 ||
        copy_tab(arg, "ctdc_cod", g_ctdc_cod, sizeof g_ctdc_cod / 2, 1) < 0 ||
        copy_tab(arg, "tz_len", g_tz_len, sizeof g_tz_len, 0) < 0 ||
        copy_tab(arg, "tz_cod", g_tz_cod, sizeof g_tz_cod / 2, 1) < 0 ||
        copy_tab(arg, "tzdc0_len", g_tzdc0_len, sizeof g_tzdc0_len, 0) < 0 ||
        copy_tab(arg, "tzdc0_cod", g_tzdc0_cod, sizeof g_tzdc0_cod / 2, 1) < 0 ||
        copy_tab(arg, "tzdc1_len", g_tzdc1_len, sizeof g_tzdc1_len, 0) < 0 ||
        copy_tab(arg, "tzdc1_cod", g_tzdc1_cod, sizeof g_tzdc1_cod / 2, 1) < 0 ||
        copy_tab(arg, "run_len", g_run_len, sizeof g_run_len, 0) < 0 ||
        copy_tab(arg, "run_cod", g_run_cod, sizeof g_run_cod / 2, 1) < 0 ||
        copy_tab(arg, "cbp_inv_chroma", g_cbp_inv_chroma,
                 sizeof g_cbp_inv_chroma, 0) < 0)
        return NULL;
    g_tables_set = 1;
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* residual block writer (cavlc_write.write_residual_block twin)       */
/* ------------------------------------------------------------------ */

static int write_residual(BW *w, const int32_t *c, int nc, int max_coeff) {
    int nzpos[64], nz = 0;
    for (int i = 0; i < max_coeff; i++)
        if (c[i]) nzpos[nz++] = i;
    int total = nz;

    int trailing = 0;
    for (int k = nz - 1; k >= 0; k--) {
        int32_t v = c[nzpos[k]];
        if ((v == 1 || v == -1) && trailing < 3) trailing++;
        else break;
    }

    /* coeff_token */
    if (nc >= 8) {
        if (total == 0) bw_u(w, 3, 6);
        else bw_u(w, (uint32_t)(((total - 1) << 2) | trailing), 6);
    } else if (nc >= 0) {
        int ti = nc < 2 ? 0 : (nc < 4 ? 1 : 2);
        int ln = g_ct_len[ti][trailing][total];
        if (ln == 0) return -1;
        bw_u(w, g_ct_cod[ti][trailing][total], ln);
    } else {
        int ti = nc == -1 ? 0 : 1;
        int ln = g_ctdc_len[ti][trailing][total];
        if (ln == 0) return -1;
        bw_u(w, g_ctdc_cod[ti][trailing][total], ln);
    }
    if (total == 0) return 0;

    for (int k = nz - 1; k >= nz - trailing; k--)
        bw_u(w, c[nzpos[k]] < 0 ? 1 : 0, 1);

    int suffix_len = (total > 10 && trailing < 3) ? 1 : 0;
    int first = 1;
    for (int k = nz - 1 - trailing; k >= 0; k--) {
        int32_t level = c[nzpos[k]];
        int32_t level_code = level > 0 ? 2 * level - 2 : -2 * level - 1;
        if (first && trailing < 3) level_code -= 2;
        first = 0;
        if (suffix_len == 0) {
            if (level_code < 14) bw_u(w, 1, level_code + 1);
            else if (level_code < 30) { bw_u(w, 1, 15); bw_u(w, level_code - 14, 4); }
            else if (level_code < 30 + 4096) { bw_u(w, 1, 16); bw_u(w, level_code - 30, 12); }
            else return -2;
        } else {
            int prefix = level_code >> suffix_len;
            if (prefix < 15) {
                bw_u(w, 1, prefix + 1);
                bw_u(w, level_code & ((1 << suffix_len) - 1), suffix_len);
            } else {
                int esc = level_code - (15 << suffix_len);
                if (esc >= 4096) return -2;
                bw_u(w, 1, 16);
                bw_u(w, esc, 12);
            }
        }
        if (suffix_len == 0) suffix_len = 1;
        int32_t alevel = level < 0 ? -level : level;
        if (alevel > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }

    int total_zeros = nzpos[nz - 1] + 1 - total;
    if (total < max_coeff) {
        int vlcnum = total - 1;
        if (max_coeff == 4) bw_u(w, g_tzdc0_cod[vlcnum][total_zeros],
                                 g_tzdc0_len[vlcnum][total_zeros]);
        else if (max_coeff == 8) bw_u(w, g_tzdc1_cod[vlcnum][total_zeros],
                                      g_tzdc1_len[vlcnum][total_zeros]);
        else bw_u(w, g_tz_cod[vlcnum][total_zeros],
                  g_tz_len[vlcnum][total_zeros]);
    }

    int zeros_left = total_zeros;
    for (int j = nz - 1; j >= 1; j--) {
        if (zeros_left <= 0) break;
        int run = nzpos[j] - nzpos[j - 1] - 1;
        int vlc = (zeros_left < 7 ? zeros_left : 7) - 1;
        bw_u(w, g_run_cod[vlc][run], g_run_len[vlc][run]);
        zeros_left -= run;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* picture state + prediction context (predict_ctx.py twin)            */
/* ------------------------------------------------------------------ */

static const int CODE2RASTER[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                    8, 9, 12, 13, 10, 11, 14, 15};
static const int RASTER2CODE[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                    8, 9, 12, 13, 10, 11, 14, 15};
/* RASTER2CODE = argsort(CODE2RASTER); computed below at init */
static int g_r2c[16];
static void init_r2c(void) {
    for (int c = 0; c < 16; c++) g_r2c[CODE2RASTER[c]] = c;
}

typedef struct {
    int n, mb_w, crows;
    const int8_t *mb_class;
    const uint8_t *skip;
    const int8_t *inter_mode;
    const int8_t *sub_mode;     /* (n,4) */
    const int8_t *ref_idx;      /* (n,4) */
    const int32_t *mv;          /* (n,16,2) */
    const int32_t *cbp;
    const int32_t *qp;
    const int32_t *slice_id;
    const int8_t *i4_modes;     /* (n,16) */
    const int8_t *i16_mode;
    const int8_t *chroma_mode;
    const int32_t *luma_coef;   /* (n,16,16) */
    const int32_t *luma_dc;     /* (n,16) */
    const int32_t *luma_coef8;  /* (n,4,64) */
    const uint8_t *transform8x8;
    const int32_t *luma_nnz;    /* (n,16) */
    const int32_t *chroma_dc;   /* (n,2,2*crows) */
    const int32_t *chroma_coef; /* (n,2,2*crows,16) */
    const int32_t *chroma_nnz;  /* (n,2,2*crows) */
} Pic;

static inline int avail(const Pic *p, int naddr, int cur) {
    return naddr >= 0 && naddr < p->n
        && p->slice_id[naddr] == p->slice_id[cur];
}

static inline int combine_nc(int na, int aa, int nb, int ab) {
    if (aa && ab) return (na + nb + 1) >> 1;
    if (aa) return na;
    if (ab) return nb;
    return 0;
}

static int nc_luma(const Pic *p, int addr, int blk) {
    int by = blk / 4, bx = blk % 4;
    int a_addr, a_blk, aa, b_addr, b_blk, ab;
    if (bx > 0) { a_addr = addr; a_blk = blk - 1; aa = 1; }
    else {
        a_addr = (addr % p->mb_w) ? addr - 1 : -1;
        a_blk = blk + 3;
        aa = avail(p, a_addr, addr);
    }
    if (by > 0) { b_addr = addr; b_blk = blk - 4; ab = 1; }
    else {
        b_addr = addr - p->mb_w;
        b_blk = blk + 12;
        ab = avail(p, b_addr, addr);
    }
    return combine_nc(aa ? p->luma_nnz[a_addr * 16 + a_blk] : 0, aa,
                      ab ? p->luma_nnz[b_addr * 16 + b_blk] : 0, ab);
}

static int nc_chroma(const Pic *p, int addr, int comp, int blk) {
    int crows = p->crows, nb = 2 * crows;
    int by = blk / 2, bx = blk % 2;
    int a_addr, a_blk, aa, b_addr, b_blk, ab;
    if (bx > 0) { a_addr = addr; a_blk = blk - 1; aa = 1; }
    else {
        a_addr = (addr % p->mb_w) ? addr - 1 : -1;
        a_blk = blk + 1;
        aa = avail(p, a_addr, addr);
    }
    if (by > 0) { b_addr = addr; b_blk = blk - 2; ab = 1; }
    else {
        b_addr = addr - p->mb_w;
        b_blk = blk + 2 * (crows - 1);
        ab = avail(p, b_addr, addr);
    }
    const int32_t *cn = p->chroma_nnz;
    return combine_nc(aa ? cn[(a_addr * 2 + comp) * nb + a_blk] : 0, aa,
                      ab ? cn[(b_addr * 2 + comp) * nb + b_blk] : 0, ab);
}

static int pred_intra4_mode(const Pic *p, int addr, int blk) {
    int by = blk / 4, bx = blk % 4;
    int ma, mb, aa, ab;
    if (bx > 0) {
        ma = p->i4_modes[addr * 16 + blk - 1];
        aa = 1;
        if (p->mb_class[addr] != 1) ma = 2;
    } else {
        int a_addr = (addr % p->mb_w) ? addr - 1 : -1;
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

/* returns 1 if a neighbor exists; *mvx/*mvy/*ref filled ((0,0,-1) for
 * intra / no-motion neighbors) */
static int mv_neighbor(const Pic *p, int addr, int bx, int by, int cur_blk,
                       int *mvx, int *mvy, int *ref) {
    int mbx = addr % p->mb_w, mby = addr / p->mb_w;
    int gx = mbx * 4 + bx, gy = mby * 4 + by;
    if (gx < 0 || gy < 0 || gx >= p->mb_w * 4) return 0;
    int naddr = (gy / 4) * p->mb_w + (gx / 4);
    int nblk = (gy % 4) * 4 + (gx % 4);
    if (naddr == addr) {
        if (g_r2c[nblk] >= g_r2c[cur_blk]) return 0;
    } else {
        if (naddr > addr || !avail(p, naddr, addr)) return 0;
    }
    int q = (nblk / 8) * 2 + ((nblk % 4) / 2);
    int r = p->ref_idx[naddr * 4 + q];
    if (r < 0) { *mvx = 0; *mvy = 0; *ref = -1; return 1; }
    *mvx = p->mv[(naddr * 16 + nblk) * 2];
    *mvy = p->mv[(naddr * 16 + nblk) * 2 + 1];
    *ref = r;
    return 1;
}

static inline int med3(int a, int b, int c) {
    int mx = a > b ? a : b;
    if (c > mx) mx = c;
    int mn = a < b ? a : b;
    if (c < mn) mn = c;
    return a + b + c - mx - mn;
}

static void mv_pred(const Pic *p, int addr, int bx, int by, int bw, int bh,
                    int ref, int *px, int *py) {
    int cur = by * 4 + bx;
    int ax, ay, ar, bx_, by_, br, cx, cy, cr;
    int ha = mv_neighbor(p, addr, bx - 1, by, cur, &ax, &ay, &ar);
    int hb = mv_neighbor(p, addr, bx, by - 1, cur, &bx_, &by_, &br);
    int hc = mv_neighbor(p, addr, bx + bw, by - 1, cur, &cx, &cy, &cr);
    if (!hc) hc = mv_neighbor(p, addr, bx - 1, by - 1, cur, &cx, &cy, &cr);

    if (bw == 4 && bh == 2) {
        if (by == 0 && hb && br == ref) { *px = bx_; *py = by_; return; }
        if (by == 2 && ha && ar == ref) { *px = ax; *py = ay; return; }
    } else if (bw == 2 && bh == 4) {
        if (bx == 0 && ha && ar == ref) { *px = ax; *py = ay; return; }
        if (bx == 2 && hc && cr == ref) { *px = cx; *py = cy; return; }
    }
    int mva[2] = {ha ? ax : 0, ha ? ay : 0};
    int mvb[2] = {hb ? bx_ : 0, hb ? by_ : 0};
    int mvc[2] = {hc ? cx : 0, hc ? cy : 0};
    int refa = ha ? ar : -2, refb = hb ? br : -2, refc = hc ? cr : -2;
    if (ha && !hb && !hc) { *px = mva[0]; *py = mva[1]; return; }
    int m0 = refa == ref, m1 = refb == ref, m2 = refc == ref;
    if (m0 + m1 + m2 == 1) {
        if (m0) { *px = mva[0]; *py = mva[1]; }
        else if (m1) { *px = mvb[0]; *py = mvb[1]; }
        else { *px = mvc[0]; *py = mvc[1]; }
        return;
    }
    *px = med3(mva[0], mvb[0], mvc[0]);
    *py = med3(mva[1], mvb[1], mvc[1]);
}

/* ------------------------------------------------------------------ */
/* MB serialization                                                    */
/* ------------------------------------------------------------------ */

static const int PARTS[4][4][4] = {
    /* mode -> list of (bx, by, bw, bh); unused rows bw=0 */
    {{0, 0, 4, 4}, {0}, {0}, {0}},
    {{0, 0, 4, 2}, {0, 2, 4, 2}, {0}, {0}},
    {{0, 0, 2, 4}, {2, 0, 2, 4}, {0}, {0}},
    {{0, 0, 2, 2}, {2, 0, 2, 2}, {0, 2, 2, 2}, {2, 2, 2, 2}},
};
static const int NPARTS[4] = {1, 2, 2, 4};
/* P8x8 sub-partitions (me.SUB_PARTS): sub_mode -> (sx, sy, sw, sh) */
static const int SUBP[4][4][4] = {
    {{0, 0, 2, 2}, {0}, {0}, {0}},
    {{0, 0, 2, 1}, {0, 1, 2, 1}, {0}, {0}},
    {{0, 0, 1, 2}, {1, 0, 1, 2}, {0}, {0}},
    {{0, 0, 1, 1}, {1, 0, 1, 1}, {0, 1, 1, 1}, {1, 1, 1, 1}},
};
static const int NSUBP[4] = {1, 2, 2, 4};

typedef struct {
    int slice_qp;      /* running QP for delta coding */
    int skip_run;
    int slice_type;    /* 0=P, 2=I (SliceType values) */
    int num_ref;
    int transform8x8_mode;
} WState;

static int write_qp_delta(BW *w, WState *st, const Pic *p, int addr) {
    int dq = p->qp[addr] - st->slice_qp;
    if (dq > 25) dq -= 52;
    else if (dq < -26) dq += 52;
    bw_se(w, dq);
    st->slice_qp = p->qp[addr];
    return 0;
}

static int write_luma_residual(BW *w, const Pic *p, int addr, int cbp,
                               int is_i16) {
    if (is_i16) {
        int nc = nc_luma(p, addr, 0);
        if (write_residual(w, &p->luma_dc[addr * 16], nc, 16) < 0) return -1;
    }
    for (int blk8 = 0; blk8 < 4; blk8++) {
        if (!(cbp & (1 << blk8))) continue;
        for (int sub = 0; sub < 4; sub++) {
            int blk = CODE2RASTER[blk8 * 4 + sub];
            int nc = nc_luma(p, addr, blk);
            const int32_t *c = &p->luma_coef[(addr * 16 + blk) * 16];
            if (is_i16) {
                if (write_residual(w, c + 1, nc, 15) < 0) return -1;
            } else {
                if (write_residual(w, c, nc, 16) < 0) return -1;
            }
        }
    }
    return 0;
}

static int write_luma_residual_8x8(BW *w, const Pic *p, int addr, int cbp) {
    int32_t tmp[16];
    for (int blk8 = 0; blk8 < 4; blk8++) {
        if (!(cbp & (1 << blk8))) continue;
        int by0 = (blk8 / 2) * 2, bx0 = (blk8 % 2) * 2;
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++) {
                int blk = (by0 + dy) * 4 + bx0 + dx;
                int sub = 2 * dy + dx;
                int nc = nc_luma(p, addr, blk);
                const int32_t *c8 = &p->luma_coef8[(addr * 4 + blk8) * 64];
                for (int k = 0; k < 16; k++) tmp[k] = c8[4 * k + sub];
                if (write_residual(w, tmp, nc, 16) < 0) return -1;
            }
    }
    return 0;
}

static int write_chroma_residual(BW *w, const Pic *p, int addr, int cbp) {
    int cbp_chroma = cbp >> 4;
    int nb = 2 * p->crows;
    int dc_nc = p->crows == 2 ? -1 : -2;
    if (cbp_chroma & 3) {
        for (int comp = 0; comp < 2; comp++) {
            const int32_t *dc = &p->chroma_dc[(addr * 2 + comp) * nb];
            if (write_residual(w, dc, dc_nc, nb) < 0) return -1;
        }
    }
    if (cbp_chroma & 2) {
        for (int comp = 0; comp < 2; comp++)
            for (int blk = 0; blk < nb; blk++) {
                int nc = nc_chroma(p, addr, comp, blk);
                const int32_t *c =
                    &p->chroma_coef[((addr * 2 + comp) * nb + blk) * 16];
                if (write_residual(w, c + 1, nc, 15) < 0) return -1;
            }
    }
    return 0;
}

static int write_intra_mb(BW *w, WState *st, const Pic *p, int addr,
                          int base) {
    int cbp = p->cbp[addr];
    if (p->mb_class[addr] == 1) {            /* I_NxN */
        bw_ue(w, base + 0);
        if (st->transform8x8_mode) bw_u(w, 0, 1);
        for (int ci = 0; ci < 16; ci++) {
            int blk = CODE2RASTER[ci];
            int mode = p->i4_modes[addr * 16 + blk];
            int pred = pred_intra4_mode(p, addr, blk);
            if (mode == pred) bw_u(w, 1, 1);
            else {
                bw_u(w, 0, 1);
                bw_u(w, mode < pred ? mode : mode - 1, 3);
            }
        }
        bw_ue(w, p->chroma_mode[addr]);
        bw_ue(w, g_cbp_inv_chroma[0][cbp]);
        if (cbp) write_qp_delta(w, st, p, addr);
        if (write_luma_residual(w, p, addr, cbp & 15, 0) < 0) return -1;
        return write_chroma_residual(w, p, addr, cbp);
    }
    /* I_16x16 */
    int cbp_luma_flag = (cbp & 15) ? 1 : 0;
    int k = 1 + p->i16_mode[addr] + ((cbp >> 4) << 2) + cbp_luma_flag * 12;
    bw_ue(w, base + k);
    bw_ue(w, p->chroma_mode[addr]);
    write_qp_delta(w, st, p, addr);
    if (write_luma_residual(w, p, addr, cbp & 15, 1) < 0) return -1;
    return write_chroma_residual(w, p, addr, cbp);
}

static int write_p_inter_mb(BW *w, WState *st, const Pic *p, int addr) {
    int mode = p->inter_mode[addr];
    if (mode < 0) mode = 0;
    bw_ue(w, mode);
    int num_ref = st->num_ref;
    if (mode == 3) {
        for (int q = 0; q < 4; q++)
            bw_ue(w, p->sub_mode[addr * 4 + q]);
        if (num_ref > 1)
            for (int q = 0; q < 4; q++)
                bw_te(w, p->ref_idx[addr * 4 + q], num_ref - 1);
        for (int q = 0; q < 4; q++) {
            int qx = (q % 2) * 2, qy = (q / 2) * 2;
            int ref = p->ref_idx[addr * 4 + q];
            int sm = p->sub_mode[addr * 4 + q];
            for (int s = 0; s < NSUBP[sm]; s++) {
                int sx = SUBP[sm][s][0], sy = SUBP[sm][s][1];
                int sw = SUBP[sm][s][2], sh = SUBP[sm][s][3];
                int bx = qx + sx, by = qy + sy, px, py;
                mv_pred(p, addr, bx, by, sw, sh, ref, &px, &py);
                const int32_t *mv = &p->mv[(addr * 16 + by * 4 + bx) * 2];
                bw_se(w, mv[0] - px);
                bw_se(w, mv[1] - py);
            }
        }
    } else {
        if (num_ref > 1)
            for (int i = 0; i < NPARTS[mode]; i++) {
                int bx = PARTS[mode][i][0], by = PARTS[mode][i][1];
                int q = (by / 2) * 2 + bx / 2;
                bw_te(w, p->ref_idx[addr * 4 + q], num_ref - 1);
            }
        for (int i = 0; i < NPARTS[mode]; i++) {
            int bx = PARTS[mode][i][0], by = PARTS[mode][i][1];
            int bw_ = PARTS[mode][i][2], bh = PARTS[mode][i][3];
            int q = (by / 2) * 2 + bx / 2;
            int ref = p->ref_idx[addr * 4 + q];
            int px, py;
            mv_pred(p, addr, bx, by, bw_, bh, ref, &px, &py);
            const int32_t *mv = &p->mv[(addr * 16 + by * 4 + bx) * 2];
            bw_se(w, mv[0] - px);
            bw_se(w, mv[1] - py);
        }
    }
    int cbp = p->cbp[addr];
    bw_ue(w, g_cbp_inv_chroma[1][cbp]);
    int allow8 = p->inter_mode[addr] != 3;
    if (!allow8) {
        allow8 = 1;
        for (int q = 0; q < 4; q++)
            if (p->sub_mode[addr * 4 + q]) allow8 = 0;
    }
    if (st->transform8x8_mode && (cbp & 15) && allow8)
        bw_u(w, p->transform8x8[addr] ? 1 : 0, 1);
    if (cbp) write_qp_delta(w, st, p, addr);
    if (p->transform8x8[addr]) {
        if (write_luma_residual_8x8(w, p, addr, cbp & 15) < 0) return -1;
    } else {
        if (write_luma_residual(w, p, addr, cbp & 15, 0) < 0) return -1;
    }
    return write_chroma_residual(w, p, addr, cbp);
}

static PyObject *py_cavlc_slice_data(PyObject *self, PyObject *args) {
    PyObject *head_obj, *pic_dict, *addrs_obj;
    unsigned long long acc;
    int nacc, slice_type, num_ref, t8mode, slice_qp;
    if (!PyArg_ParseTuple(args, "SKiOOiiii", &head_obj, &acc, &nacc,
                          &pic_dict, &addrs_obj, &slice_type, &num_ref,
                          &t8mode, &slice_qp))
        return NULL;
    if (!g_tables_set) {
        PyErr_SetString(PyExc_RuntimeError, "cavlc tables not installed");
        return NULL;
    }

    Buf b_class = {{0}, 0}, b_skip = {{0}, 0}, b_imode = {{0}, 0},
        b_sub = {{0}, 0}, b_ref = {{0}, 0}, b_mv = {{0}, 0},
        b_cbp = {{0}, 0}, b_qp = {{0}, 0}, b_sid = {{0}, 0},
        b_i4 = {{0}, 0}, b_i16 = {{0}, 0}, b_cm = {{0}, 0},
        b_lc = {{0}, 0}, b_ldc = {{0}, 0}, b_lc8 = {{0}, 0},
        b_t8 = {{0}, 0}, b_lnnz = {{0}, 0}, b_cdc = {{0}, 0},
        b_cc = {{0}, 0}, b_cnnz = {{0}, 0}, b_addrs = {{0}, 0};
    PyObject *result = NULL;
    BW w = {0};

    if (get_arr(pic_dict, "mb_class", &b_class, 0) < 0 ||
        get_arr(pic_dict, "skip", &b_skip, 0) < 0 ||
        get_arr(pic_dict, "inter_mode", &b_imode, 0) < 0 ||
        get_arr(pic_dict, "sub_mode", &b_sub, 0) < 0 ||
        get_arr(pic_dict, "ref_idx", &b_ref, 0) < 0 ||
        get_arr(pic_dict, "mv", &b_mv, 0) < 0 ||
        get_arr(pic_dict, "cbp", &b_cbp, 0) < 0 ||
        get_arr(pic_dict, "qp", &b_qp, 0) < 0 ||
        get_arr(pic_dict, "slice_id", &b_sid, 0) < 0 ||
        get_arr(pic_dict, "i4_modes", &b_i4, 0) < 0 ||
        get_arr(pic_dict, "i16_mode", &b_i16, 0) < 0 ||
        get_arr(pic_dict, "chroma_mode", &b_cm, 0) < 0 ||
        get_arr(pic_dict, "luma_coef", &b_lc, 0) < 0 ||
        get_arr(pic_dict, "luma_dc", &b_ldc, 0) < 0 ||
        get_arr(pic_dict, "luma_coef8", &b_lc8, 0) < 0 ||
        get_arr(pic_dict, "transform8x8", &b_t8, 0) < 0 ||
        get_arr(pic_dict, "luma_nnz", &b_lnnz, 0) < 0 ||
        get_arr(pic_dict, "chroma_dc", &b_cdc, 0) < 0 ||
        get_arr(pic_dict, "chroma_coef", &b_cc, 0) < 0 ||
        get_arr(pic_dict, "chroma_nnz", &b_cnnz, 0) < 0)
        goto done;
    if (PyObject_GetBuffer(addrs_obj, &b_addrs.view, PyBUF_C_CONTIGUOUS) < 0)
        goto done;
    b_addrs.ok = 1;

    {
        PyObject *mw_o = PyDict_GetItemString(pic_dict, "mb_w");
        PyObject *cr_o = PyDict_GetItemString(pic_dict, "crows");
        if (!mw_o || !cr_o) {
            PyErr_SetString(PyExc_KeyError, "mb_w/crows missing");
            goto done;
        }
        Pic p;
        p.mb_w = (int)PyLong_AsLong(mw_o);
        p.crows = (int)PyLong_AsLong(cr_o);
        if (PyErr_Occurred()) goto done;
        p.n = (int)b_class.view.len;
        {
            Py_ssize_t n = p.n, nb = 2 * (Py_ssize_t)p.crows;
            if (p.mb_w <= 0 || (p.crows != 2 && p.crows != 4)) {
                PyErr_SetString(PyExc_ValueError, "bad mb_w / crows");
                goto done;
            }
            if (check_len(&b_skip, "skip", n) < 0 ||
                check_len(&b_imode, "inter_mode", n) < 0 ||
                check_len(&b_sub, "sub_mode", n * 4) < 0 ||
                check_len(&b_ref, "ref_idx", n * 4) < 0 ||
                check_len(&b_mv, "mv", n * 16 * 2 * 4) < 0 ||
                check_len(&b_cbp, "cbp", n * 4) < 0 ||
                check_len(&b_qp, "qp", n * 4) < 0 ||
                check_len(&b_sid, "slice_id", n * 4) < 0 ||
                check_len(&b_i4, "i4_modes", n * 16) < 0 ||
                check_len(&b_i16, "i16_mode", n) < 0 ||
                check_len(&b_cm, "chroma_mode", n) < 0 ||
                check_len(&b_lc, "luma_coef", n * 16 * 16 * 4) < 0 ||
                check_len(&b_ldc, "luma_dc", n * 16 * 4) < 0 ||
                check_len(&b_lc8, "luma_coef8", n * 4 * 64 * 4) < 0 ||
                check_len(&b_t8, "transform8x8", n) < 0 ||
                check_len(&b_lnnz, "luma_nnz", n * 16 * 4) < 0 ||
                check_len(&b_cdc, "chroma_dc", n * 2 * nb * 4) < 0 ||
                check_len(&b_cc, "chroma_coef", n * 2 * nb * 16 * 4) < 0 ||
                check_len(&b_cnnz, "chroma_nnz", n * 2 * nb * 4) < 0)
                goto done;
            if (b_addrs.view.len % 4) {
                PyErr_SetString(PyExc_ValueError, "addrs must be int32");
                goto done;
            }
            const int32_t *a = (const int32_t *)b_addrs.view.buf;
            for (Py_ssize_t i = 0; i < b_addrs.view.len / 4; i++)
                if (a[i] < 0 || a[i] >= n) {
                    PyErr_Format(PyExc_ValueError, "MB address %d outside "
                                 "the picture", (int)a[i]);
                    goto done;
                }
        }
        p.mb_class = (const int8_t *)b_class.view.buf;
        p.skip = (const uint8_t *)b_skip.view.buf;
        p.inter_mode = (const int8_t *)b_imode.view.buf;
        p.sub_mode = (const int8_t *)b_sub.view.buf;
        p.ref_idx = (const int8_t *)b_ref.view.buf;
        p.mv = (const int32_t *)b_mv.view.buf;
        p.cbp = (const int32_t *)b_cbp.view.buf;
        p.qp = (const int32_t *)b_qp.view.buf;
        p.slice_id = (const int32_t *)b_sid.view.buf;
        p.i4_modes = (const int8_t *)b_i4.view.buf;
        p.i16_mode = (const int8_t *)b_i16.view.buf;
        p.chroma_mode = (const int8_t *)b_cm.view.buf;
        p.luma_coef = (const int32_t *)b_lc.view.buf;
        p.luma_dc = (const int32_t *)b_ldc.view.buf;
        p.luma_coef8 = (const int32_t *)b_lc8.view.buf;
        p.transform8x8 = (const uint8_t *)b_t8.view.buf;
        p.luma_nnz = (const int32_t *)b_lnnz.view.buf;
        p.chroma_dc = (const int32_t *)b_cdc.view.buf;
        p.chroma_coef = (const int32_t *)b_cc.view.buf;
        p.chroma_nnz = (const int32_t *)b_cnnz.view.buf;

        const int32_t *addrs = (const int32_t *)b_addrs.view.buf;
        Py_ssize_t naddrs = b_addrs.view.len / 4;

        bw_init(&w, (const uint8_t *)PyBytes_AS_STRING(head_obj),
                PyBytes_GET_SIZE(head_obj), acc, nacc);
        WState st = {slice_qp, 0, slice_type, num_ref, t8mode};

        int rc = 0;
        for (Py_ssize_t i = 0; i < naddrs && rc == 0; i++) {
            int addr = addrs[i];
            if (st.slice_type == 0) {       /* P */
                if (p.skip[addr]) { st.skip_run++; continue; }
                bw_ue(&w, st.skip_run);
                st.skip_run = 0;
                if (p.mb_class[addr] == 0)
                    rc = write_p_inter_mb(&w, &st, &p, addr);
                else if (p.mb_class[addr] == 3)
                    rc = -3;                 /* IPCM: python fallback */
                else
                    rc = write_intra_mb(&w, &st, &p, addr, 5);
            } else {                         /* I */
                if (p.mb_class[addr] == 3) rc = -3;
                else rc = write_intra_mb(&w, &st, &p, addr, 0);
            }
        }
        if (rc == 0) {
            if (st.slice_type == 0 && st.skip_run > 0)
                bw_ue(&w, st.skip_run);
            bw_trailing(&w);
        }
        if (rc < 0 || w.err) {
            PyErr_Format(PyExc_ValueError,
                         "cavlc_slice_data failed (rc=%d err=%d)", rc, w.err);
            goto done;
        }
        result = PyBytes_FromStringAndSize((const char *)w.buf,
                                           (Py_ssize_t)w.len);
    }

done:
    if (w.buf) free(w.buf);
    rel(&b_class); rel(&b_skip); rel(&b_imode); rel(&b_sub); rel(&b_ref);
    rel(&b_mv); rel(&b_cbp); rel(&b_qp); rel(&b_sid); rel(&b_i4);
    rel(&b_i16); rel(&b_cm); rel(&b_lc); rel(&b_ldc); rel(&b_lc8);
    rel(&b_t8); rel(&b_lnnz); rel(&b_cdc); rel(&b_cc); rel(&b_cnnz);
    rel(&b_addrs);
    return result;
}

/* ------------------------------------------------------------------ */
/* the host motion search's fractional refinement                      */
/* (encoder/me.py subpel_refine)                                       */
/* ------------------------------------------------------------------ */

/* ops/consts.QPEL_TAB by xf + 4 yf: (plane1, dx1, dy1, plane2, dx2, dy2),
 * and the reference planes' padding PAD; installed by set_qpel_tab */
static int g_qpel[16][6];
static int g_pad = -1;

static PyObject *py_set_qpel_tab(PyObject *self, PyObject *args) {
    PyObject *tab;
    int pad;
    if (!PyArg_ParseTuple(args, "Oi", &tab, &pad)) return NULL;
    Py_buffer v;
    if (PyObject_GetBuffer(tab, &v, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (v.len != (Py_ssize_t)sizeof(g_qpel)) {
        PyBuffer_Release(&v);
        PyErr_SetString(PyExc_ValueError, "set_qpel_tab: expected a (16, 6) "
                        "int32 table");
        return NULL;
    }
    memcpy(g_qpel, v.buf, sizeof(g_qpel));
    PyBuffer_Release(&v);
    g_pad = pad;
    Py_RETURN_NONE;
}

/* floor(v / 4), as Python's v >> 2 */
static inline int floor4(int v) { return v >= 0 ? v / 4 : -((-v + 3) / 4); }

static inline int64_t se_bits(int64_t v) {
    uint64_t u = v > 0 ? (uint64_t)(2 * v - 1) : (uint64_t)(-2 * v);
    return 2 * (64 - __builtin_clzll(u + 1)) - 1;
}

typedef struct {
    const uint8_t *org;         /* the block, row stride org_s */
    Py_ssize_t org_s;
    const uint8_t *pl;          /* the 4 planes, strides s0 / s1 / s2 */
    Py_ssize_t s0, s1, s2;
    int bw, bh, px, py, w, h, pmx, pmy, satd;
    int64_t lam, extra;
} SubpelCtx;

/* the cost of quarter-pel MV (mx, my): the SATD (or SAD) of the block
 * against me.mc_luma_block's prediction plus lam * (mvd bits + extra) */
static int64_t subpel_cost(const SubpelCtx *c, int mx, int my) {
    const int pad = g_pad;
    int x4 = c->px * 4 + mx, y4 = c->py * 4 + my;
    int xi = floor4(x4), yi = floor4(y4);
    if (xi > c->w + pad - c->bw - 1) xi = c->w + pad - c->bw - 1;
    if (xi < -pad) xi = -pad;
    if (yi > c->h + pad - c->bh - 1) yi = c->h + pad - c->bh - 1;
    if (yi < -pad) yi = -pad;
    const int *q = g_qpel[(x4 & 3) + 4 * (y4 & 3)];
    const uint8_t *a = c->pl + q[0] * c->s0 + (pad + yi + q[2]) * c->s1
                       + (pad + xi + q[1]) * c->s2;
    const uint8_t *b = q[3] < 0 ? NULL
        : c->pl + q[3] * c->s0 + (pad + yi + q[5]) * c->s1
          + (pad + xi + q[4]) * c->s2;
    int d[16][16];
    for (int y = 0; y < c->bh; y++)
        for (int x = 0; x < c->bw; x++) {
            int p = a[y * c->s1 + x * c->s2];
            if (b) p = (p + b[y * c->s1 + x * c->s2] + 1) >> 1;
            d[y][x] = (int)c->org[y * c->org_s + x] - p;
        }
    int64_t dist = 0;
    if (c->satd) {
        /* sum |H t H^T| over the 4x4 tiles, then >> 1 */
        for (int ty = 0; ty < c->bh; ty += 4)
            for (int tx = 0; tx < c->bw; tx += 4) {
                int m[4][4], r;
                for (int k = 0; k < 4; k++) {
                    int d0 = d[ty][tx + k], d1 = d[ty + 1][tx + k];
                    int d2 = d[ty + 2][tx + k], d3 = d[ty + 3][tx + k];
                    m[0][k] = d0 + d1 + d2 + d3;
                    m[1][k] = d0 + d1 - d2 - d3;
                    m[2][k] = d0 - d1 - d2 + d3;
                    m[3][k] = d0 - d1 + d2 - d3;
                }
                for (int i = 0; i < 4; i++) {
                    int e0 = m[i][0], e1 = m[i][1], e2 = m[i][2], e3 = m[i][3];
                    r = e0 + e1 + e2 + e3; dist += r < 0 ? -r : r;
                    r = e0 + e1 - e2 - e3; dist += r < 0 ? -r : r;
                    r = e0 - e1 - e2 + e3; dist += r < 0 ? -r : r;
                    r = e0 - e1 + e2 - e3; dist += r < 0 ? -r : r;
                }
            }
        dist >>= 1;
    } else {
        for (int y = 0; y < c->bh; y++)
            for (int x = 0; x < c->bw; x++)
                dist += d[y][x] < 0 ? -d[y][x] : d[y][x];
    }
    return dist + c->lam * (se_bits((int64_t)mx - c->pmx)
                            + se_bits((int64_t)my - c->pmy) + c->extra);
}

/* subpel_refine(orig_blk, planes, (px, py, mvx, mvy, w, h, pmx, pmy,
 * extra_bits, use_satd, qpel_start), lam) -> (mvx, mvy, cost): the half-
 * then quarter-pel refinement of encoder/me.py subpel_refine, on uint8
 * buffers of any strides (the block (bh, bw), bh and bw multiples of 4
 * up to 16; the planes (4, h + 2 PAD, w + 2 PAD)). */
static PyObject *py_subpel_refine(PyObject *self, PyObject *args) {
    PyObject *org_obj, *pl_obj;
    int px, py, mvx, mvy, w, h, pmx, pmy, extra, satd, qpel_start;
    long long lam;
    if (!PyArg_ParseTuple(args, "OO(iiiiiiiiiii)L", &org_obj, &pl_obj, &px,
                          &py, &mvx, &mvy, &w, &h, &pmx, &pmy, &extra, &satd,
                          &qpel_start, &lam))
        return NULL;
    if (g_pad < 0) {
        PyErr_SetString(PyExc_RuntimeError, "qpel table not installed");
        return NULL;
    }
    Py_buffer ov, pv;
    if (PyObject_GetBuffer(org_obj, &ov, PyBUF_STRIDES | PyBUF_FORMAT) < 0)
        return NULL;
    if (PyObject_GetBuffer(pl_obj, &pv, PyBUF_STRIDES | PyBUF_FORMAT) < 0) {
        PyBuffer_Release(&ov);
        return NULL;
    }
    PyObject *result = NULL;
    int ok_fmt = ov.itemsize == 1 && pv.itemsize == 1
                 && (!ov.format || !strcmp(ov.format, "B"))
                 && (!pv.format || !strcmp(pv.format, "B"));
    if (!ok_fmt || ov.ndim != 2 || pv.ndim != 3 || pv.shape[0] != 4
        || ov.strides[1] != 1 || ov.shape[0] % 4 || ov.shape[1] % 4
        || ov.shape[0] < 4 || ov.shape[1] < 4 || ov.shape[0] > 16
        || ov.shape[1] > 16 || pv.shape[1] != h + 2 * g_pad
        || pv.shape[2] != w + 2 * g_pad) {
        PyErr_SetString(PyExc_ValueError, "subpel_refine: expected a uint8 "
                        "block (bh, bw) and uint8 planes (4, h + 2 PAD, "
                        "w + 2 PAD)");
    } else {
        SubpelCtx c;
        c.org = (const uint8_t *)ov.buf;
        c.org_s = ov.strides[0];
        c.pl = (const uint8_t *)pv.buf;
        c.s0 = pv.strides[0];
        c.s1 = pv.strides[1];
        c.s2 = pv.strides[2];
        c.bh = (int)ov.shape[0];
        c.bw = (int)ov.shape[1];
        c.px = px; c.py = py; c.w = w; c.h = h; c.pmx = pmx; c.pmy = pmy;
        c.satd = satd; c.lam = lam; c.extra = extra;
        int bx = qpel_start ? mvx : 4 * mvx, by = qpel_start ? mvy : 4 * mvy;
        int64_t bcost = subpel_cost(&c, bx, by);
        for (int step = 2; step >= 1; step--) {
            /* the 8 neighbours in the reference's order; the first of
             * least cost replaces the centre when below it */
            int cx = bx, cy = by, found = 0;
            int64_t cmin = 0;
            for (int dy = -step; dy <= step; dy += step)
                for (int dx = -step; dx <= step; dx += step) {
                    if (!dx && !dy) continue;
                    int64_t v = subpel_cost(&c, bx + dx, by + dy);
                    if (!found || v < cmin) {
                        cmin = v; cx = bx + dx; cy = by + dy; found = 1;
                    }
                }
            if (cmin < bcost) { bx = cx; by = cy; bcost = cmin; }
        }
        result = Py_BuildValue("(iiL)", bx, by, (long long)bcost);
    }
    PyBuffer_Release(&ov);
    PyBuffer_Release(&pv);
    return result;
}

/* the (bh, bw) luma prediction at quarter-pel (x4, y4) from the 4
 * quarter-pel planes (me.mc_luma_block), into out (row stride bw) */
static void mc_luma(const uint8_t *pl, Py_ssize_t s0, Py_ssize_t s1,
                    Py_ssize_t s2, int x4, int y4, int bw, int bh, int w,
                    int h, int32_t *out) {
    const int pad = g_pad;
    int xi = floor4(x4), yi = floor4(y4);
    if (xi > w + pad - bw - 1) xi = w + pad - bw - 1;
    if (xi < -pad) xi = -pad;
    if (yi > h + pad - bh - 1) yi = h + pad - bh - 1;
    if (yi < -pad) yi = -pad;
    const int *q = g_qpel[(x4 & 3) + 4 * (y4 & 3)];
    const uint8_t *a = pl + q[0] * s0 + (pad + yi + q[2]) * s1
                       + (pad + xi + q[1]) * s2;
    const uint8_t *b = q[3] < 0 ? NULL
        : pl + q[3] * s0 + (pad + yi + q[5]) * s1 + (pad + xi + q[4]) * s2;
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
            int v = a[y * s1 + x * s2];
            out[y * bw + x] = b ? (v + b[y * s1 + x * s2] + 1) >> 1 : v;
        }
}

/* the (bh, bw) eighth-pel bilinear chroma prediction at (x8, y8) from a
 * padded plane (me.mc_chroma_block), into out (row stride bw) */
static void mc_chroma(const uint8_t *pl, Py_ssize_t s0, Py_ssize_t s1,
                      int x8, int y8, int bw, int bh, int w, int h,
                      int32_t *out) {
    const int pad = g_pad;
    int xi = x8 >= 0 ? x8 / 8 : -((-x8 + 7) / 8);
    int yi = y8 >= 0 ? y8 / 8 : -((-y8 + 7) / 8);
    if (xi > w + pad - bw - 1) xi = w + pad - bw - 1;
    if (xi < -pad) xi = -pad;
    if (yi > h + pad - bh - 1) yi = h + pad - bh - 1;
    if (yi < -pad) yi = -pad;
    const int xf = x8 & 7, yf = y8 & 7;
    const uint8_t *a = pl + (pad + yi) * s0 + (pad + xi) * s1;
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
            const uint8_t *p = a + y * s0 + x * s1;
            out[y * bw + x] = ((8 - xf) * (8 - yf) * p[0]
                               + xf * (8 - yf) * p[s1]
                               + (8 - xf) * yf * p[s0]
                               + xf * yf * p[s0 + s1] + 32) >> 6;
        }
}

/* mc_blk(planes, padU, padV, (x4, y4, bw, bh, w, h, cx8, cy8, cbw, cbh,
 * cw, ch), out_y, out_u, out_v): one block's luma prediction from the
 * quarter-pel planes (4, h + 2 PAD, w + 2 PAD) and its Cb / Cr
 * predictions from the padded chroma planes (ch + 2 PAD, cw + 2 PAD), all
 * uint8 of any strides, into the int32 C-contiguous outputs (bh, bw) and
 * (cbh, cbw): me.mc_luma_block and me.mc_chroma_block in one call. */
static PyObject *py_mc_blk(PyObject *self, PyObject *args) {
    PyObject *objs[6];
    int x4, y4, bw, bh, w, h, cx8, cy8, cbw, cbh, cw, ch;
    if (!PyArg_ParseTuple(args, "OOO(iiiiiiiiiiii)OOO", &objs[0], &objs[1],
                          &objs[2], &x4, &y4, &bw, &bh, &w, &h, &cx8, &cy8,
                          &cbw, &cbh, &cw, &ch, &objs[3], &objs[4],
                          &objs[5]))
        return NULL;
    if (g_pad < 0) {
        PyErr_SetString(PyExc_RuntimeError, "qpel table not installed");
        return NULL;
    }
    Py_buffer v[6];
    int got = 0, ok = 1;
    for (; got < 6; got++) {
        int flags = got < 3 ? (PyBUF_STRIDES | PyBUF_FORMAT)
                            : (PyBUF_C_CONTIGUOUS | PyBUF_FORMAT
                               | PyBUF_WRITABLE);
        if (PyObject_GetBuffer(objs[got], &v[got], flags) < 0) {
            ok = 0;
            break;
        }
    }
    if (ok) {
        for (int i = 0; i < 3; i++)
            ok &= v[i].itemsize == 1 && (!v[i].format
                                         || !strcmp(v[i].format, "B"));
        for (int i = 3; i < 6; i++) {
            char f = v[i].format[strlen(v[i].format) - 1];
            ok &= v[i].itemsize == 4 && f == 'i';
        }
        ok &= v[0].ndim == 3 && v[0].shape[0] == 4
              && v[0].shape[1] == h + 2 * g_pad
              && v[0].shape[2] == w + 2 * g_pad
              && v[1].ndim == 2 && v[2].ndim == 2
              && v[1].shape[0] == ch + 2 * g_pad
              && v[1].shape[1] == cw + 2 * g_pad
              && v[2].shape[0] == v[1].shape[0]
              && v[2].shape[1] == v[1].shape[1]
              && bw >= 1 && bh >= 1 && bw <= 16 && bh <= 16
              && cbw >= 1 && cbh >= 1 && cbw <= 16 && cbh <= 16
              && v[3].len == (Py_ssize_t)4 * bw * bh
              && v[4].len == (Py_ssize_t)4 * cbw * cbh
              && v[5].len == v[4].len;
        if (!ok)
            PyErr_SetString(PyExc_ValueError, "mc_blk: expected uint8 planes "
                            "(4, h + 2 PAD, w + 2 PAD) and two (ch + 2 PAD, "
                            "cw + 2 PAD), int32 outputs (bh, bw) and two "
                            "(cbh, cbw)");
    }
    if (ok) {
        mc_luma((const uint8_t *)v[0].buf, v[0].strides[0], v[0].strides[1],
                v[0].strides[2], x4, y4, bw, bh, w, h, (int32_t *)v[3].buf);
        for (int c = 1; c < 3; c++)
            mc_chroma((const uint8_t *)v[c].buf, v[c].strides[0],
                      v[c].strides[1], cx8, cy8, cbw, cbh, cw, ch,
                      (int32_t *)v[3 + c].buf);
    }
    for (int i = 0; i < got; i++) PyBuffer_Release(&v[i]);
    if (!ok) return NULL;
    Py_RETURN_NONE;
}

/* quad_sad(orig, plane, x, y) -> (s0, s1, s2, s3): the SADs of an MB's
 * four 8x8 quadrants (orig: (4, 8, 8) int32 C-contiguous, quadrants in
 * raster order) against the 16x16 window of plane (2-D uint8, any
 * strides) whose top-left sample is (x, y): the EPZS / UMHex searchers'
 * quadrant SADs at one integer displacement (me_epzs.py _qsad). */
static PyObject *py_quad_sad(PyObject *self, PyObject *args) {
    PyObject *org_obj, *pl_obj;
    int x, y;
    if (!PyArg_ParseTuple(args, "OOii", &org_obj, &pl_obj, &x, &y))
        return NULL;
    Py_buffer ov, pv;
    if (PyObject_GetBuffer(org_obj, &ov, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT)
        < 0)
        return NULL;
    if (PyObject_GetBuffer(pl_obj, &pv, PyBUF_STRIDES | PyBUF_FORMAT) < 0) {
        PyBuffer_Release(&ov);
        return NULL;
    }
    char fo = ov.format ? ov.format[strlen(ov.format) - 1] : 'B';
    int ok = ov.itemsize == 4 && fo == 'i' && ov.len == 4 * 4 * 64
             && pv.itemsize == 1 && (!pv.format || !strcmp(pv.format, "B"))
             && pv.ndim == 2 && x >= 0 && y >= 0 && x + 16 <= pv.shape[1]
             && y + 16 <= pv.shape[0];
    PyObject *result = NULL;
    if (!ok) {
        PyErr_SetString(PyExc_ValueError, "quad_sad: expected a (4, 8, 8) "
                        "int32 MB and a uint8 plane holding the window");
    } else {
        const int32_t *o = (const int32_t *)ov.buf;
        const uint8_t *p = (const uint8_t *)pv.buf;
        const Py_ssize_t s0 = pv.strides[0], s1 = pv.strides[1];
        long long sad[4] = {0, 0, 0, 0};
        for (int q = 0; q < 4; q++) {
            const int oy = y + (q >> 1) * 8, ox = x + (q & 1) * 8;
            for (int j = 0; j < 8; j++)
                for (int i = 0; i < 8; i++) {
                    int d = o[q * 64 + j * 8 + i]
                            - p[(oy + j) * s0 + (ox + i) * s1];
                    sad[q] += d < 0 ? -d : d;
                }
        }
        result = Py_BuildValue("(LLLL)", sad[0], sad[1], sad[2], sad[3]);
    }
    PyBuffer_Release(&ov);
    PyBuffer_Release(&pv);
    return result;
}

/* round(v / 4) as Python rounds it: half to even */
static inline int round4(int v) {
    int f = floor4(v), r = v - 4 * f;
    return r < 2 ? f : r > 2 ? f + 1 : (f & 1 ? f + 1 : f);
}

/* int_search(table, cols, (pmx, pmy, sr), lam) -> (mvx, mvy): the
 * integer full search's arg-min of encoder/me.py (the table's columns
 * cols summed, plus int_rate_tab, with best_int_mv_tiebreak's spiral
 * ranks). table: one MB's int16 / int32 / int64 SADs, ((2 sr + 1)^2,) or
 * ((2 sr + 1)^2, k), any strides; cols: column indices (ignored for a
 * 1-D table). */
static PyObject *py_int_search(PyObject *self, PyObject *args) {
    PyObject *tab_obj, *cols_obj;
    int pmx, pmy, sr;
    long long lam;
    if (!PyArg_ParseTuple(args, "OO(iii)L", &tab_obj, &cols_obj, &pmx, &pmy,
                          &sr, &lam))
        return NULL;
    Py_buffer v;
    if (PyObject_GetBuffer(tab_obj, &v, PyBUF_STRIDES | PyBUF_FORMAT) < 0)
        return NULL;
    const int side = 2 * sr + 1;
    char fc = v.format ? v.format[strlen(v.format) - 1] : 'B';
    int ok = sr >= 0 && sr < 1024 && (v.ndim == 1 || v.ndim == 2)
             && v.shape[0] == (Py_ssize_t)side * side
             && (fc == 'h' || fc == 'i' || fc == 'l' || fc == 'q')
             && (v.itemsize == 2 || v.itemsize == 4 || v.itemsize == 8);
    int cols[16], ncols = 1;
    cols[0] = 0;
    if (ok && v.ndim == 2) {
        PyObject *seq = PySequence_Fast(cols_obj, "int_search: cols");
        if (!seq) { PyBuffer_Release(&v); return NULL; }
        ncols = (int)PySequence_Fast_GET_SIZE(seq);
        ok = ncols >= 1 && ncols <= 16;
        for (int i = 0; ok && i < ncols; i++) {
            long c = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
            ok = c >= 0 && c < v.shape[1];
            cols[i] = (int)c;
        }
        Py_DECREF(seq);
        if (PyErr_Occurred()) { PyBuffer_Release(&v); return NULL; }
    }
    if (!ok) {
        PyBuffer_Release(&v);
        PyErr_SetString(PyExc_ValueError, "int_search: expected a signed "
                        "integer table of (2 sr + 1)^2 rows and up to 16 "
                        "valid columns");
        return NULL;
    }
    /* the rate of each displacement by axis (int_rate_tab's se(v) bits
     * of the mvd in quarter samples, clamped as its table is) */
    int64_t rx[2048], ry[2048];
    for (int i = 0; i < side; i++) {
        int64_t ax = 4LL * (i - sr) - pmx, ay = 4LL * (i - sr) - pmy;
        ax = ax < 0 ? -ax : ax;
        ay = ay < 0 ? -ay : ay;
        if (ax > 16383) ax = 16383;
        if (ay > 16383) ay = 16383;
        rx[i] = ax ? 2 * (64 - __builtin_clzll((uint64_t)(2 * ax))) - 1 : 1;
        ry[i] = ay ? 2 * (64 - __builtin_clzll((uint64_t)(2 * ay))) - 1 : 1;
    }
    int cx = round4(pmx), cy = round4(pmy);
    cx = cx < -sr ? -sr : cx > sr ? sr : cx;
    cy = cy < -sr ? -sr : cy > sr ? sr : cy;
    const char *base = (const char *)v.buf;
    const Py_ssize_t s0 = v.strides[0], s1 = v.ndim == 2 ? v.strides[1] : 0;
    int64_t best = 0;
    int bk = -1;
    for (int k = 0; k < side * side; k++) {
        int dy = k / side - sr, dx = k % side - sr;
        const char *row = base + k * s0;
        int64_t sad = 0;
        for (int i = 0; i < ncols; i++) {
            const char *e = row + cols[i] * s1;
            sad += v.itemsize == 2 ? *(const int16_t *)e
                   : v.itemsize == 4 ? *(const int32_t *)e
                                     : *(const int64_t *)e;
        }
        int ay = dy - cy < 0 ? cy - dy : dy - cy;
        int ax = dx - cx < 0 ? cx - dx : dx - cx;
        int ring = ax > ay ? ax : ay, sub = ax + ay;
        int64_t key = (sad + lam * (ry[dy + sr] + rx[dx + sr])) * 8192
                      + ring * 64 + (sub < 63 ? sub : 63);
        if (bk < 0 || key < best) { best = key; bk = k; }
    }
    PyBuffer_Release(&v);
    return Py_BuildValue("(ii)", bk % side - sr, bk / side - sr);
}

/* ------------------------------------------------------------------ */
/* the SP level decision                                                */
/* ------------------------------------------------------------------ */

/* UVLC lengths of a (level, run) pair: lencod vlc.c levrun_linfo_inter
 * (kind 0) and levrun_linfo_c2x2 (kind 1); twins of
 * encoder/residual_np.py levrun_len_inter / levrun_len_c2x2 */
static const int LEVRUN_INTER[16] = {4, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                                     0, 0, 0, 0, 0, 0};
static const int NTAB_INTER[4][10] = {{1, 3, 5, 9, 11, 13, 21, 23, 25, 27},
                                      {7, 17, 19, 0, 0, 0, 0, 0, 0, 0},
                                      {15, 0, 0, 0, 0, 0, 0, 0, 0, 0},
                                      {29, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
static const int LEVRUN_C2[4] = {2, 1, 0, 0};
static const int NTAB_C2[2][2] = {{1, 5}, {3, 0}};

static int uvlc_len(long long n) {
    long long nn = n >> 1;
    int i = 0;
    while (nn) {
        nn >>= 1;
        i++;
    }
    return 2 * i + 1;
}

static int levrun_len(long long level, int run, int kind) {
    long long la = level < 0 ? -level : level, n;
    if (kind == 0) {
        if (la <= LEVRUN_INTER[run]) n = NTAB_INTER[la - 1][run] + 1;
        else n = (la - LEVRUN_INTER[run]) * 32 + run * 2;
    } else {
        if (la <= LEVRUN_C2[run]) n = NTAB_C2[la - 1][run] + 1;
        else n = (la - LEVRUN_C2[run]) * 8 + run * 2;
    }
    return uvlc_len(n);
}

static inline long long isignab(long long a, long long b) {
    long long m = a < 0 ? -a : a;
    return b < 0 ? -m : m;
}

/* sp_levels(X, P, out, (qp, qs, shift, kind), lam, A, pos, scales): the
 * SP level decision of encoder/residual_np.py sp_quant_coeffs on every
 * row of X / P ((K, n) int64, C-contiguous: the source's and the
 * prediction's transform in scan order), each row from run -1, into out
 * ((K, n) int64). A / pos: (n,) int64, each scan position's A factor and
 * raster index into scales ((3, 16) int64: the quant scale at QS % 6,
 * the quant and the dequant scale at QP % 6); shift 6 (4x4) or 5
 * (chroma DC, whose quant shifts one more); kind 0 or 1, the rate of
 * levrun_len_inter or levrun_len_c2x2. The costs d * d + lam * rate are
 * doubles summed as Python sums them (the build has no FP contraction). */
static PyObject *py_sp_levels(PyObject *self, PyObject *args) {
    PyObject *objs[6];
    int qp, qs, shift, kind;
    double lam;
    if (!PyArg_ParseTuple(args, "OOO(iiii)dOOO", &objs[0], &objs[1],
                          &objs[2], &qp, &qs, &shift, &kind, &lam, &objs[3],
                          &objs[4], &objs[5]))
        return NULL;
    Py_buffer v[6];
    int got = 0, ok = 1;
    for (; got < 6; got++) {
        int flags = PyBUF_C_CONTIGUOUS | PyBUF_FORMAT
                    | (got == 2 ? PyBUF_WRITABLE : 0);
        if (PyObject_GetBuffer(objs[got], &v[got], flags) < 0) {
            ok = 0;
            break;
        }
    }
    Py_ssize_t n = 0, rows = 0;
    if (ok) {
        for (int i = 0; i < 6; i++) {
            char f = v[i].format[strlen(v[i].format) - 1];
            ok &= v[i].itemsize == 8 && (f == 'l' || f == 'q');
        }
        n = v[3].len / 8;
        ok &= n >= 1 && n <= 16 && v[4].len == v[3].len
              && v[0].len % (8 * n) == 0 && v[1].len == v[0].len
              && v[2].len == v[0].len && v[5].len == 3 * 16 * 8
              && qp >= 0 && qp <= 51 && qs >= 0 && qs <= 51
              && (shift == 5 || shift == 6) && (kind == 0 || kind == 1)
              && (kind == 0 ? n <= 16 : n <= 4);
        rows = ok ? v[0].len / (8 * n) : 0;
        const int64_t *pos = (const int64_t *)v[4].buf;
        for (Py_ssize_t k = 0; ok && k < n; k++) ok &= pos[k] >= 0
                                                       && pos[k] < 16;
        if (!ok)
            PyErr_SetString(PyExc_ValueError, "sp_levels: expected int64 "
                            "(K, n) X / P / out, (n,) A and pos (n <= 16), "
                            "(3, 16) scales, QP / QS 0..51, shift 5 or 6, "
                            "kind 0 or 1");
    }
    if (ok) {
        const int64_t *X = (const int64_t *)v[0].buf;
        const int64_t *P = (const int64_t *)v[1].buf;
        int64_t *out = (int64_t *)v[2].buf;
        const int64_t *A = (const int64_t *)v[3].buf;
        const int64_t *pos = (const int64_t *)v[4].buf;
        const int64_t *sc = (const int64_t *)v[5].buf;
        const int qp_per = qp / 6, qs_per = qs / 6;
        const int extra = shift == 5 ? 1 : 0;
        const int q_bits = 15 + qp_per + extra;
        const int q_bits_sp = 15 + qs_per + extra;
        const long long qp_const = extra
            ? 2 * ((1LL << (q_bits - 1)) / 6) : (1LL << q_bits) / 6;
        const long long qp_const2 = extra
            ? 2 * ((1LL << (q_bits_sp - 1)) >> 1) : (1LL << q_bits_sp) >> 1;
        const long long per_mul = 1LL << qp_per;
        for (Py_ssize_t r = 0; r < rows; r++) {
            int run = -1;
            for (Py_ssize_t k = 0; k < n; k++) {
                run++;
                const long long x = X[r * n + k], p = P[r * n + k];
                const long long qs_k = sc[pos[k]], qp_k = sc[16 + pos[k]];
                const long long dp_k = sc[32 + pos[k]], a_k = A[k];
                const long long l1p = ((p < 0 ? -p : p) * qs_k + qp_const2)
                                      >> q_bits_sp;
                const long long l1d = (l1p << q_bits_sp) / qs_k;
                const long long c_err1 = x - isignab(l1d, p);
                const long long l1 = ((c_err1 < 0 ? -c_err1 : c_err1) * qp_k
                                      + qp_const) >> q_bits;
                const long long c_err2 = x - p;
                const long long l2 = ((c_err2 < 0 ? -c_err2 : c_err2) * qp_k
                                      + qp_const) >> q_bits;
                long long level, c_err;
                if (l1 != l2 && l1 != 0 && l2 != 0) {
                    const long long d1 = x - ((isignab(l1, c_err1) * dp_k
                                               * a_k * per_mul) >> shift) - p;
                    const long long d2 = x - ((isignab(l2, c_err2) * dp_k
                                               * a_k * per_mul) >> shift) - p;
                    const double D1 = (double)(d1 * d1)
                                      + lam * (double)levrun_len(l1, run, kind);
                    const double D2 = (double)(d2 * d2)
                                      + lam * (double)levrun_len(l2, run, kind);
                    if (D1 == D2) {
                        if (l1 < l2) { level = l1; c_err = c_err1; }
                        else { level = l2; c_err = c_err2; }
                    } else if (D1 < D2) {
                        level = l1; c_err = c_err1;
                    } else {
                        level = l2; c_err = c_err2;
                    }
                } else if (l1 == l2) {
                    level = l1; c_err = c_err1;
                } else if (l1 == 0) {
                    level = l1; c_err = c_err1;
                } else {
                    level = l2; c_err = c_err2;
                }
                out[r * n + k] = 0;
                if (level != 0) {
                    out[r * n + k] = isignab(level, c_err);
                    run = -1;
                }
            }
        }
    }
    for (int i = 0; i < got; i++) PyBuffer_Release(&v[i]);
    if (!ok) return NULL;
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* registration                                                        */
/* ------------------------------------------------------------------ */

static PyMethodDef enc_methods[] = {
    {"set_cavlc_tables", py_set_cavlc_tables, METH_O,
     "install the normative CAVLC code tables (dict of arrays)"},
    {"cavlc_slice_data", py_cavlc_slice_data, METH_VARARGS,
     "serialize one slice's macroblocks (CAVLC) after a written header"},
    {"set_qpel_tab", py_set_qpel_tab, METH_VARARGS,
     "install the quarter-pel plane selection table and the padding"},
    {"subpel_refine", py_subpel_refine, METH_VARARGS,
     "the half- then quarter-pel refinement of one block's MV"},
    {"int_search", py_int_search, METH_VARARGS,
     "the integer full search's arg-min over one MB's SAD table"},
    {"mc_blk", py_mc_blk, METH_VARARGS,
     "one block's quarter-pel luma and eighth-pel chroma predictions"},
    {"quad_sad", py_quad_sad, METH_VARARGS,
     "an MB's four quadrant SADs at one integer displacement"},
    {"sp_levels", py_sp_levels, METH_VARARGS,
     "the SP level decision of rows of transform coefficients"},
    {NULL, NULL, 0, NULL},
};

extern "C" int register_jm_torch_enc(PyObject *module) {
    init_r2c();
    for (PyMethodDef *def = enc_methods; def->ml_name; def++) {
        PyObject *func = PyCFunction_NewEx(def, NULL, NULL);
        if (!func) return -1;
        if (PyModule_AddObject(module, def->ml_name, func) < 0) {
            Py_DECREF(func);
            return -1;
        }
    }
    return 0;
}
