/* jm_torch_native: the host C++ runtime of jm_tpu_torch, module core.
 *
 * The port's copy of jm_tpu's native/jm_native.cpp, under its own module
 * name (jm_torch_native), so that both packages load in one process. It
 * holds the host-side bit-serial layer, the part of the codec that is not
 * batched tensor math:
 *   - BitReader: MSB-first Exp-Golomb / fixed-width reader
 *     (parity: ldecod/src/vlc.c ue_v/se_v/u_v; Python twin
 *     jm_tpu_torch/bitstream/bitreader.py PyBitReader, same API; ``data``
 *     is the RBSP as bytes, as the twin's)
 *   - CabacEngine: binary arithmetic decoder with bit-serial renorm
 *     (parity: ldecod/src/biaridecod.c biari_decode_symbol; Python twin
 *     jm_tpu_torch/decoder/cabac.py PyCabacEngine)
 *   - ebsp_to_rbsp / rbsp_to_ebsp: emulation-prevention (un)escaping
 *     (ldecod/src/nalu.c EBSPtoRBSP, lencod/src/nal.c RBSPtoEBSP)
 * jm_enc.cpp adds the CAVLC slice serializer, jm_dec.cpp the CAVLC slice
 * parser and the intra reconstruction.
 *
 * Plain CPython C API (no pybind11, no torch headers), built by
 * jm_tpu_torch/native/__init__.py with g++. The CABAC state-transition
 * tables are installed once from common/cabac_tables.py
 * (set_cabac_tables), the single source of truth.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* BitReader                                                           */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    PyObject *bytes;     /* the RBSP, an owned bytes object */
    const uint8_t *data; /* its buffer */
    Py_ssize_t nbytes;
    int64_t nbits;
    int64_t pos;
} BitReaderObject;

static void BitReader_dealloc(BitReaderObject *self) {
    Py_XDECREF(self->bytes);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int BitReader_init(BitReaderObject *self, PyObject *args,
                          PyObject *kwds) {
    PyObject *src;
    if (!PyArg_ParseTuple(args, "O", &src)) return -1;
    Py_buffer view;
    if (PyObject_GetBuffer(src, &view, PyBUF_SIMPLE) < 0) return -1;
    PyObject *copy = PyBytes_FromStringAndSize((const char *)view.buf,
                                               view.len);
    PyBuffer_Release(&view);
    if (!copy) return -1;
    Py_XSETREF(self->bytes, copy);
    self->data = (const uint8_t *)PyBytes_AS_STRING(copy);
    self->nbytes = PyBytes_GET_SIZE(copy);
    self->nbits = (int64_t)self->nbytes * 8;
    self->pos = 0;
    return 0;
}

static inline int br_flag_raw(BitReaderObject *b) {
    /* caller must bounds-check */
    int64_t p = b->pos++;
    return (b->data[p >> 3] >> (7 - (p & 7))) & 1;
}

static inline int br_read_u(BitReaderObject *b, int n, uint64_t *out) {
    if (n == 0) { *out = 0; return 0; }
    if (b->pos + n > b->nbits) {
        PyErr_Format(PyExc_EOFError,
                     "bitreader overrun: need %d bits at %lld/%lld", n,
                     (long long)b->pos, (long long)b->nbits);
        return -1;
    }
    uint64_t acc = 0;
    int64_t p = b->pos;
    int64_t byte0 = p >> 3;
    int nbytes = (int)(((p & 7) + n + 7) >> 3);
    for (int i = 0; i < nbytes; i++) acc = (acc << 8) | b->data[byte0 + i];
    int shift = nbytes * 8 - (int)(p & 7) - n;
    b->pos = p + n;
    *out = (acc >> shift) & ((n >= 64) ? ~0ULL : ((1ULL << n) - 1));
    return 0;
}

static inline int br_read_ue(BitReaderObject *b, int64_t *out) {
    int zeros = 0;
    for (;;) {
        if (b->pos >= b->nbits) {
            PyErr_SetString(PyExc_EOFError, "bitreader overrun");
            return -1;
        }
        if (br_flag_raw(b)) break;
        if (++zeros > 32) {
            PyErr_SetString(PyExc_ValueError,
                            "invalid Exp-Golomb code (>32 leading zeros)");
            return -1;
        }
    }
    if (zeros == 0) { *out = 0; return 0; }
    uint64_t tail;
    if (br_read_u(b, zeros, &tail) < 0) return -1;
    *out = ((int64_t)1 << zeros) - 1 + (int64_t)tail;
    return 0;
}

static PyObject *BitReader_u(BitReaderObject *self, PyObject *arg) {
    long n = PyLong_AsLong(arg);
    if (n == -1 && PyErr_Occurred()) return NULL;
    uint64_t v;
    if (br_read_u(self, (int)n, &v) < 0) return NULL;
    return PyLong_FromUnsignedLongLong(v);
}

static PyObject *BitReader_flag(BitReaderObject *self, PyObject *noargs) {
    if (self->pos >= self->nbits) {
        PyErr_SetString(PyExc_EOFError, "bitreader overrun");
        return NULL;
    }
    return PyLong_FromLong(br_flag_raw(self));
}

static PyObject *BitReader_ue(BitReaderObject *self, PyObject *noargs) {
    int64_t v;
    if (br_read_ue(self, &v) < 0) return NULL;
    return PyLong_FromLongLong(v);
}

static PyObject *BitReader_se(BitReaderObject *self, PyObject *noargs) {
    int64_t k;
    if (br_read_ue(self, &k) < 0) return NULL;
    int64_t v = (k & 1) ? ((k + 1) >> 1) : -(k >> 1);
    return PyLong_FromLongLong(v);
}

static PyObject *BitReader_te(BitReaderObject *self, PyObject *arg) {
    long rng = PyLong_AsLong(arg);
    if (rng == -1 && PyErr_Occurred()) return NULL;
    if (rng == 1) {
        if (self->pos >= self->nbits) {
            PyErr_SetString(PyExc_EOFError, "bitreader overrun");
            return NULL;
        }
        return PyLong_FromLong(1 - br_flag_raw(self));
    }
    int64_t v;
    if (br_read_ue(self, &v) < 0) return NULL;
    return PyLong_FromLongLong(v);
}

static PyObject *BitReader_byte_aligned(BitReaderObject *self, PyObject *na) {
    if ((self->pos & 7) == 0) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static PyObject *BitReader_align(BitReaderObject *self, PyObject *na) {
    self->pos = (self->pos + 7) & ~7LL;
    Py_RETURN_NONE;
}

static PyObject *BitReader_bits_left(BitReaderObject *self, PyObject *na) {
    return PyLong_FromLongLong(self->nbits - self->pos);
}

static PyObject *BitReader_more_rbsp_data(BitReaderObject *self, PyObject *na) {
    if (self->pos >= self->nbits) Py_RETURN_FALSE;
    Py_ssize_t last = self->nbytes - 1;
    while (last >= 0 && self->data[last] == 0) last--;
    if (last < 0) Py_RETURN_FALSE;
    uint8_t b = self->data[last];
    int low = 0;
    while (!((b >> low) & 1)) low++;     /* lowest set bit from LSB */
    int64_t stop = (int64_t)last * 8 + (7 - low);
    if (self->pos < stop) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static PyObject *BitReader_peek(BitReaderObject *self, PyObject *arg) {
    long n = PyLong_AsLong(arg);
    if (n == -1 && PyErr_Occurred()) return NULL;
    int64_t save = self->pos;
    uint64_t v;
    int rc = br_read_u(self, (int)n, &v);
    self->pos = save;
    if (rc < 0) return NULL;
    return PyLong_FromUnsignedLongLong(v);
}

static PyObject *BitReader_peek_pad(BitReaderObject *self, PyObject *arg) {
    long n = PyLong_AsLong(arg);
    if (n == -1 && PyErr_Occurred()) return NULL;
    int64_t avail = self->nbits - self->pos;
    if (avail >= n) return BitReader_peek(self, arg);
    if (avail <= 0) return PyLong_FromLong(0);
    int64_t save = self->pos;
    uint64_t v;
    int rc = br_read_u(self, (int)avail, &v);
    self->pos = save;
    if (rc < 0) return NULL;
    return PyLong_FromUnsignedLongLong(v << (n - avail));
}

static PyObject *BitReader_zeros_until_one(BitReaderObject *self,
                                           PyObject *args, PyObject *kwds) {
    long limit = 32;
    static const char *kwlist[] = {"limit", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|l", (char **)kwlist,
                                     &limit))
        return NULL;
    long n = 0;
    for (;;) {
        if (self->pos >= self->nbits) {
            PyErr_SetString(PyExc_EOFError, "bitreader overrun");
            return NULL;
        }
        if (br_flag_raw(self)) break;
        if (++n > limit) {
            PyErr_SetString(PyExc_ValueError,
                            "runaway zero run in bitstream");
            return NULL;
        }
    }
    return PyLong_FromLong(n);
}

static PyObject *BitReader_get_pos(BitReaderObject *self, void *closure) {
    return PyLong_FromLongLong(self->pos);
}

static int BitReader_set_pos(BitReaderObject *self, PyObject *value,
                             void *closure) {
    long long v = PyLong_AsLongLong(value);
    if (v == -1 && PyErr_Occurred()) return -1;
    self->pos = v;
    return 0;
}

static PyObject *BitReader_get_nbits(BitReaderObject *self, void *closure) {
    return PyLong_FromLongLong(self->nbits);
}

static PyObject *BitReader_get_data(BitReaderObject *self, void *closure) {
    /* the RBSP bytes (I_PCM samples, the native slice parser) */
    if (!self->bytes) return PyBytes_FromStringAndSize(NULL, 0);
    Py_INCREF(self->bytes);
    return self->bytes;
}

static PyMethodDef BitReader_methods[] = {
    {"u", (PyCFunction)BitReader_u, METH_O, "read n bits"},
    {"flag", (PyCFunction)BitReader_flag, METH_NOARGS, "read 1 bit"},
    {"ue", (PyCFunction)BitReader_ue, METH_NOARGS, "unsigned Exp-Golomb"},
    {"se", (PyCFunction)BitReader_se, METH_NOARGS, "signed Exp-Golomb"},
    {"te", (PyCFunction)BitReader_te, METH_O, "truncated Exp-Golomb"},
    {"byte_aligned", (PyCFunction)BitReader_byte_aligned, METH_NOARGS, ""},
    {"align", (PyCFunction)BitReader_align, METH_NOARGS, ""},
    {"bits_left", (PyCFunction)BitReader_bits_left, METH_NOARGS, ""},
    {"more_rbsp_data", (PyCFunction)BitReader_more_rbsp_data, METH_NOARGS,
     ""},
    {"peek", (PyCFunction)BitReader_peek, METH_O, ""},
    {"peek_pad", (PyCFunction)BitReader_peek_pad, METH_O, ""},
    {"zeros_until_one", (PyCFunction)BitReader_zeros_until_one,
     METH_VARARGS | METH_KEYWORDS, ""},
    {NULL}
};

static PyGetSetDef BitReader_getset[] = {
    {"pos", (getter)BitReader_get_pos, (setter)BitReader_set_pos, "", NULL},
    {"nbits", (getter)BitReader_get_nbits, NULL, "", NULL},
    {"data", (getter)BitReader_get_data, NULL, "", NULL},
    {NULL}
};

static PyTypeObject BitReaderType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "jm_torch_native.BitReader",     /* tp_name */
    sizeof(BitReaderObject),         /* tp_basicsize */
};

/* ------------------------------------------------------------------ */
/* CABAC engine                                                        */
/* ------------------------------------------------------------------ */

static uint8_t g_range_lps[64][4];
static uint8_t g_next_mps[64];
static uint8_t g_next_lps[64];
static int g_tables_ready = 0;

typedef struct {
    PyObject_HEAD
    BitReaderObject *br;   /* strong ref */
    int32_t rng;
    int32_t offset;
} CabacObject;

static void Cabac_dealloc(CabacObject *self) {
    Py_XDECREF(self->br);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int Cabac_init(CabacObject *self, PyObject *args, PyObject *kwds) {
    PyObject *br;
    if (!PyArg_ParseTuple(args, "O", &br)) return -1;
    if (!PyObject_TypeCheck(br, &BitReaderType)) {
        PyErr_SetString(PyExc_TypeError,
                        "CabacEngine requires a jm_torch_native.BitReader");
        return -1;
    }
    if (!g_tables_ready) {
        PyErr_SetString(PyExc_RuntimeError,
                        "set_cabac_tables() not called");
        return -1;
    }
    Py_INCREF(br);
    self->br = (BitReaderObject *)br;
    self->br->pos = (self->br->pos + 7) & ~7LL;
    uint64_t v;
    if (br_read_u(self->br, 9, &v) < 0) return -1;
    self->rng = 510;
    self->offset = (int32_t)v;
    return 0;
}

static inline int cb_flag(CabacObject *self) {
    BitReaderObject *b = self->br;
    if (b->pos >= b->nbits) {
        PyErr_SetString(PyExc_EOFError, "bitreader overrun");
        return -1;
    }
    return br_flag_raw(b);
}

/* ctx must be an int32 C-contiguous (..., 2) array; returns pointer to
 * element [idx] pair. Caller releases buf. */
static inline int32_t *ctx_pair(PyObject *ctx, Py_ssize_t idx,
                                Py_buffer *buf) {
    if (PyObject_GetBuffer(ctx, buf, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE |
                           PyBUF_FORMAT) < 0)
        return NULL;
    if (buf->itemsize != 4) {
        PyBuffer_Release(buf);
        PyErr_SetString(PyExc_TypeError, "ctx must be int32");
        return NULL;
    }
    Py_ssize_t n = buf->len / 8;   /* pairs */
    if (idx < 0 || idx >= n) {
        PyBuffer_Release(buf);
        PyErr_SetString(PyExc_IndexError, "ctx index out of range");
        return NULL;
    }
    return (int32_t *)buf->buf + 2 * idx;
}

static inline int cab_decision_raw(CabacObject *self, int32_t *pair) {
    int state = pair[0];
    int mps = pair[1];
    int q = (self->rng >> 6) & 3;
    int r_lps = g_range_lps[state][q];
    self->rng -= r_lps;
    int bit;
    if (self->offset >= self->rng) {
        bit = 1 - mps;
        self->offset -= self->rng;
        self->rng = r_lps;
        if (state == 0) pair[1] = 1 - mps;
        pair[0] = g_next_lps[state];
    } else {
        bit = mps;
        pair[0] = g_next_mps[state];
    }
    while (self->rng < 256) {
        self->rng <<= 1;
        int f = cb_flag(self);
        if (f < 0) return -1;
        self->offset = (self->offset << 1) | f;
    }
    return bit;
}

static inline int cab_bypass_raw(CabacObject *self) {
    int f = cb_flag(self);
    if (f < 0) return -1;
    self->offset = (self->offset << 1) | f;
    if (self->offset >= self->rng) {
        self->offset -= self->rng;
        return 1;
    }
    return 0;
}

static PyObject *Cabac_decision(CabacObject *self, PyObject *args) {
    PyObject *ctx;
    Py_ssize_t idx;
    if (!PyArg_ParseTuple(args, "On", &ctx, &idx)) return NULL;
    Py_buffer buf;
    int32_t *pair = ctx_pair(ctx, idx, &buf);
    if (!pair) return NULL;
    int bit = cab_decision_raw(self, pair);
    PyBuffer_Release(&buf);
    if (bit < 0) return NULL;
    return PyLong_FromLong(bit);
}

static PyObject *Cabac_bypass(CabacObject *self, PyObject *na) {
    int bit = cab_bypass_raw(self);
    if (bit < 0) return NULL;
    return PyLong_FromLong(bit);
}

static PyObject *Cabac_terminate(CabacObject *self, PyObject *na) {
    self->rng -= 2;
    if (self->offset >= self->rng) return PyLong_FromLong(1);
    while (self->rng < 256) {
        self->rng <<= 1;
        int f = cb_flag(self);
        if (f < 0) return NULL;
        self->offset = (self->offset << 1) | f;
    }
    return PyLong_FromLong(0);
}

static PyObject *Cabac_unary(CabacObject *self, PyObject *args) {
    PyObject *ctx;
    Py_ssize_t first_idx, rest_idx;
    if (!PyArg_ParseTuple(args, "Onn", &ctx, &first_idx, &rest_idx))
        return NULL;
    Py_buffer buf;
    int32_t *base = ctx_pair(ctx, 0, &buf);
    if (!base) return NULL;
    Py_ssize_t npairs = buf.len / 8;
    if (first_idx >= npairs || rest_idx >= npairs) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_IndexError, "ctx index out of range");
        return NULL;
    }
    int bit = cab_decision_raw(self, base + 2 * first_idx);
    if (bit < 0) { PyBuffer_Release(&buf); return NULL; }
    long n = 0;
    if (bit) {
        for (;;) {
            n += 1;
            bit = cab_decision_raw(self, base + 2 * rest_idx);
            if (bit < 0) { PyBuffer_Release(&buf); return NULL; }
            if (!bit) break;
        }
    }
    PyBuffer_Release(&buf);
    return PyLong_FromLong(n);
}

static PyObject *Cabac_unary_max(CabacObject *self, PyObject *args) {
    PyObject *ctx;
    Py_ssize_t first_idx, rest_idx;
    long max_symbol;
    if (!PyArg_ParseTuple(args, "Onnl", &ctx, &first_idx, &rest_idx,
                          &max_symbol))
        return NULL;
    Py_buffer buf;
    int32_t *base = ctx_pair(ctx, 0, &buf);
    if (!base) return NULL;
    Py_ssize_t npairs = buf.len / 8;
    if (first_idx >= npairs || rest_idx >= npairs) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_IndexError, "ctx index out of range");
        return NULL;
    }
    int sym = cab_decision_raw(self, base + 2 * first_idx);
    if (sym < 0) { PyBuffer_Release(&buf); return NULL; }
    if (sym == 0 || max_symbol == 0) {
        PyBuffer_Release(&buf);
        return PyLong_FromLong(sym);
    }
    long s = 0;
    int l;
    for (;;) {
        l = cab_decision_raw(self, base + 2 * rest_idx);
        if (l < 0) { PyBuffer_Release(&buf); return NULL; }
        s += 1;
        if (l == 0 || s >= max_symbol) break;
    }
    if (l != 0 && s == max_symbol) s += 1;
    PyBuffer_Release(&buf);
    return PyLong_FromLong(s);
}

static int cab_exp_golomb_raw(CabacObject *self, int k, long *out) {
    long sym = 0;
    for (;;) {
        int b = cab_bypass_raw(self);
        if (b < 0) return -1;
        if (!b) break;
        sym += 1L << k;
        k += 1;
    }
    long val = 0;
    while (k) {
        k -= 1;
        int b = cab_bypass_raw(self);
        if (b < 0) return -1;
        if (b) val |= 1L << k;
    }
    *out = sym + val;
    return 0;
}

static PyObject *Cabac_exp_golomb_eq_prob(CabacObject *self, PyObject *arg) {
    long k = PyLong_AsLong(arg);
    if (k == -1 && PyErr_Occurred()) return NULL;
    long v;
    if (cab_exp_golomb_raw(self, (int)k, &v) < 0) return NULL;
    return PyLong_FromLong(v);
}

static PyObject *Cabac_ueg0_level(CabacObject *self, PyObject *args) {
    PyObject *ctx;
    Py_ssize_t idx;
    if (!PyArg_ParseTuple(args, "On", &ctx, &idx)) return NULL;
    Py_buffer buf;
    int32_t *pair = ctx_pair(ctx, idx, &buf);
    if (!pair) return NULL;
    int bit = cab_decision_raw(self, pair);
    if (bit < 0) { PyBuffer_Release(&buf); return NULL; }
    if (!bit) { PyBuffer_Release(&buf); return PyLong_FromLong(0); }
    long sym = 0;
    int k = 1, l;
    for (;;) {
        l = cab_decision_raw(self, pair);
        if (l < 0) { PyBuffer_Release(&buf); return NULL; }
        sym += 1;
        k += 1;
        if (l == 0 || k == 13) break;
    }
    PyBuffer_Release(&buf);
    if (l != 0) {
        long t;
        if (cab_exp_golomb_raw(self, 0, &t) < 0) return NULL;
        sym += t + 1;
    }
    return PyLong_FromLong(sym);
}

static PyObject *Cabac_ueg3_mv(CabacObject *self, PyObject *args,
                               PyObject *kwds) {
    PyObject *ctx;
    Py_ssize_t base_idx;
    long max_bin = 3;
    static const char *kwlist[] = {"ctx", "base_idx", "max_bin", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "On|l", (char **)kwlist,
                                     &ctx, &base_idx, &max_bin))
        return NULL;
    Py_buffer buf;
    int32_t *base = ctx_pair(ctx, 0, &buf);
    if (!base) return NULL;
    Py_ssize_t npairs = buf.len / 8;
    if (base_idx + 3 >= npairs + 1) { /* up to base_idx+? guarded below */ }
    int bit = cab_decision_raw(self, base + 2 * base_idx);
    if (bit < 0) { PyBuffer_Release(&buf); return NULL; }
    if (!bit) { PyBuffer_Release(&buf); return PyLong_FromLong(0); }
    Py_ssize_t idx = base_idx + 1;
    long sym = 0;
    int k = 1, binno = 1, l;
    for (;;) {
        if (idx >= npairs) {
            PyBuffer_Release(&buf);
            PyErr_SetString(PyExc_IndexError, "ctx index out of range");
            return NULL;
        }
        l = cab_decision_raw(self, base + 2 * idx);
        if (l < 0) { PyBuffer_Release(&buf); return NULL; }
        binno += 1;
        if (binno == 2) idx += 1;
        if (binno == max_bin) idx += 1;
        sym += 1;
        k += 1;
        if (l == 0 || k == 8) break;
    }
    PyBuffer_Release(&buf);
    if (l != 0) {
        long t;
        if (cab_exp_golomb_raw(self, 3, &t) < 0) return NULL;
        sym += t + 1;
    }
    return PyLong_FromLong(sym);
}

static PyObject *Cabac_get_rng(CabacObject *self, void *c) {
    return PyLong_FromLong(self->rng);
}
static PyObject *Cabac_get_offset(CabacObject *self, void *c) {
    return PyLong_FromLong(self->offset);
}
static PyObject *Cabac_get_br(CabacObject *self, void *c) {
    Py_INCREF(self->br);
    return (PyObject *)self->br;
}

static PyMethodDef Cabac_methods[] = {
    {"decision", (PyCFunction)Cabac_decision, METH_VARARGS, ""},
    {"bypass", (PyCFunction)Cabac_bypass, METH_NOARGS, ""},
    {"terminate", (PyCFunction)Cabac_terminate, METH_NOARGS, ""},
    {"unary", (PyCFunction)Cabac_unary, METH_VARARGS, ""},
    {"unary_max", (PyCFunction)Cabac_unary_max, METH_VARARGS, ""},
    {"exp_golomb_eq_prob", (PyCFunction)Cabac_exp_golomb_eq_prob, METH_O,
     ""},
    {"ueg0_level", (PyCFunction)Cabac_ueg0_level, METH_VARARGS, ""},
    {"ueg3_mv", (PyCFunction)Cabac_ueg3_mv, METH_VARARGS | METH_KEYWORDS,
     ""},
    {NULL}
};

static PyGetSetDef Cabac_getset[] = {
    {"rng", (getter)Cabac_get_rng, NULL, "", NULL},
    {"offset", (getter)Cabac_get_offset, NULL, "", NULL},
    {"br", (getter)Cabac_get_br, NULL, "", NULL},
    {NULL}
};

static PyTypeObject CabacType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "jm_torch_native.CabacEngine",
    sizeof(CabacObject),
};

/* ------------------------------------------------------------------ */
/* module functions                                                    */
/* ------------------------------------------------------------------ */

static PyObject *m_set_cabac_tables(PyObject *mod, PyObject *args) {
    PyObject *rlps, *nmps, *nlps;
    if (!PyArg_ParseTuple(args, "OOO", &rlps, &nmps, &nlps)) return NULL;
    Py_buffer b1, b2, b3;
    if (PyObject_GetBuffer(rlps, &b1, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (PyObject_GetBuffer(nmps, &b2, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&b1); return NULL;
    }
    if (PyObject_GetBuffer(nlps, &b3, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&b1); PyBuffer_Release(&b2); return NULL;
    }
    if (b1.len != 64 * 4 * b1.itemsize || b2.len != 64 * b2.itemsize ||
        b3.len != 64 * b3.itemsize) {
        PyErr_SetString(PyExc_ValueError, "bad table shapes");
        PyBuffer_Release(&b1); PyBuffer_Release(&b2); PyBuffer_Release(&b3);
        return NULL;
    }
#define LOADT(dst, BB, count) do { \
    for (int i = 0; i < (count); i++) { \
        long v; \
        switch ((BB).itemsize) { \
        case 1: v = ((uint8_t *)(BB).buf)[i]; break; \
        case 2: v = ((int16_t *)(BB).buf)[i]; break; \
        case 4: v = ((int32_t *)(BB).buf)[i]; break; \
        default: v = ((int64_t *)(BB).buf)[i]; break; } \
        (dst)[i] = (uint8_t)v; } } while (0)
    LOADT(&g_range_lps[0][0], b1, 256);
    LOADT(g_next_mps, b2, 64);
    LOADT(g_next_lps, b3, 64);
#undef LOADT
    PyBuffer_Release(&b1); PyBuffer_Release(&b2); PyBuffer_Release(&b3);
    g_tables_ready = 1;
    Py_RETURN_NONE;
}

static PyObject *m_ebsp_to_rbsp(PyObject *mod, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    const uint8_t *src = (const uint8_t *)view.buf;
    Py_ssize_t n = view.len;
    PyObject *out = PyBytes_FromStringAndSize(NULL, n);
    if (!out) { PyBuffer_Release(&view); return NULL; }
    uint8_t *dst = (uint8_t *)PyBytes_AS_STRING(out);
    Py_ssize_t o = 0;
    int zeros = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        uint8_t b = src[i];
        if (zeros >= 2 && b == 3) {
            zeros = 0;            /* drop emulation prevention byte */
            continue;
        }
        dst[o++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    PyBuffer_Release(&view);
    if (o != n) _PyBytes_Resize(&out, o);
    return out;
}

static PyObject *m_rbsp_to_ebsp(PyObject *mod, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    const uint8_t *src = (const uint8_t *)view.buf;
    Py_ssize_t n = view.len;
    PyObject *out = PyBytes_FromStringAndSize(NULL, n + n / 2 + 4);
    if (!out) { PyBuffer_Release(&view); return NULL; }
    uint8_t *dst = (uint8_t *)PyBytes_AS_STRING(out);
    Py_ssize_t o = 0;
    int zeros = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        uint8_t b = src[i];
        if (zeros >= 2 && b <= 3) {
            dst[o++] = 3;
            zeros = 0;
        }
        dst[o++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    PyBuffer_Release(&view);
    _PyBytes_Resize(&out, o);
    return out;
}

static PyMethodDef module_methods[] = {
    {"set_cabac_tables", m_set_cabac_tables, METH_VARARGS,
     "install RANGE_LPS / NEXT_STATE tables"},
    {"ebsp_to_rbsp", m_ebsp_to_rbsp, METH_O, "strip emulation prevention"},
    {"rbsp_to_ebsp", m_rbsp_to_ebsp, METH_O, "insert emulation prevention"},
    {NULL}
};

static struct PyModuleDef jm_torch_native_module = {
    PyModuleDef_HEAD_INIT, "jm_torch_native",
    "host C++ runtime of jm_tpu_torch", -1, module_methods,
};

extern "C" int register_jm_torch_enc(PyObject *module);
extern "C" int register_jm_torch_dec(PyObject *module);

PyMODINIT_FUNC PyInit_jm_torch_native(void) {
    BitReaderType.tp_dealloc = (destructor)BitReader_dealloc;
    BitReaderType.tp_flags = Py_TPFLAGS_DEFAULT;
    BitReaderType.tp_methods = BitReader_methods;
    BitReaderType.tp_getset = BitReader_getset;
    BitReaderType.tp_init = (initproc)BitReader_init;
    BitReaderType.tp_new = PyType_GenericNew;
    if (PyType_Ready(&BitReaderType) < 0) return NULL;

    CabacType.tp_dealloc = (destructor)Cabac_dealloc;
    CabacType.tp_flags = Py_TPFLAGS_DEFAULT;
    CabacType.tp_methods = Cabac_methods;
    CabacType.tp_getset = Cabac_getset;
    CabacType.tp_init = (initproc)Cabac_init;
    CabacType.tp_new = PyType_GenericNew;
    if (PyType_Ready(&CabacType) < 0) return NULL;

    PyObject *m = PyModule_Create(&jm_torch_native_module);
    if (!m) return NULL;
    Py_INCREF(&BitReaderType);
    PyModule_AddObject(m, "BitReader", (PyObject *)&BitReaderType);
    Py_INCREF(&CabacType);
    PyModule_AddObject(m, "CabacEngine", (PyObject *)&CabacType);
    if (register_jm_torch_enc(m) < 0) { Py_DECREF(m); return NULL; }
    if (register_jm_torch_dec(m) < 0) { Py_DECREF(m); return NULL; }
    return m;
}
