/* Native msgpack codec — the record-value hot path.
 *
 * C implementation of zeebe_tpu/protocol/msgpack.py (that module is the
 * specification; tests assert byte-equality between the two). The reference
 * keeps its record codec native for the same reason (zero-alloc MsgPackWriter/
 * MsgPackReader over Agrona buffers, msgpack-core/src/main/java/io/camunda/
 * zeebe/msgpack/spec/): every record append, replay, export, and transport
 * frame round-trips through it.
 *
 * Exposes packb(obj) -> bytes and unpackb(buffer) -> obj, raising the
 * exception class registered via set_error_class (MsgPackError) on malformed
 * input — same contract as the Python module.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static PyObject *error_class = NULL; /* MsgPackError, set from Python */

static PyObject *codec_error(const char *fmt, ...)
{
    char buf[256];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    PyErr_SetString(error_class ? error_class : PyExc_ValueError, buf);
    return NULL;
}

/* ---------------------------------------------------------------- writer */

typedef struct {
    uint8_t *data;
    Py_ssize_t len;
    Py_ssize_t cap;
} Writer;

static int writer_grow(Writer *w, Py_ssize_t need)
{
    Py_ssize_t cap = w->cap ? w->cap : 256;
    while (cap < w->len + need)
        cap *= 2;
    uint8_t *p = PyMem_Realloc(w->data, cap);
    if (!p) {
        PyErr_NoMemory();
        return -1;
    }
    w->data = p;
    w->cap = cap;
    return 0;
}

static inline int put(Writer *w, const void *src, Py_ssize_t n)
{
    if (w->len + n > w->cap && writer_grow(w, n) < 0)
        return -1;
    memcpy(w->data + w->len, src, n);
    w->len += n;
    return 0;
}

static inline int put1(Writer *w, uint8_t b) { return put(w, &b, 1); }

static inline int put_be16(Writer *w, uint16_t v)
{
    uint8_t b[2] = {(uint8_t)(v >> 8), (uint8_t)v};
    return put(w, b, 2);
}

static inline int put_be32(Writer *w, uint32_t v)
{
    uint8_t b[4] = {(uint8_t)(v >> 24), (uint8_t)(v >> 16), (uint8_t)(v >> 8), (uint8_t)v};
    return put(w, b, 4);
}

static inline int put_be64(Writer *w, uint64_t v)
{
    uint8_t b[8];
    for (int i = 0; i < 8; i++)
        b[i] = (uint8_t)(v >> (56 - 8 * i));
    return put(w, b, 8);
}

static int pack_obj(Writer *w, PyObject *obj, int depth);
static int pack_ll(Writer *w, long long v);

static int pack_long(Writer *w, PyObject *obj)
{
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow > 0) {
        unsigned long long u = PyLong_AsUnsignedLongLong(obj);
        if (u == (unsigned long long)-1 && PyErr_Occurred()) {
            PyErr_Clear();
            codec_error("int too large");
            return -1;
        }
        return put1(w, 0xCF) < 0 || put_be64(w, u) < 0 ? -1 : 0;
    }
    if (overflow < 0) {
        codec_error("int too small");
        return -1;
    }
    if (v == -1 && PyErr_Occurred())
        return -1;
    return pack_ll(w, v);
}

static int pack_ll(Writer *w, long long v)
{
    if (v >= 0) {
        if (v < 0x80)
            return put1(w, (uint8_t)v);
        if (v < 0x100)
            return put1(w, 0xCC) < 0 || put1(w, (uint8_t)v) < 0 ? -1 : 0;
        if (v < 0x10000)
            return put1(w, 0xCD) < 0 || put_be16(w, (uint16_t)v) < 0 ? -1 : 0;
        if (v < 0x100000000LL)
            return put1(w, 0xCE) < 0 || put_be32(w, (uint32_t)v) < 0 ? -1 : 0;
        return put1(w, 0xCF) < 0 || put_be64(w, (uint64_t)v) < 0 ? -1 : 0;
    }
    if (v >= -32)
        return put1(w, (uint8_t)(v & 0xFF));
    if (v >= -0x80)
        return put1(w, 0xD0) < 0 || put1(w, (uint8_t)(int8_t)v) < 0 ? -1 : 0;
    if (v >= -0x8000)
        return put1(w, 0xD1) < 0 || put_be16(w, (uint16_t)(int16_t)v) < 0 ? -1 : 0;
    if (v >= -0x80000000LL)
        return put1(w, 0xD2) < 0 || put_be32(w, (uint32_t)(int32_t)v) < 0 ? -1 : 0;
    return put1(w, 0xD3) < 0 || put_be64(w, (uint64_t)v) < 0 ? -1 : 0;
}

static int pack_str(Writer *w, PyObject *obj)
{
    Py_ssize_t n;
    const char *raw = PyUnicode_AsUTF8AndSize(obj, &n);
    if (!raw)
        return -1;
    if (n < 32) {
        if (put1(w, (uint8_t)(0xA0 | n)) < 0)
            return -1;
    } else if (n < 0x100) {
        if (put1(w, 0xD9) < 0 || put1(w, (uint8_t)n) < 0)
            return -1;
    } else if (n < 0x10000) {
        if (put1(w, 0xDA) < 0 || put_be16(w, (uint16_t)n) < 0)
            return -1;
    } else {
        if (put1(w, 0xDB) < 0 || put_be32(w, (uint32_t)n) < 0)
            return -1;
    }
    return put(w, raw, n);
}

static int pack_bin(Writer *w, const uint8_t *raw, Py_ssize_t n)
{
    if (n < 0x100) {
        if (put1(w, 0xC4) < 0 || put1(w, (uint8_t)n) < 0)
            return -1;
    } else if (n < 0x10000) {
        if (put1(w, 0xC5) < 0 || put_be16(w, (uint16_t)n) < 0)
            return -1;
    } else {
        if (put1(w, 0xC6) < 0 || put_be32(w, (uint32_t)n) < 0)
            return -1;
    }
    return put(w, raw, n);
}

#define MAX_DEPTH 256

static int pack_obj(Writer *w, PyObject *obj, int depth)
{
    if (depth > MAX_DEPTH) {
        codec_error("msgpack nesting exceeds %d", MAX_DEPTH);
        return -1;
    }
    if (obj == Py_None)
        return put1(w, 0xC0);
    if (obj == Py_True)
        return put1(w, 0xC3);
    if (obj == Py_False)
        return put1(w, 0xC2);
    if (PyLong_Check(obj))
        return pack_long(w, obj);
    if (PyFloat_Check(obj)) {
        double d = PyFloat_AS_DOUBLE(obj);
        uint64_t bits;
        memcpy(&bits, &d, 8);
        return put1(w, 0xCB) < 0 || put_be64(w, bits) < 0 ? -1 : 0;
    }
    if (PyUnicode_Check(obj))
        return pack_str(w, obj);
    if (PyBytes_Check(obj))
        return pack_bin(w, (const uint8_t *)PyBytes_AS_STRING(obj), PyBytes_GET_SIZE(obj));
    if (PyByteArray_Check(obj))
        return pack_bin(w, (const uint8_t *)PyByteArray_AS_STRING(obj), PyByteArray_GET_SIZE(obj));
    if (PyMemoryView_Check(obj)) {
        Py_buffer *view = PyMemoryView_GET_BUFFER(obj);
        if (!PyBuffer_IsContiguous(view, 'C')) {
            codec_error("cannot msgpack non-contiguous memoryview");
            return -1;
        }
        return pack_bin(w, (const uint8_t *)view->buf, view->len);
    }
    if (PyList_Check(obj) || PyTuple_Check(obj)) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
        if (n < 16) {
            if (put1(w, (uint8_t)(0x90 | n)) < 0)
                return -1;
        } else if (n < 0x10000) {
            if (put1(w, 0xDC) < 0 || put_be16(w, (uint16_t)n) < 0)
                return -1;
        } else {
            if (put1(w, 0xDD) < 0 || put_be32(w, (uint32_t)n) < 0)
                return -1;
        }
        for (Py_ssize_t i = 0; i < n; i++)
            if (pack_obj(w, PySequence_Fast_GET_ITEM(obj, i), depth + 1) < 0)
                return -1;
        return 0;
    }
    if (PyDict_Check(obj)) {
        Py_ssize_t n = PyDict_GET_SIZE(obj);
        if (n < 16) {
            if (put1(w, (uint8_t)(0x80 | n)) < 0)
                return -1;
        } else if (n < 0x10000) {
            if (put1(w, 0xDE) < 0 || put_be16(w, (uint16_t)n) < 0)
                return -1;
        } else {
            if (put1(w, 0xDF) < 0 || put_be32(w, (uint32_t)n) < 0)
                return -1;
        }
        PyObject *key, *value;
        Py_ssize_t pos = 0;
        while (PyDict_Next(obj, &pos, &key, &value)) {
            if (pack_obj(w, key, depth + 1) < 0)
                return -1;
            if (pack_obj(w, value, depth + 1) < 0)
                return -1;
        }
        return 0;
    }
    codec_error("cannot msgpack type %s", Py_TYPE(obj)->tp_name);
    return -1;
}

static PyObject *codec_packb(PyObject *self, PyObject *obj)
{
    Writer w = {NULL, 0, 0};
    if (pack_obj(&w, obj, 0) < 0) {
        PyMem_Free(w.data);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)w.data, w.len);
    PyMem_Free(w.data);
    return out;
}

/* ---------------------------------------------------------------- reader */

typedef struct {
    const uint8_t *data;
    Py_ssize_t len;
    Py_ssize_t pos;
} Reader;

static PyObject *read_obj(Reader *r, int depth);

static inline int take(Reader *r, Py_ssize_t n, const uint8_t **out)
{
    if (r->pos + n > r->len) {
        codec_error("truncated msgpack data");
        return -1;
    }
    *out = r->data + r->pos;
    r->pos += n;
    return 0;
}

static inline int read_be(Reader *r, int n, uint64_t *out)
{
    const uint8_t *p;
    if (take(r, n, &p) < 0)
        return -1;
    uint64_t v = 0;
    for (int i = 0; i < n; i++)
        v = (v << 8) | p[i];
    *out = v;
    return 0;
}

static PyObject *read_str(Reader *r, Py_ssize_t n)
{
    const uint8_t *p;
    if (take(r, n, &p) < 0)
        return NULL;
    PyObject *s = PyUnicode_DecodeUTF8((const char *)p, n, NULL);
    if (!s && PyErr_ExceptionMatches(PyExc_UnicodeDecodeError)) {
        PyErr_Clear();
        codec_error("malformed msgpack data: invalid utf-8");
    }
    return s;
}

static PyObject *read_bin(Reader *r, Py_ssize_t n)
{
    const uint8_t *p;
    if (take(r, n, &p) < 0)
        return NULL;
    return PyBytes_FromStringAndSize((const char *)p, n);
}

static PyObject *read_array(Reader *r, Py_ssize_t n, int depth)
{
    /* every element needs >= 1 byte: reject corrupt lengths before the
     * allocation so malformed frames raise MsgPackError, not MemoryError */
    if (n > r->len - r->pos)
        return codec_error("truncated msgpack data");
    PyObject *list = PyList_New(n);
    if (!list)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = read_obj(r, depth);
        if (!item) {
            Py_DECREF(list);
            return NULL;
        }
        PyList_SET_ITEM(list, i, item);
    }
    return list;
}

static PyObject *read_map(Reader *r, Py_ssize_t n, int depth)
{
    if (n > (r->len - r->pos) / 2) /* each entry needs >= 2 bytes */
        return codec_error("truncated msgpack data");
    PyObject *dict = PyDict_New();
    if (!dict)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = read_obj(r, depth);
        if (!key) {
            Py_DECREF(dict);
            return NULL;
        }
        PyObject *value = read_obj(r, depth);
        if (!value) {
            Py_DECREF(key);
            Py_DECREF(dict);
            return NULL;
        }
        int rc = PyDict_SetItem(dict, key, value);
        Py_DECREF(key);
        Py_DECREF(value);
        if (rc < 0) {
            Py_DECREF(dict);
            if (PyErr_ExceptionMatches(PyExc_TypeError)) { /* unhashable key */
                PyErr_Clear();
                return codec_error("malformed msgpack data: unhashable map key");
            }
            return NULL;
        }
    }
    return dict;
}

static PyObject *read_obj(Reader *r, int depth)
{
    const uint8_t *p;
    uint64_t u;
    /* depth = number of enclosing containers; checked at value-read entry to
     * mirror the pure-Python _Reader.read() exactly (a container at the limit
     * still decodes if it has no children) */
    if (depth > MAX_DEPTH)
        return codec_error("msgpack nesting exceeds %d", MAX_DEPTH);
    if (take(r, 1, &p) < 0)
        return NULL;
    uint8_t b = *p;
    if (b < 0x80)
        return PyLong_FromLong(b);
    if (b >= 0xE0)
        return PyLong_FromLong((long)b - 0x100);
    if (b <= 0x8F)
        return read_map(r, b & 0x0F, depth + 1);
    if (b <= 0x9F)
        return read_array(r, b & 0x0F, depth + 1);
    if (b <= 0xBF)
        return read_str(r, b & 0x1F);
    switch (b) {
    case 0xC0:
        Py_RETURN_NONE;
    case 0xC2:
        Py_RETURN_FALSE;
    case 0xC3:
        Py_RETURN_TRUE;
    case 0xC4:
        if (read_be(r, 1, &u) < 0)
            return NULL;
        return read_bin(r, (Py_ssize_t)u);
    case 0xC5:
        if (read_be(r, 2, &u) < 0)
            return NULL;
        return read_bin(r, (Py_ssize_t)u);
    case 0xC6:
        if (read_be(r, 4, &u) < 0)
            return NULL;
        return read_bin(r, (Py_ssize_t)u);
    case 0xCA: {
        if (read_be(r, 4, &u) < 0)
            return NULL;
        uint32_t bits = (uint32_t)u;
        float f;
        memcpy(&f, &bits, 4);
        return PyFloat_FromDouble((double)f);
    }
    case 0xCB: {
        if (read_be(r, 8, &u) < 0)
            return NULL;
        double d;
        memcpy(&d, &u, 8);
        return PyFloat_FromDouble(d);
    }
    case 0xCC:
        if (read_be(r, 1, &u) < 0)
            return NULL;
        return PyLong_FromUnsignedLongLong(u);
    case 0xCD:
        if (read_be(r, 2, &u) < 0)
            return NULL;
        return PyLong_FromUnsignedLongLong(u);
    case 0xCE:
        if (read_be(r, 4, &u) < 0)
            return NULL;
        return PyLong_FromUnsignedLongLong(u);
    case 0xCF:
        if (read_be(r, 8, &u) < 0)
            return NULL;
        return PyLong_FromUnsignedLongLong(u);
    case 0xD0:
        if (read_be(r, 1, &u) < 0)
            return NULL;
        return PyLong_FromLong((int8_t)u);
    case 0xD1:
        if (read_be(r, 2, &u) < 0)
            return NULL;
        return PyLong_FromLong((int16_t)u);
    case 0xD2:
        if (read_be(r, 4, &u) < 0)
            return NULL;
        return PyLong_FromLong((int32_t)u);
    case 0xD3:
        if (read_be(r, 8, &u) < 0)
            return NULL;
        return PyLong_FromLongLong((int64_t)u);
    case 0xD9:
        if (read_be(r, 1, &u) < 0)
            return NULL;
        return read_str(r, (Py_ssize_t)u);
    case 0xDA:
        if (read_be(r, 2, &u) < 0)
            return NULL;
        return read_str(r, (Py_ssize_t)u);
    case 0xDB:
        if (read_be(r, 4, &u) < 0)
            return NULL;
        return read_str(r, (Py_ssize_t)u);
    case 0xDC:
        if (read_be(r, 2, &u) < 0)
            return NULL;
        return read_array(r, (Py_ssize_t)u, depth + 1);
    case 0xDD:
        if (read_be(r, 4, &u) < 0)
            return NULL;
        return read_array(r, (Py_ssize_t)u, depth + 1);
    case 0xDE:
        if (read_be(r, 2, &u) < 0)
            return NULL;
        return read_map(r, (Py_ssize_t)u, depth + 1);
    case 0xDF:
        if (read_be(r, 4, &u) < 0)
            return NULL;
        return read_map(r, (Py_ssize_t)u, depth + 1);
    default:
        return codec_error("unsupported msgpack byte 0x%02x", b);
    }
}

static PyObject *codec_unpackb(PyObject *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    Reader r = {(const uint8_t *)view.buf, view.len, 0};
    PyObject *obj = read_obj(&r, 0);
    if (obj && r.pos != r.len) {
        Py_DECREF(obj);
        obj = codec_error("trailing bytes after msgpack value: %zd", r.len - r.pos);
    }
    PyBuffer_Release(&view);
    return obj;
}

static PyObject *codec_set_error_class(PyObject *self, PyObject *cls)
{
    Py_XINCREF(cls);
    Py_XDECREF(error_class);
    error_class = cls;
    Py_RETURN_NONE;
}

/* Record wire frame (protocol/record.py _HEADER, little endian):
 *   u8 recordType | u8 valueType | u8 intent | u8 rejectionType
 *   i64 key | i64 sourceRecordPosition | i64 timestamp
 *   i32 requestStreamId | i64 requestId | i64 operationReference
 *   u16 rejectionReasonLen | reason utf-8 | u32 valueLen | value msgpack
 * decode_record_frame(data) -> 12-tuple mirroring that order with the
 * reason as str and the value as the decoded msgpack object — one C call
 * replaces struct.unpack_from + two slices + a separate unpackb on the
 * log-scan hot path. */
#define FRAME_HEADER_SIZE (4 + 8 * 3 + 4 + 8 * 2 + 2)

static int64_t rd_i64(const uint8_t *p) { int64_t v; memcpy(&v, p, 8); return v; }
static int32_t rd_i32(const uint8_t *p) { int32_t v; memcpy(&v, p, 4); return v; }

static PyObject *codec_decode_record_frame(PyObject *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    const uint8_t *p = (const uint8_t *)view.buf;
    Py_ssize_t len = view.len;
    PyObject *out = NULL, *reason = NULL, *value = NULL;
    if (len < FRAME_HEADER_SIZE) {
        codec_error("record frame truncated: %zd bytes", len);
        goto done;
    }
    unsigned record_type = p[0], value_type = p[1], intent = p[2], rejection = p[3];
    int64_t key = rd_i64(p + 4);
    int64_t source_pos = rd_i64(p + 12);
    int64_t timestamp = rd_i64(p + 20);
    int32_t request_stream_id = rd_i32(p + 28);
    int64_t request_id = rd_i64(p + 32);
    int64_t operation_reference = rd_i64(p + 40);
    unsigned reason_len = (unsigned)p[48] | ((unsigned)p[49] << 8);
    Py_ssize_t off = FRAME_HEADER_SIZE;
    if (off + (Py_ssize_t)reason_len + 4 > len) {
        codec_error("record frame truncated in reason/value length");
        goto done;
    }
    reason = PyUnicode_DecodeUTF8((const char *)p + off, reason_len, NULL);
    if (!reason)
        goto done;
    off += reason_len;
    uint32_t value_len = (uint32_t)p[off] | ((uint32_t)p[off + 1] << 8)
        | ((uint32_t)p[off + 2] << 16) | ((uint32_t)p[off + 3] << 24);
    off += 4;
    if (off + (Py_ssize_t)value_len != len) {
        codec_error("record frame length mismatch: header says %zd, got %zd",
                    off + (Py_ssize_t)value_len, len);
        goto done;
    }
    Reader r = {p + off, (Py_ssize_t)value_len, 0};
    value = read_obj(&r, 0);
    if (!value)
        goto done;
    if (r.pos != r.len) {
        codec_error("trailing bytes after record value: %zd", r.len - r.pos);
        goto done;
    }
    out = PyTuple_New(12);
    if (!out)
        goto done;
    {
        PyObject *items[12];
        items[0] = PyLong_FromUnsignedLong(record_type);
        items[1] = PyLong_FromUnsignedLong(value_type);
        items[2] = PyLong_FromUnsignedLong(intent);
        items[3] = PyLong_FromUnsignedLong(rejection);
        items[4] = PyLong_FromLongLong(key);
        items[5] = PyLong_FromLongLong(source_pos);
        items[6] = PyLong_FromLongLong(timestamp);
        items[7] = PyLong_FromLong(request_stream_id);
        items[8] = PyLong_FromLongLong(request_id);
        items[9] = PyLong_FromLongLong(operation_reference);
        items[10] = reason;
        items[11] = value;
        for (int i = 0; i < 12; i++) {
            if (!items[i]) { /* an int alloc failed: free the rest */
                for (int j = 0; j < 12; j++)
                    if (j != 10 && j != 11)
                        Py_XDECREF(items[j]);
                Py_CLEAR(out);
                goto done;
            }
        }
        for (int i = 0; i < 12; i++)
            PyTuple_SET_ITEM(out, i, items[i]);
        /* the tuple now owns reason/value */
        reason = NULL;
        value = NULL;
    }
done:
    Py_XDECREF(reason);
    Py_XDECREF(value);
    PyBuffer_Release(&view);
    return out;
}

static void wr_i64(uint8_t *p, int64_t v) { memcpy(p, &v, 8); }
static void wr_i32(uint8_t *p, int32_t v) { memcpy(p, &v, 4); }

/* encode_record_frame(record_type, value_type, intent, rejection_type,
 *     key, source_position, timestamp, request_stream_id, request_id,
 *     operation_reference, reason, value) -> (frame, value_body)
 * One-pass encode mirror of decode_record_frame above. protocol/record.py
 * Record.encode is the specification (tests assert byte-equality): fixed
 * little-endian header, rejection reason truncated to u16 bytes on a
 * codepoint boundary, u32 body length, msgpack body. The body bytes are
 * returned separately so the append path can seed its decode cache
 * without re-packing the value. */
static PyObject *codec_encode_record_frame(PyObject *self, PyObject *args)
{
    int record_type, value_type, intent, rejection, request_stream_id;
    long long key, source_pos, timestamp, request_id, operation_reference;
    PyObject *reason_obj, *value;
    if (!PyArg_ParseTuple(args, "iiiiLLLiLLUO",
                          &record_type, &value_type, &intent, &rejection,
                          &key, &source_pos, &timestamp, &request_stream_id,
                          &request_id, &operation_reference,
                          &reason_obj, &value))
        return NULL;
    if ((unsigned)record_type > 0xFF || (unsigned)value_type > 0xFF
        || (unsigned)intent > 0xFF || (unsigned)rejection > 0xFF)
        return codec_error("record header byte field out of range");
    Py_ssize_t rlen;
    const char *reason = PyUnicode_AsUTF8AndSize(reason_obj, &rlen);
    if (!reason)
        return NULL;
    if (rlen > 0xFFFF) {
        /* the wire field is u16; truncate on a codepoint boundary so an
         * oversized error message can never poison the append path (same
         * continuation/lead-byte walk as Record.encode) */
        rlen = 0xFFFF;
        while (rlen && ((unsigned char)reason[rlen - 1] & 0xC0) == 0x80)
            rlen--;
        if (rlen && (unsigned char)reason[rlen - 1] >= 0xC0)
            rlen--;
    }
    uint8_t hdr[FRAME_HEADER_SIZE];
    hdr[0] = (uint8_t)record_type;
    hdr[1] = (uint8_t)value_type;
    hdr[2] = (uint8_t)intent;
    hdr[3] = (uint8_t)rejection;
    wr_i64(hdr + 4, key);
    wr_i64(hdr + 12, source_pos);
    wr_i64(hdr + 20, timestamp);
    wr_i32(hdr + 28, request_stream_id);
    wr_i64(hdr + 32, request_id);
    wr_i64(hdr + 40, operation_reference);
    hdr[48] = (uint8_t)(rlen & 0xFF);
    hdr[49] = (uint8_t)(rlen >> 8);
    Writer w = {NULL, 0, 0};
    static const uint8_t zero4[4] = {0, 0, 0, 0};
    if (put(&w, hdr, FRAME_HEADER_SIZE) < 0 || put(&w, reason, rlen) < 0
        || put(&w, zero4, 4) < 0)
        goto fail;
    Py_ssize_t body_off = w.len;
    if (pack_obj(&w, value, 0) < 0)
        goto fail;
    Py_ssize_t body_len = w.len - body_off;
    if (body_len > 0xFFFFFFFFLL) {
        codec_error("record value too large: %zd bytes", body_len);
        goto fail;
    }
    wr_i32(w.data + body_off - 4, (int32_t)(uint32_t)body_len);
    {
        PyObject *frame = PyBytes_FromStringAndSize((const char *)w.data, w.len);
        PyObject *body = PyBytes_FromStringAndSize(
            (const char *)w.data + body_off, body_len);
        PyMem_Free(w.data);
        if (!frame || !body) {
            Py_XDECREF(frame);
            Py_XDECREF(body);
            return NULL;
        }
        return Py_BuildValue("(NN)", frame, body);
    }
fail:
    PyMem_Free(w.data);
    return NULL;
}

/* Sequenced-batch header scan (logstreams/log_stream.py framing):
 *   batch header:  u32 count | i64 sourcePosition | u64 timestamp
 *   per entry:     u8 processed | i64 position | u32 recordLen | frame
 * scan_batch_headers(payload) -> (source_position, timestamp,
 *   [(processed, position, record_type, value_type, intent, key,
 *     frame_off, frame_len), ...])
 * Only the fixed frame prefix is touched — rejection reason and msgpack
 * value stay raw bytes, so a filtering scan (job discovery, command scan,
 * export filters) pays nothing for records it skips. */
#define BATCH_HEADER_SIZE (4 + 8 + 8)
#define ENTRY_HEADER_SIZE (1 + 8 + 4)

/* shared worker: want_rt/want_vt/want_intent of -1 match anything (the
 * unfiltered entry point passes -1,-1,-1 and preallocates the list) */
static PyObject *scan_batch_headers_impl(PyObject *arg, int want_rt,
                                         int want_vt, int want_intent)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    const uint8_t *p = (const uint8_t *)view.buf;
    Py_ssize_t len = view.len;
    int filtered = want_rt >= 0 || want_vt >= 0 || want_intent >= 0;
    PyObject *out = NULL, *records = NULL;
    if (len < BATCH_HEADER_SIZE) {
        codec_error("batch payload truncated: %zd bytes", len);
        goto done;
    }
    uint32_t count = (uint32_t)rd_i32(p);
    int64_t source_position = rd_i64(p + 4);
    int64_t timestamp = rd_i64(p + 12);
    /* a corrupted count must not drive a huge allocation: every entry needs
     * at least its header, so this bound holds for any valid payload */
    if ((Py_ssize_t)count > (len - BATCH_HEADER_SIZE) / ENTRY_HEADER_SIZE) {
        codec_error("batch count %u impossible for %zd-byte payload", count, len);
        goto done;
    }
    records = filtered ? PyList_New(0) : PyList_New((Py_ssize_t)count);
    if (!records)
        goto done;
    Py_ssize_t off = BATCH_HEADER_SIZE;
    for (uint32_t i = 0; i < count; i++) {
        if (off + ENTRY_HEADER_SIZE > len) {
            codec_error("batch entry %u truncated", i);
            goto done;
        }
        unsigned processed = p[off];
        int64_t position = rd_i64(p + off + 1);
        uint32_t rec_len = (uint32_t)rd_i32(p + off + 9);
        off += ENTRY_HEADER_SIZE;
        if (off + (Py_ssize_t)rec_len > len || rec_len < FRAME_HEADER_SIZE) {
            codec_error("batch record %u truncated", i);
            goto done;
        }
        const uint8_t *f = p + off;
        if ((want_rt < 0 || (int)f[0] == want_rt)
            && (want_vt < 0 || (int)f[1] == want_vt)
            && (want_intent < 0 || (int)f[2] == want_intent)) {
            PyObject *tup = Py_BuildValue(
                "(iLiiiLnn)", (int)processed, (long long)position,
                (int)f[0], (int)f[1], (int)f[2], (long long)rd_i64(f + 4),
                (Py_ssize_t)off, (Py_ssize_t)rec_len);
            if (!tup)
                goto done;
            if (filtered) {
                int rc = PyList_Append(records, tup);
                Py_DECREF(tup);
                if (rc < 0)
                    goto done;
            } else {
                PyList_SET_ITEM(records, (Py_ssize_t)i, tup);
            }
        }
        off += rec_len;
    }
    if (off != len) {
        codec_error("trailing bytes after batch: %zd", len - off);
        goto done;
    }
    out = Py_BuildValue("(LLO)", (long long)source_position,
                        (long long)timestamp, records);
done:
    Py_XDECREF(records);
    PyBuffer_Release(&view);
    return out;
}

static PyObject *codec_scan_batch_headers(PyObject *self, PyObject *arg)
{
    return scan_batch_headers_impl(arg, -1, -1, -1);
}

/* ------------------------------------------------------------------------
 * Fingerprint packer (spec: kernel_backend._fingerprint's pure-Python walk).
 *
 * pack_fingerprint(docs, roles, fp_fields) -> (bytes, fp_values)
 *   roles:     dict int -> str tag (keys known at admission)
 *   fp_fields: set of dict-key names whose large-int values are extracted
 * Two passes: collect large ints pinned at non-whitelisted positions, then
 * emit msgpack with role markers ["\x00r", tag], extraction markers
 * ["\x00f", ordinal], and "\x00s" string escaping — byte-identical to
 * packb(norm(docs)) from the Python implementation. */

typedef struct {
    PyObject *roles;      /* borrowed: dict int -> str */
    PyObject *fp_fields;  /* borrowed: set/frozenset of str */
    PyObject *pinned;     /* owned: set of ints */
    PyObject *fp_ordinal; /* owned: dict int -> int */
    PyObject *fp_values;  /* owned: list of ints */
    PyObject *min_obj;    /* owned: 2^32 */
    PyObject *neg_min_obj; /* owned: -(2^32) */
} FpCtx;

static int fp_large(FpCtx *c, PyObject *obj, int *large)
{
    int r = PyObject_RichCompareBool(obj, c->min_obj, Py_GE);
    if (r < 0)
        return -1;
    *large = r;
    return 0;
}

static int fp_field_match(FpCtx *c, PyObject *key)
{
    if (!PyUnicode_CheckExact(key))
        return 0;
    return PySet_Contains(c->fp_fields, key);
}

static int fp_scan(FpCtx *c, PyObject *obj, int in_fp_field, int depth)
{
    if (depth > MAX_DEPTH) {
        codec_error("fingerprint nesting exceeds %d", MAX_DEPTH);
        return -1;
    }
    if (PyLong_CheckExact(obj)) {
        int large;
        if (fp_large(c, obj, &large) < 0)
            return -1;
        if (large) {
            if (!in_fp_field) {
                int in_roles = PyDict_Contains(c->roles, obj);
                if (in_roles < 0)
                    return -1;
                if (!in_roles && PySet_Add(c->pinned, obj) < 0)
                    return -1;
            }
        } else {
            /* large negatives are never roles and never extracted — the
             * emit pass copies them unchanged everywhere, so they are
             * fingerprint-pinned (sound template constants) */
            int neg = PyObject_RichCompareBool(obj, c->neg_min_obj, Py_LE);
            if (neg < 0)
                return -1;
            if (neg && PySet_Add(c->pinned, obj) < 0)
                return -1;
        }
        return 0;
    }
    if (PyDict_CheckExact(obj)) {
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (fp_scan(c, k, 0, depth + 1) < 0)
                return -1;
            int fp = fp_field_match(c, k);
            if (fp < 0 || fp_scan(c, v, fp, depth + 1) < 0)
                return -1;
        }
        return 0;
    }
    if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
        for (Py_ssize_t i = 0; i < n; i++)
            if (fp_scan(c, PySequence_Fast_GET_ITEM(obj, i), 0, depth + 1) < 0)
                return -1;
        return 0;
    }
    return 0;
}

static const uint8_t FP_ROLE_MARK[4] = {0x92, 0xA2, 0x00, 'r'};
static const uint8_t FP_EXTRACT_MARK[4] = {0x92, 0xA2, 0x00, 'f'};

static int fp_emit(FpCtx *c, Writer *w, PyObject *obj, int in_fp_field, int depth)
{
    if (depth > MAX_DEPTH) {
        codec_error("fingerprint nesting exceeds %d", MAX_DEPTH);
        return -1;
    }
    if (PyLong_CheckExact(obj)) {
        int large;
        if (fp_large(c, obj, &large) < 0)
            return -1;
        if (large) {
            PyObject *tag = PyDict_GetItemWithError(c->roles, obj);
            if (!tag && PyErr_Occurred())
                return -1;
            if (tag) {
                if (put(w, FP_ROLE_MARK, 4) < 0)
                    return -1;
                return pack_str(w, tag);
            }
            if (in_fp_field) {
                int pinned = PySet_Contains(c->pinned, obj);
                if (pinned < 0)
                    return -1;
                if (!pinned) {
                    PyObject *ord = PyDict_GetItemWithError(c->fp_ordinal, obj);
                    long long ordv;
                    if (!ord && PyErr_Occurred())
                        return -1;
                    if (ord) {
                        ordv = PyLong_AsLongLong(ord);
                    } else {
                        ordv = PyList_GET_SIZE(c->fp_values);
                        PyObject *o = PyLong_FromLongLong(ordv);
                        if (!o)
                            return -1;
                        int rc = PyDict_SetItem(c->fp_ordinal, obj, o);
                        if (rc == 0)
                            rc = PyList_Append(c->fp_values, obj);
                        Py_DECREF(o);
                        if (rc < 0)
                            return -1;
                    }
                    if (put(w, FP_EXTRACT_MARK, 4) < 0)
                        return -1;
                    return pack_ll(w, ordv);
                }
            }
        }
        return pack_long(w, obj);
    }
    if (PyUnicode_CheckExact(obj)) {
        Py_ssize_t n;
        const char *raw = PyUnicode_AsUTF8AndSize(obj, &n);
        if (!raw)
            return -1;
        if (n > 0 && raw[0] == 0) {
            /* "\x00"-prefixed user string: escape as "\x00s" + original so
             * it can never forge a role/extract marker */
            Py_ssize_t total = n + 2;
            if (total < 32) {
                if (put1(w, (uint8_t)(0xA0 | total)) < 0)
                    return -1;
            } else if (total < 0x100) {
                if (put1(w, 0xD9) < 0 || put1(w, (uint8_t)total) < 0)
                    return -1;
            } else if (total < 0x10000) {
                if (put1(w, 0xDA) < 0 || put_be16(w, (uint16_t)total) < 0)
                    return -1;
            } else {
                if (put1(w, 0xDB) < 0 || put_be32(w, (uint32_t)total) < 0)
                    return -1;
            }
            static const uint8_t esc[2] = {0x00, 's'};
            return put(w, esc, 2) < 0 || put(w, raw, n) < 0 ? -1 : 0;
        }
        return pack_str(w, obj);
    }
    if (PyDict_CheckExact(obj)) {
        Py_ssize_t n = PyDict_GET_SIZE(obj);
        if (n < 16) {
            if (put1(w, (uint8_t)(0x80 | n)) < 0)
                return -1;
        } else if (n < 0x10000) {
            if (put1(w, 0xDE) < 0 || put_be16(w, (uint16_t)n) < 0)
                return -1;
        } else {
            if (put1(w, 0xDF) < 0 || put_be32(w, (uint32_t)n) < 0)
                return -1;
        }
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (fp_emit(c, w, k, 0, depth + 1) < 0)
                return -1;
            int fp = fp_field_match(c, k);
            if (fp < 0 || fp_emit(c, w, v, fp, depth + 1) < 0)
                return -1;
        }
        return 0;
    }
    if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
        if (n < 16) {
            if (put1(w, (uint8_t)(0x90 | n)) < 0)
                return -1;
        } else if (n < 0x10000) {
            if (put1(w, 0xDC) < 0 || put_be16(w, (uint16_t)n) < 0)
                return -1;
        } else {
            if (put1(w, 0xDD) < 0 || put_be32(w, (uint32_t)n) < 0)
                return -1;
        }
        for (Py_ssize_t i = 0; i < n; i++)
            if (fp_emit(c, w, PySequence_Fast_GET_ITEM(obj, i), 0, depth + 1) < 0)
                return -1;
        return 0;
    }
    return pack_obj(w, obj, depth);
}

static PyObject *codec_pack_fingerprint(PyObject *self, PyObject *args)
{
    PyObject *docs, *roles, *fp_fields;
    if (!PyArg_ParseTuple(args, "OOO", &docs, &roles, &fp_fields))
        return NULL;
    if (!PyDict_Check(roles) || !PyAnySet_Check(fp_fields)) {
        PyErr_SetString(PyExc_TypeError, "roles must be dict, fp_fields a set");
        return NULL;
    }
    FpCtx c = {roles, fp_fields, NULL, NULL, NULL, NULL, NULL};
    PyObject *out = NULL, *payload = NULL;
    Writer w = {NULL, 0, 0};
    c.pinned = PySet_New(NULL);
    c.fp_ordinal = PyDict_New();
    c.fp_values = PyList_New(0);
    c.min_obj = PyLong_FromUnsignedLongLong(1ULL << 32);
    c.neg_min_obj = PyLong_FromLongLong(-(1LL << 32));
    if (!c.pinned || !c.fp_ordinal || !c.fp_values || !c.min_obj
        || !c.neg_min_obj)
        goto done;
    if (fp_scan(&c, docs, 0, 0) < 0)
        goto done;
    if (fp_emit(&c, &w, docs, 0, 0) < 0)
        goto done;
    payload = PyBytes_FromStringAndSize((const char *)w.data, w.len);
    if (!payload)
        goto done;
    out = PyTuple_Pack(3, payload, c.fp_values, c.pinned);
done:
    PyMem_Free(w.data);
    Py_XDECREF(payload);
    Py_XDECREF(c.pinned);
    Py_XDECREF(c.fp_ordinal);
    Py_XDECREF(c.fp_values);
    Py_XDECREF(c.min_obj);
    Py_XDECREF(c.neg_min_obj);
    return out;
}

/* ------------------------------------------------------------------------
 * Bulk patch applier (burst-template instantiation fast path).
 *
 * apply_patches(buf, plan, values) -> None
 *   buf:    bytearray to patch in place
 *   plan:   bytes of little-endian entries {u32 offset; u8 fmt; u8 value_idx}
 *           fmt 0 = i64 LE, 1 = i32 LE, 2 = u64 BE (masked),
 *           fmt 3 = u64 BE with the state-key sign flip (v ^ 2^63)
 *   values: sequence of ints, indexed by value_idx */
#define PATCH_ENTRY_SIZE 6

static PyObject *codec_apply_patches(PyObject *self, PyObject *args)
{
    PyObject *buf, *plan, *values;
    if (!PyArg_ParseTuple(args, "OOO", &buf, &plan, &values))
        return NULL;
    if (!PyByteArray_CheckExact(buf) || !PyBytes_CheckExact(plan)
        || !PyList_CheckExact(values)) {
        PyErr_SetString(PyExc_TypeError,
                        "apply_patches(bytearray, bytes, list) expected");
        return NULL;
    }
    uint8_t *b = (uint8_t *)PyByteArray_AS_STRING(buf);
    Py_ssize_t blen = PyByteArray_GET_SIZE(buf);
    const uint8_t *p = (const uint8_t *)PyBytes_AS_STRING(plan);
    Py_ssize_t plen = PyBytes_GET_SIZE(plan);
    if (plen % PATCH_ENTRY_SIZE) {
        PyErr_SetString(PyExc_ValueError, "malformed patch plan");
        return NULL;
    }
    Py_ssize_t nvals = PyList_GET_SIZE(values);
    int64_t cache[256];
    uint8_t cached[256] = {0};
    for (Py_ssize_t e = 0; e < plen; e += PATCH_ENTRY_SIZE) {
        uint32_t off = (uint32_t)p[e] | ((uint32_t)p[e + 1] << 8)
            | ((uint32_t)p[e + 2] << 16) | ((uint32_t)p[e + 3] << 24);
        uint8_t fmt = p[e + 4];
        uint8_t idx = p[e + 5];
        if (idx >= nvals) {
            PyErr_SetString(PyExc_IndexError, "patch value index out of range");
            return NULL;
        }
        int64_t v;
        if (cached[idx]) {
            v = cache[idx];
        } else {
            int overflow = 0;
            v = PyLong_AsLongLongAndOverflow(PyList_GET_ITEM(values, idx), &overflow);
            if (v == -1 && PyErr_Occurred())
                return NULL;
            if (overflow) {
                PyErr_SetString(PyExc_OverflowError, "patch value out of i64 range");
                return NULL;
            }
            cache[idx] = v;
            cached[idx] = 1;
        }
        Py_ssize_t width = (fmt == 1) ? 4 : 8;
        if ((Py_ssize_t)off + width > blen) {
            PyErr_SetString(PyExc_ValueError, "patch offset out of range");
            return NULL;
        }
        switch (fmt) {
        case 0:
            memcpy(b + off, &v, 8);
            break;
        case 1: {
            int32_t v32 = (int32_t)v;
            memcpy(b + off, &v32, 4);
            break;
        }
        case 2:
        case 3: {
            uint64_t u = (uint64_t)v;
            if (fmt == 3)
                u ^= 0x8000000000000000ULL;
            for (int i = 0; i < 8; i++)
                b[off + i] = (uint8_t)(u >> (56 - 8 * i));
            break;
        }
        default:
            PyErr_SetString(PyExc_ValueError, "unknown patch format");
            return NULL;
        }
    }
    Py_RETURN_NONE;
}

/* stamp_batch(buf, pos_offsets, ts_offsets, first_position, timestamp):
 * write first_position+i LE at pos_offsets[i] and timestamp LE at every
 * ts_offset — the only two unknowns of a pre-serialized burst batch,
 * patched under the append lock. */
static PyObject *codec_stamp_batch(PyObject *self, PyObject *args)
{
    PyObject *buf, *pos_offsets, *ts_offsets;
    long long first_position, timestamp;
    if (!PyArg_ParseTuple(args, "OOOLL", &buf, &pos_offsets, &ts_offsets,
                          &first_position, &timestamp))
        return NULL;
    if (!PyByteArray_CheckExact(buf) || !PyList_CheckExact(pos_offsets)
        || !PyList_CheckExact(ts_offsets)) {
        PyErr_SetString(PyExc_TypeError,
                        "stamp_batch(bytearray, list, list, int, int) expected");
        return NULL;
    }
    uint8_t *b = (uint8_t *)PyByteArray_AS_STRING(buf);
    Py_ssize_t blen = PyByteArray_GET_SIZE(buf);
    Py_ssize_t n = PyList_GET_SIZE(pos_offsets);
    for (Py_ssize_t i = 0; i < n; i++) {
        long long off = PyLong_AsLongLong(PyList_GET_ITEM(pos_offsets, i));
        if (off == -1 && PyErr_Occurred())
            return NULL;
        if (off < 0 || off + 8 > blen) {
            PyErr_SetString(PyExc_ValueError, "position offset out of range");
            return NULL;
        }
        int64_t v = first_position + i;
        memcpy(b + off, &v, 8);
    }
    n = PyList_GET_SIZE(ts_offsets);
    for (Py_ssize_t i = 0; i < n; i++) {
        long long off = PyLong_AsLongLong(PyList_GET_ITEM(ts_offsets, i));
        if (off == -1 && PyErr_Occurred())
            return NULL;
        if (off < 0 || off + 8 > blen) {
            PyErr_SetString(PyExc_ValueError, "timestamp offset out of range");
            return NULL;
        }
        int64_t v = timestamp;
        memcpy(b + off, &v, 8);
    }
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------------
 * scan_batch_headers_filtered(payload, record_type, value_type, intent):
 * scan_batch_headers that keeps only entries matching the given header ints
 * (intent < 0 matches any intent) — a discovery sweep over N records with k
 * matches allocates k tuples, not N. Same framing as scan_batch_headers. */
static PyObject *codec_scan_batch_headers_filtered(PyObject *self, PyObject *args)
{
    PyObject *arg;
    int want_rt, want_vt, want_intent;
    if (!PyArg_ParseTuple(args, "Oiii", &arg, &want_rt, &want_vt, &want_intent))
        return NULL;
    return scan_batch_headers_impl(arg, want_rt, want_vt, want_intent);
}

/* ------------------------------------------------------------------------
 * apply_state_plan: a burst template's state write-set applied natively,
 * with Transaction.put/delete semantics (state/db.py): a key not yet in the
 * overlay dict is insorted into the sorted-keys list; the dict then maps
 * key -> fresh value object (puts) or the _DELETED sentinel (deletes).
 *
 * apply_state_plan(plan, values, writes, sorted_writes, deleted)
 *   plan: list of (op:int 0=del/1=put, key:bytes, key_patches:bytes,
 *                  value_bytes:bytes|None, value_patches:bytes)
 *     patches are packed (u32 LE offset, u8 role index), 5 bytes each;
 *     key patches write BE u64 sign-flipped (db key int encoding), value
 *     patches write BE u64 raw (msgpack uint64 body) — matching
 *     StateOp.build_value / BurstTemplate.apply_state exactly.
 *   values: list of resolved role ints (one resolve per distinct role)
 * Every put unpacks a FRESH value object (the engine mutates state values
 * in place, so object sharing across instantiations would corrupt state). */
#define STATE_PATCH_SIZE 5

static int apply_packed_patches(uint8_t *buf, Py_ssize_t blen,
                                const uint8_t *patches, Py_ssize_t plen,
                                const int64_t *vals, Py_ssize_t nvals,
                                int sign_flip)
{
    if (plen % STATE_PATCH_SIZE) {
        PyErr_SetString(PyExc_ValueError, "malformed state patch plan");
        return -1;
    }
    for (Py_ssize_t e = 0; e < plen; e += STATE_PATCH_SIZE) {
        uint32_t off = (uint32_t)patches[e] | ((uint32_t)patches[e + 1] << 8)
            | ((uint32_t)patches[e + 2] << 16) | ((uint32_t)patches[e + 3] << 24);
        uint8_t idx = patches[e + 4];
        if (idx >= nvals || (Py_ssize_t)off + 8 > blen) {
            PyErr_SetString(PyExc_ValueError, "state patch out of range");
            return -1;
        }
        uint64_t u = (uint64_t)vals[idx];
        if (sign_flip)
            u ^= 0x8000000000000000ULL;
        for (int i = 0; i < 8; i++)
            buf[off + i] = (uint8_t)(u >> (56 - 8 * i));
    }
    return 0;
}

/* bisect_left over an ascending list of bytes keys (memcmp fast path,
 * RichCompare fallback for non-bytes items); -1 on comparison error */
static Py_ssize_t bisect_left_bytes(PyObject *list, PyObject *key)
{
    Py_ssize_t lo = 0, hi = PyList_GET_SIZE(list);
    const char *kbuf = PyBytes_CheckExact(key) ? PyBytes_AS_STRING(key) : NULL;
    Py_ssize_t klen = kbuf ? PyBytes_GET_SIZE(key) : 0;
    while (lo < hi) {
        Py_ssize_t mid = (lo + hi) / 2;
        PyObject *item = PyList_GET_ITEM(list, mid);
        int lt;
        if (kbuf && PyBytes_CheckExact(item)) {
            Py_ssize_t ilen = PyBytes_GET_SIZE(item);
            Py_ssize_t n = ilen < klen ? ilen : klen;
            int c = memcmp(PyBytes_AS_STRING(item), kbuf, (size_t)n);
            lt = c < 0 || (c == 0 && ilen < klen);
        } else {
            lt = PyObject_RichCompareBool(item, key, Py_LT);
            if (lt < 0)
                return -1;
        }
        if (lt)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

/* ascending-bytes insort (Transaction._sorted_writes invariant) */
static int insort_bytes(PyObject *list, PyObject *key)
{
    Py_ssize_t lo = bisect_left_bytes(list, key);
    if (lo < 0)
        return -1;
    return PyList_Insert(list, lo, key);
}

/* commit_overlay(writes, data, sorted_keys, deleted):
 * Transaction.commit's apply loop, natively — for each (key, val) in the
 * overlay dict: a deleted-sentinel val removes the key from the committed
 * dict and its sorted-keys list; any other val upserts (insort on first
 * insert). Mirrors ZbDb._put_committed/_delete_committed exactly. */
static PyObject *codec_commit_overlay(PyObject *self, PyObject *args)
{
    PyObject *writes, *data, *sorted_keys, *deleted;
    if (!PyArg_ParseTuple(args, "OOOO", &writes, &data, &sorted_keys, &deleted))
        return NULL;
    if (!PyDict_CheckExact(writes) || !PyDict_CheckExact(data)
        || !PyList_CheckExact(sorted_keys)) {
        PyErr_SetString(PyExc_TypeError,
                        "commit_overlay(dict, dict, list, obj) expected");
        return NULL;
    }
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(writes, &pos, &key, &val)) {
        int present = PyDict_Contains(data, key);
        if (present < 0)
            return NULL;
        if (val == deleted) {
            if (!present)
                continue;
            if (PyDict_DelItem(data, key) < 0)
                return NULL;
            /* locate the key in the sorted list (bisect_left + equality) */
            Py_ssize_t lo = bisect_left_bytes(sorted_keys, key);
            if (lo < 0)
                return NULL;
            if (lo < PyList_GET_SIZE(sorted_keys)) {
                int eq = PyObject_RichCompareBool(
                    PyList_GET_ITEM(sorted_keys, lo), key, Py_EQ);
                if (eq < 0)
                    return NULL;
                if (eq && PySequence_DelItem(sorted_keys, lo) < 0)
                    return NULL;
            }
        } else {
            if (!present && insort_bytes(sorted_keys, key) < 0)
                return NULL;
            if (PyDict_SetItem(data, key, val) < 0)
                return NULL;
        }
    }
    Py_RETURN_NONE;
}

/* iterate_snapshot(sorted_keys, data, prefix, sorted_writes, writes,
 *                  deleted, reads_cache):
 * Transaction.iterate's merge, natively — one pass building the ordered
 * committed-union-overlay snapshot list for a prefix range. Committed
 * values go through the same defensive-copy-and-cache discipline as
 * Transaction._committed_read (dict/list values are shallow-copied once
 * per transaction via reads_cache); overlay values are returned verbatim
 * with deleted-sentinel entries dropped. Both inputs are sorted, so the
 * output merges in order with no final sort. */
static PyObject *codec_iterate_snapshot(PyObject *self, PyObject *args)
{
    PyObject *sorted_keys, *data, *prefix, *sorted_writes, *writes, *deleted,
        *reads;
    if (!PyArg_ParseTuple(args, "OOOOOOO", &sorted_keys, &data, &prefix,
                          &sorted_writes, &writes, &deleted, &reads))
        return NULL;
    if (!PyList_CheckExact(sorted_keys) || !PyDict_CheckExact(data)
        || !PyBytes_CheckExact(prefix) || !PyList_CheckExact(sorted_writes)
        || !PyDict_CheckExact(writes) || !PyDict_CheckExact(reads)) {
        PyErr_SetString(PyExc_TypeError,
                        "iterate_snapshot(list, dict, bytes, list, dict, obj, "
                        "dict) expected");
        return NULL;
    }
    /* range bounds: [prefix, successor(prefix)) on both sorted lists */
    Py_ssize_t plen = PyBytes_GET_SIZE(prefix);
    PyObject *end = NULL; /* NULL = unbounded */
    {
        const char *p = PyBytes_AS_STRING(prefix);
        Py_ssize_t n = plen;
        while (n > 0 && (unsigned char)p[n - 1] == 0xFF)
            n--;
        if (n > 0) {
            end = PyBytes_FromStringAndSize(p, n);
            if (!end)
                return NULL;
            ((unsigned char *)PyBytes_AS_STRING(end))[n - 1]++;
        }
    }
    Py_ssize_t clo = bisect_left_bytes(sorted_keys, prefix);
    Py_ssize_t chi = end ? bisect_left_bytes(sorted_keys, end)
                         : PyList_GET_SIZE(sorted_keys);
    Py_ssize_t wlo = bisect_left_bytes(sorted_writes, prefix);
    Py_ssize_t whi = end ? bisect_left_bytes(sorted_writes, end)
                         : PyList_GET_SIZE(sorted_writes);
    Py_XDECREF(end);
    if (clo < 0 || chi < 0 || wlo < 0 || whi < 0)
        return NULL;
    PyObject *out = PyList_New(0);
    if (!out)
        return NULL;
    Py_ssize_t ci = clo, wi = wlo;
    while (ci < chi || wi < whi) {
        PyObject *key;
        PyObject *val;
        int from_overlay;
        if (wi >= whi) {
            from_overlay = 0;
            key = PyList_GET_ITEM(sorted_keys, ci);
            ci++;
        } else if (ci >= chi) {
            from_overlay = 1;
            key = PyList_GET_ITEM(sorted_writes, wi);
            wi++;
        } else {
            PyObject *ck = PyList_GET_ITEM(sorted_keys, ci);
            PyObject *wk = PyList_GET_ITEM(sorted_writes, wi);
            int cmp;
            if (PyBytes_CheckExact(ck) && PyBytes_CheckExact(wk)) {
                Py_ssize_t cl = PyBytes_GET_SIZE(ck), wl = PyBytes_GET_SIZE(wk);
                Py_ssize_t n = cl < wl ? cl : wl;
                int c = memcmp(PyBytes_AS_STRING(ck), PyBytes_AS_STRING(wk),
                               (size_t)n);
                cmp = c != 0 ? c : (cl < wl ? -1 : (cl > wl ? 1 : 0));
            } else {
                int lt = PyObject_RichCompareBool(ck, wk, Py_LT);
                if (lt < 0)
                    goto fail;
                cmp = lt ? -1 : 1;
                if (!lt) {
                    int eq = PyObject_RichCompareBool(ck, wk, Py_EQ);
                    if (eq < 0)
                        goto fail;
                    if (eq)
                        cmp = 0;
                }
            }
            if (cmp < 0) {
                from_overlay = 0;
                key = ck;
                ci++;
            } else if (cmp > 0) {
                from_overlay = 1;
                key = wk;
                wi++;
            } else {
                /* overlay supersedes the committed entry */
                from_overlay = 1;
                key = wk;
                ci++;
                wi++;
            }
        }
        if (from_overlay) {
            val = PyDict_GetItemWithError(writes, key);
            if (!val) {
                if (PyErr_Occurred())
                    goto fail;
                continue; /* raced away — cannot happen on these dicts */
            }
            if (val == deleted)
                continue;
            Py_INCREF(val);
        } else {
            /* _committed_read: copy-and-cache containers, scalars verbatim */
            val = PyDict_GetItemWithError(reads, key);
            if (!val && PyErr_Occurred())
                goto fail;
            if (!val) {
                val = PyDict_GetItemWithError(data, key);
                if (!val) {
                    if (PyErr_Occurred())
                        goto fail;
                    continue; /* deleted between index and dict — unreachable */
                }
                if (PyDict_CheckExact(val)) {
                    val = PyDict_Copy(val);
                    if (!val || PyDict_SetItem(reads, key, val) < 0)
                        goto fail_val;
                } else if (PyList_CheckExact(val)) {
                    val = PyList_GetSlice(val, 0, PyList_GET_SIZE(val));
                    if (!val || PyDict_SetItem(reads, key, val) < 0)
                        goto fail_val;
                } else {
                    Py_INCREF(val);
                }
            } else {
                Py_INCREF(val);
            }
        }
        {
            PyObject *pair = PyTuple_Pack(2, key, val);
            Py_DECREF(val);
            if (!pair)
                goto fail;
            if (PyList_Append(out, pair) < 0) {
                Py_DECREF(pair);
                goto fail;
            }
            Py_DECREF(pair);
        }
        continue;
    fail_val:
        Py_XDECREF(val);
        goto fail;
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

static PyObject *codec_apply_state_plan(PyObject *self, PyObject *args)
{
    PyObject *plan, *values, *writes, *sorted_writes, *deleted;
    if (!PyArg_ParseTuple(args, "OOOOO", &plan, &values, &writes,
                          &sorted_writes, &deleted))
        return NULL;
    if (!PyList_CheckExact(plan) || !PyList_CheckExact(values)
        || !PyDict_CheckExact(writes) || !PyList_CheckExact(sorted_writes)) {
        PyErr_SetString(PyExc_TypeError,
                        "apply_state_plan(list, list, dict, list, obj) expected");
        return NULL;
    }
    Py_ssize_t nvals = PyList_GET_SIZE(values);
    if (nvals > 256) {
        PyErr_SetString(PyExc_ValueError, "too many roles in state plan");
        return NULL;
    }
    int64_t vals[256];
    for (Py_ssize_t i = 0; i < nvals; i++) {
        int overflow = 0;
        vals[i] = PyLong_AsLongLongAndOverflow(PyList_GET_ITEM(values, i), &overflow);
        if (vals[i] == -1 && PyErr_Occurred())
            return NULL;
        if (overflow) {
            PyErr_SetString(PyExc_OverflowError, "role value out of i64 range");
            return NULL;
        }
    }
    Py_ssize_t nops = PyList_GET_SIZE(plan);
    for (Py_ssize_t i = 0; i < nops; i++) {
        PyObject *op = PyList_GET_ITEM(plan, i);
        if (!PyTuple_CheckExact(op) || PyTuple_GET_SIZE(op) != 5) {
            PyErr_SetString(PyExc_TypeError, "malformed state plan op");
            return NULL;
        }
        long code = PyLong_AsLong(PyTuple_GET_ITEM(op, 0));
        PyObject *key_tmpl = PyTuple_GET_ITEM(op, 1);
        PyObject *kp = PyTuple_GET_ITEM(op, 2);
        PyObject *vb = PyTuple_GET_ITEM(op, 3);
        PyObject *vp = PyTuple_GET_ITEM(op, 4);
        if ((code == -1 && PyErr_Occurred()) || !PyBytes_CheckExact(key_tmpl)
            || !PyBytes_CheckExact(kp) || !PyBytes_CheckExact(vp)) {
            PyErr_SetString(PyExc_TypeError, "malformed state plan op");
            return NULL;
        }
        /* key: reuse the template bytes when patch-free (immutable) */
        PyObject *key;
        Py_ssize_t kplen = PyBytes_GET_SIZE(kp);
        if (kplen == 0) {
            key = key_tmpl;
            Py_INCREF(key);
        } else {
            key = PyBytes_FromStringAndSize(PyBytes_AS_STRING(key_tmpl),
                                            PyBytes_GET_SIZE(key_tmpl));
            if (!key)
                return NULL;
            if (apply_packed_patches((uint8_t *)PyBytes_AS_STRING(key),
                                     PyBytes_GET_SIZE(key),
                                     (const uint8_t *)PyBytes_AS_STRING(kp),
                                     kplen, vals, nvals, 1) < 0) {
                Py_DECREF(key);
                return NULL;
            }
        }
        /* value: fresh unpack per op (deletes store the sentinel) */
        PyObject *value;
        if (code == 0) {
            value = deleted;
            Py_INCREF(value);
        } else {
            if (!PyBytes_CheckExact(vb)) {
                Py_DECREF(key);
                PyErr_SetString(PyExc_TypeError, "state plan put without value bytes");
                return NULL;
            }
            Py_ssize_t vlen = PyBytes_GET_SIZE(vb);
            Py_ssize_t vplen = PyBytes_GET_SIZE(vp);
            if (vplen == 0) {
                Reader r = {(const uint8_t *)PyBytes_AS_STRING(vb), vlen, 0};
                value = read_obj(&r, 0);
                if (value && r.pos != r.len) {
                    Py_DECREF(value);
                    value = codec_error("trailing bytes in state value");
                }
            } else {
                uint8_t stack_buf[512];
                uint8_t *vbuf = vlen <= (Py_ssize_t)sizeof stack_buf
                    ? stack_buf : PyMem_Malloc(vlen);
                if (!vbuf) {
                    Py_DECREF(key);
                    return PyErr_NoMemory();
                }
                memcpy(vbuf, PyBytes_AS_STRING(vb), vlen);
                if (apply_packed_patches(vbuf, vlen,
                                         (const uint8_t *)PyBytes_AS_STRING(vp),
                                         vplen, vals, nvals, 0) < 0) {
                    if (vbuf != stack_buf)
                        PyMem_Free(vbuf);
                    Py_DECREF(key);
                    return NULL;
                }
                Reader r = {vbuf, vlen, 0};
                value = read_obj(&r, 0);
                if (value && r.pos != r.len) {
                    Py_DECREF(value);
                    value = codec_error("trailing bytes in state value");
                }
                if (vbuf != stack_buf)
                    PyMem_Free(vbuf);
            }
            if (!value) {
                Py_DECREF(key);
                return NULL;
            }
        }
        /* Transaction.put/delete: insort on first write of the key */
        int present = PyDict_Contains(writes, key);
        if (present < 0 || (present == 0 && insort_bytes(sorted_writes, key) < 0)
            || PyDict_SetItem(writes, key, value) < 0) {
            Py_DECREF(key);
            Py_DECREF(value);
            return NULL;
        }
        Py_DECREF(key);
        Py_DECREF(value);
    }
    Py_RETURN_NONE;
}

/* -- durable-state base-segment indexing ---------------------------------- */

static uint32_t crc32_tab[256];
static uint32_t crc32_tab8[8][256]; /* slice-by-8 lanes; lane 0 == crc32_tab */
static int crc32_ready = 0;

static void crc32_build(void)
{
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc32_tab[i] = c;
        crc32_tab8[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int k = 1; k < 8; k++)
            crc32_tab8[k][i] =
                (crc32_tab8[k - 1][i] >> 8) ^ crc32_tab[crc32_tab8[k - 1][i] & 0xFF];
    crc32_ready = 1;
}

/* advance the RAW crc register (pre/post inversion is the caller's business)
 * over n bytes — slice-by-8 body, bytewise tail. Little-endian word loads,
 * the same host assumption the frame readers (rd_i64 &c.) already make. */
static uint32_t crc32_update(uint32_t c, const unsigned char *p, Py_ssize_t n)
{
    while (n >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, p, 4);
        memcpy(&hi, p + 4, 4);
        c ^= lo;
        c = crc32_tab8[7][c & 0xFF] ^ crc32_tab8[6][(c >> 8) & 0xFF]
            ^ crc32_tab8[5][(c >> 16) & 0xFF] ^ crc32_tab8[4][c >> 24]
            ^ crc32_tab8[3][hi & 0xFF] ^ crc32_tab8[2][(hi >> 8) & 0xFF]
            ^ crc32_tab8[1][(hi >> 16) & 0xFF] ^ crc32_tab8[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n--) {
        c = crc32_tab[(c ^ *p++) & 0xFF] ^ (c >> 8);
    }
    return c;
}

static uint32_t crc32_buf(const unsigned char *p, Py_ssize_t n)
{
    return crc32_update(0xFFFFFFFFu, p, n) ^ 0xFFFFFFFFu;
}

/* index_base_segment(view, data) -> [keys in file order]
 * Scan a durable base segment (state/durable.py layout: per entry a <HII>
 * header = key len, value len, key crc — then key bytes, then the cold
 * slice [value crc u32 | value bytes]). Key crcs verify eagerly; values
 * install as raw zero-copy memoryview slices of the caller's mmap view
 * (crc-checked lazily at resolution, _resolve_view). A torn or corrupt
 * entry truncates the scan (journal discipline). File order == sorted. */
static PyObject *codec_index_base_segment(PyObject *self, PyObject *args)
{
    PyObject *view, *data;
    if (!PyArg_ParseTuple(args, "OO", &view, &data))
        return NULL;
    if (!PyDict_CheckExact(data)) {
        PyErr_SetString(PyExc_TypeError, "data must be a dict");
        return NULL;
    }
    Py_buffer buf;
    if (PyObject_GetBuffer(view, &buf, PyBUF_SIMPLE) < 0)
        return NULL;
    if (!crc32_ready)
        crc32_build();
    const unsigned char *p = (const unsigned char *)buf.buf;
    Py_ssize_t n = buf.len;
    PyObject *keys = PyList_New(0);
    if (!keys) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    Py_ssize_t off = 0;
    while (off + 10 <= n) {
        uint16_t klen = (uint16_t)(p[off] | (p[off + 1] << 8));
        uint32_t vlen = (uint32_t)p[off + 2] | ((uint32_t)p[off + 3] << 8)
            | ((uint32_t)p[off + 4] << 16) | ((uint32_t)p[off + 5] << 24);
        uint32_t kcrc = (uint32_t)p[off + 6] | ((uint32_t)p[off + 7] << 8)
            | ((uint32_t)p[off + 8] << 16) | ((uint32_t)p[off + 9] << 24);
        Py_ssize_t kstart = off + 10;
        Py_ssize_t vstart = kstart + klen; /* [vcrc|value] slice start */
        Py_ssize_t vend = vstart + 4 + (Py_ssize_t)vlen;
        if (vend > n)
            break;
        if (crc32_buf(p + kstart, klen) != kcrc)
            break;
        PyObject *key = PyBytes_FromStringAndSize((const char *)p + kstart, klen);
        if (!key)
            goto fail;
        /* zero-copy cold slice narrowed to [vcrc|value]. obj stays NULL:
         * the view does NOT pin the mmap — DurableZbDb owns the map for
         * the db's lifetime (self._maps) and drops _data before unmapping,
         * and cold views never escape the db (every read path resolves
         * them to fresh objects). This keeps indexing to ONE allocation
         * per value. */
        Py_buffer vb = buf;
        vb.obj = NULL;
        vb.buf = (char *)buf.buf + vstart;
        vb.len = vend - vstart;
        PyObject *vview = PyMemoryView_FromBuffer(&vb);
        if (!vview) {
            Py_DECREF(key);
            goto fail;
        }
        if (PyDict_SetItem(data, key, vview) < 0
            || PyList_Append(keys, key) < 0) {
            Py_DECREF(vview);
            Py_DECREF(key);
            goto fail;
        }
        Py_DECREF(vview);
        Py_DECREF(key);
        off = vend;
    }
    PyBuffer_Release(&buf);
    return keys;
fail:
    PyBuffer_Release(&buf);
    Py_DECREF(keys);
    return NULL;
}

/* encode_key(prefix, parts) -> bytes
 * Order-preserving state-key encoding (spec: state/db.py encode_key /
 * _encode_part — that Python implementation is the contract; tests assert
 * byte-equality). prefix is the 2-byte column-family prefix; parts is a
 * tuple of int | str | bytes. */
static PyObject *codec_encode_key(PyObject *self, PyObject *args)
{
    PyObject *prefix, *parts;
    if (!PyArg_ParseTuple(args, "SO!", &prefix, &PyTuple_Type, &parts))
        return NULL;
    unsigned char stack_buf[256];
    Py_ssize_t cap = sizeof(stack_buf);
    unsigned char *buf = stack_buf;
    Py_ssize_t n = PyBytes_GET_SIZE(prefix);
    if (n > cap)
        return PyErr_Format(PyExc_ValueError, "oversized cf prefix");
    memcpy(buf, PyBytes_AS_STRING(prefix), n);
    PyObject *heap = NULL; /* switch-over for long keys */
    Py_ssize_t count = PyTuple_GET_SIZE(parts);
    for (Py_ssize_t i = 0; i < count; i++) {
        PyObject *part = PyTuple_GET_ITEM(parts, i);
        const void *src = NULL;
        Py_ssize_t need, slen = 0;
        uint64_t flipped = 0;
        int kind;
        if (PyBool_Check(part)) {
            Py_XDECREF(heap);
            PyErr_SetString(PyExc_TypeError,
                            "bool key parts are ambiguous; use int 0/1");
            return NULL;
        } else if (PyLong_Check(part)) {
            /* wrap to 64 bits like the Python spec's `& 0xFFFF…` mask */
            uint64_t v = (uint64_t)PyLong_AsUnsignedLongLongMask(part);
            if (v == (uint64_t)-1 && PyErr_Occurred()) {
                Py_XDECREF(heap);
                return NULL;
            }
            flipped = v ^ 0x8000000000000000ULL;
            kind = 1;
            need = 9;
        } else if (PyUnicode_Check(part)) {
            src = PyUnicode_AsUTF8AndSize(part, &slen);
            if (!src) {
                Py_XDECREF(heap);
                return NULL;
            }
            if (memchr(src, 0, (size_t)slen)) {
                Py_XDECREF(heap);
                PyErr_SetString(PyExc_ValueError, "NUL byte in string key part");
                return NULL;
            }
            kind = 2;
            need = slen + 2;
        } else if (PyBytes_Check(part)) {
            src = PyBytes_AS_STRING(part);
            slen = PyBytes_GET_SIZE(part);
            kind = 3;
            need = slen + 9;
        } else {
            Py_XDECREF(heap);
            return PyErr_Format(PyExc_TypeError,
                                "unsupported key part type %.100s",
                                Py_TYPE(part)->tp_name);
        }
        if (n + need > cap) {
            Py_ssize_t newcap = (cap * 2 > n + need + 64) ? cap * 2 : n + need + 64;
            PyObject *nh = PyBytes_FromStringAndSize(NULL, newcap);
            if (!nh) {
                Py_XDECREF(heap);
                return NULL;
            }
            memcpy(PyBytes_AS_STRING(nh), buf, (size_t)n);
            Py_XDECREF(heap);
            heap = nh;
            buf = (unsigned char *)PyBytes_AS_STRING(nh);
            cap = newcap;
        }
        if (kind == 1) {
            buf[n++] = 0x01;
            for (int b = 7; b >= 0; b--)
                buf[n++] = (unsigned char)(flipped >> (8 * b));
        } else if (kind == 2) {
            buf[n++] = 0x02;
            memcpy(buf + n, src, (size_t)slen);
            n += slen;
            buf[n++] = 0x00;
        } else {
            buf[n++] = 0x03;
            uint64_t ulen = (uint64_t)slen;
            for (int b = 7; b >= 0; b--)
                buf[n++] = (unsigned char)(ulen >> (8 * b));
            memcpy(buf + n, src, (size_t)slen);
            n += slen;
        }
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)buf, n);
    Py_XDECREF(heap);
    return out;
}

/* -- journal frame fast path ---------------------------------------------- */

/* journal/journal.py _checksum is the specification: one continuous crc32
 * register over pack("<Qq", index, asqn) then the payload — the exact
 * zlib.crc32(data, zlib.crc32(head)) continuation semantics. */
static uint32_t journal_crc(uint64_t index, int64_t asqn,
                            const unsigned char *data, Py_ssize_t n)
{
    unsigned char head[16];
    memcpy(head, &index, 8);
    memcpy(head + 8, &asqn, 8);
    uint32_t c = crc32_update(0xFFFFFFFFu, head, 16);
    return crc32_update(c, data, n) ^ 0xFFFFFFFFu;
}

/* journal_checksum(index, asqn, data) -> int — the scan/verify side. */
static PyObject *codec_journal_checksum(PyObject *self, PyObject *args)
{
    unsigned long long index;
    long long asqn;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "KLy*", &index, &asqn, &data))
        return NULL;
    if (!crc32_ready)
        crc32_build();
    uint32_t crc = journal_crc(index, asqn,
                               (const unsigned char *)data.buf, data.len);
    PyBuffer_Release(&data);
    return PyLong_FromUnsignedLong(crc);
}

/* journal_frame(index, asqn, data) -> bytes — the append side: one
 * complete frame (<IIQq> header = payload length, checksum, index, asqn —
 * then the payload) in a single allocation and a single crc pass,
 * replacing two zlib.crc32 calls, two struct packs, and a bytes concat
 * per append. Accepts any contiguous buffer (the prepatched burst path
 * hands the writer's bytearray straight through). */
static PyObject *codec_journal_frame(PyObject *self, PyObject *args)
{
    unsigned long long index;
    long long asqn;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "KLy*", &index, &asqn, &data))
        return NULL;
    if (!crc32_ready)
        crc32_build();
    const unsigned char *p = (const unsigned char *)data.buf;
    Py_ssize_t n = data.len;
    if (n > 0xFFFFFFFFLL) {
        PyBuffer_Release(&data);
        return codec_error("journal payload too large: %zd bytes", n);
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, 24 + n);
    if (!out) {
        PyBuffer_Release(&data);
        return NULL;
    }
    unsigned char *q = (unsigned char *)PyBytes_AS_STRING(out);
    uint32_t length = (uint32_t)n;
    uint32_t crc = journal_crc(index, asqn, p, n);
    int64_t sq = asqn;
    memcpy(q, &length, 4);
    memcpy(q + 4, &crc, 4);
    memcpy(q + 8, &index, 8);
    memcpy(q + 16, &sq, 8);
    memcpy(q + 24, p, n);
    PyBuffer_Release(&data);
    return out;
}

static PyMethodDef codec_methods[] = {
    {"encode_key", codec_encode_key, METH_VARARGS,
     "Order-preserving state-key encoding (spec: state/db.py encode_key)."},
    {"index_base_segment", codec_index_base_segment, METH_VARARGS,
     "Index a durable-state base segment: keys eager, values as lazy cold slices."},
    {"stamp_batch", codec_stamp_batch, METH_VARARGS,
     "Stamp record positions and the batch timestamp into a pre-serialized burst."},
    {"pack_fingerprint", codec_pack_fingerprint, METH_VARARGS,
     "Role-normalizing fingerprint packer: (docs, roles, fp_fields) -> "
     "(bytes, fp_values, pinned_ints)."},
    {"apply_patches", codec_apply_patches, METH_VARARGS,
     "Apply a compiled patch plan to a bytearray in place."},
    {"packb", codec_packb, METH_O, "Serialize an object to msgpack bytes."},
    {"unpackb", codec_unpackb, METH_O, "Deserialize one msgpack value (consumes all bytes)."},
    {"decode_record_frame", codec_decode_record_frame, METH_O,
     "Parse one record wire frame into a 12-tuple (header fields, reason, value)."},
    {"encode_record_frame", codec_encode_record_frame, METH_VARARGS,
     "Serialize one record wire frame; returns (frame, value_body)."},
    {"journal_frame", codec_journal_frame, METH_VARARGS,
     "Build one complete journal frame (header + payload) in a single pass."},
    {"journal_checksum", codec_journal_checksum, METH_VARARGS,
     "Journal frame checksum over (index, asqn, payload) — zlib.crc32 parity."},
    {"scan_batch_headers", codec_scan_batch_headers, METH_O,
     "Parse a sequenced batch into per-record header tuples without decoding values."},
    {"scan_batch_headers_filtered", codec_scan_batch_headers_filtered, METH_VARARGS,
     "scan_batch_headers keeping only entries matching (record_type, value_type, intent)."},
    {"apply_state_plan", codec_apply_state_plan, METH_VARARGS,
     "Apply a compiled burst-template state plan to a transaction overlay."},
    {"iterate_snapshot", codec_iterate_snapshot, METH_VARARGS,
     "Transaction.iterate committed-union-overlay merge in one native pass"},
    {"commit_overlay", codec_commit_overlay, METH_VARARGS,
     "Apply a transaction overlay dict to the committed store (dict + sorted keys)."},
    {"set_error_class", codec_set_error_class, METH_O, "Register the exception class raised on malformed input."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef codec_module = {
    PyModuleDef_HEAD_INIT, "_zb_codec", "Native msgpack codec for zeebe_tpu records.", -1, codec_methods,
};

PyMODINIT_FUNC PyInit__zb_codec(void)
{
    return PyModule_Create(&codec_module);
}
