/* _hostops: the collector's host work in C, for klogs_tpu_torch.
 *
 * The port's own copy of four functions of the JAX package's
 * klogs_tpu/native/_hostops.c (find_newlines :970, join_kept_framed
 * :1012, frame_lines :486, split_frame :540), with their checks: offsets
 * ride int32, so a framed buffer past 2 GiB raises OverflowError, and a
 * mask or offsets array shorter than its count raises ValueError. The
 * JAX file's packers and classifiers (pack_lines, pack_classify*,
 * classify_chunk) are not copied: the card cuts and classifies the rows
 * (ops/csrc/pack_kernels.cu pack_rows, ops/nfa.py classify_chunk).
 *
 * What bounds these functions is the host's memory traffic: each is one
 * pass over its bytes (a memchr sweep, or memcpy runs), with no
 * per-line Python object except where the caller asks for lines
 * (split_frame). Every function holds the GIL; none depends on numpy's
 * C API: callers wrap the returned buffers with np.frombuffer.
 *
 * Built at first use by klogs_tpu_torch/native/__init__.py with the
 * host's C compiler (cc -O3 -shared -fPIC).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>
#include <stdint.h>

/* frame_lines(lines: list[bytes], strip_nl) -> (payload, offsets, raw_total)
 *
 * Contiguous "framed batch" builder: payload = concatenation of the
 * lines (trailing '\n' runs stripped when strip_nl, matching the
 * engine's rstrip(b"\n") parity rule), offsets = int32[n+1] exclusive
 * prefix sums, raw_total = sum of UNstripped lengths (the stats
 * bytes-in figure). One C pass. */
static PyObject *
frame_lines(PyObject *self, PyObject *args)
{
    PyObject *list;
    int strip_nl;
    if (!PyArg_ParseTuple(args, "O!i", &PyList_Type, &list, &strip_nl))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(list);
    Py_ssize_t total = 0, raw = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(list, i);
        char *p;
        Py_ssize_t len;
        if (PyBytes_AsStringAndSize(item, &p, &len) < 0)
            return NULL;
        raw += len;
        if (strip_nl)
            while (len > 0 && p[len - 1] == '\n')
                len--;
        total += len;
    }
    if (total > INT32_MAX) {
        PyErr_SetString(PyExc_OverflowError,
                        "framed batch exceeds int32 offsets");
        return NULL;
    }
    PyObject *payload = PyBytes_FromStringAndSize(NULL, total);
    PyObject *offs = PyBytes_FromStringAndSize(NULL, (n + 1) * 4);
    if (!payload || !offs) {
        Py_XDECREF(payload);
        Py_XDECREF(offs);
        return NULL;
    }
    char *out = PyBytes_AS_STRING(payload);
    int32_t *ov = (int32_t *)PyBytes_AS_STRING(offs);
    Py_ssize_t pos = 0;
    ov[0] = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(list, i);
        char *p = PyBytes_AS_STRING(item);
        Py_ssize_t len = PyBytes_GET_SIZE(item);
        if (strip_nl)
            while (len > 0 && p[len - 1] == '\n')
                len--;
        memcpy(out + pos, p, len);
        pos += len;
        ov[i + 1] = (int32_t)pos;
    }
    return Py_BuildValue("(NNn)", payload, offs, raw);
}

/* split_frame(payload, offsets, n) -> list[bytes]
 * Inverse of frame_lines (the bridge for callers that need lines): one
 * PyBytes per span. */
static PyObject *
split_frame(PyObject *self, PyObject *args)
{
    Py_buffer payload, offs;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "y*y*n", &payload, &offs, &n))
        return NULL;
    if (n < 0 || offs.len < (n + 1) * 4) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyErr_SetString(PyExc_ValueError, "split_frame: bad offsets size");
        return NULL;
    }
    const int32_t *ov = (const int32_t *)offs.buf;
    const char *src = (const char *)payload.buf;
    PyObject *list = PyList_New(n);
    if (!list)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t lo = ov[i], hi = ov[i + 1];
        if (lo < 0 || hi < lo || hi > payload.len) {
            Py_DECREF(list);
            list = NULL;
            PyErr_SetString(PyExc_ValueError,
                            "split_frame: offsets out of range");
            goto fail;
        }
        PyObject *b = PyBytes_FromStringAndSize(src + lo, hi - lo);
        if (!b) {
            Py_DECREF(list);
            list = NULL;
            goto fail;
        }
        PyList_SET_ITEM(list, i, b);
    }
fail:
    PyBuffer_Release(&payload);
    PyBuffer_Release(&offs);
    return list;
}

/* find_newlines(data, base) -> bytes holding int32 positions
 *
 * Absolute end-offsets (position AFTER each '\n', plus `base`) of every
 * newline in `data` — one memchr sweep. The framed-batcher's line
 * scanner: chunk boundaries never materialize per-line objects. */
static PyObject *
find_newlines(PyObject *self, PyObject *args)
{
    Py_buffer data;
    Py_ssize_t base;
    if (!PyArg_ParseTuple(args, "y*n", &data, &base))
        return NULL;
    if (base < 0 || base + data.len > INT32_MAX) {
        /* Same guard as frame_lines: a >2 GiB pending buffer must fail
         * loudly here, not wrap into negative offsets downstream. */
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_OverflowError,
                        "framed buffer exceeds int32 offsets");
        return NULL;
    }
    const char *src = (const char *)data.buf;
    Py_ssize_t n = data.len;
    /* Count first (cheap memchr sweep), then fill exactly. */
    Py_ssize_t count = 0;
    for (const char *p = src;
         (p = memchr(p, '\n', n - (p - src))) != NULL; p++)
        count++;
    PyObject *out = PyBytes_FromStringAndSize(NULL, count * 4);
    if (!out) {
        PyBuffer_Release(&data);
        return NULL;
    }
    int32_t *ov = (int32_t *)PyBytes_AS_STRING(out);
    Py_ssize_t k = 0;
    for (const char *p = src;
         (p = memchr(p, '\n', n - (p - src))) != NULL; p++)
        ov[k++] = (int32_t)(base + (p - src) + 1);
    PyBuffer_Release(&data);
    return out;
}

/* join_kept_framed(payload, offsets, n, mask) -> bytes
 *
 * Concatenation of the mask-selected spans, with ADJACENT kept lines
 * coalesced into single memcpys (a 25%-match batch averages long kept/
 * dropped runs; the common all-kept case is ONE memcpy). The framed
 * sibling of join_kept. */
static PyObject *
join_kept_framed(PyObject *self, PyObject *args)
{
    Py_buffer payload, offs, mask;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "y*y*ny*", &payload, &offs, &n, &mask))
        return NULL;
    if (n < 0 || offs.len < (n + 1) * 4 || mask.len < n) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&mask);
        PyErr_SetString(PyExc_ValueError, "join_kept_framed: bad sizes");
        return NULL;
    }
    const int32_t *ov = (const int32_t *)offs.buf;
    const char *m = (const char *)mask.buf;
    const char *src = (const char *)payload.buf;
    Py_ssize_t total = 0;
    int bad = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        if (ov[i] < 0 || ov[i + 1] < ov[i] || ov[i + 1] > payload.len) {
            bad = 1;
            break;
        }
        if (m[i])
            total += ov[i + 1] - ov[i];
    }
    if (bad) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&mask);
        PyErr_SetString(PyExc_ValueError,
                        "join_kept_framed: offsets out of range");
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, total);
    if (!out) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&mask);
        return NULL;
    }
    char *dst = PyBytes_AS_STRING(out);
    Py_ssize_t i = 0;
    while (i < n) {
        if (!m[i]) {
            i++;
            continue;
        }
        Py_ssize_t j = i;
        while (j < n && m[j])
            j++;
        Py_ssize_t len = ov[j] - ov[i];
        memcpy(dst, src + ov[i], len);
        dst += len;
        i = j;
    }
    PyBuffer_Release(&payload);
    PyBuffer_Release(&offs);
    PyBuffer_Release(&mask);
    return out;
}


static PyMethodDef Methods[] = {
    {"frame_lines", frame_lines, METH_VARARGS,
     "frame_lines(lines, strip_nl) -> (payload, int32-offsets-bytes,"
     " raw_total)"},
    {"split_frame", split_frame, METH_VARARGS,
     "split_frame(payload, offsets, n) -> list[bytes]"},
    {"find_newlines", find_newlines, METH_VARARGS,
     "find_newlines(data, base) -> int32 after-newline positions"},
    {"join_kept_framed", join_kept_framed, METH_VARARGS,
     "join_kept_framed(payload, offsets, n, mask) -> bytes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_hostops",
    "The collector's host framing and joining for klogs_tpu_torch", -1,
    Methods,
};

PyMODINIT_FUNC
PyInit__hostops(void)
{
    return PyModule_Create(&module);
}
