/* _hostops: the port's host work in C, for klogs_tpu_torch.
 *
 * The port's own copy of functions of the JAX package's
 * klogs_tpu/native/_hostops.c, with their checks:
 *
 *   - the collector's framing and join: find_newlines (:970),
 *     join_kept_framed (:1012), frame_lines (:486) and split_frame
 *     (:540). Offsets ride int32, so a framed buffer past 2 GiB raises
 *     OverflowError, and a mask or offsets array shorter than its count
 *     raises ValueError;
 *   - the host engines of --backend cpu: dfa_scan (:769-968), the flat
 *     DFA table walk of filters/cpu.py DFAFilter; sweep_candidates and
 *     sweep_simd_level (:1193-1973), the indexed engine's literal sweep
 *     with its scalar, SSSE3, AVX2 and AVX-512 stage-1 tiers; and
 *     group_scan with its MultiDFA blob parser (:1974-2504), the
 *     indexed engine's batched confirm stage. The row-parallel helpers
 *     (host_threads, slice_jobs, dispatch_row_jobs; :133-209) come
 *     with them.
 *
 * The JAX file's packers and classifiers (pack_lines, pack_classify*,
 * classify_chunk) are not copied: the card cuts and classifies the rows
 * (ops/csrc/pack_kernels.cu pack_rows, ops/nfa.py classify_chunk).
 *
 * The framing functions hold the GIL and are bound by the host's
 * memory traffic (one memchr sweep or memcpy runs). The three scans
 * release the GIL for the whole scan. The wide stage-1 tiers compile
 * under function target attributes and run only where CPUID reports
 * them, so the library builds with no -march flag on any x86-64 host.
 * Nothing depends on numpy's C API: callers wrap the returned buffers
 * with np.frombuffer.
 *
 * Built at first use by klogs_tpu_torch/native/__init__.py with the
 * host's C compiler (cc -O3 -shared -fPIC -pthread).
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

/* ================= row-parallel dispatch (KLOGS_HOST_THREADS) =======
 *
 * KLOGS_HOST_THREADS=N (N>1) splits a scan's row loop across N pthreads
 * with the GIL RELEASED: the per-row work is pure C over borrowed
 * read-only buffers, and each worker writes a disjoint output range.
 * Unset or 1 keeps the single-threaded scan; the output is the same
 * byte for byte either way. dfa_scan and group_scan dispatch through
 * here.
 */
#include <pthread.h>

static int
host_threads(void)
{
    const char *s = getenv("KLOGS_HOST_THREADS");
    if (!s)
        return 1;
    int n = atoi(s);
    return n < 1 ? 1 : (n > 64 ? 64 : n);
}

/* Clone *proto into jobs[0..count) slices covering [0, rows) in
 * contiguous ranges of ceil(rows/nthreads) rounded up to `align` rows
 * (lane-aligned splits keep interleaved loops on full groups except at
 * each slice's own tail); writes the bounds through the lo/hi field
 * offsets so dfa_job and gs_job share one slicer. Returns the live
 * slice count. */
#include <stddef.h>

static int
slice_jobs(char *jobs, size_t jsz, const void *proto, Py_ssize_t rows,
           int nthreads, Py_ssize_t align, size_t lo_off, size_t hi_off)
{
    Py_ssize_t per = (rows + nthreads - 1) / nthreads;
    per = (per + align - 1) / align * align;
    if (per < 1)
        per = 1;
    int count = 0;
    for (int t = 0; t < nthreads; t++) {
        Py_ssize_t lo = (Py_ssize_t)t * per;
        Py_ssize_t hi = lo + per < rows ? lo + per : rows;
        if (lo >= hi)
            break;
        char *j = jobs + (size_t)count * jsz;
        memcpy(j, proto, jsz);
        *(Py_ssize_t *)(j + lo_off) = lo;
        *(Py_ssize_t *)(j + hi_off) = hi;
        count++;
    }
    return count;
}

/* THE one spawn/join/inline-fallback loop for row-parallel work:
 * jobs[0..count) are pre-sliced clones; the LAST live slice runs
 * inline on this thread, a failed pthread_create runs that slice
 * inline, and every spawned worker is joined before return. Call with
 * the GIL released; job structs must reference no Python objects. */
static void
dispatch_row_jobs(char *jobs, size_t jsz, int count,
                  void *(*worker)(void *), void (*run)(void *))
{
    pthread_t tids[64];
    int started = 0;
    for (int t = 0; t < count; t++) {
        void *j = jobs + (size_t)t * jsz;
        if (t == count - 1) {
            run(j);
            break;
        }
        if (pthread_create(&tids[started], NULL, worker, j) != 0) {
            run(j);
            continue;
        }
        started++;
    }
    for (int t = 0; t < started; t++)
        pthread_join(tids[t], NULL);
}


/* dfa_scan(payload, offsets, n, table, n_classes, accept, byte_class,
 *          start, end_class) -> mask bytes[n]
 *
 * Flat-table DFA scan over a framed batch: one u32 table lookup per
 * byte, early exit on accept: the host engine of --backend cpu
 * (filters/compiler/dfa.py builds the tables; scan_python there is the
 * plain version of this loop). The GIL is released for the whole
 * scan.
 *
 *   table:      u32[n_dfa * n_classes]  (row-major)
 *   accept:     u8[n_dfa]
 *   byte_class: i32[256]
 *   start:      state AFTER the BEGIN sentinel step (checked first)
 *   end_class:  class fed after the last byte ($ handling)
 */
typedef struct {
    const uint8_t *src;
    Py_ssize_t src_len;
    const int32_t *ov;
    const uint16_t *tab16;
    const uint32_t *tab32;
    const uint8_t *accept;
    const int32_t *bc;
    unsigned int start, n_classes, end_class, wide;
    char *out;
    Py_ssize_t lo, hi;          /* row range for this worker */
    int bad;
} dfa_job;

/* The scan body over rows [lo, hi): bound by the dependent load chain
 * (state -> table -> state, ~3ns/byte scalar), so DFA_LANES
 * independent lines interleave to overlap the chains. The u16 path
 * (every practical pattern set) takes the interleaved loop; u32 and
 * the remainder fall through to the scalar loop. Pure C over borrowed
 * buffers — safe with the GIL released and across worker threads. */
#define DFA_LANES 4
static void
dfa_scan_rows(dfa_job *job)
{
    const uint8_t *src = job->src;
    const int32_t *ov = job->ov;
    const uint16_t *tab16 = job->tab16;
    const uint32_t *tab32 = job->tab32;
    const uint8_t *accept = job->accept;
    const int32_t *bc = job->bc;
    const unsigned int start = job->start, n_classes = job->n_classes;
    const unsigned int end_class = job->end_class, wide = job->wide;
    char *out = job->out;
    Py_ssize_t i0 = job->lo;
    if (!wide && job->hi - job->lo >= DFA_LANES) {
        for (; i0 + DFA_LANES <= job->hi && !job->bad; i0 += DFA_LANES) {
            const uint8_t *p[DFA_LANES], *pe[DFA_LANES];
            uint32_t s[DFA_LANES];
            int m[DFA_LANES];
            unsigned active = 0;
            for (int l = 0; l < DFA_LANES; l++) {
                int32_t lo = ov[i0 + l], hi = ov[i0 + l + 1];
                if (lo < 0 || hi < lo || hi > job->src_len) {
                    job->bad = 1;
                    break;
                }
                Py_ssize_t len = hi - lo;
                while (len > 0 && src[lo + len - 1] == '\n')
                    len--;
                p[l] = src + lo;
                pe[l] = p[l] + len;
                s[l] = start;
                m[l] = accept[start];
                if (!m[l] && p[l] < pe[l])
                    active |= 1u << l;
            }
            if (job->bad)
                break;
            while (active) {
                for (int l = 0; l < DFA_LANES; l++) {
                    if (!(active & (1u << l)))
                        continue;
                    s[l] = tab16[s[l] * n_classes + (uint32_t)bc[*p[l]]];
                    p[l]++;
                    if (accept[s[l]]) {
                        m[l] = 1;
                        active &= ~(1u << l);
                    } else if (p[l] == pe[l]) {
                        active &= ~(1u << l);
                    }
                }
            }
            for (int l = 0; l < DFA_LANES; l++) {
                if (!m[l]) {
                    uint32_t sf = tab16[s[l] * n_classes + end_class];
                    m[l] = accept[sf];
                }
                out[i0 + l] = (char)m[l];
            }
        }
    }
    for (Py_ssize_t i = i0; i < job->hi && !job->bad; i++) {
        int32_t lo = ov[i], hi = ov[i + 1];
        if (lo < 0 || hi < lo || hi > job->src_len) {
            job->bad = 1;
            break;
        }
        Py_ssize_t len = hi - lo;
        while (len > 0 && src[lo + len - 1] == '\n')
            len--;
        uint32_t s = start;
        int m = accept[s];
        if (!m) {
            const uint8_t *p = src + lo, *pe = p + len;
            if (wide) {
                for (; p < pe; p++) {
                    s = tab32[s * n_classes + (uint32_t)bc[*p]];
                    if (accept[s]) {
                        m = 1;
                        break;
                    }
                }
                if (!m) {
                    s = tab32[s * n_classes + end_class];
                    m = accept[s];
                }
            } else {
                for (; p < pe; p++) {
                    s = tab16[s * n_classes + (uint32_t)bc[*p]];
                    if (accept[s]) {
                        m = 1;
                        break;
                    }
                }
                if (!m) {
                    s = tab16[s * n_classes + end_class];
                    m = accept[s];
                }
            }
        }
        out[i] = (char)m;
    }
}

static void *
dfa_scan_worker(void *arg)
{
    dfa_scan_rows((dfa_job *)arg);
    return NULL;
}

static void
dfa_scan_run(void *arg)
{
    dfa_scan_rows((dfa_job *)arg);
}

static PyObject *
dfa_scan(PyObject *self, PyObject *args)
{
    Py_buffer payload, offs, table, acc, bclass;
    Py_ssize_t n;
    unsigned int start, n_classes, end_class, wide;
    if (!PyArg_ParseTuple(args, "y*y*ny*Iy*y*III", &payload, &offs, &n,
                          &table, &n_classes, &acc, &bclass,
                          &start, &end_class, &wide))
        return NULL;
    const Py_ssize_t elem = wide ? 4 : 2;
    const Py_ssize_t n_dfa = (Py_ssize_t)(acc.len);
    if (n < 0 || offs.len < (n + 1) * 4 || bclass.len < 256 * 4
        || n_classes == 0 || end_class >= n_classes || start >= n_dfa
        || table.len < n_dfa * (Py_ssize_t)n_classes * elem) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&table);
        PyBuffer_Release(&acc);
        PyBuffer_Release(&bclass);
        PyErr_SetString(PyExc_ValueError, "dfa_scan: bad buffer sizes");
        return NULL;
    }
    PyObject *mask = PyBytes_FromStringAndSize(NULL, n);
    if (!mask) {
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&table);
        PyBuffer_Release(&acc);
        PyBuffer_Release(&bclass);
        return NULL;
    }
    /* KLOGS_HOST_THREADS row-parallel dispatch: the table/accept/byte_class buffers are borrowed
     * and read-only, each worker writes a disjoint out range, so the
     * whole scan runs GIL-free. Small batches stay single-threaded
     * (thread spawn ~10us each would swamp a sub-ms scan). */
    dfa_job job = {(const uint8_t *)payload.buf, payload.len,
                   (const int32_t *)offs.buf,
                   (const uint16_t *)table.buf,
                   (const uint32_t *)table.buf,
                   (const uint8_t *)acc.buf,
                   (const int32_t *)bclass.buf,
                   start, n_classes, end_class, wide,
                   PyBytes_AS_STRING(mask), 0, n, 0};
    int nthreads = host_threads();
    int bad;
    if (nthreads <= 1 || n < 8192) {
        Py_BEGIN_ALLOW_THREADS
        dfa_scan_rows(&job);
        Py_END_ALLOW_THREADS
        bad = job.bad;
    } else {
        dfa_job jobs[64];
        int count = slice_jobs((char *)jobs, sizeof(dfa_job), &job, n,
                               nthreads, DFA_LANES,
                               offsetof(dfa_job, lo),
                               offsetof(dfa_job, hi));
        Py_BEGIN_ALLOW_THREADS
        dispatch_row_jobs((char *)jobs, sizeof(dfa_job), count,
                          dfa_scan_worker, dfa_scan_run);
        Py_END_ALLOW_THREADS
        bad = 0;
        for (int t = 0; t < count; t++)
            bad |= jobs[t].bad;
    }
    PyBuffer_Release(&payload);
    PyBuffer_Release(&offs);
    PyBuffer_Release(&table);
    PyBuffer_Release(&acc);
    PyBuffer_Release(&bclass);
    if (bad) {
        Py_DECREF(mask);
        PyErr_SetString(PyExc_ValueError, "dfa_scan: offsets out of range");
        return NULL;
    }
    return mask;
}

/* ================= SIMD literal sweep (factor-index narrowing) =======
 *
 * sweep_candidates(blob, payload, offsets, n_lines, simd)
 *     -> bytes holding u32[n_lines, GW] little-endian group bitsets
 *
 * Native twin of FactorIndex.group_candidates (filters/compiler/
 * index.py) in the Hyperscan-FDR/Teddy shape: stage 1 is a SIMD shufti
 * over the payload — per byte position, four nibble-LUT lookups AND'd
 * across the first four bytes of every factor's rarest anchored window
 * (8 bucket bits per byte, so unrelated factor families don't dilute
 * each other's predicate; a 3-byte factor's 4th window byte is its
 * don't-care extension -> wildcard position) — then a 64 KiB union-
 * bloom gate on the exact 4-byte code, and only positions surviving
 * BOTH pay the exact two-tier hash probe + masked-word verify. The tables ARE
 * the device SweepProgram's (packed by FactorIndex.native_sweep_blob):
 * narrow tier keyed on the LE 4-byte window code (3-byte factors as
 * 256 one-byte extensions), wide tier on the Fibonacci mix of two
 * chained half-window codes, open-addressed hash probe bounded by
 * max_probe, exact factor verify as masked u32 compares, per-factor
 * group bitset accumulate, always_mask pre-set on every row. Exact
 * verification makes the mask byte-identical to both the numpy and
 * the device sweeps (the three-way parity held by
 * tests/test_torch_native.py and tests/test_torch_indexed.py).
 *
 * Stage 1 comes in two widths (v2 blobs, SH_BUCKETS): the classic
 * 8-bucket plane, and a "fat Teddy" 16-bucket mode (the Hyperscan
 * trick) where a SECOND nibble-mask plane (SH_TEDDY2_OFF) carries
 * buckets 8..15 and a position survives when EITHER plane's AND-chain
 * is nonzero — twice the bucket resolution for one extra shuffle
 * chain, chosen at blob-build time when the factor count would
 * otherwise saturate 8 buckets (FactorIndex.native_sweep_blob).
 *
 * Dispatch: AVX-512BW (64-wide) -> AVX2 (32-wide) -> SSSE3 (16-wide)
 * -> portable scalar (256-entry byte LUTs), resolved at runtime from
 * CPUID and clamped by the caller's `simd` argument
 * (KLOGS_NATIVE_SIMD, parsed in Python). The whole scan — offsets
 * validation, padded copy, stage 1, confirms — runs inside
 * Py_BEGIN_ALLOW_THREADS over borrowed read-only buffers and
 * call-local scratch: the indexed engine's slab pipeline and the
 * coalescer's fetch pool overlap sweeps with group scans, packing and
 * device fetches, and the packed tables are shareable across threads
 * (no statics touched). The optional trailing stats buffer
 * (u64[2] = survivors, positions) is written back only after the
 * scan, under the GIL.
 */

#define SWEEP_MAGIC 0x4B535750  /* "PWSK" little-endian */
#define SWEEP_VERSION 2
#define SWEEP_FIB 2654435761u
#define SWEEP_PAD 128           /* zero tail: widest SIMD load + code/verify overreach */
/* The SIMD kernels scan the source buffer IN PLACE (no full-payload
 * copy): positions below n - SWEEP_TAIL are proven in-bounds for
 * every load the scan and confirm paths issue (widest block 64 + 3
 * shifted planes, 8-byte confirm code, 27-byte verify reach), and the
 * last SWEEP_TAIL positions re-scan from a small zero-padded stack
 * copy with SWEEP_TAIL_LEFT bytes of left context for anchored
 * factor verifies reaching back from a tail position. */
#define SWEEP_TAIL 128
#define SWEEP_TAIL_LEFT 32

/* Header word indexes (i32 each; see FactorIndex.native_sweep_blob).
 * v2 appends SH_BUCKETS/SH_TEDDY2_OFF after SH_TOTAL so every v1
 * word keeps its index. */
enum {
    SH_MAGIC = 0, SH_VERSION, SH_F, SH_NW, SH_GW, SH_G,
    SH_TEDDY_OFF, SH_BLOOM_OFF, SH_ALWAYS_OFF, SH_FACLEN_OFF,
    SH_FACWORDS_OFF, SH_FACWMASK_OFF, SH_FACGROUPS_OFF,
    SH_NARROW = 13,             /* 9 words per tier */
    SH_WIDE = 22,
    SH_TOTAL = 31,
    SH_BUCKETS = 32,            /* 8 or 16 (fat Teddy) */
    SH_TEDDY2_OFF = 33,         /* second bucket plane; 0 when 8-bucket */
    SH_WORDS = 34,
};
#define SWEEP_TEDDY_M 4         /* stage-1 window bytes (shufti AND depth) */
#define SWEEP_BLOOM_SIZE 65536  /* union bloom: fold16 of every probe code */
enum { ST_H = 0, ST_E, ST_NE, ST_MAXPROBE,
       ST_SLOTKEY_OFF, ST_SLOTEID_OFF, ST_BSTART_OFF, ST_FID_OFF,
       ST_ANCHOR_OFF };

typedef struct {
    uint32_t H, E, NE, max_probe, bits;
    const uint32_t *slot_key;   /* [H] */
    const int32_t *slot_eid;    /* [H], -1 = empty */
    const int32_t *bucket_start;  /* [E+1] */
    const int32_t *fid;         /* [NE] */
    const int32_t *anchor;      /* [NE] */
} sweep_tier_c;

typedef struct {
    int32_t F, NW, GW, G;
    sweep_tier_c narrow, wide;
    const int32_t *fac_len;     /* [F] */
    const uint32_t *fac_words;  /* [F, NW] LE */
    const uint32_t *fac_wmask;  /* [F, NW] */
    const uint32_t *fac_groups; /* [F, GW] */
    const uint32_t *always;     /* [GW] */
    const uint8_t *teddy;       /* [M][2][16] nibble masks, buckets 0..7 */
    const uint8_t *teddy2;      /* [M][2][16] buckets 8..15; NULL when thin */
    const uint8_t *bloom;       /* [65536] union bloom over probe codes */
} sweep_prog_c;

static inline uint32_t
sweep_le32(const uint8_t *p)
{
    uint32_t v;
    memcpy(&v, p, 4);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    v = __builtin_bswap32(v);
#endif
    return v;
}

/* Bounds-checked array slice out of the blob; returns NULL on a
 * malformed offset (caller maps to ValueError). */
static const void *
sweep_arr(const char *blob, Py_ssize_t blen, int32_t off, int64_t count,
          int64_t elem)
{
    if (off < 0 || (off & 3) || count < 0
        || (int64_t)off + count * elem > (int64_t)blen)
        return NULL;
    return blob + off;
}

static int
sweep_parse_tier(const char *blob, Py_ssize_t blen, const int32_t *h,
                 sweep_tier_c *t)
{
    t->H = (uint32_t)h[ST_H];
    t->E = (uint32_t)h[ST_E];
    t->NE = (uint32_t)h[ST_NE];
    t->max_probe = (uint32_t)h[ST_MAXPROBE];
    if (t->H & (t->H - 1))
        return -1;              /* hash size must be a power of two */
    t->bits = 0;
    for (uint32_t x = t->H; x > 1; x >>= 1)
        t->bits++;
    /* A probeable tier needs H >= 2: bits=0 would make the probe's
     * `>> (32 - bits)` a shift-by-32 (UB). Internally packed tables
     * are always H >= 16; this guards the untrusted-blob contract. */
    if (t->max_probe > t->H || t->bits >= 32
        || (t->max_probe && t->H < 2))
        return -1;
    t->slot_key = sweep_arr(blob, blen, h[ST_SLOTKEY_OFF], t->H, 4);
    t->slot_eid = sweep_arr(blob, blen, h[ST_SLOTEID_OFF], t->H, 4);
    t->bucket_start = sweep_arr(blob, blen, h[ST_BSTART_OFF],
                                (int64_t)t->E + 1, 4);
    t->fid = sweep_arr(blob, blen, h[ST_FID_OFF], t->NE, 4);
    t->anchor = sweep_arr(blob, blen, h[ST_ANCHOR_OFF], t->NE, 4);
    if (!t->slot_key || !t->slot_eid || !t->bucket_start || !t->fid
        || !t->anchor)
        return -1;
    return 0;
}

static int
sweep_parse_blob(const char *blob, Py_ssize_t blen, sweep_prog_c *sp)
{
    if (blen < SH_WORDS * 4)
        return -1;
    const int32_t *h = (const int32_t *)blob;
    if (h[SH_MAGIC] != SWEEP_MAGIC || h[SH_VERSION] != SWEEP_VERSION
        || h[SH_TOTAL] != (int32_t)blen)
        return -1;
    sp->F = h[SH_F];
    sp->NW = h[SH_NW];
    sp->GW = h[SH_GW];
    sp->G = h[SH_G];
    if (sp->F < 1 || sp->NW < 1 || sp->GW < 1 || sp->G < 1)
        return -1;
    sp->teddy = sweep_arr(blob, blen, h[SH_TEDDY_OFF],
                          SWEEP_TEDDY_M * 32, 1);
    /* Bucket mode: 8 packs a zero second-plane offset (rejected if
     * nonzero — a stale packer would smuggle an unread plane); 16
     * requires the second plane to slice cleanly out of the blob. */
    if (h[SH_BUCKETS] == 8) {
        if (h[SH_TEDDY2_OFF] != 0)
            return -1;
        sp->teddy2 = NULL;
    } else if (h[SH_BUCKETS] == 16) {
        sp->teddy2 = sweep_arr(blob, blen, h[SH_TEDDY2_OFF],
                               SWEEP_TEDDY_M * 32, 1);
        if (!sp->teddy2)
            return -1;
    } else {
        return -1;
    }
    sp->bloom = sweep_arr(blob, blen, h[SH_BLOOM_OFF],
                          SWEEP_BLOOM_SIZE, 1);
    sp->always = sweep_arr(blob, blen, h[SH_ALWAYS_OFF], sp->GW, 4);
    sp->fac_len = sweep_arr(blob, blen, h[SH_FACLEN_OFF], sp->F, 4);
    sp->fac_words = sweep_arr(blob, blen, h[SH_FACWORDS_OFF],
                              (int64_t)sp->F * sp->NW, 4);
    sp->fac_wmask = sweep_arr(blob, blen, h[SH_FACWMASK_OFF],
                              (int64_t)sp->F * sp->NW, 4);
    sp->fac_groups = sweep_arr(blob, blen, h[SH_FACGROUPS_OFF],
                               (int64_t)sp->F * sp->GW, 4);
    if (!sp->teddy || !sp->bloom || !sp->always || !sp->fac_len
        || !sp->fac_words || !sp->fac_wmask || !sp->fac_groups)
        return -1;
    if (sweep_parse_tier(blob, blen, (const int32_t *)blob + SH_NARROW,
                         &sp->narrow) < 0
        || sweep_parse_tier(blob, blen, (const int32_t *)blob + SH_WIDE,
                            &sp->wide) < 0)
        return -1;
    /* Entry tables index factors and buckets; validate once here so
     * the hot confirm loop can trust them. */
    for (int tix = 0; tix < 2; tix++) {
        const sweep_tier_c *t = tix ? &sp->wide : &sp->narrow;
        for (uint32_t i = 0; i < t->H; i++)
            if (t->slot_eid[i] >= (int32_t)t->E)
                return -1;
        for (uint32_t i = 0; i <= t->E; i++)
            if (t->bucket_start[i] < 0
                || t->bucket_start[i] > (int32_t)t->NE
                || (i && t->bucket_start[i] < t->bucket_start[i - 1]))
                return -1;
        for (uint32_t i = 0; i < t->NE; i++)
            if (t->fid[i] < 0 || t->fid[i] >= sp->F || t->anchor[i] < 0
                /* anchors sit inside the factor (<= cap 24 - window),
                 * so the verify never reaches further left than the
                 * tail copy's SWEEP_TAIL_LEFT margin */
                || t->anchor[i] > SWEEP_TAIL_LEFT - 8)
                return -1;
    }
    /* fac_len 0 is the zero-factor index's padding row (never
     * referenced by any tier entry — both tiers are empty there). */
    for (int32_t i = 0; i < sp->F; i++)
        if (sp->fac_len[i] < 0 || (sp->fac_len[i] + 3) / 4 > sp->NW)
            return -1;
    return 0;
}

/* Exact resolution of one stage-1 survivor against one tier: hash
 * probe -> bucket run -> masked-word factor verify -> line bounds ->
 * group bitset accumulate. Mirrors FactorIndex._emit exactly: the
 * line is the one containing the FACTOR START q (not the probe
 * window), and the factor's own bytes must sit inside it.
 *
 * Positions are GLOBAL payload offsets; the byte at global index g
 * lives at buf[g - bias] (bias = 0 when scanning the source buffer
 * directly, nonzero for the zero-padded tail copy). 4-byte loads are
 * valid while they end at or before load_end; past it, bytes are
 * assembled one at a time with zeros beyond n — same value the old
 * full-payload zero-padded copy produced. */
static void
sweep_probe_tier(const sweep_prog_c *sp, const sweep_tier_c *t,
                 uint32_t key, const uint8_t *buf, Py_ssize_t bias,
                 Py_ssize_t n, Py_ssize_t load_end, const int32_t *ov,
                 Py_ssize_t B, Py_ssize_t pos, uint32_t *out)
{
    uint32_t h = (uint32_t)(key * SWEEP_FIB) >> (32 - t->bits);
    int32_t eid = -1;
    for (uint32_t j = 0; j < t->max_probe; j++) {
        uint32_t s = (h + j) & (t->H - 1);
        int32_t e = t->slot_eid[s];
        if (e < 0)
            return;             /* empty slot ends the probe cluster */
        if (t->slot_key[s] == key) {
            eid = e;
            break;
        }
    }
    if (eid < 0)
        return;
    for (int32_t bi = t->bucket_start[eid]; bi < t->bucket_start[eid + 1];
         bi++) {
        int32_t fi = t->fid[bi];
        Py_ssize_t q = pos - t->anchor[bi];
        int32_t L = sp->fac_len[fi];
        if (q < bias || q + L > n)
            continue;
        int32_t W = (L + 3) / 4;
        int ok = 1;
        for (int32_t w = 0; w < W; w++) {
            Py_ssize_t a = q + 4 * (Py_ssize_t)w;
            uint32_t vw;
            if (a + 4 <= load_end) {
                vw = sweep_le32(buf + (a - bias));
            } else {
                uint8_t tb[4] = {0, 0, 0, 0};
                for (int z = 0; z < 4 && a + z < n; z++)
                    tb[z] = buf[a + z - bias];
                vw = sweep_le32(tb);
            }
            if ((vw & sp->fac_wmask[(size_t)fi * sp->NW + w])
                != sp->fac_words[(size_t)fi * sp->NW + w]) {
                ok = 0;
                break;
            }
        }
        if (!ok || q < ov[0])
            continue;
        /* Largest line with ov[line] <= q (searchsorted right - 1). */
        Py_ssize_t a = 0, b = B + 1;
        while (b - a > 1) {
            Py_ssize_t m = a + (b - a) / 2;
            if ((Py_ssize_t)ov[m] <= q)
                a = m;
            else
                b = m;
        }
        if (a >= B || q + L > (Py_ssize_t)ov[a + 1])
            continue;
        uint32_t *row = out + (size_t)a * sp->GW;
        for (int32_t k = 0; k < sp->GW; k++)
            row[k] |= sp->fac_groups[(size_t)fi * sp->GW + k];
    }
}

/* Caller guarantees 8 readable bytes at the survivor position:
 * main-region positions sit >= SWEEP_TAIL bytes before the payload
 * end, tail positions read the zero-padded tail copy. */
static void
sweep_confirm(const sweep_prog_c *sp, const uint8_t *buf,
              Py_ssize_t bias, Py_ssize_t n, Py_ssize_t load_end,
              const int32_t *ov, Py_ssize_t B, Py_ssize_t pos,
              uint32_t *out)
{
    /* Union-bloom gate first (fold16 of the position's 4-byte code,
     * covering BOTH tiers' probe codes — the numpy sweep's stage-1
     * twin): the nibble-LUT stage over-approximates heavily on
     * digit-dense corpora, and this one multiply + cache-resident
     * byte load rules out ~95% of its survivors before any hash
     * probe is paid. */
    const uint8_t *p = buf + (pos - bias);
    uint32_t code = sweep_le32(p);
    if (!sp->bloom[(uint32_t)(code * SWEEP_FIB) >> 16])
        return;
    if (sp->narrow.max_probe)
        sweep_probe_tier(sp, &sp->narrow, code, buf, bias, n,
                         load_end, ov, B, pos, out);
    if (sp->wide.max_probe) {
        uint32_t lo = sweep_le32(p + 4);
        sweep_probe_tier(sp, &sp->wide,
                         (uint32_t)(code * SWEEP_FIB) ^ lo,
                         buf, bias, n, load_end, ov, B, pos, out);
    }
}

/* Portable scalar stage 1: the nibble masks expanded once into
 * 256-entry byte LUTs (cache-resident), then 4 loads + 3 ANDs per
 * position (per bucket plane). Also the tail/readability reference
 * for the SIMD paths: a position survives when ANY plane's AND-chain
 * is nonzero, and every survivor bumps *nsurv (the stage-1
 * survivor-ratio telemetry) before paying its confirm. */
static void
sweep_scan_scalar(const sweep_prog_c *sp, const uint8_t *pad,
                  Py_ssize_t scan_n, Py_ssize_t n, const int32_t *ov,
                  Py_ssize_t B, uint32_t *out, uint64_t *nsurv)
{
    const int fat = sp->teddy2 != NULL;
    uint8_t lut[SWEEP_TEDDY_M][256], lut2[SWEEP_TEDDY_M][256];
    for (int j = 0; j < SWEEP_TEDDY_M; j++) {
        const uint8_t *lo = sp->teddy + j * 32;
        const uint8_t *hi = lo + 16;
        for (int c = 0; c < 256; c++)
            lut[j][c] = (uint8_t)(lo[c & 15] & hi[c >> 4]);
        if (fat) {
            const uint8_t *lo2 = sp->teddy2 + j * 32;
            const uint8_t *hi2 = lo2 + 16;
            for (int c = 0; c < 256; c++)
                lut2[j][c] = (uint8_t)(lo2[c & 15] & hi2[c >> 4]);
        }
    }
    for (Py_ssize_t i = 0; i < scan_n; i++) {
        unsigned v = lut[0][pad[i]] & lut[1][pad[i + 1]]
            & lut[2][pad[i + 2]] & lut[3][pad[i + 3]];
        if (fat)
            v |= lut2[0][pad[i]] & lut2[1][pad[i + 1]]
                & lut2[2][pad[i + 2]] & lut2[3][pad[i + 3]];
        if (v) {
            (*nsurv)++;
            sweep_confirm(sp, pad, 0, n, n, ov, B, i, out);
        }
    }
}

/* Scalar sweep of the last global positions [lo, n): buf is a small
 * stack copy of payload[bias:n] followed by SWEEP_PAD zeros, so every
 * load the confirm path issues is in-bounds and bytes past n read 0 —
 * bit-identical to the old full-payload zero-padded copy. At most
 * SWEEP_TAIL positions, so the plain nibble-mask test (no LUT build)
 * is cheapest. */
static void
sweep_scan_tail(const sweep_prog_c *sp, const uint8_t *buf,
                Py_ssize_t bias, Py_ssize_t lo, Py_ssize_t n,
                const int32_t *ov, Py_ssize_t B, uint32_t *out,
                uint64_t *nsurv)
{
    const int fat = sp->teddy2 != NULL;
    for (Py_ssize_t g = lo; g < n; g++) {
        const uint8_t *p = buf + (g - bias);
        unsigned v = 0xff;
        for (int j = 0; j < SWEEP_TEDDY_M; j++) {
            const uint8_t *m = sp->teddy + j * 32;
            v &= m[p[j] & 15] & m[16 + (p[j] >> 4)];
        }
        if (fat) {
            unsigned v2 = 0xff;
            for (int j = 0; j < SWEEP_TEDDY_M; j++) {
                const uint8_t *m = sp->teddy2 + j * 32;
                v2 &= m[p[j] & 15] & m[16 + (p[j] >> 4)];
            }
            v |= v2;
        }
        if (v) {
            (*nsurv)++;
            sweep_confirm(sp, buf, bias, n,
                          n + SWEEP_PAD - 8, ov, B, g, out);
        }
    }
}

#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#define SWEEP_HAVE_X86 1
#include <immintrin.h>

__attribute__((target("ssse3"))) static void
sweep_scan_ssse3(const sweep_prog_c *sp, const uint8_t *pad,
                 Py_ssize_t scan_n, Py_ssize_t n, const int32_t *ov,
                 Py_ssize_t B, uint32_t *out, uint64_t *nsurv)
{
    const __m128i lowm = _mm_set1_epi8(0x0f);
    const int fat = sp->teddy2 != NULL;
    __m128i tl[SWEEP_TEDDY_M], th[SWEEP_TEDDY_M];
    __m128i tl2[SWEEP_TEDDY_M], th2[SWEEP_TEDDY_M];
    for (int j = 0; j < SWEEP_TEDDY_M; j++) {
        tl[j] = _mm_loadu_si128((const __m128i *)(sp->teddy + j * 32));
        th[j] = _mm_loadu_si128(
            (const __m128i *)(sp->teddy + j * 32 + 16));
        tl2[j] = th2[j] = _mm_setzero_si128();
        if (fat) {
            tl2[j] = _mm_loadu_si128(
                (const __m128i *)(sp->teddy2 + j * 32));
            th2[j] = _mm_loadu_si128(
                (const __m128i *)(sp->teddy2 + j * 32 + 16));
        }
    }
    for (Py_ssize_t i = 0; i < scan_n; i += 16) {
        __m128i m = _mm_set1_epi8((char)0xff);
        __m128i m2 = m;
        for (int j = 0; j < SWEEP_TEDDY_M; j++) {
            __m128i d = _mm_loadu_si128((const __m128i *)(pad + i + j));
            __m128i lx = _mm_and_si128(d, lowm);
            __m128i hx = _mm_and_si128(_mm_srli_epi16(d, 4), lowm);
            m = _mm_and_si128(m, _mm_and_si128(
                _mm_shuffle_epi8(tl[j], lx),
                _mm_shuffle_epi8(th[j], hx)));
            if (fat)
                m2 = _mm_and_si128(m2, _mm_and_si128(
                    _mm_shuffle_epi8(tl2[j], lx),
                    _mm_shuffle_epi8(th2[j], hx)));
        }
        if (fat)
            m = _mm_or_si128(m, m2);
        int bits = _mm_movemask_epi8(
            _mm_cmpeq_epi8(m, _mm_setzero_si128())) ^ 0xffff;
        while (bits) {
            int b = __builtin_ctz((unsigned)bits);
            bits &= bits - 1;
            Py_ssize_t pos = i + b;
            if (pos < scan_n) {
                (*nsurv)++;
                sweep_confirm(sp, pad, 0, n, n, ov, B, pos, out);
            }
        }
    }
}

__attribute__((target("avx2"))) static void
sweep_scan_avx2(const sweep_prog_c *sp, const uint8_t *pad,
                Py_ssize_t scan_n, Py_ssize_t n, const int32_t *ov,
                Py_ssize_t B, uint32_t *out, uint64_t *nsurv)
{
    const __m256i lowm = _mm256_set1_epi8(0x0f);
    const int fat = sp->teddy2 != NULL;
    __m256i tl[SWEEP_TEDDY_M], th[SWEEP_TEDDY_M];
    __m256i tl2[SWEEP_TEDDY_M], th2[SWEEP_TEDDY_M];
    for (int j = 0; j < SWEEP_TEDDY_M; j++) {
        tl[j] = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)(sp->teddy + j * 32)));
        th[j] = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)(sp->teddy + j * 32 + 16)));
        tl2[j] = th2[j] = _mm256_setzero_si256();
        if (fat) {
            tl2[j] = _mm256_broadcastsi128_si256(_mm_loadu_si128(
                (const __m128i *)(sp->teddy2 + j * 32)));
            th2[j] = _mm256_broadcastsi128_si256(_mm_loadu_si128(
                (const __m128i *)(sp->teddy2 + j * 32 + 16)));
        }
    }
    for (Py_ssize_t i = 0; i < scan_n; i += 32) {
        __m256i m = _mm256_set1_epi8((char)0xff);
        __m256i m2 = m;
        for (int j = 0; j < SWEEP_TEDDY_M; j++) {
            __m256i d = _mm256_loadu_si256(
                (const __m256i *)(pad + i + j));
            __m256i lx = _mm256_and_si256(d, lowm);
            __m256i hx = _mm256_and_si256(_mm256_srli_epi16(d, 4),
                                          lowm);
            m = _mm256_and_si256(m, _mm256_and_si256(
                _mm256_shuffle_epi8(tl[j], lx),
                _mm256_shuffle_epi8(th[j], hx)));
            if (fat)
                m2 = _mm256_and_si256(m2, _mm256_and_si256(
                    _mm256_shuffle_epi8(tl2[j], lx),
                    _mm256_shuffle_epi8(th2[j], hx)));
        }
        if (fat)
            m = _mm256_or_si256(m, m2);
        uint32_t bits = ~(uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(m, _mm256_setzero_si256()));
        while (bits) {
            int b = __builtin_ctz(bits);
            bits &= bits - 1;
            Py_ssize_t pos = i + b;
            if (pos < scan_n) {
                (*nsurv)++;
                sweep_confirm(sp, pad, 0, n, n, ov, B, pos, out);
            }
        }
    }
}

/* 64 positions per iteration; the bucket planes live broadcast in
 * zmm registers and the survivor bitmap falls straight out of
 * _mm512_test_epi8_mask — no compare-against-zero + movemask pair. */
__attribute__((target("avx512f,avx512bw"))) static void
sweep_scan_avx512(const sweep_prog_c *sp, const uint8_t *pad,
                  Py_ssize_t scan_n, Py_ssize_t n, const int32_t *ov,
                  Py_ssize_t B, uint32_t *out, uint64_t *nsurv)
{
    const __m512i lowm = _mm512_set1_epi8(0x0f);
    const int fat = sp->teddy2 != NULL;
    __m512i tl[SWEEP_TEDDY_M], th[SWEEP_TEDDY_M];
    __m512i tl2[SWEEP_TEDDY_M], th2[SWEEP_TEDDY_M];
    for (int j = 0; j < SWEEP_TEDDY_M; j++) {
        tl[j] = _mm512_broadcast_i32x4(
            _mm_loadu_si128((const __m128i *)(sp->teddy + j * 32)));
        th[j] = _mm512_broadcast_i32x4(
            _mm_loadu_si128((const __m128i *)(sp->teddy + j * 32 + 16)));
        tl2[j] = th2[j] = _mm512_setzero_si512();
        if (fat) {
            tl2[j] = _mm512_broadcast_i32x4(_mm_loadu_si128(
                (const __m128i *)(sp->teddy2 + j * 32)));
            th2[j] = _mm512_broadcast_i32x4(_mm_loadu_si128(
                (const __m128i *)(sp->teddy2 + j * 32 + 16)));
        }
    }
    for (Py_ssize_t i = 0; i < scan_n; i += 64) {
        __m512i m = _mm512_set1_epi8((char)0xff);
        __m512i m2 = m;
        for (int j = 0; j < SWEEP_TEDDY_M; j++) {
            __m512i d = _mm512_loadu_si512(
                (const void *)(pad + i + j));
            __m512i lx = _mm512_and_si512(d, lowm);
            __m512i hx = _mm512_and_si512(_mm512_srli_epi16(d, 4),
                                          lowm);
            m = _mm512_and_si512(m, _mm512_and_si512(
                _mm512_shuffle_epi8(tl[j], lx),
                _mm512_shuffle_epi8(th[j], hx)));
            if (fat)
                m2 = _mm512_and_si512(m2, _mm512_and_si512(
                    _mm512_shuffle_epi8(tl2[j], lx),
                    _mm512_shuffle_epi8(th2[j], hx)));
        }
        uint64_t bits = (uint64_t)_mm512_test_epi8_mask(m, m);
        if (fat)
            bits |= (uint64_t)_mm512_test_epi8_mask(m2, m2);
        while (bits) {
            int b = __builtin_ctzll(bits);
            bits &= bits - 1;
            Py_ssize_t pos = i + b;
            if (pos < scan_n) {
                (*nsurv)++;
                sweep_confirm(sp, pad, 0, n, n, ov, B, pos, out);
            }
        }
    }
}

static int
sweep_cpu_level(void)
{
    if (__builtin_cpu_supports("avx512f")
        && __builtin_cpu_supports("avx512bw"))
        return 3;
    if (__builtin_cpu_supports("avx2"))
        return 2;
    if (__builtin_cpu_supports("ssse3"))
        return 1;
    return 0;
}
#else
static int
sweep_cpu_level(void)
{
    return 0;
}
#endif

/* requested: -1 auto, 0 scalar, 1 ssse3, 2 avx2, 3 avx512 — clamped
 * to what the CPU actually has, so a pinned KLOGS_NATIVE_SIMD=avx512
 * on an old box degrades to the best real level instead of
 * faulting. */
static int
sweep_resolve_level(int requested)
{
    int cpu = sweep_cpu_level();
    if (requested < 0 || requested > cpu)
        return cpu;
    return requested;
}

static PyObject *
sweep_simd_level(PyObject *self, PyObject *args)
{
    int requested = -1;
    if (!PyArg_ParseTuple(args, "|i", &requested))
        return NULL;
    return PyLong_FromLong(sweep_resolve_level(requested));
}

static PyObject *
sweep_candidates(PyObject *self, PyObject *args)
{
    Py_buffer blob, payload, offs, stats;
    Py_ssize_t B;
    int requested;
    stats.obj = NULL;
    stats.buf = NULL;
    if (!PyArg_ParseTuple(args, "y*y*y*ni|w*", &blob, &payload, &offs,
                          &B, &requested, &stats))
        return NULL;
    sweep_prog_c sp;
    if (B < 0 || offs.len < (B + 1) * 4
        || (stats.obj && stats.len < 16)
        || sweep_parse_blob((const char *)blob.buf, blob.len, &sp) < 0) {
        PyBuffer_Release(&blob);
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&stats);
        PyErr_SetString(PyExc_ValueError,
                        "sweep_candidates: malformed tables or sizes");
        return NULL;
    }
    const Py_ssize_t n = payload.len;
    PyObject *mask = PyBytes_FromStringAndSize(
        NULL, B * (Py_ssize_t)sp.GW * 4);
    if (!mask) {
        PyBuffer_Release(&blob);
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&stats);
        return PyErr_NoMemory();
    }
    const int32_t *ov = (const int32_t *)offs.buf;
    uint32_t *out = (uint32_t *)PyBytes_AS_STRING(mask);
    int level = sweep_resolve_level(requested);
    uint64_t nsurv = 0;
    int bad = 0;

    Py_BEGIN_ALLOW_THREADS
    /* Offsets must be non-decreasing within the payload: the confirm
     * loop's binary search trusts them. */
    if (ov[0] < 0 || (Py_ssize_t)ov[B] > n)
        bad = 1;
    for (Py_ssize_t i = 0; i < B && !bad; i++)
        if (ov[i] > ov[i + 1])
            bad = 1;
    if (!bad) {
        /* Every row starts as the always-candidate mask (groups owning
         * unguarded patterns), exactly like the host sweep. */
        for (Py_ssize_t i = 0; i < B; i++)
            memcpy(out + (size_t)i * sp.GW, sp.always,
                   (size_t)sp.GW * 4);
        if (n >= 3) {
            /* In-place scan of the source buffer up to scan_n (every
             * load proven in-bounds there — see SWEEP_TAIL), then the
             * last positions from a small zero-padded stack copy.
             * Replaces a full-payload copy that cost ~1 ms per 8 MB
             * slab in malloc page faults + memcpy. */
            const uint8_t *src = (const uint8_t *)payload.buf;
            Py_ssize_t scan_n = n > SWEEP_TAIL ? n - SWEEP_TAIL : 0;
            if (scan_n) {
#if SWEEP_HAVE_X86
                if (level >= 3)
                    sweep_scan_avx512(&sp, src, scan_n, n, ov, B, out,
                                      &nsurv);
                else if (level == 2)
                    sweep_scan_avx2(&sp, src, scan_n, n, ov, B, out,
                                    &nsurv);
                else if (level == 1)
                    sweep_scan_ssse3(&sp, src, scan_n, n, ov, B, out,
                                     &nsurv);
                else
                    sweep_scan_scalar(&sp, src, scan_n, n, ov, B, out,
                                      &nsurv);
#else
                (void)level;
                sweep_scan_scalar(&sp, src, scan_n, n, ov, B, out,
                                  &nsurv);
#endif
            }
            uint8_t tbuf[SWEEP_TAIL_LEFT + SWEEP_TAIL + SWEEP_PAD];
            Py_ssize_t tbase = scan_n > SWEEP_TAIL_LEFT
                ? scan_n - SWEEP_TAIL_LEFT : 0;
            memcpy(tbuf, src + tbase, (size_t)(n - tbase));
            memset(tbuf + (n - tbase), 0, SWEEP_PAD);
            sweep_scan_tail(&sp, tbuf, tbase, scan_n, n, ov, B, out,
                            &nsurv);
        }
    }
    Py_END_ALLOW_THREADS

    if (!bad && stats.obj) {
        /* u64[2] = [stage-1 survivors, scanned byte positions]: the
         * survivor-ratio telemetry BENCH_SWEEP reports. Written under
         * the GIL, after the scan — the caller owns the buffer and
         * must not share it across in-flight sweeps. */
        uint64_t sb[2];
        sb[0] = nsurv;
        sb[1] = (uint64_t)n;
        memcpy(stats.buf, sb, sizeof sb);
        const size_t nbits = (size_t)sp.GW * 32;
        if ((size_t)stats.len >= (3 + nbits) * 8) {
            /* Extended layout u64[3 + 32*GW]: [2] = lines with any
             * candidate bit, [3+g] = per-group candidate column sums.
             * A ctz walk over the packed mask costs ~total-set-bits;
             * the equivalent numpy axis-0 reduction over the unpacked
             * [B, G] matrix measured ~4-6 ms/slab at K=1024. */
            uint64_t *sbx = (uint64_t *)stats.buf;
            uint64_t lines = 0;
            uint64_t *colsum = sbx + 3;
            memset(colsum, 0, nbits * 8);
            for (Py_ssize_t i = 0; i < B; i++) {
                const uint32_t *row = out + (size_t)i * sp.GW;
                uint32_t any = 0;
                for (int32_t w = 0; w < sp.GW; w++) {
                    uint32_t v = row[w];
                    any |= v;
                    while (v) {
                        colsum[w * 32 + __builtin_ctz(v)]++;
                        v &= v - 1;
                    }
                }
                lines += any != 0;
            }
            sbx[2] = lines;
        }
    }
    PyBuffer_Release(&blob);
    PyBuffer_Release(&payload);
    PyBuffer_Release(&offs);
    PyBuffer_Release(&stats);
    if (bad) {
        Py_DECREF(mask);
        PyErr_SetString(PyExc_ValueError,
                        "sweep_candidates: offsets out of range");
        return NULL;
    }
    return mask;
}

/* ================= MultiDFA batched group scan =======================
 *
 * group_scan(blob, payload, offsets, n_lines, cand, stride, cols,
 *            order, out, packed=0) -> scanned candidate cells (int)
 *
 * The "confirm" stage of the indexed engine done in one native call
 * (Hyperscan-FDR shape; filters/indexed.py): instead of a Python loop
 * dispatching one dfa_scan per candidate GROUP — each paying a gathered
 * sub-frame copy and its own GIL round-trip — every DFA-backed group's
 * flat scan tables travel in ONE MultiDFA program blob
 * (FactorIndex-side builder: filters/compiler/index.py multidfa_blob)
 * and this kernel walks all (row, group) candidate cells in place via
 * the framed offsets: zero sub-frame copies, one native call per slab.
 *
 *   blob:    MultiDFA program (validated header below; native byte
 *            order — the blob is process-local, never persisted)
 *   payload: framed slab bytes (borrowed, read-only)
 *   offsets: i32[n_lines+1] exclusive prefix offsets
 *   cand:    u8[n_lines, stride] candidate matrix (0 = the sweep
 *            ruled the cell out). `stride` + `cols` let the engine
 *            pass its FULL [B, n_groups] bool group matrix with zero
 *            copies: member m's candidate column is cand[., cols[m]].
 *            With packed=1 cand is instead the sweep kernel's RAW
 *            u32[n_lines, stride] group bitset (member m's candidacy
 *            is bit cols[m]&31 of word cols[m]>>5) — no host-side
 *            unpackbits at all; a single ctz walk over the masked
 *            words builds every member's candidate row list up front
 *            instead of re-reading all rows once per member.
 *   order:   i32[M] scan order over members (the engine passes
 *            ascending candidate count: most selective first, so
 *            always-candidate groups run last and inherit every
 *            earlier accept as an early-out)
 *   out:     u8[n_lines] verdict bytes, WRITABLE, monotonic 0->1 only
 *            (rows already 1 on entry are skipped entirely)
 *
 * Group-major walk with exact early-out: members run in `order`; each
 * member scans the candidate rows no earlier member accepted. That is
 * cell-for-cell the same skip set as a row-major walk (each (row,
 * member) cell runs iff no member earlier in `order` accepted the
 * row) but keeps one member's tables hot in cache across its whole
 * run. Parallelism reuses the slice_jobs/dispatch_row_jobs machinery
 * over ROW ranges — each worker owns a disjoint slice of rows and
 * with it that slice's verdict bytes, so the shared `out` array sees
 * monotonic, non-racing writes by construction and the early-out is
 * exact (not opportunistic). The whole walk runs inside
 * Py_BEGIN_ALLOW_THREADS over borrowed read-only buffers + the
 * caller-owned out buffer.
 *
 * Start-state acceleration (Hyperscan "accel state" shape): at parse
 * time each member's start-state row is scanned for its ESCAPE bytes
 * — bytes whose class leaves the start state. A member with <= 2
 * escape bytes runs a memchr-driven loop: while the automaton sits in
 * its start state, memchr jumps straight to the next escape byte
 * (every skipped byte provably self-loops), and the table walk only
 * runs from there until the state falls back to start. On literal-ish
 * patterns the scan approaches memchr speed instead of the ~1 GB/s
 * dependent-load table walk; the state trajectory is identical by
 * construction.
 *
 * Per-cell semantics are exactly dfa_scan's scalar loop (strip
 * trailing '\n', start state after BEGIN, accept latched per byte,
 * end_class step last, match_all short-circuit) — so the per-group
 * dfa_scan path is this kernel's parity oracle, cell for cell. State
 * ids loaded from the (untrusted-bytes) tables are bounds-checked in
 * the loop before use: a corrupt blob raises, never reads out of
 * bounds.
 */

#define MDFA_MAGIC 0x4B4D4446   /* "FDMK" little-endian */
#define MDFA_VERSION 1
/* Header word indexes (i32; see multidfa_blob in compiler/index.py). */
enum { MH_MAGIC = 0, MH_VERSION, MH_M, MH_TOTAL, MH_WORDS = 8 };
/* Per-member descriptor words following the header. */
enum { MD_NDFA = 0, MD_NCLASSES, MD_START, MD_ENDCLASS, MD_WIDE,
       MD_MATCHALL, MD_TABLE_OFF, MD_ACCEPT_OFF, MD_BCLASS_OFF,
       MD_WORDS = 10 };

#define MDFA_MAX_ESC 2          /* accel only for <= 2 escape bytes */

typedef struct {
    int32_t n_dfa, n_classes, start, end_class, wide, match_all;
    const uint16_t *tab16;      /* [n_dfa * n_classes] when !wide */
    const uint32_t *tab32;      /* [n_dfa * n_classes] when wide */
    const uint8_t *accept;      /* [n_dfa] */
    const int32_t *bc;          /* [256], entries < n_classes */
    int esc_n;                  /* start-state escape bytes (-1 = many) */
    uint8_t esc[MDFA_MAX_ESC];
} mdfa_member;

static int
mdfa_parse_blob(const char *blob, Py_ssize_t blen, int32_t *m_out,
                mdfa_member **members_out)
{
    if (blen < MH_WORDS * 4)
        return -1;
    const int32_t *h = (const int32_t *)blob;
    if (h[MH_MAGIC] != MDFA_MAGIC || h[MH_VERSION] != MDFA_VERSION
        || h[MH_TOTAL] != (int32_t)blen)
        return -1;
    int32_t M = h[MH_M];
    if (M < 1
        || (int64_t)MH_WORDS * 4 + (int64_t)M * MD_WORDS * 4 > (int64_t)blen)
        return -1;
    mdfa_member *mem = PyMem_Malloc((size_t)M * sizeof(mdfa_member));
    if (!mem)
        return -1;
    for (int32_t m = 0; m < M; m++) {
        const int32_t *d = h + MH_WORDS + (size_t)m * MD_WORDS;
        mdfa_member *mm = &mem[m];
        mm->n_dfa = d[MD_NDFA];
        mm->n_classes = d[MD_NCLASSES];
        mm->start = d[MD_START];
        mm->end_class = d[MD_ENDCLASS];
        mm->wide = d[MD_WIDE];
        mm->match_all = d[MD_MATCHALL];
        if (mm->n_dfa < 1 || mm->n_classes < 1
            || mm->start < 0 || mm->start >= mm->n_dfa
            || mm->end_class < 0 || mm->end_class >= mm->n_classes
            || (mm->wide != 0 && mm->wide != 1)
            || (mm->match_all != 0 && mm->match_all != 1)) {
            PyMem_Free(mem);
            return -1;
        }
        const void *tab = sweep_arr(blob, blen, d[MD_TABLE_OFF],
                                    (int64_t)mm->n_dfa * mm->n_classes,
                                    mm->wide ? 4 : 2);
        mm->accept = sweep_arr(blob, blen, d[MD_ACCEPT_OFF],
                               mm->n_dfa, 1);
        mm->bc = sweep_arr(blob, blen, d[MD_BCLASS_OFF], 256, 4);
        if (!tab || !mm->accept || !mm->bc) {
            PyMem_Free(mem);
            return -1;
        }
        mm->tab16 = (const uint16_t *)tab;
        mm->tab32 = (const uint32_t *)tab;
        for (int c = 0; c < 256; c++) {
            if (mm->bc[c] < 0 || mm->bc[c] >= mm->n_classes) {
                PyMem_Free(mem);
                return -1;
            }
        }
        /* Start-state escape set for the memchr acceleration: bytes
         * whose class maps start anywhere but back to start. */
        mm->esc_n = 0;
        for (int c = 0; c < 256 && mm->esc_n >= 0; c++) {
            uint32_t nxt = mm->wide
                ? mm->tab32[(size_t)mm->start * mm->n_classes
                            + (uint32_t)mm->bc[c]]
                : mm->tab16[(size_t)mm->start * mm->n_classes
                            + (uint32_t)mm->bc[c]];
            if (nxt == (uint32_t)mm->start)
                continue;
            if (mm->esc_n >= MDFA_MAX_ESC)
                mm->esc_n = -1;  /* too many: plain table walk */
            else
                mm->esc[mm->esc_n++] = (uint8_t)c;
        }
    }
    *m_out = M;
    *members_out = mem;
    return 0;
}

typedef struct {
    const mdfa_member *mem;     /* [M] parsed program members */
    int32_t M;
    int32_t n_ord;              /* members to scan (order entries) */
    const uint8_t *src;
    Py_ssize_t src_len;
    const int32_t *ov;          /* [B+1] framed offsets */
    const uint8_t *cand;        /* [B, stride] candidate bytes, or in
                                 * packed mode [B, stride] u32 words
                                 * (bit col&31 of word col>>5) */
    Py_ssize_t stride;
    const int32_t *cols;        /* [M] member -> cand column */
    const int32_t *order;       /* [n_ord] member scan order — the
                                 * caller may omit members it knows
                                 * have zero candidates */
    uint8_t *out;               /* [B] verdict bytes (monotonic 0->1) */
    long long scanned;          /* candidate cells actually scanned */
    Py_ssize_t lo, hi;          /* row range for this worker */
    int bad;                    /* 1 offsets, 2 state id, 4 memory */
    int packed;                 /* cand holds u32 bit words */
    const int32_t *bit2slot;    /* [stride*32] packed col -> order
                                 * slot, -1 for unlisted columns */
    const uint32_t *colmask;    /* [stride] OR of listed column bits */
} gs_job;

/* One (row, member) cell: dfa_scan's scalar loop with an in-loop
 * state-id bound check (the blob is untrusted bytes — a corrupt table
 * entry must raise, not index past accept[]) and the memchr start-
 * state acceleration (header comment). Returns 1 on accept. */
static inline int
gs_scan_cell(const mdfa_member *d, const uint8_t *row, Py_ssize_t len,
             int *bad)
{
    const uint32_t nc = (uint32_t)d->n_classes;
    const uint32_t nd = (uint32_t)d->n_dfa;
    const uint32_t start = (uint32_t)d->start;
    uint32_t s = start;
    if (d->accept[s])
        return 1;
    const uint8_t *p = row;
    const uint8_t *pe = row + len;
    if (d->esc_n == 0)
        p = pe;                 /* no byte ever leaves the start state */
    while (p < pe) {
        if (s == start && d->esc_n > 0) {
            /* Every byte before the next escape byte provably maps
             * start -> start: jump straight there. */
            const uint8_t *q = memchr(p, d->esc[0], (size_t)(pe - p));
            if (d->esc_n == 2) {
                /* Only the region BEFORE the first hit can move the
                 * jump target earlier — searching past it rescans
                 * bytes the first memchr already cleared. */
                const uint8_t *q2 = memchr(p, d->esc[1],
                                           q ? (size_t)(q - p)
                                             : (size_t)(pe - p));
                if (q2)
                    q = q2;
            }
            if (!q)
                break;
            p = q;
        }
        s = d->wide ? d->tab32[s * nc + (uint32_t)d->bc[*p]]
                    : d->tab16[s * nc + (uint32_t)d->bc[*p]];
        p++;
        if (s >= nd) {
            *bad = 2;
            return 0;
        }
        if (d->accept[s])
            return 1;
    }
    s = d->wide ? d->tab32[s * nc + (uint32_t)d->end_class]
                : d->tab16[s * nc + (uint32_t)d->end_class];
    if (s >= nd) {
        *bad = 2;
        return 0;
    }
    return d->accept[s];
}

/* Scan one member over the candidate rows listed in rl[0..rn).
 * Rows already accepted by an earlier member are skipped here (NOT
 * counted as scanned), so the early-out semantics match the original
 * row-major walk cell for cell regardless of how the list was built. */
static void
gs_scan_member(gs_job *job, int32_t g, const int32_t *rl, int32_t rn)
{
    const uint8_t *src = job->src;
    const int32_t *ov = job->ov;
    const mdfa_member *d = &job->mem[g];
    if (d->esc_n < 0 && !d->match_all && !d->wide
        && !d->accept[d->start]) {
        /* No start-state acceleration possible (broad escape set):
         * interleave DFA_LANES candidate rows so the dependent
         * state->table->state load chains overlap — the same trick
         * as dfa_scan_rows, gathered over this member's candidate
         * rows. */
        const uint32_t nc = (uint32_t)d->n_classes;
        const uint32_t nd = (uint32_t)d->n_dfa;
        Py_ssize_t idx[DFA_LANES];
        const uint8_t *p[DFA_LANES], *pe[DFA_LANES];
        uint32_t s[DFA_LANES];
        int nl = 0;
        for (int32_t t = 0; t <= rn; t++) {
            if (t < rn) {
                Py_ssize_t i = rl[t];
                if (job->out[i])
                    continue;
                job->scanned++;
                int32_t rlo = ov[i];
                Py_ssize_t len = ov[i + 1] - rlo;
                while (len > 0 && src[rlo + len - 1] == '\n')
                    len--;
                idx[nl] = i;
                p[nl] = src + rlo;
                pe[nl] = p[nl] + len;
                s[nl] = (uint32_t)d->start;
                nl++;
                if (nl < DFA_LANES)
                    continue;
            }
            unsigned active = 0;
            for (int l = 0; l < nl; l++)
                if (p[l] < pe[l])
                    active |= 1u << l;
                else
                    s[l] = UINT32_MAX;  /* empty: end step below */
            while (active) {
                for (int l = 0; l < nl; l++) {
                    if (!(active & (1u << l)))
                        continue;
                    uint32_t nxt = d->tab16[s[l] * nc
                                   + (uint32_t)d->bc[*p[l]]];
                    p[l]++;
                    if (nxt >= nd) {
                        job->bad = 2;
                        return;
                    }
                    if (d->accept[nxt]) {
                        job->out[idx[l]] = 1;
                        active &= ~(1u << l);
                    } else if (p[l] == pe[l]) {
                        s[l] = nxt;
                        active &= ~(1u << l);
                    } else {
                        s[l] = nxt;
                    }
                }
            }
            for (int l = 0; l < nl; l++) {
                if (job->out[idx[l]])
                    continue;
                uint32_t sf = s[l] == UINT32_MAX
                    ? (uint32_t)d->start : s[l];
                sf = d->tab16[sf * nc + (uint32_t)d->end_class];
                if (sf >= nd) {
                    job->bad = 2;
                    return;
                }
                if (d->accept[sf])
                    job->out[idx[l]] = 1;
            }
            nl = 0;
        }
        return;
    }
    for (int32_t t = 0; t < rn; t++) {
        Py_ssize_t i = rl[t];
        if (job->out[i])
            continue;
        job->scanned++;
        int32_t rlo = ov[i];
        Py_ssize_t len = ov[i + 1] - rlo;
        while (len > 0 && src[rlo + len - 1] == '\n')
            len--;
        if (d->match_all
            || gs_scan_cell(d, src + rlo, len, &job->bad))
            job->out[i] = 1;
        if (job->bad)
            return;
    }
}

static void
group_scan_rows(gs_job *job)
{
    const int32_t *ov = job->ov;
    /* Validate this slice's offsets ONCE; the per-member passes below
     * then trust them. */
    for (Py_ssize_t i = job->lo; i < job->hi; i++) {
        if (ov[i] < 0 || ov[i + 1] < ov[i] || ov[i + 1] > job->src_len) {
            job->bad = 1;
            return;
        }
    }
    /* Group-major: one member's tables stay cache-hot across its
     * whole row run; early-out semantics match the row-major walk
     * cell for cell (header comment). */
    if (job->packed) {
        /* One ctz walk over the sweep's packed bit matrix builds every
         * member's candidate row list at once. The byte-matrix shape
         * below re-reads all B rows once PER member (n_ord * B loads —
         * ~2 ms on a 64k-row slab at K=1k with only a handful of live
         * members); here the listed-column mask prunes dead bits in
         * bulk and each set bit costs one counted-sort insert. */
        const uint32_t *cw = (const uint32_t *)job->cand;
        const Py_ssize_t GW = job->stride;
        int32_t *cnt = calloc((size_t)job->n_ord + 1, sizeof(int32_t));
        if (!cnt) {
            job->bad = 4;
            return;
        }
        int64_t total = 0;
        for (Py_ssize_t i = job->lo; i < job->hi; i++) {
            const uint32_t *row = cw + (size_t)i * GW;
            for (Py_ssize_t w = 0; w < GW; w++) {
                uint32_t v = row[w] & job->colmask[w];
                while (v) {
                    int b = __builtin_ctz(v);
                    v &= v - 1;
                    cnt[job->bit2slot[w * 32 + b]]++;
                    total++;
                }
            }
        }
        int32_t *start = malloc(((size_t)job->n_ord + 1)
                                * sizeof(int32_t));
        int32_t *fill = malloc(((size_t)job->n_ord + 1)
                               * sizeof(int32_t));
        int32_t *lists = malloc(total ? (size_t)total * sizeof(int32_t)
                                      : sizeof(int32_t));
        if (!start || !fill || !lists) {
            free(cnt);
            free(start);
            free(fill);
            free(lists);
            job->bad = 4;
            return;
        }
        int32_t acc = 0;
        for (int32_t k = 0; k < job->n_ord; k++) {
            start[k] = fill[k] = acc;
            acc += cnt[k];
        }
        for (Py_ssize_t i = job->lo; i < job->hi; i++) {
            const uint32_t *row = cw + (size_t)i * GW;
            for (Py_ssize_t w = 0; w < GW; w++) {
                uint32_t v = row[w] & job->colmask[w];
                while (v) {
                    int b = __builtin_ctz(v);
                    v &= v - 1;
                    lists[fill[job->bit2slot[w * 32 + b]]++] =
                        (int32_t)i;
                }
            }
        }
        for (int32_t k = 0; k < job->n_ord && !job->bad; k++)
            gs_scan_member(job, job->order[k], lists + start[k],
                           cnt[k]);
        free(cnt);
        free(start);
        free(fill);
        free(lists);
        return;
    }
    Py_ssize_t nrows = job->hi - job->lo;
    int32_t *tmp = malloc(nrows ? (size_t)nrows * sizeof(int32_t)
                                : sizeof(int32_t));
    if (!tmp) {
        job->bad = 4;
        return;
    }
    for (int32_t k = 0; k < job->n_ord && !job->bad; k++) {
        const int32_t g = job->order[k];
        const int32_t col = job->cols[g];
        int32_t rn = 0;
        for (Py_ssize_t i = job->lo; i < job->hi; i++)
            if (job->cand[(size_t)i * job->stride + col])
                tmp[rn++] = (int32_t)i;
        gs_scan_member(job, g, tmp, rn);
    }
    free(tmp);
}

static void *
group_scan_worker(void *arg)
{
    group_scan_rows((gs_job *)arg);
    return NULL;
}

static void
group_scan_run(void *arg)
{
    group_scan_rows((gs_job *)arg);
}

static PyObject *
group_scan(PyObject *self, PyObject *args)
{
    Py_buffer blob, payload, offs, cand, cols, order, outb;
    Py_ssize_t B, stride;
    int packed = 0;
    if (!PyArg_ParseTuple(args, "y*y*y*ny*ny*y*w*|i", &blob, &payload,
                          &offs, &B, &cand, &stride, &cols, &order,
                          &outb, &packed))
        return NULL;
    int32_t M = 0;
    mdfa_member *mem = NULL;
    int32_t *bit2slot = NULL;
    uint32_t *colmask = NULL;
    int ok = (B >= 0 && stride >= 1 && offs.len >= (B + 1) * 4
              && mdfa_parse_blob((const char *)blob.buf, blob.len,
                                 &M, &mem) == 0);
    /* order may name FEWER members than the program holds — the
     * caller omits members it knows have zero candidate rows. */
    const int32_t n_ord = (int32_t)(order.len / 4);
    /* Packed mode: cand is the sweep's u32[B, stride] group bitset
     * (bit col&31 of word col>>5 = that column's candidacy), consumed
     * zero-copy; byte mode keeps the original [B, stride] matrix. */
    if (ok && (cand.len < (int64_t)B * stride * (packed ? 4 : 1)
               || cols.len < (Py_ssize_t)M * 4
               || n_ord > M || outb.len < B))
        ok = 0;
    if (ok) {
        const int32_t *colv = (const int32_t *)cols.buf;
        const int32_t *ordv = (const int32_t *)order.buf;
        const Py_ssize_t ncol = packed ? stride * 32 : stride;
        for (int32_t k = 0; k < M; k++)
            if (colv[k] < 0 || colv[k] >= ncol)
                ok = 0;
        for (int32_t k = 0; k < n_ord; k++)
            if (ordv[k] < 0 || ordv[k] >= M)
                ok = 0;
        if (ok && packed) {
            bit2slot = PyMem_Malloc((size_t)stride * 32
                                    * sizeof(int32_t));
            colmask = PyMem_Calloc((size_t)stride, sizeof(uint32_t));
            if (!bit2slot || !colmask) {
                PyMem_Free(mem);
                PyMem_Free(bit2slot);
                PyMem_Free(colmask);
                PyBuffer_Release(&blob);
                PyBuffer_Release(&payload);
                PyBuffer_Release(&offs);
                PyBuffer_Release(&cand);
                PyBuffer_Release(&cols);
                PyBuffer_Release(&order);
                PyBuffer_Release(&outb);
                return PyErr_NoMemory();
            }
            memset(bit2slot, 0xff, (size_t)stride * 32
                                   * sizeof(int32_t));
            for (int32_t k = 0; k < n_ord; k++) {
                int32_t c = colv[ordv[k]];
                if (bit2slot[c] != -1)
                    ok = 0;  /* duplicate column: lists would split */
                bit2slot[c] = k;
                colmask[c >> 5] |= 1u << (c & 31);
            }
        }
    }
    if (!ok) {
        PyMem_Free(bit2slot);
        PyMem_Free(colmask);
        PyMem_Free(mem);
        PyBuffer_Release(&blob);
        PyBuffer_Release(&payload);
        PyBuffer_Release(&offs);
        PyBuffer_Release(&cand);
        PyBuffer_Release(&cols);
        PyBuffer_Release(&order);
        PyBuffer_Release(&outb);
        PyErr_SetString(PyExc_ValueError,
                        "group_scan: malformed program blob or sizes");
        return NULL;
    }
    /* Escape-byte density sampling: the memchr acceleration LOSES to
     * the interleaved table walk when the escape byte saturates the
     * corpus (an 'e' every few bytes means a memchr restart per hit);
     * histogram the payload head once and demote dense-escape members
     * to the interleaved path. Pure cost heuristic — both paths step
     * the identical automaton. */
    {
        size_t hn = payload.len < 4096 ? (size_t)payload.len : 4096;
        uint32_t hist[256] = {0};
        const uint8_t *hp = (const uint8_t *)payload.buf;
        for (size_t i = 0; i < hn; i++)
            hist[hp[i]]++;
        for (int32_t m = 0; m < M; m++) {
            if (mem[m].esc_n <= 0)
                continue;
            uint32_t cnt = 0;
            for (int e = 0; e < mem[m].esc_n; e++)
                cnt += hist[mem[m].esc[e]];
            /* Break-even measured on the BENCH_K corpus: memchr +
             * range-limited second probe beats the interleaved walk
             * up to ~1/8 escape density; only truly saturated escape
             * bytes (an 'e'-every-few-bytes corpus) still demote. */
            if (hn && (size_t)cnt * 8 > hn)
                mem[m].esc_n = -1;
        }
    }
    gs_job job = {mem, M, n_ord, (const uint8_t *)payload.buf,
                  payload.len, (const int32_t *)offs.buf,
                  (const uint8_t *)cand.buf, stride,
                  (const int32_t *)cols.buf,
                  (const int32_t *)order.buf, (uint8_t *)outb.buf,
                  0, 0, B, 0, packed, bit2slot, colmask};
    int nthreads = host_threads();
    long long scanned = 0;
    int bad = 0;
    if (nthreads <= 1 || B < 8192) {
        /* Small slabs stay single-threaded (spawn cost would swamp a
         * sub-ms scan) but still release the GIL: sibling Python
         * threads sweep/pack while this slab confirms. */
        Py_BEGIN_ALLOW_THREADS
        group_scan_rows(&job);
        Py_END_ALLOW_THREADS
        scanned = job.scanned;
        bad = job.bad;
    } else {
        gs_job jobs[64];
        int count = slice_jobs((char *)jobs, sizeof(gs_job), &job, B,
                               nthreads, 1, offsetof(gs_job, lo),
                               offsetof(gs_job, hi));
        Py_BEGIN_ALLOW_THREADS
        dispatch_row_jobs((char *)jobs, sizeof(gs_job), count,
                          group_scan_worker, group_scan_run);
        Py_END_ALLOW_THREADS
        for (int t = 0; t < count; t++) {
            scanned += jobs[t].scanned;
            bad |= jobs[t].bad;
        }
    }
    PyMem_Free(bit2slot);
    PyMem_Free(colmask);
    PyMem_Free(mem);
    PyBuffer_Release(&blob);
    PyBuffer_Release(&payload);
    PyBuffer_Release(&offs);
    PyBuffer_Release(&cand);
    PyBuffer_Release(&cols);
    PyBuffer_Release(&order);
    PyBuffer_Release(&outb);
    if (bad) {
        if (bad & 4)
            return PyErr_NoMemory();
        PyErr_SetString(PyExc_ValueError,
                        bad & 2 ? "group_scan: table state id out of range"
                                : "group_scan: offsets out of range");
        return NULL;
    }
    return PyLong_FromLongLong(scanned);
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
    {"dfa_scan", dfa_scan, METH_VARARGS,
     "dfa_scan(payload, offsets, n, table, n_classes, accept, byte_class,"
     " start, end_class, wide) -> mask bytes"},
    {"sweep_candidates", sweep_candidates, METH_VARARGS,
     "sweep_candidates(blob, payload, offsets, n_lines, simd,"
     " stats=None) -> u32[n_lines, GW] group-bitset bytes; stats is an"
     " optional writable u64[2] receiving [survivors, positions], or"
     " u64[3 + 32*GW] to also receive [candidate lines, per-group"
     " column sums]"},
    {"sweep_simd_level", sweep_simd_level, METH_VARARGS,
     "sweep_simd_level(requested=-1) -> resolved SIMD level"
     " (0 scalar, 1 ssse3, 2 avx2, 3 avx512)"},
    {"group_scan", group_scan, METH_VARARGS,
     "group_scan(blob, payload, offsets, n_lines, cand, stride, cols,"
     " order, out, packed=0) -> scanned candidate cells (out updated"
     " in place); packed=1 reads cand as the sweep's u32 bit words"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_hostops",
    "The host framing, join and scans of klogs_tpu_torch", -1,
    Methods,
};

PyMODINIT_FUNC
PyInit__hostops(void)
{
    return PyModule_Create(&module);
}
