/* The typed JSON renderer of utils/serde.py, in C.
 *
 * render(obj) returns, as ASCII bytes, exactly json.dumps(serde.encode(obj))
 * (json's defaults: ", " and ": ", ensure_ascii, allow_nan), without building
 * the encoded document. It is the flight recorder's commit-path cost: a wave
 * record's gangs and pods are rendered at capture, before the binding loop
 * edits them.
 *
 * Handled here, in serde.encode's order of checks: None, bool, int, float and
 * str (subclasses too: a str or int Enum is written as its plain value, as
 * encode passes it through), then by the object's exact type as serde.py
 * classifies it once (configure): a dataclass ({"!t": name, fields...}), a
 * list, a tuple ({"!u": [...]}) or a dict (str keys as an object, other keys
 * as {"!d": [[k, v], ...]}). Anything else (a set, a plain Enum, an unknown
 * type) is handed to serde.py's fallback, which is json.dumps(encode(obj))
 * for that value and raises where encode raises.
 *
 * A container's items are held (a new reference) while they are rendered:
 * the fallback runs Python code, which may release the GIL.
 *
 * render_wave(capture, field) writes a journal's wave record straight from
 * what the commit path holds (trace/recorder.py's capture tuple): the record
 * the JAX recorder builds, field for field, without the Python dict, the
 * sorted name sets and the filtered maps that the general path
 * (recorder.wave_record) assembles first. A field whose inputs are not of the
 * plain types handled here is built by the general path's own expression
 * (field(key, capture)) and rendered. same_fleet(a, b) compares two
 * snapshots' fleets, as recorder._same_fleet does, for the recorder's fleet
 * digest.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <string.h>

enum { KIND_FALLBACK = 0, KIND_LIST = 1, KIND_TUPLE = 2, KIND_DICT = 3 };

/* type -> int kind, or (head bytes, names tuple, keys tuple of bytes) for a
 * dataclass; filled by `classify` (serde.py) on a type's first sight. */
static PyObject *kinds = NULL;
static PyObject *classify = NULL;
static PyObject *fallback = NULL;
static PyObject *scalars = NULL;

/* The output goes to a scratch buffer that is kept across calls, then to
 * one bytes object of its length. A page of memory the process has not
 * written before costs a fault on its first write, and a drain's record is
 * tens of kilobytes: so a render writes where the last one wrote. A render
 * that finds the scratch buffer in use (one that ran Python code, which let
 * another thread render) takes a buffer of its own; a scratch buffer grown
 * past SCRATCH_KEEP is released after its call. */
#define SCRATCH_KEEP (1 << 20)

static char *scratch = NULL;
static Py_ssize_t scratch_cap = 0;
static int scratch_busy = 0;

typedef struct {
    char *buf;
    Py_ssize_t len, cap;
    int own; /* buf is this render's own, not the scratch buffer */
} Out;

static int out_open(Out *o, Py_ssize_t cap) {
    o->len = 0;
    o->own = scratch_busy;
    if (!o->own) {
        if (scratch_cap < cap) {
            char *b = PyMem_Realloc(scratch, cap);
            if (!b) {
                PyErr_NoMemory();
                return -1;
            }
            scratch = b;
            scratch_cap = cap;
        }
        scratch_busy = 1;
        o->buf = scratch;
        o->cap = scratch_cap;
        return 0;
    }
    o->buf = PyMem_Malloc(cap);
    if (!o->buf) {
        PyErr_NoMemory();
        return -1;
    }
    o->cap = cap;
    return 0;
}

/* Texts the journal's writer has let go (recycle), for render_wave to hand
 * out again: a segment's records live until the segment is written and are
 * then freed together, and memory freed in bulk goes back to the system, to
 * be faulted in anew, page by page, by the next records. At most FREE_MAX
 * texts and FREE_BYTES of capacity are kept. */
#define FREE_MAX 512
#define FREE_BYTES (16 << 20)

static PyObject *free_texts[FREE_MAX];
static int free_n = 0;
static Py_ssize_t free_bytes = 0;

/* A bytearray holding the n bytes at buf: a let-go text that nothing else
 * holds any more and whose capacity takes n without a reallocation (n + 1
 * <= ob_alloc <= 2 n: PyByteArray_Resize then only sets the size), when
 * there is one; else a new one. */
static PyObject *recycled_text(const char *buf, Py_ssize_t n) {
    for (int i = free_n - 1; i >= 0; i--) {
        PyByteArrayObject *b = (PyByteArrayObject *)free_texts[i];
        if (Py_REFCNT(b) != 1 || b->ob_start != b->ob_bytes || n + 1 > b->ob_alloc ||
            b->ob_alloc > 2 * n)
            continue;
        free_texts[i] = free_texts[--free_n];
        free_bytes -= b->ob_alloc;
        if (PyByteArray_Resize((PyObject *)b, n) < 0) {
            Py_DECREF(b);
            return NULL;
        }
        memcpy(PyByteArray_AS_STRING(b), buf, (size_t)n);
        return (PyObject *)b;
    }
    return PyByteArray_FromStringAndSize(buf, n);
}

/* recycle(texts): keep the bytearrays of `texts` (a list) that nothing
 * but the list holds, for render_wave to hand out again. */
static PyObject *py_recycle(PyObject *Py_UNUSED(self), PyObject *texts) {
    if (!PyList_Check(texts)) {
        PyErr_SetString(PyExc_TypeError, "recycle: a list");
        return NULL;
    }
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(texts); i++) {
        PyObject *t = PyList_GET_ITEM(texts, i);
        if (!PyByteArray_CheckExact(t) || Py_REFCNT(t) != 1 || free_n == FREE_MAX) continue;
        Py_ssize_t alloc = ((PyByteArrayObject *)t)->ob_alloc;
        if (free_bytes + alloc > FREE_BYTES) continue;
        free_texts[free_n++] = Py_NewRef(t);
        free_bytes += alloc;
    }
    Py_RETURN_NONE;
}

/* The text written (a new reference: bytes, or with `recycled` a bytearray
 * that may be a let-go text), or NULL after a failure (`ok` 0); the buffer
 * is given back either way. */
static PyObject *out_close(Out *o, int ok, int recycled) {
    PyObject *res = !ok ? NULL
                    : recycled ? recycled_text(o->buf, o->len)
                               : PyBytes_FromStringAndSize(o->buf, o->len);
    if (o->own) {
        PyMem_Free(o->buf);
    } else {
        scratch_busy = 0;
        if (scratch_cap > SCRATCH_KEEP) {
            PyMem_Free(scratch);
            scratch = NULL;
            scratch_cap = 0;
        }
    }
    o->buf = NULL;
    return res;
}

static int out_grow(Out *o, Py_ssize_t need) {
    if (o->len + need <= o->cap) return 0;
    Py_ssize_t cap = o->cap;
    while (cap < o->len + need) cap *= 2;
    char *b = PyMem_Realloc(o->buf, cap);
    if (!b) {
        PyErr_NoMemory();
        return -1;
    }
    o->buf = b;
    o->cap = cap;
    if (!o->own) {
        scratch = b;
        scratch_cap = cap;
    }
    return 0;
}

static int out_put(Out *o, const char *s, Py_ssize_t n) {
    if (out_grow(o, n) < 0) return -1;
    memcpy(o->buf + o->len, s, n);
    o->len += n;
    return 0;
}

#define PUT_LIT(o, s) out_put((o), (s), (Py_ssize_t)(sizeof(s) - 1))

static int put_bytes(Out *o, PyObject *b) {
    return out_put(o, PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b));
}

/* An ASCII str (json.dumps output, a repr) as it is. */
static int put_ascii(Out *o, PyObject *s) {
    Py_ssize_t n;
    const char *u = PyUnicode_AsUTF8AndSize(s, &n);
    if (!u) return -1;
    return out_put(o, u, n);
}

static const char HEX[] = "0123456789abcdef";

static int put_u4(Out *o, Py_UCS4 c) {
    char e[6] = {'\\', 'u', HEX[(c >> 12) & 15], HEX[(c >> 8) & 15], HEX[(c >> 4) & 15],
                 HEX[c & 15]};
    return out_put(o, e, 6);
}

/* json's encode_basestring_ascii: quoted, every char outside ' '..'~' and
 * '"', '\\' escaped (\uXXXX in lower-case hex, a surrogate pair above the
 * BMP). */
static int put_str(Out *o, PyObject *s) {
    Py_ssize_t n = PyUnicode_GET_LENGTH(s);
    if (PyUnicode_IS_ASCII(s)) {
        const unsigned char *p = PyUnicode_1BYTE_DATA(s);
        Py_ssize_t i = 0;
        while (i < n && p[i] >= ' ' && p[i] <= '~' && p[i] != '"' && p[i] != '\\') i++;
        if (i == n) {
            if (out_grow(o, n + 2) < 0) return -1;
            o->buf[o->len++] = '"';
            memcpy(o->buf + o->len, p, n);
            o->len += n;
            o->buf[o->len++] = '"';
            return 0;
        }
    }
    int kind = PyUnicode_KIND(s);
    const void *data = PyUnicode_DATA(s);
    if (out_grow(o, n + 2) < 0) return -1;
    o->buf[o->len++] = '"';
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_UCS4 c = PyUnicode_READ(kind, data, i);
        if (c >= ' ' && c <= '~' && c != '"' && c != '\\') {
            if (out_grow(o, 1) < 0) return -1;
            o->buf[o->len++] = (char)c;
            continue;
        }
        int r;
        switch (c) {
            case '\\': r = PUT_LIT(o, "\\\\"); break;
            case '"': r = PUT_LIT(o, "\\\""); break;
            case '\b': r = PUT_LIT(o, "\\b"); break;
            case '\f': r = PUT_LIT(o, "\\f"); break;
            case '\n': r = PUT_LIT(o, "\\n"); break;
            case '\r': r = PUT_LIT(o, "\\r"); break;
            case '\t': r = PUT_LIT(o, "\\t"); break;
            default:
                if (c >= 0x10000) {
                    Py_UCS4 v = c - 0x10000;
                    r = put_u4(o, 0xd800 | ((v >> 10) & 0x3ff));
                    if (r == 0) r = put_u4(o, 0xdc00 | (v & 0x3ff));
                } else {
                    r = put_u4(o, c);
                }
        }
        if (r < 0) return -1;
    }
    if (out_grow(o, 1) < 0) return -1;
    o->buf[o->len++] = '"';
    return 0;
}

static int put_ll(Out *o, long long v) {
    char b[24];
    int i = (int)sizeof b;
    unsigned long long u = v < 0 ? 0ULL - (unsigned long long)v : (unsigned long long)v;
    do {
        b[--i] = (char)('0' + u % 10);
        u /= 10;
    } while (u);
    if (v < 0) b[--i] = '-';
    return out_put(o, b + i, (Py_ssize_t)sizeof b - i);
}

/* float.__repr__ (json's rendering of a finite float): an integral value
 * below 1e16 is its digits and ".0" (repr's fixed notation, and the shortest
 * digits that round-trip are the integer itself); -0.0 and the rest go
 * through PyOS_double_to_string as float_repr does. */
static int put_double(Out *o, double v) {
    if (isnan(v)) return PUT_LIT(o, "NaN");
    if (isinf(v)) return v > 0 ? PUT_LIT(o, "Infinity") : PUT_LIT(o, "-Infinity");
    if (fabs(v) < 1e16 && v == (double)(long long)v && !(v == 0.0 && signbit(v))) {
        if (put_ll(o, (long long)v) < 0) return -1;
        return PUT_LIT(o, ".0");
    }
    char *s = PyOS_double_to_string(v, 'r', 0, Py_DTSF_ADD_DOT_0, NULL);
    if (!s) return -1;
    int r = out_put(o, s, (Py_ssize_t)strlen(s));
    PyMem_Free(s);
    return r;
}

static int put_repr(Out *o, reprfunc repr, PyObject *x) {
    PyObject *s = repr(x);
    if (!s) return -1;
    int r = put_ascii(o, s);
    Py_DECREF(s);
    return r;
}

static int render(Out *o, PyObject *x);

/* A new reference to an item, rendered, released. */
static int render_held(Out *o, PyObject *x) {
    Py_INCREF(x);
    int r = render(o, x);
    Py_DECREF(x);
    return r;
}

static int render_fallback(Out *o, PyObject *x) {
    PyObject *s = PyObject_CallOneArg(fallback, x);
    if (!s) return -1;
    int r = -1;
    if (PyUnicode_Check(s))
        r = put_ascii(o, s);
    else
        PyErr_SetString(PyExc_TypeError, "serde fallback: not a str");
    Py_DECREF(s);
    return r;
}

static int render_items(Out *o, PyObject *seq, int is_list) {
    if (PUT_LIT(o, "[") < 0) return -1;
    for (Py_ssize_t i = 0; i < (is_list ? PyList_GET_SIZE(seq) : PyTuple_GET_SIZE(seq)); i++) {
        if (i && PUT_LIT(o, ", ") < 0) return -1;
        PyObject *item = is_list ? PyList_GET_ITEM(seq, i) : PyTuple_GET_ITEM(seq, i);
        if (render_held(o, item) < 0) return -1;
    }
    return PUT_LIT(o, "]");
}

static int render_dict(Out *o, PyObject *d) {
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    int str_keys = 1;
    while (PyDict_Next(d, &pos, &k, &v)) {
        if (!PyUnicode_Check(k)) {
            str_keys = 0;
            break;
        }
    }
    if ((str_keys ? PUT_LIT(o, "{") : PUT_LIT(o, "{\"!d\": [")) < 0) return -1;
    pos = 0;
    int first = 1;
    while (PyDict_Next(d, &pos, &k, &v)) {
        if (!first && PUT_LIT(o, ", ") < 0) return -1;
        first = 0;
        Py_INCREF(k);
        Py_INCREF(v);
        int r;
        if (str_keys) {
            r = put_str(o, k);
            if (r == 0) r = PUT_LIT(o, ": ");
            if (r == 0) r = render(o, v);
        } else {
            r = PUT_LIT(o, "[");
            if (r == 0) r = render(o, k);
            if (r == 0) r = PUT_LIT(o, ", ");
            if (r == 0) r = render(o, v);
            if (r == 0) r = PUT_LIT(o, "]");
        }
        Py_DECREF(k);
        Py_DECREF(v);
        if (r < 0) return -1;
    }
    return str_keys ? PUT_LIT(o, "}") : PUT_LIT(o, "]}");
}

/* (head, names, keys): head is b'{"!t": "<name>"', keys[i] is
 * b', "<names[i]>": '. */
static int render_dataclass(Out *o, PyObject *x, PyObject *desc) {
    PyObject *head = PyTuple_GET_ITEM(desc, 0);
    PyObject *names = PyTuple_GET_ITEM(desc, 1);
    PyObject *keys = PyTuple_GET_ITEM(desc, 2);
    if (put_bytes(o, head) < 0) return -1;
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(names); i++) {
        if (put_bytes(o, PyTuple_GET_ITEM(keys, i)) < 0) return -1;
        PyObject *v = PyObject_GetAttr(x, PyTuple_GET_ITEM(names, i));
        if (!v) return -1;
        int r = render(o, v);
        Py_DECREF(v);
        if (r < 0) return -1;
    }
    return PUT_LIT(o, "}");
}

static int render(Out *o, PyObject *x) {
    if (x == Py_None) return PUT_LIT(o, "null");
    if (x == Py_True) return PUT_LIT(o, "true");
    if (x == Py_False) return PUT_LIT(o, "false");
    if (PyUnicode_Check(x)) return put_str(o, x);
    if (PyLong_Check(x)) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(x, &overflow);
        if (v == -1 && PyErr_Occurred()) return -1;
        if (overflow) return put_repr(o, PyLong_Type.tp_repr, x);
        return put_ll(o, v);
    }
    if (PyFloat_Check(x)) return put_double(o, PyFloat_AS_DOUBLE(x));
    PyObject *desc = PyDict_GetItemWithError(kinds, (PyObject *)Py_TYPE(x));
    if (desc) {
        Py_INCREF(desc);
    } else {
        if (PyErr_Occurred()) return -1;
        desc = PyObject_CallOneArg(classify, (PyObject *)Py_TYPE(x));
        if (!desc) return -1;
    }
    if (PyTuple_Check(desc)) {
        int r = -1;
        if (!Py_EnterRecursiveCall(" while rendering a dataclass")) {
            r = render_dataclass(o, x, desc);
            Py_LeaveRecursiveCall();
        }
        Py_DECREF(desc);
        return r;
    }
    long kind = PyLong_AsLong(desc);
    Py_DECREF(desc);
    if (kind == -1 && PyErr_Occurred()) return -1;
    if (kind == KIND_FALLBACK) return render_fallback(o, x);
    if (Py_EnterRecursiveCall(" while rendering a container")) return -1;
    int r;
    if (kind == KIND_LIST) {
        r = render_items(o, x, 1);
    } else if (kind == KIND_TUPLE) {
        r = PUT_LIT(o, "{\"!u\": ");
        if (r == 0) r = render_items(o, x, 0);
        if (r == 0) r = PUT_LIT(o, "}");
    } else {
        r = render_dict(o, x);
    }
    Py_LeaveRecursiveCall();
    return r;
}

/* ---- the wave record ---------------------------------------------------- */

/* The capture tuple's slots, in trace/recorder.py's CAPTURE order. */
enum {
    C_NOW, C_WAVE, C_FLEET, C_PAD_NODES, C_RESOURCES, C_ALLOC, C_NODE_NAMES, C_GANGS,
    C_PODS_BY_NAME, C_SCHEDULED, C_BOUND_NODES, C_REUSE_NODES, C_SPREAD_AVOID,
    C_MAX_GROUPS, C_MAX_SETS, C_MAX_PODS, C_PAD_GANGS_TO, C_PARAMS, C_PORTFOLIO,
    C_ESCALATE_PORTFOLIO, C_MESH, C_PRUNING, C_PLAN, C_OK, C_VALID, C_SCORES,
    C_SOLVE_SECONDS, C_FREE_ROWS, C_CANDIDATES, C_COUNT
};

/* A capture tuple and `field`, field(key, capture) being the general path's
 * value of the record's field `key`. */
typedef struct {
    PyObject *cap, *field;
} Wave;

#define ITEM(w, slot) PyTuple_GET_ITEM((w)->cap, (slot))

static PyObject *S_name, *S_spec, *S_pod_groups, *S_pod_references, *S_item, *S_get;

/* Render the general path's value of field `key`. */
static int put_field(Out *o, const char *key, const Wave *w) {
    PyObject *v = PyObject_CallFunction(w->field, "sO", key, w->cap);
    if (!v) return -1;
    int r = render(o, v);
    Py_DECREF(v);
    return r;
}

static int put_float_of(Out *o, PyObject *x) {
    PyObject *f = PyNumber_Float(x);
    if (!f) return -1;
    int r = put_double(o, PyFloat_AS_DOUBLE(f));
    Py_DECREF(f);
    return r;
}

static int put_int_of(Out *o, PyObject *x) {
    PyObject *i = PyNumber_Long(x);
    if (!i) return -1;
    int r = render(o, i);
    Py_DECREF(i);
    return r;
}

/* [conv(x) for x in it]: float() when as_float, else int(). */
static int put_converted(Out *o, PyObject *it, int as_float) {
    PyObject *iter = PyObject_GetIter(it);
    if (!iter) return -1;
    int r = PUT_LIT(o, "["), first = 1;
    PyObject *x;
    while (r == 0 && (x = PyIter_Next(iter))) {
        if (!first) r = PUT_LIT(o, ", ");
        first = 0;
        if (r == 0) r = as_float ? put_float_of(o, x) : put_int_of(o, x);
        Py_DECREF(x);
    }
    Py_DECREF(iter);
    if (r < 0 || PyErr_Occurred()) return -1;
    return PUT_LIT(o, "]");
}

/* recorder._jsonable: x.item() where x has an `item`, else x (new ref);
 * x itself where its type is in `scalars` (serde.SCALAR_TYPES: bool() and
 * float() of x are those of x.item(), which is all the caller reads). */
static PyObject *jsonable(PyObject *x) {
    if (PyBool_Check(x) || PyLong_CheckExact(x) || PyFloat_CheckExact(x) ||
        PySet_Contains(scalars, (PyObject *)Py_TYPE(x)) == 1) {
        Py_INCREF(x);
        return x;
    }
    if (PyErr_Occurred()) return NULL;
    PyObject *m = PyObject_GetAttr(x, S_item);
    if (!m) {
        if (!PyErr_ExceptionMatches(PyExc_AttributeError)) return NULL;
        PyErr_Clear();
        Py_INCREF(x);
        return x;
    }
    PyObject *r = PyObject_CallNoArgs(m);
    Py_DECREF(m);
    return r;
}

/* _jsonable(m.get(k, dflt)), a new reference. */
static PyObject *verdict(PyObject *m, PyObject *k, PyObject *dflt) {
    PyObject *v;
    if (PyDict_CheckExact(m)) {
        v = PyDict_GetItemWithError(m, k);
        if (!v && PyErr_Occurred()) return NULL;
        v = v ? v : dflt;
        Py_INCREF(v);
    } else {
        v = PyObject_CallMethodObjArgs(m, S_get, k, dflt, NULL);
        if (!v) return NULL;
    }
    PyObject *r = jsonable(v);
    Py_DECREF(v);
    return r;
}

/* {n: bool(...)} (as_score 0) or {n: float(...)} (as_score 1) over the
 * sorted gang names. */
static int put_verdicts(Out *o, PyObject *sorted_names, PyObject *m, int as_score) {
    PyObject *dflt = as_score ? PyFloat_FromDouble(0.0) : Py_NewRef(Py_False);
    if (!dflt) return -1;
    int r = PUT_LIT(o, "{");
    for (Py_ssize_t i = 0; r == 0 && i < PyList_GET_SIZE(sorted_names); i++) {
        PyObject *n = PyList_GET_ITEM(sorted_names, i);
        if (i) r = PUT_LIT(o, ", ");
        if (r == 0) r = put_str(o, n);
        if (r == 0) r = PUT_LIT(o, ": ");
        if (r < 0) break;
        PyObject *v = verdict(m, n, dflt);
        if (!v) {
            r = -1;
            break;
        }
        if (as_score) {
            r = put_float_of(o, v);
        } else {
            int t = PyObject_IsTrue(v);
            r = t < 0 ? -1 : t ? PUT_LIT(o, "true") : PUT_LIT(o, "false");
        }
        Py_DECREF(v);
    }
    Py_DECREF(dflt);
    return r < 0 ? -1 : PUT_LIT(o, "}");
}

/* rejections: for each name in the set's own order, the reason of a gang
 * that was not admitted. */
static int put_rejections(Out *o, PyObject *names, PyObject *ok, PyObject *valid) {
    PyObject *iter = PyObject_GetIter(names);
    if (!iter) return -1;
    int r = PUT_LIT(o, "{"), first = 1;
    PyObject *n;
    while (r == 0 && (n = PyIter_Next(iter))) {
        int t = -1;
        PyObject *v = verdict(ok, n, Py_False);
        if (v) {
            t = PyObject_IsTrue(v);
            Py_DECREF(v);
        }
        if (t == 0) {
            int is_valid = -1;
            v = verdict(valid, n, Py_False);
            if (v) {
                is_valid = PyObject_IsTrue(v);
                Py_DECREF(v);
            }
            if (is_valid < 0) {
                r = -1;
            } else {
                if (!first) r = PUT_LIT(o, ", ");
                first = 0;
                if (r == 0) r = put_str(o, n);
                if (r == 0)
                    r = is_valid ? PUT_LIT(o, ": \"rejected (capacity/constraints)\"")
                                 : PUT_LIT(o, ": \"not solver-valid (gated base or "
                                              "unresolvable constraint)\"");
            }
        } else if (t < 0) {
            r = -1;
        }
        Py_DECREF(n);
    }
    Py_DECREF(iter);
    if (r < 0 || PyErr_Occurred()) return -1;
    return PUT_LIT(o, "}");
}

static int all_str(PyObject *list) {
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(list); i++)
        if (!PyUnicode_Check(PyList_GET_ITEM(list, i))) return 0;
    return 1;
}

/* x.<attr> for each x in `it`, added to the set `out`; with `filter`, only
 * those that are in `filter` (the `in` operator). */
static int add_attrs(PyObject *out, PyObject *it, PyObject *attr, PyObject *filter) {
    PyObject *iter = PyObject_GetIter(it);
    if (!iter) return -1;
    PyObject *x;
    int r = 0;
    while (r == 0 && (x = PyIter_Next(iter))) {
        PyObject *v = PyObject_GetAttr(x, attr);
        Py_DECREF(x);
        if (!v) {
            r = -1;
            break;
        }
        int in = filter ? PySequence_Contains(filter, v) : 1;
        if (in < 0 || (in && PySet_Add(out, v) < 0)) r = -1;
        Py_DECREF(v);
    }
    Py_DECREF(iter);
    return r < 0 || PyErr_Occurred() ? -1 : 0;
}

/* x.<attr> for each x in `it`, a list (new reference). */
static PyObject *attrs(PyObject *it, PyObject *attr) {
    PyObject *iter = PyObject_GetIter(it);
    if (!iter) return NULL;
    PyObject *out = PyList_New(0), *x;
    while (out && (x = PyIter_Next(iter))) {
        PyObject *v = PyObject_GetAttr(x, attr);
        Py_DECREF(x);
        if (!v || PyList_Append(out, v) < 0) Py_CLEAR(out);
        Py_XDECREF(v);
    }
    Py_DECREF(iter);
    if (PyErr_Occurred()) Py_CLEAR(out);
    return out;
}

/* sorted({r.name for g in gangs for grp in g.spec.pod_groups for r in
 * grp.pod_references if r.name in pods_by_name}), a new reference. */
static PyObject *ref_names(PyObject *gangs, PyObject *pods_by_name) {
    PyObject *set = PySet_New(NULL), *specs = NULL, *list = NULL;
    if (!set || !(specs = attrs(gangs, S_spec))) goto done;
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(specs); i++) {
        PyObject *groups = PyObject_GetAttr(PyList_GET_ITEM(specs, i), S_pod_groups);
        PyObject *refs = groups ? attrs(groups, S_pod_references) : NULL;
        Py_XDECREF(groups);
        if (!refs) goto done;
        for (Py_ssize_t j = 0; j < PyList_GET_SIZE(refs); j++) {
            if (add_attrs(set, PyList_GET_ITEM(refs, j), S_name, pods_by_name) < 0) {
                Py_DECREF(refs);
                goto done;
            }
        }
        Py_DECREF(refs);
    }
    list = PySequence_List(set);
    if (list && PyList_Sort(list) < 0) Py_CLEAR(list);
done:
    Py_XDECREF(set);
    Py_XDECREF(specs);
    return list;
}

/* pods_by_name[n] for each of the sorted names, a list (new reference). */
static PyObject *pods_of(PyObject *names, PyObject *pods_by_name) {
    Py_ssize_t n = PyList_GET_SIZE(names);
    PyObject *pods = PyList_New(n);
    for (Py_ssize_t i = 0; pods && i < n; i++) {
        PyObject *pod = PyObject_GetItem(pods_by_name, PyList_GET_ITEM(names, i));
        if (!pod) Py_CLEAR(pods);
        else PyList_SET_ITEM(pods, i, pod);
    }
    return pods;
}

/* {names[i]: pods[i]}. */
static int put_pods(Out *o, PyObject *names, PyObject *pods) {
    int r = PUT_LIT(o, "{");
    for (Py_ssize_t i = 0; r == 0 && i < PyList_GET_SIZE(names); i++) {
        if (i) r = PUT_LIT(o, ", ");
        if (r == 0) r = put_str(o, PyList_GET_ITEM(names, i));
        if (r == 0) r = PUT_LIT(o, ": ");
        if (r == 0) r = render_held(o, PyList_GET_ITEM(pods, i));
    }
    return r < 0 ? -1 : PUT_LIT(o, "}");
}

static void read_cell(const Py_buffer *v, Py_ssize_t i, Py_ssize_t j, double *out) {
    const char *p = (const char *)v->buf + i * v->strides[0] + j * v->strides[1];
    if (v->format[0] == 'f') {
        float f;
        memcpy(&f, p, sizeof f);
        *out = f;
    } else {
        memcpy(out, p, sizeof *out);
    }
}

/* {node_names[i]: row i as floats} for the real rows with any allocation
 * (numpy's nonzero: NaN counts), from a 2-D float32 or float64 buffer;
 * anything else takes the general path (-2 where the caller must rewind:
 * a name that is not a str). Node names are unique in a snapshot (its
 * node_index_map). */
static int put_allocated(Out *o, const Wave *w) {
    PyObject *alloc = ITEM(w, C_ALLOC);
    PyObject *node_names = ITEM(w, C_NODE_NAMES);
    Py_buffer v;
    if (!PyList_CheckExact(node_names) || PyObject_GetBuffer(alloc, &v, PyBUF_RECORDS_RO) < 0) {
        PyErr_Clear();
        return put_field(o, "allocated", w);
    }
    if (v.ndim != 2 || !v.format || v.format[1] != '\0' ||
        (v.format[0] != 'f' && v.format[0] != 'd') ||
        v.itemsize != (v.format[0] == 'f' ? 4 : 8)) {
        PyBuffer_Release(&v);
        return put_field(o, "allocated", w);
    }
    Py_ssize_t rows = PyList_GET_SIZE(node_names), cols = v.shape[1];
    if (rows > v.shape[0]) rows = v.shape[0];
    int r = PUT_LIT(o, "{"), first = 1;
    for (Py_ssize_t i = 0; r == 0 && i < rows; i++) {
        int any = 0;
        double x;
        for (Py_ssize_t j = 0; j < cols && !any; j++) {
            read_cell(&v, i, j, &x);
            any = x != 0.0;
        }
        if (!any) continue;
        PyObject *name = PyList_GET_ITEM(node_names, i);
        if (!PyUnicode_Check(name)) {
            /* A non-str key: the general path's dict. */
            PyBuffer_Release(&v);
            return -2;
        }
        if (!first) r = PUT_LIT(o, ", ");
        first = 0;
        if (r == 0) r = put_str(o, name);
        if (r == 0) r = PUT_LIT(o, ": [");
        for (Py_ssize_t j = 0; r == 0 && j < cols; j++) {
            read_cell(&v, i, j, &x);
            if (j) r = PUT_LIT(o, ", ");
            if (r == 0) r = put_double(o, x);
        }
        if (r == 0) r = PUT_LIT(o, "]");
    }
    PyBuffer_Release(&v);
    return r < 0 ? -1 : PUT_LIT(o, "}");
}

/* {g: dict(b)}: the plan itself when it is a dict of dicts. */
static int put_plan(Out *o, const Wave *w) {
    PyObject *plan = ITEM(w, C_PLAN);
    if (!PyDict_CheckExact(plan)) return put_field(o, "plan", w);
    Py_ssize_t pos = 0;
    PyObject *k, *b;
    while (PyDict_Next(plan, &pos, &k, &b))
        if (!PyDict_CheckExact(b)) return put_field(o, "plan", w);
    return render(o, plan);
}

/* An empty dict filtered by name is "{}"; any other takes the general
 * path. */
static int put_filtered(Out *o, const Wave *w, int slot, const char *key) {
    PyObject *d = ITEM(w, slot);
    if (PyDict_CheckExact(d) && PyDict_GET_SIZE(d) == 0) return PUT_LIT(o, "{}");
    return put_field(o, key, w);
}

/* {str(n): [float(v) for v in row]} for a dict with str keys. */
static int put_free_rows(Out *o, const Wave *w) {
    PyObject *d = ITEM(w, C_FREE_ROWS);
    Py_ssize_t pos = 0;
    PyObject *k, *row;
    if (!PyDict_CheckExact(d)) return put_field(o, "freeRows", w);
    while (PyDict_Next(d, &pos, &k, &row))
        if (!PyUnicode_CheckExact(k)) return put_field(o, "freeRows", w);
    int r = PUT_LIT(o, "{");
    pos = 0;
    for (int first = 1; r == 0 && PyDict_Next(d, &pos, &k, &row); first = 0) {
        Py_INCREF(k);
        Py_INCREF(row);
        if (!first) r = PUT_LIT(o, ", ");
        if (r == 0) r = put_str(o, k);
        if (r == 0) r = PUT_LIT(o, ": ");
        if (r == 0) r = put_converted(o, row, 1);
        Py_DECREF(k);
        Py_DECREF(row);
    }
    return r < 0 ? -1 : PUT_LIT(o, "}");
}

#define TRY(e) \
    if ((e) < 0) goto done

static int put_wave(Out *o, const Wave *w) {
    int r = -1;
    PyObject *names = PySet_New(NULL), *sorted_names = NULL, *pod_names = NULL, *pods = NULL;
    if (!names) return -1;
    /* {g.name for g in gangs}: its own order is the rejections' order. */
    if (add_attrs(names, ITEM(w, C_GANGS), S_name, NULL) < 0) goto done;
    sorted_names = PySequence_List(names);
    if (!sorted_names || PyList_Sort(sorted_names) < 0) goto done;
    TRY(PUT_LIT(o, "{\"kind\": \"wave\", \"now\": "));
    TRY(put_float_of(o, ITEM(w, C_NOW)));
    TRY(PUT_LIT(o, ", \"wave\": "));
    TRY(render(o, ITEM(w, C_WAVE)));
    TRY(PUT_LIT(o, ", \"fleet\": "));
    TRY(render(o, ITEM(w, C_FLEET)));
    TRY(PUT_LIT(o, ", \"padNodesTo\": "));
    TRY(put_int_of(o, ITEM(w, C_PAD_NODES)));
    TRY(PUT_LIT(o, ", \"resources\": "));
    PyObject *res = ITEM(w, C_RESOURCES);
    if (PyTuple_CheckExact(res) || PyList_CheckExact(res)) {
        TRY(render_items(o, res, PyList_CheckExact(res)));
    } else {
        TRY(put_field(o, "resources", w));
    }
    TRY(PUT_LIT(o, ", \"allocated\": "));
    Py_ssize_t mark = o->len;
    int a = put_allocated(o, w);
    if (a == -2) {
        o->len = mark;
        a = put_field(o, "allocated", w);
    }
    TRY(a);
    /* The pods the gangs reference, fetched (as the general path builds its
     * dict) before anything of the gangs is rendered. */
    pod_names = ref_names(ITEM(w, C_GANGS), ITEM(w, C_PODS_BY_NAME));
    if (!pod_names) goto done;
    if (all_str(pod_names)) {
        pods = pods_of(pod_names, ITEM(w, C_PODS_BY_NAME));
        if (!pods) goto done;
    }
    TRY(PUT_LIT(o, ", \"gangs\": "));
    TRY(render(o, ITEM(w, C_GANGS)));
    TRY(PUT_LIT(o, ", \"pods\": "));
    TRY(pods ? put_pods(o, pod_names, pods) : put_field(o, "pods", w));
    TRY(PUT_LIT(o, ", \"scheduled\": "));
    PyObject *sched = PySequence_List(ITEM(w, C_SCHEDULED));
    if (!sched) goto done;
    int sr = PyList_Sort(sched);
    if (sr == 0) sr = render(o, sched);
    Py_DECREF(sched);
    TRY(sr);
    TRY(PUT_LIT(o, ", \"boundNodes\": "));
    TRY(put_filtered(o, w, C_BOUND_NODES, "boundNodes"));
    TRY(PUT_LIT(o, ", \"reuseNodes\": "));
    TRY(put_filtered(o, w, C_REUSE_NODES, "reuseNodes"));
    TRY(PUT_LIT(o, ", \"spreadAvoid\": "));
    TRY(put_filtered(o, w, C_SPREAD_AVOID, "spreadAvoid"));
    TRY(PUT_LIT(o, ", \"maxGroups\": "));
    TRY(render(o, ITEM(w, C_MAX_GROUPS)));
    TRY(PUT_LIT(o, ", \"maxSets\": "));
    TRY(render(o, ITEM(w, C_MAX_SETS)));
    TRY(PUT_LIT(o, ", \"maxPods\": "));
    TRY(render(o, ITEM(w, C_MAX_PODS)));
    TRY(PUT_LIT(o, ", \"padGangsTo\": "));
    TRY(render(o, ITEM(w, C_PAD_GANGS_TO)));
    TRY(PUT_LIT(o, ", \"solver\": {\"params\": "));
    TRY(put_converted(o, ITEM(w, C_PARAMS), 1));
    TRY(PUT_LIT(o, ", \"portfolio\": "));
    TRY(put_int_of(o, ITEM(w, C_PORTFOLIO)));
    TRY(PUT_LIT(o, ", \"escalatePortfolio\": "));
    TRY(put_int_of(o, ITEM(w, C_ESCALATE_PORTFOLIO)));
    TRY(PUT_LIT(o, ", \"mesh\": "));
    TRY(render(o, ITEM(w, C_MESH)));
    TRY(PUT_LIT(o, ", \"pruning\": "));
    TRY(render(o, ITEM(w, C_PRUNING)));
    TRY(PUT_LIT(o, "}, \"plan\": "));
    TRY(put_plan(o, w));
    if (all_str(sorted_names)) {
        TRY(PUT_LIT(o, ", \"ok\": "));
        TRY(put_verdicts(o, sorted_names, ITEM(w, C_OK), 0));
        TRY(PUT_LIT(o, ", \"valid\": "));
        TRY(put_verdicts(o, sorted_names, ITEM(w, C_VALID), 0));
        TRY(PUT_LIT(o, ", \"scores\": "));
        TRY(put_verdicts(o, sorted_names, ITEM(w, C_SCORES), 1));
        TRY(PUT_LIT(o, ", \"rejections\": "));
        TRY(put_rejections(o, names, ITEM(w, C_OK), ITEM(w, C_VALID)));
    } else {
        TRY(PUT_LIT(o, ", \"ok\": "));
        TRY(put_field(o, "ok", w));
        TRY(PUT_LIT(o, ", \"valid\": "));
        TRY(put_field(o, "valid", w));
        TRY(PUT_LIT(o, ", \"scores\": "));
        TRY(put_field(o, "scores", w));
        TRY(PUT_LIT(o, ", \"rejections\": "));
        TRY(put_field(o, "rejections", w));
    }
    TRY(PUT_LIT(o, ", \"solveSeconds\": "));
    TRY(put_float_of(o, ITEM(w, C_SOLVE_SECONDS)));
    int fr = PyObject_IsTrue(ITEM(w, C_FREE_ROWS));
    TRY(fr);
    if (fr) {
        TRY(PUT_LIT(o, ", \"freeRows\": "));
        TRY(put_free_rows(o, w));
    }
    PyObject *cand = ITEM(w, C_CANDIDATES);
    if (cand != Py_None) {
        TRY(PUT_LIT(o, ", \"candidates\": "));
        TRY(put_converted(o, cand, 0));
    }
    r = PUT_LIT(o, "}");
done:
    Py_DECREF(names);
    Py_XDECREF(sorted_names);
    Py_XDECREF(pod_names);
    Py_XDECREF(pods);
    return r;
}

static PyObject *py_render_wave(PyObject *Py_UNUSED(self), PyObject *args) {
    Wave wv;
    if (!PyArg_ParseTuple(args, "O!O", &PyTuple_Type, &wv.cap, &wv.field)) return NULL;
    if (!kinds) {
        PyErr_SetString(PyExc_RuntimeError, "serde_render: configure() was not called");
        return NULL;
    }
    if (PyTuple_GET_SIZE(wv.cap) != C_COUNT) {
        PyErr_Format(PyExc_TypeError, "render_wave: a capture tuple of %d items", C_COUNT);
        return NULL;
    }
    Out o;
    if (out_open(&o, 1 << 16) < 0) return NULL;
    return out_close(&o, put_wave(&o, &wv) == 0, 1);
}

/* ---- the fleet comparison ------------------------------------------------- */

static PyObject *S_node_names, *S_resource_names, *S_capacity, *S_schedulable,
    *S_node_labels, *S_node_taints, *S_topology, *S_levels;

/* 1 when the first n rows of two C-contiguous buffers of one format hold
 * the same bytes, 0 when not, -1 when they cannot be compared here. */
static int same_rows(PyObject *a, PyObject *b, Py_ssize_t n) {
    Py_buffer va, vb;
    if (PyObject_GetBuffer(a, &va, PyBUF_FORMAT | PyBUF_C_CONTIGUOUS) < 0) {
        PyErr_Clear();
        return -1;
    }
    if (PyObject_GetBuffer(b, &vb, PyBUF_FORMAT | PyBUF_C_CONTIGUOUS) < 0) {
        PyErr_Clear();
        PyBuffer_Release(&va);
        return -1;
    }
    int r = -1;
    if (va.ndim >= 1 && va.ndim == vb.ndim && va.itemsize == vb.itemsize && va.format &&
        vb.format && strcmp(va.format, vb.format) == 0) {
        Py_ssize_t ra = va.shape[0] < n ? va.shape[0] : n;
        Py_ssize_t rb = vb.shape[0] < n ? vb.shape[0] : n;
        Py_ssize_t row_a = va.shape[0] ? va.len / va.shape[0] : 0;
        Py_ssize_t row_b = vb.shape[0] ? vb.len / vb.shape[0] : 0;
        r = ra * row_a == rb * row_b && memcmp(va.buf, vb.buf, (size_t)(ra * row_a)) == 0;
    }
    PyBuffer_Release(&va);
    PyBuffer_Release(&vb);
    return r;
}

/* 1 when a.<attr> == b.<attr>, 0 when not, -1 on an error. */
static int same_attr(PyObject *a, PyObject *b, PyObject *attr) {
    PyObject *x = PyObject_GetAttr(a, attr);
    if (!x) return -1;
    PyObject *y = PyObject_GetAttr(b, attr);
    if (!y) {
        Py_DECREF(x);
        return -1;
    }
    int r = PyObject_RichCompareBool(x, y, Py_EQ);
    Py_DECREF(x);
    Py_DECREF(y);
    return r;
}

/* same_fleet(a, b): False when the two snapshots' fleets differ in their
 * names, resources, capacity, schedulable rows, labels or taints; True when
 * they are equal and their topologies are one object or have equal levels;
 * None when the rest cannot be decided here (the caller compares the
 * topologies' level documents, or the arrays). */
static PyObject *py_same_fleet(PyObject *Py_UNUSED(self), PyObject *args) {
    PyObject *a, *b;
    if (!PyArg_ParseTuple(args, "OO", &a, &b)) return NULL;
    int r = same_attr(a, b, S_node_names);
    if (r == 1) r = same_attr(a, b, S_resource_names);
    if (r < 0) return NULL;
    if (r == 0) Py_RETURN_FALSE;
    PyObject *names = PyObject_GetAttr(a, S_node_names);
    if (!names) return NULL;
    Py_ssize_t n = PyObject_Length(names);
    Py_DECREF(names);
    if (n < 0) return NULL;
    int undecided = 0;
    PyObject *arrays[2] = {S_capacity, S_schedulable};
    for (int i = 0; i < 2; i++) {
        PyObject *x = PyObject_GetAttr(a, arrays[i]);
        if (!x) return NULL;
        PyObject *y = PyObject_GetAttr(b, arrays[i]);
        if (!y) {
            Py_DECREF(x);
            return NULL;
        }
        int s = same_rows(x, y, n);
        Py_DECREF(x);
        Py_DECREF(y);
        if (s == 0) Py_RETURN_FALSE;
        if (s < 0) undecided = 1;
    }
    r = same_attr(a, b, S_node_labels);
    if (r == 1) r = same_attr(a, b, S_node_taints);
    if (r < 0) return NULL;
    if (r == 0) Py_RETURN_FALSE;
    if (undecided) Py_RETURN_NONE;
    PyObject *ta = PyObject_GetAttr(a, S_topology);
    if (!ta) return NULL;
    PyObject *tb = PyObject_GetAttr(b, S_topology);
    if (!tb) {
        Py_DECREF(ta);
        return NULL;
    }
    r = ta == tb ? 1 : same_attr(ta, tb, S_levels);
    Py_DECREF(ta);
    Py_DECREF(tb);
    if (r < 0) return NULL;
    if (r == 0) Py_RETURN_NONE;
    Py_RETURN_TRUE;
}

static PyObject *py_render(PyObject *Py_UNUSED(self), PyObject *x) {
    if (!kinds) {
        PyErr_SetString(PyExc_RuntimeError, "serde_render: configure() was not called");
        return NULL;
    }
    Out o;
    if (out_open(&o, 4096) < 0) return NULL;
    return out_close(&o, render(&o, x) == 0, 0);
}

static PyObject *py_configure(PyObject *Py_UNUSED(self), PyObject *args) {
    PyObject *k, *c, *f, *sc;
    if (!PyArg_ParseTuple(args, "O!OOO!", &PyDict_Type, &k, &c, &f, &PySet_Type, &sc))
        return NULL;
    Py_INCREF(k);
    Py_INCREF(c);
    Py_INCREF(f);
    Py_INCREF(sc);
    Py_XSETREF(kinds, k);
    Py_XSETREF(classify, c);
    Py_XSETREF(fallback, f);
    Py_XSETREF(scalars, sc);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"render", py_render, METH_O, "json.dumps(serde.encode(obj)) as ASCII bytes."},
    {"render_wave", py_render_wave, METH_VARARGS,
     "render_wave(capture, field): the JSON text of a wave record, as an ASCII "
     "bytearray (a let-go text's memory where there is one)."},
    {"recycle", py_recycle, METH_O,
     "recycle(texts): keep the let-go texts of a list for render_wave."},
    {"same_fleet", py_same_fleet, METH_VARARGS,
     "same_fleet(a, b): False, True, or None where the caller must decide."},
    {"configure", py_configure, METH_VARARGS,
     "configure(kinds, classify, fallback, scalars): the type table, its "
     "filler, the general path and the verdicts' scalar types."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_serde_render", NULL, -1, methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__serde_render(void) {
    struct {
        PyObject **slot;
        const char *text;
    } names[] = {
        {&S_name, "name"}, {&S_spec, "spec"}, {&S_pod_groups, "pod_groups"},
        {&S_pod_references, "pod_references"}, {&S_item, "item"}, {&S_get, "get"},
        {&S_node_names, "node_names"}, {&S_resource_names, "resource_names"},
        {&S_capacity, "capacity"}, {&S_schedulable, "schedulable"},
        {&S_node_labels, "node_labels"}, {&S_node_taints, "node_taints"},
        {&S_topology, "topology"}, {&S_levels, "levels"},
    };
    for (size_t i = 0; i < sizeof names / sizeof names[0]; i++) {
        if (!*names[i].slot) *names[i].slot = PyUnicode_InternFromString(names[i].text);
        if (!*names[i].slot) return NULL;
    }
    return PyModule_Create(&module);
}
