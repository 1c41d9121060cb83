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
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdio.h>
#include <string.h>

enum { KIND_FALLBACK = 0, KIND_LIST = 1, KIND_TUPLE = 2, KIND_DICT = 3 };

/* type -> int kind, or (head bytes, names tuple, keys tuple of bytes) for a
 * dataclass; filled by `classify` (serde.py) on a type's first sight. */
static PyObject *kinds = NULL;
static PyObject *classify = NULL;
static PyObject *fallback = NULL;

typedef struct {
    char *buf;
    Py_ssize_t len, cap;
} Out;

static int out_grow(Out *o, Py_ssize_t need) {
    if (o->len + need <= o->cap) return 0;
    Py_ssize_t cap = o->cap ? o->cap : 4096;
    while (cap < o->len + need) cap *= 2;
    char *b = PyMem_Realloc(o->buf, cap);
    if (!b) {
        PyErr_NoMemory();
        return -1;
    }
    o->buf = b;
    o->cap = cap;
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
        char b[32];
        int n = snprintf(b, sizeof b, "%lld", v);
        return out_put(o, b, n);
    }
    if (PyFloat_Check(x)) {
        double v = PyFloat_AS_DOUBLE(x);
        if (isnan(v)) return PUT_LIT(o, "NaN");
        if (isinf(v)) return v > 0 ? PUT_LIT(o, "Infinity") : PUT_LIT(o, "-Infinity");
        return put_repr(o, PyFloat_Type.tp_repr, x);
    }
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

static PyObject *py_render(PyObject *Py_UNUSED(self), PyObject *x) {
    if (!kinds) {
        PyErr_SetString(PyExc_RuntimeError, "serde_render: configure() was not called");
        return NULL;
    }
    Out o = {NULL, 0, 0};
    PyObject *res = NULL;
    if (render(&o, x) == 0) res = PyBytes_FromStringAndSize(o.buf ? o.buf : "", o.len);
    PyMem_Free(o.buf);
    return res;
}

static PyObject *py_configure(PyObject *Py_UNUSED(self), PyObject *args) {
    PyObject *k, *c, *f;
    if (!PyArg_ParseTuple(args, "O!OO", &PyDict_Type, &k, &c, &f)) return NULL;
    Py_INCREF(k);
    Py_INCREF(c);
    Py_INCREF(f);
    Py_XSETREF(kinds, k);
    Py_XSETREF(classify, c);
    Py_XSETREF(fallback, f);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"render", py_render, METH_O, "json.dumps(serde.encode(obj)) as ASCII bytes."},
    {"configure", py_configure, METH_VARARGS,
     "configure(kinds, classify, fallback): the type table, its filler and the "
     "general path."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_serde_render", NULL, -1, methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__serde_render(void) { return PyModule_Create(&module); }
