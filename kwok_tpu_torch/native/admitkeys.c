/* kwok_admitkeys: the admission keys of DeviceSimulator._classify in one
 * native pass over the admitted object.
 *
 * keys(trie, obj) walks the object once to check that it is
 * JSON-standard (every value exactly a dict, list, str, int, float,
 * bool or None; every dict key exactly a str), then writes two texts,
 * byte for byte what Python's json module writes:
 *
 *   - json.dumps({"spec": ..., "labels": ..., "annotations": ...,
 *     "ownerReferences": ...}, sort_keys=True, default=str), the text
 *     CompiledStageSet._signature_key hashes;
 *   - json.dumps(behaviour.project(obj, trie), sort_keys=True,
 *     default=str), the text of Regions.key.
 *
 * It returns (signature_text, region_text), or None when it refuses the
 * object: a value or key of another type, nesting deeper than
 * MAX_DEPTH, a metadata that is neither a dict nor falsy, or an int too
 * long for its repr.  A refused object takes the Python path, which
 * handles it as it always has.
 *
 * compile_trie(trie, iter) turns a Regions trie (str keys, the ITER
 * sentinel for "every element", None leaves for whole subtrees) into the
 * capsule keys() reads, its keys sorted as json sorts them.
 *
 * The encoder follows CPython's Modules/_json.c with the default
 * arguments of json.dumps: separators ", " and ": ", ensure_ascii
 * (\uXXXX in lowercase hex, astral characters as surrogate pairs),
 * allow_nan (NaN, Infinity, -Infinity), ints and finite floats through
 * their repr. */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdlib.h>
#include <string.h>

#define MAX_DEPTH 256
#define STACK_BYTES 4096
#define STACK_PAIRS 32

/* 0: done; REFUSE: the object takes the Python path; -1: a Python error */
#define REFUSE 1

static PyObject *s_metadata, *s_spec, *s_labels, *s_annotations, *s_ownerReferences;

/* ------------------------------------------------------------ output */

typedef struct {
    char *p;
    Py_ssize_t n, cap;
    char stack[STACK_BYTES];
} Buf;

static void buf_init(Buf *b) { b->p = b->stack; b->n = 0; b->cap = STACK_BYTES; }

static void buf_free(Buf *b) { if (b->p != b->stack) PyMem_Free(b->p); }

static int buf_reserve(Buf *b, Py_ssize_t extra) {
    if (b->n + extra <= b->cap)
        return 0;
    Py_ssize_t cap = b->cap;
    while (cap < b->n + extra)
        cap *= 2;
    char *p = PyMem_Malloc((size_t)cap);
    if (p == NULL) {
        PyErr_NoMemory();
        return -1;
    }
    memcpy(p, b->p, (size_t)b->n);
    buf_free(b);
    b->p = p;
    b->cap = cap;
    return 0;
}

static int buf_put(Buf *b, const char *s, Py_ssize_t n) {
    if (buf_reserve(b, n) < 0)
        return -1;
    memcpy(b->p + b->n, s, (size_t)n);
    b->n += n;
    return 0;
}

#define PUT_LIT(b, lit) buf_put((b), (lit), (Py_ssize_t)(sizeof(lit) - 1))

/* the text as a str: every byte written is ASCII */
static PyObject *buf_str(Buf *b) {
    PyObject *s = PyUnicode_New(b->n, 127);
    if (s != NULL)
        memcpy(PyUnicode_1BYTE_DATA(s), b->p, (size_t)b->n);
    return s;
}

/* ------------------------------------------------------------ strings */

static const char HEX[] = "0123456789abcdef";

/* json's S_CHAR: written as is under ensure_ascii */
#define PLAIN(c) ((c) >= ' ' && (c) <= '~' && (c) != '\\' && (c) != '"')

static char *escape(char *o, Py_UCS4 c) {
    *o++ = '\\';
    switch (c) {
    case '\\': *o++ = '\\'; return o;
    case '"': *o++ = '"'; return o;
    case '\b': *o++ = 'b'; return o;
    case '\f': *o++ = 'f'; return o;
    case '\n': *o++ = 'n'; return o;
    case '\r': *o++ = 'r'; return o;
    case '\t': *o++ = 't'; return o;
    }
    if (c >= 0x10000) {
        Py_UCS4 hi = 0xd800 | ((c - 0x10000) >> 10);
        *o++ = 'u';
        *o++ = HEX[(hi >> 12) & 0xf];
        *o++ = HEX[(hi >> 8) & 0xf];
        *o++ = HEX[(hi >> 4) & 0xf];
        *o++ = HEX[hi & 0xf];
        c = 0xdc00 | ((c - 0x10000) & 0x3ff);
        *o++ = '\\';
    }
    *o++ = 'u';
    *o++ = HEX[(c >> 12) & 0xf];
    *o++ = HEX[(c >> 8) & 0xf];
    *o++ = HEX[(c >> 4) & 0xf];
    *o++ = HEX[c & 0xf];
    return o;
}

static int put_str(Buf *b, PyObject *s) {
    Py_ssize_t len = PyUnicode_GET_LENGTH(s);
    if (PyUnicode_IS_ASCII(s)) {
        const unsigned char *d = PyUnicode_1BYTE_DATA(s);
        Py_ssize_t i = 0;
        while (i < len && PLAIN(d[i]))
            i++;
        if (i == len) {  /* nothing to escape: one copy */
            if (buf_reserve(b, len + 2) < 0)
                return -1;
            char *o = b->p + b->n;
            *o++ = '"';
            memcpy(o, d, (size_t)len);
            o[len] = '"';
            b->n += len + 2;
            return 0;
        }
    }
    /* at most 12 bytes a character (a surrogate pair), and the quotes */
    if (buf_reserve(b, 12 * len + 2) < 0)
        return -1;
    int kind = PyUnicode_KIND(s);
    const void *data = PyUnicode_DATA(s);
    char *o = b->p + b->n;
    *o++ = '"';
    for (Py_ssize_t i = 0; i < len; i++) {
        Py_UCS4 c = PyUnicode_READ(kind, data, i);
        if (PLAIN(c))
            *o++ = (char)c;
        else
            o = escape(o, c);
    }
    *o++ = '"';
    b->n = o - b->p;
    return 0;
}

/* ------------------------------------------------------------ numbers */

static int put_int(Buf *b, PyObject *v) {
    PyObject *r = PyLong_Type.tp_repr(v);
    if (r == NULL) {
        if (PyErr_ExceptionMatches(PyExc_ValueError)) {  /* past the int's digit limit */
            PyErr_Clear();
            return REFUSE;
        }
        return -1;
    }
    int rc = buf_put(b, (const char *)PyUnicode_1BYTE_DATA(r), PyUnicode_GET_LENGTH(r));
    Py_DECREF(r);
    return rc;
}

static int put_float(Buf *b, PyObject *v) {
    double x = PyFloat_AS_DOUBLE(v);
    if (!Py_IS_FINITE(x)) {
        if (x > 0)
            return PUT_LIT(b, "Infinity");
        if (x < 0)
            return PUT_LIT(b, "-Infinity");
        return PUT_LIT(b, "NaN");
    }
    char *r = PyOS_double_to_string(x, 'r', 0, Py_DTSF_ADD_DOT_0, NULL);
    if (r == NULL)
        return -1;
    int rc = buf_put(b, r, (Py_ssize_t)strlen(r));
    PyMem_Free(r);
    return rc;
}

/* ------------------------------------------------------------ keys */

/* code point order, as Python orders str */
static int key_cmp(PyObject *a, PyObject *b) {
    if (PyUnicode_IS_ASCII(a) && PyUnicode_IS_ASCII(b)) {
        Py_ssize_t la = PyUnicode_GET_LENGTH(a), lb = PyUnicode_GET_LENGTH(b);
        int c = memcmp(PyUnicode_1BYTE_DATA(a), PyUnicode_1BYTE_DATA(b),
                       (size_t)(la < lb ? la : lb));
        if (c)
            return c;
        return la < lb ? -1 : la > lb;
    }
    return PyUnicode_Compare(a, b);  /* cannot fail for two str */
}

typedef struct {
    PyObject *k, *v;
} Pair;

static int pair_cmp(const void *a, const void *b) {
    return key_cmp(((const Pair *)a)->k, ((const Pair *)b)->k);
}

/* ------------------------------------------------------------ checking */

static int standard(PyObject *v, int depth) {
    if (depth > MAX_DEPTH)
        return REFUSE;
    PyTypeObject *t = Py_TYPE(v);
    if (t == &PyDict_Type) {
        Py_ssize_t pos = 0;
        PyObject *k, *x;
        while (PyDict_Next(v, &pos, &k, &x)) {
            if (!PyUnicode_CheckExact(k))
                return REFUSE;
            int rc = standard(x, depth + 1);
            if (rc)
                return rc;
        }
        return 0;
    }
    if (t == &PyList_Type) {
        for (Py_ssize_t i = 0; i < PyList_GET_SIZE(v); i++) {
            int rc = standard(PyList_GET_ITEM(v, i), depth + 1);
            if (rc)
                return rc;
        }
        return 0;
    }
    if (t == &PyUnicode_Type || t == &PyLong_Type || t == &PyFloat_Type || t == &PyBool_Type ||
        v == Py_None)
        return 0;
    return REFUSE;
}

/* ------------------------------------------------------------ encoding */

static int put_value(Buf *b, PyObject *v);

static int put_dict(Buf *b, PyObject *d) {
    Py_ssize_t n = PyDict_GET_SIZE(d);
    if (n == 0)
        return PUT_LIT(b, "{}");
    Pair stack[STACK_PAIRS];
    Pair *pairs = n <= STACK_PAIRS ? stack : PyMem_Malloc(sizeof(Pair) * (size_t)n);
    if (pairs == NULL) {
        PyErr_NoMemory();
        return -1;
    }
    Py_ssize_t pos = 0, i = 0;
    PyObject *k, *v;
    while (PyDict_Next(d, &pos, &k, &v)) {
        pairs[i].k = k;
        pairs[i].v = v;
        i++;
    }
    qsort(pairs, (size_t)n, sizeof(Pair), pair_cmp);
    int rc = PUT_LIT(b, "{");
    for (i = 0; i < n && rc == 0; i++) {
        if (i)
            rc = PUT_LIT(b, ", ");
        if (rc == 0)
            rc = put_str(b, pairs[i].k);
        if (rc == 0)
            rc = PUT_LIT(b, ": ");
        if (rc == 0)
            rc = put_value(b, pairs[i].v);
    }
    if (rc == 0)
        rc = PUT_LIT(b, "}");
    if (pairs != stack)
        PyMem_Free(pairs);
    return rc;
}

static int put_list(Buf *b, PyObject *l) {
    int rc = PUT_LIT(b, "[");
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(l) && rc == 0; i++) {
        if (i)
            rc = PUT_LIT(b, ", ");
        if (rc == 0)
            rc = put_value(b, PyList_GET_ITEM(l, i));
    }
    return rc ? rc : PUT_LIT(b, "]");
}

/* a value the check passed */
static int put_value(Buf *b, PyObject *v) {
    PyTypeObject *t = Py_TYPE(v);
    if (t == &PyUnicode_Type)
        return put_str(b, v);
    if (t == &PyDict_Type)
        return put_dict(b, v);
    if (t == &PyList_Type)
        return put_list(b, v);
    if (v == Py_None)
        return PUT_LIT(b, "null");
    if (v == Py_True)
        return PUT_LIT(b, "true");
    if (v == Py_False)
        return PUT_LIT(b, "false");
    if (t == &PyLong_Type)
        return put_int(b, v);
    if (t == &PyFloat_Type)
        return put_float(b, v);
    return REFUSE;
}

/* ------------------------------------------------------------ the trie */

typedef struct Node {
    Py_ssize_t n;          /* named steps, sorted by key */
    PyObject **keys;       /* str, owned */
    struct Node **subs;    /* NULL: the whole value under that key */
    int iter;              /* has an ITER step */
    struct Node *elem;     /* under ITER; NULL: each whole element */
} Node;

static void node_free(Node *t) {
    if (t == NULL)
        return;
    for (Py_ssize_t i = 0; i < t->n; i++) {
        Py_XDECREF(t->keys[i]);
        node_free(t->subs[i]);
    }
    PyMem_Free(t->keys);
    PyMem_Free(t->subs);
    node_free(t->elem);
    PyMem_Free(t);
}

static Node *node_compile(PyObject *trie, PyObject *iter, int depth) {
    if (!PyDict_CheckExact(trie) || depth > MAX_DEPTH) {
        PyErr_SetString(PyExc_TypeError, "a trie is a dict of str or ITER to a trie or None");
        return NULL;
    }
    Py_ssize_t n = PyDict_GET_SIZE(trie);
    Node *t = PyMem_Calloc(1, sizeof(Node));
    if (t == NULL)
        return (Node *)PyErr_NoMemory();
    t->keys = PyMem_Calloc((size_t)n + 1, sizeof(PyObject *));
    t->subs = PyMem_Calloc((size_t)n + 1, sizeof(Node *));
    if (t->keys == NULL || t->subs == NULL) {
        node_free(t);
        return (Node *)PyErr_NoMemory();
    }
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    while (PyDict_Next(trie, &pos, &k, &v)) {
        Node *sub = NULL;
        if (v != Py_None && (sub = node_compile(v, iter, depth + 1)) == NULL) {
            node_free(t);
            return NULL;
        }
        if (k == iter) {
            t->iter = 1;
            t->elem = sub;
            continue;
        }
        if (!PyUnicode_CheckExact(k)) {
            node_free(sub);
            node_free(t);
            PyErr_SetString(PyExc_TypeError, "a trie's step is a str or ITER");
            return NULL;
        }
        /* insertion in key order */
        Py_ssize_t j = t->n;
        for (; j > 0 && key_cmp(t->keys[j - 1], k) > 0; j--) {
            t->keys[j] = t->keys[j - 1];
            t->subs[j] = t->subs[j - 1];
        }
        Py_INCREF(k);
        t->keys[j] = k;
        t->subs[j] = sub;
        t->n++;
    }
    return t;
}

static void trie_destroy(PyObject *capsule) {
    node_free(PyCapsule_GetPointer(capsule, "kwok_admitkeys.trie"));
}

/* json.dumps(project(v, t)) */
static int put_projected(Buf *b, PyObject *v, const Node *t) {
    if (t == NULL)
        return put_value(b, v);
    if (PyDict_CheckExact(v)) {
        if (t->iter)
            return put_value(b, v);
        int rc = PUT_LIT(b, "{");
        int first = 1;
        for (Py_ssize_t i = 0; i < t->n && rc == 0; i++) {
            PyObject *x = PyDict_GetItemWithError(v, t->keys[i]);
            if (x == NULL) {
                if (PyErr_Occurred())
                    return -1;
                continue;
            }
            if (!first)
                rc = PUT_LIT(b, ", ");
            first = 0;
            if (rc == 0)
                rc = put_str(b, t->keys[i]);
            if (rc == 0)
                rc = PUT_LIT(b, ": ");
            if (rc == 0)
                rc = put_projected(b, x, t->subs[i]);
        }
        return rc ? rc : PUT_LIT(b, "}");
    }
    if (PyList_CheckExact(v) && t->iter) {
        int rc = PUT_LIT(b, "[");
        for (Py_ssize_t i = 0; i < PyList_GET_SIZE(v) && rc == 0; i++) {
            if (i)
                rc = PUT_LIT(b, ", ");
            if (rc == 0)
                rc = put_projected(b, PyList_GET_ITEM(v, i), t->elem);
        }
        return rc ? rc : PUT_LIT(b, "]");
    }
    return put_value(b, v);
}

/* ------------------------------------------------------------ the pass */

static PyObject *get(PyObject *d, PyObject *key) {
    PyObject *v = PyDict_GetItemWithError(d, key);
    return v != NULL || PyErr_Occurred() ? v : Py_None;
}

/* the signature's text: its four parts, sorted by name */
static int put_signature(Buf *b, PyObject *obj) {
    PyObject *meta = get(obj, s_metadata), *spec = get(obj, s_spec);
    PyObject *labels = Py_None, *ann = Py_None, *owners = Py_None;
    if (meta == NULL || spec == NULL)
        return -1;
    int truthy = PyObject_IsTrue(meta);
    if (truthy < 0)
        return -1;
    if (truthy) {  /* obj.get("metadata") or {} */
        if (!PyDict_CheckExact(meta))
            return REFUSE;
        if ((labels = get(meta, s_labels)) == NULL || (ann = get(meta, s_annotations)) == NULL ||
            (owners = get(meta, s_ownerReferences)) == NULL)
            return -1;
    }
    int rc = PUT_LIT(b, "{\"annotations\": ");
    if (rc == 0)
        rc = put_value(b, ann);
    if (rc == 0)
        rc = PUT_LIT(b, ", \"labels\": ");
    if (rc == 0)
        rc = put_value(b, labels);
    if (rc == 0)
        rc = PUT_LIT(b, ", \"ownerReferences\": ");
    if (rc == 0)
        rc = put_value(b, owners);
    if (rc == 0)
        rc = PUT_LIT(b, ", \"spec\": ");
    if (rc == 0)
        rc = put_value(b, spec);
    return rc ? rc : PUT_LIT(b, "}");
}

static PyObject *py_keys(PyObject *self, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "keys(trie, obj) takes two arguments");
        return NULL;
    }
    PyObject *cap = args[0], *obj = args[1];
    const Node *trie = PyCapsule_GetPointer(cap, "kwok_admitkeys.trie");
    if (trie == NULL)
        return NULL;
    if (!PyDict_CheckExact(obj) || standard(obj, 0))
        Py_RETURN_NONE;
    Buf sig, region;
    buf_init(&sig);
    buf_init(&region);
    PyObject *out = NULL;
    int rc = put_signature(&sig, obj);
    if (rc == 0)
        rc = put_projected(&region, obj, trie);
    if (rc == REFUSE) {
        out = Py_NewRef(Py_None);
    } else if (rc == 0) {
        PyObject *a = buf_str(&sig);
        PyObject *r = a == NULL ? NULL : buf_str(&region);
        if (r != NULL)
            out = PyTuple_Pack(2, a, r);
        Py_XDECREF(a);
        Py_XDECREF(r);
    }
    buf_free(&sig);
    buf_free(&region);
    return out;
}

static PyObject *py_compile_trie(PyObject *self, PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 2) {
        PyErr_SetString(PyExc_TypeError, "compile_trie(trie, iter) takes two arguments");
        return NULL;
    }
    Node *t = node_compile(args[0], args[1], 0);
    if (t == NULL)
        return NULL;
    PyObject *cap = PyCapsule_New(t, "kwok_admitkeys.trie", trie_destroy);
    if (cap == NULL)
        node_free(t);
    return cap;
}

static PyMethodDef Methods[] = {
    {"keys", (PyCFunction)(void (*)(void))py_keys, METH_FASTCALL,
     "keys(trie, obj) -> (signature_text, region_text) or None"},
    {"compile_trie", (PyCFunction)(void (*)(void))py_compile_trie, METH_FASTCALL,
     "compile_trie(trie, iter) -> the trie as keys() reads it"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "kwok_admitkeys", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit_kwok_admitkeys(void) {
    if (!(s_metadata = PyUnicode_InternFromString("metadata")) ||
        !(s_spec = PyUnicode_InternFromString("spec")) ||
        !(s_labels = PyUnicode_InternFromString("labels")) ||
        !(s_annotations = PyUnicode_InternFromString("annotations")) ||
        !(s_ownerReferences = PyUnicode_InternFromString("ownerReferences")))
        return NULL;
    return PyModule_Create(&moduledef);
}
