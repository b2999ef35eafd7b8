/* Native row-hashing kernel for the host-side runtime.
 *
 * The engine's relational plane hashes object columns (string join keys,
 * group-by values, row digests for consolidation) on every tick; doing that
 * per row through Python frames + hashlib dominates string-keyed pipelines.
 * This module walks the numpy object array in C and computes the framework's
 * stable 64-bit hash ("pwhash64": splitmix64 over zero-padded little-endian
 * 8-byte chunks, seeded with a type tag and the length) for the common scalar
 * types; exotic values (tuples, ndarrays, Json) call back into the Python
 * fallback so both paths always agree.
 *
 * The pure-Python mirror lives in internals/keys.py; the two MUST stay
 * bit-identical — a cluster where one process builds the extension and
 * another does not still exchanges blocks by the same key hashes.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>
#include <stdint.h>
#include <string.h>

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

static uint64_t pwhash_bytes(const unsigned char *p, Py_ssize_t n, uint64_t tag,
                             uint64_t salt) {
    uint64_t h = splitmix64(tag ^ salt ^ (uint64_t)n);
    Py_ssize_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t chunk;
        memcpy(&chunk, p + i, 8);
        h = splitmix64(h ^ chunk);
    }
    if (i < n) {
        uint64_t chunk = 0;
        memcpy(&chunk, p + i, (size_t)(n - i));
        h = splitmix64(h ^ chunk);
    }
    return h;
}

#define NONE_SEED 0xA5C9ULL

static int hash_one(PyObject *v, PyObject *fallback, uint64_t salt, uint64_t *out) {
    /* salt is xor-ed into every pre-mix value (no-op when 0), mirroring
     * internals/keys.py stable_hash_obj exactly */
    if (v == Py_None) {
        *out = splitmix64(splitmix64(NONE_SEED ^ salt));
        return 0;
    }
    if (PyBool_Check(v)) {
        *out = splitmix64((v == Py_True ? 1 : 0) ^ salt);
        return 0;
    }
    if (PyLong_Check(v)) {
        int overflow = 0;
        long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (!overflow && !(x == -1 && PyErr_Occurred())) {
            *out = splitmix64((uint64_t)x ^ salt);
            return 0;
        }
        PyErr_Clear();
        unsigned long long ux = PyLong_AsUnsignedLongLongMask(v);
        PyErr_Clear();
        *out = splitmix64((uint64_t)ux ^ salt);
        return 0;
    }
    if (PyFloat_Check(v)) {
        double d = PyFloat_AS_DOUBLE(v) + 0.0; /* normalize -0.0 */
        uint64_t bits;
        memcpy(&bits, &d, 8);
        *out = splitmix64(bits ^ salt);
        return 0;
    }
    if (PyUnicode_Check(v)) {
        Py_ssize_t len;
        const char *s = PyUnicode_AsUTF8AndSize(v, &len);
        if (s == NULL) return -1;
        *out = pwhash_bytes((const unsigned char *)s, len, 0x04, salt);
        return 0;
    }
    if (PyBytes_Check(v)) {
        *out = pwhash_bytes((const unsigned char *)PyBytes_AS_STRING(v),
                            PyBytes_GET_SIZE(v), 0x05, salt);
        return 0;
    }
    /* numpy scalars, tuples, arrays, Json, ... -> python fallback */
    PyObject *r = PyObject_CallFunctionObjArgs(fallback, v, NULL);
    if (r == NULL) return -1;
    PyObject *idx = PyNumber_Index(r);
    Py_DECREF(r);
    if (idx == NULL) return -1;
    unsigned long long h = PyLong_AsUnsignedLongLongMask(idx);
    Py_DECREF(idx);
    if (PyErr_Occurred()) return -1;
    *out = (uint64_t)h;
    return 0;
}

static PyObject *hash_obj_array(PyObject *self, PyObject *args) {
    PyObject *arr_obj, *fallback;
    unsigned long long salt = 0;
    if (!PyArg_ParseTuple(args, "OO|K", &arr_obj, &fallback, &salt)) return NULL;
    PyArrayObject *arr = (PyArrayObject *)PyArray_FROM_OTF(
        arr_obj, NPY_OBJECT, NPY_ARRAY_IN_ARRAY);
    if (arr == NULL) return NULL;
    npy_intp n = PyArray_SIZE(arr);
    npy_intp dims[1] = {n};
    PyArrayObject *out =
        (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_UINT64);
    if (out == NULL) {
        Py_DECREF(arr);
        return NULL;
    }
    PyObject **data = (PyObject **)PyArray_DATA(arr);
    uint64_t *o = (uint64_t *)PyArray_DATA(out);
    for (npy_intp i = 0; i < n; i++) {
        if (hash_one(data[i], fallback, (uint64_t)salt, &o[i]) < 0) {
            Py_DECREF(arr);
            Py_DECREF(out);
            return NULL;
        }
    }
    Py_DECREF(arr);
    return (PyObject *)out;
}

static PyMethodDef Methods[] = {
    {"hash_obj_array", hash_obj_array, METH_VARARGS,
     "Stable 64-bit hash of a numpy object array (fallback callable for exotic types)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "pwhash", NULL, -1, Methods};

PyMODINIT_FUNC PyInit_pwhash(void) {
    PyObject *m = PyModule_Create(&moduledef);
    if (m == NULL) return NULL;
    import_array();
    return m;
}
