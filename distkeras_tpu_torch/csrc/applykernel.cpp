/* A copy of csrc/applykernel.cpp of the JAX package, kept in the port so that it
 * builds its own module from its own sources (distkeras_tpu_torch/native.py
 * compiles it at first use into BUILD_DIR/_applykernel<EXT_SUFFIX>).  The code
 * below is that file unchanged: its results stay byte-equal to the JAX
 * package's module, and its own comment, which follows, still names the
 * JAX package's paths. */

/* Native apply kernel for distkeras_tpu.parameter_servers.
 *
 * The PS apply path is two numpy idioms: `center += scale * delta` (dense
 * commits) and `np.add.at(flat, indices, values)` (sparse top-k commits and
 * the coalesced drain's one-scatter-add-per-drain batch).  Both are
 * memory-bound loops that numpy runs with a temporary allocation (the
 * `scale * delta` intermediate) or through the notoriously slow unbuffered
 * fancy-indexing machinery (`add.at`).  This module is the C twin:
 *
 *   axpy_f32(dst, src, scale) -> None
 *       dst[i] += float(scale) * src[i], in place, no temporary.
 *
 *   scatter_add_f32(dst, indices_i64, values_f32) -> None
 *       dst[idx[i]] += vals[i], sequentially in array order — the exact
 *       operation (and the exact float rounding/accumulation ORDER) of
 *       `np.add.at`, so results are bit-identical to the numpy path.
 *
 * Bit-equality is the contract (tests/test_applykernel.py fuzzes it): the
 * pure-NumPy path stays the default and the reference.  Two consequences
 * for the build: `-ffp-contract=off` (an FMA would round `dst + scale*src`
 * once where numpy rounds twice), and all loads/stores go through memcpy
 * (callers may pass byte-unaligned buffers, e.g. pooled receive views;
 * the compiler lowers 4/8-byte memcpy to plain moves on every target we
 * care about).
 *
 * Built by setup.py as distkeras_tpu._applykernel (optional; the apply path
 * falls back to numpy when absent — same pattern as _wirecodec).  CPython
 * C API only — no pybind11 dependency.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

static inline float load_f32(const uint8_t *p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline void store_f32(uint8_t *p, float v) { std::memcpy(p, &v, 4); }

static inline int64_t load_i64(const uint8_t *p) {
  int64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static PyObject *axpy_f32(PyObject *, PyObject *args) {
  Py_buffer dst, src;
  double scale;
  if (!PyArg_ParseTuple(args, "w*y*d", &dst, &src, &scale)) return nullptr;
  if (dst.len != src.len || dst.len % 4 != 0) {
    PyBuffer_Release(&dst);
    PyBuffer_Release(&src);
    PyErr_SetString(PyExc_ValueError,
                    "axpy_f32: dst/src must be equal-length float32 buffers");
    return nullptr;
  }
  uint8_t *d = (uint8_t *)dst.buf;
  const uint8_t *s = (const uint8_t *)src.buf;
  Py_ssize_t n = dst.len / 4;
  const float fs = (float)scale;  /* numpy casts the python-float scale to
                                     the array dtype (f32) before the
                                     multiply — match it exactly */
  Py_BEGIN_ALLOW_THREADS
  if (fs == 1.0f) {
    for (Py_ssize_t i = 0; i < n; i++)
      store_f32(d + 4 * i, load_f32(d + 4 * i) + load_f32(s + 4 * i));
  } else {
    for (Py_ssize_t i = 0; i < n; i++) {
      float p = fs * load_f32(s + 4 * i); /* two roundings, as numpy */
      store_f32(d + 4 * i, load_f32(d + 4 * i) + p);
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&dst);
  PyBuffer_Release(&src);
  Py_RETURN_NONE;
}

static PyObject *scatter_add_f32(PyObject *, PyObject *args) {
  Py_buffer dst, idx, vals;
  if (!PyArg_ParseTuple(args, "w*y*y*", &dst, &idx, &vals)) return nullptr;
  if (dst.len % 4 != 0 || idx.len % 8 != 0 || vals.len % 4 != 0 ||
      idx.len / 8 != vals.len / 4) {
    PyBuffer_Release(&dst);
    PyBuffer_Release(&idx);
    PyBuffer_Release(&vals);
    PyErr_SetString(PyExc_ValueError,
                    "scatter_add_f32: dst f32, indices int64, values f32 "
                    "with len(indices) == len(values)");
    return nullptr;
  }
  uint8_t *d = (uint8_t *)dst.buf;
  const uint8_t *ip = (const uint8_t *)idx.buf;
  const uint8_t *vp = (const uint8_t *)vals.buf;
  Py_ssize_t n = idx.len / 8;
  int64_t dlen = (int64_t)(dst.len / 4);
  int64_t bad = 0;
  int oob = 0;
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; i++) {
    int64_t j = load_i64(ip + 8 * i);
    if (j < 0 || j >= dlen) {
      bad = j;
      oob = 1;
      break;
    }
    store_f32(d + 4 * j, load_f32(d + 4 * j) + load_f32(vp + 4 * i));
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&dst);
  PyBuffer_Release(&idx);
  PyBuffer_Release(&vals);
  if (oob) {
    /* mirrors np.add.at's IndexError; a partial prefix may have applied —
     * callers validate bounds first (parameter_servers does), this is a
     * last-resort guard against a corrupted batch */
    PyErr_Format(PyExc_IndexError,
                 "scatter_add_f32: index %lld out of range for length %lld",
                 (long long)bad, (long long)dlen);
    return nullptr;
  }
  Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"axpy_f32", axpy_f32, METH_VARARGS,
     "axpy_f32(dst_f32, src_f32, scale) -> None: dst += scale * src"},
    {"scatter_add_f32", scatter_add_f32, METH_VARARGS,
     "scatter_add_f32(dst_f32, indices_i64, values_f32) -> None: "
     "dst[idx[i]] += vals[i] in array order (np.add.at bit-equal)"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_applykernel",
    "Native scatter-add / axpy apply kernel for the host-PS core.", -1,
    methods};

PyMODINIT_FUNC PyInit__applykernel(void) {
  return PyModule_Create(&moduledef);
}
