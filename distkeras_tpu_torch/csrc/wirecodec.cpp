/* A copy of csrc/wirecodec.cpp of the JAX package, kept in the port so that it
 * builds its own module from its own sources (distkeras_tpu_torch/native.py
 * compiles it at first use into BUILD_DIR/_wirecodec<EXT_SUFFIX>).  The code
 * below is that file unchanged: its results stay byte-equal to the JAX
 * package's module, and its own comment, which follows, still names the
 * JAX package's paths. */

/* Native wire codec for distkeras_tpu.networking.
 *
 * Speeds up the host-PS transport's hot path (the reference's equivalent is
 * pickle inside distkeras/networking.py :: send_data/recv_data — SURVEY.md
 * §2.4).  The wire format is byte-identical to the pure-Python codec
 * (MAGIC "DKT1" | u32 header_len | header JSON | per-buffer u64 len | raw
 * bytes), so either end may run either implementation:
 *
 *   encode_frames(header: bytes, buffers: sequence of buffer-protocol
 *                 objects) -> bytes
 *       One allocation + memcpy per part; avoids the Python-level
 *       join([...]) and per-ndarray tobytes() copies.
 *
 *   decode_frames(data: bytes) -> (header: bytes, buffers: list[memoryview])
 *       Zero-copy: the returned memoryviews alias `data`.
 *
 *   decode_payload(data) -> list[memoryview]
 *       Splits a bare run of `u64 len | raw bytes` frames (no magic/header)
 *       into zero-copy memoryviews over `data` — the pooled receive path,
 *       where the tensor payload lands in a reusable per-connection buffer
 *       (networking.BufferPool) and must decode without fresh allocations.
 *
 * Built by setup.py as distkeras_tpu._wirecodec (optional; networking.py
 * falls back to the Python codec when absent).  CPython C API only — no
 * pybind11 dependency.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

static const char MAGIC[4] = {'D', 'K', 'T', '1'};

static void put_u32(uint8_t *p, uint32_t v) {
  p[0] = (uint8_t)(v & 0xff);
  p[1] = (uint8_t)((v >> 8) & 0xff);
  p[2] = (uint8_t)((v >> 16) & 0xff);
  p[3] = (uint8_t)((v >> 24) & 0xff);
}

static void put_u64(uint8_t *p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = (uint8_t)((v >> (8 * i)) & 0xff);
}

static uint32_t get_u32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

static uint64_t get_u64(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v |= ((uint64_t)p[i]) << (8 * i);
  return v;
}

static PyObject *encode_frames(PyObject *, PyObject *args) {
  Py_buffer header;
  PyObject *buflist;
  if (!PyArg_ParseTuple(args, "y*O", &header, &buflist)) return nullptr;

  PyObject *seq = PySequence_Fast(buflist, "buffers must be a sequence");
  if (!seq) {
    PyBuffer_Release(&header);
    return nullptr;
  }
  Py_ssize_t nbuf = PySequence_Fast_GET_SIZE(seq);

  std::vector<Py_buffer> views(nbuf);
  Py_ssize_t total = 4 + 4 + header.len;
  Py_ssize_t acquired = 0;
  for (Py_ssize_t i = 0; i < nbuf; i++) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[i], PyBUF_C_CONTIGUOUS) != 0) {
      for (Py_ssize_t j = 0; j < acquired; j++) PyBuffer_Release(&views[j]);
      Py_DECREF(seq);
      PyBuffer_Release(&header);
      return nullptr;
    }
    acquired++;
    total += 8 + views[i].len;
  }

  PyObject *out = PyBytes_FromStringAndSize(nullptr, total);
  if (out) {
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
    std::memcpy(p, MAGIC, 4);
    p += 4;
    put_u32(p, (uint32_t)header.len);
    p += 4;
    std::memcpy(p, header.buf, header.len);
    p += header.len;
    for (Py_ssize_t i = 0; i < nbuf; i++) {
      put_u64(p, (uint64_t)views[i].len);
      p += 8;
      std::memcpy(p, views[i].buf, views[i].len);
      p += views[i].len;
    }
  }
  for (Py_ssize_t i = 0; i < acquired; i++) PyBuffer_Release(&views[i]);
  Py_DECREF(seq);
  PyBuffer_Release(&header);
  return out;
}

/* Append data_obj[lo:hi] to `buffers` as a zero-copy memoryview slice.
 * Returns 0 on success, -1 with a Python error set otherwise. */
static int append_view(PyObject *data_obj, PyObject *buffers, uint64_t lo,
                       uint64_t hi) {
  PyObject *mv = PyMemoryView_FromObject(data_obj);
  PyObject *sliced = nullptr;
  if (mv) {
    PyObject *plo = PyLong_FromUnsignedLongLong(lo);
    PyObject *phi = PyLong_FromUnsignedLongLong(hi);
    PyObject *slice = (plo && phi) ? PySlice_New(plo, phi, nullptr) : nullptr;
    Py_XDECREF(plo);
    Py_XDECREF(phi);
    if (slice) {
      sliced = PyObject_GetItem(mv, slice);
      Py_DECREF(slice);
    }
    Py_DECREF(mv);
  }
  if (!sliced) return -1;
  int rc = PyList_Append(buffers, sliced);
  Py_DECREF(sliced);
  return rc;
}

/* Parse `u64 len | raw bytes` frames out of data[off:] into `buffers`.
 * Shared by decode_frames (off = past the header) and decode_payload
 * (off = 0).  Returns 0 on success, -1 with a Python error set. */
static int parse_frames(PyObject *data_obj, const uint8_t *p, Py_ssize_t n,
                        uint64_t off, PyObject *buffers) {
  /* All bounds checks are written subtraction-style (x > n - off) so a
   * hostile 64-bit length cannot wrap the addition and slip past. */
  while (off < (uint64_t)n) {
    if ((uint64_t)n - off < 8) {
      PyErr_SetString(PyExc_ValueError, "Truncated buffer length");
      return -1;
    }
    uint64_t blen = get_u64(p + off);
    off += 8;
    if (blen > (uint64_t)n - off) {
      PyErr_SetString(PyExc_ValueError, "Truncated buffer payload");
      return -1;
    }
    if (append_view(data_obj, buffers, off, off + blen) != 0) return -1;
    off += blen;
  }
  return 0;
}

static PyObject *decode_frames(PyObject *, PyObject *args) {
  PyObject *data_obj;
  if (!PyArg_ParseTuple(args, "O", &data_obj)) return nullptr;
  Py_buffer data;
  if (PyObject_GetBuffer(data_obj, &data, PyBUF_C_CONTIGUOUS) != 0)
    return nullptr;

  const uint8_t *p = (const uint8_t *)data.buf;
  Py_ssize_t n = data.len;
  if (n < 8 || std::memcmp(p, MAGIC, 4) != 0) {
    PyBuffer_Release(&data);
    PyErr_SetString(PyExc_ValueError, "Bad magic on wire message");
    return nullptr;
  }
  uint64_t hlen = get_u32(p + 4);
  if (hlen > (uint64_t)n - 8) {
    PyBuffer_Release(&data);
    PyErr_SetString(PyExc_ValueError, "Truncated header");
    return nullptr;
  }
  PyObject *header =
      PyBytes_FromStringAndSize((const char *)p + 8, (Py_ssize_t)hlen);
  PyObject *buffers = PyList_New(0);
  if (!header || !buffers ||
      parse_frames(data_obj, p, n, 8 + hlen, buffers) != 0) {
    Py_XDECREF(header);
    Py_XDECREF(buffers);
    PyBuffer_Release(&data);
    return nullptr;
  }
  PyBuffer_Release(&data);
  PyObject *result = PyTuple_Pack(2, header, buffers);
  Py_DECREF(header);
  Py_DECREF(buffers);
  return result;
}

static PyObject *decode_payload(PyObject *, PyObject *args) {
  PyObject *data_obj;
  if (!PyArg_ParseTuple(args, "O", &data_obj)) return nullptr;
  Py_buffer data;
  if (PyObject_GetBuffer(data_obj, &data, PyBUF_C_CONTIGUOUS) != 0)
    return nullptr;
  PyObject *buffers = PyList_New(0);
  if (!buffers || parse_frames(data_obj, (const uint8_t *)data.buf, data.len,
                               0, buffers) != 0) {
    Py_XDECREF(buffers);
    PyBuffer_Release(&data);
    return nullptr;
  }
  PyBuffer_Release(&data);
  return buffers;
}

static PyMethodDef methods[] = {
    {"encode_frames", encode_frames, METH_VARARGS,
     "encode_frames(header: bytes, buffers) -> bytes"},
    {"decode_frames", decode_frames, METH_VARARGS,
     "decode_frames(data) -> (header, [memoryview, ...])"},
    {"decode_payload", decode_payload, METH_VARARGS,
     "decode_payload(data) -> [memoryview, ...] (bare u64-len frames)"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_wirecodec",
                                       "Native wire codec for the host-PS "
                                       "transport.",
                                       -1, methods};

PyMODINIT_FUNC PyInit__wirecodec(void) { return PyModule_Create(&moduledef); }
