/* A copy of csrc/csvloader.cpp of the JAX package, kept in the port so that it
 * builds its own module from its own sources (distkeras_tpu_torch/native.py
 * compiles it at first use into BUILD_DIR/_csvloader<EXT_SUFFIX>).  The code
 * below is that file unchanged: its results stay byte-equal to the JAX
 * package's module, and its own comment, which follows, still names the
 * JAX package's paths. */

/* Native CSV ingest for distkeras_tpu.data.datasets.read_csv.
 *
 * The reference's data plane is Apache Spark: CSV ingest happens in the JVM
 * (reference workload: examples/data/atlas_higgs.csv read on the driver —
 * SURVEY.md §2.1 row 23, §5 "Data layer").  The TPU-native rebuild feeds
 * host-resident numpy shards instead, and this kernel is the native piece of
 * that path: a multithreaded text→float64 parser for clean numeric CSVs.
 *
 *   parse_numeric(data: bytes, n_cols: int, delimiter: int, skip: int)
 *       -> bytes                # n_rows * n_cols little-endian float64s
 *
 * Semantics are a strict subset of np.genfromtxt(dtype=float64): fields are
 * strtod-parsed, empty/invalid fields become NaN, every data row must have
 * exactly n_cols fields (ragged rows raise ValueError), '\r' before '\n' is
 * tolerated, trailing newline optional, `skip` leading lines (the header)
 * are ignored.  The caller (datasets.read_csv) only takes this path for
 * files with no quotes and no comment characters; anything else falls back
 * to genfromtxt, so observable behavior never changes — only speed.
 *
 * Parallelism: the buffer is split at line boundaries into one chunk per
 * hardware thread; each chunk parses independently in a single pass into a
 * growing per-chunk vector, concatenated into the output bytes at the end
 * (peak memory ~2x output size).  No Python API calls inside worker
 * threads; the GIL is released for the whole parse.
 *
 * Built by setup.py as distkeras_tpu._csvloader (optional, like the wire
 * codec).  CPython C API only — no pybind11 dependency.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <locale.h>

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ChunkResult {
  std::vector<double> values;
  Py_ssize_t bad_line = -1;    // 1-based line number (within chunk) of a
  Py_ssize_t bad_fields = 0;   // ragged row, and how many fields it had
  Py_ssize_t n_rows = 0;
};

// One process-lifetime "C" numeric locale: plain strtod honors
// LC_NUMERIC, so an embedding app that called setlocale() to a
// comma-decimal locale would silently truncate every '1.5' to 1.0.
locale_t c_locale() {
  static locale_t loc = newlocale(LC_NUMERIC_MASK, "C", nullptr);
  return loc;
}

// Parse [begin, end) — a whole number of lines — expecting n_cols fields
// per non-empty line.  Blank lines are skipped (genfromtxt does the same).
void parse_chunk(const char *begin, const char *end, Py_ssize_t n_cols,
                 char delim, ChunkResult *out) {
  const char *p = begin;
  Py_ssize_t line_no = 0;
  while (p < end) {
    const char *eol = static_cast<const char *>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char *line_end = eol ? eol : end;
    ++line_no;
    if (line_end > p && line_end[-1] == '\r') --line_end;
    // genfromtxt strips each line with strip(' \r\n') before splitting, so
    // space-only lines vanish; tab-only lines do NOT (tabs are gated to the
    // fallback by the caller, so none reach here).
    const char *scan = p;
    while (scan < line_end && *scan == ' ') ++scan;
    if (scan == line_end) {  // blank/space-only line: genfromtxt skips
      p = eol ? eol + 1 : end;
      continue;
    }
    Py_ssize_t field = 0;
    const char *f = p;
    while (true) {
      const char *fe = static_cast<const char *>(
          memchr(f, delim, static_cast<size_t>(line_end - f)));
      const char *field_end = fe ? fe : line_end;
      if (field < n_cols) {
        // strtod needs NUL-terminated input; copy locally (stack buffer for
        // the common case, heap for pathological >63-char fields)
        char buf[64];
        std::string big;
        size_t len = static_cast<size_t>(field_end - f);
        double v;
        if (len == 0) {
          v = NAN;
        } else {
          const char *s;
          if (len < sizeof(buf)) {
            memcpy(buf, f, len);
            buf[len] = '\0';
            s = buf;
          } else {
            big.assign(f, len);
            s = big.c_str();
          }
          char *endp = nullptr;
          v = strtod_l(s, &endp, c_locale());
          while (endp && (*endp == ' ' || *endp == '\t')) ++endp;
          if (endp == s || (endp && *endp != '\0')) v = NAN;
        }
        out->values.push_back(v);
      }
      ++field;
      if (!fe) break;
      f = fe + 1;
    }
    if (field != n_cols) {
      out->bad_line = line_no;
      out->bad_fields = field;
      out->values.resize(static_cast<size_t>(out->n_rows) *
                         static_cast<size_t>(n_cols));
      return;
    }
    ++out->n_rows;
    p = eol ? eol + 1 : end;
  }
}

}  // namespace

static PyObject *parse_numeric(PyObject *, PyObject *args) {
  Py_buffer data;
  Py_ssize_t n_cols, skip;
  int delim_int;
  if (!PyArg_ParseTuple(args, "y*nin", &data, &n_cols, &delim_int, &skip))
    return nullptr;
  if (n_cols <= 0) {
    PyBuffer_Release(&data);
    PyErr_SetString(PyExc_ValueError, "n_cols must be positive");
    return nullptr;
  }
  const char *buf = static_cast<const char *>(data.buf);
  const char *end = buf + data.len;
  const char delim = static_cast<char>(delim_int);

  // Skip `skip` leading lines (header) — cheap, single-threaded.
  const char *body = buf;
  for (Py_ssize_t i = 0; i < skip && body < end; ++i) {
    const char *eol = static_cast<const char *>(
        memchr(body, '\n', static_cast<size_t>(end - body)));
    body = eol ? eol + 1 : end;
  }

  unsigned hw = std::thread::hardware_concurrency();
  size_t n_threads = hw ? hw : 4;
  size_t body_len = static_cast<size_t>(end - body);
  if (body_len < (1u << 16)) n_threads = 1;  // small file: threads all cost

  // Chunk boundaries snapped forward to the next newline.
  std::vector<const char *> bounds;
  bounds.push_back(body);
  for (size_t t = 1; t < n_threads; ++t) {
    const char *target = body + body_len * t / n_threads;
    if (target <= bounds.back()) target = bounds.back();
    const char *eol = static_cast<const char *>(
        memchr(target, '\n', static_cast<size_t>(end - target)));
    bounds.push_back(eol ? eol + 1 : end);
  }
  bounds.push_back(end);

  std::vector<ChunkResult> results(bounds.size() - 1);
  Py_BEGIN_ALLOW_THREADS;
  {
    std::vector<std::thread> threads;
    for (size_t t = 0; t + 1 < bounds.size(); ++t)
      threads.emplace_back(parse_chunk, bounds[t], bounds[t + 1], n_cols,
                           delim, &results[t]);
    for (auto &th : threads) th.join();
  }
  Py_END_ALLOW_THREADS;

  Py_ssize_t total_rows = 0, lines_before = 0;
  for (size_t t = 0; t < results.size(); ++t) {
    if (results[t].bad_line >= 0) {
      PyBuffer_Release(&data);
      PyErr_Format(PyExc_ValueError,
                   "CSV row ~%zd has %zd fields, expected %zd",
                   static_cast<Py_ssize_t>(lines_before + results[t].bad_line
                                           + skip),
                   results[t].bad_fields, n_cols);
      return nullptr;
    }
    total_rows += results[t].n_rows;
    lines_before += results[t].n_rows;  // approximation is fine for the msg
  }

  PyObject *out = PyBytes_FromStringAndSize(
      nullptr, total_rows * n_cols * static_cast<Py_ssize_t>(sizeof(double)));
  if (!out) {
    PyBuffer_Release(&data);
    return nullptr;
  }
  char *dst = PyBytes_AS_STRING(out);
  for (auto &r : results) {
    size_t nbytes = r.values.size() * sizeof(double);
    memcpy(dst, r.values.data(), nbytes);
    dst += nbytes;
  }
  PyBuffer_Release(&data);
  return out;
}

static PyMethodDef Methods[] = {
    {"parse_numeric", parse_numeric, METH_VARARGS,
     "parse_numeric(data, n_cols, delimiter, skip) -> float64 bytes"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_csvloader",
    "Native multithreaded numeric-CSV parser", -1, Methods,
    nullptr, nullptr, nullptr, nullptr};

PyMODINIT_FUNC PyInit__csvloader(void) { return PyModule_Create(&moduledef); }
