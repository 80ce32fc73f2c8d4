// Host data plane of tuplex_tpu_torch (CPython C API, no numpy headers).
//
// The encoders and decoders below are the reference package's
// (tuplex_tpu/native/src/fasttransfer.cpp), with the same semantics: typed
// bulk conversion of Python lists into column buffers and back, with
// non-conforming elements reported for boxing (the analog of Tuplex's
// PythonContext.cc:823-919 fast paths and PythonDataSet.cc:1400-1442 bulk
// decoders). This copy adds the readers the port needs without pyarrow:
// a one-pass CSV record/field splitter, a line splitter with
// str.splitlines' boundaries, and a gather of (start, length) byte ranges
// into a zero-padded matrix.
//
// Exposed module: _tuplex_torch_native
//   encode_i64(list)  -> (data_bytes,  valid_bytes, bad_index_list)
//   encode_f64(list)  -> (data_bytes,  valid_bytes, bad_index_list)
//   encode_bool(list) -> (data_bytes,  valid_bytes, bad_index_list)
//   encode_str(list)  -> (mat_bytes, lens_bytes, valid_bytes, width,
//                         bad_index_list)
//   offsets_to_matrix(data, offsets_i64, n, offset, max_w)
//                     -> (mat_bytes, lens_i32_bytes, full_lens_i64, width)
//   decode_str(mat_bytes, lens_bytes, width, n) -> list[str]
//   decode_columns(spec, n) -> list of row tuples (bare values if 1 column)
//   encode_rows(rows, kinds) -> (cols, bad_index_list)
//   split_csv(data, delim, quote, k, has_header)
//                     -> (starts, ends, good, fstart, flen, n_fast, bad)
//   split_lines(data) -> (starts, ends, odd_index_list)
//   gather_rows(data, starts, lens, k, pos|None, m)
//                     -> [(mat, lens_i32, width)] * k
// The last three return bytearrays (writable for numpy).
//
// "bad" = element whose type doesn't conform (including bool where int is
// expected — python bool is an int subtype but the type lattice separates
// them); None is VALID (valid=0) since Option columns carry a validity mask.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

struct EncodedCommon {
  PyObject *valid_bytes = nullptr;
  PyObject *bad_list = nullptr;
};

static bool alloc_common(Py_ssize_t n, EncodedCommon &out) {
  out.valid_bytes = PyBytes_FromStringAndSize(nullptr, n);
  out.bad_list = PyList_New(0);
  return out.valid_bytes && out.bad_list;
}

static PyObject *encode_i64(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *data = PyBytes_FromStringAndSize(nullptr, n * 8);
  EncodedCommon c;
  if (!data || !alloc_common(n, c)) return nullptr;
  int64_t *d = reinterpret_cast<int64_t *>(PyBytes_AS_STRING(data));
  char *v = PyBytes_AS_STRING(c.valid_bytes);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *o = PyList_GET_ITEM(arg, i);
    if (o == Py_None) {
      d[i] = 0;
      v[i] = 0;
      continue;
    }
    if (PyLong_Check(o) && !PyBool_Check(o)) {
      int overflow = 0;
      long long val = PyLong_AsLongLongAndOverflow(o, &overflow);
      if (!overflow) {
        d[i] = static_cast<int64_t>(val);
        v[i] = 1;
        continue;
      }
    }
    d[i] = 0;
    v[i] = 1;  // slot unusable; caller boxes the row
    PyObject *idx = PyLong_FromSsize_t(i);
    PyList_Append(c.bad_list, idx);
    Py_DECREF(idx);
  }
  return Py_BuildValue("(NNN)", data, c.valid_bytes, c.bad_list);
}

static PyObject *encode_f64(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *data = PyBytes_FromStringAndSize(nullptr, n * 8);
  EncodedCommon c;
  if (!data || !alloc_common(n, c)) return nullptr;
  double *d = reinterpret_cast<double *>(PyBytes_AS_STRING(data));
  char *v = PyBytes_AS_STRING(c.valid_bytes);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *o = PyList_GET_ITEM(arg, i);
    if (o == Py_None) {
      d[i] = 0.0;
      v[i] = 0;
      continue;
    }
    if (PyFloat_Check(o)) {
      d[i] = PyFloat_AS_DOUBLE(o);
      v[i] = 1;
      continue;
    }
    d[i] = 0.0;
    v[i] = 1;
    PyObject *idx = PyLong_FromSsize_t(i);
    PyList_Append(c.bad_list, idx);
    Py_DECREF(idx);
  }
  return Py_BuildValue("(NNN)", data, c.valid_bytes, c.bad_list);
}

static PyObject *encode_bool(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *data = PyBytes_FromStringAndSize(nullptr, n);
  EncodedCommon c;
  if (!data || !alloc_common(n, c)) return nullptr;
  char *d = PyBytes_AS_STRING(data);
  char *v = PyBytes_AS_STRING(c.valid_bytes);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *o = PyList_GET_ITEM(arg, i);
    if (o == Py_None) {
      d[i] = 0;
      v[i] = 0;
      continue;
    }
    if (PyBool_Check(o)) {
      d[i] = (o == Py_True) ? 1 : 0;
      v[i] = 1;
      continue;
    }
    d[i] = 0;
    v[i] = 1;
    PyObject *idx = PyLong_FromSsize_t(i);
    PyList_Append(c.bad_list, idx);
    Py_DECREF(idx);
  }
  return Py_BuildValue("(NNN)", data, c.valid_bytes, c.bad_list);
}

static PyObject *encode_str(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  // pass 1: utf8 views + max width
  std::vector<const char *> ptrs(static_cast<size_t>(n), nullptr);
  std::vector<Py_ssize_t> lens(static_cast<size_t>(n), 0);
  std::vector<Py_ssize_t> bad;
  Py_ssize_t w = 1;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *o = PyList_GET_ITEM(arg, i);
    if (o == Py_None) continue;
    if (PyUnicode_Check(o)) {
      Py_ssize_t sz = 0;
      const char *u = PyUnicode_AsUTF8AndSize(o, &sz);
      if (u) {
        ptrs[static_cast<size_t>(i)] = u;
        lens[static_cast<size_t>(i)] = sz;
        if (sz > w) w = sz;
        continue;
      }
      PyErr_Clear();
    }
    bad.push_back(i);
  }
  PyObject *mat = PyBytes_FromStringAndSize(nullptr, n * w);
  PyObject *lens_b = PyBytes_FromStringAndSize(nullptr, n * 4);
  PyObject *valid_b = PyBytes_FromStringAndSize(nullptr, n);
  PyObject *bad_list = PyList_New(0);
  if (!mat || !lens_b || !valid_b || !bad_list) return nullptr;
  char *m = PyBytes_AS_STRING(mat);
  int32_t *lp = reinterpret_cast<int32_t *>(PyBytes_AS_STRING(lens_b));
  char *v = PyBytes_AS_STRING(valid_b);
  memset(m, 0, static_cast<size_t>(n * w));
  for (Py_ssize_t i = 0; i < n; i++) {
    const char *u = ptrs[static_cast<size_t>(i)];
    if (u) {
      memcpy(m + i * w, u, static_cast<size_t>(lens[static_cast<size_t>(i)]));
      lp[i] = static_cast<int32_t>(lens[static_cast<size_t>(i)]);
      v[i] = 1;
    } else {
      lp[i] = 0;
      v[i] = 0;
    }
  }
  for (Py_ssize_t i : bad) {
    v[i] = 1;  // not a None: row must be boxed by the caller
    PyObject *idx = PyLong_FromSsize_t(i);
    PyList_Append(bad_list, idx);
    Py_DECREF(idx);
  }
  return Py_BuildValue("(NNNnN)", mat, lens_b, valid_b, w, bad_list);
}

// Arrow large_string buffers -> zero-padded [n, w] byte matrix + clamped
// int32 lens + unclamped int64 lens, in one pass of memcpy (the reference
// package's arrow_string_to_leaf; this package reads no Arrow buffers, and
// its readers use gather_rows below).
static PyObject *offsets_to_matrix(PyObject *, PyObject *args) {
  Py_buffer data, offs;
  Py_ssize_t n, aoff, maxw;
  if (!PyArg_ParseTuple(args, "y*y*nnn", &data, &offs, &n, &aoff, &maxw))
    return nullptr;
  if (maxw < 0) maxw = 0;  // python fallback: w = min(max_len, maxw) >= 0
  if (offs.len < static_cast<Py_ssize_t>((aoff + n + 1) * 8) ||
      n < 0 || aoff < 0) {
    PyBuffer_Release(&data);
    PyBuffer_Release(&offs);
    PyErr_SetString(PyExc_ValueError, "offsets buffer too small");
    return nullptr;
  }
  const int64_t *off = reinterpret_cast<const int64_t *>(offs.buf) + aoff;
  int64_t wmax = 1;
  for (Py_ssize_t i = 0; i < n; i++) {
    int64_t li = off[i + 1] - off[i];
    if (li > wmax) wmax = li;
  }
  Py_ssize_t w = static_cast<Py_ssize_t>(wmax < maxw ? wmax : maxw);
  PyObject *mat = PyBytes_FromStringAndSize(nullptr, n * w);
  PyObject *lens_b = PyBytes_FromStringAndSize(nullptr, n * 4);
  PyObject *full_b = PyBytes_FromStringAndSize(nullptr, n * 8);
  if (!mat || !lens_b || !full_b) {
    PyBuffer_Release(&data);
    PyBuffer_Release(&offs);
    Py_XDECREF(mat);
    Py_XDECREF(lens_b);
    Py_XDECREF(full_b);
    return nullptr;
  }
  char *m = PyBytes_AS_STRING(mat);
  int32_t *lp = reinterpret_cast<int32_t *>(PyBytes_AS_STRING(lens_b));
  int64_t *fp = reinterpret_cast<int64_t *>(PyBytes_AS_STRING(full_b));
  const char *src = reinterpret_cast<const char *>(data.buf);
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS;
  memset(m, 0, static_cast<size_t>(n * w));
  for (Py_ssize_t i = 0; i < n; i++) {
    int64_t start = off[i];
    int64_t li = off[i + 1] - start;
    if (start < 0 || li < 0 || start + li > data.len) {
      ok = false;
      break;
    }
    int64_t c = li < w ? li : w;
    memcpy(m + i * w, src + start, static_cast<size_t>(c));
    lp[i] = static_cast<int32_t>(c);
    fp[i] = li;
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&data);
  PyBuffer_Release(&offs);
  if (!ok) {
    Py_DECREF(mat);
    Py_DECREF(lens_b);
    Py_DECREF(full_b);
    PyErr_SetString(PyExc_ValueError, "offsets out of data bounds");
    return nullptr;
  }
  return Py_BuildValue("(NNNn)", mat, lens_b, full_b, w);
}

static PyObject *decode_str(PyObject *, PyObject *args) {
  PyObject *mat_obj, *lens_obj;
  Py_ssize_t w, n;
  if (!PyArg_ParseTuple(args, "SSnn", &mat_obj, &lens_obj, &w, &n))
    return nullptr;
  const char *m = PyBytes_AS_STRING(mat_obj);
  const int32_t *lp =
      reinterpret_cast<const int32_t *>(PyBytes_AS_STRING(lens_obj));
  if (PyBytes_GET_SIZE(mat_obj) < n * w ||
      PyBytes_GET_SIZE(lens_obj) < n * 4) {
    PyErr_SetString(PyExc_ValueError, "buffer too small");
    return nullptr;
  }
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    int32_t li = lp[i];
    if (li < 0) li = 0;
    if (li > w) li = static_cast<int32_t>(w);
    PyObject *s =
        PyUnicode_DecodeUTF8(m + i * w, li, "replace");
    if (!s) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, s);
  }
  return out;
}

// One-pass multi-column decode: typed column buffers -> list of row tuples
// (list of bare values for a single column). The resultSetToCPython analog
// (reference: tuplex/python/src/PythonDataSet.cc:1400-1442 dispatches to
// per-type bulk decoders) — avoids per-column python lists, Option-mask
// comprehensions, and the final zip().
//
// spec per column: (kind, data_buf, valid_buf|None[, lens_buf, width])
//   kind: 0=i64 1=f64 2=bool 3=str(bytes matrix + i32 lens + width)
static PyObject *decode_columns(PyObject *, PyObject *args) {
  PyObject *spec;
  Py_ssize_t n;
  if (!PyArg_ParseTuple(args, "On", &spec, &n)) return nullptr;
  if (!PyList_Check(spec)) {
    PyErr_SetString(PyExc_TypeError, "spec must be a list");
    return nullptr;
  }
  Py_ssize_t k = PyList_GET_SIZE(spec);
  struct Col {
    int kind = 0;
    Py_buffer data{}, valid{}, lens{};
    bool has_valid = false, has_lens = false;
    Py_ssize_t w = 0;
  };
  std::vector<Col> cols(static_cast<size_t>(k));
  bool arg_ok = true;
  for (Py_ssize_t c = 0; c < k && arg_ok; c++) {
    PyObject *t = PyList_GET_ITEM(spec, c);
    Col &col = cols[static_cast<size_t>(c)];
    PyObject *vb = Py_None;
    long kind = 0;
    if (!PyArg_ParseTuple(t, "ly*|Oy*n", &kind, &col.data, &vb, &col.lens,
                          &col.w)) {
      col = Col{};  // ParseTuple released any y* buffers it acquired
      arg_ok = false;
      break;
    }
    col.kind = static_cast<int>(kind);
    col.has_lens = col.lens.buf != nullptr;
    if (vb != Py_None) {
      if (PyObject_GetBuffer(vb, &col.valid, PyBUF_SIMPLE) < 0) {
        arg_ok = false;
        break;
      }
      col.has_valid = true;
    }
    // bounds: every row index must stay inside the provided buffers; a
    // negative width would make `need` vacuously small and let
    // buf + i*w index backwards, so reject it outright (w == 0 is a
    // legal degenerate: every row decodes to the empty string)
    if (col.kind == 3 && col.w < 0) {
      PyErr_SetString(PyExc_ValueError, "string column width must be >= 0");
      arg_ok = false;
      break;
    }
    Py_ssize_t need = col.kind == 3 ? n * col.w
                      : col.kind == 2 ? n
                                      : n * 8;
    if (col.data.len < need || (col.has_valid && col.valid.len < n) ||
        (col.kind == 3 && (!col.has_lens || col.lens.len < n * 4))) {
      PyErr_SetString(PyExc_ValueError, "column buffer too small");
      arg_ok = false;
      break;
    }
  }
  PyObject *out = arg_ok ? PyList_New(n) : nullptr;
  if (out) {
    bool single = (k == 1);
    for (Py_ssize_t i = 0; i < n && out; i++) {
      PyObject *row = single ? nullptr : PyTuple_New(k);
      if (!single && !row) {
        Py_CLEAR(out);
        break;
      }
      for (Py_ssize_t c = 0; c < k; c++) {
        Col &col = cols[static_cast<size_t>(c)];
        PyObject *v = nullptr;
        if (col.has_valid &&
            !reinterpret_cast<const char *>(col.valid.buf)[i]) {
          v = Py_None;
          Py_INCREF(v);
        } else {
          switch (col.kind) {
            case 0:
              v = PyLong_FromLongLong(
                  reinterpret_cast<const int64_t *>(col.data.buf)[i]);
              break;
            case 1:
              v = PyFloat_FromDouble(
                  reinterpret_cast<const double *>(col.data.buf)[i]);
              break;
            case 2:
              v = PyBool_FromLong(
                  reinterpret_cast<const char *>(col.data.buf)[i]);
              break;
            case 3: {
              int32_t li = reinterpret_cast<const int32_t *>(col.lens.buf)[i];
              if (li < 0) li = 0;
              if (li > col.w) li = static_cast<int32_t>(col.w);
              v = PyUnicode_DecodeUTF8(
                  reinterpret_cast<const char *>(col.data.buf) + i * col.w,
                  li, "replace");
              break;
            }
            default:
              PyErr_SetString(PyExc_ValueError, "bad column kind");
          }
        }
        if (!v) {
          Py_XDECREF(row);
          Py_CLEAR(out);
          break;
        }
        if (single) {
          PyList_SET_ITEM(out, i, v);
        } else {
          PyTuple_SET_ITEM(row, c, v);
        }
      }
      if (out && !single) PyList_SET_ITEM(out, i, row);
    }
  }
  for (auto &col : cols) {
    if (col.data.buf) PyBuffer_Release(&col.data);
    if (col.has_valid) PyBuffer_Release(&col.valid);
    if (col.has_lens) PyBuffer_Release(&col.lens);
  }
  return out;
}

// One-pass mixed-tuple encode: list of k-tuples -> per-column typed buffers
// (the fastMixedSimpleTypeTupleTransfer analog, reference:
// tuplex/python/src/PythonContext.cc:860). kinds: same codes as
// decode_columns. Returns (cols, bad_list) where cols is a list of
//   i64/f64: (data_bytes, valid_bytes)   bool: (data_bytes, valid_bytes)
//   str:     (mat_bytes, lens_bytes, valid_bytes, width)
// bad rows (wrong arity / non-conforming field type / i64 overflow) have
// every column slot zeroed+valid and appear in bad_list for boxing.
static PyObject *encode_rows(PyObject *, PyObject *args) {
  PyObject *rows, *kinds_obj;
  if (!PyArg_ParseTuple(args, "OO", &rows, &kinds_obj)) return nullptr;
  if (!PyList_Check(rows) || !PyList_Check(kinds_obj)) {
    PyErr_SetString(PyExc_TypeError, "expected (list, list)");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(rows);
  Py_ssize_t k = PyList_GET_SIZE(kinds_obj);
  std::vector<int> kinds(static_cast<size_t>(k));
  for (Py_ssize_t c = 0; c < k; c++) {
    long v = PyLong_AsLong(PyList_GET_ITEM(kinds_obj, c));
    if (v < 0 || v > 3) {
      PyErr_SetString(PyExc_ValueError, "bad kind");
      return nullptr;
    }
    kinds[static_cast<size_t>(c)] = static_cast<int>(v);
  }
  // str columns need a width pass first
  std::vector<Py_ssize_t> widths(static_cast<size_t>(k), 0);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *row = PyList_GET_ITEM(rows, i);
    // exact tuple only (matches the python path's `type(v) is tuple`):
    // namedtuple rows must box so collect() returns them unchanged
    if (!PyTuple_CheckExact(row) || PyTuple_GET_SIZE(row) != k) continue;
    for (Py_ssize_t c = 0; c < k; c++) {
      if (kinds[static_cast<size_t>(c)] != 3) continue;
      PyObject *o = PyTuple_GET_ITEM(row, c);
      if (PyUnicode_Check(o)) {
        Py_ssize_t sz = 0;
        if (PyUnicode_AsUTF8AndSize(o, &sz)) {
          if (sz > widths[static_cast<size_t>(c)])
            widths[static_cast<size_t>(c)] = sz;
        } else {
          PyErr_Clear();
        }
      }
    }
  }
  struct OutCol {
    PyObject *data = nullptr, *valid = nullptr, *lens = nullptr;
    char *d = nullptr, *v = nullptr;
    int32_t *lp = nullptr;
    Py_ssize_t w = 1;
  };
  std::vector<OutCol> out(static_cast<size_t>(k));
  bool alloc_ok = true;
  for (Py_ssize_t c = 0; c < k && alloc_ok; c++) {
    OutCol &oc = out[static_cast<size_t>(c)];
    int kind = kinds[static_cast<size_t>(c)];
    Py_ssize_t esz = kind == 2 ? 1 : 8;
    if (kind == 3) {
      oc.w = widths[static_cast<size_t>(c)] > 0
                 ? widths[static_cast<size_t>(c)]
                 : 1;
      oc.data = PyBytes_FromStringAndSize(nullptr, n * oc.w);
      oc.lens = PyBytes_FromStringAndSize(nullptr, n * 4);
      if (!oc.data || !oc.lens) {
        alloc_ok = false;
        break;
      }
      oc.lp = reinterpret_cast<int32_t *>(PyBytes_AS_STRING(oc.lens));
      memset(PyBytes_AS_STRING(oc.data), 0, static_cast<size_t>(n * oc.w));
    } else {
      oc.data = PyBytes_FromStringAndSize(nullptr, n * esz);
      if (!oc.data) {
        alloc_ok = false;
        break;
      }
      memset(PyBytes_AS_STRING(oc.data), 0, static_cast<size_t>(n * esz));
    }
    oc.valid = PyBytes_FromStringAndSize(nullptr, n);
    if (!oc.valid) {
      alloc_ok = false;
      break;
    }
    oc.d = PyBytes_AS_STRING(oc.data);
    oc.v = PyBytes_AS_STRING(oc.valid);
  }
  PyObject *bad_list = alloc_ok ? PyList_New(0) : nullptr;
  if (!bad_list) {
    for (auto &oc : out) {
      Py_XDECREF(oc.data);
      Py_XDECREF(oc.valid);
      Py_XDECREF(oc.lens);
    }
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *row = PyList_GET_ITEM(rows, i);
    bool bad = !PyTuple_CheckExact(row) || PyTuple_GET_SIZE(row) != k;
    for (Py_ssize_t c = 0; c < k && !bad; c++) {
      OutCol &oc = out[static_cast<size_t>(c)];
      PyObject *o = PyTuple_GET_ITEM(row, c);
      oc.v[i] = 1;
      if (o == Py_None) {
        oc.v[i] = 0;  // Option slot; schema-validity is the caller's check
        if (oc.lp) oc.lp[i] = 0;
        continue;
      }
      switch (kinds[static_cast<size_t>(c)]) {
        case 0: {
          if (!PyLong_Check(o) || PyBool_Check(o)) {
            bad = true;
            break;
          }
          int overflow = 0;
          long long val = PyLong_AsLongLongAndOverflow(o, &overflow);
          if (overflow) {
            bad = true;
            break;
          }
          reinterpret_cast<int64_t *>(oc.d)[i] = val;
          break;
        }
        case 1:
          if (!PyFloat_Check(o)) {
            bad = true;
            break;
          }
          reinterpret_cast<double *>(oc.d)[i] = PyFloat_AS_DOUBLE(o);
          break;
        case 2:
          if (!PyBool_Check(o)) {
            bad = true;
            break;
          }
          oc.d[i] = (o == Py_True) ? 1 : 0;
          break;
        case 3: {
          if (!PyUnicode_Check(o)) {
            bad = true;
            break;
          }
          Py_ssize_t sz = 0;
          const char *u = PyUnicode_AsUTF8AndSize(o, &sz);
          // sz > w can only happen if pass 1's AsUTF8 failed transiently
          // for this object — never write past the row slot
          if (!u || sz > oc.w) {
            PyErr_Clear();
            bad = true;
            break;
          }
          memcpy(oc.d + i * oc.w, u, static_cast<size_t>(sz));
          oc.lp[i] = static_cast<int32_t>(sz);
          break;
        }
      }
    }
    if (bad) {
      for (Py_ssize_t c = 0; c < k; c++) {
        OutCol &oc = out[static_cast<size_t>(c)];
        oc.v[i] = 1;  // slot unusable; caller boxes the row
        if (oc.lp) oc.lp[i] = 0;
      }
      PyObject *idx = PyLong_FromSsize_t(i);
      PyList_Append(bad_list, idx);
      Py_DECREF(idx);
    }
  }
  PyObject *cols_out = PyList_New(k);
  if (!cols_out) {
    for (auto &oc : out) {
      Py_XDECREF(oc.data);
      Py_XDECREF(oc.valid);
      Py_XDECREF(oc.lens);
    }
    Py_DECREF(bad_list);
    return nullptr;
  }
  for (Py_ssize_t c = 0; c < k; c++) {
    OutCol &oc = out[static_cast<size_t>(c)];
    PyObject *t =
        kinds[static_cast<size_t>(c)] == 3
            ? Py_BuildValue("(NNNn)", oc.data, oc.lens, oc.valid, oc.w)
            : Py_BuildValue("(NN)", oc.data, oc.valid);
    if (!t) {
      Py_DECREF(cols_out);
      Py_DECREF(bad_list);
      return nullptr;
    }
    PyList_SET_ITEM(cols_out, c, t);
  }
  return Py_BuildValue("(NN)", cols_out, bad_list);
}

// ---------------------------------------------------------------------------
// readers: file bytes -> record/field/line ranges and byte matrices
// ---------------------------------------------------------------------------

// The first position in [i, n) whose byte has a class in cls, or n.
// Where SSE2 is available, `hits` maps a 16-byte block to a mask of its
// candidate bytes (a superset of the classed ones), so runs of plain bytes
// are skipped 16 at a time.
template <typename Hits>
static inline Py_ssize_t next_classed(const unsigned char *b, Py_ssize_t i,
                                      Py_ssize_t n, const unsigned char *cls,
                                      Hits hits) {
#if defined(__SSE2__)
  for (; i + 16 <= n; i += 16) {
    unsigned mask = hits(
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(b + i)));
    while (mask) {
      const Py_ssize_t p = i + __builtin_ctz(mask);
      if (cls[b[p]]) return p;
      mask &= mask - 1;
    }
  }
#else
  (void)hits;
#endif
  while (i < n && !cls[b[i]]) i++;
  return i;
}

#if defined(__SSE2__)
using Block = __m128i;
#else
struct Block {};
#endif

template <typename V>
static PyObject *bytearray_of(const V &vec) {
  return PyByteArray_FromStringAndSize(
      reinterpret_cast<const char *>(vec.data()),
      static_cast<Py_ssize_t>(vec.size() * sizeof(typename V::value_type)));
}

// Length of the UTF-8 sequence at p (rem bytes left) as CPython's strict
// decoder accepts it, or 0 where it would not (overlong forms, surrogates,
// beyond U+10FFFF, truncated or bad continuation bytes).
static Py_ssize_t utf8_seq(const unsigned char *p, Py_ssize_t rem) {
  const unsigned char c = p[0];
  if (c < 0x80) return 1;
  if (c < 0xC2) return 0;
  if (c < 0xE0) return rem >= 2 && (p[1] & 0xC0) == 0x80 ? 2 : 0;
  if (c < 0xF0) {
    if (rem < 3 || (p[2] & 0xC0) != 0x80) return 0;
    const unsigned char lo = c == 0xE0 ? 0xA0 : 0x80;
    const unsigned char hi = c == 0xED ? 0x9F : 0xBF;
    return p[1] >= lo && p[1] <= hi ? 3 : 0;
  }
  if (c < 0xF5) {
    if (rem < 4 || (p[2] & 0xC0) != 0x80 || (p[3] & 0xC0) != 0x80) return 0;
    const unsigned char lo = c == 0xF0 ? 0x90 : 0x80;
    const unsigned char hi = c == 0xF4 ? 0x8F : 0xBF;
    return p[1] >= lo && p[1] <= hi ? 4 : 0;
  }
  return 0;
}

// CSV records and fields in one pass over the file's bytes. The same five
// arrays as the port's numpy splitter (io/csvsource.py _split_records):
// record starts and ends (terminators excluded, blank lines and the header
// dropped), a fast-path flag per record, and the start and length of each
// field of the fast records, whole-field quotes stripped. A record is on
// the fast path when it has k-1 delimiters outside quotes, no newline
// inside quotes, no CR other than its terminator's, and every quote byte
// in it is one of a field's two enclosing quotes. Each line starts outside
// quotes (a newline ends a line only outside them), so a record's quote
// parity starts at zero. The same pass checks that the bytes are UTF-8 as
// CPython's strict decoder accepts it: `bad` is the offset of the first
// sequence it would refuse, -1 if none.
static PyObject *split_csv(PyObject *, PyObject *args) {
  Py_buffer data;
  int delim, quote, has_header;
  Py_ssize_t k;
  if (!PyArg_ParseTuple(args, "y*iinp", &data, &delim, &quote, &k,
                        &has_header))
    return nullptr;
  if (k < 1 || delim < 0 || delim > 255 || quote < 0 || quote > 255 ||
      delim == quote || delim == 10 || delim == 13 || quote == 10 ||
      quote == 13) {
    PyBuffer_Release(&data);
    PyErr_SetString(PyExc_ValueError, "bad delimiter, quote or k");
    return nullptr;
  }
  const unsigned char *b = static_cast<const unsigned char *>(data.buf);
  const Py_ssize_t n = data.len;
  const unsigned char q = static_cast<unsigned char>(quote);
  // byte classes: 1 delimiter, 2 quote, 3 newline, 4 CR, 5 non-ASCII
  unsigned char cls[256] = {0};
  for (int c = 0x80; c < 256; c++) cls[c] = 5;
  cls[10] = 3;
  cls[13] = 4;
  cls[quote] = 2;
  cls[delim] = 1;
  auto hits = [delim, quote](Block v) -> unsigned {
#if defined(__SSE2__)
    const __m128i a = _mm_or_si128(
        _mm_cmpeq_epi8(v, _mm_set1_epi8(static_cast<char>(delim))),
        _mm_cmpeq_epi8(v, _mm_set1_epi8(static_cast<char>(quote))));
    const __m128i c = _mm_or_si128(_mm_cmpeq_epi8(v, _mm_set1_epi8(10)),
                                   _mm_cmpeq_epi8(v, _mm_set1_epi8(13)));
    // a match is 0xFF, and a byte >= 0x80 has its high bit set already
    return static_cast<unsigned>(
        _mm_movemask_epi8(_mm_or_si128(_mm_or_si128(a, c), v)));
#else
    (void)v;
    return 0;
#endif
  };
  // room for every line, so the outputs are written in place: growing
  // and then copying 10^7-entry arrays costs more than counting newlines
  Py_ssize_t n_lines = 1;
  Py_BEGIN_ALLOW_THREADS;
  for (const unsigned char *p = b, *end = b + n;
       (p = static_cast<const unsigned char *>(memchr(p, 10, end - p)));
       p++)
    n_lines++;
  Py_END_ALLOW_THREADS;
  PyObject *out[5] = {
      PyByteArray_FromStringAndSize(nullptr, n_lines * 8),
      PyByteArray_FromStringAndSize(nullptr, n_lines * 8),
      PyByteArray_FromStringAndSize(nullptr, n_lines),
      PyByteArray_FromStringAndSize(nullptr, n_lines * k * 8),
      PyByteArray_FromStringAndSize(nullptr, n_lines * k * 8)};
  if (!out[0] || !out[1] || !out[2] || !out[3] || !out[4]) {
    for (PyObject *o : out) Py_XDECREF(o);
    PyBuffer_Release(&data);
    return nullptr;
  }
  int64_t *starts = reinterpret_cast<int64_t *>(PyByteArray_AS_STRING(out[0]));
  int64_t *ends = reinterpret_cast<int64_t *>(PyByteArray_AS_STRING(out[1]));
  char *good = PyByteArray_AS_STRING(out[2]);
  int64_t *fstart = reinterpret_cast<int64_t *>(PyByteArray_AS_STRING(out[3]));
  int64_t *flen = reinterpret_cast<int64_t *>(PyByteArray_AS_STRING(out[4]));
  std::vector<int64_t> d;
  Py_ssize_t n_rec = 0, n_fast = 0, bad = -1;
  Py_BEGIN_ALLOW_THREADS;
  bool header_pending = has_header != 0;
  Py_ssize_t s = 0;
  while (s < n) {
    int parity = 0;
    int64_t n_quotes = 0, n_stray = 0;  // stray: inner newlines and CRs
    d.clear();
    Py_ssize_t i = s;
    bool ended = false;
    while (!ended && (i = next_classed(b, i, n, cls, hits)) < n) {
      switch (cls[b[i]]) {
        case 1:
          if (!parity) d.push_back(i);
          break;
        case 2:
          parity ^= 1;
          n_quotes++;
          break;
        case 3:
          if (!parity) {
            ended = true;
            continue;
          }
          n_stray++;
          break;
        case 4:
          n_stray++;
          break;
        default: {
          // a sequence's continuation bytes are >= 0x80: none is skipped
          // over a structural byte
          const Py_ssize_t len = utf8_seq(b + i, n - i);
          if (len == 0 && bad < 0) bad = i;
          if (len > 1) i += len - 1;
        }
      }
      i++;
    }
    const Py_ssize_t next = i + 1;
    Py_ssize_t e = i;
    if (e > s && b[e - 1] == 13) {  // a CR before the end is the terminator's
      e--;
      n_stray--;
    }
    if (e > s && header_pending) {
      header_pending = false;
    } else if (e > s) {
      starts[n_rec] = s;
      ends[n_rec] = e;
      bool ok = static_cast<Py_ssize_t>(d.size()) == k - 1 && n_stray == 0;
      if (ok) {
        int64_t *fs_row = fstart + n_fast * k, *fl_row = flen + n_fast * k;
        int64_t n_quoted = 0;
        for (Py_ssize_t j = 0; j < k; j++) {
          int64_t fs = j == 0 ? s : d[static_cast<size_t>(j - 1)] + 1;
          int64_t fe = j == k - 1 ? e : d[static_cast<size_t>(j)];
          int64_t quoted = fe - fs >= 2 && b[fs] == q && b[fe - 1] == q;
          n_quoted += quoted;
          fs_row[j] = fs + quoted;
          fl_row[j] = fe - fs - 2 * quoted;
        }
        ok = n_quotes == 2 * n_quoted;
      }
      good[n_rec++] = ok ? 1 : 0;
      n_fast += ok;
    }
    s = next;
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&data);
  const Py_ssize_t sizes[5] = {n_rec * 8, n_rec * 8, n_rec, n_fast * k * 8,
                               n_fast * k * 8};
  for (int j = 0; j < 5; j++) {
    if (PyByteArray_Resize(out[j], sizes[j]) < 0) {
      for (PyObject *o : out) Py_DECREF(o);
      return nullptr;
    }
  }
  return Py_BuildValue("(NNNNNnn)", out[0], out[1], out[2], out[3], out[4],
                       n_fast, bad);
}

// Pieces of the file between \n, \r and \r\n terminators (each piece's
// [start, end), terminator excluded; no piece after a final terminator),
// and the indices of the "odd" pieces: those holding another separator of
// str.splitlines (\v, \f, \x1c-\x1e, U+0085, U+2028, U+2029) or bytes that
// are not valid UTF-8. Every other piece decodes to exactly one line of
// data.decode("utf-8", "replace").splitlines(), and its bytes are that
// line's UTF-8. An invalid sequence never takes an ASCII byte with it, so
// a terminator ends a piece whatever came before it.
static PyObject *split_lines(PyObject *, PyObject *arg) {
  Py_buffer data;
  if (PyObject_GetBuffer(arg, &data, PyBUF_SIMPLE) < 0) return nullptr;
  const unsigned char *b = static_cast<const unsigned char *>(data.buf);
  const Py_ssize_t n = data.len;
  // byte classes: 1 terminator, 2 other separator, 3 non-ASCII
  unsigned char cls[256] = {0};
  cls[10] = cls[13] = 1;
  cls[0x0b] = cls[0x0c] = cls[0x1c] = cls[0x1d] = cls[0x1e] = 2;
  for (int c = 0x80; c < 256; c++) cls[c] = 3;
  // candidates: control bytes and bytes >= 0x80 (negative as int8)
  auto hits = [](Block v) -> unsigned {
#if defined(__SSE2__)
    return static_cast<unsigned>(
        _mm_movemask_epi8(_mm_cmplt_epi8(v, _mm_set1_epi8(0x20))));
#else
    (void)v;
    return 0;
#endif
  };
  std::vector<int64_t> starts, ends, odd;
  Py_BEGIN_ALLOW_THREADS;
  Py_ssize_t s = 0, i = 0;
  bool is_odd = false;
  while ((i = next_classed(b, i, n, cls, hits)) < n) {
    const unsigned char c = cls[b[i]];
    if (c == 1) {
      if (is_odd) odd.push_back(static_cast<int64_t>(starts.size()));
      starts.push_back(s);
      ends.push_back(i);
      i += (b[i] == 13 && i + 1 < n && b[i + 1] == 10) ? 2 : 1;
      s = i;
      is_odd = false;
    } else if (c == 2) {
      is_odd = true;
      i++;
    } else {
      const Py_ssize_t len = utf8_seq(b + i, n - i);
      if (len == 0 || (len == 2 && b[i] == 0xC2 && b[i + 1] == 0x85) ||
          (len == 3 && b[i] == 0xE2 && b[i + 1] == 0x80 &&
           (b[i + 2] == 0xA8 || b[i + 2] == 0xA9)))
        is_odd = true;
      i += len ? len : 1;
    }
  }
  if (s < n) {
    if (is_odd) odd.push_back(static_cast<int64_t>(starts.size()));
    starts.push_back(s);
    ends.push_back(n);
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&data);
  PyObject *odd_list = PyList_New(static_cast<Py_ssize_t>(odd.size()));
  if (!odd_list) return nullptr;
  for (size_t j = 0; j < odd.size(); j++) {
    PyObject *v = PyLong_FromLongLong(odd[j]);
    if (!v) {
      Py_DECREF(odd_list);
      return nullptr;
    }
    PyList_SET_ITEM(odd_list, static_cast<Py_ssize_t>(j), v);
  }
  return Py_BuildValue("(NNN)", bytearray_of(starts), bytearray_of(ends),
                       odd_list);
}

// Byte ranges into zero-padded matrices, k columns at once. starts and
// lens are row-major [F, k] int64 (field j of record i at [i * k + j]);
// range (i, j) lands in row pos[i] (row i without pos) of column j's
// [m, w_j] matrix, w_j the longest range of column j (at least 1). Rows
// no range lands in stay zero with length 0. One pass over the records in
// file order, one memcpy per range: the CSV source's per-column matrices
// and the text source's line matrix (k = 1).
static PyObject *gather_rows(PyObject *, PyObject *args) {
  Py_buffer data, st, ln, ps{};
  PyObject *pos_o;
  Py_ssize_t k, m;
  if (!PyArg_ParseTuple(args, "y*y*y*nOn", &data, &st, &ln, &k, &pos_o, &m))
    return nullptr;
  const bool has_pos = pos_o != Py_None;
  if (has_pos && PyObject_GetBuffer(pos_o, &ps, PyBUF_SIMPLE) < 0) {
    PyBuffer_Release(&data);
    PyBuffer_Release(&st);
    PyBuffer_Release(&ln);
    return nullptr;
  }
  auto release = [&]() {
    PyBuffer_Release(&data);
    PyBuffer_Release(&st);
    PyBuffer_Release(&ln);
    if (has_pos) PyBuffer_Release(&ps);
  };
  const Py_ssize_t f = k > 0 ? st.len / 8 / k : 0;
  const int64_t *sp = static_cast<const int64_t *>(st.buf);
  const int64_t *lp = static_cast<const int64_t *>(ln.buf);
  const int64_t *pp = static_cast<const int64_t *>(ps.buf);
  const char *err = nullptr;
  if (k < 1 || m < 0 || st.len != f * k * 8 || ln.len != st.len ||
      (has_pos ? ps.len != f * 8 : m != f))
    err = "want starts and lens of [F, k] int64 and pos of [F] (m = F "
          "without pos)";
  std::vector<int64_t> w(static_cast<size_t>(k > 0 ? k : 0), 1);
  for (Py_ssize_t i = 0; i < f && !err; i++) {
    if (has_pos && (pp[i] < 0 || pp[i] >= m)) err = "row out of bounds";
    for (Py_ssize_t j = 0; j < k; j++) {
      const int64_t s = sp[i * k + j], l = lp[i * k + j];
      if (s < 0 || l < 0 || s > data.len - l) err = "range out of bounds";
      if (l > w[static_cast<size_t>(j)]) w[static_cast<size_t>(j)] = l;
    }
  }
  for (int64_t wj : w)
    if (!err && wj > INT32_MAX) err = "range longer than int32";
  if (err) {
    release();
    PyErr_SetString(PyExc_ValueError, err);
    return nullptr;
  }
  PyObject *out = PyList_New(k);
  std::vector<char *> mats(static_cast<size_t>(k));
  std::vector<int32_t *> lens(static_cast<size_t>(k));
  for (Py_ssize_t j = 0; j < k && out; j++) {
    const Py_ssize_t wj = static_cast<Py_ssize_t>(w[static_cast<size_t>(j)]);
    PyObject *mat = PyByteArray_FromStringAndSize(nullptr, m * wj);
    PyObject *lb = PyByteArray_FromStringAndSize(nullptr, m * 4);
    PyObject *t = mat && lb ? Py_BuildValue("(NNn)", mat, lb, wj) : nullptr;
    if (!t) {
      if (!(mat && lb)) {
        Py_XDECREF(mat);
        Py_XDECREF(lb);
      }
      Py_CLEAR(out);
      break;
    }
    mats[static_cast<size_t>(j)] = PyByteArray_AS_STRING(mat);
    lens[static_cast<size_t>(j)] =
        reinterpret_cast<int32_t *>(PyByteArray_AS_STRING(lb));
    PyList_SET_ITEM(out, j, t);
  }
  if (!out) {
    release();
    return nullptr;
  }
  const char *src = static_cast<const char *>(data.buf);
  Py_BEGIN_ALLOW_THREADS;
  if (has_pos) {
    for (Py_ssize_t j = 0; j < k; j++) {
      memset(mats[static_cast<size_t>(j)], 0,
             static_cast<size_t>(m * w[static_cast<size_t>(j)]));
      memset(lens[static_cast<size_t>(j)], 0, static_cast<size_t>(m) * 4);
    }
  }
  for (Py_ssize_t i = 0; i < f; i++) {
    const int64_t r = has_pos ? pp[i] : i;
    for (Py_ssize_t j = 0; j < k; j++) {
      const size_t jj = static_cast<size_t>(j);
      const int64_t l = lp[i * k + j];
      char *row = mats[jj] + r * w[jj];
      memcpy(row, src + sp[i * k + j], static_cast<size_t>(l));
      if (!has_pos) memset(row + l, 0, static_cast<size_t>(w[jj] - l));
      lens[jj][r] = static_cast<int32_t>(l);
    }
  }
  Py_END_ALLOW_THREADS;
  release();
  return out;
}

static PyMethodDef Methods[] = {
    {"encode_i64", encode_i64, METH_O, "bulk encode int column"},
    {"encode_f64", encode_f64, METH_O, "bulk encode float column"},
    {"encode_bool", encode_bool, METH_O, "bulk encode bool column"},
    {"encode_str", encode_str, METH_O, "bulk encode str column"},
    {"offsets_to_matrix", offsets_to_matrix, METH_VARARGS,
     "arrow offsets+data -> padded byte matrix"},
    {"decode_str", decode_str, METH_VARARGS, "bulk decode str column"},
    {"decode_columns", decode_columns, METH_VARARGS,
     "typed column buffers -> list of row tuples"},
    {"encode_rows", encode_rows, METH_VARARGS,
     "list of tuples -> per-column typed buffers"},
    {"split_csv", split_csv, METH_VARARGS,
     "CSV bytes -> record ranges and fast-path field ranges"},
    {"split_lines", split_lines, METH_O,
     "text bytes -> line ranges and the lines str.splitlines must read"},
    {"gather_rows", gather_rows, METH_VARARGS,
     "byte ranges -> zero-padded byte matrix"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef Module = {PyModuleDef_HEAD_INIT,
                                    "_tuplex_torch_native",
                                    "host data plane of tuplex_tpu_torch",
                                    -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit__tuplex_torch_native(void) { return PyModule_Create(&Module); }
