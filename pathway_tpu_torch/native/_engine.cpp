// The engine's host loops — CPython extension of the port's dataflow engine.
//
// Canonical value serialization + XXH64 keying over whole columns,
// (key, row-hash) delta consolidation, the SoA transpose behind
// Batch.from_rows, the record -> row extraction of the connectors
// (record dicts, JSON-lines and CSV bytes), the newline tokenizer of the
// line-based file readers, and the hash join's two loops (one
// side's batch applied to its buckets, and the dL x R cross products with
// their pair keys). The keys are bit-for-bit those of
// the JAX package's engine, so tables compare by row id across packages.
//
// XXH64 implemented from the public algorithm specification
// (github.com/Cyan4973/xxHash, public domain); equal to the Python
// implementation in engine/xxh64.py and to python-xxhash's xxh64.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

// ---------------------------------------------------------------- XXH64
static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64/arm64)
}
static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
static inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl64(acc, 31);
  return acc * P1;
}
static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  val = xxh_round(0, val);
  acc ^= val;
  return acc * P1 + P4;
}

static uint64_t xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed + 0;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read64(p)); p += 8;
      v2 = xxh_round(v2, read64(p)); p += 8;
      v3 = xxh_round(v3, read64(p)); p += 8;
      v4 = xxh_round(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------- canonical value serialization
// Byte-for-byte identical to engine/value.py serialize_value for the types
// handled natively; exotic types (ndarray, Json, datetimes, PyObjectWrapper)
// signal a fallback to the Python encoder.

static PyObject* g_pointer_type = nullptr;  // set by set_pointer_type()

struct SerializeError {};

static bool serialize(PyObject* v, std::string& out);

static inline void put_u32(std::string& out, uint32_t x) {
  out.append(reinterpret_cast<const char*>(&x), 4);
}
static inline void put_u64(std::string& out, uint64_t x) {
  out.append(reinterpret_cast<const char*>(&x), 8);
}

static bool serialize(PyObject* v, std::string& out) {
  if (v == Py_None) {
    out.push_back('\x00');
  } else if (PyBool_Check(v)) {
    out.push_back('\x01');
    out.push_back(v == Py_True ? '\x01' : '\x00');
  } else if (PyLong_Check(v)) {
    int overflow = 0;
    long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (!overflow) {
      out.push_back('\x02');
      put_u64(out, (uint64_t)ll);
    } else if (overflow > 0) {
      // positive ints in [2^63, 2^64) — every uint64 row key lands here.
      // Python encodes them as TAG_BIGINT + u32 len + to_bytes(little,
      // signed): bit_length 64 -> 9 bytes, low 8 LE + 0x00 sign byte.
      unsigned long long ull = PyLong_AsUnsignedLongLong(v);
      if (PyErr_Occurred()) {
        PyErr_Clear();
        return false;  // > 2^64: rare — python fallback
      }
      out.push_back('\x0f');
      put_u32(out, 9);
      put_u64(out, (uint64_t)ull);
      out.push_back('\x00');
    } else {
      return false;  // < -2^63: rare — python fallback
    }
  } else if (PyFloat_Check(v)) {
    double d = PyFloat_AS_DOUBLE(v);
    out.push_back('\x03');
    out.append(reinterpret_cast<const char*>(&d), 8);
  } else if (PyUnicode_Check(v)) {
    Py_ssize_t n;
    const char* s = PyUnicode_AsUTF8AndSize(v, &n);
    if (s == nullptr) throw SerializeError{};
    out.push_back('\x04');
    put_u32(out, (uint32_t)n);
    out.append(s, (size_t)n);
  } else if (PyBytes_Check(v)) {
    out.push_back('\x05');
    put_u32(out, (uint32_t)PyBytes_GET_SIZE(v));
    out.append(PyBytes_AS_STRING(v), (size_t)PyBytes_GET_SIZE(v));
  } else if (g_pointer_type != nullptr &&
             PyObject_TypeCheck(v, (PyTypeObject*)g_pointer_type)) {
    PyObject* val = PyObject_GetAttrString(v, "value");
    if (val == nullptr) throw SerializeError{};
    uint64_t k = PyLong_AsUnsignedLongLongMask(val);
    Py_DECREF(val);
    if (PyErr_Occurred()) throw SerializeError{};
    out.push_back('\x06');
    put_u64(out, k);
  } else if (PyTuple_Check(v) || PyList_Check(v)) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(v);
    out.push_back('\x07');
    put_u32(out, (uint32_t)n);
    PyObject** items = PySequence_Fast_ITEMS(v);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (!serialize(items[i], out)) return false;
    }
  } else {
    return false;  // exotic type -> python fallback
  }
  return true;
}

// hash_object_column(seq, out_buffer) -> list_of_fallback_indices

// out_buffer: writable buffer of n*8 bytes receiving LE uint64 digests.
static PyObject* py_hash_object_column(PyObject*, PyObject* args) {
  PyObject* seq;
  Py_buffer out_buf;
  if (!PyArg_ParseTuple(args, "Ow*", &seq, &out_buf)) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "expected a sequence");
  if (fast == nullptr) {
    PyBuffer_Release(&out_buf);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  if ((Py_ssize_t)out_buf.len < n * 8) {
    PyBuffer_Release(&out_buf);
    Py_DECREF(fast);
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    return nullptr;
  }
  uint64_t* out = reinterpret_cast<uint64_t*>(out_buf.buf);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  PyObject* fallback = PyList_New(0);
  std::string buf;
  buf.reserve(64);
  try {
    for (Py_ssize_t i = 0; i < n; i++) {
      buf.clear();
      if (serialize(items[i], buf)) {
        out[i] = xxh64(reinterpret_cast<const uint8_t*>(buf.data()),
                       buf.size(), 0);
      } else {
        PyObject* idx = PyLong_FromSsize_t(i);
        PyList_Append(fallback, idx);
        Py_DECREF(idx);
      }
    }
  } catch (SerializeError&) {
    PyBuffer_Release(&out_buf);
    Py_DECREF(fast);
    Py_DECREF(fallback);
    return nullptr;
  }
  PyBuffer_Release(&out_buf);
  Py_DECREF(fast);
  return fallback;
}


// xxh64_digest(bytes_like, seed=0) -> int
static PyObject* py_xxh64(PyObject*, PyObject* args) {
  Py_buffer buf;
  unsigned long long seed = 0;
  if (!PyArg_ParseTuple(args, "y*|K", &buf, &seed)) return nullptr;
  uint64_t h = xxh64(reinterpret_cast<const uint8_t*>(buf.buf),
                     (size_t)buf.len, (uint64_t)seed);
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLongLong(h);
}

// consolidate_pairs(keys_u64, rowh_u64, diffs_i64) -> (idx_bytes, diff_bytes)
// Groups rows by (key, row_hash), sums diffs, drops zero groups; returns the
// first-occurrence index (uint64 LE) and summed diff (int64 LE) per kept
// group, ordered by first occurrence.
static PyObject* py_consolidate_pairs(PyObject*, PyObject* args) {
  Py_buffer kb, rb, db;
  if (!PyArg_ParseTuple(args, "y*y*y*", &kb, &rb, &db)) return nullptr;
  size_t n = kb.len / 8;
  if (rb.len / 8 != (Py_ssize_t)n || db.len / 8 != (Py_ssize_t)n) {
    PyBuffer_Release(&kb); PyBuffer_Release(&rb); PyBuffer_Release(&db);
    PyErr_SetString(PyExc_ValueError, "length mismatch");
    return nullptr;
  }
  const uint64_t* keys = reinterpret_cast<const uint64_t*>(kb.buf);
  const uint64_t* rowh = reinterpret_cast<const uint64_t*>(rb.buf);
  const int64_t* diffs = reinterpret_cast<const int64_t*>(db.buf);

  std::vector<uint32_t> order(n);
  for (size_t i = 0; i < n; i++) order[i] = (uint32_t)i;
  std::sort(order.begin(), order.end(), [&](uint32_t a, uint32_t b) {
    if (keys[a] != keys[b]) return keys[a] < keys[b];
    if (rowh[a] != rowh[b]) return rowh[a] < rowh[b];
    return a < b;
  });

  std::vector<uint64_t> first;
  std::vector<int64_t> summed;
  first.reserve(n);
  summed.reserve(n);
  size_t i = 0;
  while (i < n) {
    size_t j = i;
    int64_t s = 0;
    uint32_t f = order[i];
    while (j < n && keys[order[j]] == keys[order[i]] &&
           rowh[order[j]] == rowh[order[i]]) {
      s += diffs[order[j]];
      if (order[j] < f) f = order[j];
      j++;
    }
    if (s != 0) {
      first.push_back(f);
      summed.push_back(s);
    }
    i = j;
  }
  // order kept groups by first occurrence for deterministic batch layout
  std::vector<uint32_t> gorder(first.size());
  for (size_t g = 0; g < gorder.size(); g++) gorder[g] = (uint32_t)g;
  std::sort(gorder.begin(), gorder.end(), [&](uint32_t a, uint32_t b) {
    return first[a] < first[b];
  });
  PyObject* idx_bytes = PyBytes_FromStringAndSize(nullptr, first.size() * 8);
  PyObject* diff_bytes = PyBytes_FromStringAndSize(nullptr, summed.size() * 8);
  if (idx_bytes && diff_bytes) {
    uint64_t* ip = reinterpret_cast<uint64_t*>(PyBytes_AS_STRING(idx_bytes));
    int64_t* dp = reinterpret_cast<int64_t*>(PyBytes_AS_STRING(diff_bytes));
    for (size_t g = 0; g < gorder.size(); g++) {
      ip[g] = first[gorder[g]];
      dp[g] = summed[gorder[g]];
    }
  }
  PyBuffer_Release(&kb); PyBuffer_Release(&rb); PyBuffer_Release(&db);
  if (!idx_bytes || !diff_bytes) {
    Py_XDECREF(idx_bytes); Py_XDECREF(diff_bytes);
    return nullptr;
  }
  PyObject* ret = PyTuple_Pack(2, idx_bytes, diff_bytes);
  Py_DECREF(idx_bytes);
  Py_DECREF(diff_bytes);
  return ret;
}

// Batch schema extraction+coercion — the per-record half the reference
// does in Rust (src/connectors/data_format.rs JsonLinesParser). For each
// record dict, produce one row tuple in column order with the FAST
// coercions applied in C: exact-type passthrough, int->float, absent ->
// schema default / None. A record needing anything slower (string->int
// parses, datetimes, JSON wrapping, non-dict records) lands in
// fallback_indices and is re-parsed wholesale by the Python path, so
// semantics cannot drift. dtype_codes per column: 0=always-fallback,
// 1=INT, 2=FLOAT, 3=BOOL, 4=STR, 5=BYTES, 6=ANY(passthrough).
static PyObject* py_rows_from_records(PyObject*, PyObject* args) {
  PyObject *records, *cols, *codes_obj, *defaults;
  if (!PyArg_ParseTuple(args, "OOOO", &records, &cols, &codes_obj, &defaults))
    return nullptr;
  PyObject* rec_fast = PySequence_Fast(records, "records must be a sequence");
  if (rec_fast == nullptr) return nullptr;
  PyObject* col_fast = PySequence_Fast(cols, "cols must be a sequence");
  if (col_fast == nullptr) {
    Py_DECREF(rec_fast);
    return nullptr;
  }
  PyObject* code_fast = PySequence_Fast(codes_obj, "codes must be a sequence");
  if (code_fast == nullptr) {
    Py_DECREF(rec_fast);
    Py_DECREF(col_fast);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(rec_fast);
  Py_ssize_t nc = PySequence_Fast_GET_SIZE(col_fast);
  if (PySequence_Fast_GET_SIZE(code_fast) != nc || !PyDict_Check(defaults)) {
    Py_DECREF(rec_fast);
    Py_DECREF(col_fast);
    Py_DECREF(code_fast);
    PyErr_SetString(PyExc_ValueError, "cols/codes length mismatch or bad defaults");
    return nullptr;
  }
  std::vector<long> codes((size_t)nc);
  for (Py_ssize_t j = 0; j < nc; j++) {
    codes[(size_t)j] = PyLong_AsLong(PySequence_Fast_GET_ITEM(code_fast, j));
  }
  PyObject** recs = PySequence_Fast_ITEMS(rec_fast);
  PyObject** colnames = PySequence_Fast_ITEMS(col_fast);
  PyObject* rows = PyList_New(n);
  PyObject* fallback = PyList_New(0);
  if (rows == nullptr || fallback == nullptr) goto fail;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* rec = recs[i];
    bool ok = PyDict_Check(rec);
    PyObject* row = ok ? PyTuple_New(nc) : nullptr;
    if (ok && row == nullptr) goto fail;
    for (Py_ssize_t j = 0; ok && j < nc; j++) {
      PyObject* v = PyDict_GetItem(rec, colnames[j]);  // borrowed
      PyObject* outv = nullptr;
      if (v == nullptr) {  // absent field: schema default, else null
        outv = PyDict_GetItem(defaults, colnames[j]);
        if (outv == nullptr) outv = Py_None;
        Py_INCREF(outv);
      } else if (v == Py_None) {
        outv = Py_None;
        Py_INCREF(outv);
      } else {
        switch (codes[(size_t)j]) {
          case 1:  // INT
            if (PyLong_Check(v) && !PyBool_Check(v)) {
              outv = v;
              Py_INCREF(outv);
            }
            break;
          case 2:  // FLOAT
            if (PyFloat_Check(v)) {
              outv = v;
              Py_INCREF(outv);
            } else if (PyLong_Check(v) && !PyBool_Check(v)) {
              double d = PyLong_AsDouble(v);
              if (d == -1.0 && PyErr_Occurred()) {
                PyErr_Clear();
              } else {
                outv = PyFloat_FromDouble(d);
              }
            }
            break;
          case 3:  // BOOL
            if (PyBool_Check(v)) {
              outv = v;
              Py_INCREF(outv);
            }
            break;
          case 4:  // STR
            if (PyUnicode_Check(v)) {
              outv = v;
              Py_INCREF(outv);
            }
            break;
          case 5:  // BYTES
            if (PyBytes_Check(v)) {
              outv = v;
              Py_INCREF(outv);
            }
            break;
          case 6:  // ANY: passthrough
            outv = v;
            Py_INCREF(outv);
            break;
          default:
            break;  // 0: always fallback
        }
      }
      if (outv == nullptr) {
        ok = false;  // slow coercion needed: whole record -> Python
      } else {
        PyTuple_SET_ITEM(row, j, outv);
      }
    }
    if (ok) {
      PyList_SET_ITEM(rows, i, row);  // steals
    } else {
      Py_XDECREF(row);
      Py_INCREF(Py_None);
      PyList_SET_ITEM(rows, i, Py_None);
      PyObject* idx = PyLong_FromSsize_t(i);
      if (idx == nullptr || PyList_Append(fallback, idx) < 0) {
        Py_XDECREF(idx);
        goto fail;
      }
      Py_DECREF(idx);
    }
  }
  Py_DECREF(rec_fast);
  Py_DECREF(col_fast);
  Py_DECREF(code_fast);
  return Py_BuildValue("(NN)", rows, fallback);
fail:
  Py_DECREF(rec_fast);
  Py_DECREF(col_fast);
  Py_DECREF(code_fast);
  Py_XDECREF(rows);
  Py_XDECREF(fallback);
  return nullptr;
}

// jsonl_rows(data, cols, dtype_codes, defaults)
//   -> (rows list[tuple|None], fallback list[(index, line_bytes)])
// One-pass JSON-lines parse + schema extraction + fast coercion straight
// from bytes — the full Rust-parser analog (data_format.rs JsonLinesParser
// over data_tokenize.rs lines). Flat objects with string/int/float/bool/
// null values parse here; any line with escapes, nested containers,
// overflowing ints, or coercions outside the fast table is returned as a
// fallback (index, bytes) pair for the Python path. Blank lines produce no
// row. Rows list holds None at fallback positions (caller patches/drops).
namespace jsonl {

struct Cursor {
  const char* p;
  const char* end;
};

static inline void skip_ws(Cursor& c) {
  while (c.p < c.end &&
         (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) {
    c.p++;
  }
}

// scan a JSON string (after the opening quote); false => escape/invalid
static bool scan_string(Cursor& c, const char** s, size_t* len) {
  *s = c.p;
  while (c.p < c.end) {
    unsigned char ch = (unsigned char)*c.p;
    if (ch == '"') {
      *len = (size_t)(c.p - *s);
      c.p++;
      return true;
    }
    if (ch == '\\' || ch < 0x20) return false;  // escapes -> python path
    c.p++;
  }
  return false;
}

enum ValKind { V_FAIL, V_STR, V_INT, V_FLOAT, V_TRUE, V_FALSE, V_NULL };

struct Val {
  ValKind kind;
  const char* s;
  size_t len;
  long long i;
  double d;
};

static Val parse_value(Cursor& c) {
  Val v;
  v.kind = V_FAIL;
  skip_ws(c);
  if (c.p >= c.end) return v;
  char ch = *c.p;
  if (ch == '"') {
    c.p++;
    if (scan_string(c, &v.s, &v.len)) v.kind = V_STR;
    return v;
  }
  if (ch == 't') {
    if (c.end - c.p >= 4 && std::memcmp(c.p, "true", 4) == 0) {
      c.p += 4;
      v.kind = V_TRUE;
    }
    return v;
  }
  if (ch == 'f') {
    if (c.end - c.p >= 5 && std::memcmp(c.p, "false", 5) == 0) {
      c.p += 5;
      v.kind = V_FALSE;
    }
    return v;
  }
  if (ch == 'n') {
    if (c.end - c.p >= 4 && std::memcmp(c.p, "null", 4) == 0) {
      c.p += 4;
      v.kind = V_NULL;
    }
    return v;
  }
  if (ch == '-' || (ch >= '0' && ch <= '9')) {
    // strict JSON number grammar: -?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?
    // — leading-zero ints ('0123') and empty fractions ('1.') must FAIL
    // here exactly like json.loads rejects them, or the fast path would
    // emit rows from lines the Python path drops
    const char* start = c.p;
    bool is_float = false;
    if (ch == '-') c.p++;
    const char* int_start = c.p;
    while (c.p < c.end && *c.p >= '0' && *c.p <= '9') c.p++;
    size_t int_digits = (size_t)(c.p - int_start);
    if (int_digits == 0 ||
        (int_digits > 1 && *int_start == '0')) {
      return v;
    }
    if (c.p < c.end && *c.p == '.') {
      is_float = true;
      c.p++;
      const char* frac_start = c.p;
      while (c.p < c.end && *c.p >= '0' && *c.p <= '9') c.p++;
      if (c.p == frac_start) return v;  // '1.' is not JSON
    }
    if (c.p < c.end && (*c.p == 'e' || *c.p == 'E')) {
      is_float = true;
      c.p++;
      if (c.p < c.end && (*c.p == '+' || *c.p == '-')) c.p++;
      const char* exp_start = c.p;
      while (c.p < c.end && *c.p >= '0' && *c.p <= '9') c.p++;
      if (c.p == exp_start) return v;  // '1e' is not JSON
    }
    std::string num(start, (size_t)(c.p - start));
    if (is_float) {
      char* endp = nullptr;
      v.d = std::strtod(num.c_str(), &endp);
      if (endp == num.c_str() + num.size()) v.kind = V_FLOAT;
    } else {
      errno = 0;
      char* endp = nullptr;
      v.i = std::strtoll(num.c_str(), &endp, 10);
      if (errno == 0 && endp == num.c_str() + num.size()) v.kind = V_INT;
    }
    return v;
  }
  return v;  // '{' / '[' / garbage -> fallback
}

}  // namespace jsonl

static PyObject* py_jsonl_rows(PyObject*, PyObject* args) {
  Py_buffer buf;
  PyObject *cols, *codes_obj, *defaults;
  int columnar = 0;  // 1: emit per-column LISTS (no row tuples) — the
                     // bulk fs reader consumes columns, so the row-tuple
                     // detour and its transpose disappear entirely
  if (!PyArg_ParseTuple(args, "y*OOO|i", &buf, &cols, &codes_obj, &defaults,
                        &columnar))
    return nullptr;
  PyObject* col_fast = PySequence_Fast(cols, "cols must be a sequence");
  PyObject* code_fast =
      col_fast ? PySequence_Fast(codes_obj, "codes must be a sequence")
               : nullptr;
  if (col_fast == nullptr || code_fast == nullptr) {
    Py_XDECREF(col_fast);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Py_ssize_t nc = PySequence_Fast_GET_SIZE(col_fast);
  std::vector<std::string> names((size_t)nc);
  std::vector<long> codes((size_t)nc);
  std::vector<PyObject*> defvals((size_t)nc);  // borrowed (or nullptr)
  bool arg_err = PySequence_Fast_GET_SIZE(code_fast) != nc ||
                 !PyDict_Check(defaults);
  for (Py_ssize_t j = 0; !arg_err && j < nc; j++) {
    PyObject* nm = PySequence_Fast_GET_ITEM(col_fast, j);
    Py_ssize_t sl;
    const char* s = PyUnicode_AsUTF8AndSize(nm, &sl);
    if (s == nullptr) {
      arg_err = true;
      break;
    }
    names[(size_t)j].assign(s, (size_t)sl);
    codes[(size_t)j] = PyLong_AsLong(PySequence_Fast_GET_ITEM(code_fast, j));
    defvals[(size_t)j] = PyDict_GetItem(defaults, nm);
  }
  if (arg_err) {
    Py_DECREF(col_fast);
    Py_DECREF(code_fast);
    PyBuffer_Release(&buf);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "bad cols/codes/defaults");
    return nullptr;
  }
  PyObject* rows = columnar ? nullptr : PyList_New(0);
  PyObject* fallback = PyList_New(0);
  std::vector<PyObject*> col_out;  // columnar mode: one list per column
  bool mem_err = (!columnar && rows == nullptr) || fallback == nullptr;
  if (columnar) {
    col_out.resize((size_t)nc, nullptr);
    for (Py_ssize_t j = 0; !mem_err && j < nc; j++) {
      col_out[(size_t)j] = PyList_New(0);
      if (col_out[(size_t)j] == nullptr) mem_err = true;
    }
  }
  Py_ssize_t n_rows_out = 0;  // emitted rows incl. fallback placeholders
  const char* data = reinterpret_cast<const char*>(buf.buf);
  const char* data_end = data + buf.len;
  std::vector<PyObject*> rowvals((size_t)nc);  // owned per row
  const char* line = data;
  while (line < data_end && !mem_err) {
    const char* nl = (const char*)std::memchr(line, '\n', (size_t)(data_end - line));
    const char* line_end = nl ? nl : data_end;
    jsonl::Cursor c{line, line_end};
    jsonl::skip_ws(c);
    if (c.p == line_end) {  // blank line: no row
      line = nl ? nl + 1 : data_end;
      continue;
    }
    bool ok = (*c.p == '{');
    if (ok) c.p++;
    for (Py_ssize_t j = 0; j < nc; j++) rowvals[(size_t)j] = nullptr;
    if (ok) {
      jsonl::skip_ws(c);
      if (c.p < line_end && *c.p == '}') {
        c.p++;  // empty object
      } else {
        while (ok) {
          jsonl::skip_ws(c);
          if (c.p >= line_end || *c.p != '"') {
            ok = false;
            break;
          }
          c.p++;
          const char* ks;
          size_t klen;
          if (!jsonl::scan_string(c, &ks, &klen)) {
            ok = false;
            break;
          }
          jsonl::skip_ws(c);
          if (c.p >= line_end || *c.p != ':') {
            ok = false;
            break;
          }
          c.p++;
          jsonl::Val v = jsonl::parse_value(c);
          if (v.kind == jsonl::V_FAIL) {
            ok = false;
            break;
          }
          // which column? (linear scan; schemas are narrow)
          Py_ssize_t target = -1;
          for (Py_ssize_t j = 0; j < nc; j++) {
            if (names[(size_t)j].size() == klen &&
                std::memcmp(names[(size_t)j].data(), ks, klen) == 0) {
              target = j;
              break;
            }
          }
          if (target >= 0) {
            PyObject* outv = nullptr;
            long code = codes[(size_t)target];
            switch (v.kind) {
              case jsonl::V_NULL:
                outv = Py_None;
                Py_INCREF(outv);
                break;
              case jsonl::V_STR:
                if (code == 4 || code == 6)
                  outv = PyUnicode_FromStringAndSize(v.s, (Py_ssize_t)v.len);
                break;
              case jsonl::V_INT:
                if (code == 1 || code == 6)
                  outv = PyLong_FromLongLong(v.i);
                else if (code == 2)
                  outv = PyFloat_FromDouble((double)v.i);
                break;
              case jsonl::V_FLOAT:
                if (code == 2 || code == 6)
                  outv = PyFloat_FromDouble(v.d);
                break;
              case jsonl::V_TRUE:
              case jsonl::V_FALSE:
                if (code == 3 || code == 6) {
                  outv = v.kind == jsonl::V_TRUE ? Py_True : Py_False;
                  Py_INCREF(outv);
                }
                break;
              default:
                break;
            }
            if (outv == nullptr) {
              // slow coercion -> python (clear any allocation/decoding
              // error PyUnicode_FromStringAndSize may have set)
              if (PyErr_Occurred()) PyErr_Clear();
              ok = false;
              break;
            }
            Py_XDECREF(rowvals[(size_t)target]);  // duplicate key: last wins
            rowvals[(size_t)target] = outv;
          }
          jsonl::skip_ws(c);
          if (c.p < line_end && *c.p == ',') {
            c.p++;
            continue;
          }
          if (c.p < line_end && *c.p == '}') {
            c.p++;
            break;
          }
          ok = false;
        }
      }
      if (ok) {  // only trailing whitespace may follow
        jsonl::skip_ws(c);
        ok = (c.p == line_end);
      }
    }
    if (ok) {
      if (columnar) {
        for (Py_ssize_t j = 0; j < nc && !mem_err; j++) {
          PyObject* outv = rowvals[(size_t)j];
          if (outv == nullptr) {
            outv = defvals[(size_t)j] ? defvals[(size_t)j] : Py_None;
            Py_INCREF(outv);
          }
          if (PyList_Append(col_out[(size_t)j], outv) < 0) mem_err = true;
          Py_DECREF(outv);
          rowvals[(size_t)j] = nullptr;
        }
        for (Py_ssize_t j = 0; j < nc; j++) {  // on error: free leftovers
          Py_XDECREF(rowvals[(size_t)j]);
          rowvals[(size_t)j] = nullptr;
        }
        n_rows_out++;
      } else {
        PyObject* row = PyTuple_New(nc);
        if (row == nullptr) {
          mem_err = true;
        } else {
          for (Py_ssize_t j = 0; j < nc; j++) {
            PyObject* outv = rowvals[(size_t)j];
            if (outv == nullptr) {
              outv = defvals[(size_t)j] ? defvals[(size_t)j] : Py_None;
              Py_INCREF(outv);
            }
            PyTuple_SET_ITEM(row, j, outv);
            rowvals[(size_t)j] = nullptr;
          }
          if (PyList_Append(rows, row) < 0) mem_err = true;
          Py_DECREF(row);
          n_rows_out++;
        }
      }
    } else {
      for (Py_ssize_t j = 0; j < nc; j++) Py_XDECREF(rowvals[(size_t)j]);
      PyObject* entry = Py_BuildValue(
          "(ny#)", n_rows_out, line, (Py_ssize_t)(line_end - line));
      if (entry == nullptr || PyList_Append(fallback, entry) < 0) {
        Py_XDECREF(entry);
        mem_err = true;
      } else {
        Py_DECREF(entry);
        if (columnar) {
          for (Py_ssize_t j = 0; j < nc && !mem_err; j++) {
            if (PyList_Append(col_out[(size_t)j], Py_None) < 0)
              mem_err = true;
          }
        } else {
          Py_INCREF(Py_None);
          if (PyList_Append(rows, Py_None) < 0) mem_err = true;
          Py_DECREF(Py_None);
        }
        n_rows_out++;
      }
    }
    line = nl ? nl + 1 : data_end;
  }
  Py_DECREF(col_fast);
  Py_DECREF(code_fast);
  PyBuffer_Release(&buf);
  if (mem_err) {
    Py_XDECREF(rows);
    Py_XDECREF(fallback);
    for (PyObject* cl : col_out) Py_XDECREF(cl);
    return nullptr;
  }
  if (columnar) {
    PyObject* cols_tuple = PyTuple_New(nc);
    if (cols_tuple == nullptr) {
      Py_XDECREF(fallback);
      for (PyObject* cl : col_out) Py_XDECREF(cl);
      return nullptr;
    }
    for (Py_ssize_t j = 0; j < nc; j++) {
      PyTuple_SET_ITEM(cols_tuple, j, col_out[(size_t)j]);  // steals ref
    }
    return Py_BuildValue("(NnN)", cols_tuple, n_rows_out, fallback);
  }
  return Py_BuildValue("(NN)", rows, fallback);
}

// split_lines(bytes) -> bytes of uint64 LE (start,end) offset pairs per line,
// skipping a trailing empty line — the tokenizer core for jsonlines/plaintext
// readers (reference: src/connectors/data_tokenize.rs).
static PyObject* py_split_lines(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const char* data = reinterpret_cast<const char*>(buf.buf);
  size_t n = (size_t)buf.len;
  std::vector<uint64_t> offs;
  size_t start = 0;
  for (size_t i = 0; i < n; i++) {
    if (data[i] == '\n') {
      offs.push_back(start);
      offs.push_back(i);
      start = i + 1;
    }
  }
  if (start < n) {
    offs.push_back(start);
    offs.push_back(n);
  }
  PyObject* out = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(offs.data()), offs.size() * 8);
  PyBuffer_Release(&buf);
  return out;
}

// ------------------------------------------------------------- CSV (DSV)
// RFC4180-style state machine mirroring Python's csv.DictReader semantics
// for the common settings (1-byte delimiter/quote): records split on
// newlines OUTSIDE quotes, quoted fields may contain delimiter/newline and
// doubled quotes, a trailing \r before the record break is stripped.
// Simple coercions (int/float/bool/str) happen here; any record with a
// field the simple parser cannot coerce exactly like io/_utils.parse_value
// is returned as a fallback (record index, raw record bytes) for the
// Python csv module to re-parse — results are identical either way.

namespace csvn {

// exact mirror of parse_value's int(): optional sign + digits only
// (anything else — underscores, whitespace, hex — goes to fallback)
static bool parse_int(const std::string& f, long long* out) {
  if (f.empty()) return false;
  size_t i = (f[0] == '+' || f[0] == '-') ? 1 : 0;
  if (i == f.size()) return false;
  long long v = 0;
  for (; i < f.size(); i++) {
    if (f[i] < '0' || f[i] > '9') return false;
    if (v > (9223372036854775807LL - 9) / 10) return false;  // overflow
    v = v * 10 + (f[i] - '0');
  }
  *out = f[0] == '-' ? -v : v;
  return true;
}

static bool parse_float(const std::string& f, double* out) {
  if (f.empty()) return false;
  // strtod accepts inf/nan/hex and leading whitespace, which Python's
  // float() treats differently in part — allow only the plain forms
  for (char c : f) {
    if (!((c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.' ||
          c == 'e' || c == 'E'))
      return false;
  }
  errno = 0;
  char* end = nullptr;
  double v = std::strtod(f.c_str(), &end);
  if (end != f.c_str() + f.size() || errno == ERANGE) return false;
  *out = v;
  return true;
}

static inline bool is_strip_ws(char c) {
  // the ASCII subset of what Python str.strip() removes (incl. the
  // \x1c-\x1f separator control chars, which are .isspace() in Python)
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v' || (c >= '\x1c' && c <= '\x1f');
}

// Mirrors str(raw).strip().lower() in ("1","true","yes","on").  Returns
// false (caller falls back to the Python parser) when the field holds
// non-ASCII bytes, where Python's strip()/lower() could diverge.
static bool parse_bool(const std::string& f, bool* out) {
  std::string t;
  t.reserve(f.size());
  size_t b = 0, e = f.size();
  while (b < e && is_strip_ws(f[b])) b++;
  while (e > b && is_strip_ws(f[e - 1])) e--;
  for (size_t i = b; i < e; i++) {
    char c = f[i];
    if ((unsigned char)c >= 0x80) return false;
    t.push_back(c >= 'A' && c <= 'Z' ? (char)(c + 32) : c);
  }
  *out = (t == "1" || t == "true" || t == "yes" || t == "on");
  return true;
}

}  // namespace csvn

// csv_cols(data, delimiter, quote, cols, codes, defaults)
//   -> (header_list, col_lists_tuple, n_rows, fallback[(idx, bytes)])
static PyObject* py_csv_cols(PyObject*, PyObject* args) {
  Py_buffer buf;
  int delim_i, quote_i;
  PyObject *cols, *codes_obj, *defaults;
  if (!PyArg_ParseTuple(args, "y*iiOOO", &buf, &delim_i, &quote_i, &cols,
                        &codes_obj, &defaults))
    return nullptr;
  const char delim = (char)delim_i, quote = (char)quote_i;
  PyObject* col_fast = PySequence_Fast(cols, "cols must be a sequence");
  PyObject* code_fast =
      col_fast ? PySequence_Fast(codes_obj, "codes must be a sequence")
               : nullptr;
  if (col_fast == nullptr || code_fast == nullptr) {
    Py_XDECREF(col_fast);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Py_ssize_t nc = PySequence_Fast_GET_SIZE(col_fast);
  std::vector<std::string> names((size_t)nc);
  std::vector<long> codes((size_t)nc);
  std::vector<PyObject*> defvals((size_t)nc);  // borrowed or nullptr
  bool arg_err = PySequence_Fast_GET_SIZE(code_fast) != nc ||
                 !PyDict_Check(defaults);
  for (Py_ssize_t j = 0; !arg_err && j < nc; j++) {
    PyObject* nm = PySequence_Fast_GET_ITEM(col_fast, j);
    Py_ssize_t sl;
    const char* s = PyUnicode_AsUTF8AndSize(nm, &sl);
    if (s == nullptr) { arg_err = true; break; }
    names[(size_t)j].assign(s, (size_t)sl);
    codes[(size_t)j] = PyLong_AsLong(PySequence_Fast_GET_ITEM(code_fast, j));
    defvals[(size_t)j] = PyDict_GetItem(defaults, nm);
  }
  if (arg_err) {
    Py_DECREF(col_fast);
    Py_DECREF(code_fast);
    PyBuffer_Release(&buf);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "bad cols/codes/defaults");
    return nullptr;
  }
  const char* p = reinterpret_cast<const char*>(buf.buf);
  const char* end = p + buf.len;

  // one record: fields split on delim outside quotes; doubled quotes
  // inside a quoted field unescape; returns false at EOF with no data
  std::vector<std::string> fields;
  auto read_record = [&](const char** cursor, const char** rec_start,
                         const char** rec_end) -> bool {
    const char* c = *cursor;
    if (c >= end) return false;
    *rec_start = c;
    fields.clear();
    std::string cur;
    bool in_quotes = false;
    bool any = false;
    // csv.reader opens a quoted section only when the quote is the very
    // first character of a field; any later quote is a literal char
    // (e.g. '5" disk,x' -> ['5" disk', 'x'], '"a"b"c,d' -> ['ab"c', 'd'])
    bool field_fresh = true;
    while (c < end) {
      char ch = *c;
      if (in_quotes) {
        if (ch == quote) {
          if (c + 1 < end && c[1] == quote) { cur.push_back(quote); c += 2; }
          else { in_quotes = false; c++; }
        } else { cur.push_back(ch); c++; }
      } else if (ch == quote) {
        if (field_fresh) in_quotes = true;
        else cur.push_back(quote);
        field_fresh = false;
        any = true;
        c++;
      } else if (ch == delim) {
        fields.push_back(cur);
        cur.clear();
        field_fresh = true;
        any = true;
        c++;
      } else if (ch == '\n' || ch == '\r') {
        const char* brk = c;
        if (ch == '\r' && c + 1 < end && c[1] == '\n') c += 2; else c++;
        if (!any && cur.empty() && fields.empty()) {
          // blank line: csv.reader yields [] and DictReader skips it
          *cursor = c;
          *rec_start = c;
          continue;
        }
        fields.push_back(cur);
        *rec_end = brk;
        *cursor = c;
        return true;
      } else {
        cur.push_back(ch);
        field_fresh = false;
        any = true;
        c++;
      }
    }
    if (!any && cur.empty() && fields.empty()) { *cursor = c; return false; }
    fields.push_back(cur);
    *rec_end = c;
    *cursor = c;
    return true;
  };

  const char* cursor = p;
  const char *rs, *re;
  PyObject* header = PyList_New(0);
  std::vector<Py_ssize_t> field_to_col;  // header position -> schema col
  bool mem_err = header == nullptr;
  if (!mem_err && read_record(&cursor, &rs, &re)) {
    for (const std::string& h : fields) {
      PyObject* hs = PyUnicode_DecodeUTF8(h.data(), (Py_ssize_t)h.size(),
                                          "replace");
      if (hs == nullptr || PyList_Append(header, hs) < 0) {
        Py_XDECREF(hs);
        mem_err = true;
        break;
      }
      Py_DECREF(hs);
      Py_ssize_t target = -1;
      for (Py_ssize_t j = 0; j < nc; j++) {
        if (names[(size_t)j] == h) { target = j; break; }
      }
      field_to_col.push_back(target);
    }
  }
  std::vector<PyObject*> col_out((size_t)nc, nullptr);
  PyObject* fallback = PyList_New(0);
  if (fallback == nullptr) mem_err = true;
  for (Py_ssize_t j = 0; !mem_err && j < nc; j++) {
    col_out[(size_t)j] = PyList_New(0);
    if (col_out[(size_t)j] == nullptr) mem_err = true;
  }
  // schema columns ABSENT from the header take defaults every row
  // (parse_record_fields absent-field semantics); header-mapped columns
  // missing from a SHORT row get None (DictReader's restval)
  std::vector<bool> col_in_header((size_t)nc, false);
  for (Py_ssize_t t : field_to_col) {
    if (t >= 0) col_in_header[(size_t)t] = true;
  }
  std::vector<PyObject*> rowvals((size_t)nc);
  Py_ssize_t n_rows = 0;
  while (!mem_err && read_record(&cursor, &rs, &re)) {
    for (Py_ssize_t j = 0; j < nc; j++) rowvals[(size_t)j] = nullptr;
    bool ok = true;
    for (size_t fi = 0; ok && fi < fields.size() && fi < field_to_col.size();
         fi++) {
      Py_ssize_t target = field_to_col[fi];
      if (target < 0) continue;
      const std::string& f = fields[fi];
      long code = codes[(size_t)target];
      PyObject* outv = nullptr;
      switch (code) {
        case 1: {
          long long v;
          if (csvn::parse_int(f, &v)) outv = PyLong_FromLongLong(v);
          break;
        }
        case 2: {
          double v;
          if (csvn::parse_float(f, &v)) outv = PyFloat_FromDouble(v);
          break;
        }
        case 3: {
          bool v;
          if (csvn::parse_bool(f, &v)) {
            outv = v ? Py_True : Py_False;
            Py_INCREF(outv);
          }
          break;
        }
        case 4:
        case 6:
          outv = PyUnicode_DecodeUTF8(f.data(), (Py_ssize_t)f.size(),
                                      "replace");
          break;
        default:
          break;  // bytes/json/datetime/containers -> python fallback
      }
      if (outv == nullptr) {
        if (PyErr_Occurred()) PyErr_Clear();
        ok = false;
        break;
      }
      Py_XDECREF(rowvals[(size_t)target]);
      rowvals[(size_t)target] = outv;
    }
    if (ok) {
      for (Py_ssize_t j = 0; j < nc && !mem_err; j++) {
        PyObject* outv = rowvals[(size_t)j];
        if (outv == nullptr) {
          if (!col_in_header[(size_t)j] && defvals[(size_t)j] != nullptr) {
            outv = defvals[(size_t)j];  // absent column -> schema default
          } else {
            outv = Py_None;  // short row (restval) or absent w/o default
          }
          Py_INCREF(outv);
        }
        if (PyList_Append(col_out[(size_t)j], outv) < 0) mem_err = true;
        Py_DECREF(outv);
        rowvals[(size_t)j] = nullptr;
      }
      for (Py_ssize_t j = 0; j < nc; j++) {
        Py_XDECREF(rowvals[(size_t)j]);
        rowvals[(size_t)j] = nullptr;
      }
      n_rows++;
    } else {
      for (Py_ssize_t j = 0; j < nc; j++) {
        Py_XDECREF(rowvals[(size_t)j]);
        rowvals[(size_t)j] = nullptr;
      }
      PyObject* entry = Py_BuildValue("(ny#)", n_rows, rs,
                                      (Py_ssize_t)(re - rs));
      if (entry == nullptr || PyList_Append(fallback, entry) < 0) {
        Py_XDECREF(entry);
        mem_err = true;
      } else {
        Py_DECREF(entry);
        for (Py_ssize_t j = 0; j < nc && !mem_err; j++) {
          if (PyList_Append(col_out[(size_t)j], Py_None) < 0) mem_err = true;
        }
        n_rows++;
      }
    }
  }
  Py_DECREF(col_fast);
  Py_DECREF(code_fast);
  PyBuffer_Release(&buf);
  if (mem_err) {
    Py_XDECREF(header);
    Py_XDECREF(fallback);
    for (PyObject* cl : col_out) Py_XDECREF(cl);
    return nullptr;
  }
  PyObject* cols_tuple = PyTuple_New(nc);
  if (cols_tuple == nullptr) {
    Py_XDECREF(header);
    Py_XDECREF(fallback);
    for (PyObject* cl : col_out) Py_XDECREF(cl);
    return nullptr;
  }
  for (Py_ssize_t j = 0; j < nc; j++) {
    PyTuple_SET_ITEM(cols_tuple, j, col_out[(size_t)j]);  // steals ref
  }
  return Py_BuildValue("(NNnN)", header, cols_tuple, n_rows, fallback);
}

static PyObject* py_set_pointer_type(PyObject*, PyObject* args) {
  PyObject* t;
  if (!PyArg_ParseTuple(args, "O", &t)) return nullptr;
  Py_XINCREF(t);
  Py_XDECREF(g_pointer_type);
  g_pointer_type = t;
  Py_RETURN_NONE;
}

// batch_rows_split(rows, ncols, keys_u64_buf, diffs_i64_buf)
//   rows: list of (key:int, row:tuple, diff:int). Fills the key/diff
//   buffers and returns a tuple of ncols value lists — the SoA transpose
//   behind Batch.from_rows, one C pass instead of n*ncols Python steps.
static PyObject* py_batch_rows_split(PyObject*, PyObject* args) {
  PyObject* rows;
  Py_ssize_t ncols;
  Py_buffer keys_buf, diffs_buf;
  if (!PyArg_ParseTuple(args, "Onw*w*", &rows, &ncols, &keys_buf,
                        &diffs_buf))
    return nullptr;
  PyObject* fast = PySequence_Fast(rows, "rows must be a sequence");
  if (fast == nullptr) {
    PyBuffer_Release(&keys_buf);
    PyBuffer_Release(&diffs_buf);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  bool fail = false;
  if ((Py_ssize_t)keys_buf.len < n * 8 ||
      (Py_ssize_t)diffs_buf.len < n * 8) {
    PyErr_SetString(PyExc_ValueError, "key/diff buffer too small");
    fail = true;
  }
  uint64_t* keys = reinterpret_cast<uint64_t*>(keys_buf.buf);
  int64_t* diffs = reinterpret_cast<int64_t*>(diffs_buf.buf);
  PyObject* cols = fail ? nullptr : PyTuple_New(ncols);
  if (cols == nullptr) fail = true;
  for (Py_ssize_t j = 0; !fail && j < ncols; j++) {
    PyObject* lst = PyList_New(n);
    if (lst == nullptr) { fail = true; break; }
    PyTuple_SET_ITEM(cols, j, lst);
  }
  for (Py_ssize_t i = 0; !fail && i < n; i++) {
    PyObject* triple = PySequence_Fast_GET_ITEM(fast, i);
    if (!PyTuple_Check(triple) || PyTuple_GET_SIZE(triple) != 3) {
      PyErr_SetString(PyExc_TypeError, "row entry must be (key, row, diff)");
      fail = true;
      break;
    }
    PyObject* key = PyTuple_GET_ITEM(triple, 0);
    PyObject* row = PyTuple_GET_ITEM(triple, 1);
    PyObject* diff = PyTuple_GET_ITEM(triple, 2);
    keys[i] = PyLong_AsUnsignedLongLongMask(key);
    int64_t d = PyLong_AsLongLong(diff);
    if (PyErr_Occurred()) { fail = true; break; }
    diffs[i] = d;
    if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) != ncols) {
      PyErr_SetString(PyExc_TypeError, "row tuple arity mismatch");
      fail = true;
      break;
    }
    for (Py_ssize_t j = 0; j < ncols; j++) {
      PyObject* v = PyTuple_GET_ITEM(row, j);
      Py_INCREF(v);
      PyList_SET_ITEM(PyTuple_GET_ITEM(cols, j), i, v);
    }
  }
  Py_DECREF(fast);
  PyBuffer_Release(&keys_buf);
  PyBuffer_Release(&diffs_buf);
  if (fail) {
    Py_XDECREF(cols);
    return nullptr;
  }
  return cols;
}


// ---------------------------------------------------------------- join emit
// join_ld_cross(works, sides, idxs)
// splitmix64 rehash with salt — must match value.py hash_keys_with.
static inline uint64_t splitmix_salt(uint64_t x, uint64_t salt) {
  x += salt;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

static const uint64_t kSeqSalt = 0x9E3779B97F4A7C15ULL;  // value.py _SEQ_SALT
static const uint64_t kColPrime = 0x100000001B3ULL;

// xxh64 of the canonical serialization of one value (the per-element body
// of hash_object_column). Returns false when the value can't be
// canonically serialized in C (exotic types) — callers raise.
static bool hash_value_u64(PyObject* v, std::string& scratch, uint64_t* out) {
  scratch.clear();
  try {
    if (!serialize(v, scratch)) return false;
  } catch (SerializeError&) {
    PyErr_Clear();
    return false;
  }
  *out = xxh64(reinterpret_cast<const uint8_t*>(scratch.data()),
               scratch.size(), 0);
  return true;
}

//   works: list of (ld, rbucket) where ld = [(key, row, diff), ...] and
//          rbucket = {rkey: rrow}; rows are tuples. diff (+/-1) is the
//          emission weight: a retracted left row crossed against the
//          bucket emits its pairs with diff -1 (the weighted bilinear
//          delta — mixed insert/retract streams ride the same path).
//   sides: bytes, one per output column, 1 = from lrow else rrow.
//   idxs:  list of ints, source position within that row.
// One call per engine step covers every fast-path join key: emits the
// dL x R cross product COLUMNAR — (col_lists, out_keys_u64_bytes,
// diffs_i64_bytes) — with the pair output keys (Key::for_values(lk,
// rk), matching value.py keys_for_value_columns) hashed inline. The
// caller wraps the columns + key/diff buffers straight into a Batch:
// no row tuples, no re-split, no second hashing pass.
static PyObject* py_join_ld_cross(PyObject*, PyObject* args) {
  PyObject *works, *sides_obj, *idxs_obj;
  if (!PyArg_ParseTuple(args, "OSO", &works, &sides_obj, &idxs_obj))
    return nullptr;
  const char* sides = PyBytes_AS_STRING(sides_obj);
  Py_ssize_t ncols = PyBytes_GET_SIZE(sides_obj);
  PyObject* idx_fast = PySequence_Fast(idxs_obj, "idxs must be a sequence");
  if (idx_fast == nullptr) return nullptr;
  if (PySequence_Fast_GET_SIZE(idx_fast) != ncols) {
    Py_DECREF(idx_fast);
    PyErr_SetString(PyExc_ValueError, "sides/idxs length mismatch");
    return nullptr;
  }
  std::vector<Py_ssize_t> idxs((size_t)ncols);
  for (Py_ssize_t j = 0; j < ncols; j++) {
    idxs[(size_t)j] =
        PyLong_AsSsize_t(PySequence_Fast_GET_ITEM(idx_fast, j));
    if (idxs[(size_t)j] < 0) {  // conversion error OR a negative index —
      // both invalid (unchecked GET_ITEM macros below must never see <0)
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "idxs must be non-negative");
      Py_DECREF(idx_fast);
      return nullptr;
    }
  }
  PyObject* works_fast = PySequence_Fast(works, "works must be a sequence");
  if (works_fast == nullptr) {
    Py_DECREF(idx_fast);
    return nullptr;
  }
  Py_ssize_t nwork = PySequence_Fast_GET_SIZE(works_fast);
  // total pair count up front (lens only) so the key buffer and column
  // lists are allocated exactly once
  Py_ssize_t total = 0;
  bool fail = false;
  for (Py_ssize_t w = 0; !fail && w < nwork; w++) {
    PyObject* pair = PySequence_Fast_GET_ITEM(works_fast, w);
    if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) < 2 ||
        !PyDict_Check(PyTuple_GET_ITEM(pair, 1))) {
      PyErr_SetString(PyExc_TypeError,
                      "work item must be (delta, bucket[, swapped])");
      fail = true;
      break;
    }
    Py_ssize_t nld = PySequence_Size(PyTuple_GET_ITEM(pair, 0));
    if (nld < 0) { fail = true; break; }
    total += nld * PyDict_GET_SIZE(PyTuple_GET_ITEM(pair, 1));
  }
  PyObject* keys_buf =
      fail ? nullptr : PyByteArray_FromStringAndSize(nullptr, total * 8);
  PyObject* diffs_buf =
      fail ? nullptr : PyByteArray_FromStringAndSize(nullptr, total * 8);
  PyObject* cols = fail || keys_buf == nullptr || diffs_buf == nullptr
                       ? nullptr
                       : PyTuple_New(ncols);
  fail = fail || keys_buf == nullptr || diffs_buf == nullptr ||
         cols == nullptr;
  for (Py_ssize_t j = 0; !fail && j < ncols; j++) {
    PyObject* lst = PyList_New(total);
    if (lst == nullptr) { fail = true; break; }
    PyTuple_SET_ITEM(cols, j, lst);
  }
  uint64_t* keys_out =
      fail ? nullptr
           : reinterpret_cast<uint64_t*>(PyByteArray_AS_STRING(keys_buf));
  int64_t* diffs_out =
      fail ? nullptr
           : reinterpret_cast<int64_t*>(PyByteArray_AS_STRING(diffs_buf));
  std::string scratch;
  std::vector<uint64_t> rk_hash;  // per-work rbucket hashes (reused rows)
  Py_ssize_t outpos = 0;
  for (Py_ssize_t w = 0; !fail && w < nwork; w++) {
    PyObject* pair = PySequence_Fast_GET_ITEM(works_fast, w);
    PyObject* ld = PyTuple_GET_ITEM(pair, 0);
    PyObject* rbucket = PyTuple_GET_ITEM(pair, 1);
    // swapped: the delta is the RIGHT side crossed against a LEFT
    // bucket (L x dR term) — output-column sourcing and the two key-
    // hash salts flip, everything else is symmetric
    int swapped = 0;
    if (PyTuple_GET_SIZE(pair) >= 3) {
      swapped = PyObject_IsTrue(PyTuple_GET_ITEM(pair, 2));
      if (swapped < 0) { fail = true; break; }
    }
    PyObject* ld_fast = PySequence_Fast(ld, "ld must be a sequence");
    if (ld_fast == nullptr) { fail = true; break; }
    Py_ssize_t nld = PySequence_Fast_GET_SIZE(ld_fast);
    Py_ssize_t nrb = PyDict_GET_SIZE(rbucket);
    // hash each bucket key once per work item (shared across delta rows);
    // the left-position hash carries the column-combine prime so the pair
    // key is a plain XOR either way
    rk_hash.resize((size_t)nrb);
    {
      PyObject *rk, *rrow;
      Py_ssize_t pos = 0, ri = 0;
      while (PyDict_Next(rbucket, &pos, &rk, &rrow)) {
        uint64_t h;
        if (!hash_value_u64(rk, scratch, &h)) {
          PyErr_SetString(PyExc_TypeError, "unhashable join row key");
          fail = true;
          break;
        }
        rk_hash[(size_t)ri++] =
            swapped ? splitmix_salt(h, kSeqSalt) * kColPrime
                    : splitmix_salt(h, kSeqSalt * 2);
      }
    }
    for (Py_ssize_t i = 0; !fail && i < nld; i++) {
      PyObject* entry = PySequence_Fast_GET_ITEM(ld_fast, i);
      if (!PyTuple_Check(entry) || PyTuple_GET_SIZE(entry) < 2 ||
          !PyTuple_Check(PyTuple_GET_ITEM(entry, 1))) {
        PyErr_SetString(PyExc_TypeError, "ld entry must be (key, row, diff)");
        fail = true;
        break;
      }
      PyObject* lk = PyTuple_GET_ITEM(entry, 0);
      PyObject* lrow = PyTuple_GET_ITEM(entry, 1);
      long long weight = 1;
      if (PyTuple_GET_SIZE(entry) >= 3) {
        weight = PyLong_AsLongLong(PyTuple_GET_ITEM(entry, 2));
        if (PyErr_Occurred()) { fail = true; break; }
      }
      uint64_t lh;
      if (!hash_value_u64(lk, scratch, &lh)) {
        PyErr_SetString(PyExc_TypeError, "unhashable join row key");
        fail = true;
        break;
      }
      lh = swapped ? splitmix_salt(lh, kSeqSalt * 2)
                   : splitmix_salt(lh, kSeqSalt) * kColPrime;
      PyObject *rk, *rrow;
      Py_ssize_t pos = 0, ri = 0;
      while (!fail && PyDict_Next(rbucket, &pos, &rk, &rrow)) {
        if (!PyTuple_Check(rrow)) {
          PyErr_SetString(PyExc_TypeError, "rrow must be a tuple");
          fail = true;
          break;
        }
        for (Py_ssize_t j = 0; j < ncols; j++) {
          PyObject* src = ((sides[j] != 0) != (swapped != 0)) ? lrow : rrow;
          Py_ssize_t k = idxs[(size_t)j];
          if (k >= PyTuple_GET_SIZE(src)) {
            PyErr_SetString(PyExc_IndexError, "row index out of range");
            fail = true;
            break;
          }
          PyObject* v = PyTuple_GET_ITEM(src, k);
          Py_INCREF(v);
          PyList_SET_ITEM(PyTuple_GET_ITEM(cols, j), outpos, v);
        }
        if (fail) break;
        keys_out[outpos] = lh ^ rk_hash[(size_t)ri++];
        diffs_out[outpos] = (int64_t)weight;
        outpos++;
      }
    }
    Py_DECREF(ld_fast);
  }
  Py_DECREF(works_fast);
  Py_DECREF(idx_fast);
  if (!fail && outpos != total) {
    PyErr_SetString(PyExc_RuntimeError, "join cross emitted short");
    fail = true;
  }
  if (fail) {
    Py_XDECREF(keys_buf);
    Py_XDECREF(diffs_buf);
    Py_XDECREF(cols);
    return nullptr;
  }
  PyObject* result = PyTuple_Pack(3, cols, keys_buf, diffs_buf);
  Py_DECREF(cols);
  Py_DECREF(keys_buf);
  Py_DECREF(diffs_buf);
  return result;
}

// Ensure deltas[jk] exists and return it (borrowed); nullptr on error.
static PyObject* join_delta_list(PyObject* deltas, PyObject* jk) {
  PyObject* dl = PyDict_GetItemWithError(deltas, jk);  // borrowed
  if (dl == nullptr) {
    if (PyErr_Occurred()) return nullptr;
    dl = PyList_New(0);
    if (dl == nullptr || PyDict_SetItem(deltas, jk, dl) < 0) {
      Py_XDECREF(dl);
      return nullptr;
    }
    Py_DECREF(dl);  // deltas holds it; borrowed ref stays valid
  }
  return dl;
}

// undo[jk].append((key, old_row_or_None)) — the per-mutation undo log the
// recompute path replays in reverse to reconstruct pre-batch buckets
// (replacing the old always-materialized emitted-pairs cache).
static int join_log_undo(PyObject* undo, PyObject* jk, PyObject* key,
                         PyObject* old) {
  PyObject* lst = join_delta_list(undo, jk);  // borrowed ensure-list
  if (lst == nullptr) return -1;
  PyObject* pairt = PyTuple_Pack(2, key, old ? old : Py_None);
  if (pairt == nullptr) return -1;
  int rc = PyList_Append(lst, pairt);
  Py_DECREF(pairt);
  return rc;
}

// Remove `key` from state[jk]'s bucket (dropping an emptied bucket),
// logging the removed row to the undo log. Returns 0 ok, -1 error.
static int join_evict(PyObject* state, PyObject* jk, PyObject* key,
                      PyObject* undo) {
  PyObject* bucket = PyDict_GetItemWithError(state, jk);  // borrowed
  if (bucket == nullptr) return PyErr_Occurred() ? -1 : 0;
  PyObject* old = PyDict_GetItemWithError(bucket, key);  // borrowed
  if (old == nullptr) return PyErr_Occurred() ? -1 : 0;
  if (join_log_undo(undo, jk, key, old) < 0) return -1;
  if (PyDict_DelItem(bucket, key) < 0) return -1;
  if (PyDict_GET_SIZE(bucket) == 0 && PyDict_DelItem(state, jk) < 0)
    return -1;
  return 0;
}

// join_apply_side(state, key2jk, keys, diffs, col_lists, jk_idx,
//                 error_sentinel)
//   state: dict jk -> {rowkey: rowtuple}; key2jk: dict rowkey -> its
//   current jk (stale-bucket eviction for key-changing raw
//   re-deliveries); keys/diffs: lists; col_lists: tuple of per-column
//   value lists (the SoA batch); jk_idx: which column is the (single)
//   join key. Builds each row tuple once, applies the delta to the
//   bucket state, and groups deltas per jk — the whole Python
//   _side_deltas pass in one C loop. Every bucket mutation is logged to
//   an undo dict (jk -> [(key, old_row|None), ...]) so the recompute
//   path can rebuild pre-batch buckets. Returns (deltas_dict,
//   dirty_list, undo_dict, n_errors).
static PyObject* py_join_apply_side(PyObject*, PyObject* args) {
  PyObject *state, *key2jk, *keys, *diffs, *col_lists, *sentinel;
  Py_ssize_t jk_idx;
  if (!PyArg_ParseTuple(args, "O!O!OOO!nO", &PyDict_Type, &state,
                        &PyDict_Type, &key2jk, &keys, &diffs,
                        &PyTuple_Type, &col_lists, &jk_idx, &sentinel))
    return nullptr;
  PyObject* keys_fast = PySequence_Fast(keys, "keys");
  PyObject* diffs_fast = PySequence_Fast(diffs, "diffs");
  if (keys_fast == nullptr || diffs_fast == nullptr) {
    Py_XDECREF(keys_fast);
    Py_XDECREF(diffs_fast);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(keys_fast);
  Py_ssize_t ncols = PyTuple_GET_SIZE(col_lists);
  std::vector<PyObject**> col_items((size_t)ncols);
  bool fail = PySequence_Fast_GET_SIZE(diffs_fast) != n || jk_idx < 0 ||
              jk_idx >= ncols;
  if (fail) PyErr_SetString(PyExc_ValueError, "bad apply_side arguments");
  for (Py_ssize_t j = 0; !fail && j < ncols; j++) {
    PyObject* col = PyTuple_GET_ITEM(col_lists, j);
    if (!PyList_Check(col) || PyList_GET_SIZE(col) != n) {
      PyErr_SetString(PyExc_TypeError, "columns must be n-length lists");
      fail = true;
      break;
    }
    col_items[(size_t)j] = ((PyListObject*)col)->ob_item;
  }
  PyObject* deltas = fail ? nullptr : PyDict_New();
  PyObject* dirty = fail ? nullptr : PyList_New(0);
  PyObject* undo = fail ? nullptr : PyDict_New();
  Py_ssize_t n_err = 0;
  if (deltas == nullptr || dirty == nullptr || undo == nullptr) fail = true;
  for (Py_ssize_t i = 0; !fail && i < n; i++) {
    PyObject* jk = col_items[(size_t)jk_idx][i];
    if (jk == sentinel) { n_err++; continue; }
    PyObject* key = PySequence_Fast_GET_ITEM(keys_fast, i);
    long long d = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(diffs_fast, i));
    if (PyErr_Occurred()) { fail = true; break; }
    PyObject* row = PyTuple_New(ncols);
    if (row == nullptr) { fail = true; break; }
    for (Py_ssize_t j = 0; j < ncols; j++) {
      PyObject* v = col_items[(size_t)j][i];
      Py_INCREF(v);
      PyTuple_SET_ITEM(row, j, v);
    }
    PyObject* old = PyDict_GetItemWithError(key2jk, key);  // borrowed
    if (old == nullptr && PyErr_Occurred()) {
      Py_DECREF(row);
      fail = true;
      break;
    }
    int moved = 0;  // row key is live under a DIFFERENT jk
    if (old != nullptr && old != jk) {
      moved = PyObject_RichCompareBool(old, jk, Py_EQ);
      if (moved < 0) { Py_DECREF(row); fail = true; break; }
      moved = !moved;
    }
    // which deltas[...] list this triple lands in: the delivered jk for
    // inserts, the row's ACTUAL bucket for retractions (a retraction
    // carrying a stale join key must drain from where the row lives)
    PyObject* grp;
    if (d > 0) {
      if (moved) {
        // key-changing raw re-delivery: evict the stale row and mark
        // the old bucket for recompute (its pairs must retract)
        if (join_evict(state, old, key, undo) < 0 ||
            PyList_Append(dirty, old) < 0 ||
            join_delta_list(deltas, old) == nullptr) {
          Py_DECREF(row);
          fail = true;
          break;
        }
      }
      grp = jk;
      Py_INCREF(grp);
      PyObject* bucket = PyDict_GetItemWithError(state, jk);  // borrowed
      if (bucket == nullptr && PyErr_Occurred()) {
        Py_DECREF(grp);
        Py_DECREF(row);
        fail = true;
        break;
      }
      PyObject* prev = nullptr;  // row stored under this key pre-insert
      if (bucket == nullptr) {
        bucket = PyDict_New();
        if (bucket == nullptr ||
            PyDict_SetItem(state, jk, bucket) < 0) {
          Py_XDECREF(bucket);
          Py_DECREF(grp);
          Py_DECREF(row);
          fail = true;
          break;
        }
        Py_DECREF(bucket);  // state holds it; borrowed ref stays valid
      } else {
        prev = PyDict_GetItemWithError(bucket, key);  // borrowed
        if (prev == nullptr && PyErr_Occurred()) {
          Py_DECREF(grp);
          Py_DECREF(row);
          fail = true;
          break;
        }
        // upsert-style re-delivery of a row key: recompute path
        if (prev != nullptr && PyList_Append(dirty, jk) < 0) {
          Py_DECREF(grp);
          Py_DECREF(row);
          fail = true;
          break;
        }
      }
      if (join_log_undo(undo, jk, key, prev) < 0 ||
          PyDict_SetItem(bucket, key, row) < 0 ||
          PyDict_SetItem(key2jk, key, jk) < 0) {
        Py_DECREF(grp);
        Py_DECREF(row);
        fail = true;
        break;
      }
    } else {
      grp = old != nullptr ? old : jk;
      Py_INCREF(grp);  // must survive the key2jk delete below
      if (old != nullptr && PyDict_DelItem(key2jk, key) < 0) {
        Py_DECREF(grp);
        Py_DECREF(row);
        fail = true;
        break;
      }
      if (join_evict(state, grp, key, undo) < 0 ||
          (moved && PyList_Append(dirty, grp) < 0)) {
        Py_DECREF(grp);
        Py_DECREF(row);
        fail = true;
        break;
      }
    }
    // deltas[grp].append((key, row, diff))
    PyObject* dl = join_delta_list(deltas, grp);
    if (dl == nullptr) {
      Py_DECREF(grp);
      Py_DECREF(row);
      fail = true;
      break;
    }
    PyObject* triple = PyTuple_New(3);
    if (triple == nullptr) {
      Py_DECREF(grp);
      Py_DECREF(row);
      fail = true;
      break;
    }
    Py_INCREF(key);
    PyTuple_SET_ITEM(triple, 0, key);
    PyTuple_SET_ITEM(triple, 1, row);  // steals the row ref
    PyObject* dobj = PyLong_FromLongLong(d);
    if (dobj == nullptr) {
      Py_DECREF(grp);
      Py_DECREF(triple);
      fail = true;
      break;
    }
    PyTuple_SET_ITEM(triple, 2, dobj);
    if (PyList_Append(dl, triple) < 0) fail = true;
    Py_DECREF(triple);
    Py_DECREF(grp);
  }
  Py_DECREF(keys_fast);
  Py_DECREF(diffs_fast);
  if (fail) {
    Py_XDECREF(deltas);
    Py_XDECREF(dirty);
    Py_XDECREF(undo);
    return nullptr;
  }
  PyObject* nerr = PyLong_FromSsize_t(n_err);
  PyObject* out =
      nerr ? PyTuple_Pack(4, deltas, dirty, undo, nerr) : nullptr;
  Py_DECREF(deltas);
  Py_DECREF(dirty);
  Py_DECREF(undo);
  Py_XDECREF(nerr);
  return out;
}

static PyMethodDef methods[] = {
    {"join_apply_side", py_join_apply_side, METH_VARARGS,
     "apply one side's columnar batch to join bucket state"},
    {"join_ld_cross", py_join_ld_cross, METH_VARARGS,
     "emit dL x R cross products columnar with hashed pair output keys"},
    {"hash_object_column", py_hash_object_column, METH_VARARGS,
     "hash a sequence of values into an n*8-byte output buffer; returns "
     "indices needing python fallback"},
    {"xxh64_digest", py_xxh64, METH_VARARGS, "xxh64 of a bytes-like"},
    {"consolidate_pairs", py_consolidate_pairs, METH_VARARGS,
     "group (key,row_hash) deltas, sum diffs, drop zeros"},
    {"batch_rows_split", py_batch_rows_split, METH_VARARGS,
     "SoA transpose of (key, row, diff) triples"},
    {"rows_from_records", py_rows_from_records, METH_VARARGS,
     "batch record-dict -> row-tuple extraction with fast coercions"},
    {"jsonl_rows", py_jsonl_rows, METH_VARARGS,
     "one-pass jsonlines bytes -> row tuples with schema coercion"},
    {"csv_cols", py_csv_cols, METH_VARARGS,
     "one-pass CSV bytes -> per-column value lists with schema coercion"},
    {"split_lines", py_split_lines, METH_VARARGS,
     "newline tokenizer returning (start,end) offset pairs"},
    {"set_pointer_type", py_set_pointer_type, METH_VARARGS,
     "register the engine Pointer type"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_engine",
    "the port's engine host loops (hashing, consolidation, row extraction, "
    "CSV and line parsing, joins)",
    -1, methods};

PyMODINIT_FUNC PyInit__engine(void) { return PyModule_Create(&moduledef); }
