// pathway_tpu_torch native tokenizers — CPython extension.
//
// The batch inner loops of the port's host tokenizers
// (models/tokenizer.py): HashTokenizer's FNV-1a word hashing and BERT
// WordPiece (basic tokenization + greedy longest-match) over a registry of
// loaded vocabularies. ASCII rows are tokenized here; rows with non-ASCII
// bytes come back as fallback indices and re-tokenize in Python, because
// Unicode case folding and NFD accent stripping are part of the semantics.
// Built with g++ at first use by native/__init__.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

// hash_tokenize(texts, max_length, reserved, span)
//   -> (ids_bytearray, width, fallback_indices)
// The HashTokenizer hot loop (models/tokenizer.py): per text emit
// [CLS] word-ids [SEP] where word-id = reserved + fnv1a(word) % span, words
// are maximal [a-z0-9]+ runs of the ASCII-lowercased text, truncated so
// len(ids) <= max_length. Output is an n*width int32 LE row-major matrix,
// 0-padded (PAD id is 0 and every real id is > 0, so the attention mask is
// simply ids != 0). Texts containing non-ASCII bytes are listed in
// fallback_indices with a bare [CLS][SEP] row: Python's str.lower() does
// Unicode case folding (U+212A KELVIN SIGN -> 'k' etc.) that a byte scan
// cannot reproduce, so those rows re-tokenize on the Python path to keep
// native and fallback ids identical for every input.
static PyObject* py_hash_tokenize(PyObject*, PyObject* args) {
  PyObject* seq;
  long max_length, reserved;
  unsigned long long span;
  if (!PyArg_ParseTuple(args, "OllK", &seq, &max_length, &reserved, &span))
    return nullptr;
  if (span == 0) {
    PyErr_SetString(PyExc_ValueError, "span must be positive");
    return nullptr;
  }
  PyObject* fast = PySequence_Fast(seq, "expected a sequence of strings");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  std::vector<int32_t> flat;
  flat.reserve((size_t)n * 16);
  std::vector<uint32_t> lens((size_t)n);
  size_t width = 2;
  PyObject* fallback = PyList_New(0);
  if (fallback == nullptr) {
    Py_DECREF(fast);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_ssize_t slen;
    const char* s = PyUnicode_AsUTF8AndSize(items[i], &slen);
    if (s == nullptr) {
      Py_DECREF(fast);
      Py_DECREF(fallback);
      return nullptr;  // non-string: caller falls back to the Python path
    }
    bool ascii = true;
    for (Py_ssize_t j = 0; j < slen; j++) {
      if ((unsigned char)s[j] >= 0x80) {
        ascii = false;
        break;
      }
    }
    size_t row_start = flat.size();
    flat.push_back(101);  // [CLS]
    long count = 1;
    if (!ascii) {
      PyObject* idx = PyLong_FromSsize_t(i);
      if (idx == nullptr || PyList_Append(fallback, idx) < 0) {
        Py_XDECREF(idx);
        Py_DECREF(fast);
        Py_DECREF(fallback);
        return nullptr;
      }
      Py_DECREF(idx);
    } else {
      size_t j = 0;
      while (j < (size_t)slen && count < max_length - 1) {
        unsigned char c = (unsigned char)s[j];
        unsigned char lc = (c >= 'A' && c <= 'Z') ? (unsigned char)(c + 32) : c;
        bool is_word = (lc >= 'a' && lc <= 'z') || (lc >= '0' && lc <= '9');
        if (!is_word) {
          j++;
          continue;
        }
        uint64_t h = 0xCBF29CE484222325ULL;
        while (j < (size_t)slen) {
          c = (unsigned char)s[j];
          lc = (c >= 'A' && c <= 'Z') ? (unsigned char)(c + 32) : c;
          if (!((lc >= 'a' && lc <= 'z') || (lc >= '0' && lc <= '9'))) break;
          h ^= (uint64_t)lc;
          h = (h * 0x100000001B3ULL) & 0xFFFFFFFFFFFFFFFFULL;
          j++;
        }
        flat.push_back((int32_t)(reserved + (long)(h % span)));
        count++;
      }
    }
    flat.push_back(102);  // [SEP]
    count++;
    lens[(size_t)i] = (uint32_t)(flat.size() - row_start);
    if ((size_t)count > width) width = (size_t)count;
  }
  Py_DECREF(fast);
  PyObject* out = PyByteArray_FromStringAndSize(nullptr, (Py_ssize_t)(n * width * 4));
  if (out == nullptr) {
    Py_DECREF(fallback);
    return nullptr;
  }
  int32_t* dst = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(out));
  std::memset(dst, 0, (size_t)n * width * 4);
  size_t pos = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    std::memcpy(dst + (size_t)i * width, flat.data() + pos,
                (size_t)lens[(size_t)i] * 4);
    pos += lens[(size_t)i];
  }
  return Py_BuildValue("(NnN)", out, (Py_ssize_t)width, fallback);
}

// ------------------------------------------------------------- WordPiece
// BERT's tokenizer (BasicTokenizer + WordPiece greedy longest-match) as a
// native batch loop. ASCII rows are handled here; rows with non-ASCII bytes
// are returned as fallback indices for the Python path (Unicode NFD accent
// stripping / case folding). Parity with transformers.BertTokenizer is
// pinned by test.

#include <deque>
#include <string_view>
#include <unordered_map>

// greedy longest-match probes are substrings of the word buffer, looked
// up as string_views with no per-probe allocation. The maps are keyed on
// string_view directly — backed by owned strings with stable addresses —
// rather than relying on C++20 heterogeneous unordered lookup (P0919),
// which libstdc++ only ships from GCC 11.
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view s) const noexcept {
    return std::hash<std::string_view>{}(s);
  }
};

using WpMap =
    std::unordered_map<std::string_view, int32_t, SvHash, std::equal_to<>>;

struct WordPieceVocab {
  // deque: push_back never moves earlier elements, so the map's views
  // into these strings stay valid as the vocab grows
  std::deque<std::string> storage;
  // word_start also answers single-char punctuation lookups (a 1-char
  // token can never start with "##")
  WpMap word_start;   // tokens NOT starting with "##"
  WpMap word_suffix;  // tokens starting with "##", stored WITHOUT the "##"
};
static std::vector<WordPieceVocab*> g_wp_vocabs;

// wordpiece_load(tokens) -> handle
static PyObject* py_wordpiece_load(PyObject*, PyObject* args) {
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "O", &seq)) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "expected a sequence of strings");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  auto* vocab = new WordPieceVocab();
  vocab->word_start.reserve((size_t)n);
  vocab->word_suffix.reserve((size_t)n);
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_ssize_t slen;
    const char* s = PyUnicode_AsUTF8AndSize(items[i], &slen);
    if (s == nullptr) {
      delete vocab;
      Py_DECREF(fast);
      return nullptr;
    }
    // assignment (not emplace): duplicate tokens keep the LAST id, matching
    // dict comprehension / HF vocab-load semantics
    vocab->storage.emplace_back(s, (size_t)slen);
    std::string_view tok(vocab->storage.back());
    if (slen >= 2 && s[0] == '#' && s[1] == '#') {
      vocab->word_suffix[tok.substr(2)] = (int32_t)i;
    } else {
      vocab->word_start[tok] = (int32_t)i;
    }
  }
  Py_DECREF(fast);
  // reuse a freed slot before growing the registry
  for (size_t h = 0; h < g_wp_vocabs.size(); h++) {
    if (g_wp_vocabs[h] == nullptr) {
      g_wp_vocabs[h] = vocab;
      return PyLong_FromSsize_t((Py_ssize_t)h);
    }
  }
  g_wp_vocabs.push_back(vocab);
  return PyLong_FromSsize_t((Py_ssize_t)g_wp_vocabs.size() - 1);
}

// wordpiece_free(handle): release a vocab registered by wordpiece_load
static PyObject* py_wordpiece_free(PyObject*, PyObject* args) {
  Py_ssize_t handle;
  if (!PyArg_ParseTuple(args, "n", &handle)) return nullptr;
  if (handle >= 0 && (size_t)handle < g_wp_vocabs.size()) {
    delete g_wp_vocabs[(size_t)handle];
    g_wp_vocabs[(size_t)handle] = nullptr;
  }
  Py_RETURN_NONE;
}

static inline bool wp_is_punct(unsigned char c) {
  // BERT _is_punctuation ASCII ranges
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// greedy longest-match of one lowercased ASCII word into piece ids;
// probes are string_views into the word buffer — no allocations
static void wp_word(const WordPieceVocab& v, const std::string& w,
                    int32_t unk_id, std::vector<int32_t>& out) {
  if (w.size() > 200) {  // BERT max_input_chars_per_word
    out.push_back(unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < w.size()) {
    const WpMap& m = start ? v.word_suffix : v.word_start;
    size_t end = w.size();
    int32_t id = -1;
    while (end > start) {
      auto it = m.find(std::string_view(w.data() + start, end - start));
      if (it != m.end()) {
        id = it->second;
        break;
      }
      end--;
    }
    if (id < 0) {  // whole word becomes [UNK]
      out.push_back(unk_id);
      return;
    }
    pieces.push_back(id);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

// wordpiece_tokenize(handle, texts, max_length, cls_id, sep_id, unk_id,
//                    pad_id) -> (ids_bytearray, width, lens_bytearray,
//                                fallback_indices)
static PyObject* py_wordpiece_tokenize(PyObject*, PyObject* args) {
  Py_ssize_t handle;
  PyObject* seq;
  long max_length, cls_id, sep_id, unk_id, pad_id;
  if (!PyArg_ParseTuple(args, "nOlllll", &handle, &seq, &max_length,
                        &cls_id, &sep_id, &unk_id, &pad_id))
    return nullptr;
  if (handle < 0 || (size_t)handle >= g_wp_vocabs.size() ||
      g_wp_vocabs[(size_t)handle] == nullptr) {
    PyErr_SetString(PyExc_ValueError, "bad wordpiece vocab handle");
    return nullptr;
  }
  const WordPieceVocab& vocab = *g_wp_vocabs[(size_t)handle];
  PyObject* fast = PySequence_Fast(seq, "expected a sequence of strings");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject** items = PySequence_Fast_ITEMS(fast);
  std::vector<int32_t> flat;
  flat.reserve((size_t)n * 32);
  std::vector<uint32_t> lens((size_t)n);
  size_t width = 2;
  PyObject* fallback = PyList_New(0);
  if (fallback == nullptr) {
    Py_DECREF(fast);
    return nullptr;
  }
  std::string word;
  std::vector<int32_t> pieces;
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_ssize_t slen;
    const char* s = PyUnicode_AsUTF8AndSize(items[i], &slen);
    if (s == nullptr) {
      Py_DECREF(fast);
      Py_DECREF(fallback);
      return nullptr;
    }
    bool ascii = true;
    for (Py_ssize_t j = 0; j < slen; j++) {
      if ((unsigned char)s[j] >= 0x80) {
        ascii = false;
        break;
      }
    }
    size_t row_start = flat.size();
    flat.push_back((int32_t)cls_id);
    if (!ascii) {
      PyObject* idx = PyLong_FromSsize_t(i);
      if (idx == nullptr || PyList_Append(fallback, idx) < 0) {
        Py_XDECREF(idx);
        Py_DECREF(fast);
        Py_DECREF(fallback);
        return nullptr;
      }
      Py_DECREF(idx);
    } else {
      pieces.clear();
      word.clear();
      for (Py_ssize_t j = 0; j <= slen; j++) {
        unsigned char c = j < slen ? (unsigned char)s[j] : (unsigned char)' ';
        unsigned char lc = (c >= 'A' && c <= 'Z') ? (unsigned char)(c + 32) : c;
        bool is_space = (c == ' ' || c == '\t' || c == '\n' || c == '\r');
        bool is_ctrl = (c < 0x20 && !is_space) || c == 0x7f;
        if (is_ctrl) continue;  // control chars are REMOVED (BERT
        // clean_text): 'ab\x01cd' stays ONE word, it does not split
        if (is_space || wp_is_punct(c)) {
          if (!word.empty()) {
            wp_word(vocab, word, (int32_t)unk_id, pieces);
            word.clear();
          }
          if (wp_is_punct(c)) {
            char pc = (char)c;
            auto it = vocab.word_start.find(std::string_view(&pc, 1));
            pieces.push_back(it != vocab.word_start.end()
                                 ? it->second
                                 : (int32_t)unk_id);
          }
        } else {
          word.push_back((char)lc);
        }
      }
      long budget = max_length > 2 ? max_length - 2 : 0;  // [CLS]/[SEP] room
      long take = (long)pieces.size() < budget ? (long)pieces.size() : budget;
      flat.insert(flat.end(), pieces.begin(), pieces.begin() + take);
    }
    flat.push_back((int32_t)sep_id);
    lens[(size_t)i] = (uint32_t)(flat.size() - row_start);
    if (lens[(size_t)i] > width) width = lens[(size_t)i];
  }
  Py_DECREF(fast);
  PyObject* out = PyByteArray_FromStringAndSize(
      nullptr, (Py_ssize_t)(n * width * 4));
  PyObject* lens_out = PyByteArray_FromStringAndSize(
      nullptr, (Py_ssize_t)(n * 4));
  if (out == nullptr || lens_out == nullptr) {
    Py_XDECREF(out);
    Py_XDECREF(lens_out);
    Py_DECREF(fallback);
    return nullptr;
  }
  int32_t* dst = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(out));
  uint32_t* lp = reinterpret_cast<uint32_t*>(PyByteArray_AS_STRING(lens_out));
  size_t pos = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    uint32_t len = lens[(size_t)i];
    std::memcpy(dst + (size_t)i * width, flat.data() + pos, (size_t)len * 4);
    for (size_t j = len; j < width; j++)
      dst[(size_t)i * width + j] = (int32_t)pad_id;
    lp[i] = len;
    pos += len;
  }
  return Py_BuildValue("(NnNN)", out, (Py_ssize_t)width, lens_out, fallback);
}

static PyMethodDef methods[] = {
    {"hash_tokenize", py_hash_tokenize, METH_VARARGS,
     "batch HashTokenizer: texts -> padded int32 id matrix + width"},
    {"wordpiece_load", py_wordpiece_load, METH_VARARGS,
     "register a WordPiece vocab; returns a handle"},
    {"wordpiece_free", py_wordpiece_free, METH_VARARGS,
     "release a WordPiece vocab handle"},
    {"wordpiece_tokenize", py_wordpiece_tokenize, METH_VARARGS,
     "batch WordPiece: texts -> padded int32 id matrix + width + fallbacks"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tokenize",
    "pathway_tpu_torch native batch tokenizers (hashing, WordPiece)", -1,
    methods};

PyMODINIT_FUNC PyInit__tokenize(void) { return PyModule_Create(&moduledef); }
