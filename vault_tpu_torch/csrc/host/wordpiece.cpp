// Native WordPiece tokenizer core (the port's copy of the JAX package's
// native/wordpiece.cpp, with the same C interface).
//
// Scope: ASCII basic tokenization (lowercase, punctuation split,
// whitespace) + greedy longest-match WordPiece with "##" continuations.
// The Python wrapper (vault_tpu_torch/text/native.py) is handed only ASCII
// text without protected tokens (text/wordpiece.py routes the rest through
// the Python tokenizer), so the ids are those of the Python tokenizer
// wherever this core runs (tests/test_torch_native.py).
//
// Built with the host C++ compiler at first use by
// vault_tpu_torch/ops/_build_host.py; loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id;
  bool lowercase;
  int32_t max_chars_per_word;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_control(unsigned char c) { return c < 32 && !is_space(c); }

// Greedy longest-match WordPiece on one basic token.
void wordpiece(const Tokenizer& t, const std::string& word,
               std::vector<int32_t>* out) {
  if ((int32_t)word.size() > t.max_chars_per_word) {
    out->push_back(t.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t found = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = t.vocab.find(sub);
      if (it != t.vocab.end()) {
        found = it->second;
        break;
      }
      end--;
    }
    if (found < 0) {
      out->push_back(t.unk_id);
      return;
    }
    pieces.push_back(found);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_create(const char** tokens, int32_t n, int32_t unk_id,
                int32_t lowercase, int32_t max_chars_per_word) {
  auto* t = new Tokenizer();
  t->vocab.reserve(n * 2);
  for (int32_t i = 0; i < n; i++) t->vocab.emplace(tokens[i], i);
  t->unk_id = unk_id;
  t->lowercase = lowercase != 0;
  t->max_chars_per_word = max_chars_per_word;
  return t;
}

void wp_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Tokenize `text` (ASCII) into ids; returns count (truncated to max_out).
int32_t wp_tokenize(void* handle, const char* text, int32_t* out_ids,
                    int32_t max_out) {
  const Tokenizer& t = *static_cast<Tokenizer*>(handle);
  std::vector<int32_t> ids;
  std::string word;
  const auto flush = [&]() {
    if (!word.empty()) {
      wordpiece(t, word, &ids);
      word.clear();
    }
  };
  for (const char* p = text; *p; p++) {
    unsigned char c = *p;
    if (c == 0xEF || c == 0xBF || is_control(c)) continue;  // defensive
    if (is_space(c)) {
      flush();
    } else if (is_ascii_punct(c)) {
      flush();
      std::string punct(1, (char)c);
      wordpiece(t, punct, &ids);
    } else {
      word.push_back(t.lowercase ? (char)tolower(c) : (char)c);
    }
  }
  flush();
  int32_t n = (int32_t)ids.size();
  if (n > max_out) n = max_out;
  std::memcpy(out_ids, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // extern "C"
