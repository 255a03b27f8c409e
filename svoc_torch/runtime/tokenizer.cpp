// Native batch tokenizer of the port: the hot host-side stage of the
// serving feed. A copy of svoc_tpu/runtime/tokenizer.cpp
// (svoc_tokenize_batch, line 78), changed in nothing but this comment;
// built and bound by svoc_torch/runtime/native.py.
//
// Semantics mirror svoc_torch/models/tokenizer.py::HashingTokenizer
// exactly for ASCII text: lowercase, split on non-alphanumeric bytes,
// FNV-1a hash each word into [N_SPECIAL, vocab_size), wrap with bos/eos,
// pad to seq_len. Non-ASCII UTF-8 bytes are treated as word characters
// without case folding (Python's unicode isalnum()/lower() may differ
// there); the serving path uses these ids, as the reference's does.
//
// Exposed as a C ABI for ctypes; calls release the GIL on the Python
// side, so tokenization overlaps device compute in the input pipeline.

#include <cstddef>
#include <cstdint>

namespace {

constexpr uint64_t kFnvOffset = 14695981039346656037ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;
constexpr int kNSpecial = 4;  // HashingTokenizer.N_SPECIAL

inline bool ascii_alnum(unsigned char c) {
  return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
         (c >= 'A' && c <= 'Z');
}

inline unsigned char ascii_lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
}

}  // namespace

extern "C" {

// Tokenize one row; returns the number of ids written (<= seq_len).
// ids/mask point at the row's seq_len-sized slices.
static int tokenize_row(const char* text, int seq_len, int64_t vocab_size,
                        int32_t pad_id, int32_t bos_id, int32_t eos_id,
                        int32_t* ids, int32_t* mask) {
  for (int i = 0; i < seq_len; ++i) {
    ids[i] = pad_id;
    mask[i] = 0;
  }
  if (seq_len < 2) return 0;

  const int64_t span = vocab_size - kNSpecial;
  int out = 0;
  ids[out++] = bos_id;

  uint64_t h = kFnvOffset;
  bool in_word = false;
  const int max_words = seq_len - 2;
  int n_words = 0;
  for (const char* p = text; *p != '\0' && n_words < max_words; ++p) {
    const unsigned char c = static_cast<unsigned char>(*p);
    if (ascii_alnum(c) || c >= 0x80) {
      h = (h ^ ascii_lower(c)) * kFnvPrime;
      in_word = true;
    } else if (in_word) {
      ids[out++] = static_cast<int32_t>(kNSpecial + (h % span));
      ++n_words;
      h = kFnvOffset;
      in_word = false;
    }
  }
  if (in_word && n_words < max_words) {
    ids[out++] = static_cast<int32_t>(kNSpecial + (h % span));
  }
  ids[out++] = eos_id;
  for (int i = 0; i < out; ++i) mask[i] = 1;
  return out;
}

void svoc_tokenize_batch(const char** texts, int n_texts, int seq_len,
                         int64_t vocab_size, int32_t pad_id, int32_t bos_id,
                         int32_t eos_id, int32_t* ids, int32_t* mask) {
  for (int i = 0; i < n_texts; ++i) {
    tokenize_row(texts[i], seq_len, vocab_size, pad_id, bos_id, eos_id,
                 ids + static_cast<ptrdiff_t>(i) * seq_len,
                 mask + static_cast<ptrdiff_t>(i) * seq_len);
  }
}

}  // extern "C"
