// Native BPE encoder core (C ABI, loaded via ctypes).
//
// The reference's tokenization speed comes from native dependencies
// (sentencepiece C++ / tiktoken's Rust core, consumed through
// mistral-common — reference: pyproject.toml:30, main.py:41-57). This is
// the in-repo equivalent: the merge loops for both tokenizer families live
// here; Python keeps only file parsing and normalization.
//
//   * spm_*  — SentencePiece-style BPE: greedy merge of the adjacent pair
//     whose merged piece has the highest score (ties: leftmost), over
//     UTF-8 codepoint symbols, with <0xNN> byte fallback. Uses a heap-free
//     O(n·m) scan per merge which is faster than a priority queue for
//     typical (< few hundred symbol) words and allocation-free.
//   * bbpe_* — byte-level BPE (tekken/tiktoken style): repeatedly merge the
//     adjacent pair with the lowest rank.
//
// Build: make -C mistral_inference_tpu/native   (→ libbpe.so)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct SpmModel {
  std::unordered_map<std::string, int32_t> piece_to_id;
  std::vector<float> scores;
  int32_t byte_ids[256];
  int32_t unk_id;
};

struct BbpeModel {
  std::unordered_map<std::string, int32_t> ranks;  // token bytes -> rank
};

// UTF-8 codepoint length from lead byte.
inline int cp_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;  // invalid byte: treat as single
}

}  // namespace

extern "C" {

// pieces: concatenated [len:int32][bytes] entries; scores: float per piece.
void* spm_create(const uint8_t* pieces, const int32_t* lens, const float* scores,
                 int32_t n, int32_t unk_id) {
  auto* m = new SpmModel();
  m->unk_id = unk_id;
  m->scores.assign(scores, scores + n);
  for (int i = 0; i < 256; ++i) m->byte_ids[i] = unk_id;
  size_t off = 0;
  char hexbuf[8];
  for (int32_t i = 0; i < n; ++i) {
    std::string piece(reinterpret_cast<const char*>(pieces + off), lens[i]);
    off += lens[i];
    m->piece_to_id.emplace(piece, i);
    if (lens[i] == 6 && piece[0] == '<' && piece[1] == '0' && piece[2] == 'x' &&
        piece[5] == '>') {
      int b = std::stoi(piece.substr(3, 2), nullptr, 16);
      m->byte_ids[b] = i;
    }
    (void)hexbuf;
  }
  return m;
}

void spm_destroy(void* h) { delete static_cast<SpmModel*>(h); }

// Encode normalized UTF-8 text (already ▁-substituted). Returns count;
// writes ids into out (caller allocates >= byte length of text).
int32_t spm_encode(void* h, const uint8_t* text, int32_t text_len, int32_t* out) {
  auto* m = static_cast<SpmModel*>(h);
  // split into codepoint symbols: (start, len) pairs
  std::vector<std::pair<int32_t, int32_t>> syms;
  syms.reserve(text_len);
  for (int32_t i = 0; i < text_len;) {
    int l = cp_len(text[i]);
    if (i + l > text_len) l = 1;
    syms.emplace_back(i, l);
    i += l;
  }
  std::string merged;
  while (syms.size() > 1) {
    int best_i = -1;
    float best_score = -1e30f;
    for (size_t j = 0; j + 1 < syms.size(); ++j) {
      merged.assign(reinterpret_cast<const char*>(text + syms[j].first),
                    syms[j].second + syms[j + 1].second);
      auto it = m->piece_to_id.find(merged);
      if (it != m->piece_to_id.end() && m->scores[it->second] > best_score) {
        best_score = m->scores[it->second];
        best_i = static_cast<int>(j);
      }
    }
    if (best_i < 0) break;
    syms[best_i].second += syms[best_i + 1].second;
    syms.erase(syms.begin() + best_i + 1);
  }
  int32_t count = 0;
  std::string s;
  for (auto& sym : syms) {
    s.assign(reinterpret_cast<const char*>(text + sym.first), sym.second);
    auto it = m->piece_to_id.find(s);
    if (it != m->piece_to_id.end()) {
      out[count++] = it->second;
    } else {
      for (int32_t b = 0; b < sym.second; ++b)
        out[count++] = m->byte_ids[text[sym.first + b]];
    }
  }
  return count;
}

void* bbpe_create(const uint8_t* tokens, const int32_t* lens, const int32_t* ranks,
                  int32_t n) {
  auto* m = new BbpeModel();
  size_t off = 0;
  for (int32_t i = 0; i < n; ++i) {
    m->ranks.emplace(
        std::string(reinterpret_cast<const char*>(tokens + off), lens[i]), ranks[i]);
    off += lens[i];
  }
  return m;
}

void bbpe_destroy(void* h) { delete static_cast<BbpeModel*>(h); }

// Classic byte-BPE over one pre-split word; returns count, ids into out.
int32_t bbpe_encode(void* h, const uint8_t* word, int32_t len, int32_t* out) {
  auto* m = static_cast<BbpeModel*>(h);
  std::vector<std::pair<int32_t, int32_t>> parts;  // (start, len)
  parts.reserve(len);
  for (int32_t i = 0; i < len; ++i) parts.emplace_back(i, 1);
  std::string merged;
  while (parts.size() > 1) {
    int best_i = -1;
    int64_t best_rank = INT64_MAX;
    for (size_t j = 0; j + 1 < parts.size(); ++j) {
      merged.assign(reinterpret_cast<const char*>(word + parts[j].first),
                    parts[j].second + parts[j + 1].second);
      auto it = m->ranks.find(merged);
      if (it != m->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = static_cast<int>(j);
      }
    }
    if (best_i < 0) break;
    parts[best_i].second += parts[best_i + 1].second;
    parts.erase(parts.begin() + best_i + 1);
  }
  int32_t count = 0;
  std::string s;
  for (auto& p : parts) {
    s.assign(reinterpret_cast<const char*>(word + p.first), p.second);
    auto it = m->ranks.find(s);
    out[count++] = it != m->ranks.end() ? it->second : -1;
  }
  return count;
}

}  // extern "C"
