// mimm_host — host-side data ops of mimm_tpu_torch (the port's own copy of
// the JAX package's host library source, the same algorithm).
//
// The reference's data loader spends its time in Python/PIL transforming
// full-resolution CXRs (helpers.py:146-161).  This library implements the
// fused inverse-map affine + center-crop + max-normalize (the exact
// algorithm of mimm_tpu_torch/data/transforms.py affine_crop +
// max_normalize, the same PIL pixel-center floor rounding) in C++, and the
// ctypes calls (mimm_tpu_torch/data/native_ops.py) release the GIL, so the
// Loader's decode threads run on several cores at once.
//
// Built at first use by mimm_tpu_torch/data/native_ops.py with
// g++ -O3 -fPIC -shared -ffp-contract=off (no -march=native: a contracted
// m[0] * fx + base_x could move a floor by one pixel); no dependencies.

#include <cmath>
#include <cstdint>
#include <algorithm>

// Inverse-affine sample of the centered out_size x out_size crop.
// matrix m[6]: output pixel-center (x+0.5, y+0.5) -> source coords
// (torchvision _get_inverse_affine_matrix convention, scale=1, shear=0).
// Pixels mapping outside the source are 0 (PIL fillcolor=0).
// Returns the max sample value (for normalization).
// src_oy/src_ox (decoded-crop cache, data/crop_cache.py): `img` is a
// (h, w) window cut from a larger source at that origin; source coords
// are computed in FULL-image frame and shifted by the integer origin
// AFTER the floor — bit-exact with running on the full image (a
// pre-floor float shift could flip the floor by one ulp).  Masking
// against the window bounds equals masking against the full image
// because the cache window covers the whole affine support region by
// construction (crop_cache.support_window).
template <typename T>
static double affine_crop_impl(const T* img, int64_t h, int64_t w,
                               const double* m, int64_t top, int64_t left,
                               int64_t out_size, float* out,
                               int64_t src_oy = 0, int64_t src_ox = 0) {
  double maxv = 0.0;
  for (int64_t oy = 0; oy < out_size; ++oy) {
    const double fy = static_cast<double>(oy + top) + 0.5;
    const double base_x = m[1] * fy + m[2];
    const double base_y = m[4] * fy + m[5];
    float* row = out + oy * out_size;
    for (int64_t ox = 0; ox < out_size; ++ox) {
      const double fx = static_cast<double>(ox + left) + 0.5;
      const int64_t sx =
          static_cast<int64_t>(std::floor(m[0] * fx + base_x)) - src_ox;
      const int64_t sy =
          static_cast<int64_t>(std::floor(m[3] * fx + base_y)) - src_oy;
      float v = 0.0f;
      if (sx >= 0 && sx < w && sy >= 0 && sy < h) {
        v = static_cast<float>(img[sy * w + sx]);
      }
      row[ox] = v;
      if (v > maxv) maxv = v;
    }
  }
  return maxv;
}

static void normalize_inplace(float* out, int64_t n, double maxv) {
  // true division (not reciprocal-multiply) for bit-exact parity with the
  // numpy reference path (img / max(1e-3, img.max()))
  const float denom = static_cast<float>(std::max(1e-3, maxv));
  for (int64_t i = 0; i < n; ++i) out[i] /= denom;
}

extern "C" {

// uint8 source (standard MIMIC-CXR JPEGs)
void affine_crop_norm_u8(const uint8_t* img, int64_t h, int64_t w,
                         const double* matrix, int64_t top, int64_t left,
                         int64_t out_size, float* out) {
  const double maxv = affine_crop_impl(img, h, w, matrix, top, left, out_size, out);
  normalize_inplace(out, out_size * out_size, maxv);
}

// uint16 source (IMREAD_ANYDEPTH can produce 16-bit)
void affine_crop_norm_u16(const uint16_t* img, int64_t h, int64_t w,
                          const double* matrix, int64_t top, int64_t left,
                          int64_t out_size, float* out) {
  const double maxv = affine_crop_impl(img, h, w, matrix, top, left, out_size, out);
  normalize_inplace(out, out_size * out_size, maxv);
}

// Windowed variants (decoded-crop cache): img is a window at source
// origin (src_oy, src_ox); top/left/matrix stay in FULL-image frame.
void affine_crop_norm_u8_win(const uint8_t* img, int64_t h, int64_t w,
                             const double* matrix, int64_t top, int64_t left,
                             int64_t src_oy, int64_t src_ox,
                             int64_t out_size, float* out) {
  const double maxv = affine_crop_impl(img, h, w, matrix, top, left, out_size,
                                       out, src_oy, src_ox);
  normalize_inplace(out, out_size * out_size, maxv);
}

void affine_crop_norm_u16_win(const uint16_t* img, int64_t h, int64_t w,
                              const double* matrix, int64_t top, int64_t left,
                              int64_t src_oy, int64_t src_ox,
                              int64_t out_size, float* out) {
  const double maxv = affine_crop_impl(img, h, w, matrix, top, left, out_size,
                                       out, src_oy, src_ox);
  normalize_inplace(out, out_size * out_size, maxv);
}

}  // extern "C"

// Raw (un-normalized, source-dtype) affine-crop variants for the compact
// host->device transfer path: the loader ships the integer crop (1-2 bytes
// per pixel instead of a 4-byte float) and the train step performs the
// identical float32 cast + max-normalize on device
// (mimm_tpu_torch/ops/image_norm.py) — bit-exact with the fused variants
// above, at half/quarter the host-to-device traffic.
template <typename T>
static void affine_crop_raw_impl(const T* img, int64_t h, int64_t w,
                                 const double* m, int64_t top, int64_t left,
                                 int64_t out_size, T* out,
                                 int64_t src_oy = 0, int64_t src_ox = 0) {
  for (int64_t oy = 0; oy < out_size; ++oy) {
    const double fy = static_cast<double>(oy + top) + 0.5;
    const double base_x = m[1] * fy + m[2];
    const double base_y = m[4] * fy + m[5];
    T* row = out + oy * out_size;
    for (int64_t ox = 0; ox < out_size; ++ox) {
      const double fx = static_cast<double>(ox + left) + 0.5;
      const int64_t sx =
          static_cast<int64_t>(std::floor(m[0] * fx + base_x)) - src_ox;
      const int64_t sy =
          static_cast<int64_t>(std::floor(m[3] * fx + base_y)) - src_oy;
      T v = 0;
      if (sx >= 0 && sx < w && sy >= 0 && sy < h) {
        v = img[sy * w + sx];
      }
      row[ox] = v;
    }
  }
}

extern "C" {

void affine_crop_raw_u8(const uint8_t* img, int64_t h, int64_t w,
                        const double* matrix, int64_t top, int64_t left,
                        int64_t out_size, uint8_t* out) {
  affine_crop_raw_impl(img, h, w, matrix, top, left, out_size, out);
}

void affine_crop_raw_u16(const uint16_t* img, int64_t h, int64_t w,
                         const double* matrix, int64_t top, int64_t left,
                         int64_t out_size, uint16_t* out) {
  affine_crop_raw_impl(img, h, w, matrix, top, left, out_size, out);
}

void affine_crop_raw_u8_win(const uint8_t* img, int64_t h, int64_t w,
                            const double* matrix, int64_t top, int64_t left,
                            int64_t src_oy, int64_t src_ox,
                            int64_t out_size, uint8_t* out) {
  affine_crop_raw_impl(img, h, w, matrix, top, left, out_size, out,
                       src_oy, src_ox);
}

void affine_crop_raw_u16_win(const uint16_t* img, int64_t h, int64_t w,
                             const double* matrix, int64_t top, int64_t left,
                             int64_t src_oy, int64_t src_ox,
                             int64_t out_size, uint16_t* out) {
  affine_crop_raw_impl(img, h, w, matrix, top, left, out_size, out,
                       src_oy, src_ox);
}

}  // extern "C"

// Plain center-crop (+ zero pad) + normalize — the eval path.
template <typename T>
static void center_crop_impl(const T* img, int64_t h, int64_t w,
                             int64_t top, int64_t left, int64_t out_size,
                             float* out) {
  double maxv = 0.0;
  for (int64_t oy = 0; oy < out_size; ++oy) {
    const int64_t sy = oy + top;
    float* row = out + oy * out_size;
    for (int64_t ox = 0; ox < out_size; ++ox) {
      const int64_t sx = ox + left;
      float v = 0.0f;
      if (sx >= 0 && sx < w && sy >= 0 && sy < h) {
        v = static_cast<float>(img[sy * w + sx]);
      }
      row[ox] = v;
      if (v > maxv) maxv = v;
    }
  }
  normalize_inplace(out, out_size * out_size, maxv);
}

extern "C" {

void center_crop_norm_u8(const uint8_t* img, int64_t h, int64_t w,
                         int64_t top, int64_t left, int64_t out_size,
                         float* out) {
  center_crop_impl(img, h, w, top, left, out_size, out);
}

void center_crop_norm_u16(const uint16_t* img, int64_t h, int64_t w,
                          int64_t top, int64_t left, int64_t out_size,
                          float* out) {
  center_crop_impl(img, h, w, top, left, out_size, out);
}

}  // extern "C"

// Raw center-crop (eval-path counterpart of affine_crop_raw_*).
template <typename T>
static void center_crop_raw_impl(const T* img, int64_t h, int64_t w,
                                 int64_t top, int64_t left, int64_t out_size,
                                 T* out) {
  for (int64_t oy = 0; oy < out_size; ++oy) {
    const int64_t sy = oy + top;
    T* row = out + oy * out_size;
    for (int64_t ox = 0; ox < out_size; ++ox) {
      const int64_t sx = ox + left;
      T v = 0;
      if (sx >= 0 && sx < w && sy >= 0 && sy < h) {
        v = img[sy * w + sx];
      }
      row[ox] = v;
    }
  }
}

extern "C" {

void center_crop_raw_u8(const uint8_t* img, int64_t h, int64_t w,
                        int64_t top, int64_t left, int64_t out_size,
                        uint8_t* out) {
  center_crop_raw_impl(img, h, w, top, left, out_size, out);
}

void center_crop_raw_u16(const uint16_t* img, int64_t h, int64_t w,
                         int64_t top, int64_t left, int64_t out_size,
                         uint16_t* out) {
  center_crop_raw_impl(img, h, w, top, left, out_size, out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native WordPiece encoder (ASCII fast path).
//
// The reference tokenizes 200k reports with a Pool(cpu_count()-1) of Python
// workers (model_utils.py:539-543); the pure-Python WordPiece
// (mimm_tpu_torch/data/tokenizer.py) holds the GIL, and a forked pool is
// unsafe once CUDA is initialized in the process.  This encoder implements
// the exact BERT basic+wordpiece algorithm for ASCII input in C++ — clinical
// MIMIC-CXR reports are ASCII — and REFUSES (returns -1) on any byte >= 0x80
// so the Python implementation, which carries the full Unicode semantics
// (NFD accent stripping, category lookups), handles those texts instead.
// Calls release the GIL via ctypes, so featurization fans out over THREADS.

#include <cstdio>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct WpVocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t unk_id = 0;
};

inline bool wp_is_ascii_punct(unsigned char c) {
  // tokenizer.py _is_punctuation: the four ASCII ranges (category-P chars
  // outside them are all non-ASCII, and the ranges also include $+<=>^`|~
  // by the same treat-all-symbols-as-punctuation rule).
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

const char* kNeverSplit[] = {"[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"};

// Greedy longest-match-first wordpiece over one whitespace/punct-free word.
// Appends ids to `out`; a word with no full tiling becomes one [UNK]
// (tokenizer.py WordpieceTokenizer.tokenize).
void wp_wordpiece(const WpVocab& v, const std::string& word,
                  std::vector<int32_t>& out) {
  if (word.size() > 100) {  // max_input_chars_per_word
    out.push_back(v.unk_id);
    return;
  }
  std::vector<int32_t> sub;
  size_t start = 0;
  std::string key;
  while (start < word.size()) {
    size_t end = word.size();
    bool found = false;
    while (start < end) {
      key.clear();
      if (start > 0) key = "##";
      key.append(word, start, end - start);
      auto it = v.map.find(key);
      if (it != v.map.end()) {
        sub.push_back(it->second);
        found = true;
        break;
      }
      --end;
    }
    if (!found) {
      out.push_back(v.unk_id);
      return;
    }
    start = end;
  }
  out.insert(out.end(), sub.begin(), sub.end());
}

}  // namespace

extern "C" {

// Load vocab.txt (one token per line; only trailing '\n' stripped, matching
// tokenizer.py load_vocab's rstrip("\n"); duplicate tokens keep the LAST
// index, like dict assignment).  Returns an opaque handle or null.
void* mimm_wp_create(const char* vocab_path) {
  FILE* f = fopen(vocab_path, "rb");
  if (!f) return nullptr;
  WpVocab* v = new WpVocab();
  std::string line;
  int32_t idx = 0;
  int c;
  bool pending = false;
  while ((c = fgetc(f)) != EOF) {
    // Universal-newline line splitting ('\n', '\r\n', lone '\r'), matching
    // Python's text-mode load_vocab (data/tokenizer.py) so CRLF vocab files
    // produce identical keys/indices on both paths.
    if (c == '\r') {
      int next = fgetc(f);
      if (next != '\n' && next != EOF) ungetc(next, f);
      c = '\n';
    }
    if (c == '\n') {
      v->map[line] = idx++;
      line.clear();
      pending = false;
    } else {
      line.push_back(static_cast<char>(c));
      pending = true;
    }
  }
  if (pending) v->map[line] = idx++;
  fclose(f);
  auto it = v->map.find("[UNK]");
  v->unk_id = (it != v->map.end()) ? it->second : 0;
  return v;
}

void mimm_wp_destroy(void* handle) { delete static_cast<WpVocab*>(handle); }

// Encode UTF-8 text -> wordpiece ids (no [CLS]/[SEP]).  Returns the number
// of ids written, -1 if the text needs the Python path (any non-ASCII
// byte), or -2 if `max_out` is too small.  Thread-safe (vocab is
// read-only after create).
int64_t mimm_wp_encode(const void* handle, const char* text, int64_t n,
                       int do_lower_case, int32_t* out_ids, int64_t max_out) {
  const WpVocab& v = *static_cast<const WpVocab*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }
  std::vector<int32_t> ids;
  ids.reserve(static_cast<size_t>(n) / 4 + 8);
  std::string word, piece;
  for (int64_t i = 0; i <= n; ++i) {
    unsigned char c = (i < n) ? static_cast<unsigned char>(text[i]) : ' ';
    // _clean_text: drop NUL and control chars (ASCII Cc = 0x01-0x1F minus
    // \t\n\r, plus 0x7F); whitespace (incl. \t\n\r) is a word boundary.
    if (c == 0 || c == 0x7F || (c < 0x20 && c != '\t' && c != '\n' && c != '\r'))
      continue;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      if (word.empty()) continue;
      bool never = false;
      for (const char* t : kNeverSplit)
        if (word == t) { never = true; break; }
      if (never) {
        wp_wordpiece(v, word, ids);
      } else {
        if (do_lower_case) {
          for (char& ch : word)
            if (ch >= 'A' && ch <= 'Z') ch += 'a' - 'A';
          // NFD accent stripping is a no-op on ASCII.
        }
        piece.clear();
        for (char ch : word) {
          if (wp_is_ascii_punct(static_cast<unsigned char>(ch))) {
            if (!piece.empty()) wp_wordpiece(v, piece, ids);
            piece.assign(1, ch);
            wp_wordpiece(v, piece, ids);
            piece.clear();
          } else {
            piece.push_back(ch);
          }
        }
        if (!piece.empty()) wp_wordpiece(v, piece, ids);
      }
      word.clear();
    } else {
      word.push_back(static_cast<char>(c));
    }
  }
  if (static_cast<int64_t>(ids.size()) > max_out) return -2;
  for (size_t i = 0; i < ids.size(); ++i) out_ids[i] = ids[i];
  return static_cast<int64_t>(ids.size());
}

}  // extern "C"
