// Native feature-generation ops: the host C++ half of FG.
//
// Counterpart of torcheasyrec_tpu/fg/csrc/fg_ops.cc, kept byte for byte
// in its code so that both packages give the same ids. TorchEasyRec runs
// FG in the closed-source pyfg wheel (FgArrowHandler); here the
// host-side FG hot loops (string hashing, multi-value splitting,
// bucketization and the per-feature DAG tasks) run over Arrow-compatible
// flat buffers (offsets + data pointers), behind a C ABI that
// torcheasyrec_tpu_torch/fg/__init__.py loads through ctypes.
//
// Hash: 64-bit FNV-1a, the same bytes as the plain versions in
// torcheasyrec_tpu_torch/fg/__init__.py. Parallelized with a simple
// thread pool (fg_threads in DataConfig).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

inline uint64_t fnv1a(const char* data, int64_t len) {
  uint64_t h = kFnvOffset;
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

void parallel_for(int64_t n, int threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (threads <= 1 || n < (1 << 14)) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Hash utf-8 strings laid out as (offsets[n+1], data) -> out[n] uint64.
void fg_hash64_strings(const int32_t* offsets, const char* data, int64_t n,
                       uint64_t* out, int threads) {
  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i] = fnv1a(data + offsets[i], offsets[i + 1] - offsets[i]);
    }
  });
}

// Same but modulo a bucket count (hash_bucket_size semantics).
void fg_hash64_strings_mod(const int32_t* offsets, const char* data,
                           int64_t n, uint64_t num_buckets, int64_t* out,
                           int threads) {
  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t h =
          fnv1a(data + offsets[i], offsets[i + 1] - offsets[i]);
      out[i] = static_cast<int64_t>(h % num_buckets);
    }
  });
}

// Bucketize: out[i] = #boundaries <= searchsorted-right position.
void fg_bucketize(const double* values, int64_t n, const double* boundaries,
                  int64_t n_bounds, int64_t* out, int threads) {
  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i] = std::upper_bound(boundaries, boundaries + n_bounds,
                                values[i]) -
               boundaries;
    }
  });
}

// Split multi-value strings on `sep` and hash each token:
// inputs (offsets[n+1], data); outputs: token hashes appended to
// out_vals (caller-sized to max_tokens), per-row counts in out_lengths.
// Returns total token count, or -1 if out_vals capacity was exceeded.
int64_t fg_split_hash(const int32_t* offsets, const char* data, int64_t n,
                      char sep, uint64_t num_buckets, int64_t* out_vals,
                      int64_t max_tokens, int32_t* out_lengths) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* begin = data + offsets[i];
    const char* end = data + offsets[i + 1];
    int32_t count = 0;
    if (begin == end) {
      out_lengths[i] = 0;
      continue;
    }
    const char* tok = begin;
    for (const char* p = begin; p <= end; ++p) {
      if (p == end || *p == sep) {
        if (p > tok) {
          if (total >= max_tokens) return -1;
          uint64_t h = fnv1a(tok, p - tok);
          out_vals[total++] =
              num_buckets ? static_cast<int64_t>(h % num_buckets)
                          : static_cast<int64_t>(h);
          ++count;
        }
        tok = p + 1;
      }
    }
    out_lengths[i] = count;
  }
  return total;
}

// Hash int64 values by their DECIMAL STRING representation (the python
// FG_NORMAL path str()s integer id columns before FNV hashing, so the
// vectorized path must hash identical bytes), modulo bucket count.
void fg_hash64_ints_mod(const int64_t* values, int64_t n,
                        uint64_t num_buckets, int64_t* out, int threads) {
  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    char buf[24];
    for (int64_t i = lo; i < hi; ++i) {
      int len = snprintf(buf, sizeof(buf), "%lld",
                         static_cast<long long>(values[i]));
      uint64_t h = fnv1a(buf, len);
      out[i] = static_cast<int64_t>(h % num_buckets);
    }
  });
}

// log10 normalizer with threshold/default (raw_feature's
// normalizer "method=log10").
void fg_normalize_log10(const float* values, int64_t n, float threshold,
                        float default_value, float* out, int threads) {
  parallel_for(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[i] = values[i] >= threshold ? log10f(values[i]) : default_value;
    }
  });
}

int fg_version() { return 1; }

}  // extern "C"

// ---------------------------------------------------------------------------
// FG DAG executor: one task per feature, a worker pool drains the task
// array (the pyfg multi-threaded DAG equivalent: FgArrowHandler
// processes all features of a batch in C++ in one call).
// Python builds tasks from feature configs; unsupported feature types
// stay on the python path per feature.
// ---------------------------------------------------------------------------

extern "C" {

enum FgTaskKind {
  FG_TASK_ID_HASH = 0,    // split(sep) + FNV-1a mod buckets
  FG_TASK_COMBO_HASH = 1, // join n_inputs single values with \x1d, hash
  FG_TASK_RAW = 2,        // parse float (+log10) (+bucketize)
  FG_TASK_KV_LOOKUP = 3,  // map "k:v,k:v" column + key column -> float
  FG_TASK_MATCH_LOOKUP = 4, // nested "pk^k:v,k:v|pk2^..." + pkey + skey
  FG_TASK_OVERLAP = 5,      // query/title token-set overlap ratios
  FG_TASK_KV_DOT = 6,       // weighted dot of two "k:v<sep>k:v" columns
  FG_TASK_ID_VOCAB = 7,     // whole-cell token -> sorted-vocab bsearch
};

typedef struct {
  // inputs: arrow string columns (offsets/data); fvals for numeric RAW
  const int32_t* offsets[4];
  const char* data[4];
  const double* fvals;
  const double* boundaries;
  int64_t* out_vals;
  float* out_fvals;
  int32_t* out_lengths;
  int64_t n_rows;
  int64_t n_bounds;
  int64_t max_tokens;
  int64_t out_total;   // written by the executor
  uint64_t num_buckets;
  double norm_threshold;
  double norm_default;
  double default_fval;
  int32_t kind;
  int32_t n_inputs;
  int32_t normalizer;  // 0 none, 1 log10
  int32_t status;      // 0 ok; -1 capacity; -2 bad task
  int32_t sep;         // multi-value separator char for ID_HASH
  int32_t _pad;
  // ID_VOCAB: sorted key blob rides inputs[1]; ids + OOV id below
  const int64_t* aux_vals;
  int64_t n_aux;
  int64_t oov_val;
} FgTask;

}  // extern "C"

namespace {

void run_id_hash(FgTask& t) {
  int64_t total = fg_split_hash(t.offsets[0], t.data[0], t.n_rows,
                                static_cast<char>(t.sep), t.num_buckets,
                                t.out_vals, t.max_tokens, t.out_lengths);
  if (total < 0) {
    t.status = -1;
    return;
  }
  t.out_total = total;
}

void run_combo_hash(FgTask& t) {
  // cross of single values per row: join inputs with \x1d then hash
  // (matches the python ComboFeature path); any empty input -> skip row
  char buf[4096];
  int64_t total = 0;
  for (int64_t i = 0; i < t.n_rows; ++i) {
    int64_t pos = 0;
    bool ok = true;
    for (int32_t j = 0; j < t.n_inputs; ++j) {
      int64_t len = t.offsets[j][i + 1] - t.offsets[j][i];
      if (pos + len + 1 > static_cast<int64_t>(sizeof(buf))) {
        t.status = -1;  // too long for the fixed buffer: python fallback
        return;
      }
      if (len == 0) {
        ok = false;
        break;
      }
      if (j) buf[pos++] = '\x1d';
      std::memcpy(buf + pos, t.data[j] + t.offsets[j][i], len);
      pos += len;
    }
    if (!ok) {
      t.out_lengths[i] = 0;
      continue;
    }
    if (total >= t.max_tokens) {
      t.status = -1;
      return;
    }
    uint64_t h = fnv1a(buf, pos);
    t.out_vals[total++] =
        t.num_buckets ? static_cast<int64_t>(h % t.num_buckets)
                      : static_cast<int64_t>(h);
    t.out_lengths[i] = 1;
  }
  t.out_total = total;
}

inline double parse_double(const char* s, int64_t len, double dflt) {
  if (len == 0) return dflt;
  char buf[64];
  int64_t n = std::min<int64_t>(len, 63);
  std::memcpy(buf, s, n);
  buf[n] = '\0';
  char* end = nullptr;
  double v = strtod(buf, &end);
  return end == buf ? dflt : v;
}

// python float() semantics: the whole token must parse or -> dflt
inline double parse_double_strict(const char* s, int64_t len, double dflt) {
  if (len == 0 || len > 63) return dflt;
  char buf[64];
  std::memcpy(buf, s, len);
  buf[len] = '\0';
  char* end = nullptr;
  double v = strtod(buf, &end);
  return (end == buf + len) ? v : dflt;
}

void run_raw(FgTask& t) {
  for (int64_t i = 0; i < t.n_rows; ++i) {
    double v;
    if (t.fvals) {
      v = t.fvals[i];
    } else {
      v = parse_double(t.data[0] + t.offsets[0][i],
                       t.offsets[0][i + 1] - t.offsets[0][i],
                       t.default_fval);
    }
    if (t.normalizer == 1) {
      v = v >= t.norm_threshold ? log10(v) : t.norm_default;
    }
    if (t.n_bounds > 0) {
      t.out_vals[i] = std::upper_bound(t.boundaries,
                                       t.boundaries + t.n_bounds, v) -
                      t.boundaries;
      t.out_lengths[i] = 1;
    } else {
      t.out_fvals[i] = static_cast<float>(v);
    }
  }
  t.out_total = t.n_rows;
}

void run_kv_lookup(FgTask& t) {
  // inputs[0] = map column "k1:v1<sep>k2:v2"; inputs[1] = key column
  char sep = static_cast<char>(t.sep);
  for (int64_t i = 0; i < t.n_rows; ++i) {
    const char* key = t.data[1] + t.offsets[1][i];
    int64_t key_len = t.offsets[1][i + 1] - t.offsets[1][i];
    const char* m = t.data[0] + t.offsets[0][i];
    const char* end = m + (t.offsets[0][i + 1] - t.offsets[0][i]);
    double v = t.default_fval;
    const char* entry = m;
    while (entry < end && key_len > 0) {
      const char* next = static_cast<const char*>(
          memchr(entry, sep, end - entry));
      const char* entry_end = next ? next : end;
      const char* colon = static_cast<const char*>(
          memchr(entry, ':', entry_end - entry));
      if (colon && colon - entry == key_len &&
          std::memcmp(entry, key, key_len) == 0) {
        // keep scanning: python dict() keeps the LAST duplicate key
        v = parse_double_strict(colon + 1, entry_end - colon - 1,
                                t.default_fval);
      }
      entry = entry_end + 1;
    }
    t.out_fvals[i] = static_cast<float>(v);
  }
  t.out_total = t.n_rows;
}

void run_match_lookup(FgTask& t) {
  // inputs[0] = nested map "pk1^k1:v1,k2:v2|pk2^..."; [1] = pkey; [2] =
  // skey. Python-dict semantics preserved: the LAST group with a
  // matching pk REPLACES earlier ones entirely (so a later match
  // lacking skey clears an earlier value), and within a group the last
  // duplicate key wins.
  for (int64_t i = 0; i < t.n_rows; ++i) {
    const char* pkey = t.data[1] + t.offsets[1][i];
    int64_t pkey_len = t.offsets[1][i + 1] - t.offsets[1][i];
    const char* skey = t.data[2] + t.offsets[2][i];
    int64_t skey_len = t.offsets[2][i + 1] - t.offsets[2][i];
    const char* m = t.data[0] + t.offsets[0][i];
    const char* end = m + (t.offsets[0][i + 1] - t.offsets[0][i]);
    double v = t.default_fval;
    const char* grp = m;
    while (grp < end) {
      const char* grp_next = static_cast<const char*>(
          memchr(grp, '|', end - grp));
      const char* grp_end = grp_next ? grp_next : end;
      const char* caret = static_cast<const char*>(
          memchr(grp, '^', grp_end - grp));
      if (caret && caret - grp == pkey_len &&
          std::memcmp(grp, pkey, pkey_len) == 0) {
        v = t.default_fval;  // a matching group replaces earlier ones
        const char* entry = caret + 1;
        while (entry < grp_end) {
          const char* comma = static_cast<const char*>(
              memchr(entry, ',', grp_end - entry));
          const char* entry_end = comma ? comma : grp_end;
          const char* colon = static_cast<const char*>(
              memchr(entry, ':', entry_end - entry));
          if (colon && colon - entry == skey_len &&
              std::memcmp(entry, skey, skey_len) == 0) {
            v = parse_double_strict(colon + 1, entry_end - colon - 1,
                                    t.default_fval);
          }
          entry = entry_end + 1;
        }
      }
      grp = grp_end + 1;
    }
    t.out_fvals[i] = static_cast<float>(v);
  }
  t.out_total = t.n_rows;
}

// Tokenize a string by `sep` into up to `cap` DISTINCT token spans.
// Returns the distinct count, or -1 when the row has too many tokens.
inline int overlap_tokens(const char* s, int64_t len, char sep,
                          const char** tok, int64_t* tok_len, int cap) {
  int n = 0;
  const char* p = s;
  const char* end = s + len;
  while (p <= end) {
    const char* next = static_cast<const char*>(
        p < end ? memchr(p, sep, end - p) : nullptr);
    const char* tok_end = next ? next : end;
    int64_t tl = tok_end - p;
    if (tl > 0) {
      bool dup = false;
      for (int j = 0; j < n; ++j) {
        if (tok_len[j] == tl && std::memcmp(tok[j], p, tl) == 0) {
          dup = true;
          break;
        }
      }
      if (!dup) {
        if (n >= cap) return -1;
        tok[n] = p;
        tok_len[n] = tl;
        ++n;
      }
    }
    if (!next) break;
    p = next + 1;
  }
  return n;
}

void run_overlap(FgTask& t) {
  // inputs[0] = query column, [1] = title column; method rides the
  // normalizer slot: 0 query_common_ratio, 1 title_common_ratio,
  // 2 is_contain, 3 is_equal. Optional boundaries bucketize the ratio
  // (sparse variant), like run_raw.
  constexpr int kCap = 256;
  const char* qt[kCap];
  int64_t ql[kCap];
  const char* tt[kCap];
  int64_t tl[kCap];
  char sep = static_cast<char>(t.sep);
  for (int64_t i = 0; i < t.n_rows; ++i) {
    int qn = overlap_tokens(t.data[0] + t.offsets[0][i],
                            t.offsets[0][i + 1] - t.offsets[0][i], sep,
                            qt, ql, kCap);
    int tn = overlap_tokens(t.data[1] + t.offsets[1][i],
                            t.offsets[1][i + 1] - t.offsets[1][i], sep,
                            tt, tl, kCap);
    if (qn < 0 || tn < 0) {
      t.status = -1;  // token overflow: python fallback
      return;
    }
    int inter = 0;
    for (int a = 0; a < qn; ++a) {
      for (int b = 0; b < tn; ++b) {
        if (ql[a] == tl[b] && std::memcmp(qt[a], tt[b], ql[a]) == 0) {
          ++inter;
          break;
        }
      }
    }
    double v = 0.0;
    switch (t.normalizer) {
      case 0: v = inter / static_cast<double>(std::max(qn, 1)); break;
      case 1: v = inter / static_cast<double>(std::max(tn, 1)); break;
      case 2: v = (qn > 0 && inter == qn) ? 1.0 : 0.0; break;
      case 3: v = (qn > 0 && qn == tn && inter == qn) ? 1.0 : 0.0; break;
    }
    if (t.n_bounds > 0) {
      t.out_vals[i] = std::upper_bound(t.boundaries,
                                       t.boundaries + t.n_bounds, v) -
                      t.boundaries;
      t.out_lengths[i] = 1;
    } else {
      t.out_fvals[i] = static_cast<float>(v);
    }
  }
  t.out_total = t.n_rows;
}

// Parse "k:v<sep>k:v" into up to `cap` DISTINCT keys; python-dict
// semantics: a later duplicate key REPLACES the earlier value; pairs
// whose value part does not parse as a full float are skipped (the
// python comprehension's `if v` filter for empty values; unparseable
// values are skipped rather than raised). Returns count or -1 on
// overflow.
inline int kv_pairs(const char* s, int64_t len, char sep, const char** key,
                    int64_t* key_len, double* val, int cap) {
  int n = 0;
  const char* p = s;
  const char* end = s + len;
  while (p <= end) {
    const char* next = static_cast<const char*>(
        p < end ? memchr(p, sep, end - p) : nullptr);
    const char* pair_end = next ? next : end;
    const char* colon = static_cast<const char*>(
        p < pair_end ? memchr(p, ':', pair_end - p) : nullptr);
    if (colon && pair_end - colon > 1) {
      char buf[64];
      int64_t vl = pair_end - colon - 1;
      if (vl > 63) return -2;  // parity unknown: python fallback
      {
        // python float() parity guard: bail to the python path on any
        // value char outside plain decimal/scientific notation (hex
        // floats, underscores, whitespace, inf/nan all behave
        // differently between strtod and float())
        for (int64_t q = 0; q < vl; ++q) {
          char ch = colon[1 + q];
          if (!((ch >= '0' && ch <= '9') || ch == '+' || ch == '-' ||
                ch == '.' || ch == 'e' || ch == 'E'))
            return -2;
        }
        std::memcpy(buf, colon + 1, vl);
        buf[vl] = '\0';
        char* e = nullptr;
        double v = strtod(buf, &e);
        if (e == buf + vl) {
          int64_t kl = colon - p;
          bool dup = false;
          for (int j = 0; j < n; ++j) {
            if (key_len[j] == kl && std::memcmp(key[j], p, kl) == 0) {
              val[j] = v;  // last duplicate key wins
              dup = true;
              break;
            }
          }
          if (!dup) {
            if (n >= cap) return -1;
            key[n] = p;
            key_len[n] = kl;
            val[n] = v;
            ++n;
          }
        }
      }
    }
    if (!next) break;
    p = next + 1;
  }
  return n;
}

void run_kv_dot(FgTask& t) {
  // inputs[0]/[1] = kv columns; dot product over the key intersection.
  // Optional boundaries bucketize the value (sparse variant).
  constexpr int kCap = 256;
  const char* k1[kCap];
  int64_t l1[kCap];
  double v1[kCap];
  const char* k2[kCap];
  int64_t l2[kCap];
  double v2[kCap];
  char sep = static_cast<char>(t.sep);
  for (int64_t i = 0; i < t.n_rows; ++i) {
    int n1 = kv_pairs(t.data[0] + t.offsets[0][i],
                      t.offsets[0][i + 1] - t.offsets[0][i], sep,
                      k1, l1, v1, kCap);
    int n2 = kv_pairs(t.data[1] + t.offsets[1][i],
                      t.offsets[1][i + 1] - t.offsets[1][i], sep,
                      k2, l2, v2, kCap);
    if (n1 < 0 || n2 < 0) {
      t.status = -1;  // overflow or parity-unknown value: python fallback
      return;
    }
    double dot = 0.0;
    for (int a = 0; a < n1; ++a) {
      for (int b = 0; b < n2; ++b) {
        if (l1[a] == l2[b] && std::memcmp(k1[a], k2[b], l1[a]) == 0) {
          dot += v1[a] * v2[b];
          break;
        }
      }
    }
    if (t.n_bounds > 0) {
      // the python path stores the dot into a float32 array before
      // bucketizing; round identically so boundary-adjacent values
      // land in the same bucket on both paths
      double dot_f32 = static_cast<double>(static_cast<float>(dot));
      t.out_vals[i] = std::upper_bound(t.boundaries,
                                       t.boundaries + t.n_bounds, dot_f32) -
                      t.boundaries;
      t.out_lengths[i] = 1;
    } else {
      t.out_fvals[i] = static_cast<float>(dot);
    }
  }
  t.out_total = t.n_rows;
}

// Whole-cell token -> id through a SORTED vocab (keys as a string
// blob in inputs[1], ids in aux_vals, miss -> oov_val). Sorted by
// UTF-8 bytes == python str (code point) order, so memcmp bsearch
// reproduces table.get(str(t), oov) exactly. No splitting: the python
// vocab path treats the whole cell as one token.
void run_id_vocab(FgTask& t) {
  const int32_t* ko = t.offsets[1] ? reinterpret_cast<const int32_t*>(
      t.offsets[1]) : nullptr;
  const char* kd = t.data[1];
  int64_t nk = t.n_aux;
  if (!ko || !kd || !t.aux_vals) { t.status = -2; return; }
  for (int64_t i = 0; i < t.n_rows; ++i) {
    const char* tok = t.data[0] + t.offsets[0][i];
    int64_t tl = t.offsets[0][i + 1] - t.offsets[0][i];
    int64_t lo = 0, hi = nk;
    while (lo < hi) {  // lower_bound by (bytes, length)
      int64_t mid = (lo + hi) >> 1;
      const char* k = kd + ko[mid];
      int64_t kl = ko[mid + 1] - ko[mid];
      int c = std::memcmp(k, tok, static_cast<size_t>(std::min(kl, tl)));
      if (c < 0 || (c == 0 && kl < tl)) lo = mid + 1;
      else hi = mid;
    }
    int64_t out = t.oov_val;
    if (lo < nk) {
      const char* k = kd + ko[lo];
      int64_t kl = ko[lo + 1] - ko[lo];
      if (kl == tl && std::memcmp(k, tok, static_cast<size_t>(tl)) == 0)
        out = t.aux_vals[lo];
    }
    t.out_vals[i] = out;
    t.out_lengths[i] = 1;
  }
  t.out_total = t.n_rows;
}

}  // namespace

extern "C" {

// Drain the task array with a worker pool (one task = one feature).
// Returns the number of tasks with non-zero status.
int fg_run_dag(FgTask* tasks, int64_t n_tasks, int threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> errors(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_tasks) return;
      FgTask& t = tasks[i];
      t.status = 0;
      t.out_total = 0;
      switch (t.kind) {
        case FG_TASK_ID_HASH: run_id_hash(t); break;
        case FG_TASK_COMBO_HASH: run_combo_hash(t); break;
        case FG_TASK_RAW: run_raw(t); break;
        case FG_TASK_KV_LOOKUP: run_kv_lookup(t); break;
        case FG_TASK_MATCH_LOOKUP: run_match_lookup(t); break;
        case FG_TASK_OVERLAP: run_overlap(t); break;
        case FG_TASK_KV_DOT: run_kv_dot(t); break;
        case FG_TASK_ID_VOCAB: run_id_vocab(t); break;
        default: t.status = -2;
      }
      if (t.status != 0) errors.fetch_add(1);
    }
  };
  int n_workers = std::max(1, std::min<int>(threads, n_tasks));
  if (n_workers == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int w = 0; w < n_workers; ++w) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return errors.load();
}

}  // extern "C"

// Sequence id pipeline: split rows on `seq_delim` into steps, each step
// on `sep` into tokens, FNV-hash each token mod num_buckets.
// Outputs: token ids (out_vals), tokens-per-step (out_lengths, capacity
// max_steps), steps-per-row (out_seq_lengths[n]). Returns total tokens,
// -1 on capacity overflow (python fallback), -2 on step overflow.
extern "C" int64_t fg_seq_split_hash(
    const int32_t* offsets, const char* data, int64_t n, char seq_delim,
    char sep, uint64_t num_buckets, int64_t* out_vals, int64_t max_tokens,
    int32_t* out_lengths, int64_t max_steps, int32_t* out_seq_lengths) {
  int64_t total = 0;
  int64_t step_total = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* begin = data + offsets[i];
    const char* end = data + offsets[i + 1];
    int32_t steps = 0;
    if (begin == end) {
      out_seq_lengths[i] = 0;
      continue;
    }
    const char* step_start = begin;
    for (const char* p = begin; p <= end; ++p) {
      if (p == end || *p == seq_delim) {
        // one step: split tokens on sep
        if (step_total >= max_steps) return -2;
        int32_t count = 0;
        const char* tok = step_start;
        for (const char* q = step_start; q <= p; ++q) {
          if (q == p || *q == sep) {
            if (q > tok) {
              if (total >= max_tokens) return -1;
              uint64_t h = fnv1a(tok, q - tok);
              out_vals[total++] =
                  num_buckets ? static_cast<int64_t>(h % num_buckets)
                              : static_cast<int64_t>(h);
              ++count;
            }
            tok = q + 1;
          }
        }
        if (count == 0) {
          // python's split yields [''] for an empty step: hash it
          if (total >= max_tokens) return -1;
          uint64_t h = fnv1a(step_start, 0);
          out_vals[total++] =
              num_buckets ? static_cast<int64_t>(h % num_buckets)
                          : static_cast<int64_t>(h);
          count = 1;
        }
        out_lengths[step_total++] = count;
        ++steps;
        step_start = p + 1;
      }
    }
    out_seq_lengths[i] = steps;
  }
  return total;
}
