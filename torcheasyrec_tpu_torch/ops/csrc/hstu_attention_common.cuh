// Shared device code of the HSTU attention kernels (forward and backward):
// the mask family of the Pallas kernels' `_mask_block`
// (torcheasyrec_tpu/ops/pallas/hstu_attention.py:47-102), the tile
// schedules that take the Pallas kernels' loop bounds (:128-198 forward,
// :229-321 backward), SiLU, and the fp32 kernels' tile loads. NT is the
// block's thread count.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hstu {

using bf16 = __nv_bfloat16;

struct MaskParams {
  int causal;
  int has_targets;
  int max_attn_len;
  int contextual_seq_len;
  int min_full_attn_seq_len;
  int sla_k1;
  int sla_k2;
};

// _mask_block of the Pallas kernel, one element at a time.
__device__ __forceinline__ bool valid_attn(int row, int col, int seq_len,
                                           int n_t, const MaskParams& p) {
  if (row >= seq_len || col >= seq_len) return false;
  if (p.sla_k1 > 0 || p.sla_k2 > 0) {
    const int eff_k2 = max(p.sla_k2, p.contextual_seq_len);
    const int h_bound = seq_len - n_t;
    const bool hist = (col < min(eff_k2, row + 1)) ||
                      (col >= max(eff_k2, row - p.sla_k1 + 1) && col <= row);
    return row < h_bound ? hist : (col < h_bound);
  }
  int ids_r = row, ids_c = col, max_ids = seq_len;
  if (p.contextual_seq_len > 0) {
    ids_r = max(ids_r - p.contextual_seq_len + 1, 0);
    ids_c = max(ids_c - p.contextual_seq_len + 1, 0);
    max_ids = max_ids - p.contextual_seq_len + 1;
  }
  if (p.has_targets) {
    max_ids -= n_t;
    ids_r = min(ids_r, max_ids);
    ids_c = min(ids_c, max_ids);
  }
  int dist = ids_r - ids_c;
  if (!p.causal) dist = abs(dist);
  bool m = (row == col) || dist > 0;
  if (p.max_attn_len > 0) {
    if (p.min_full_attn_seq_len > 0) {
      m = m && (dist <= p.max_attn_len ||
                ids_r >= max_ids - p.min_full_attn_seq_len);
    } else {
      m = m && dist <= p.max_attn_len;
    }
  }
  if (p.contextual_seq_len > 0) m = m || (ids_r == 0 && ids_c < max_ids);
  return m;
}

// True when the [rows, cols] tile starting at (q0, k0) is wholly unmasked
// under the plain causal mask (no SLA, no window): every column lies before
// every row and in the history (before the targets), and every row is
// within the length. Holds with or without a contextual prefix or targets
// (see `valid_attn`).
__device__ __forceinline__ bool tile_unmasked(int q0, int k0, int bq, int bk,
                                              int seq_len, int n_t,
                                              const MaskParams& p) {
  return p.causal && p.max_attn_len == 0 && p.sla_k1 == 0 && p.sla_k2 == 0 &&
         k0 + bk <= q0 && k0 + bk <= seq_len - n_t && q0 + bq <= seq_len;
}

// The tiles a loop visits: [lo0, hi0) then [lo1, hi1), empty ranges
// skipped.
struct TileRanges {
  int lo0, hi0, lo1, hi1;
  __device__ __forceinline__ int count() const {
    return max(hi0 - lo0, 0) + max(hi1 - lo1, 0);
  }
  __device__ __forceinline__ int tile(int i) const {
    const int n0 = max(hi0 - lo0, 0);
    return i < n0 ? lo0 + i : lo1 + (i - n0);
  }
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Key tiles of BK rows that the query tile [q0, q0 + BQ) must visit, the
// bounds of `_fwd_kernel`: none past the length; under causality none past
// the tile's last row unless it holds contextual rows (they attend every
// column; under SLA they are history rows). Under SLA the prefix tiles,
// then the window from the tile's first row back k1 - 1 columns, or every
// causal tile when the query tile holds target rows.
template <int BQ, int BK>
__device__ __forceinline__ TileRanges kv_schedule(int q0, int seq_len,
                                                  int n_t,
                                                  const MaskParams& p) {
  int end = (seq_len + BK - 1) / BK;
  const bool sla = p.sla_k1 > 0 || p.sla_k2 > 0;
  if (sla || (p.causal && q0 >= p.contextual_seq_len)) {
    const int last_row = min(q0 + BQ, seq_len) - 1;
    end = min(end, last_row / BK + 1);
  }
  if (!sla) return TileRanges{0, end, 0, 0};
  const int eff_k2 = max(p.sla_k2, p.contextual_seq_len);
  const int n_pref = min((eff_k2 + BK - 1) / BK, end);
  int start = max(floor_div(q0 - p.sla_k1 + 1, BK), n_pref);
  if (q0 + BQ > seq_len - n_t) start = n_pref;
  return TileRanges{0, n_pref, start, end};
}

// Query tiles of BQ rows that can attend the key tile [k0, k0 + BK), the
// bounds of `_bwd_dv_dk_kernel`: none past the length; under causality
// from the tile holding row k0 on, plus the tiles of the contextual rows.
// Under SLA the window (rows within k1 - 1 of the columns; every row when
// a column lies in the prefix), then the tiles of the target rows (they
// attend all history).
template <int BQ, int BK>
__device__ __forceinline__ TileRanges q_schedule(int k0, int seq_len, int n_t,
                                                 const MaskParams& p) {
  const int end = (seq_len + BQ - 1) / BQ;
  const bool sla = p.sla_k1 > 0 || p.sla_k2 > 0;
  if (!sla && !p.causal) return TileRanges{0, end, 0, 0};
  const int first = min(k0 / BQ, end);
  if (!sla) {
    const int n_pre = p.contextual_seq_len > 0
                          ? min((p.contextual_seq_len + BQ - 1) / BQ, first)
                          : 0;
    return TileRanges{0, n_pre, first, end};
  }
  const int eff_k2 = max(p.sla_k2, p.contextual_seq_len);
  const int win_end =
      k0 < eff_k2 ? end : min((k0 + BK - 1 + p.sla_k1) / BQ + 1, end);
  const int tgt_start = max(floor_div(seq_len - n_t, BQ), win_end);
  return TileRanges{first, win_end, tgt_start, end};
}

// The sample of rank `rank` among the batch ordered by length, longest
// first (ties by index), so that blocks taken in rank order start the
// longest samples first. Batches of more than 256 samples keep their
// order. Every thread of the block calls it.
__device__ __forceinline__ int sample_of_rank(const int* lengths, int b_count,
                                              int rank, int n) {
  if (b_count > 256) return rank;
  __shared__ int found;
  for (int i = threadIdx.x; i < b_count; i += blockDim.x) {
    const int li = min(lengths[i], n);
    int r = 0;
    for (int j = 0; j < b_count; ++j) {
      const int lj = min(lengths[j], n);
      r += lj > li || (lj == li && j < i);
    }
    if (r == rank) found = i;
  }
  __syncthreads();
  return found;
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// SiLU with the fast exp and division: bf16 keeps far fewer bits than
// these lose.
__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// Copy rows [r0, r0 + R) x COLS of a [N, H, COLS] head slice into shared
// memory with leading dimension ld; rows at or past `rows_valid` read as 0.
template <int NT, typename T, int R, int COLS>
__device__ __forceinline__ void load_tile(T* smem, int ld, const T* base,
                                          int row_stride, int r0,
                                          int rows_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VEC;
  constexpr int ITERS = R * PER_ROW / NT;
  static_assert(R * PER_ROW % NT == 0, "tile does not divide over the block");
  uint4 vals[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {  // all loads in flight at once
    const int i = threadIdx.x + it * NT;
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    vals[it] = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows_valid) {
      vals[it] = *reinterpret_cast<const uint4*>(
          base + (size_t)(r0 + r) * row_stride + c);
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const T* src = reinterpret_cast<const T*>(&vals[it]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) smem[r * ld + c + e] = src[e];
  }
}

// Rows [r0, min(r0 + ROWS, n)) x COLS of a [N, H, COLS] head slice are
// written as zeros.
template <int NT, int ROWS, typename T, int COLS>
__device__ __forceinline__ void zero_rows(T* base, int row_stride, int r0,
                                          int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VEC;
  const int rows = min(ROWS, n - r0);
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(base + (size_t)(r0 + r) * row_stride + c) =
        make_uint4(0, 0, 0, 0);
  }
}

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace hstu
