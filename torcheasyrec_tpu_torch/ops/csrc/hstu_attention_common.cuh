// Shared device code of the HSTU attention kernels (forward and backward):
// the mask family of the Pallas kernels' `_mask_block`
// (torcheasyrec_tpu/ops/pallas/hstu_attention.py:47-102), SiLU, and the
// global -> shared tile loads. NT is the block's thread count.

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

// 16-byte global -> shared copy that bypasses registers; src_bytes 0 fills
// the destination with zeros.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Asynchronous counterpart of load_tile for bf16 tiles (ld a multiple of 8).
template <int NT, int R, int COLS>
__device__ __forceinline__ void load_tile_async(bf16* smem, int ld,
                                                const bf16* base,
                                                int row_stride, int r0,
                                                int rows_valid) {
  constexpr int PER_ROW = COLS / 8;
  constexpr int ITERS = R * PER_ROW / NT;
  static_assert(R * PER_ROW % NT == 0, "tile does not divide over the block");
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool valid = r0 + r < rows_valid;
    cp_async_16(smem + r * ld + c,
                base + (size_t)(valid ? r0 + r : 0) * row_stride + c, valid);
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
