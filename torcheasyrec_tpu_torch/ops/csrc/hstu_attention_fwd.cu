// HSTU pointwise-SiLU attention, forward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torcheasyrec_tpu/ops/pallas/hstu_attention.py
// `_fwd_kernel` (:114), launched through `pallas_hstu_mha` (:523). It computes
//
//   out[b, i, h, :] = sum_j mask(i, j) * SiLU(alpha * q[b,i,h,:] . k[b,j,h,:])
//                     / scaling_seqlen * v[b, j, h, :]
//
// with fp32 accumulation, the scores cast to v's dtype before the second
// product, and zeros for rows at or past the sample's length. `mask` is the
// whole family of `_mask_block` (:47-102): causal or not, the max_attn_len
// window with its min_full_attn_seq_len escape, the contextual prefix,
// num_targets isolation and Semi-Local Attention (sla_k1 / sla_k2).
//
// What bounds it on the H100: operations. At the DLRM-HSTU serving shapes
// (B=32, N=4017, H=4, D=V=128, bf16, histories of 512..3899 tokens) the two
// products over the unmasked (row, column) pairs are about 210 GFLOP
// against 0.53 GB of q, k, v and out (chip_smoke.py counts both), some 400
// FLOP per byte, above the card's ~295 FLOP/byte balance point.
// Softmax-free attention needs no running max or rescale, so the kernel is a
// plain blockwise accumulation: it keeps the [BQ, BK] score tile in shared
// memory and the [BQ, V] output in registers, so nothing of size N x N ever
// reaches device memory. On an H100 80GB HBM3 at 700 W it ran 2.19 ms
// against a 0.21 ms bound (chip_smoke.py). Not profiled inside the kernel
// yet; the likely limit is the score tile's trip through shared memory and
// the per-element SiLU rather than the tensor cores.
//
// Design (a simple, correct first kernel; wgmma and TMA come later):
// - one thread block of 4 warps per (query tile of 64 rows, head, sample);
//   query tiles run longest-first to even out the tail of the grid;
// - a loop over 64-row key/value tiles bounded by ceil(len / 64), and by
//   causality when no row of the query tile is a contextual row (contextual
//   rows attend every valid column; under SLA every row is causal);
// - bf16: q, k, v tiles reach shared memory by cp.async (16 bytes a thread,
//   rows at or past the length zero-filled, so padding never meets the
//   products); the k/v tiles are double-buffered, the next one loading while
//   the tensor cores work on this one. S = Q K^T and O += P V run through
//   WMMA 16x16x16 bf16 fragments with fp32 accumulators; warp w owns query
//   rows [16w, 16w + 16), so between tile loads the warps need no barrier;
// - a tile whose every column lies before every row, in the history and
//   within the length is wholly unmasked under the plain causal mask and
//   skips the per-element mask;
// - fp32: the same tiles with fp32 FMAs on the CUDA cores (no TF32), so the
//   fp32 result holds to the plain version's precision;
// - SiLU, alpha, 1/scaling_seqlen and the mask (a __device__ copy of
//   `_mask_block`) are applied to the fp32 scores before the cast to v's type.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (torcheasyrec_tpu_torch/ops/cuda_build.py). The launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hstu_attention_common.cuh"

namespace {

using namespace hstu;

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key/value rows per tile
constexpr int NUM_THREADS = 128;  // 4 warps

// Number of key/value tiles the query tile starting at q0 must visit.
__device__ __forceinline__ int kv_tiles(int q0, int seq_len,
                                        const MaskParams& p) {
  int end = (seq_len + BK - 1) / BK;
  const bool sla = p.sla_k1 > 0 || p.sla_k2 > 0;
  if (sla || (p.causal && q0 >= p.contextual_seq_len)) {
    const int last_row = min(q0 + BQ, seq_len) - 1;
    end = min(end, last_row / BK + 1);
  }
  return end;
}

// ---------------------------------------------------------------------------
// bf16: WMMA tensor-core tiles
// ---------------------------------------------------------------------------

template <int D, int V>
struct Bf16Smem {
  static constexpr int LDQ = D + 8, LDK = D + 8, LDV = V + 8;
  static constexpr int LDS = BK + 4, LDP = BK + 8, LDO = V + 4;
  static constexpr int Q_BYTES = align128(BQ * LDQ * 2);
  static constexpr int S_BYTES = align128(BQ * LDS * 4);
  static constexpr int K_BYTES = align128(BK * LDK * 2);
  static constexpr int V_BYTES = align128(BK * LDV * 2);
  // the q tile is read once into registers; the score tile reuses it
  static constexpr int Q_OFF = 0, S_OFF = 0;
  static constexpr int P_OFF = Q_BYTES > S_BYTES ? Q_BYTES : S_BYTES;
  static constexpr int KV_OFF = P_OFF + align128(BQ * LDP * 2);
  static constexpr int KV_STAGE = K_BYTES + V_BYTES;  // two stages
  static constexpr int END = KV_OFF + 2 * KV_STAGE;
  // the fp32 output tile reuses the buffer from offset 0 after the loop
  static constexpr int O_BYTES = BQ * LDO * 4;
  static constexpr int BYTES = END > O_BYTES ? END : O_BYTES;
};

template <int D, int V>
__global__ void __launch_bounds__(NUM_THREADS)
hstu_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              const int* __restrict__ lengths,
              const int* __restrict__ num_targets, int n, int h_count,
              float alpha, float inv_scale, MaskParams p) {
  using namespace nvcuda;
  using L = Bf16Smem<D, V>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* os = reinterpret_cast<float*>(smem);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int seq_len = min(lengths[b], n);
  const int n_t = p.has_targets ? num_targets[b] : 0;
  const size_t head = (size_t)b * n * h_count + h;
  const int qk_stride = h_count * D, v_stride = h_count * V;
  const bf16* q_base = q + head * D;
  const bf16* k_base = k + head * D;
  const bf16* v_base = v + head * V;
  bf16* o_base = out + head * V;

  if (q0 >= seq_len) {
    zero_rows<NUM_THREADS, BQ, bf16, V>(o_base, v_stride, q0, n);
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // this warp's first row inside the tile
  auto k_stage = [&](int stage) {
    return reinterpret_cast<bf16*>(smem + L::KV_OFF + stage * L::KV_STAGE);
  };
  auto v_stage = [&](int stage) {
    return reinterpret_cast<bf16*>(smem + L::KV_OFF + stage * L::KV_STAGE +
                                   L::K_BYTES);
  };
  const int n_kv = kv_tiles(q0, seq_len, p);

  load_tile_async<NUM_THREADS, BQ, D>(qs, L::LDQ, q_base, qk_stride, q0, seq_len);
  load_tile_async<NUM_THREADS, BK, D>(k_stage(0), L::LDK, k_base, qk_stride, 0, seq_len);
  load_tile_async<NUM_THREADS, BK, V>(v_stage(0), L::LDV, v_base, v_stride, 0, seq_len);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], qs + wrow * L::LDQ + kk * 16, L::LDQ);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[V / 16];
#pragma unroll
  for (int nb = 0; nb < V / 16; ++nb) wmma::fill_fragment(acc[nb], 0.0f);
  __syncthreads();  // the score tile overwrites the q tile

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    const bf16* ks = k_stage(kt & 1);
    const bf16* vs = v_stage(kt & 1);
    if (kt + 1 < n_kv) {  // prefetch the next tile into the other stage
      load_tile_async<NUM_THREADS, BK, D>(k_stage((kt + 1) & 1), L::LDK, k_base,
                             qk_stride, k0 + BK, seq_len);
      load_tile_async<NUM_THREADS, BK, V>(v_stage((kt + 1) & 1), L::LDV, v_base,
                             v_stride, k0 + BK, seq_len);
      cp_async_commit();
    }

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int nb = 0; nb < BK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + nb * 16 * L::LDK + kk * 16, L::LDK);
        wmma::mma_sync(s, qa[kk], kb, s);
      }
      wmma::store_matrix_sync(ss + wrow * L::LDS + nb * 16, s, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // P = mask * SiLU(alpha * S) / scale, cast to v's type; each lane
    // takes two neighbouring columns of a row
    const bool unmasked = tile_unmasked(q0, k0, BQ, BK, seq_len, n_t, p);
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int c = 2 * lane;
      const float2 sv =
          *reinterpret_cast<const float2*>(ss + (wrow + r) * L::LDS + c);
      float v0 = silu_fast(sv.x * alpha) * inv_scale;
      float v1 = silu_fast(sv.y * alpha) * inv_scale;
      if (!unmasked) {
        const int row = q0 + wrow + r, col = k0 + c;
        if (!valid_attn(row, col, seq_len, n_t, p)) v0 = 0.0f;
        if (!valid_attn(row, col + 1, seq_len, n_t, p)) v1 = 0.0f;
      }
      *reinterpret_cast<__nv_bfloat162*>(ps + (wrow + r) * L::LDP + c) =
          __floats2bfloat162_rn(v0, v1);
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, ps + wrow * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int nb = 0; nb < V / 16; ++nb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kk * 16 * L::LDV + nb * 16, L::LDV);
        wmma::mma_sync(acc[nb], pa, vb, acc[nb]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // next stage landed; every warp is done with this one
  }

#pragma unroll
  for (int nb = 0; nb < V / 16; ++nb) {
    wmma::store_matrix_sync(os + wrow * L::LDO + nb * 16, acc[nb], L::LDO,
                            wmma::mem_row_major);
  }
  __syncwarp();
  constexpr int PER_ROW = V / 8;
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const int row = q0 + wrow + r;
    if (row >= n) continue;
    const float* src = os + (wrow + r) * L::LDO + c;
    __align__(16) bf16 packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16(src[e]);
    *reinterpret_cast<uint4*>(o_base + (size_t)row * v_stride + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

template <int D, int V>
struct F32Smem {
  // odd leading dimensions keep the column-wise reads free of bank conflicts
  static constexpr int LDQ = D + 1, LDK = D + 1, LDV = V, LDP = BK + 1;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + align128(BQ * LDQ * 4);
  static constexpr int V_OFF = K_OFF + align128(BK * LDK * 4);
  static constexpr int P_OFF = V_OFF + align128(BK * LDV * 4);
  static constexpr int BYTES = P_OFF + align128(BQ * LDP * 4);
};

template <int D, int V>
__global__ void __launch_bounds__(NUM_THREADS)
hstu_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             const int* __restrict__ lengths,
             const int* __restrict__ num_targets, int n, int h_count,
             float alpha, float inv_scale, MaskParams p) {
  using L = F32Smem<D, V>;
  constexpr int VC = V / 8;  // output columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* ks = reinterpret_cast<float*>(smem + L::K_OFF);
  float* vs = reinterpret_cast<float*>(smem + L::V_OFF);
  float* ps = reinterpret_cast<float*>(smem + L::P_OFF);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int seq_len = min(lengths[b], n);
  const int n_t = p.has_targets ? num_targets[b] : 0;
  const size_t head = (size_t)b * n * h_count + h;
  const int qk_stride = h_count * D, v_stride = h_count * V;
  const float* q_base = q + head * D;
  const float* k_base = k + head * D;
  const float* v_base = v + head * V;
  float* o_base = out + head * V;

  if (q0 >= seq_len) {
    zero_rows<NUM_THREADS, BQ, float, V>(o_base, v_stride, q0, n);
    return;
  }

  // thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx + 8*j
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;

  load_tile<NUM_THREADS, float, BQ, D>(qs, L::LDQ, q_base, qk_stride, q0, seq_len);

  float acc[4][VC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[i][c] = 0.0f;

  const int n_kv = kv_tiles(q0, seq_len, p);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<NUM_THREADS, float, BK, D>(ks, L::LDK, k_base, qk_stride, k0, seq_len);
    load_tile<NUM_THREADS, float, BK, V>(vs, L::LDV, v_base, v_stride, k0, seq_len);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * L::LDQ + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = ks[(tx + 8 * j) * L::LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = ty * 4 + i, c = tx + 8 * j;
        float val = 0.0f;
        if (valid_attn(q0 + r, k0 + c, seq_len, n_t, p)) {
          val = silu(s[i][j] * alpha) * inv_scale;
        }
        ps[r * L::LDP + c] = val;
      }
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * L::LDP + j];
#pragma unroll
      for (int c = 0; c < VC; ++c) {
        const float vv = vs[j * L::LDV + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < VC; ++c) {
      o_base[(size_t)row * v_stride + tx + 8 * c] = acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  const int *lengths, *num_targets;
  int b, n, h;
  float alpha, inv_scale;
  MaskParams p;
  cudaStream_t stream;
};

template <int D, int V>
cudaError_t launch_dv(int is_bf16, const Args& a) {
  const dim3 grid((a.n + BQ - 1) / BQ, a.h, a.b);
  if (is_bf16) {
    auto kern = hstu_fwd_bf16<D, V>;
    constexpr int smem_bytes = Bf16Smem<D, V>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    kern<<<grid, NUM_THREADS, smem_bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lengths,
        a.num_targets, a.n, a.h, a.alpha, a.inv_scale, a.p);
  } else {
    auto kern = hstu_fwd_f32<D, V>;
    constexpr int smem_bytes = F32Smem<D, V>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    kern<<<grid, NUM_THREADS, smem_bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out),
        a.lengths, a.num_targets, a.n, a.h, a.alpha, a.inv_scale, a.p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int v_dim, int is_bf16, const Args& a) {
  switch (v_dim) {
    case 32: return launch_dv<D, 32>(is_bf16, a);
    case 64: return launch_dv<D, 64>(is_bf16, a);
    case 128: return launch_dv<D, 128>(is_bf16, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int hstu_attention_fwd(
    const void* q, const void* k, const void* v, void* out,
    const int* lengths, const int* num_targets, int b, int n, int h, int d,
    int v_dim, int is_bf16, float alpha, float inv_scale, int causal,
    int max_attn_len, int contextual_seq_len, int min_full_attn_seq_len,
    int sla_k1, int sla_k2, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0) return (int)cudaSuccess;
  Args a{q, k, v, out, lengths, num_targets, b, n, h, alpha, inv_scale,
         MaskParams{causal, num_targets != nullptr, max_attn_len,
                    contextual_seq_len, min_full_attn_seq_len, sla_k1,
                    sla_k2},
         static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 32: return (int)launch_d<32>(v_dim, is_bf16, a);
    case 64: return (int)launch_d<64>(v_dim, is_bf16, a);
    case 128: return (int)launch_d<128>(v_dim, is_bf16, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hstu_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
