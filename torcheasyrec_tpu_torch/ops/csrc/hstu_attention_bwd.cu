// HSTU pointwise-SiLU attention, fused backward, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel torcheasyrec_tpu/ops/pallas/hstu_attention.py
// `_bwd_dv_dk_kernel` (:207), launched from the custom VJP `_bwd_rule` (:444).
// With z = alpha * q k^T, s = mask * SiLU(z) / scaling_seqlen and the upstream
// gradient do of out = s v, it computes
//
//   dv = s^T do
//   dz = mask * (do v^T) * SiLU'(z) * alpha / scaling_seqlen,
//        SiLU'(z) = sigma(z) (1 + z (1 - sigma(z)))
//   dk = dz^T q
//   dq = dz k
//
// with fp32 sums and s, dz cast to the inputs' type before the second
// products, for the whole mask family of `_mask_block` (:47-102). Nothing of
// size N x N reaches device memory: the forward saved q, k, v only, and the
// scores are recomputed tile by tile.
//
// What bounds it on the H100: operations. Five products over the unmasked
// (row, column) pairs, 2 * pairs * H * (3 D + 2 V) FLOP, against q, k, v, do
// read and dq, dk, dv written once (chip_smoke.py counts both for its run).
// At the DLRM-HSTU training shapes (B=32, N=4017, H=4, D=V=128, bf16,
// histories of 512..3899 tokens) that is about 526 GFLOP against 0.92 GB.
// On an H100 80GB HBM3 at 700 W it ran 6.9 ms against a 0.53 ms bound
// (chip_smoke.py). Not profiled inside the kernel yet; the likely limits
// are one block per SM (154 KB of shared memory at D=V=128), the score
// tiles' trip through shared memory and the dq atomics.
//
// Design (a simple, correct first kernel; wgmma and TMA come later):
// - one thread block of 8 warps per (key tile of 64 rows, head, sample). The
//   block keeps its k and v tiles in shared memory and its dk and dv sums in
//   registers for the whole loop, and walks the query tiles that can attend
//   its columns: tiles from the diagonal on under causality, plus the tiles
//   that hold contextual rows (they attend every column), up to
//   ceil(len / 64). Key tiles at or past the length write zeros.
// - dq: the Pallas kernel walks one (sample, head)'s key blocks in order and
//   adds into a [N, D] fp32 block resident in VMEM. CUDA blocks run in no
//   order, so each block adds its [64, D] dq tiles into a zeroed fp32
//   [B, N, H, D] buffer with 16-byte vector atomics (red.global.add.v4.f32);
//   the wrapper casts that buffer to q's type afterwards, as the Pallas
//   wrapper does (:504). Five products instead of the seven a separate dq
//   pass needs; the price is that dq's sums are taken in an order that
//   changes from run to run (fp32, so the spread is a few ulp).
// - bf16: q and do tiles arrive by cp.async into two stages (rows at or past
//   the length zero-filled, so padded rows of do never meet the products),
//   the next tile loading while this one is worked on. Phase A: warp
//   (wr, wc) computes rows [16 wr, +16) x columns [32 wc, +32) of z and of
//   do v^T with WMMA 16x16x16 bf16 fragments, applies SiLU, its derivative,
//   the scale and the mask in fp32, and leaves s and dz as bf16 in shared
//   memory. Phase B (after one barrier): the warp adds s^T do and dz^T q into
//   its [16 key rows, half of V / D] share of dv and dk, and computes its
//   [16 query rows, half of D] share of dz k for the atomics.
// - fp32: the same tiles with fp32 FMAs on the CUDA cores (no TF32) and the
//   exact expf, so the fp32 result holds to the plain version's precision.
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

constexpr int BQ = 64;            // query rows per step of the loop
constexpr int BK = 64;            // key/value rows per block
constexpr int NUM_THREADS = 256;  // 8 warps

// The query tiles a key tile must visit, as a sequence of tile indices:
// `n_pre` contextual tiles [0, n_pre), then [first, end).
struct QTiles {
  int n_pre, first, end;
  __device__ __forceinline__ int count() const {
    return n_pre + max(end - first, 0);
  }
  __device__ __forceinline__ int tile(int i) const {
    return i < n_pre ? i : first + (i - n_pre);
  }
};

__device__ __forceinline__ QTiles q_tiles(int kt, int seq_len,
                                          const MaskParams& p) {
  QTiles t;
  t.end = (seq_len + BQ - 1) / BQ;
  t.n_pre = 0;
  t.first = 0;
  const bool sla = p.sla_k1 > 0 || p.sla_k2 > 0;
  if (sla || p.causal) {
    // rows before this tile's first column cannot attend it, except the
    // contextual rows of the plain mask (under SLA they are history rows)
    t.first = kt;  // BQ == BK
    if (!sla && p.contextual_seq_len > 0) {
      t.n_pre = min((p.contextual_seq_len + BQ - 1) / BQ, kt);
    }
  }
  return t;
}

// SiLU(z) and SiLU'(z) from one sigmoid.
template <bool FAST>
__device__ __forceinline__ void silu_and_grad(float z, float* s, float* ds) {
  const float sig = FAST ? __fdividef(1.0f, 1.0f + __expf(-z))
                         : 1.0f / (1.0f + expf(-z));
  *s = z * sig;
  *ds = sig * (1.0f + z * (1.0f - sig));
}

// ---------------------------------------------------------------------------
// bf16: WMMA tensor-core tiles
// ---------------------------------------------------------------------------

template <int D, int V>
struct Bf16Smem {
  static constexpr int LDQ = D + 8, LDK = D + 8, LDV = V + 8;
  static constexpr int LDS = BK + 4, LDP = BK + 8;
  static constexpr int LDOV = V + 4, LDOK = D + 4;
  static constexpr int K_BYTES = align128(BK * LDK * 2);
  static constexpr int V_BYTES = align128(BK * LDV * 2);
  static constexpr int Q_BYTES = align128(BQ * LDQ * 2);
  static constexpr int DO_BYTES = align128(BQ * LDV * 2);
  static constexpr int S_BYTES = align128(BQ * LDS * 4);
  static constexpr int P_BYTES = align128(BQ * LDP * 2);
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + K_BYTES;
  static constexpr int REST_OFF = V_OFF + V_BYTES;
  // inside the loop: two (q, do) stages, fp32 z and do v^T, bf16 s and dz
  static constexpr int STAGE = Q_BYTES + DO_BYTES;
  static constexpr int S_OFF = REST_OFF + 2 * STAGE;
  static constexpr int DA_OFF = S_OFF + S_BYTES;
  static constexpr int P_OFF = DA_OFF + S_BYTES;
  static constexpr int DZ_OFF = P_OFF + P_BYTES;
  static constexpr int LOOP_END = DZ_OFF + P_BYTES;
  // after the loop: the fp32 dv and dk tiles on their way out
  static constexpr int DV_OFF = REST_OFF;
  static constexpr int DK_OFF = DV_OFF + align128(BK * LDOV * 4);
  static constexpr int OUT_END = DK_OFF + align128(BK * LDOK * 4);
  static constexpr int BYTES = LOOP_END > OUT_END ? LOOP_END : OUT_END;
};

// fp32 [64, COLS] tile in shared memory -> bf16 rows [r0, r0 + 64) of a
// [N, H, COLS] head slice, rows at or past n left alone.
template <int COLS>
__device__ __forceinline__ void store_tile_bf16(bf16* base, int row_stride,
                                                int r0, int n,
                                                const float* tile, int ld) {
  constexpr int PER_ROW = COLS / 8;
  for (int i = threadIdx.x; i < BK * PER_ROW; i += NUM_THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    if (r0 + r >= n) continue;
    const float* src = tile + r * ld + c;
    __align__(16) bf16 packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16(src[e]);
    *reinterpret_cast<uint4*>(base + (size_t)(r0 + r) * row_stride + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

template <int D, int V>
__global__ void __launch_bounds__(NUM_THREADS)
hstu_bwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ d_out,
              float* __restrict__ dq, bf16* __restrict__ dk,
              bf16* __restrict__ dv, const int* __restrict__ lengths,
              const int* __restrict__ num_targets, int n, int h_count,
              float alpha, float inv_scale, MaskParams p) {
  using namespace nvcuda;
  using L = Bf16Smem<D, V>;
  constexpr int DH = D / 2, VH = V / 2;  // this warp's share of the columns
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* das = reinterpret_cast<float*>(smem + L::DA_OFF);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  bf16* dzs = reinterpret_cast<bf16*>(smem + L::DZ_OFF);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int seq_len = min(lengths[b], n);
  const int n_t = p.has_targets ? num_targets[b] : 0;
  const size_t head = (size_t)b * n * h_count + h;
  const int qk_stride = h_count * D, v_stride = h_count * V;
  const bf16* q_base = q + head * D;
  const bf16* k_base = k + head * D;
  const bf16* v_base = v + head * V;
  const bf16* do_base = d_out + head * V;
  float* dq_base = dq + head * D;
  bf16* dk_base = dk + head * D;
  bf16* dv_base = dv + head * V;

  if (k0 >= seq_len) {
    zero_rows<NUM_THREADS, BK, bf16, D>(dk_base, qk_stride, k0, n);
    zero_rows<NUM_THREADS, BK, bf16, V>(dv_base, v_stride, k0, n);
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = (warp & 3) * 16;  // this warp's 16 rows inside a tile
  const int wc = warp >> 2;          // and its half of the columns
  auto q_stage = [&](int stage) {
    return reinterpret_cast<bf16*>(smem + L::REST_OFF + stage * L::STAGE);
  };
  auto do_stage = [&](int stage) {
    return reinterpret_cast<bf16*>(smem + L::REST_OFF + stage * L::STAGE +
                                   L::Q_BYTES);
  };
  const QTiles tiles = q_tiles(kt, seq_len, p);
  const int n_q = tiles.count();

  load_tile_async<NUM_THREADS, BK, D>(ks, L::LDK, k_base, qk_stride, k0,
                                      seq_len);
  load_tile_async<NUM_THREADS, BK, V>(vs, L::LDV, v_base, v_stride, k0,
                                      seq_len);
  load_tile_async<NUM_THREADS, BQ, D>(q_stage(0), L::LDQ, q_base, qk_stride,
                                      tiles.tile(0) * BQ, seq_len);
  load_tile_async<NUM_THREADS, BQ, V>(do_stage(0), L::LDV, do_base, v_stride,
                                      tiles.tile(0) * BQ, seq_len);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv_acc[VH / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[DH / 16];
#pragma unroll
  for (int f = 0; f < VH / 16; ++f) wmma::fill_fragment(dv_acc[f], 0.0f);
#pragma unroll
  for (int f = 0; f < DH / 16; ++f) wmma::fill_fragment(dk_acc[f], 0.0f);
  const float dz_scale = alpha * inv_scale;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = tiles.tile(it) * BQ;
    const bf16* qs = q_stage(it & 1);
    const bf16* dos = do_stage(it & 1);
    if (it + 1 < n_q) {  // prefetch the next tile into the other stage
      const int q_next = tiles.tile(it + 1) * BQ;
      load_tile_async<NUM_THREADS, BQ, D>(q_stage((it + 1) & 1), L::LDQ,
                                          q_base, qk_stride, q_next, seq_len);
      load_tile_async<NUM_THREADS, BQ, V>(do_stage((it + 1) & 1), L::LDV,
                                          do_base, v_stride, q_next, seq_len);
      cp_async_commit();
    }

    // ---- phase A: z = q k^T and da = do v^T for this warp's 16 x 32 ----
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int col = wc * 32 + nb * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> z, da;
      wmma::fill_fragment(z, 0.0f);
      wmma::fill_fragment(da, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, qs + wrow * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(bk, ks + col * L::LDK + kk * 16, L::LDK);
        wmma::mma_sync(z, a, bk, z);
      }
#pragma unroll
      for (int kk = 0; kk < V / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bv;
        wmma::load_matrix_sync(a, dos + wrow * L::LDV + kk * 16, L::LDV);
        wmma::load_matrix_sync(bv, vs + col * L::LDV + kk * 16, L::LDV);
        wmma::mma_sync(da, a, bv, da);
      }
      wmma::store_matrix_sync(ss + wrow * L::LDS + col, z, L::LDS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(das + wrow * L::LDS + col, da, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // s = mask * SiLU(z) / scale and dz = mask * da * SiLU'(z) * alpha /
    // scale, cast to the inputs' type; each lane takes one column
    const bool unmasked = tile_unmasked(q0, k0, BQ, BK, seq_len, n_t, p);
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int c = wc * 32 + lane;
      float s_val, ds_val;
      silu_and_grad<true>(ss[(wrow + r) * L::LDS + c] * alpha, &s_val,
                          &ds_val);
      s_val *= inv_scale;
      float dz_val = das[(wrow + r) * L::LDS + c] * ds_val * dz_scale;
      if (!unmasked && !valid_attn(q0 + wrow + r, k0 + c, seq_len, n_t, p)) {
        s_val = 0.0f;
        dz_val = 0.0f;
      }
      ps[(wrow + r) * L::LDP + c] = __float2bfloat16(s_val);
      dzs[(wrow + r) * L::LDP + c] = __float2bfloat16(dz_val);
    }
    __syncthreads();  // s and dz of all 64 query rows are in place

    // ---- phase B: dv += s^T do, dk += dz^T q over the 64 query rows ----
#pragma unroll
    for (int qq = 0; qq < BQ / 16; ++qq) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> dzt;
      wmma::load_matrix_sync(pt, ps + qq * 16 * L::LDP + wrow, L::LDP);
      wmma::load_matrix_sync(dzt, dzs + qq * 16 * L::LDP + wrow, L::LDP);
#pragma unroll
      for (int f = 0; f < VH / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bo;
        wmma::load_matrix_sync(
            bo, dos + qq * 16 * L::LDV + wc * VH + f * 16, L::LDV);
        wmma::mma_sync(dv_acc[f], pt, bo, dv_acc[f]);
      }
#pragma unroll
      for (int f = 0; f < DH / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bq;
        wmma::load_matrix_sync(
            bq, qs + qq * 16 * L::LDQ + wc * DH + f * 16, L::LDQ);
        wmma::mma_sync(dk_acc[f], dzt, bq, dk_acc[f]);
      }
    }

    // dq tile = dz k: 16 query rows x this warp's half of D, one 16 x 16
    // fragment at a time through the warp's own corner of the z buffer
    float* stage = ss + wrow * L::LDS + wc * 32;
#pragma unroll
    for (int f = 0; f < DH / 16; ++f) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc;
      wmma::fill_fragment(dq_acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(a, dzs + wrow * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(
            bk, ks + kk * 16 * L::LDK + wc * DH + f * 16, L::LDK);
        wmma::mma_sync(dq_acc, a, bk, dq_acc);
      }
      wmma::store_matrix_sync(stage, dq_acc, L::LDS, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = lane + 32 * t;
        const int r = i / 4, c = (i % 4) * 4;
        const int row = q0 + wrow + r;
        if (row < seq_len) {  // rows past the length carry zeros
          const float4 val =
              *reinterpret_cast<const float4*>(stage + r * L::LDS + c);
          atomicAdd(reinterpret_cast<float4*>(
                        dq_base + (size_t)row * qk_stride + wc * DH + f * 16 +
                        c),
                    val);
        }
      }
      __syncwarp();
    }
    cp_async_wait_all();
    __syncthreads();  // next stage landed; every warp is done with this one
  }

  // ---- dv and dk leave through shared memory as bf16 ----
  float* dvs = reinterpret_cast<float*>(smem + L::DV_OFF);
  float* dks = reinterpret_cast<float*>(smem + L::DK_OFF);
#pragma unroll
  for (int f = 0; f < VH / 16; ++f) {
    wmma::store_matrix_sync(dvs + wrow * L::LDOV + wc * VH + f * 16,
                            dv_acc[f], L::LDOV, wmma::mem_row_major);
  }
#pragma unroll
  for (int f = 0; f < DH / 16; ++f) {
    wmma::store_matrix_sync(dks + wrow * L::LDOK + wc * DH + f * 16,
                            dk_acc[f], L::LDOK, wmma::mem_row_major);
  }
  __syncthreads();
  store_tile_bf16<V>(dv_base, v_stride, k0, n, dvs, L::LDOV);
  store_tile_bf16<D>(dk_base, qk_stride, k0, n, dks, L::LDOK);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

template <int D, int V>
struct F32Smem {
  // odd leading dimensions keep the column-wise reads free of bank conflicts
  static constexpr int LDQ = D + 1, LDK = D + 1, LDV = V + 1, LDP = BK + 1;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + align128(BK * LDK * 4);
  static constexpr int Q_OFF = V_OFF + align128(BK * LDV * 4);
  static constexpr int DO_OFF = Q_OFF + align128(BQ * LDQ * 4);
  static constexpr int P_OFF = DO_OFF + align128(BQ * LDV * 4);
  static constexpr int DZ_OFF = P_OFF + align128(BQ * LDP * 4);
  static constexpr int BYTES = DZ_OFF + align128(BQ * LDP * 4);
};

template <int D, int V>
__global__ void __launch_bounds__(NUM_THREADS)
hstu_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ d_out,
             float* __restrict__ dq, float* __restrict__ dk,
             float* __restrict__ dv, const int* __restrict__ lengths,
             const int* __restrict__ num_targets, int n, int h_count,
             float alpha, float inv_scale, MaskParams p) {
  using L = F32Smem<D, V>;
  constexpr int DC = D / 16, VC = V / 16;  // columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + L::K_OFF);
  float* vs = reinterpret_cast<float*>(smem + L::V_OFF);
  float* qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* dos = reinterpret_cast<float*>(smem + L::DO_OFF);
  float* ps = reinterpret_cast<float*>(smem + L::P_OFF);
  float* dzs = reinterpret_cast<float*>(smem + L::DZ_OFF);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int seq_len = min(lengths[b], n);
  const int n_t = p.has_targets ? num_targets[b] : 0;
  const size_t head = (size_t)b * n * h_count + h;
  const int qk_stride = h_count * D, v_stride = h_count * V;
  const float* q_base = q + head * D;
  const float* k_base = k + head * D;
  const float* v_base = v + head * V;
  const float* do_base = d_out + head * V;
  float* dq_base = dq + head * D;
  float* dk_base = dk + head * D;
  float* dv_base = dv + head * V;

  if (k0 >= seq_len) {
    zero_rows<NUM_THREADS, BK, float, D>(dk_base, qk_stride, k0, n);
    zero_rows<NUM_THREADS, BK, float, V>(dv_base, v_stride, k0, n);
    return;
  }

  // thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx + 16*j of
  // whichever [64, *] tile it is working on
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<NUM_THREADS, float, BK, D>(ks, L::LDK, k_base, qk_stride, k0,
                                       seq_len);
  load_tile<NUM_THREADS, float, BK, V>(vs, L::LDV, v_base, v_stride, k0,
                                       seq_len);

  float dv_acc[4][VC], dk_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < VC; ++c) dv_acc[i][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = 0.0f;
  }
  const float dz_scale = alpha * inv_scale;
  const QTiles tiles = q_tiles(kt, seq_len, p);
  const int n_q = tiles.count();

  for (int it = 0; it < n_q; ++it) {
    const int q0 = tiles.tile(it) * BQ;
    __syncthreads();  // the previous step's reads are done
    load_tile<NUM_THREADS, float, BQ, D>(qs, L::LDQ, q_base, qk_stride, q0,
                                         seq_len);
    load_tile<NUM_THREADS, float, BQ, V>(dos, L::LDV, do_base, v_stride, q0,
                                         seq_len);
    __syncthreads();

    // phase A: z and do v^T for query rows ty*4.., key columns tx + 16*j
    float z[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[i][j] = da[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * L::LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * L::LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[i][j] = fmaf(a[i], kb[j], z[i][j]);
    }
    for (int d = 0; d < V; ++d) {
      float a[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dos[(ty * 4 + i) * L::LDV + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = vs[(tx + 16 * j) * L::LDV + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) da[i][j] = fmaf(a[i], vb[j], da[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        float s_val = 0.0f, dz_val = 0.0f;
        if (valid_attn(q0 + r, k0 + c, seq_len, n_t, p)) {
          float ds_val;
          silu_and_grad<false>(z[i][j] * alpha, &s_val, &ds_val);
          s_val *= inv_scale;
          dz_val = da[i][j] * ds_val * dz_scale;
        }
        ps[r * L::LDP + c] = s_val;
        dzs[r * L::LDP + c] = dz_val;
      }
    }
    __syncthreads();

    // phase B: this thread's key rows ty*4.. of dv and dk
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dzv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * L::LDP + ty * 4 + i];
        dzv[i] = dzs[r * L::LDP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < VC; ++c) {
        const float x = dos[r * L::LDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv_acc[i][c] = fmaf(pv[i], x, dv_acc[i][c]);
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float x = qs[r * L::LDQ + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dk_acc[i][c] = fmaf(dzv[i], x, dk_acc[i][c]);
      }
    }

    // dq rows ty*4.. of this query tile, added into the fp32 buffer
    float dq_acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.0f;
    for (int j = 0; j < BK; ++j) {
      float dzv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dzv[i] = dzs[(ty * 4 + i) * L::LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float x = ks[j * L::LDK + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dq_acc[i][c] = fmaf(dzv[i], x, dq_acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row >= seq_len) continue;  // rows past the length carry zeros
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        atomicAdd(dq_base + (size_t)row * qk_stride + tx + 16 * c,
                  dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < VC; ++c) {
      dv_base[(size_t)row * v_stride + tx + 16 * c] = dv_acc[i][c];
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_base[(size_t)row * qk_stride + tx + 16 * c] = dk_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *d_out;
  float* dq;
  void *dk, *dv;
  const int *lengths, *num_targets;
  int b, n, h;
  float alpha, inv_scale;
  MaskParams p;
  cudaStream_t stream;
};

template <int D, int V>
cudaError_t launch_dv(int is_bf16, const Args& a) {
  const dim3 grid((a.n + BK - 1) / BK, a.h, a.b);
  if (is_bf16) {
    auto kern = hstu_bwd_bf16<D, V>;
    constexpr int smem_bytes = Bf16Smem<D, V>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    kern<<<grid, NUM_THREADS, smem_bytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.d_out),
        a.dq, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.lengths,
        a.num_targets, a.n, a.h, a.alpha, a.inv_scale, a.p);
  } else {
    auto kern = hstu_bwd_f32<D, V>;
    constexpr int smem_bytes = F32Smem<D, V>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    kern<<<grid, NUM_THREADS, smem_bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.d_out),
        a.dq, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
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

// dq is a zeroed fp32 [B, N, H, D] buffer the kernel adds into; dk and dv
// are written whole, in q's type.
extern "C" int hstu_attention_bwd(
    const void* q, const void* k, const void* v, const void* d_out, float* dq,
    void* dk, void* dv, const int* lengths, const int* num_targets, int b,
    int n, int h, int d, int v_dim, int is_bf16, float alpha, float inv_scale,
    int causal, int max_attn_len, int contextual_seq_len,
    int min_full_attn_seq_len, int sla_k1, int sla_k2, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0) return (int)cudaSuccess;
  Args a{q, k, v, d_out, dq, dk, dv, lengths, num_targets, b, n, h, alpha,
         inv_scale,
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
