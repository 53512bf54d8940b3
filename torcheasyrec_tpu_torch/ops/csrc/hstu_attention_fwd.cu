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
// num_targets isolation and Semi-Local Attention (sla_k1 / sla_k2). The key
// tiles a query tile visits are the Pallas kernel's (`kv_schedule`): under
// SLA only the prefix and the window, or all history for target rows.
//
// What bounds it on the H100: operations. At the DLRM-HSTU serving shapes
// (B=32, N=4017, H=4, D=V=128, bf16, histories of 512..3899 tokens) the two
// products over the unmasked (row, column) pairs are about 210 GFLOP
// against 0.53 GB of q, k, v and out (chip_smoke.py counts both), a 0.21 ms
// bound. Softmax-free attention needs no running max or rescale, so the
// kernel is a plain blockwise accumulation. On an H100 80GB HBM3 at 700 W
// the first kernel (WMMA fragments, scores through shared memory in fp32)
// ran 2.19 ms; this one runs 1.06-1.08 ms, 195-199 TFLOP/s, 20% of the
// bound (chip_smoke.py).
//
// bf16 design, one block per (query tile of 128 rows, head, sample). Blocks
// start sample by sample, longest first, and within a head from the last
// query tile (the one that visits the most key tiles) down, to even out the
// tail of the grid while the blocks in flight share one or two heads' k and
// v in L2:
// - warp specialised: one producer warp, one thread of which issues TMA
//   loads: the block's q tile once, then the k and v tiles into a
//   two-stage ring under full/empty mbarriers. Warpgroups 0 and 1 each own
//   64 query rows, so every k/v tile serves 128 rows (half the k/v traffic
//   per row of a 64-row tile). A ninth warp caps every thread at 168
//   registers (three warps on one of the SM's four register files); the
//   consumers need about 160 (O and S 64 each, P 32) and ptxas reports no
//   spills. A version that ran the next tile's S during this tile's SiLU
//   (two S accumulators, 256 threads for 255 registers) was slower: ptxas
//   serialised its wgmma for want of registers.
// - scores stay in registers: S = Q K^T by wgmma (64 rows x 128 key
//   columns, fp32 accumulators); SiLU, alpha, 1/scaling_seqlen and the mask
//   are applied to the accumulator registers (row and column from the lane;
//   wholly unmasked tiles skip the mask); P is cast to bf16 in registers and
//   is the A operand of O += P V (wgmma with A from registers, V MN-major
//   from shared memory). O stays in registers and leaves as bf16.
// - padding never meets a product: a v tile that crosses the sample's
//   length has its rows at or past the length zeroed in shared memory before
//   the product (a masked score is 0, and 0 times NaN is NaN); scores of
//   padded q or k rows are masked by selection, never by multiplication.
// fp32 (the parity path): one block of 4 warps per 64-row query tile, fp32
// FMAs on the CUDA cores (no TF32), so the fp32 result holds to the plain
// version's precision.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (torcheasyrec_tpu_torch/ops/cuda_build.py). The tensor maps are
// encoded on the host for each call. The launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "hstu_attention_common.cuh"

namespace {

using namespace hstu;
using namespace hopper;

constexpr int BQ = 64;            // fp32: query rows per block
constexpr int BK = 64;            // fp32: key/value rows per tile
constexpr int NUM_THREADS = 128;  // fp32: 4 warps
constexpr int HBQ = 128;          // bf16: query rows per block
constexpr int HBK = 128;          // bf16: key/value rows per tile
constexpr int CONSUMERS = 256;    // bf16: two consumer warpgroups
constexpr int H_THREADS = CONSUMERS + 32;  // bf16: and the producer warp

// ---------------------------------------------------------------------------
// bf16: TMA, wgmma, warp specialisation
// ---------------------------------------------------------------------------

template <int D, int V>
struct HopperSmem {
  using QT = Tile<HBQ, D>;
  using KT = Tile<HBK, D>;
  using VT = Tile<HBK, V>;
  static constexpr int Q_OFF = 0;
  static constexpr int V_IN_STAGE = align1024(KT::BYTES);
  static constexpr int STAGE = V_IN_STAGE + align1024(VT::BYTES);
  static constexpr int STAGE_OFF = Q_OFF + align1024(QT::BYTES);
  static constexpr int BAR_OFF = STAGE_OFF + 2 * STAGE;
  // 5 mbarriers, and room to align the dynamic buffer to 1024 bytes
  static constexpr int BYTES = BAR_OFF + 64 + 1024;
};

template <int D, int V>
__global__ void __launch_bounds__(H_THREADS, 1)
hstu_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              bf16* __restrict__ out, const int* __restrict__ lengths,
              const int* __restrict__ num_targets, int n, int h_count,
              float alpha, float inv_scale, MaskParams p) {
  using L = HopperSmem<D, V>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int b = sample_of_rank(lengths, gridDim.z, blockIdx.z, n);
  const int h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * HBQ;
  const int seq_len = min(lengths[b], n);
  const int n_t = p.has_targets ? num_targets[b] : 0;
  const size_t head = (size_t)b * n * h_count + h;
  const int v_stride = h_count * V;
  bf16* o_base = out + head * V;

  if (q0 >= seq_len) {
    zero_rows<H_THREADS, HBQ, bf16, V>(o_base, v_stride, q0, n);
    return;
  }

  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;   // [2]: k and v of a stage landed
  uint64_t* empty = q_full + 3;  // [2]: every consumer warp is done with it
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const TileRanges tiles = kv_schedule<HBQ, HBK>(q0, seq_len, n_t, p);
  const int n_kv = tiles.count();
  unsigned char* qs = smem + L::Q_OFF;
  if (threadIdx.x >= CONSUMERS) {  // ---- producer ----
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, L::QT::BYTES);
      tma_load_tile<HBQ, D>(qs, &q_map, q_full, h, q0, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it & 1;
        unsigned char* stage = smem + L::STAGE_OFF + s * L::STAGE;
        mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::KT::BYTES + L::VT::BYTES);
        const int k0 = tiles.tile(it) * HBK;
        tma_load_tile<HBK, D>(stage, &k_map, &full[s], h, k0, b);
        tma_load_tile<HBK, V>(stage + L::V_IN_STAGE, &v_map, &full[s], h, k0,
                              b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [q0 + qw, q0 + qw + 64) ----
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int qw = wg * 64;
  const int r_lo = 16 * warp + lane / 4;  // accumulator rows r_lo, r_lo + 8
  const int c_lo = 2 * (lane % 4);        // columns 8 i + c_lo (+ 1)

  float o_acc[V / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i) o_acc[i] = 0.0f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int s = it & 1;
    const int k0 = tiles.tile(it) * HBK;
    unsigned char* ks = smem + L::STAGE_OFF + s * L::STAGE;
    unsigned char* vs = ks + L::V_IN_STAGE;
    mbar_wait(&full[s], (it >> 1) & 1);
    if (k0 + HBK > seq_len) {  // v rows past the length read as zero
      zero_tile_rows<HBK, V, CONSUMERS>(vs, seq_len - k0, tid);
      fence_async_smem();
      named_barrier(1, CONSUMERS);
    }

    // S = Q K^T: [64 query rows, 128 key columns]
    float sacc[HBK / 2];
#pragma unroll
    for (int i = 0; i < HBK / 2; ++i) sacc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<HBK, 0, 0>::ss(sacc, desc_k_major<HBQ, D>(qs, qw, 16 * kk),
                           desc_k_major<HBK, D>(ks, 0, 16 * kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // P = mask * SiLU(alpha S) / scale, cast to bf16 as the A operand; the
    // mask as one bit per register, computed in a rolled loop where the
    // tile needs it
    uint64_t valid = ~0ull;
    if (!tile_unmasked(q0 + qw, k0, 64, HBK, seq_len, n_t, p)) {
      valid = 0;
#pragma unroll 1
      for (int i = 0; i < HBK / 2; ++i) {
        const int row = q0 + qw + r_lo + ((i & 2) ? 8 : 0);
        const int col = k0 + 8 * (i / 4) + c_lo + (i & 1);
        valid |= (uint64_t)valid_attn(row, col, seq_len, n_t, p) << i;
      }
    }
#pragma unroll
    for (int i = 0; i < HBK / 2; ++i) {
      const float val = silu_fast(sacc[i] * alpha) * inv_scale;
      sacc[i] = (valid >> i) & 1 ? val : 0.0f;
    }
    uint32_t pa[HBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < HBK / 16; ++kk) acc_to_a(sacc, kk, pa[kk]);

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HBK / 16; ++kk) {
      Wgmma<V, 0, 1>::rs(o_acc, pa[kk], desc_mn_major<HBK, V>(vs, 16 * kk, 0),
                         1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
#pragma unroll
    for (int kk = 0; kk < HBK / 16; ++kk) fence_regs(pa[kk]);
    if (lane == 0) mbar_arrive(&empty[s]);  // k and v of this stage are free
  }

  // ---- out from the registers, as bf16 (rows past the length hold 0) ----
#pragma unroll
  for (int i = 0; i < V / 2; i += 2) {
    const int row = q0 + qw + r_lo + ((i & 2) ? 8 : 0);
    if (row < n) {
      *reinterpret_cast<uint32_t*>(o_base + (size_t)row * v_stride +
                                   8 * (i / 4) + c_lo) =
          pack_bf16(o_acc[i], o_acc[i + 1]);
    }
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

  const TileRanges tiles = kv_schedule<BQ, BK>(q0, seq_len, n_t, p);
  const int n_kv = tiles.count();
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = tiles.tile(it) * BK;
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
  if (is_bf16) {
    CUtensorMap q_map, k_map, v_map;
    cudaError_t err = make_map(&q_map, a.q, a.b, a.n, a.h, D, HBQ);
    if (err == cudaSuccess) err = make_map(&k_map, a.k, a.b, a.n, a.h, D, HBK);
    if (err == cudaSuccess) err = make_map(&v_map, a.v, a.b, a.n, a.h, V, HBK);
    if (err != cudaSuccess) return err;
    auto kern = hstu_fwd_bf16<D, V>;
    constexpr int smem_bytes = HopperSmem<D, V>::BYTES;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n + HBQ - 1) / HBQ, a.h, a.b);
    kern<<<grid, H_THREADS, smem_bytes, a.stream>>>(
        q_map, k_map, v_map, static_cast<bf16*>(a.out), a.lengths,
        a.num_targets, a.n, a.h, a.alpha, a.inv_scale, a.p);
  } else {
    auto kern = hstu_fwd_f32<D, V>;
    constexpr int smem_bytes = F32Smem<D, V>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n + BQ - 1) / BQ, a.h, a.b);
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
