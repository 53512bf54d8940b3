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
// scores are recomputed tile by tile. The query tiles a key tile visits are
// the Pallas kernel's (`q_schedule`): under SLA only the window and the
// target rows.
//
// What bounds it on the H100: operations. Five products over the unmasked
// (row, column) pairs, 2 * pairs * H * (3 D + 2 V) FLOP, against q, k, v, do
// read and dq, dk, dv written once (chip_smoke.py counts both for its run).
// At the DLRM-HSTU training shapes (B=32, N=4017, H=4, D=V=128, bf16,
// histories of 512..3899 tokens) that is about 526 GFLOP against 0.92 GB,
// a 0.53 ms bound. On an H100 80GB HBM3 at 700 W the first kernel (WMMA
// fragments, scores through shared memory in fp32) ran 6.95 ms; this one
// runs 2.22 ms, 237 TFLOP/s, 24% of the bound (chip_smoke.py).
//
// 16-bit design (bf16 and fp16: one body, `bwd_wgmma`, instantiated for each
// operand type as `hstu_bwd_bf16` and `hstu_bwd_f16`; .f32.bf16.bf16 or
// .f32.f16.f16 wgmma, the tensor maps of the type, round-to-nearest packing),
// one block per (key tile of 128 rows, head, sample). Blocks
// start sample by sample, longest first, and within a head in rising key
// tile order, so that the heaviest (the low key tiles of the longest
// samples, which most query tiles attend) start first and the blocks in
// flight share one or two heads' q and do in L2:
// - two warpgroups of 4 warps, each owning 64 key rows; thread 0 issues the
//   TMA loads: the block's k and v tiles once, then the query tiles' q and
//   do into a two-stage ring under full/empty mbarriers, each stage refilled
//   as soon as all 8 warps are done with it, so two query tiles are always
//   in flight. No separate producer warp: a ninth warp would put three
//   warps on one of the SM's four register files and cut every thread to
//   168 registers; ptxas compiled the consumers within that limit even
//   under setmaxnreg (spills, serialised wgmma, several times slower),
//   while two warpgroups alone get 255 registers and no spills (dk and dv
//   take 128).
// - scores stay in registers: each warpgroup computes S^T = K Q^T and
//   dP^T = V dO^T with wgmma (key rows as M, 64 query rows as N, fp32
//   accumulators), applies SiLU, SiLU', alpha, 1/scaling_seqlen and the mask
//   to the accumulator registers (the row and column of each register follow
//   from the lane; wholly unmasked tiles skip the mask), and casts P^T and
//   dS^T to 16 bits in the A-fragment layout of the next products (in fp16 a
//   dS past 65504, as a loss scale gives, becomes inf there as in the plain
//   version, and its inf or NaN reaches dk and dq; nothing is clamped):
//   dV += P^T dO and dK += dS^T Q are wgmma with A from registers. dk and dv
//   stay in registers for the whole loop.
// - dq: only dS^T (16-bit, 16 KB) goes to shared memory, once per step, double
//   buffered; after one barrier between the two warpgroups each computes
//   dQ = dS K for half of the head dim (wgmma, A and B MN-major from shared
//   memory) and adds it into a zeroed fp32 [B, N, H, D] buffer with 8-byte
//   atomics (red.global.add); rows past the length add nothing. The wrapper
//   casts the buffer to q's type. Five products in one kernel; dq's sums
//   are taken in an order that changes from run to run (fp32, a few ulp).
//   128 key rows per block halve the dq additions of the first kernel.
// - padding never meets a product: TMA reads whatever device memory holds,
//   so a tile that crosses the sample's length has its rows at or past the
//   length zeroed in shared memory before any wgmma reads it. Key rows past
//   the length write zeros to dk and dv.
// fp32 (the parity path): the same tiles with fp32 FMAs on the CUDA cores
// (no TF32) and the exact expf, 64 key rows per block.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (torcheasyrec_tpu_torch/ops/cuda_build.py). The tensor maps are
// encoded on the host for each call. The launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "hstu_attention_common.cuh"

namespace {

using namespace hstu;
using namespace hopper;

constexpr int BQ = 64;            // query rows per step of the loop
constexpr int BK = 64;            // fp32: key rows per block
constexpr int NUM_THREADS = 256;  // 8 warps (16-bit: two warpgroups)
constexpr int HBK = 128;          // 16-bit: key rows per block

// SiLU(z) and SiLU'(z) from one sigmoid.
template <bool FAST>
__device__ __forceinline__ void silu_and_grad(float z, float* s, float* ds) {
  const float sig = FAST ? __fdividef(1.0f, 1.0f + __expf(-z))
                         : 1.0f / (1.0f + expf(-z));
  *s = z * sig;
  *ds = sig * (1.0f + z * (1.0f - sig));
}

// ---------------------------------------------------------------------------
// bf16 and fp16: TMA, wgmma
// ---------------------------------------------------------------------------

template <int D, int V>
struct HopperSmem {
  using KT = Tile<HBK, D>;
  using VT = Tile<HBK, V>;
  using QT = Tile<BQ, D>;
  using OT = Tile<BQ, V>;   // do
  using ST = Tile<HBK, BQ>;  // dS^T
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + align1024(KT::BYTES);
  static constexpr int DO_IN_STAGE = align1024(QT::BYTES);
  static constexpr int STAGE = DO_IN_STAGE + align1024(OT::BYTES);
  static constexpr int STAGE_OFF = V_OFF + align1024(VT::BYTES);
  static constexpr int DS_STAGE = align1024(ST::BYTES);
  static constexpr int DS_OFF = STAGE_OFF + 2 * STAGE;
  static constexpr int BAR_OFF = DS_OFF + 2 * DS_STAGE;
  // 5 mbarriers, and room to align the dynamic buffer to 1024 bytes
  static constexpr int BYTES = BAR_OFF + 64 + 1024;
};

// The body of the 16-bit kernels, for operands and dk, dv of type E (bf16
// or fp16); `*_map` point at the kernel's __grid_constant__ maps.
template <typename E, int D, int V>
__device__ __forceinline__ void bwd_wgmma(
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, const CUtensorMap* do_map,
    float* __restrict__ dq, E* __restrict__ dk, E* __restrict__ dv,
    const int* __restrict__ lengths, const int* __restrict__ num_targets,
    int n, int h_count, float alpha, float inv_scale, MaskParams p) {
  using L = HopperSmem<D, V>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int b = sample_of_rank(lengths, gridDim.z, blockIdx.z, n);
  const int h = blockIdx.y, k0 = blockIdx.x * HBK;
  const int seq_len = min(lengths[b], n);
  const int n_t = p.has_targets ? num_targets[b] : 0;
  const size_t head = (size_t)b * n * h_count + h;
  const int qk_stride = h_count * D, v_stride = h_count * V;
  float* dq_base = dq + head * D;
  E* dk_base = dk + head * D;
  E* dv_base = dv + head * V;

  if (k0 >= seq_len) {
    zero_rows<NUM_THREADS, HBK, E, D>(dk_base, qk_stride, k0, n);
    zero_rows<NUM_THREADS, HBK, E, V>(dv_base, v_stride, k0, n);
    return;
  }

  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;   // [2]: q and do of a stage landed
  uint64_t* empty = kv_full + 3;  // [2]: every consumer warp is done with it
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const TileRanges tiles = q_schedule<BQ, HBK>(k0, seq_len, n_t, p);
  const int n_q = tiles.count();
  unsigned char* ks = smem + L::K_OFF;
  unsigned char* vs = smem + L::V_OFF;
  const int tid = threadIdx.x;
  // q and do of query tile `it` into stage it % 2, by thread 0
  auto load_stage = [&](int it) {
    unsigned char* stage = smem + L::STAGE_OFF + (it & 1) * L::STAGE;
    uint64_t* bar = &full[it & 1];
    const int q0 = tiles.tile(it) * BQ;
    mbar_expect_tx(bar, L::QT::BYTES + L::OT::BYTES);
    tma_load_tile<BQ, D>(stage, q_map, bar, h, q0, b);
    tma_load_tile<BQ, V>(stage + L::DO_IN_STAGE, do_map, bar, h, q0, b);
  };
  if (tid == 0) {
    mbar_expect_tx(kv_full, L::KT::BYTES + L::VT::BYTES);
    tma_load_tile<HBK, D>(ks, k_map, kv_full, h, k0, b);
    tma_load_tile<HBK, V>(vs, v_map, kv_full, h, k0, b);
    for (int it = 0; it < min(n_q, 2); ++it) load_stage(it);
  }

  // ---- warpgroup wg owns key rows [k0 + kw, k0 + kw + 64) ----
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int kw = wg * 64;
  const int r_lo = 16 * warp + lane / 4;  // accumulator rows r_lo, r_lo + 8
  const int c_lo = 2 * (lane % 4);        // columns 8 i + c_lo (+ 1)
  const float dz_scale = alpha * inv_scale;

  mbar_wait(kv_full, 0);
  if (k0 + HBK > seq_len) {  // rows past the length read as zero
    zero_tile_rows<HBK, D, NUM_THREADS>(ks, seq_len - k0, tid);
    zero_tile_rows<HBK, V, NUM_THREADS>(vs, seq_len - k0, tid);
    fence_async_smem();
    named_barrier(1, NUM_THREADS);
  }

  float dk_acc[D / 2], dv_acc[V / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < V / 2; ++i) dv_acc[i] = 0.0f;

  for (int it = 0; it < n_q; ++it) {
    const int s = it & 1;
    const int q0 = tiles.tile(it) * BQ;
    unsigned char* qs = smem + L::STAGE_OFF + s * L::STAGE;
    unsigned char* dos = qs + L::DO_IN_STAGE;
    unsigned char* dss = smem + L::DS_OFF + s * L::DS_STAGE;
    mbar_wait(&full[s], (it >> 1) & 1);
    if (q0 + BQ > seq_len) {
      zero_tile_rows<BQ, D, NUM_THREADS>(qs, seq_len - q0, tid);
      zero_tile_rows<BQ, V, NUM_THREADS>(dos, seq_len - q0, tid);
      fence_async_smem();
      named_barrier(1, NUM_THREADS);
    }

    // S^T = K Q^T and dP^T = V dO^T: [64 key rows, 64 query rows]
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<BQ, 0, 0, E>::ss(st, desc_k_major<HBK, D>(ks, kw, 16 * kk),
                          desc_k_major<BQ, D>(qs, 0, 16 * kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < V / 16; ++kk) {
      Wgmma<BQ, 0, 0, E>::ss(dpt, desc_k_major<HBK, V>(vs, kw, 16 * kk),
                          desc_k_major<BQ, V>(dos, 0, 16 * kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in the accumulator registers; the mask as one bit per
    // register, computed in a rolled loop where the tile needs it
    uint32_t valid = 0xffffffffu;
    if (!tile_unmasked(q0, k0 + kw, BQ, 64, seq_len, n_t, p)) {
      valid = 0;
#pragma unroll 1
      for (int i = 0; i < BQ / 2; ++i) {
        const int key = k0 + kw + r_lo + ((i & 2) ? 8 : 0);
        const int row = q0 + 8 * (i / 4) + c_lo + (i & 1);
        valid |= (uint32_t)valid_attn(row, key, seq_len, n_t, p) << i;
      }
    }
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      float s_val, ds_val;
      silu_and_grad<true>(st[i] * alpha, &s_val, &ds_val);
      const bool keep = (valid >> i) & 1;
      st[i] = keep ? s_val * inv_scale : 0.0f;
      dpt[i] = keep ? dpt[i] * ds_val * dz_scale : 0.0f;
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a<E>(st, kk, pa[kk]);
      acc_to_a<E>(dpt, kk, da[kk]);
    }
    // dS^T to shared memory for dQ, the same 16-bit values
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = kw + r_lo + ((e & 1) ? 8 : 0);
        const int col = 16 * kk + 8 * (e >> 1) + c_lo;
        *reinterpret_cast<uint32_t*>(dss + tile_offset<HBK, BQ>(row, col)) =
            da[kk][e];
      }
    }

    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Wgmma<V, 0, 1, E>::rs(dv_acc, pa[kk], desc_mn_major<BQ, V>(dos, 16 * kk, 0),
                         1);
      Wgmma<D, 0, 1, E>::rs(dk_acc, da[kk], desc_mn_major<BQ, D>(qs, 16 * kk, 0),
                         1);
    }
    wgmma_commit();

    // dQ = dS K for this warpgroup's half of the head dim
    fence_async_smem();
    named_barrier(2, NUM_THREADS);  // both halves of dS^T are in place
    float dq_acc[D / 4];
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dq_acc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HBK / 16; ++kk) {
      Wgmma<D / 2, 1, 1, E>::ss(dq_acc, desc_mn_major<HBK, BQ>(dss, 16 * kk, 0),
                             desc_mn_major<HBK, D>(ks, 16 * kk, wg * (D / 2)),
                             kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq_acc);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // q and do of this stage are free

#pragma unroll
    for (int i = 0; i < D / 4; i += 2) {
      const int row = q0 + r_lo + ((i & 2) ? 8 : 0);
      const int col = wg * (D / 2) + 8 * (i / 4) + c_lo;
      if (row < seq_len) {  // rows past the length carry zeros
        atomicAdd(
            reinterpret_cast<float2*>(dq_base + (size_t)row * qk_stride + col),
            make_float2(dq_acc[i], dq_acc[i + 1]));
      }
    }
    if (tid == 0 && it + 2 < n_q) {  // refill the stage once all are done
      mbar_wait(&empty[s], (it >> 1) & 1);
      load_stage(it + 2);
    }
  }

  // ---- dk and dv from the registers, as E ----
#pragma unroll
  for (int i = 0; i < V / 2; i += 2) {
    const int row = k0 + kw + r_lo + ((i & 2) ? 8 : 0);
    if (row < n) {
      *reinterpret_cast<uint32_t*>(dv_base + (size_t)row * v_stride + 8 * (i / 4) +
                                   c_lo) = pack2<E>(dv_acc[i], dv_acc[i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = k0 + kw + r_lo + ((i & 2) ? 8 : 0);
    if (row < n) {
      *reinterpret_cast<uint32_t*>(dk_base + (size_t)row * qk_stride +
                                   8 * (i / 4) + c_lo) =
          pack2<E>(dk_acc[i], dk_acc[i + 1]);
    }
  }
}

#define HSTU_BWD_KERNEL(NAME, E)                                              \
  template <int D, int V>                                                     \
  __global__ void __launch_bounds__(NUM_THREADS, 1)                           \
      NAME(const __grid_constant__ CUtensorMap q_map,                         \
           const __grid_constant__ CUtensorMap k_map,                         \
           const __grid_constant__ CUtensorMap v_map,                         \
           const __grid_constant__ CUtensorMap do_map,                        \
           float* __restrict__ dq, E* __restrict__ dk, E* __restrict__ dv,    \
           const int* __restrict__ lengths,                                   \
           const int* __restrict__ num_targets, int n, int h_count,           \
           float alpha, float inv_scale, MaskParams p) {                      \
    bwd_wgmma<E, D, V>(&q_map, &k_map, &v_map, &do_map, dq, dk, dv, lengths,  \
                       num_targets, n, h_count, alpha, inv_scale, p);         \
  }
HSTU_BWD_KERNEL(hstu_bwd_bf16, bf16)
HSTU_BWD_KERNEL(hstu_bwd_f16, __half)
#undef HSTU_BWD_KERNEL

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
  const TileRanges tiles = q_schedule<BQ, BK>(k0, seq_len, n_t, p);
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

// The 16-bit kernel `kern` for operands of type E.
template <typename E, int D, int V, typename Kernel>
cudaError_t launch_wgmma(Kernel kern, const Args& a) {
  CUtensorMap q_map, k_map, v_map, do_map;
  constexpr CUtensorMapDataType t = map_type<E>();
  cudaError_t err = make_map(&q_map, t, a.q, a.b, a.n, a.h, D, BQ);
  if (err == cudaSuccess) err = make_map(&k_map, t, a.k, a.b, a.n, a.h, D, HBK);
  if (err == cudaSuccess) err = make_map(&v_map, t, a.v, a.b, a.n, a.h, V, HBK);
  if (err == cudaSuccess) {
    err = make_map(&do_map, t, a.d_out, a.b, a.n, a.h, V, BQ);
  }
  if (err != cudaSuccess) return err;
  constexpr int smem_bytes = HopperSmem<D, V>::BYTES;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + HBK - 1) / HBK, a.h, a.b);
  kern<<<grid, NUM_THREADS, smem_bytes, a.stream>>>(
      q_map, k_map, v_map, do_map, a.dq, static_cast<E*>(a.dk),
      static_cast<E*>(a.dv), a.lengths, a.num_targets, a.n, a.h, a.alpha,
      a.inv_scale, a.p);
  return cudaGetLastError();
}

// dtype: 0 fp32, 1 bf16, 2 fp16
// Head dim 16 (HSTU-Match's towers) runs on the fp32 kernel only: the
// 16-bit kernels' tiles start at 32 columns (64-byte rows).
template <int D, int V>
cudaError_t launch_dv(int dtype, const Args& a) {
  if constexpr (D >= 32 && V >= 32) {
    if (dtype == 1) return launch_wgmma<bf16, D, V>(hstu_bwd_bf16<D, V>, a);
    if (dtype == 2) return launch_wgmma<__half, D, V>(hstu_bwd_f16<D, V>, a);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  auto kern = hstu_bwd_f32<D, V>;
  constexpr int smem_bytes = F32Smem<D, V>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + BK - 1) / BK, a.h, a.b);
  kern<<<grid, NUM_THREADS, smem_bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.d_out),
      a.dq, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.lengths, a.num_targets, a.n, a.h, a.alpha, a.inv_scale, a.p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int v_dim, int dtype, const Args& a) {
  switch (v_dim) {
    case 16: return launch_dv<D, 16>(dtype, a);
    case 32: return launch_dv<D, 32>(dtype, a);
    case 64: return launch_dv<D, 64>(dtype, a);
    case 128: return launch_dv<D, 128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dq is a zeroed fp32 [B, N, H, D] buffer the kernel adds into; dk and dv
// are written whole, in q's type. dtype: 0 fp32, 1 bf16, 2 fp16.
extern "C" int hstu_attention_bwd(
    const void* q, const void* k, const void* v, const void* d_out, float* dq,
    void* dk, void* dv, const int* lengths, const int* num_targets, int b,
    int n, int h, int d, int v_dim, int dtype, float alpha, float inv_scale,
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
    case 16: return (int)launch_d<16>(v_dim, dtype, a);
    case 32: return (int)launch_d<32>(v_dim, dtype, a);
    case 64: return (int)launch_d<64>(v_dim, dtype, a);
    case 128: return (int)launch_d<128>(v_dim, dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hstu_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
