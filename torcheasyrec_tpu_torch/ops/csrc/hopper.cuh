// Hopper (sm_90a) building blocks of the HSTU attention kernels: tensor
// maps and TMA loads, mbarriers, named barriers, and wgmma with its
// shared-memory descriptors.
//
// Tile layout convention. A 16-bit (bf16 or fp16) tile of R rows x COLS columns lives in
// shared memory as COLS / P column panels of P = min(64, COLS) columns;
// panel p starts at byte p * R * P * 2, each row of a panel takes P * 2
// bytes (128 or 64), and the 16-byte chunks of a row are XOR-swizzled
// with the row index (the 128B or 64B pattern of TMA and wgmma). TMA
// writes this layout when its map asks for the same swizzle, and wgmma
// reads it through a descriptor of the matching layout type, as
// K-major (the reduced dimension runs along the row) or MN-major (the
// reduced dimension runs down the rows). Every tile starts on a
// 1024-byte boundary.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

template <int R, int COLS>
struct Tile {
  static constexpr int P = COLS < 64 ? COLS : 64;  // columns per panel
  static constexpr int ROW_BYTES = P * 2;           // 128 or 64
  static constexpr int PANEL_BYTES = R * ROW_BYTES;
  static constexpr int BYTES = COLS * R * 2;
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // SWIZZLE_128B/64B
  static_assert(COLS == 32 || COLS % 64 == 0, "unsupported tile width");
  static_assert(R % 8 == 0, "tile rows must be a multiple of 8");
};

constexpr int align1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) of a Tile<R, COLS>.
template <int R, int COLS>
__device__ __forceinline__ int tile_offset(int row, int col) {
  using T = Tile<R, COLS>;
  const int panel = col / T::P, c = col % T::P;
  // the swizzle XORs the chunk index with bits 7.. of the byte offset
  const int chunk = (c / 8) ^ ((row * T::ROW_BYTES >> 7) % (T::ROW_BYTES / 16));
  return panel * T::PANEL_BYTES + row * T::ROW_BYTES + chunk * 16 + (c % 8) * 2;
}

// Rows [r0, R) of a Tile<R, COLS> are set to zero by NT threads starting
// at thread index `tid` (the swizzle permutes within a row only).
template <int R, int COLS, int NT>
__device__ __forceinline__ void zero_tile_rows(unsigned char* tile, int r0,
                                               int tid) {
  using T = Tile<R, COLS>;
  if (r0 < 0) r0 = 0;
  constexpr int CHUNKS = T::ROW_BYTES / 16;
  const int per_panel = (R - r0) * CHUNKS;
  for (int i = tid; i < per_panel * (COLS / T::P); i += NT) {
    const int panel = i / per_panel, j = i % per_panel;
    *reinterpret_cast<uint4*>(tile + panel * T::PANEL_BYTES +
                              r0 * T::ROW_BYTES + j * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// wgmma descriptors
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// Operand whose reduced dimension runs along the rows of a Tile<R, COLS>:
// rows [row0, row0 + 64 or N) and reduced columns [k0, k0 + 16).
template <int R, int COLS>
__device__ __forceinline__ uint64_t desc_k_major(const unsigned char* tile,
                                                 int row0, int k0) {
  using T = Tile<R, COLS>;
  const uint32_t addr = smem_addr(tile) + (k0 / T::P) * T::PANEL_BYTES +
                        row0 * T::ROW_BYTES + (k0 % T::P) * 2;
  return make_desc(addr, 16, 8 * T::ROW_BYTES, T::LAYOUT);
}

// Operand whose reduced dimension runs down the rows of a Tile<R, COLS>:
// reduced rows [k0, k0 + 16) and columns [col0, col0 + 64 or N).
template <int R, int COLS>
__device__ __forceinline__ uint64_t desc_mn_major(const unsigned char* tile,
                                                  int k0, int col0) {
  using T = Tile<R, COLS>;
  const uint32_t addr = smem_addr(tile) + (col0 / T::P) * T::PANEL_BYTES +
                        k0 * T::ROW_BYTES + (col0 % T::P) * 2;
  return make_desc(addr, T::PANEL_BYTES, 8 * T::ROW_BYTES, T::LAYOUT);
}

// ---------------------------------------------------------------------------
// wgmma: D[64 x N] (+)= A[64 x 16] B[16 x N], 16-bit operands of type E
// (__nv_bfloat16 or __half), fp32 accumulators.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8)
// and columns 8 i + 2 (t % 4) (+ 1) of D: d[4 i + e] is row +8 for e >= 2
// and column +1 for odd e, the D fragment of mma.m16n8k16 per warp.
// TA / TB = 1 read A / B MN-major; `rs` takes A from registers in the A
// fragment layout of mma.m16n8k16.
// ---------------------------------------------------------------------------

template <int N, int TA, int TB, typename E>
struct Wgmma;

#define HOPPER_WGMMA_E __nv_bfloat16
#define HOPPER_WGMMA_TY "bf16"
#include "hopper_wgmma.cuh"
#undef HOPPER_WGMMA_E
#undef HOPPER_WGMMA_TY
#define HOPPER_WGMMA_E __half
#define HOPPER_WGMMA_TY "f16"
#include "hopper_wgmma.cuh"
#undef HOPPER_WGMMA_E
#undef HOPPER_WGMMA_TY

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Two fp32 values rounded to nearest into one register of type E, lo in
// the low half. A value past E's range becomes inf, never clamped.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-step kk (columns [16 kk, 16 kk + 16)) from a
// [64 x N] accumulator, cast to E: two neighbouring n8 blocks.
template <typename E, int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack2<E>(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2<E>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<E>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<E>(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// barriers, TMA, registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits until the phase of the given parity has completed. A wait that
// lasts seconds (a lost arrival) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Rows [row0, row0 + R) x columns [col0, col0 + P) of head h of sample b
// through a map over a [B, N, H, COLS] tensor, into one panel.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int h,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col0),
      "r"(h), "r"(row0), "r"(b)
      : "memory");
}

// Every panel of a Tile<R, COLS> starting at row0; completes on `bar`.
template <int R, int COLS>
__device__ __forceinline__ void tma_load_tile(unsigned char* tile,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int h, int row0,
                                              int b) {
  using T = Tile<R, COLS>;
#pragma unroll
  for (int p = 0; p < COLS / T::P; ++p) {
    tma_load(tile + p * T::PANEL_BYTES, map, bar, p * T::P, h, row0, b);
  }
}

// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over the first `n` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library links against the runtime only.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A map over a 16-bit [B, N, H, COLS] tensor of type `type` (BFLOAT16 or
// FLOAT16) whose box is one panel (P columns) of `rows` rows of one head
// of one sample, in the swizzle of Tile<rows, COLS>. Rows past N read as
// zeros.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                            const void* base, int b, int n, int h, int cols,
                            int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int p = cols < 64 ? cols : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)h, (cuuint64_t)n,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * 2 * h,
                                 (cuuint64_t)cols * 2 * h * n};
  const cuuint32_t box[4] = {(cuuint32_t)p, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      p == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor-map element type of E.
template <typename E>
constexpr CUtensorMapDataType map_type();
template <>
constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

}  // namespace hopper
