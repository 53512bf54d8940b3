// Row write: table[ids[k]] = rows[k] for every k, in place, whole rows.
//
// Replaces the TPU kernel _write_kernel of
// torcheasyrec_tpu/ops/pallas/row_write.py (one DMA per row out of a
// VMEM block, a ring of 16 in flight, 8192 ids per grid step). None of
// that shape carries over: on this card a row of 128 fp32 lanes is 512
// bytes, which is one 16-byte store for each of a warp's 32 lanes, fully
// coalesced. So: one warp per row, each lane copies the float4s
// lane, lane + 32, ... of its row (one float4 at 128 lanes).
//
// Bound: bytes. K rows are read once and written once (2 * K * lanes * 4
// bytes) plus the ids; there is no arithmetic. At a few tens of
// thousands of rows the work is tens of microseconds, so the launch
// itself is a large share of the time.
//
// Two Hopper designs were timed against this one in turns
// (tools/row_write_turns/, with their sources): a persistent grid whose
// warps take 8 to 32 rows at a time, and a bulk-copy ring. Neither was
// faster once the engine stopped writing the scratch row (it passes the
// table without that row, so those writes fall past p and are dropped):
// what is left, 512-byte writes scattered over a table of many GB, this
// kernel moves at about 76% of the memory rate at the DeepFM step's
// targets (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, phase
// kernel_row_write), and it is the fastest at small K.
//
// Contract (the embedding engine's packed update relies on each point):
// - ids < 0 or >= p are dropped, not clamped;
// - duplicate targets race: which row wins is undefined, and 16-byte
//   pieces of different rows may mix. The engine sends every duplicate
//   to one scratch row whose content is never read. A racing write never
//   touches another row: each lane stores only inside its target row;
// - a row's byte offset exceeds 32 bits on large tables (30 M rows of
//   512 bytes are 15 GB), so all index arithmetic is 64-bit;
// - table and rows are contiguous, 16-byte aligned, lanes % 4 == 0 (the
//   wrapper checks this and lanes % 128 == 0).
// The kernel runs on the stream it is given and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int NUM_THREADS = WARPS_PER_BLOCK * 32;

template <typename IdT>
__global__ void __launch_bounds__(NUM_THREADS)
row_write_kernel(float4* __restrict__ table, const IdT* __restrict__ ids,
                 const float4* __restrict__ rows, long long k, long long p,
                 int vecs_per_row) {
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= k) return;
  const long long id = static_cast<long long>(ids[row]);
  if (id < 0 || id >= p) return;
  const float4* src = rows + static_cast<size_t>(row) * vecs_per_row;
  float4* dst = table + static_cast<size_t>(id) * vecs_per_row;
  for (int c = threadIdx.x & 31; c < vecs_per_row; c += 32) {
    dst[c] = __ldcs(src + c);  // rows are read once: streaming load
  }
}

}  // namespace

// table [p, lanes] fp32, ids [k] int32 or int64, rows [k, lanes] fp32.
extern "C" int row_write(void* table, const void* ids, const void* rows,
                         long long k, long long p, int lanes, int ids_are_64,
                         void* stream) {
  if (k <= 0 || p <= 0) return (int)cudaSuccess;
  if (lanes <= 0 || lanes % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (k + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_are_64) {
    row_write_kernel<long long><<<grid, NUM_THREADS, 0, s>>>(
        static_cast<float4*>(table), static_cast<const long long*>(ids),
        static_cast<const float4*>(rows), k, p, lanes / 4);
  } else {
    row_write_kernel<int><<<grid, NUM_THREADS, 0, s>>>(
        static_cast<float4*>(table), static_cast<const int*>(ids),
        static_cast<const float4*>(rows), k, p, lanes / 4);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* row_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
