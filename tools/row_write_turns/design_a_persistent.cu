// Row write, design A: table[ids[k]] = rows[k] for every k, in place.
//
// A candidate for torcheasyrec_tpu_torch/ops/csrc/row_write.cu (same C
// interface and contract), kept for the comparison in turns.py beside
// it; the package does not build it. On this card a row of 128 fp32
// lanes is 512 bytes: one 16-byte piece for each of a warp's 32 lanes.
//
// Bound: bytes. K rows are read once and written once (2 * K * lanes * 4
// bytes) plus the ids; there is no arithmetic. At the DeepFM step's
// 73 k rows that is 23 us at 3.35 TB/s, so what matters is how many
// bytes are in flight and how little each row waits on.
//
// Design. A persistent grid: at most as many blocks as fit on the SMs at
// once, each warp striding over batches of ROWS_PER_BATCH rows (32 by
// default). A warp reads its batch's ids in one coalesced load (lane i
// holds ids[base + i]) and hands each row's target out with __shfl_sync,
// so no row waits on a load of its own id. Then every lane copies its
// 16-byte pieces of the batch's rows UNROLL rows at a time: UNROLL
// independent streaming loads, then their UNROLL stores, so UNROLL x 512
// bytes are in flight per warp. Each row's target is fetched from its
// lane again for the store, so that only the loaded values stay in
// registers.
//
// Contract (the embedding engine's packed update relies on each point):
// - ids < 0 or >= p are dropped, not clamped;
// - duplicate targets race: which row wins is undefined, and 16-byte
//   pieces of different rows may mix. The engine sends every duplicate
//   to one scratch row whose content is never read. A racing write never
//   touches another row: each lane stores only inside its target row;
// - a row's byte offset exceeds 32 bits on large tables (30 M rows of
//   512 bytes are 15 GB), so all index arithmetic is 64-bit;
// - int32 and int64 ids are both read as they are, at any alignment;
// - table and rows are contiguous and 16-byte aligned, lanes % 128 == 0
//   (the wrapper checks this);
// - k == 0 launches nothing.
// The kernel runs on the stream it is given and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int NUM_THREADS = WARPS_PER_BLOCK * 32;
// rows per batch (one id per lane) and 16-byte loads in flight per lane;
// nvcc -D sets other values
#ifndef RW_ROWS_PER_BATCH
#define RW_ROWS_PER_BATCH 32
#endif
#ifndef RW_UNROLL
#define RW_UNROLL 8
#endif
constexpr int ROWS_PER_BATCH = RW_ROWS_PER_BATCH;
constexpr int UNROLL = RW_UNROLL;
static_assert(ROWS_PER_BATCH <= 32, "one id per lane");
constexpr int MAX_DEVICES = 64;

template <typename IdT>
__global__ void __launch_bounds__(NUM_THREADS)
row_write_kernel(float4* __restrict__ table, const IdT* __restrict__ ids,
                 const float4* __restrict__ rows, long long k, long long p,
                 int vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int per_lane = vecs_per_row / 32;  // pieces of a row per lane
  const long long step =
      static_cast<long long>(gridDim.x) * WARPS_PER_BLOCK * ROWS_PER_BATCH;
  long long base = (static_cast<long long>(blockIdx.x) * WARPS_PER_BLOCK +
                    (threadIdx.x >> 5)) * ROWS_PER_BATCH;
  for (; base < k; base += step) {
    const int n = static_cast<int>(
        k - base < ROWS_PER_BATCH ? k - base : ROWS_PER_BATCH);
    long long id = -1;
    if (lane < n) id = static_cast<long long>(ids[base + lane]);
    if (id >= p) id = -1;  // dropped, as negative ids are
    const float4* src = rows + static_cast<size_t>(base) * vecs_per_row + lane;
    const int pieces = n * per_lane;  // (row, piece) pairs of each lane
    for (int t0 = 0; t0 < pieces; t0 += UNROLL) {
      // t is the same in every lane: the warp copies one row per u; each
      // row's target is fetched from its lane again for the store, so
      // that only the loaded values stay in registers
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = t0 + u, r = t / per_lane;
        const long long target = __shfl_sync(0xffffffffu, id, r & 31);
        if (t < pieces && target >= 0) {
          v[u] = __ldcs(src + static_cast<size_t>(r) * vecs_per_row +
                        (t - r * per_lane) * 32);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = t0 + u, r = t / per_lane;
        const long long target = __shfl_sync(0xffffffffu, id, r & 31);
        if (t < pieces && target >= 0) {
          table[target * vecs_per_row + (t - r * per_lane) * 32 + lane] = v[u];
        }
      }
    }
  }
}

// Blocks of row_write_kernel<IdT> that fit on device `dev` at once.
template <typename IdT>
cudaError_t resident_blocks(int dev, int* out) {
  static int cached[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_write_kernel<IdT>, NUM_THREADS, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cached[dev];
  return cudaSuccess;
}

template <typename IdT>
cudaError_t launch(void* table, const void* ids, const void* rows,
                   long long k, long long p, int lanes, cudaStream_t s) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks<IdT>(dev, &resident);
  if (err != cudaSuccess) return err;
  const long long batches = (k + ROWS_PER_BATCH - 1) / ROWS_PER_BATCH;
  long long blocks = (batches + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > resident) blocks = resident;
  row_write_kernel<IdT><<<static_cast<unsigned>(blocks), NUM_THREADS, 0, s>>>(
      static_cast<float4*>(table), static_cast<const IdT*>(ids),
      static_cast<const float4*>(rows), k, p, lanes / 4);
  return cudaGetLastError();
}

}  // namespace

// table [p, lanes] fp32, ids [k] int32 or int64, rows [k, lanes] fp32.
extern "C" int row_write(void* table, const void* ids, const void* rows,
                         long long k, long long p, int lanes, int ids_are_64,
                         void* stream) {
  if (k <= 0 || p <= 0) return (int)cudaSuccess;
  if (lanes <= 0 || lanes % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ids_are_64 ? launch<long long>(table, ids, rows, k, p, lanes, s)
                          : launch<int>(table, ids, rows, k, p, lanes, s));
}

extern "C" const char* row_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
