// Row write, design B, a bulk-copy ring: table[ids[k]] = rows[k], in
// place. A candidate for torcheasyrec_tpu_torch/ops/csrc/row_write.cu,
// kept for the comparison in turns.py beside it; the package does not
// build it.
//
// The TPU kernel's design (a ring of row DMAs) done by Hopper's copy
// engine. Rows are
// contiguous, so lane 0 of a warp loads a chunk of them (16 KB, 32 rows
// of 512 bytes) into shared memory with one bulk copy that completes on
// an mbarrier; then every lane issues one bulk store of its row to that
// row's target (dropped ids issue none) and commits it as its own bulk
// group. A ring of RING chunk buffers per warp keeps LOOK chunk loads in
// flight under the stores of the chunks before them; a buffer is refilled
// only once the stores that read it have (cp.async.bulk.wait_group.read).
// Same C interface and contract as row_write.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 3;
constexpr int RING = 4;                 // chunk buffers per warp
constexpr int LOOK = RING - 2;          // chunk loads in flight ahead
constexpr int CHUNK_BYTES = 16384;      // at most 32 rows per chunk
constexpr int SMEM_BYTES = WARPS_PER_BLOCK * RING * CHUNK_BYTES;
constexpr int MAX_DEVICES = 64;

// One bulk copy of `bytes` from global memory into shared memory; its
// bytes complete the transaction count of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar))
      : "memory");
}
// One bulk copy of `bytes` from shared memory to global memory, in the
// thread's open bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(hopper::smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of the thread's bulk groups may still read their
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename IdT>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
row_write_bulk_kernel(unsigned char* __restrict__ table,
                      const IdT* __restrict__ ids,
                      const unsigned char* __restrict__ rows, long long k,
                      long long p, int row_bytes, int chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[WARPS_PER_BLOCK][RING];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + warp * RING * CHUNK_BYTES;
  uint64_t* bar = bars[warp];
  if (lane == 0) {
    for (int b = 0; b < RING; ++b) hopper::mbar_init(&bar[b], 1);
    hopper::mbar_init_fence();
  }
  __syncwarp();

  const long long chunks = (k + chunk_rows - 1) / chunk_rows;
  const long long gw = static_cast<long long>(blockIdx.x) * WARPS_PER_BLOCK +
                       warp;
  const long long nw = static_cast<long long>(gridDim.x) * WARPS_PER_BLOCK;
  const long long n_mine = gw < chunks ? (chunks - gw + nw - 1) / nw : 0;

  // lane 0: the j-th chunk of this warp into buffer j % RING
  auto load = [&](long long j) {
    const long long r0 = (gw + j * nw) * chunk_rows;
    const int n = static_cast<int>(k - r0 < chunk_rows ? k - r0 : chunk_rows);
    uint64_t* b = &bar[j % RING];
    hopper::mbar_expect_tx(b, n * row_bytes);
    bulk_load(ring + (j % RING) * CHUNK_BYTES,
                      rows + static_cast<size_t>(r0) * row_bytes,
                      static_cast<uint32_t>(n * row_bytes), b);
  };
  if (lane == 0) {
    for (long long j = 0; j < LOOK && j < n_mine; ++j) load(j);
  }
  for (long long j = 0; j < n_mine; ++j) {
    const long long r0 = (gw + j * nw) * chunk_rows;
    const int n = static_cast<int>(k - r0 < chunk_rows ? k - r0 : chunk_rows);
    long long id = -1;
    if (lane < n) id = static_cast<long long>(ids[r0 + lane]);
    if (id >= p) id = -1;
    if (j + LOOK < n_mine) {
      // buffer (j + LOOK) % RING last held chunk j + LOOK - RING = j - 2,
      // whose stores are every lane's groups but the newest one
      bulk_wait_read<RING - LOOK - 1>();
      __syncwarp();
      if (lane == 0) load(j + LOOK);
    }
    hopper::mbar_wait(&bar[j % RING], static_cast<int>((j / RING) & 1));
    if (id >= 0) {
      bulk_store(table + static_cast<size_t>(id) * row_bytes,
                         ring + (j % RING) * CHUNK_BYTES + lane * row_bytes,
                         static_cast<uint32_t>(row_bytes));
    }
    bulk_commit();
  }
  bulk_wait_all();
}

template <typename IdT>
cudaError_t resident_blocks(int dev, int* out) {
  static int cached[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        row_write_bulk_kernel<IdT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_write_bulk_kernel<IdT>, WARPS_PER_BLOCK * 32,
          SMEM_BYTES);
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
  const int row_bytes = lanes * 4;
  int chunk_rows = CHUNK_BYTES / row_bytes;
  if (chunk_rows > 32) chunk_rows = 32;
  const long long chunks = (k + chunk_rows - 1) / chunk_rows;
  long long blocks = (chunks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > resident) blocks = resident;
  row_write_bulk_kernel<IdT>
      <<<static_cast<unsigned>(blocks), WARPS_PER_BLOCK * 32, SMEM_BYTES, s>>>(
          static_cast<unsigned char*>(table), static_cast<const IdT*>(ids),
          static_cast<const unsigned char*>(rows), k, p, row_bytes,
          chunk_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int row_write(void* table, const void* ids, const void* rows,
                         long long k, long long p, int lanes, int ids_are_64,
                         void* stream) {
  if (k <= 0 || p <= 0) return (int)cudaSuccess;
  if (lanes <= 0 || lanes % 128 != 0 || lanes * 4 > CHUNK_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ids_are_64 ? launch<long long>(table, ids, rows, k, p, lanes, s)
                          : launch<int>(table, ids, rows, k, p, lanes, s));
}

extern "C" const char* row_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
