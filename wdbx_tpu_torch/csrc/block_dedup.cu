// Block-list dedup of the clustered scan for Hopper (sm_90a), CUDA C++.
//
// Replaces, on the card, the chain of PyTorch operations of
// wdbx_tpu_torch/index/clustered.py _dedup_blocks_plain (the JAX package's
// _dedup_blocks: a gather, a sort, two searchsorted, a top-k and some
// twenty element-wise steps, each its own launch).
// Function: for the r probed bucket ids `probe` (queries x nprobe), the
// blocks blk_lo[p] + j, j < m, below blk_hi[p] of each probed bucket p,
// less the blocks whose c validity bytes are all zero (when `valid` is
// given): each distinct block once, ordered by the number of probe
// entries that list it (most first; the count capped at `cap_count`, the
// JAX ranking's int32 clamp), ties by the lower block id. The first u of
// them go to uniq with ok 1; the entries past the distinct blocks hold
// block nblocks - 1 with ok 0.
//
// Design. One CTA of 1,024 threads, since the list is small (some 2,900
// distinct blocks of 9,766 at 10M x 768, c = 1,024, B = 128, nprobe 8):
// a shared-memory count per block, raised with shared atomics over the
// r x m probe entries; a warp per counted block reads its validity bytes
// (16 bytes a lane where aligned) and clears the count of a dead block;
// the counted blocks are compacted as 64-bit keys ((INT32_MAX - count) <<
// 32 | id), so that ascending order is the ranking, and bitonic-sorted in
// shared memory over the next power of two of their number. Shared memory
// holds 8 bytes a key for the next power of two of nblocks and 4 bytes a
// count: nblocks <= kMaxBlocks (16,384) fits the 227 KB a CTA may have.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBlocks = 16384;

__global__ void __launch_bounds__(kThreads)
block_dedup_kernel(const int64_t* __restrict__ probe, int r,
                   const int64_t* __restrict__ blk_lo,
                   const int64_t* __restrict__ blk_hi, int m,
                   const uint8_t* __restrict__ valid, int c, int nblocks,
                   int keys_len, int cap_count, int u,
                   int64_t* __restrict__ uniq, bool* __restrict__ ok) {
  extern __shared__ unsigned long long keys[];
  int* counts = reinterpret_cast<int*>(keys + keys_len);
  __shared__ int n_live;
  const int tid = threadIdx.x;
  for (int i = tid; i < nblocks; i += kThreads) counts[i] = 0;
  if (tid == 0) n_live = 0;
  __syncthreads();

  const long long entries = (long long)r * m;
  for (long long e = tid; e < entries; e += kThreads) {
    const long long row = e / m;
    const int64_t p = probe[row];
    const int64_t blk = blk_lo[p] + (e - row * m);
    if (blk < blk_hi[p] && blk >= 0 && blk < nblocks)
      atomicAdd(&counts[blk], 1);
  }
  __syncthreads();

  if (valid != nullptr) {
    const int warp = tid >> 5, lane = tid & 31;
    const bool vec =
        (reinterpret_cast<uintptr_t>(valid) & 15) == 0 && c % 16 == 0;
    for (int blk = warp; blk < nblocks; blk += kThreads / 32) {
      if (counts[blk] == 0) continue;  // the same word for the whole warp
      const uint8_t* rows = valid + (long long)blk * c;
      bool live = false;
      if (vec) {
        const uint4* v4 = reinterpret_cast<const uint4*>(rows);
        for (int i = lane; i < c / 16; i += 32) {
          const uint4 x = v4[i];
          live |= (x.x | x.y | x.z | x.w) != 0;
        }
      } else {
        for (int i = lane; i < c; i += 32) live |= rows[i] != 0;
      }
      if (!__any_sync(0xffffffffu, live) && lane == 0) counts[blk] = 0;
    }
    __syncthreads();
  }

  for (int blk = tid; blk < nblocks; blk += kThreads) {
    const int cnt = counts[blk];
    if (cnt > 0) {
      const int at = atomicAdd(&n_live, 1);
      const int capped = cnt < cap_count ? cnt : cap_count;
      keys[at] = ((unsigned long long)(unsigned)(INT32_MAX - capped) << 32) |
                 (unsigned)blk;
    }
  }
  __syncthreads();
  const int live = n_live;
  int p2 = 1;
  while (p2 < live) p2 <<= 1;
  for (int i = live + tid; i < p2; i += kThreads) keys[i] = ~0ULL;
  __syncthreads();

  for (int k2 = 2; k2 <= p2; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += kThreads) {
        const int other = i ^ j;
        if (other > i) {
          const unsigned long long a = keys[i], b = keys[other];
          if ((a > b) == ((i & k2) == 0)) {
            keys[i] = b;
            keys[other] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < u; i += kThreads) {
    const bool hit = i < live;
    uniq[i] = hit ? (int64_t)(keys[i] & 0xffffffffULL) : nblocks - 1;
    ok[i] = hit;
  }
}

}  // namespace

extern "C" {

// probe (r,) int64 bucket ids; blk_lo / blk_hi (nlist,) int64 block
// extents; valid (nblocks * c,) bytes or null; uniq (u,) int64 and ok (u,)
// bool outputs. cap_count >= 1.
int wdbx_block_dedup(const void* probe, int r, const void* blk_lo,
                     const void* blk_hi, int m, const void* valid, int c,
                     int nblocks, int cap_count, int u, void* uniq, void* ok,
                     void* stream) {
  if (r < 1 || m < 1 || nblocks < 1 || nblocks > kMaxBlocks || u < 1 ||
      cap_count < 1 || (valid != nullptr && c < 1))
    return (int)cudaErrorInvalidValue;
  int keys_len = 1;
  while (keys_len < nblocks) keys_len <<= 1;
  const size_t smem = (size_t)keys_len * sizeof(unsigned long long) +
                      (size_t)nblocks * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      block_dedup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_dedup_kernel<<<1, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(probe), r,
      static_cast<const int64_t*>(blk_lo),
      static_cast<const int64_t*>(blk_hi), m,
      static_cast<const uint8_t*>(valid), c, nblocks, keys_len, cap_count, u,
      static_cast<int64_t*>(uniq), static_cast<bool*>(ok));
  return (int)cudaGetLastError();
}

}  // extern "C"
