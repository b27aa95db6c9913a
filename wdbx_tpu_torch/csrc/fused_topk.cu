// Fused streaming score + top-k for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas bodies of wdbx_tpu/kernels/fused_topk.py:
//   _kernel       (fused_topk.py:153)  float32 / bfloat16 slabs
//   _kernel_int8  (fused_topk.py:177)  int8 slabs, and packed int4 slabs
//                                     unpacked one tile at a time
// Function: for queries q (B, d) and a slab (N, d), the k largest
// q . row (float32 accumulation; int8/int4 rows times their row scale),
// over rows whose validity byte is non-zero, sorted descending, with
// -inf / -1 where fewer than k rows are valid.
//
// Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s of float32 FMAs): bf16 /
// int8 slabs are bound by the slab read (1M x 384 bf16 is 805 MB, 0.24
// ms per batch; int8 0.12 ms); packed int4 by ~0.10 ms of bf16
// tensor-core work at B = 128; float32 by operations: true float32 runs
// on the CUDA cores, 2 B N d FMAs = 103 GFLOP at B = 128, 1.54 ms, while
// its 1.6 GB slab is 0.48 ms of bytes.
//
// Design. On the TPU the grid runs in order and carries the running
// top-k in VMEM scratch; here CTAs run in parallel, so the work is two
// hand-written stages:
//   1. fused_topk_partial: grid (query tiles) x (row chunks). A CTA
//      streams its chunk in row tiles through shared memory, scores them
//      (int4 bytes are unpacked in registers after the load, so HBM moves
//      0.5 byte per dim and no unpacked slab ever exists), applies the
//      row scale and the validity mask, and feeds each query's scores
//      into a per-query candidate buffer in shared memory. A candidate
//      enters only when it beats that query's current k-th best; when
//      the buffer fills, a warp-level radix select cuts it back to
//      exactly k. The CTA writes its k survivors per query (unsorted) to
//      (B, chunks, k).
//   2. topk_merge_partials: one warp per query streams the partials
//      through the same buffer, then ranks the final k into sorted order.
// Selection is exact: the TPU kernel's grouped pre-reduction (`group`)
// is not reproduced, which can only raise recall against it.
// Stage-1 bodies (topk_common.cuh, shared with clustered_scan.cu), named
// by the launcher:
//   * bf16, int8 and int4 slabs: mma.sync bf16 -> f32 on the tensor cores
//     when d % 32 == 0 and the operands are 16-byte aligned;
//   * float32 slabs with d % 4 == 0 and 16-byte aligned operands:
//     scan_fma_tiled, the operation-bound case's body: 128-row x
//     128-query tiles with 8 x 8 float32 accumulators a thread, a
//     3-stage cp.async ring with one barrier per 32-dim slice, and
//     selection from registers (no score tile in shared memory). Its
//     grid gives each SM an equal share of long row chunks in whole
//     waves. TF32 stays off: the products and sums are float32 FMAs, as
//     the JAX package's float32 path asks (precision "highest");
//   * everything else (ragged widths, unaligned views): scan_fma.
// No wgmma or TMA yet: times in PERF.md.

#include "topk_common.cuh"

namespace {

constexpr int kMergeWarps = 4;

// ---------------------------------------------------------------------
// Stage 1: one CTA scores the QT queries of its tile against its chunk
// of rows with one of the scan bodies of topk_common.cuh.
template <int SLAB, int TQ, bool MMA>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial_kernel(const void* __restrict__ db,
                          const void* __restrict__ q,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ scales, int n, int d,
                          int b, int k, int cap, int rows_per_chunk,
                          float* __restrict__ part_v,
                          int* __restrict__ part_i) {
  constexpr int QT = 16 * TQ;
  constexpr int QTYPE = SLAB == kF32 ? kQF32 : kQBF16;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_words = MMA ? mma_tile_words(QT) : fma_tile_words(QT);
  const CtaSel sel(reinterpret_cast<uint32_t*>(smem) + tile_words, QT, cap,
                   k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const int chunk = blockIdx.y;
  const int row_begin = chunk * rows_per_chunk;
  const RangeTiles tiles{row_begin, min(n, row_begin + rows_per_chunk)};
  if constexpr (MMA)
    scan_mma<SLAB, QTYPE, TQ>(tiles, sel, smem, db, q, nullptr, valid,
                              scales, d, b, q0);
  else
    scan_fma<SLAB, QTYPE, TQ>(tiles, sel, smem, db, q, nullptr, valid,
                              scales, d, b, q0);
  sel.write(q0, b, chunk, gridDim.y, part_v, part_i, warp, lane);
}

// The float32 body: QT = 16 * TQ queries x the chunk's 128-row tiles.
template <int TQ>
__global__ void __launch_bounds__(kThreads, 1)
fused_topk_tiled_kernel(const float* __restrict__ db,
                        const float* __restrict__ q,
                        const uint8_t* __restrict__ valid, int n, int d,
                        int b, int k, int cap, int rows_per_chunk,
                        float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int QT = 16 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const CtaSel sel(reinterpret_cast<uint32_t*>(smem) + fma_tiled_words(QT),
                   QT, cap, k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const int row_begin = blockIdx.y * rows_per_chunk;
  const RangeTiles tiles{row_begin, min(n, row_begin + rows_per_chunk)};
  scan_fma_tiled<TQ>(tiles, sel, smem, db, q, valid, d, b, q0);
  sel.write<true>(q0, b, blockIdx.y, gridDim.y, part_v, part_i, warp, lane);
}

template <int TQ>
cudaError_t launch_tiled(const void* db, const void* q, const void* valid,
                         int n, int d, int b, int k, int cap,
                         int rows_per_chunk, int chunks, void* part_v,
                         void* part_i, cudaStream_t stream) {
  constexpr int QT = 16 * TQ;
  const size_t smem = fma_tiled_smem_bytes(QT, cap);
  auto kern = fused_topk_tiled_kernel<TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, chunks);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(db), static_cast<const float*>(q),
      static_cast<const uint8_t*>(valid), n, d, b, k, cap, rows_per_chunk,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return cudaGetLastError();
}

template <int SLAB, int TQ>
cudaError_t launch_partial(bool tensor_cores, const void* db, const void* q,
                           const void* valid, const void* scales, int n,
                           int d, int b, int k, int cap, int rows_per_chunk,
                           int chunks, void* part_v, void* part_i,
                           cudaStream_t stream) {
  constexpr int QT = 16 * TQ;
  const size_t smem = tensor_cores ? mma_smem_bytes(QT, cap)
                                   : partial_smem_bytes(QT, cap);
  auto kern = fused_topk_partial_kernel<SLAB, TQ, false>;
  if constexpr (SLAB != kF32)
    if (tensor_cores) kern = fused_topk_partial_kernel<SLAB, TQ, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, chunks);
  kern<<<grid, kThreads, smem, stream>>>(
      db, q, static_cast<const uint8_t*>(valid),
      static_cast<const float*>(scales), n, d, b, k, cap, rows_per_chunk,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return cudaGetLastError();
}

template <int TQ>
cudaError_t dispatch_slab(int slab, bool mma, const void* db, const void* q,
                          const void* valid, const void* scales, int n, int d,
                          int b, int k, int cap, int rpc, int chunks,
                          void* pv, void* pi, cudaStream_t st) {
  switch (slab) {
    case kF32:
      return launch_partial<kF32, TQ>(false, db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case kBF16:
      return launch_partial<kBF16, TQ>(mma, db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case kI8:
      return launch_partial<kI8, TQ>(mma, db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case kI4:
      return launch_partial<kI4, TQ>(mma, db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// Stage 2.
size_t merge_smem_bytes(int cap) {
  return (size_t)kMergeWarps * (2 * (size_t)cap + 256 + 2) * 4;
}

__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge_partials_kernel(const float* __restrict__ pv,
                           const int* __restrict__ pi, int b, int m, int k,
                           int cap, float* __restrict__ out_v,
                           int64_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= b) return;
  unsigned char* mine = smem + (size_t)warp * (2 * (size_t)cap + 256 + 2) * 4;
  float* sv = reinterpret_cast<float*>(mine);
  int* si = reinterpret_cast<int*>(sv + cap);
  unsigned* hist = reinterpret_cast<unsigned*>(si + cap);
  int* cnt = reinterpret_cast<int*>(hist + 256);
  float* thr = reinterpret_cast<float*>(cnt + 1);
  if (lane == 0) {
    *cnt = 0;
    *thr = -INFINITY;
  }
  __syncwarp();
  const Sel s{sv, si, cnt, thr, hist};
  const float* qv = pv + (size_t)q * m;
  const int* qi = pi + (size_t)q * m;
  for (int base = 0; base < m; base += 32) {
    const int e = base + lane;
    const float v = e < m ? qv[e] : -INFINITY;
    const int id = e < m ? qi[e] : -1;
    sel_offer(s, v, id, k, cap, lane);
  }
  sel_shrink(s, k, lane);
  const int c = *cnt;
  float* ov = out_v + (size_t)q * k;
  int64_t* oi = out_i + (size_t)q * k;
  // rank sort: descending score, ties by buffer position
  for (int e = lane; e < c; e += 32) {
    const float v = sv[e];
    int rank = 0;
    for (int j = 0; j < c; ++j) {
      const float u = sv[j];
      rank += (u > v) || (u == v && j < e);
    }
    ov[rank] = v;
    oi[rank] = si[e];
  }
  for (int e = c + lane; e < k; e += 32) {
    ov[e] = -INFINITY;
    oi[e] = -1;
  }
}

}  // namespace

extern "C" {

// Shared memory a stage-1 CTA of qt queries needs: the tiled body's, or
// the larger of the other two bodies'.
size_t wdbx_fused_topk_partial_smem(int body, int qt, int cap) {
  if (body == kBodyFmaTiled) return fma_tiled_smem_bytes(qt, cap);
  const size_t a = partial_smem_bytes(qt, cap), b = mma_smem_bytes(qt, cap);
  return a > b ? a : b;
}

// body: 0 scan_fma, 1 scan_mma, 2 scan_fma_tiled (Body); a body whose
// rule the arguments break is refused: scan_mma takes bf16 / int8 / int4
// slabs with d % 32 == 0, scan_fma_tiled float32 slabs with d % 4 == 0,
// both with 16-byte aligned slab and queries. slab: 0 float32, 1
// bfloat16, 2 int8, 3 packed int4. qt queries per CTA: 128, 64, 32 or 16
// (scan_fma_tiled), 64 or 16 (the others); rows_per_chunk a multiple of
// 128. Queries are float32 for a float32 slab, else bf16.
// part_v (b, chunks, k) float32 and part_i (b, chunks, k) int32.
int wdbx_fused_topk_partial(int body, int slab, int qt, const void* db,
                            const void* q, const void* valid,
                            const void* scales, int n, int d, int b, int k,
                            int cap, int rows_per_chunk, int chunks,
                            void* part_v, void* part_i, void* stream) {
  if (k < 1 || cap < k + 32 || n < 1 || b < 1 || d < 1 ||
      rows_per_chunk % kRowsM != 0 || (slab == kI4 && d % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(db) && aligned16(q);
  if (body == kBodyFmaTiled) {
    if (slab != kF32 || d % 4 != 0 || !aligned)
      return (int)cudaErrorInvalidValue;
#define WDBX_TILED(TQ)                                                     \
  return (int)launch_tiled<TQ>(db, q, valid, n, d, b, k, cap, rows_per_chunk, \
                               chunks, part_v, part_i, st)
    switch (qt) {
      case 128: WDBX_TILED(8);
      case 64: WDBX_TILED(4);
      case 32: WDBX_TILED(2);
      case 16: WDBX_TILED(1);
    }
#undef WDBX_TILED
    return (int)cudaErrorInvalidValue;
  }
  const bool mma = body == kBodyMma;
  if ((body != kBodyFma && !mma) ||
      (mma && (slab == kF32 || d % 32 != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  if (qt == 64)
    return (int)dispatch_slab<4>(slab, mma, db, q, valid, scales, n, d, b, k,
                                 cap, rows_per_chunk, chunks, part_v, part_i,
                                 st);
  if (qt == 16)
    return (int)dispatch_slab<1>(slab, mma, db, q, valid, scales, n, d, b, k,
                                 cap, rows_per_chunk, chunks, part_v, part_i,
                                 st);
  return (int)cudaErrorInvalidValue;
}

// m = chunks * k candidates per query; out_v (b, k) float32, out_i (b, k)
// int64, sorted descending, -inf / -1 past the valid count.
int wdbx_topk_merge_partials(const void* part_v, const void* part_i, int b,
                             int m, int k, int cap, void* out_v, void* out_i,
                             void* stream) {
  if (k < 1 || cap < k + 32 || b < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = merge_smem_bytes(cap);
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (b + kMergeWarps - 1) / kMergeWarps;
  topk_merge_partials_kernel<<<blocks, kMergeWarps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), b,
      m, k, cap, static_cast<float*>(out_v), static_cast<int64_t*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
