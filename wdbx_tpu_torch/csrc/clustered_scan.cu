// Clustered block scan + top-k for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas bodies of wdbx_tpu/kernels/clustered_scan.py:
//   _kernel_v2  (clustered_scan.py:107)  float32 / bf16 / int8 / packed
//                                        int4 slabs; bf16 or int8 queries
//   _kernel     (clustered_scan.py:50)   v1: float32 / bf16 / int8 slabs
//                                        with bf16 or float32 queries
// Function: for queries q (B, d) and a cluster-ordered slab (cap, d) seen
// as cap / c blocks of c rows, the k largest q . row over the rows of the
// blocks listed in uniq[0..u) whose ok entry is non-zero and whose
// validity byte is non-zero; int8 / int4 rows times their row scale, and
// with int8 queries (int8 x int8 -> int32 products) times the query's
// scale after the row scale. Positions are global slab rows, blk * c +
// row. v1 is the same function with bf16 / float32 queries, so it is a
// mode of the same kernel with its own launch counter (in Python).
//
// Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s of float32 FMAs): the
// listed blocks' bytes for bf16 / int8 / int4 rows. At 10M x 768 int8,
// c = 1,024, nprobe 1 and B = 128, some 420 live blocks of 0.79 MB: 0.33
// GB, about 0.1 ms per batch; their bf16 tensor-core work (2 B blocks c d
// = 83 GFLOP) is another 0.08 ms at 989 TFLOP/s. float32 rows are bound
// by operations: true float32 runs on the CUDA cores, and at 1M x 384,
// nprobe 1, B = 128 (~190 live blocks of 1,024 rows) the 19 GFLOP take
// 0.29 ms against 0.09 ms of bytes.
//
// Design. On the TPU a sequential grid walks the block list, with the
// block ids scalar-prefetched into the index maps and the running top-k
// in VMEM. Here stage 1 (clustered_block_partial) runs on a grid of
// (query tiles) x (groups). Each CTA reads the block list uniq / ok from
// device memory itself (no host sync on the list), keeps the blocks with
// ok != 0 (the dedup padding is skipped: it loads nothing), and scores
// their c-row tiles for its query tile with the scan bodies of
// topk_common.cuh, the same code as the fused flat scan, named by the
// launcher:
//   * bf16, int8 and int4 rows: scan_mma_pipe (resident queries, a
//     cp.async ring, selection from registers; bf16 products against bf16
//     queries with int8 / int4 codes converted in registers, s8 m16n8k32
//     products on raw bytes against int8 queries, int4 nibbles as u8
//     codes less 8 sum(q)), its CTAs taking equal spans of the live tiles
//     as the float32 body's do, when its rule holds (k and d whose buffers
//     fit);
//   * otherwise scan_mma: mma.sync bf16 for bf16 rows and for int8 / int4
//     rows against bf16 queries (int8 converted, int4 unpacked after the
//     load), mma.sync s8 m16n8k32 for int8 / int4 rows against int8
//     queries; a group is `ways` consecutive list entries;
//   * float32 rows with float32 queries, d % 4 == 0 and 16-byte aligned
//     operands: scan_fma_tiled (128 x 128 register tiles of float32
//     FMAs, a 3-stage cp.async ring, selection from registers; TF32
//     stays off). Every CTA counts the live entries of the whole list and
//     takes an equal span of their 128-row tiles, so a 1,024-row block
//     may be split across CTAs and the grid, a whole number of waves,
//     ends together however many entries are live;
//   * scan_fma (CUDA-core float32 FMAs) for widths off those rules and
//     unaligned views.
// Row scale, query scale and the validity mask apply before the
// per-query top-k, which a CTA writes to its group's slot of (B, groups,
// k). A CTA with no live tile writes -inf / -1 partials. Stage 2 is
// topk_merge_partials of fused_topk.cu.
// Selection is exact: `group` and `n_ways` of the TPU kernels (the
// approximate grouped and pair reductions) are not reproduced, which can
// only raise recall against them. The int8-query scale is applied to
// every score before selection instead of at emit: a positive scale
// keeps the order, and (acc * row scale) * query scale is the TPU
// kernel's emitted value bit for bit. No wgmma or TMA yet: times in
// PERF.md.

#include "topk_common.cuh"

namespace {

constexpr int kMaxWays = 32;  // block-list entries per CTA

template <int SLAB, int QTYPE, int TQ, bool MMA>
__global__ void __launch_bounds__(kThreads)
clustered_block_partial_kernel(const void* __restrict__ db,
                               const void* __restrict__ q,
                               const float* __restrict__ qscale,
                               const uint8_t* __restrict__ valid,
                               const float* __restrict__ scales,
                               const int* __restrict__ uniq,
                               const int* __restrict__ ok, int nblocks, int u,
                               int ways, int c, int d, int b, int k, int cap,
                               float* __restrict__ part_v,
                               int* __restrict__ part_i) {
  constexpr int QT = 16 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int blk[kMaxWays];
  __shared__ int nlive;
  const size_t tile_words = MMA ? mma_tile_words(QT) : fma_tile_words(QT);
  const CtaSel sel(reinterpret_cast<uint32_t*>(smem) + tile_words, QT, cap,
                   k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const int group = blockIdx.y;
  if (threadIdx.x == 0) {  // this CTA's live blocks, in list order
    int n = 0;
    for (int j = 0; j < ways; ++j) {
      const int e = group * ways + j;
      if (e >= u || ok[e] == 0) continue;
      const int id = uniq[e];
      if (id >= 0 && id < nblocks) blk[n++] = id;
    }
    nlive = n;
  }
  __syncthreads();
  const BlockTiles tiles{blk, nlive, c};
  if constexpr (MMA)
    scan_mma<SLAB, QTYPE, TQ>(tiles, sel, smem, db, q, qscale, valid, scales,
                              d, b, q0);
  else
    scan_fma<SLAB, QTYPE, TQ>(tiles, sel, smem, db, q, qscale, valid, scales,
                              d, b, q0);
  sel.write(q0, b, group, gridDim.y, part_v, part_i, warp, lane);
}

// This CTA's equal span of the live entries' 128-row tiles (group g of
// `groups`): every thread counts the live entries of the whole list,
// then the span's entries are written to blk in list order. groups *
// (kMaxWays - 1) >= u keeps a span within kMaxWays entries. Every thread
// of the CTA calls it.
__device__ SpanTiles cta_span(const int* __restrict__ uniq,
                              const int* __restrict__ ok, int nblocks, int u,
                              int c, int group, int groups, int* blk,
                              int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto live = [&](int e) {
    if (e >= u || ok[e] == 0) return false;
    const int id = uniq[e];
    return id >= 0 && id < nblocks;
  };
  int nlive = 0;
  for (int base = 0; base < u; base += kThreads)
    nlive += __syncthreads_count(live(base + tid));
  // this CTA's tiles [t0, t1) of the live entries' tiles, in list order
  const int per = (c + kTRows - 1) / kTRows;
  const long long total = (long long)nlive * per;
  const long long span = (total + groups - 1) / groups;
  const long long t0 = group * span, t1 = min(t0 + span, total);
  const int ntiles = t1 > t0 ? (int)(t1 - t0) : 0;
  const int e_lo = ntiles ? (int)(t0 / per) : 0;
  const int e_hi = ntiles ? (int)((t1 - 1) / per) : -1;
  int rank0 = 0;  // live entries before this pass
  for (int base = 0; base < u && rank0 <= e_hi; base += kThreads) {
    const int e = base + tid;
    const bool f = live(e);
    const unsigned m = __ballot_sync(kFull, f);
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    int rank = rank0 + __popc(m & lanes_below(lane)), all = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) rank += wsum[w];
      all += wsum[w];
    }
    if (f && rank >= e_lo && rank <= e_hi) blk[rank - e_lo] = uniq[e];
    rank0 += all;
    __syncthreads();
  }
  return SpanTiles{blk, ntiles ? (int)(t0 - (long long)e_lo * per) : 0,
                   ntiles, c};
}

// The float32 body: each CTA takes an equal span of the live entries'
// 128-row tiles.
template <int TQ>
__global__ void __launch_bounds__(kThreads, 1)
clustered_tiled_kernel(const float* __restrict__ db,
                       const float* __restrict__ q,
                       const uint8_t* __restrict__ valid,
                       const int* __restrict__ uniq,
                       const int* __restrict__ ok, int nblocks, int u, int c,
                       int d, int b, int k, int cap,
                       float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int QT = 16 * TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int blk[kMaxWays];
  __shared__ int wsum[kWarps];
  const CtaSel sel(reinterpret_cast<uint32_t*>(smem) + fma_tiled_words(QT),
                   QT, cap, k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const SpanTiles tiles = cta_span(uniq, ok, nblocks, u, c, blockIdx.y,
                                   gridDim.y, blk, wsum);
  scan_fma_tiled<TQ>(tiles, sel, smem, db, q, valid, d, b, q0);
  sel.write<true>(q0, b, blockIdx.y, gridDim.y, part_v, part_i, warp, lane);
}

// The pipelined tensor-core body: an equal span of the live tiles, as the
// float32 body; the WR warps that share a query write WR parts of it.
template <int SLAB, int QTYPE, int WR, int KQ>
__global__ void __launch_bounds__(kThreads, 1)
clustered_pipe_kernel(const void* __restrict__ db, const void* __restrict__ q,
                      const float* __restrict__ qscale,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ scales,
                      const int* __restrict__ uniq, const int* __restrict__ ok,
                      int nblocks, int u, int c, int d, int b, int k, int cap,
                      float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int QT = 128 / WR;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int blk[kMaxWays];
  __shared__ int wsum[kWarps];
  const PipeSel sel(
      reinterpret_cast<uint32_t*>(smem) + pipe_words(SLAB, QTYPE, QT, d),
      cap, k);
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const SpanTiles tiles = cta_span(uniq, ok, nblocks, u, c, blockIdx.y,
                                   gridDim.y, blk, wsum);
  scan_mma_pipe<SLAB, QTYPE, WR, KQ>(
      tiles, sel, smem, db, q, qscale, valid, scales, d, b, q0, part_v,
      part_i, blockIdx.y * WR + warp % WR, gridDim.y * WR);
}

template <int SLAB, int QTYPE, int WR>
cudaError_t launch_pipe(const void* db, const void* q, const void* qscale,
                        const void* valid, const void* scales,
                        const void* uniq, const void* ok, int nblocks, int u,
                        int c, int d, int b, int k, int cap, int groups,
                        void* part_v, void* part_i, cudaStream_t stream) {
  constexpr int QT = 128 / WR;
  const size_t smem = pipe_smem_bytes(SLAB, QTYPE, QT, cap, d);
  // k in registers up to 4 kPipeKQ
  auto kern = clustered_pipe_kernel<SLAB, QTYPE, WR, 0>;
  if (k <= 4 * kPipeKQ) kern = clustered_pipe_kernel<SLAB, QTYPE, WR, kPipeKQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, groups);
  kern<<<grid, kThreads, smem, stream>>>(
      db, q, static_cast<const float*>(qscale),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(scales),
      static_cast<const int*>(uniq), static_cast<const int*>(ok), nblocks, u,
      c, d, b, k, cap, static_cast<float*>(part_v), static_cast<int*>(part_i));
  return cudaGetLastError();
}

template <int SLAB, int QTYPE>
cudaError_t dispatch_pipe(int qt, const void* db, const void* q,
                          const void* qs, const void* valid,
                          const void* scales, const void* uniq,
                          const void* ok, int nblocks, int u, int c, int d,
                          int b, int k, int cap, int groups, void* pv,
                          void* pi, cudaStream_t st) {
#define WDBX_PIPE(WR)                                                        \
  return launch_pipe<SLAB, QTYPE, WR>(db, q, qs, valid, scales, uniq, ok,   \
                                      nblocks, u, c, d, b, k, cap, groups,   \
                                      pv, pi, st)
  switch (qt) {
    case 128: WDBX_PIPE(1);
    case 64: WDBX_PIPE(2);
    case 32: WDBX_PIPE(4);
  }
#undef WDBX_PIPE
  return cudaErrorInvalidValue;
}

template <int TQ>
cudaError_t launch_tiled(const void* db, const void* q, const void* valid,
                         const void* uniq, const void* ok, int nblocks,
                         int u, int c, int d, int b, int k, int cap,
                         int groups, void* part_v, void* part_i,
                         cudaStream_t stream) {
  constexpr int QT = 16 * TQ;
  const size_t smem = fma_tiled_smem_bytes(QT, cap);
  auto kern = clustered_tiled_kernel<TQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, groups);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(db), static_cast<const float*>(q),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(uniq),
      static_cast<const int*>(ok), nblocks, u, c, d, b, k, cap,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return cudaGetLastError();
}

template <int SLAB, int QTYPE, int TQ>
cudaError_t launch_partial(bool tensor_cores, const void* db, const void* q,
                           const void* qscale, const void* valid,
                           const void* scales, const void* uniq,
                           const void* ok, int n, int u, int ways, int c,
                           int d, int b, int k, int cap, int groups,
                           void* part_v, void* part_i, cudaStream_t stream) {
  constexpr int QT = 16 * TQ;
  const size_t smem = tensor_cores ? mma_smem_bytes(QT, cap)
                                   : partial_smem_bytes(QT, cap);
  auto kern = clustered_block_partial_kernel<SLAB, QTYPE, TQ, false>;
  if constexpr (SLAB != kF32)
    if (tensor_cores)
      kern = clustered_block_partial_kernel<SLAB, QTYPE, TQ, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + QT - 1) / QT, groups);
  kern<<<grid, kThreads, smem, stream>>>(
      db, q, static_cast<const float*>(qscale),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(scales),
      static_cast<const int*>(uniq), static_cast<const int*>(ok), n / c, u,
      ways, c, d, b, k, cap, static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  return cudaGetLastError();
}

template <int TQ>
cudaError_t dispatch(int slab, int qtype, bool mma, const void* db,
                     const void* q, const void* qs, const void* valid,
                     const void* scales, const void* uniq, const void* ok,
                     int n, int u, int ways, int c, int d, int b, int k,
                     int cap, int groups, void* pv, void* pi,
                     cudaStream_t st) {
#define WDBX_LAUNCH(S, Q)                                                   \
  return launch_partial<S, Q, TQ>(mma, db, q, qs, valid, scales, uniq, ok, n, \
                                  u, ways, c, d, b, k, cap, groups, pv, pi, st)
  if (slab == kF32 && qtype == kQF32) WDBX_LAUNCH(kF32, kQF32);
  if (slab == kBF16 && qtype == kQBF16) WDBX_LAUNCH(kBF16, kQBF16);
  if (slab == kI8 && qtype == kQBF16) WDBX_LAUNCH(kI8, kQBF16);
  if (slab == kI4 && qtype == kQBF16) WDBX_LAUNCH(kI4, kQBF16);
  if (slab == kI8 && qtype == kQI8) WDBX_LAUNCH(kI8, kQI8);
  if (slab == kI4 && qtype == kQI8) WDBX_LAUNCH(kI4, kQI8);
#undef WDBX_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory a stage-1 CTA of qt queries needs: the tiled or the
// pipelined body's (which depends on the query type), or the larger of
// the other two bodies'.
size_t wdbx_clustered_block_partial_smem(int body, int slab, int qtype,
                                         int qt, int cap, int d) {
  if (body == kBodyFmaTiled) return fma_tiled_smem_bytes(qt, cap);
  if (body == kBodyMmaPipe) return pipe_smem_bytes(slab, qtype, qt, cap, d);
  const size_t a = partial_smem_bytes(qt, cap), b = mma_smem_bytes(qt, cap);
  return a > b ? a : b;
}

// body: 0 scan_fma, 1 scan_mma, 2 scan_fma_tiled, 3 scan_mma_pipe
// (Body); a body whose rule the arguments break is refused: scan_mma and
// scan_mma_pipe take bf16 / int8 / int4 slabs with d % 32 == 0 (d % 64
// == 0 with int8 queries; scan_mma_pipe's shared memory must fit, or the
// launch fails), scan_fma_tiled float32 slabs and queries with d % 4 ==
// 0, all with 16-byte aligned slab and queries. slab: 0 float32, 1
// bfloat16, 2 int8, 3 packed int4 (n rows of the slab, n % c == 0).
// qtype: 0 float32 (float32 slab), 1 bf16, 2 int8 codes with qscale (b,)
// float32 (int8 / int4 slabs). qt queries per CTA: 128, 64, 32 or 16
// (scan_fma_tiled), 128, 64 or 32 (scan_mma_pipe), 64 or 16 (the others).
// uniq / ok (u,) int32. scan_fma_tiled and scan_mma_pipe: CTA group g
// takes the g-th equal span of the live entries' 128-row tiles, `ways` is
// unused and groups * 31 >= u; the others: group g takes entries [g *
// ways, (g + 1) * ways). part_v (b, parts, k) float32 and part_i (b,
// parts, k) int32 global slab positions, parts = groups, or groups * 128 /
// qt for scan_mma_pipe.
int wdbx_clustered_block_partial(int body, int slab, int qtype, int qt,
                                 const void* db, const void* q,
                                 const void* qscale, const void* valid,
                                 const void* scales, const void* uniq,
                                 const void* ok, int n, int u, int ways,
                                 int c, int d, int b, int k, int cap,
                                 int groups, void* part_v, void* part_i,
                                 void* stream) {
  if (k < 1 || cap < k + 32 || n < 1 || b < 1 || d < 1 || u < 1 || c < 1 ||
      n % c != 0 || groups < 1 || groups > 65535 ||
      (slab == kI4 && d % 2 != 0) || (qtype == kQI8 && qscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(db) && aligned16(q);
  if (body == kBodyFmaTiled) {
    if (slab != kF32 || qtype != kQF32 || d % 4 != 0 || !aligned ||
        (long long)groups * (kMaxWays - 1) < u)
      return (int)cudaErrorInvalidValue;
#define WDBX_TILED(TQ)                                                   \
  return (int)launch_tiled<TQ>(db, q, valid, uniq, ok, n / c, u, c, d, b, k, \
                               cap, groups, part_v, part_i, st)
    switch (qt) {
      case 128: WDBX_TILED(8);
      case 64: WDBX_TILED(4);
      case 32: WDBX_TILED(2);
      case 16: WDBX_TILED(1);
    }
#undef WDBX_TILED
    return (int)cudaErrorInvalidValue;
  }
  if (body == kBodyMmaPipe) {
    if (slab == kF32 || d % (qtype == kQI8 ? 64 : 32) != 0 || !aligned ||
        (slab != kBF16 && scales == nullptr) ||
        (long long)groups * (kMaxWays - 1) < u)
      return (int)cudaErrorInvalidValue;
#define WDBX_PIPE(S, Q)                                                    \
  return (int)dispatch_pipe<S, Q>(qt, db, q, qscale, valid, scales, uniq, \
                                  ok, n / c, u, c, d, b, k, cap, groups,  \
                                  part_v, part_i, st)
    if (slab == kBF16 && qtype == kQBF16) WDBX_PIPE(kBF16, kQBF16);
    if (slab == kI8 && qtype == kQBF16) WDBX_PIPE(kI8, kQBF16);
    if (slab == kI4 && qtype == kQBF16) WDBX_PIPE(kI4, kQBF16);
    if (slab == kI8 && qtype == kQI8) WDBX_PIPE(kI8, kQI8);
    if (slab == kI4 && qtype == kQI8) WDBX_PIPE(kI4, kQI8);
#undef WDBX_PIPE
    return (int)cudaErrorInvalidValue;
  }
  const bool mma = body == kBodyMma;
  if ((body != kBodyFma && !mma) || ways < 1 || ways > kMaxWays ||
      (long long)groups * ways < u ||
      (mma && (slab == kF32 || d % (qtype == kQI8 ? 64 : 32) != 0 ||
               !aligned)))
    return (int)cudaErrorInvalidValue;
  if (qt == 64)
    return (int)dispatch<4>(slab, qtype, mma, db, q, qscale, valid, scales,
                            uniq, ok, n, u, ways, c, d, b, k, cap, groups,
                            part_v, part_i, st);
  if (qt == 16)
    return (int)dispatch<1>(slab, qtype, mma, db, q, qscale, valid, scales,
                            uniq, ok, n, u, ways, c, d, b, k, cap, groups,
                            part_v, part_i, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
