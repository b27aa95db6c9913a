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
//   2. topk_merge_partials: one CTA of 8 warps per query; each warp
//      streams a share of the partials through its own buffer, one
//      CTA-wide select keeps exactly k, and a bitonic sort in shared
//      memory orders them.
// Selection is exact: the TPU kernel's grouped pre-reduction (`group`)
// is not reproduced, which can only raise recall against it.
// Stage-1 bodies (topk_common.cuh, shared with clustered_scan.cu), named
// by the launcher:
//   * bf16, int8 and packed int4 slabs, d % 32 == 0, 16-byte aligned
//     operands and k whose buffers fit: scan_mma_pipe, mma.sync bf16 ->
//     f32 on queries resident in shared memory, a 3-stage cp.async ring
//     of 128-byte row slices with one barrier per slice, ldmatrix
//     fragments (int8 and int4 codes converted in registers), selection
//     from registers, and the float32 body's whole-wave grid at one CTA a
//     SM;
//   * the tensor-core launches whose buffers fit no query tile (k = 128
//     or 1024 at these widths): scan_mma, mma.sync bf16 -> f32 with the
//     slices staged through shared memory;
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

constexpr int kMergeWarps = 8;

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

// The pipelined tensor-core body (bf16 queries; bf16, int8 or int4
// rows): QT = 128 / WR queries x the chunk's 128-row tiles; the WR warps
// that share a query write WR parts of it.
template <int SLAB, int WR, int KQ>
__global__ void __launch_bounds__(kThreads, 1)
fused_topk_pipe_kernel(const void* __restrict__ db, const void* __restrict__ q,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ scales, int n, int d, int b,
                       int k, int cap, int rows_per_chunk,
                       float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int QT = 128 / WR;
  extern __shared__ __align__(16) unsigned char smem[];
  const PipeSel sel(
      reinterpret_cast<uint32_t*>(smem) + pipe_words(SLAB, kQBF16, QT, d),
      cap, k);
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  const int row_begin = blockIdx.y * rows_per_chunk;
  const RangeTiles tiles{row_begin, min(n, row_begin + rows_per_chunk)};
  scan_mma_pipe<SLAB, kQBF16, WR, KQ>(
      tiles, sel, smem, db, q, nullptr, valid, scales, d, b, q0, part_v,
      part_i, blockIdx.y * WR + warp % WR, gridDim.y * WR);
}

template <int SLAB, int WR>
cudaError_t launch_pipe(const void* db, const void* q, const void* valid,
                        const void* scales, int n, int d, int b, int k,
                        int cap, int rows_per_chunk, int chunks, void* part_v,
                        void* part_i, cudaStream_t stream) {
  constexpr int QT = 128 / WR;
  const size_t smem = pipe_smem_bytes(SLAB, kQBF16, QT, cap, d);
  auto kern = fused_topk_pipe_kernel<SLAB, WR, 0>;  // k in registers up to 4 kPipeKQ
  if (k <= 4 * kPipeKQ) kern = fused_topk_pipe_kernel<SLAB, WR, kPipeKQ>;
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

template <int SLAB>
cudaError_t dispatch_pipe(int qt, const void* db, const void* q,
                          const void* valid, const void* scales, int n, int d,
                          int b, int k, int cap, int rpc, int chunks, void* pv,
                          void* pi, cudaStream_t st) {
  switch (qt) {
    case 128:
      return launch_pipe<SLAB, 1>(db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case 64:
      return launch_pipe<SLAB, 2>(db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case 32:
      return launch_pipe<SLAB, 4>(db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
  }
  return cudaErrorInvalidValue;
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
// Stage 2: one CTA of kMergeWarps warps per query. Warp w streams the
// w-th contiguous share of the query's m partials into its own buffer
// (sel_offer, full buffers cut by sel_cut: no shared histogram), loading
// four 32-entry steps ahead, and cuts it to at most k. Then the CTA finds
// the k-th best key of all the warps' survivors (two bits a step, each
// warp counting its own buffer), writes the kept entries in warp order,
// then buffer order (ties at the k-th score are kept in that order) to a
// sort array of k padded to a power of two, and sorts it by (score
// descending, array position) with a bitonic network in shared memory.
// Each key is the score's order-preserving bits over the complement of
// its array position, so keys are distinct and the order is fixed by the
// inputs: the same partials give the same result on every run.
__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

size_t merge_smem_bytes(int k, int cap) {
  const size_t p = (size_t)pow2_at_least(k);
  return p * 8 + p * 4                             // sort keys and ids
         + (size_t)kMergeWarps * (2 * (size_t)cap + 2) * 4  // warp buffers
         + (size_t)kMergeWarps * 4 * 4;            // counts of a select step
}

__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge_partials_kernel(const float* __restrict__ pv,
                           const int* __restrict__ pi, int b, int m, int k,
                           int cap, float* __restrict__ out_v,
                           int64_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x;
  const int P = pow2_at_least(k);
  auto* keys = reinterpret_cast<unsigned long long*>(smem);  // [P]
  int* ids = reinterpret_cast<int*>(keys + P);                // [P]
  float* bv = reinterpret_cast<float*>(ids + P);              // [warps][cap]
  int* bi = reinterpret_cast<int*>(bv + kMergeWarps * cap);   // [warps][cap]
  int* cnt = bi + kMergeWarps * cap;                          // [warps]
  float* thr = reinterpret_cast<float*>(cnt + kMergeWarps);   // [warps]
  unsigned* part = reinterpret_cast<unsigned*>(thr + kMergeWarps);  // [warps][4]
  const Sel s{bv + (size_t)warp * cap, bi + (size_t)warp * cap, cnt + warp,
              thr + warp, nullptr};
  if (lane == 0) {
    *s.count = 0;
    *s.thr = -INFINITY;
  }
  __syncwarp();

  // this warp's share of the partials, 32-entry aligned
  const int share = ((m + kMergeWarps - 1) / kMergeWarps + 31) & ~31;
  const int lo = min(m, warp * share), hi = min(m, lo + share);
  const float* qv = pv + (size_t)q * m;
  const int* qi = pi + (size_t)q * m;
  constexpr int U = 4;
  for (int base = lo; base < hi; base += 32 * U) {
    float v[U];
    int id[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + 32 * u + lane;
      v[u] = e < hi ? __ldg(qv + e) : -INFINITY;
      id[u] = e < hi ? __ldg(qi + e) : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) sel_offer<true>(s, v[u], id[u], k, cap, lane);
  }
  sel_cut(s, k, lane);
  __syncthreads();

  // the k-th best key t of all survivors (0 when there are at most k)
  int total = 0;
#pragma unroll
  for (int w = 0; w < kMergeWarps; ++w) total += cnt[w];
  const int c = *s.count;
  // keys of this warp's buffer at or above x, y and z, summed over the CTA
  auto cta_counts = [&](unsigned x, unsigned y, unsigned z, unsigned& nx,
                        unsigned& ny, unsigned& nz) {
    unsigned a = 0, bz = 0;
    for (int e = lane; e < c; e += 32) {
      const unsigned key = f2key(s.v[e]);
      a += (key >= x) | (key >= y) << 16;
      bz += key >= z;
    }
    a = __reduce_add_sync(kFull, a);
    bz = __reduce_add_sync(kFull, bz);
    if (lane == 0) {
      part[warp * 4] = a;
      part[warp * 4 + 1] = bz;
    }
    __syncthreads();
    nx = ny = nz = 0;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) {
      nx += part[w * 4] & 0xffffu;
      ny += part[w * 4] >> 16;
      nz += part[w * 4 + 1];
    }
    __syncthreads();
  };
  unsigned t = 0;
  if (total > k) {
    const unsigned want = (unsigned)k;
    for (int bit = 30; bit >= 0; bit -= 2) {
      const unsigned t1 = t | (1u << bit), t2 = t | (2u << bit),
                     t3 = t | (3u << bit);
      unsigned n1, n2, n3;
      cta_counts(t1, t2, t3, n1, n2, n3);
      t = n3 >= want ? t3 : n2 >= want ? t2 : n1 >= want ? t1 : t;
    }
  }
  // per warp: keys above t, and keys equal to t
  {
    unsigned above = 0, eq = 0;
    for (int e = lane; e < c; e += 32) {
      const unsigned key = f2key(s.v[e]);
      above += key > t;
      eq += key == t;
    }
    above = __reduce_add_sync(kFull, above);
    eq = __reduce_add_sync(kFull, eq);
    if (lane == 0) {
      part[warp * 4 + 2] = above;
      part[warp * 4 + 3] = eq;
    }
  }
  __syncthreads();
  int remaining = k, base = 0, eq_before = 0, eq_take = 0;
#pragma unroll
  for (int w = 0; w < kMergeWarps; ++w) remaining -= (int)part[w * 4 + 2];
  for (int w = 0; w < kMergeWarps; ++w) {
    const int a = (int)part[w * 4 + 2], e = (int)part[w * 4 + 3];
    const int take = max(0, min(e, remaining - eq_before));
    if (w == warp) {
      eq_take = take;
      break;
    }
    base += a + take;
    eq_before += e;
  }
  const int keep = min(total, k);
  // this warp's kept entries, in buffer order, at base.. of the sort array
  int w_at = base, eq_seen = 0;
  for (int e0 = 0; e0 < c; e0 += 32) {
    const int e = e0 + lane;
    const bool in = e < c;
    const unsigned key = in ? f2key(s.v[e]) : 0u;
    const bool eq = in && key == t;
    const unsigned eqm = __ballot_sync(kFull, eq);
    const bool kept = (in && key > t) ||
                      (eq && eq_seen + __popc(eqm & lanes_below(lane)) < eq_take);
    const unsigned km = __ballot_sync(kFull, kept);
    if (kept) {
      const int pos = w_at + __popc(km & lanes_below(lane));
      keys[pos] = (unsigned long long)key << 32 | (0xffffffffu - (unsigned)pos);
      ids[pos] = s.i[e];
    }
    w_at += __popc(km);
    eq_seen += __popc(eqm);
  }
  for (int e = keep + tid; e < P; e += kMergeWarps * 32) keys[e] = 0ull;

  // bitonic sort, descending
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < P / 2; i += kMergeWarps * 32) {
        const int l = 2 * i - (i & (stride - 1)), r = l + stride;
        const unsigned long long x = keys[l], y = keys[r];
        if ((x < y) == ((l & size) == 0)) {
          keys[l] = y;
          keys[r] = x;
        }
      }
    }
  __syncthreads();
  float* ov = out_v + (size_t)q * k;
  int64_t* oi = out_i + (size_t)q * k;
  for (int e = tid; e < k; e += kMergeWarps * 32) {
    if (e < keep) {
      const unsigned long long x = keys[e];
      ov[e] = key2f((unsigned)(x >> 32));
      oi[e] = ids[0xffffffffu - (unsigned)(x & 0xffffffffu)];
    } else {
      ov[e] = -INFINITY;
      oi[e] = -1;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory a stage-1 CTA of qt queries needs: the tiled or the
// pipelined body's, or the larger of the other two bodies'.
size_t wdbx_fused_topk_partial_smem(int body, int slab, int qt, int cap,
                                    int d) {
  if (body == kBodyFmaTiled) return fma_tiled_smem_bytes(qt, cap);
  if (body == kBodyMmaPipe) return pipe_smem_bytes(slab, kQBF16, qt, cap, d);
  const size_t a = partial_smem_bytes(qt, cap), b = mma_smem_bytes(qt, cap);
  return a > b ? a : b;
}

// body: 0 scan_fma, 1 scan_mma, 2 scan_fma_tiled, 3 scan_mma_pipe
// (Body); a body whose rule the arguments break is refused: scan_mma
// and scan_mma_pipe take bf16 / int8 / int4 slabs with d % 32 == 0
// (scan_mma_pipe's shared memory must fit, or the launch fails),
// scan_fma_tiled float32 slabs with d % 4 == 0, all with 16-byte
// aligned slab and queries. slab: 0 float32, 1 bfloat16, 2 int8, 3
// packed int4. qt queries per CTA: 128, 64, 32 or 16 (scan_fma_tiled),
// 128, 64 or 32 (scan_mma_pipe), 64 or 16 (the others); rows_per_chunk a
// multiple of 128. Queries are float32 for a float32 slab, else bf16.
// part_v (b, parts, k) float32 and part_i (b, parts, k) int32, parts =
// chunks, or chunks * 128 / qt for scan_mma_pipe.
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
  if (body == kBodyMmaPipe) {
    if (slab == kF32 || d % 32 != 0 || !aligned ||
        (slab != kBF16 && scales == nullptr))
      return (int)cudaErrorInvalidValue;
#define WDBX_PIPE(S)                                                       \
  return (int)dispatch_pipe<S>(qt, db, q, valid, scales, n, d, b, k, cap, \
                               rows_per_chunk, chunks, part_v, part_i, st)
    if (slab == kBF16) WDBX_PIPE(kBF16);
    if (slab == kI8) WDBX_PIPE(kI8);
    WDBX_PIPE(kI4);
#undef WDBX_PIPE
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
  // deeper buffers than stage 1's: a warp cuts once per k new entries
  cap = max(cap, 2 * k + 32);
  const size_t smem = merge_smem_bytes(k, cap);
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_merge_partials_kernel<<<b, kMergeWarps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), b,
      m, k, cap, static_cast<float*>(out_v), static_cast<int64_t*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
