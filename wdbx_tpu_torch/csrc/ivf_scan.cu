// IVF bucket scan + top-k for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas body _kernel of wdbx_tpu/kernels/ivf_scan.py:34
// (called through ivf_bucket_scan, pallas_call at :127), the dense-table
// IVF engine's kernel path.
// Function: for S (query, probe) pairs given as probes (S,) and qidx (S,),
// pair s scores query row q[qidx[s]], already in the table's type, against
// the (C, d) bucket rows[probes[s]] with float32 accumulation, sets rows
// whose validity byte valid[probes[s]][row] is zero to -inf, and keeps the
// pair's exact top-k (k <= 128): float32 scores and bucket-local positions
// in [0, C), -inf / -1 past the valid count. Tables are bf16 or float32.
//
// Bound on an H100 (3.35 TB/s HBM): bytes. A pair is one query row against
// C rows, 2 operations per element (1 per byte of a bf16 table, far below
// the ~295 a byte at which the tensor cores would be the limit). At the
// dense engine's 1M x 384 bf16 point (nlist 1,024, C = 1,408) a pair reads
// at most 1.08 MB; B = 64 at nprobe 8 (S = 512 pairs) reads 554 MB,
// 0.165 ms. Rows a bucket marks invalid (its padding, deletes, a filter)
// are not read at all.
//
// Design. The TPU kernel is not carried over block by block: it walks the
// S pairs on a sequential grid (the probe ids scalar-prefetched into the
// index maps), keeps every pair's result in a VMEM scratch of all S rows
// that the last step emits, and reads the validity mask as an 8x
// replicated table because Mosaic refuses (1, C) blocks. Here the work is a
// GEMV per pair, so tensor cores would idle on 15 of 16 rows: stage 1
// (ivf_bucket_partial) runs a grid of (pairs) x (row splits of the bucket),
// with the split count chosen by the wrapper so that the grid holds about
// four CTAs per SM whatever S is (at B = 1 one CTA per pair would leave
// the card empty). A CTA reads probes[s] and qidx[s] itself, keeps the
// query in shared memory as float32, and lets each warp walk groups of 32
// rows of its split: one ballot of the group's validity bytes, then the
// live rows four at a time, each lane streaming its 16-byte chunks of the
// four rows (CUDA-core float32 FMAs, a shuffle reduction per row). Each
// warp keeps its own candidate buffer (Sel / sel_offer / sel_shrink of
// topk_common.cuh), so no barrier follows the first; every warp writes its
// k survivors as one partial of (S, splits * warps, k). Stage 2 is the
// shared topk_merge_partials of fused_topk.cu with S in the place of B.
// Widths whose rows are not whole 16-byte chunks take an element-wise
// loop. No wgmma or TMA, and pairs that share a bucket read it once each:
// grouping them is later work. Times in PERF.md.

#include "topk_common.cuh"

namespace {

constexpr int kGroup = 32;  // rows a warp checks with one ballot
constexpr int kStep = 4;    // live rows a warp scores at once

// acc += (16 bytes of a table row) . (the matching query floats qv)
template <int TABLE>
__device__ __forceinline__ void fma_chunk(float& acc, const uint4& v,
                                          const float* qv) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (TABLE == kBF16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      acc = fmaf(f.x, qv[2 * j], acc);
      acc = fmaf(f.y, qv[2 * j + 1], acc);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = fmaf(__uint_as_float(w[j]), qv[j], acc);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__host__ __device__ inline size_t query_words(int d) {
  return (size_t)((d + 3) & ~3);
}

size_t ivf_smem_bytes(int d, int cap) {
  return (query_words(d) + cta_sel_words(kWarps, cap)) * 4;
}

template <int TABLE, bool VEC>
__global__ void __launch_bounds__(kThreads)
ivf_bucket_partial_kernel(const void* __restrict__ rows,
                          const uint8_t* __restrict__ valid,
                          const int* __restrict__ probes,
                          const int* __restrict__ qidx,
                          const void* __restrict__ q, int nlist, int c, int d,
                          int b, int k, int cap, int rows_per_split,
                          float* __restrict__ part_v,
                          int* __restrict__ part_i) {
  constexpr int ES = TABLE == kF32 ? 4 : 2;  // bytes per element
  constexpr int E = 16 / ES;                 // elements per 16-byte chunk
  constexpr int QTYPE = TABLE == kF32 ? kQF32 : kQBF16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  // one candidate buffer per warp: the CtaSel's "queries" are the warps
  const CtaSel sel(qs + query_words(d), kWarps, cap, k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = blockIdx.x, split = blockIdx.y;
  const int probe = probes[pair], qi = qidx[pair];
  // an id out of range scores nothing (the plain version would raise)
  const bool live = probe >= 0 && probe < nlist && qi >= 0 && qi < b;
  if (live)
    for (int j = threadIdx.x; j < d; j += kThreads)
      qs[j] = load_q<QTYPE>(q, (size_t)qi * d + j);
  sel.init(threadIdx.x);
  __syncthreads();
  const Sel s = sel.at(warp, warp);
  const int r_lo = split * rows_per_split;
  const int r_hi = min(c, r_lo + rows_per_split);
  if (live) {
    const size_t bucket = (size_t)probe * c;
    const uint8_t* vb = valid + bucket;
    const char* tb = static_cast<const char*>(rows) + bucket * d * ES;
    const size_t row_bytes = (size_t)d * ES;
    for (int base = r_lo + warp * kGroup; base < r_hi;
         base += kWarps * kGroup) {
      const int r = base + lane;
      unsigned m = __ballot_sync(kFull, r < r_hi && vb[r] != 0);
      float mine = -INFINITY;  // lane L: the score of row base + L
      while (m) {              // warp-uniform: m comes from a ballot
        int sub[kStep];
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
          sub[j] = m ? __ffs(m) - 1 : -1;
          m &= m ? m - 1 : 0u;
        }
        float acc[kStep] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (VEC) {
          const int nch = d / E;  // 16-byte chunks per row
          for (int ch = lane; ch < nch; ch += 32) {
            float qv[E];
#pragma unroll
            for (int e = 0; e < E; ++e) qv[e] = qs[ch * E + e];
            uint4 v[kStep];
#pragma unroll
            for (int j = 0; j < kStep; ++j)
              v[j] = sub[j] >= 0
                         ? ldg16(tb + (size_t)(base + sub[j]) * row_bytes +
                                 (size_t)ch * 16)
                         : make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int j = 0; j < kStep; ++j) fma_chunk<TABLE>(acc[j], v[j], qv);
          }
        } else {
          for (int e = lane; e < d; e += 32) {
            const float x = qs[e];
#pragma unroll
            for (int j = 0; j < kStep; ++j)
              if (sub[j] >= 0)
                acc[j] = fmaf(
                    load_row<TABLE>(tb, (size_t)(base + sub[j]) * d + e), x,
                    acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
          const float t = warp_sum(acc[j]);
          if (lane == sub[j]) mine = t;
        }
      }
      sel_offer(s, mine, r, k, cap, lane);
    }
  }
  sel_shrink(s, k, lane);
  const int cnt = *s.count;
  const int nparts = gridDim.y * kWarps;
  const size_t out = ((size_t)pair * nparts + split * kWarps + warp) * k;
  for (int e = lane; e < k; e += 32) {
    const bool have = e < cnt;
    part_v[out + e] = have ? s.v[e] : -INFINITY;
    part_i[out + e] = have ? s.i[e] : -1;
  }
}

template <int TABLE>
cudaError_t launch_partial(const void* rows, const void* valid,
                           const void* probes, const void* qidx, const void* q,
                           int nlist, int c, int d, int b, int s, int k,
                           int cap, int splits, int rows_per_split,
                           void* part_v, void* part_i, cudaStream_t stream) {
  constexpr int ES = TABLE == kF32 ? 4 : 2;
  // 16-byte row chunks when rows are whole chunks and the table aligned
  const bool vec = (d * ES) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  auto kern = vec ? ivf_bucket_partial_kernel<TABLE, true>
                  : ivf_bucket_partial_kernel<TABLE, false>;
  const size_t smem = ivf_smem_bytes(d, cap);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      rows, static_cast<const uint8_t*>(valid),
      static_cast<const int*>(probes), static_cast<const int*>(qidx), q, nlist,
      c, d, b, k, cap, rows_per_split, static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Warps per CTA: each writes one partial, so part_v holds splits * this.
int wdbx_ivf_bucket_partial_warps() { return kWarps; }

// table: 0 float32, 1 bfloat16 ((nlist, c, d) rows, q (b, d) of the same
// type); valid (nlist, c) bytes; probes / qidx (s,) int32. Grid (s,
// splits); split j scores rows [j * rows_per_split, (j + 1) *
// rows_per_split). part_v (s, splits * warps, k) float32, part_i the same
// shape in int32 bucket-local positions.
int wdbx_ivf_bucket_partial(int table, const void* rows, const void* valid,
                            const void* probes, const void* qidx,
                            const void* q, int nlist, int c, int d, int b,
                            int s, int k, int cap, int splits,
                            int rows_per_split, void* part_v, void* part_i,
                            void* stream) {
  if (k < 1 || cap < k + 32 || nlist < 1 || c < 1 || d < 1 || b < 1 ||
      s < 1 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < c ||
      ivf_smem_bytes(d, cap) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table == kF32)
    return (int)launch_partial<kF32>(rows, valid, probes, qidx, q, nlist, c,
                                     d, b, s, k, cap, splits, rows_per_split,
                                     part_v, part_i, st);
  if (table == kBF16)
    return (int)launch_partial<kBF16>(rows, valid, probes, qidx, q, nlist, c,
                                      d, b, s, k, cap, splits, rows_per_split,
                                      part_v, part_i, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
