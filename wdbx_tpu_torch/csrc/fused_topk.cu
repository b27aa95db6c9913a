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
// Bound on an H100 (3.35 TB/s HBM): the slab read. 1M x 384 bf16 is
// 805 MB, 0.24 ms per batch; int8 0.12 ms; packed int4 0.06 ms of bytes
// but ~0.10 ms of bf16 tensor-core work at B = 128.
//
// Design. On the TPU the grid runs in order and carries the running
// top-k in VMEM scratch; here CTAs run in parallel, so the work is two
// hand-written stages:
//   1. fused_topk_partial: grid (query tiles) x (row chunks). A CTA
//      streams its chunk in 64-row tiles, 32 dims at a time through
//      shared memory (int4 bytes are unpacked in registers after the
//      load, so HBM moves 0.5 byte per dim and no unpacked slab ever
//      exists), scores them with float32 FMAs, applies the row scale and
//      the validity mask, and feeds each query's scores into a per-query
//      candidate buffer in shared memory. A candidate enters only when
//      it beats that query's current k-th best; when the buffer fills, a
//      warp-level radix select cuts it back to exactly k. The CTA writes
//      its k survivors per query (unsorted) to (B, chunks, k).
//   2. topk_merge_partials: one warp per query streams the partials
//      through the same buffer, then ranks the final k into sorted order.
// Selection is exact: the TPU kernel's grouped pre-reduction (`group`)
// is not reproduced, which can only raise recall against it.
// Scores run on the tensor cores (mma.sync bf16 -> f32) for bf16, int8
// and int4 slabs, and on CUDA-core FMAs for float32 slabs (true float32,
// as the JAX package's CPU path) and for widths that are not a multiple
// of 32. No wgmma, TMA or warp specialisation yet: times in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // rows per tile
constexpr int kDK = 32;    // dims per shared-memory slice
constexpr int kMergeWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

enum SlabType { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3 };

// ---------------------------------------------------------------------
// Per-query candidate buffer, driven by one warp.
struct Sel {
  float* v;        // [cap] candidate scores
  int* i;          // [cap] candidate row indices
  int* count;      // live entries
  float* thr;      // k-th best once the buffer has been cut to k
  unsigned* hist;  // [256] warp-private radix histogram
};

__device__ __forceinline__ unsigned f2key(float f) {
  unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned key) {
  unsigned b = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(b);
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// Cut the buffer to exactly its k best entries (ties broken by buffer
// order) and set thr to the k-th best. Radix select over the
// order-preserving integer keys of the scores, 8 bits per pass.
__device__ void sel_shrink(const Sel& s, int k, int lane) {
  const int c = *s.count;
  if (c <= k) return;
  unsigned prefix = 0, mask = 0;
  int remaining = k;  // entries still to take among those matching prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int bin = lane; bin < 256; bin += 32) s.hist[bin] = 0;
    __syncwarp();
    for (int e = lane; e < c; e += 32) {
      unsigned key = f2key(s.v[e]);
      if ((key & mask) == prefix) atomicAdd(&s.hist[(key >> shift) & 255u], 1u);
    }
    __syncwarp();
    // lane L owns bins 255-8L down to 248-8L (descending key order)
    int local[8];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      local[j] = (int)s.hist[255 - 8 * lane - j];
      sum += local[j];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - sum;
    const bool mine = excl < remaining && remaining <= incl;
    const unsigned who = __ballot_sync(kFull, mine);
    const int src = __ffs(who) - 1;
    int bin = 0, above = 0;
    if (mine) {
      int acc = excl;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (acc + local[j] >= remaining) {
          bin = 255 - 8 * lane - j;
          above = acc;
          break;
        }
        acc += local[j];
      }
    }
    bin = __shfl_sync(kFull, bin, src);
    above = __shfl_sync(kFull, above, src);
    remaining -= above;
    prefix |= (unsigned)bin << shift;
    mask |= 255u << shift;
    __syncwarp();
  }
  // prefix is the key of the k-th best; keep every larger key and the
  // first `remaining` entries equal to it, compacted in place.
  const unsigned t = prefix;
  int w = 0, eq_taken = 0;
  for (int base = 0; base < c; base += 32) {
    const int e = base + lane;
    const bool in = e < c;
    float v = 0.f;
    int id = -1;
    unsigned key = 0;
    if (in) {
      v = s.v[e];
      id = s.i[e];
      key = f2key(v);
    }
    const bool eq = in && key == t;
    const unsigned eqm = __ballot_sync(kFull, eq);
    const int eq_rank = eq_taken + __popc(eqm & lanes_below(lane));
    const bool keep = (in && key > t) || (eq && eq_rank < remaining);
    const unsigned km = __ballot_sync(kFull, keep);
    __syncwarp();
    if (keep) {
      const int pos = w + __popc(km & lanes_below(lane));
      s.v[pos] = v;
      s.i[pos] = id;
    }
    w += __popc(km);
    eq_taken += __popc(eqm);
    __syncwarp();
  }
  if (lane == 0) {
    *s.count = w;
    *s.thr = key2f(t);
  }
  __syncwarp();
}

// Offer one candidate per lane; cap >= k + 32 keeps room after a cut.
__device__ __forceinline__ void sel_offer(const Sel& s, float v, int id,
                                          int k, int cap, int lane) {
  bool want = v > *s.thr;
  unsigned m = __ballot_sync(kFull, want);
  if (m == 0) return;
  int c = *s.count;
  int n = __popc(m);
  if (c + n > cap) {
    sel_shrink(s, k, lane);
    want = v > *s.thr;
    m = __ballot_sync(kFull, want);
    if (m == 0) return;
    c = *s.count;
    n = __popc(m);
  }
  if (want) {
    const int pos = c + __popc(m & lanes_below(lane));
    s.v[pos] = v;
    s.i[pos] = id;
  }
  __syncwarp();
  if (lane == 0) *s.count = c + n;
  __syncwarp();
}

// The candidate buffers of a stage-1 CTA's QT queries, in shared memory
// after the body's own tiles; both stage-1 bodies select through it.
size_t cta_sel_words(int qt, int cap) {
  return (size_t)kWarps * 256 + 2 * (size_t)qt + 2 * (size_t)qt * cap;
}

struct CtaSel {
  unsigned* hist;  // [kWarps][256]
  int* cnt;        // [qt]
  float* thr;      // [qt]
  float* sv;       // [qt][cap]
  int* si;         // [qt][cap]
  int qt, cap, k;

  __device__ CtaSel(void* p, int qt_, int cap_, int k_)
      : qt(qt_), cap(cap_), k(k_) {
    hist = static_cast<unsigned*>(p);
    cnt = reinterpret_cast<int*>(hist + kWarps * 256);
    thr = reinterpret_cast<float*>(cnt + qt);
    sv = thr + qt;
    si = reinterpret_cast<int*>(sv + (size_t)qt * cap);
  }

  __device__ Sel at(int ql, int warp) const {
    return Sel{sv + (size_t)ql * cap, si + (size_t)ql * cap, cnt + ql,
               thr + ql, hist + warp * 256};
  }

  // Every thread of the CTA; a __syncthreads() must follow before use.
  __device__ void init(int tid) const {
    for (int e = tid; e < qt; e += kThreads) {
      cnt[e] = 0;
      thr[e] = -INFINITY;
    }
  }

  // Offer a masked score tile St [qt][rs] of ROWS rows starting at row
  // r0: one warp per query of the batch.
  template <int ROWS>
  __device__ void offer_tile(const float* St, int rs, int r0, int q0, int b,
                             int warp, int lane) const {
    for (int ql = warp; ql < qt; ql += kWarps) {
      if (q0 + ql >= b) break;
      const Sel s = at(ql, warp);
#pragma unroll
      for (int h = 0; h < ROWS; h += 32)
        sel_offer(s, St[ql * rs + h + lane], r0 + h + lane, k, cap, lane);
    }
  }

  // Cut each query's buffer to k and write it (unsorted, -inf / -1
  // pads) to its chunk's slot of the (b, chunks, k) partials.
  __device__ void write(int q0, int b, int chunk, int nchunks,
                        float* part_v, int* part_i, int warp,
                        int lane) const {
    for (int ql = warp; ql < qt; ql += kWarps) {
      const int qg = q0 + ql;
      if (qg >= b) break;
      const Sel s = at(ql, warp);
      sel_shrink(s, k, lane);
      const int c = *s.count;
      const size_t base = ((size_t)qg * nchunks + chunk) * k;
      for (int e = lane; e < k; e += 32) {
        const bool have = e < c;
        part_v[base + e] = have ? s.v[e] : -INFINITY;
        part_i[base + e] = have ? s.i[e] : -1;
      }
    }
  }
};

// ---------------------------------------------------------------------
// Stage 1.
template <int SLAB>
__device__ __forceinline__ float load_q(const void* q, size_t idx) {
  if constexpr (SLAB == kF32) return static_cast<const float*>(q)[idx];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[idx]);
}

template <int SLAB>
__device__ __forceinline__ float load_row(const void* db, size_t idx) {
  if constexpr (SLAB == kF32) return static_cast<const float*>(db)[idx];
  if constexpr (SLAB == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(db)[idx]);
  return (float)static_cast<const int8_t*>(db)[idx];
}

// Query column feeding slice position kk of slice sl (-1: past the end).
// An int4 slice covers kDK/2 packed bytes: their low nibbles are dims
// j, their high nibbles dims j + d/2.
template <int SLAB>
__device__ __forceinline__ int query_col(int sl, int kk, int d) {
  if constexpr (SLAB == kI4) {
    constexpr int P = kDK / 2;
    const int half = d / 2;
    const int j = sl * P + (kk < P ? kk : kk - P);
    if (j >= half) return -1;
    return kk < P ? j : half + j;
  }
  const int col = sl * kDK + kk;
  return col < d ? col : -1;
}

size_t partial_smem_bytes(int qt, int cap) {
  const size_t words = (size_t)kDK * (qt + 1) + (size_t)kDK * (kRows + 1) +
                       (size_t)qt * (kRows + 1) + cta_sel_words(qt, cap);
  return words * 4;
}

template <int SLAB, int TQ>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial_kernel(const void* __restrict__ db,
                          const void* __restrict__ q,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ scales, int n, int d,
                          int b, int k, int cap, int rows_per_chunk,
                          float* __restrict__ part_v,
                          int* __restrict__ part_i) {
  constexpr int QT = 16 * TQ;
  constexpr int QS = QT + 1;     // padded strides: conflict-free stores
  constexpr int RS = kRows + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kDK][QS]
  float* Rs = Qs + kDK * QS;                   // [kDK][RS]
  float* St = Rs + kDK * RS;                   // [QT][RS] score tile
  const CtaSel sel(St + QT * RS, QT, cap, k);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * QT;
  const int chunk = blockIdx.y;
  const int nchunks = gridDim.y;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(n, row_begin + rows_per_chunk);
  const int dw = SLAB == kI4 ? d / 2 : d;  // storage columns per row
  const int slices = SLAB == kI4 ? (dw + kDK / 2 - 1) / (kDK / 2)
                                 : (d + kDK - 1) / kDK;

  sel.init(tid);
  __syncthreads();

  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    float acc[TQ][4];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int sl = 0; sl < slices; ++sl) {
      for (int e = tid; e < QT * kDK; e += kThreads) {
        const int qi = e / kDK, kk = e % kDK;
        const int col = query_col<SLAB>(sl, kk, d);
        float x = 0.f;
        if (q0 + qi < b && col >= 0) x = load_q<SLAB>(q, (size_t)(q0 + qi) * d + col);
        Qs[kk * QS + qi] = x;
      }
      if constexpr (SLAB == kI4) {
        constexpr int P = kDK / 2;
        for (int e = tid; e < kRows * P; e += kThreads) {
          const int r = e / P, jj = e % P;
          const int j = sl * P + jj, row = r0 + r;
          float lo = 0.f, hi = 0.f;
          if (row < row_end && j < dw) {
            const unsigned byte = static_cast<const uint8_t*>(db)[(size_t)row * dw + j];
            lo = (float)((int)(byte & 15u) - 8);
            hi = (float)((int)(byte >> 4) - 8);
          }
          Rs[jj * RS + r] = lo;
          Rs[(P + jj) * RS + r] = hi;
        }
      } else {
        for (int e = tid; e < kRows * kDK; e += kThreads) {
          const int r = e / kDK, kk = e % kDK;
          const int col = sl * kDK + kk, row = r0 + r;
          float x = 0.f;
          if (row < row_end && col < d) x = load_row<SLAB>(db, (size_t)row * d + col);
          Rs[kk * RS + r] = x;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDK; ++kk) {
        float a[TQ], w[4];
#pragma unroll
        for (int i = 0; i < TQ; ++i) a[i] = Qs[kk * QS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Rs[kk * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }

    // scale (int8 / int4), then the validity mask, as _kernel_int8 does
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + tx + 16 * j;
      const bool ok = row < row_end && valid[row] != 0;
      float sc = 1.f;
      if ((SLAB == kI8 || SLAB == kI4) && ok) sc = scales[row];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        St[(ty + 16 * i) * RS + tx + 16 * j] = ok ? acc[i][j] * sc : -INFINITY;
    }
    __syncthreads();
    sel.offer_tile<kRows>(St, RS, r0, q0, b, warp, lane);
    __syncthreads();
  }
  sel.write(q0, b, chunk, nchunks, part_v, part_i, warp, lane);
}

// ---------------------------------------------------------------------
// Stage 1 on the tensor cores, for slabs whose rows are bf16 products
// (bf16, int8 and int4: int8 and 4-bit codes are exact in bf16). Same
// function and selection as above; the score tile is mma.sync
// m16n8k16 bf16 -> f32. A CTA scores QT queries x 128 rows per tile,
// 32 dims per slice; each warp owns 16 rows of the tile. Slices move
// global -> registers (16-byte loads, the next slice in flight while
// the tensor cores work on this one) -> shared memory, converting
// int8 / unpacking int4 to bf16 on the way, so HBM moves 1 or 0.5 byte
// per dim. Needs d % 32 == 0 and 16-byte aligned slab and queries.
constexpr int kRowsM = 128;   // rows per tile
constexpr int kKW = 20;       // smem row stride in 32-bit words: 32 bf16 + 8
                              // pad, which makes fragment loads conflict-free

size_t mma_smem_bytes(int qt, int cap) {
  const size_t words = (size_t)qt * kKW + (size_t)kRowsM * kKW +
                       (size_t)qt * (kRowsM + 1) + cta_sel_words(qt, cap);
  return words * 4;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int SLAB, int TQ>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial_mma_kernel(const void* __restrict__ db,
                              const void* __restrict__ q,
                              const uint8_t* __restrict__ valid,
                              const float* __restrict__ scales, int n, int d,
                              int b, int k, int cap, int rows_per_chunk,
                              float* __restrict__ part_v,
                              int* __restrict__ part_i) {
  constexpr int QT = 16 * TQ;
  constexpr int R = kRowsM, RS = kRowsM + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* Qw = reinterpret_cast<uint32_t*>(smem);  // [QT][kKW] bf16 pairs
  uint32_t* Rw = Qw + QT * kKW;                      // [R][kKW]
  float* St = reinterpret_cast<float*>(Rw + R * kKW);  // [QT][RS] scores
  const CtaSel sel(St + QT * RS, QT, cap, k);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int q0 = blockIdx.x * QT;
  const int chunk = blockIdx.y;
  const int nchunks = gridDim.y;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(n, row_begin + rows_per_chunk);
  const int half = d / 2;
  const int slices = d / 32;
  const int ntiles = row_end > row_begin ? (row_end - row_begin + R - 1) / R : 0;
  const int steps = ntiles * slices;
  const char* qb = static_cast<const char*>(q);
  const char* rb = static_cast<const char*>(db);

  sel.init(tid);  // the loop's first __syncthreads() orders it

  // this thread's share of a slice: one 16-byte query chunk (query
  // tid/4, chunk tid%4) and up to two 16-byte row chunks
  const int qi = tid >> 2, qc = tid & 3;
  uint4 qreg = make_uint4(0, 0, 0, 0);
  uint4 rreg[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};

  auto gload = [&](int step) {
    const int r0 = row_begin + (step / slices) * R;
    const int sl = step % slices;
    qreg = make_uint4(0, 0, 0, 0);
    if (qi < QT && q0 + qi < b) {
      int col = sl * 32 + qc * 8;
      if constexpr (SLAB == kI4)
        col = qc < 2 ? sl * 16 + qc * 8 : half + sl * 16 + (qc - 2) * 8;
      qreg = ldg16(qb + ((size_t)(q0 + qi) * d + col) * 2);
    }
    if constexpr (SLAB == kBF16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = tid + u * kThreads, r = idx >> 2, c = idx & 3;
        const int row = r0 + r;
        rreg[u] = row < row_end
            ? ldg16(rb + ((size_t)row * d + sl * 32 + c * 8) * 2)
            : make_uint4(0, 0, 0, 0);
      }
    } else if constexpr (SLAB == kI8) {
      const int row = r0 + (tid >> 1), c = tid & 1;
      rreg[0] = row < row_end ? ldg16(rb + (size_t)row * d + sl * 32 + c * 16)
                              : make_uint4(0, 0, 0, 0);
    } else {
      const int row = r0 + tid;
      rreg[0] = tid < R && row < row_end
          ? ldg16(rb + (size_t)row * half + sl * 16)
          : make_uint4(0, 0, 0, 0);
    }
  };

  auto sstore = [&]() {
    if (qi < QT) *reinterpret_cast<uint4*>(&Qw[qi * kKW + qc * 4]) = qreg;
    if constexpr (SLAB == kBF16) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = tid + u * kThreads, r = idx >> 2, c = idx & 3;
        *reinterpret_cast<uint4*>(&Rw[r * kKW + c * 4]) = rreg[u];
      }
    } else if constexpr (SLAB == kI8) {
      const int r = tid >> 1, c = tid & 1;
      const uint32_t src[4] = {rreg[0].x, rreg[0].y, rreg[0].z, rreg[0].w};
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // bf16 pair j: int8 codes 2j, 2j+1
        const uint32_t word = src[j >> 1] >> ((j & 1) * 16);
        w[j] = pack_bf16((float)(int8_t)(word & 255u),
                         (float)(int8_t)((word >> 8) & 255u));
      }
      uint4* dst = reinterpret_cast<uint4*>(&Rw[r * kKW + c * 8]);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
      if (tid < R) {
        const uint32_t src[4] = {rreg[0].x, rreg[0].y, rreg[0].z, rreg[0].w};
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // packed bytes 2j, 2j+1
          const uint32_t word = src[j >> 1] >> ((j & 1) * 16);
          const int b0 = (int)(word & 255u), b1 = (int)((word >> 8) & 255u);
          lo[j] = pack_bf16((float)((b0 & 15) - 8), (float)((b1 & 15) - 8));
          hi[j] = pack_bf16((float)((b0 >> 4) - 8), (float)((b1 >> 4) - 8));
        }
        uint4* dst = reinterpret_cast<uint4*>(&Rw[tid * kKW]);
        dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        dst[2] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        dst[3] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
  };

  float acc[TQ][2][4];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (steps > 0) gload(0);
  for (int step = 0; step < steps; ++step) {
    __syncthreads();  // the previous slice is consumed
    sstore();
    __syncthreads();
    if (step + 1 < steps) gload(step + 1);  // in flight during the mma
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kw = ks * 8;
      uint32_t bf[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int rl = warp * 16 + ni * 8 + g;
        bf[ni][0] = Rw[rl * kKW + kw + t];
        bf[ni][1] = Rw[rl * kKW + kw + 4 + t];
      }
#pragma unroll
      for (int mi = 0; mi < TQ; ++mi) {
        const int ql = mi * 16 + g;
        const uint32_t a0 = Qw[ql * kKW + kw + t];
        const uint32_t a1 = Qw[(ql + 8) * kKW + kw + t];
        const uint32_t a2 = Qw[ql * kKW + kw + 4 + t];
        const uint32_t a3 = Qw[(ql + 8) * kKW + kw + 4 + t];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          mma_bf16(acc[mi][ni], a0, a1, a2, a3, bf[ni][0], bf[ni][1]);
      }
    }
    if (step % slices != slices - 1) continue;

    // tile done: scale (int8 / int4), mask, then select
    const int r0 = row_begin + (step / slices) * R;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int rl = warp * 16 + ni * 8 + t * 2 + hc;
        const int row = r0 + rl;
        const bool ok = row < row_end && valid[row] != 0;
        float sc = 1.f;
        if ((SLAB == kI8 || SLAB == kI4) && ok) sc = scales[row];
#pragma unroll
        for (int mi = 0; mi < TQ; ++mi) {
          const int ql = mi * 16 + g;
          St[ql * RS + rl] = ok ? acc[mi][ni][hc] * sc : -INFINITY;
          St[(ql + 8) * RS + rl] = ok ? acc[mi][ni][2 + hc] * sc : -INFINITY;
          acc[mi][ni][hc] = 0.f;
          acc[mi][ni][2 + hc] = 0.f;
        }
      }
    __syncthreads();
    sel.offer_tile<R>(St, RS, r0, q0, b, warp, lane);
  }
  __syncthreads();
  sel.write(q0, b, chunk, nchunks, part_v, part_i, warp, lane);
}

template <int SLAB, int TQ>
cudaError_t launch_partial(const void* db, const void* q, const void* valid,
                           const void* scales, int n, int d, int b, int k,
                           int cap, int rows_per_chunk, int chunks,
                           void* part_v, void* part_i, cudaStream_t stream) {
  constexpr int QT = 16 * TQ;
  const bool tensor_cores =
      SLAB != kF32 && d % 32 == 0 &&
      reinterpret_cast<uintptr_t>(db) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const size_t smem = tensor_cores ? mma_smem_bytes(QT, cap)
                                   : partial_smem_bytes(QT, cap);
  auto kern = fused_topk_partial_kernel<SLAB, TQ>;
  if constexpr (SLAB != kF32)
    if (tensor_cores) kern = fused_topk_partial_mma_kernel<SLAB, TQ>;
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
cudaError_t dispatch_slab(int slab, const void* db, const void* q,
                          const void* valid, const void* scales, int n, int d,
                          int b, int k, int cap, int rpc, int chunks,
                          void* pv, void* pi, cudaStream_t st) {
  switch (slab) {
    case kF32:
      return launch_partial<kF32, TQ>(db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case kBF16:
      return launch_partial<kBF16, TQ>(db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case kI8:
      return launch_partial<kI8, TQ>(db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
    case kI4:
      return launch_partial<kI4, TQ>(db, q, valid, scales, n, d, b, k, cap, rpc, chunks, pv, pi, st);
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

// Shared memory a stage-1 CTA of qt queries needs (either body).
size_t wdbx_fused_topk_partial_smem(int qt, int cap) {
  const size_t a = partial_smem_bytes(qt, cap), b = mma_smem_bytes(qt, cap);
  return a > b ? a : b;
}

// slab: 0 float32, 1 bfloat16, 2 int8, 3 packed int4. qt: 64 or 16
// queries per CTA; rows_per_chunk a multiple of 128. Queries are float32 for a float32 slab, else bf16.
// part_v (b, chunks, k) float32 and part_i (b, chunks, k) int32.
int wdbx_fused_topk_partial(int slab, int qt, const void* db, const void* q,
                            const void* valid, const void* scales, int n,
                            int d, int b, int k, int cap, int rows_per_chunk,
                            int chunks, void* part_v, void* part_i,
                            void* stream) {
  if (k < 1 || cap < k + 32 || n < 1 || b < 1 || d < 1 ||
      rows_per_chunk % kRowsM != 0 || (slab == kI4 && d % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qt == 64)
    return (int)dispatch_slab<4>(slab, db, q, valid, scales, n, d, b, k, cap,
                                 rows_per_chunk, chunks, part_v, part_i, st);
  if (qt == 16)
    return (int)dispatch_slab<1>(slab, db, q, valid, scales, n, d, b, k, cap,
                                 rows_per_chunk, chunks, part_v, part_i, st);
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
