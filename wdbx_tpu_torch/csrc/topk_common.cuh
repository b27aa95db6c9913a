// Shared pieces of the stage-1 score + top-k kernels (sm_90a, CUDA C++):
// the per-query candidate buffer and its warp-level radix select
// (CtaSel), the tile loaders, the in-register int4 unpack, and the two
// scan bodies that score a list of row tiles into a CtaSel:
//   scan_fma   CUDA-core float32 FMAs (float32 slabs, ragged widths)
//   scan_mma   mma.sync on the tensor cores: bf16 x bf16 -> f32
//              (bf16 / int8 / int4 slabs with bf16 queries), or
//              s8 x s8 -> s32 (int8 / int4 slabs with int8 queries)
// Both walk a Tiles object: RangeTiles is one contiguous row range (the
// fused flat scan, fused_topk.cu), BlockTiles the c-row blocks a CTA
// read from a block list (the clustered block scan, clustered_scan.cu).
// Row numbers are global slab positions, so both emit positions as-is.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // rows per tile of the FMA body
constexpr int kDK = 32;    // dims per shared-memory slice of the FMA body
constexpr unsigned kFull = 0xffffffffu;

enum SlabType { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3 };
// Query element types: float32, bf16, int8 codes with a per-query scale.
enum QueryType { kQF32 = 0, kQBF16 = 1, kQI8 = 2 };

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
  // pads) to its part's slot of the (b, nparts, k) partials.
  __device__ void write(int q0, int b, int part, int nparts, float* part_v,
                        int* part_i, int warp, int lane) const {
    for (int ql = warp; ql < qt; ql += kWarps) {
      const int qg = q0 + ql;
      if (qg >= b) break;
      const Sel s = at(ql, warp);
      sel_shrink(s, k, lane);
      const int c = *s.count;
      const size_t base = ((size_t)qg * nparts + part) * k;
      for (int e = lane; e < k; e += 32) {
        const bool have = e < c;
        part_v[base + e] = have ? s.v[e] : -INFINITY;
        part_i[base + e] = have ? s.i[e] : -1;
      }
    }
  }
};

// ---------------------------------------------------------------------
// Row tiles a CTA scores: tile(t, R) gives the first row of tile t of R
// rows and the end of the range it lies in (rows at or past it are
// masked).
struct RangeTiles {  // one contiguous range [begin, end)
  int begin, end;
  __device__ int count(int R) const {
    return end > begin ? (end - begin + R - 1) / R : 0;
  }
  __device__ void tile(int t, int R, int& r0, int& rend) const {
    r0 = begin + t * R;
    rend = end;
  }
};

struct BlockTiles {  // n blocks of c rows; block j starts at row blk[j] * c
  const int* blk;
  int n, c;
  __device__ int count(int R) const { return n * ((c + R - 1) / R); }
  __device__ void tile(int t, int R, int& r0, int& rend) const {
    const int per = (c + R - 1) / R;
    const int base = blk[t / per] * c;
    r0 = base + (t % per) * R;
    rend = base + c;
  }
};

// ---------------------------------------------------------------------
// The CUDA-core body.
template <int QTYPE>
__device__ __forceinline__ float load_q(const void* q, size_t idx) {
  if constexpr (QTYPE == kQF32) return static_cast<const float*>(q)[idx];
  if constexpr (QTYPE == kQBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[idx]);
  return (float)static_cast<const int8_t*>(q)[idx];
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

__host__ __device__ inline size_t fma_tile_words(int qt) {
  return (size_t)kDK * (qt + 1) + (size_t)kDK * (kRows + 1) +
         (size_t)qt * (kRows + 1);
}

size_t partial_smem_bytes(int qt, int cap) {
  return (fma_tile_words(qt) + cta_sel_words(qt, cap)) * 4;
}

// Score QT = 16 * TQ queries (from q0) against every tile of `tiles` with
// float32 FMAs and offer each masked score tile to `sel`. An int8 query
// type accumulates exact integer products (|sum| < 2^24 for d <= 1040)
// and applies the per-query scale after the row scale. smem holds the
// body's tiles (fma_tile_words) and then the CtaSel.
template <int SLAB, int QTYPE, int TQ, class Tiles>
__device__ void scan_fma(const Tiles& tiles, const CtaSel& sel,
                         unsigned char* smem, const void* __restrict__ db,
                         const void* __restrict__ q,
                         const float* __restrict__ qscale,
                         const uint8_t* __restrict__ valid,
                         const float* __restrict__ scales, int d, int b,
                         int q0) {
  constexpr int QT = 16 * TQ;
  constexpr int QS = QT + 1;     // padded strides: conflict-free stores
  constexpr int RS = kRows + 1;
  float* Qs = reinterpret_cast<float*>(smem);  // [kDK][QS]
  float* Rs = Qs + kDK * QS;                   // [kDK][RS]
  float* St = Rs + kDK * RS;                   // [QT][RS] score tile

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int dw = SLAB == kI4 ? d / 2 : d;  // storage columns per row
  const int slices = SLAB == kI4 ? (dw + kDK / 2 - 1) / (kDK / 2)
                                 : (d + kDK - 1) / kDK;
  float qsc[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qg = q0 + ty + 16 * i;
    qsc[i] = (QTYPE == kQI8 && qg < b) ? qscale[qg] : 1.f;
  }

  sel.init(tid);
  __syncthreads();

  const int ntiles = tiles.count(kRows);
  for (int t = 0; t < ntiles; ++t) {
    int r0, row_end;
    tiles.tile(t, kRows, r0, row_end);
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
        if (q0 + qi < b && col >= 0)
          x = load_q<QTYPE>(q, (size_t)(q0 + qi) * d + col);
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

    // row scale (int8 / int4), query scale (int8 queries), then the
    // validity mask, as the TPU kernels do
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + tx + 16 * j;
      const bool ok = row < row_end && valid[row] != 0;
      float sc = 1.f;
      if ((SLAB == kI8 || SLAB == kI4) && ok) sc = scales[row];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        float s = acc[i][j] * sc;
        if constexpr (QTYPE == kQI8) s = s * qsc[i];
        St[(ty + 16 * i) * RS + tx + 16 * j] = ok ? s : -INFINITY;
      }
    }
    __syncthreads();
    sel.offer_tile<kRows>(St, RS, r0, q0, b, warp, lane);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// The tensor-core body: the score tile is mma.sync. A CTA scores QT
// queries x 128 rows per tile, one slice of 64 bytes per row at a time
// (32 bf16 dims, or 64 int8 dims); each warp owns 16 rows of the tile.
// Slices move global -> registers (16-byte loads, the next slice in
// flight while the tensor cores work on this one) -> shared memory,
// converting int8 to bf16 or unpacking int4 on the way, so HBM moves
// 1 or 0.5 byte per dim. Needs d % 32 == 0 (bf16 products) or d % 64 == 0
// (int8 products) and 16-byte aligned slab and queries.
constexpr int kRowsM = 128;   // rows per tile
constexpr int kKW = 20;       // smem row stride in 32-bit words: 16 + 4 pad,
                              // which makes fragment loads conflict-free

__host__ __device__ inline size_t mma_tile_words(int qt) {
  return (size_t)qt * kKW + (size_t)kRowsM * kKW + (size_t)qt * (kRowsM + 1);
}

size_t mma_smem_bytes(int qt, int cap) {
  return (mma_tile_words(qt) + cta_sel_words(qt, cap)) * 4;
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

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four int4 codes of the low (or high) nibbles of packed bytes b0..b3 as
// four signed bytes, in dim order.
__device__ __forceinline__ uint32_t nibbles_s8(uint32_t bytes, int shift) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int code = (int)((bytes >> (8 * j + shift)) & 15u) - 8;
    out |= ((uint32_t)code & 255u) << (8 * j);
  }
  return out;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// QTYPE kQBF16: bf16 products for bf16, int8 and int4 slabs. QTYPE kQI8:
// int8 x int8 products (int8 and int4 slabs), scaled by the row scale and
// then by the query's scale. smem holds the body's tiles (mma_tile_words)
// and then the CtaSel.
template <int SLAB, int QTYPE, int TQ, class Tiles>
__device__ void scan_mma(const Tiles& tiles, const CtaSel& sel,
                         unsigned char* smem, const void* __restrict__ db,
                         const void* __restrict__ q,
                         const float* __restrict__ qscale,
                         const uint8_t* __restrict__ valid,
                         const float* __restrict__ scales, int d, int b,
                         int q0) {
  constexpr bool S8 = QTYPE == kQI8;
  static_assert(SLAB != kF32, "float32 slabs take the FMA body");
  static_assert(!S8 || SLAB == kI8 || SLAB == kI4, "int8 queries need codes");
  constexpr int QT = 16 * TQ;
  constexpr int R = kRowsM, RS = kRowsM + 1;
  constexpr int DS = S8 ? 64 : 32;  // dims per slice
  using Acc = typename std::conditional<S8, int, float>::type;
  uint32_t* Qw = reinterpret_cast<uint32_t*>(smem);  // [QT][kKW]
  uint32_t* Rw = Qw + QT * kKW;                      // [R][kKW]
  float* St = reinterpret_cast<float*>(Rw + R * kKW);  // [QT][RS] scores

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int half = d / 2;
  const int slices = d / DS;
  const int steps = tiles.count(R) * slices;
  // bytes per query element and per packed row
  constexpr int QB = S8 ? 1 : 2;
  const int row_bytes = SLAB == kI4 ? half : (SLAB == kBF16 ? 2 * d : d);
  const char* qb = static_cast<const char*>(q);
  const char* rb = static_cast<const char*>(db);
  float qsc[TQ][2];
#pragma unroll
  for (int mi = 0; mi < TQ; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qg = q0 + mi * 16 + g + 8 * h;
      qsc[mi][h] = (S8 && qg < b) ? qscale[qg] : 1.f;
    }

  sel.init(tid);  // the loop's first __syncthreads() orders it

  // this thread's share of a slice: one 16-byte query chunk (query
  // tid/4, chunk tid%4) and up to two 16-byte row chunks
  const int qi = tid >> 2, qc = tid & 3;
  uint4 qreg = make_uint4(0, 0, 0, 0);
  uint4 rreg[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};

  auto gload = [&](int step) {
    int r0, row_end;
    tiles.tile(step / slices, R, r0, row_end);
    const int sl = step % slices;
    qreg = make_uint4(0, 0, 0, 0);
    if (qi < QT && q0 + qi < b) {
      // 16 bytes = 8 bf16 or 16 int8 query elements
      constexpr int E = 16 / QB;
      int col = sl * DS + qc * E;
      if constexpr (SLAB == kI4) {
        constexpr int H = DS / 2;  // low-nibble dims of the slice
        col = qc < 2 ? sl * H + qc * E : half + sl * H + (qc - 2) * E;
      }
      qreg = ldg16(qb + ((size_t)(q0 + qi) * d + col) * QB);
    }
    if constexpr (SLAB == kI4) {
      // DS / 2 packed bytes per row: 16 (bf16) or 32 (int8) a slice
      constexpr int CH = DS / 32;  // 16-byte chunks per row
      const int r = tid / CH, c = tid % CH;
      const int row = r0 + r;
      rreg[0] = r < R && row < row_end
          ? ldg16(rb + (size_t)row * half + sl * (DS / 2) + c * 16)
          : make_uint4(0, 0, 0, 0);
    } else if constexpr (SLAB == kBF16 || S8) {
      // 64 bytes per row: four chunks, two per thread
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = tid + u * kThreads, r = idx >> 2, c = idx & 3;
        const int row = r0 + r;
        rreg[u] = row < row_end
            ? ldg16(rb + (size_t)row * row_bytes + sl * 64 + c * 16)
            : make_uint4(0, 0, 0, 0);
      }
    } else {  // int8 rows as bf16: 32 bytes per row, two chunks
      const int row = r0 + (tid >> 1), c = tid & 1;
      rreg[0] = row < row_end ? ldg16(rb + (size_t)row * d + sl * 32 + c * 16)
                              : make_uint4(0, 0, 0, 0);
    }
  };

  auto sstore = [&]() {
    if (qi < QT) *reinterpret_cast<uint4*>(&Qw[qi * kKW + qc * 4]) = qreg;
    if constexpr (SLAB == kI4) {
      constexpr int CH = DS / 32;
      const int r = tid / CH, c = tid % CH;
      if (r < R) {
        const uint32_t src[4] = {rreg[0].x, rreg[0].y, rreg[0].z, rreg[0].w};
        if constexpr (S8) {
          // 16 packed bytes -> 16 low codes (words c*4..) and 16 high
          // codes (words 8 + c*4..)
          uint4* dst = reinterpret_cast<uint4*>(&Rw[r * kKW]);
          dst[c] = make_uint4(nibbles_s8(src[0], 0), nibbles_s8(src[1], 0),
                              nibbles_s8(src[2], 0), nibbles_s8(src[3], 0));
          dst[2 + c] = make_uint4(nibbles_s8(src[0], 4), nibbles_s8(src[1], 4),
                                  nibbles_s8(src[2], 4), nibbles_s8(src[3], 4));
        } else {
          uint32_t lo[8], hi[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {  // packed bytes 2j, 2j+1
            const uint32_t word = src[j >> 1] >> ((j & 1) * 16);
            const int b0 = (int)(word & 255u), b1 = (int)((word >> 8) & 255u);
            lo[j] = pack_bf16((float)((b0 & 15) - 8), (float)((b1 & 15) - 8));
            hi[j] = pack_bf16((float)((b0 >> 4) - 8), (float)((b1 >> 4) - 8));
          }
          uint4* dst = reinterpret_cast<uint4*>(&Rw[r * kKW]);
          dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
          dst[2] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          dst[3] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
        }
      }
    } else if constexpr (SLAB == kBF16 || S8) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int idx = tid + u * kThreads, r = idx >> 2, c = idx & 3;
        *reinterpret_cast<uint4*>(&Rw[r * kKW + c * 4]) = rreg[u];
      }
    } else {
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
    }
  };

  Acc acc[TQ][2][4];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
        for (int ni = 0; ni < 2; ++ni) {
          if constexpr (S8)
            mma_s8(acc[mi][ni], a0, a1, a2, a3, bf[ni][0], bf[ni][1]);
          else
            mma_bf16(acc[mi][ni], a0, a1, a2, a3, bf[ni][0], bf[ni][1]);
        }
      }
    }
    if (step % slices != slices - 1) continue;

    // tile done: scale (int8 / int4 rows, then int8 queries), mask, select
    int r0, row_end;
    tiles.tile(step / slices, R, r0, row_end);
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
          float s0 = (float)acc[mi][ni][hc] * sc;
          float s1 = (float)acc[mi][ni][2 + hc] * sc;
          if constexpr (S8) {
            s0 = s0 * qsc[mi][0];
            s1 = s1 * qsc[mi][1];
          }
          St[ql * RS + rl] = ok ? s0 : -INFINITY;
          St[(ql + 8) * RS + rl] = ok ? s1 : -INFINITY;
          acc[mi][ni][hc] = 0;
          acc[mi][ni][2 + hc] = 0;
        }
      }
    __syncthreads();
    sel.offer_tile<R>(St, RS, r0, q0, b, warp, lane);
  }
  __syncthreads();
}

}  // namespace
