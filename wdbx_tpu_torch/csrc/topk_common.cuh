// Shared pieces of the stage-1 score + top-k kernels (sm_90a, CUDA C++):
// the per-query candidate buffer and its warp-level radix select
// (CtaSel), the tile loaders, the in-register int4 unpack, and the four
// scan bodies that score a list of row tiles:
//   scan_fma_tiled  float32 slabs with float32 queries, d % 4 == 0 and
//                   16-byte aligned operands: register-tiled CUDA-core
//                   FMAs fed by a cp.async ring, selection from registers
//   scan_fma        CUDA-core float32 FMAs (every other width / type off
//                   the tensor-core slices, and unaligned views)
//   scan_mma_pipe   bf16 / int8 / int4 slabs: mma.sync bf16 x bf16 -> f32
//                   (bf16 queries) or s8 x s8 / s8 x u8 -> s32 (int8
//                   queries) on queries resident in shared memory, fed by
//                   a cp.async ring, selection from registers (a register
//                   top-k up to k = 32)
//   scan_mma        the first mma.sync body: the tensor-core launches
//                   whose k or d scan_mma_pipe cannot hold, and the
//                   old-body times
// They walk a Tiles object: RangeTiles is one contiguous row range (the
// fused flat scan, fused_topk.cu), BlockTiles the c-row blocks a CTA
// read from a block list and SpanTiles a CTA's equal share of the row
// tiles of a block list (the clustered block scan, clustered_scan.cu).
// Row numbers are global slab positions, so all emit positions as-is.
// The launcher names the body (Body); the Python wrappers pick it with
// the same shape rule and the C entry points refuse a body whose rule
// the arguments break.

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
// Stage-1 scan bodies, by the code the C entry points take.
enum Body { kBodyFma = 0, kBodyMma = 1, kBodyFmaTiled = 2, kBodyMmaPipe = 3 };

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

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

// Keep the buffer's c entries with keys above t and the first `remaining`
// equal to t, compacted in place (buffer order kept); thr becomes t.
__device__ __forceinline__ void sel_compact(const Sel& s, int c, unsigned t,
                                            int remaining, int lane) {
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
  // first `remaining` entries equal to it
  sel_compact(s, c, prefix, remaining, lane);
}

// sel_shrink's contract without a shared histogram: the k-th best key is
// found two bits at a time from warp-wide counts (redux.sync), so scores
// that share their top bits do not serialise on one atomic bin. Keys are
// never 0 here (no NaN enters a buffer), so 0 pads the register copy.
__device__ __forceinline__ void sel_cut(const Sel& s, int k, int lane) {
  const int c = *s.count;
  if (c <= k) return;
  constexpr int KR = 4;  // entries lane + 32 j, j < KR, kept in registers
  unsigned key[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int e = lane + 32 * j;
    key[j] = e < c ? f2key(s.v[e]) : 0u;
  }
  // counts of the keys at or above t1 and t2 (16 bits each: c < 65536)
  // in one word, at or above t3 in another
  auto counts = [&](unsigned t1, unsigned t2, unsigned t3, unsigned& n12,
                    unsigned& n3) {
    n12 = 0;
    n3 = 0;
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      n12 += (key[j] >= t1) | (key[j] >= t2) << 16;
      n3 += key[j] >= t3;
    }
    for (int e = lane + 32 * KR; e < c; e += 32) {
      const unsigned x = f2key(s.v[e]);
      n12 += (x >= t1) | (x >= t2) << 16;
      n3 += x >= t3;
    }
    n12 = __reduce_add_sync(kFull, n12);
    n3 = __reduce_add_sync(kFull, n3);
  };
  const unsigned want = (unsigned)k;
  unsigned t = 0;  // the largest key with at least k keys at or above it
  for (int bit = 30; bit >= 0; bit -= 2) {
    const unsigned t1 = t | (1u << bit), t2 = t | (2u << bit),
                   t3 = t | (3u << bit);
    unsigned n12, n3;
    counts(t1, t2, t3, n12, n3);
    t = n3 >= want ? t3 : (n12 >> 16) >= want ? t2
        : (n12 & 0xffffu) >= want ? t1 : t;
  }
  unsigned above, unused;  // keys above t
  counts(t + 1, t + 1, t + 1, unused, above);
  sel_compact(s, c, t, k - (int)above, lane);
}

// Offer one candidate per lane; cap >= k + 32 keeps room after a cut. A
// full buffer is cut by sel_shrink, or by sel_cut with CUT (which needs
// no histogram: s.hist may then be null).
template <bool CUT = false>
__device__ __forceinline__ void sel_offer(const Sel& s, float v, int id,
                                          int k, int cap, int lane) {
  bool want = v > *s.thr;
  unsigned m = __ballot_sync(kFull, want);
  if (m == 0) return;
  int c = *s.count;
  int n = __popc(m);
  if (c + n > cap) {
    if constexpr (CUT)
      sel_cut(s, k, lane);
    else
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

  // Cut each query's buffer to k (sel_shrink, or sel_cut with CUT) and
  // write it (unsorted, -inf / -1 pads) to its part's slot of the
  // (b, nparts, k) partials.
  template <bool CUT = false>
  __device__ void write(int q0, int b, int part, int nparts, float* part_v,
                        int* part_i, int warp, int lane) const {
    for (int ql = warp; ql < qt; ql += kWarps) {
      const int qg = q0 + ql;
      if (qg >= b) break;
      const Sel s = at(ql, warp);
      if constexpr (CUT)
        sel_cut(s, k, lane);
      else
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

// n consecutive R-row tiles of the blocks blk[0], blk[1], ... (c rows
// each, ceil(c / R) tiles a block), starting at tile `first` of blk[0]:
// one CTA's share when a block list's tiles are split across CTAs.
struct SpanTiles {
  const int* blk;
  int first, n, c;
  __device__ int count(int) const { return n; }
  __device__ void tile(int t, int R, int& r0, int& rend) const {
    const int per = (c + R - 1) / R;
    const int at = first + t;
    const int base = blk[at / per] * c;
    r0 = base + (at % per) * R;
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
// The register-tiled float32 body. True float32 is bound by operations on
// this card (67 TFLOP/s of CUDA-core FMAs against 3.35 TB/s: a 1M x 384
// slab is 0.48 ms of bytes but 1.54 ms of FMAs at B = 128), so the body
// is built to keep the FMA pipes busy:
//  * a CTA scores 128 rows x QT = 16 * TQ queries per tile; each thread
//    owns 8 rows x TQ queries of accumulators (64 at QT = 128), and every
//    16-byte shared load feeds 4 * TQ or 32 FMAs;
//  * 32-dim slices of the rows and queries go global -> shared with
//    16-byte cp.async.cg copies into a kTStages ring (zero-filled past
//    the rows, the batch and d), one barrier per slice; rows are stored
//    with a 36-word stride, so each warp's 16-byte loads are free of bank
//    conflicts (16 rows in two wavefronts, 2 queries in one);
//  * warp w owns the 2 * TQ queries [w * 2TQ, (w + 1) * 2TQ) of the tile
//    over all 128 rows (lanes 0-15 and 16-31 hold alternate queries, lane
//    l % 16 rows l % 16 + 16 i), so selection needs no CTA barrier: at
//    the end of a tile each thread masks its scores, compares them with
//    its queries' thresholds (read once a tile), and the warp appends the
//    survivors to their query's buffer in a fixed order: half-warp prefix
//    sums of the survivor counts, all columns at once (lane order, then
//    row order). Only a column that floods (a CTA's first tile: cut to the
//    tile's k best in registers) or fills its buffer (cut with sel_cut,
//    which needs no shared atomics) takes the longer tiled_append, one
//    copy of which serves every column. A tile with no survivor in the
//    warp costs one vote.
// The same inputs give the same buffer slots on every run. No TF32, no
// split products: fmaf over d in order. smem holds the ring
// (fma_tiled_words) and then the CtaSel.
constexpr int kTRows = 128;        // rows per tile
constexpr int kTStages = 3;        // cp.async ring depth
constexpr int kTStride = kDK + 4;  // shared row stride in words

__host__ __device__ inline size_t fma_tiled_words(int qt) {
  return (size_t)kTStages * (kTRows + qt) * kTStride;
}

size_t fma_tiled_smem_bytes(int qt, int cap) {
  return (fma_tiled_words(qt) + cta_sel_words(qt, cap)) * 4;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in (src
// is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Survivor counts of one accumulator column: each half-warp's total and
// this lane's exclusive prefix within its half.
__device__ __forceinline__ void half_counts(unsigned bits, int lane,
                                            int& tot0, int& tot1,
                                            int& excl) {
  const int n = __popc(bits);
  int incl = n;
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o, 16);
    if ((lane & 15) >= o) incl += t;
  }
  tot0 = __shfl_sync(kFull, incl, 15);
  tot1 = __shfl_sync(kFull, incl, 31);
  excl = incl - n;
}

// One accumulator column of a thread: rows row0 + 16 i, i < 8.
struct Col {
  float v[8];
};

// A flood (more survivors of a column than k, and than the buffer takes,
// as in a CTA's first tile): each half-warp's k-th best survivor key,
// two bits a step, the three counts of a step (at most 128 each) sharing
// one half-warp sum. Returns this lane's survivor bits at or above it
// where `mine` (its half floods), and raises that query's threshold to
// it.
__device__ __forceinline__ unsigned flood_keep(const Col& col, unsigned bits,
                                               bool mine, const Sel& s, int k,
                                               int lane) {
  unsigned key[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = (bits >> i) & 1u ? f2key(col.v[i]) : 0u;
  const unsigned want = (unsigned)k;
  unsigned t = 0;
  for (int bit = 30; bit >= 0; bit -= 2) {
    const unsigned t1 = t | (1u << bit), t2 = t | (2u << bit),
                   t3 = t | (3u << bit);
    unsigned n = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      n += (key[i] >= t1) | (key[i] >= t2) << 8 | (key[i] >= t3) << 16;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) n += __shfl_xor_sync(kFull, n, o);
    t = (n >> 16) >= want ? t3
        : ((n >> 8) & 255u) >= want ? t2
        : (n & 255u) >= want ? t1 : t;
  }
  if (!mine) return bits;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (key[i] < t) bits &= ~(1u << i);
  if ((lane & 15) == 0 && key2f(t) > *s.thr) *s.thr = key2f(t);
  return bits;
}

// Append the survivors of one column (bit i of `bits`: row row0 + 16 i)
// to local query ql0 (lanes 0-15) or ql0 + 1 (lanes 16-31): slots follow
// the half-warp's lane order, then row order. A flood is cut in registers
// first (flood_keep); a buffer that cannot take the rest is cut to k
// (sel_cut).
__device__ __forceinline__ void tiled_append(const CtaSel& sel, int ql0,
                                             unsigned bits, const Col& col,
                                             int row0, int warp, int lane) {
  const int half = lane >> 4;
  int tot0, tot1, excl;
  half_counts(bits, lane, tot0, tot1, excl);
  if (tot0 + tot1 == 0) return;
  const Sel s0 = sel.at(ql0, warp), s1 = sel.at(ql0 + 1, warp);
  const Sel s = half ? s1 : s0;
  const bool flood0 = tot0 > sel.k && *s0.count + tot0 > sel.cap;
  const bool flood1 = tot1 > sel.k && *s1.count + tot1 > sel.cap;
  if (flood0 || flood1) {
    bits = flood_keep(col, bits, half ? flood1 : flood0, s, sel.k, lane);
    __syncwarp();
    half_counts(bits, lane, tot0, tot1, excl);
  }
  int done0 = 0, done1 = 0;
  while (done0 < tot0 || done1 < tot1) {
    if (done0 < tot0 && *s0.count + (tot0 - done0) > sel.cap)
      sel_cut(s0, sel.k, lane);
    if (done1 < tot1 && *s1.count + (tot1 - done1) > sel.cap)
      sel_cut(s1, sel.k, lane);
    const int c0 = *s0.count, c1 = *s1.count;
    const int take0 = min(tot0 - done0, sel.cap - c0);
    const int take1 = min(tot1 - done1, sel.cap - c1);
    const int c = half ? c1 : c0, done = half ? done1 : done0;
    const int take = half ? take1 : take0;
    int r = excl - done;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((bits >> i) & 1u) {
        if (r >= 0 && r < take) {
          s.v[c + r] = col.v[i];
          s.i[c + r] = row0 + 16 * i;
        }
        ++r;
      }
    }
    __syncwarp();
    if (lane == 0) {
      *s0.count = c0 + take0;
      *s1.count = c1 + take1;
    }
    __syncwarp();
    done0 += take0;
    done1 += take1;
  }
}

template <int TQ, class Tiles>
__device__ void scan_fma_tiled(const Tiles& tiles, const CtaSel& sel,
                               unsigned char* smem,
                               const float* __restrict__ db,
                               const float* __restrict__ q,
                               const uint8_t* __restrict__ valid, int d,
                               int b, int q0) {
  constexpr int QT = 16 * TQ, R = kTRows, S = kTStride, TR = R / 16;
  static_assert(TR == 8, "a thread holds 8 rows of a tile (Col)");
  constexpr int STAGE = (R + QT) * S;  // words per ring stage
  constexpr int QCH = QT * (kDK / 4);  // 16-byte query chunks per slice
  float* ring = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = lane & 15;
  const int qw = warp * 2 * TQ + (lane >> 4);  // column j: query qw + 2j
  const int slices = (d + kDK - 1) / kDK;
  const int ntiles = tiles.count(R);

  sel.init(tid);  // the loop's first barrier orders it

  // This thread's 16-byte chunks of a slice: rows cr + 32 u of the tile
  // and queries cr + 32 u of the batch, at column cc of the slice.
  constexpr int RU = R * (kDK / 4) / kThreads;
  constexpr int QU = (QCH + kThreads - 1) / kThreads;
  const int cr = tid >> 3, cc = (tid & 7) * 4;
  const size_t d32 = (size_t)32 * d;
  float* const dst = ring + cr * S + cc;
  const float* const qsrc = q + (size_t)(q0 + cr) * d + cc;
  // the copy cursor: tile it, slice isl, ring stage ist; rsrc is row cr
  // of tile it, bit u of rin row cr + 32 u in range
  int it = 0, isl = 0, ist = 0;
  const float* rsrc = db;
  unsigned rin = 0;
  auto fetch = [&]() {
    if (it < ntiles) {
      if (isl == 0) {
        int r0, rend;
        tiles.tile(it, R, r0, rend);
        rsrc = db + (size_t)(r0 + cr) * d + cc;
        rin = 0;
#pragma unroll
        for (int u = 0; u < RU; ++u) rin |= (r0 + cr + 32 * u < rend) << u;
      }
      const int col = isl * kDK;
      const bool cin = col + cc < d;
      float* st = dst + ist * STAGE;
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const bool in = cin && ((rin >> u) & 1u);
        cp_async16(st + 32 * u * S, in ? rsrc + u * d32 + col : db, in);
      }
#pragma unroll
      for (int u = 0; u < QU; ++u) {
        if (QCH % kThreads == 0 || cr + 32 * u < QT) {
          const bool in = cin && q0 + cr + 32 * u < b;
          cp_async16(st + (R + 32 * u) * S, in ? qsrc + u * d32 + col : q,
                     in);
        }
      }
      if (++isl == slices) {
        isl = 0;
        ++it;
      }
      ist = ist + 1 == kTStages ? 0 : ist + 1;
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
  };

  float acc[TR][TQ];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TQ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) fetch();
  int cst = 0;  // the ring stage of the slice being scored
  for (int t = 0; t < ntiles; ++t) {
    int tile_r0, rend;
    tiles.tile(t, R, tile_r0, rend);
    bool ok[TR];  // this tile's validity, in flight during its slices
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = tile_r0 + lr + 16 * i;
      ok[i] = row < rend && __ldg(valid + row) != 0;
    }
    for (int sl = 0; sl < slices; ++sl) {
      cp_async_wait<kTStages - 2>();
      __syncthreads();  // this slice landed; the previous one is consumed
      fetch();
      const float* st = ring + cst * STAGE;
      cst = cst + 1 == kTStages ? 0 : cst + 1;
      const float* Rs = st + lr * S;
      const float* Qs = st + (R + qw) * S;
#pragma unroll
      for (int kk = 0; kk < kDK; kk += 4) {
        float4 qv[TQ];
#pragma unroll
        for (int j = 0; j < TQ; ++j)
          qv[j] = *reinterpret_cast<const float4*>(Qs + 2 * j * S + kk);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 rv =
              *reinterpret_cast<const float4*>(Rs + 16 * i * S + kk);
#pragma unroll
          for (int j = 0; j < TQ; ++j) {
            float a = acc[i][j];
            a = fmaf(rv.x, qv[j].x, a);
            a = fmaf(rv.y, qv[j].y, a);
            a = fmaf(rv.z, qv[j].z, a);
            a = fmaf(rv.w, qv[j].w, a);
            acc[i][j] = a;
          }
        }
      }
    }

    // tile done: mask, compare with the thresholds, append the survivors
    unsigned bits[TQ], cols = 0;
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int ql = qw + 2 * j;
      const float thr = sel.thr[ql];
      bits[j] = 0;
      if (q0 + ql < b) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
          if (ok[i] && acc[i][j] > thr) bits[j] |= 1u << i;
      }
      cols |= (bits[j] != 0u) << j;
    }
    if (__reduce_or_sync(kFull, cols)) {
      // All columns at once: half-warp prefix sums of the survivor counts
      // (8 bits a column, 4 columns a word: a half's total is at most
      // 128), and this lane's queries' buffer counts.
      unsigned own[2] = {0u, 0u}, incl[2];
#pragma unroll
      for (int j = 0; j < TQ; ++j)
        own[j >> 2] |= (unsigned)__popc(bits[j]) << (8 * (j & 3));
      incl[0] = own[0];
      incl[1] = own[1];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const unsigned t = __shfl_up_sync(kFull, incl[w], o, 16);
          if (lr >= o) incl[w] += t;
        }
      unsigned tot[2], slow = 0;
      int cnt[TQ];
#pragma unroll
      for (int w = 0; w < 2; ++w) tot[w] = __shfl_sync(kFull, incl[w], 15, 16);
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int tj = (tot[j >> 2] >> (8 * (j & 3))) & 255u;
        cnt[j] = sel.cnt[qw + 2 * j];
        if (tj > 0 && cnt[j] + tj > sel.cap) slow |= 1u << j;
      }
      // a column either half of which floods or overflows its buffer
      // takes tiled_append; the rest are written here, in the same order
      slow = __reduce_or_sync(kFull, slow);
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        if ((slow >> j) & 1u || bits[j] == 0) continue;
        const size_t base = (size_t)(qw + 2 * j) * sel.cap + cnt[j];
        int r = ((incl[j >> 2] - own[j >> 2]) >> (8 * (j & 3))) & 255u;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          if ((bits[j] >> i) & 1u) {
            sel.sv[base + r] = acc[i][j];
            sel.si[base + r] = tile_r0 + lr + 16 * i;
            ++r;
          }
        }
      }
      __syncwarp();
      if (lr == 0) {
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          const int tj = (tot[j >> 2] >> (8 * (j & 3))) & 255u;
          if (!((slow >> j) & 1u) && tj > 0) sel.cnt[qw + 2 * j] = cnt[j] + tj;
        }
      }
      __syncwarp();
      // One copy of the append code, not TQ: a runtime loop over the
      // slow columns, each taken from column 0 of acc / bits, which then
      // shift left (static indices keep them in registers).
#pragma unroll 1
      for (int j = 0; slow >> j; ++j) {
        if ((slow >> j) & 1u) {
          Col col;
#pragma unroll
          for (int i = 0; i < TR; ++i) col.v[i] = acc[i][0];
          tiled_append(sel, qw - (lane >> 4) + 2 * j, bits[0], col,
                       tile_r0 + lr, warp, lane);
        }
#pragma unroll
        for (int jj = 0; jj + 1 < TQ; ++jj) {
          bits[jj] = bits[jj + 1];
#pragma unroll
          for (int i = 0; i < TR; ++i) acc[i][jj] = acc[i][jj + 1];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TQ; ++j) acc[i][j] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's buffers are complete
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


// ---------------------------------------------------------------------
// The pipelined tensor-core body (bf16, int8 and packed int4 slabs; bf16
// queries, or int8 queries against int8 / int4 codes). A 1M x 384 int8
// slab is 0.12 ms of bytes on this card and its bf16 products at B = 128
// another 0.10 ms at the dense peak, so the body is built to keep both
// the copies and the tensor cores busy with few other instructions:
//  * the CTA's QT = 128 / WR queries are loaded once (cp.async) and stay
//    resident in shared memory for the whole chunk, in rows padded so
//    that fragment loads are free of bank conflicts;
//  * 128-row tiles stream through a kPStages ring of 128 bytes a row (64
//    bf16, 128 int8 or 256 int4 dims a slice), 16-byte cp.async.cg copies
//    with an XOR swizzle of the 16-byte chunks, one barrier per slice;
//    int8 and int4 rows land raw. The k-steps of a slice stop at the
//    row's bytes (int4 at d = 384 is 1.5 slices);
//  * warp w owns the 16 queries [16 (w / WR), 16 (w / WR) + 16) of the
//    CTA over the rows [RW (w % WR), RW (w % WR) + RW) of a tile, RW =
//    128 / WR. The queries are A (ldmatrix.x4), the rows B (ldmatrix.x4
//    of raw ring bytes):
//    - bf16 rows: m16n8k16 bf16, two 8-row n-tiles a ldmatrix;
//    - int8 / int4 codes against bf16 queries: m16n8k16 bf16 on four
//      8-row n-tiles of one 16-byte chunk a ldmatrix, each lane's 4 bytes
//      converted in registers, exactly (int8: a byte permute and a
//      float32 magic number; int4: the nibbles into the mantissa of bf16
//      128, then one bf16x2 subtraction of 136); the A fragment takes the
//      same order of the step's dims, and an int4 chunk feeds two
//      products: its low nibbles (dims j) and its high nibbles (dims j +
//      d/2, the packing of kernels/quant.py). Up to k = 4 kPipeKQ the
//      int4 rows are converted once a slice instead, by the whole CTA,
//      into a 64 KB bf16 staging tile in the room of the warp buffers,
//      and the warps read it as bf16 rows (a second barrier a slice, 8x
//      fewer conversions);
//    - int8 queries: m16n8k32 on raw bytes, which ldmatrix lays out as
//      the s8 fragments: s8 x s8 against int8 rows; against int4 rows the
//      nibbles (x & 0x0f0f0f0f, (x >> 4) & 0x0f0f0f0f) are the biased
//      codes as u8, an s8 x u8 product, and 8 sum(q) (summed once a CTA)
//      comes off each query's int32 sum at the tile's end: exact;
//  * selection needs no CTA barrier: each warp selects for its own 16
//    queries. At the end of a tile each thread scales its scores (int8
//    queries: the int32 sum times the row scale, then times the query
//    scale, scan_mma's order; else the row scale, 1 for bf16), masks them
//    and compares them with its two queries' thresholds (one vote a tile
//    when nothing survives). The four lanes of a quad hold a query's 128
//    scores of the tile. Up to k = 4 kPipeKQ (KQ > 0) the quad keeps the
//    query's top k in registers (KQ slots a lane, the quad's minimum as
//    the threshold) and inserts survivors one a round, best first while a
//    lane holds several, so no buffer and no cut exist. Above it each
//    warp keeps a shared buffer a query: survivors are appended in lane
//    order, then row order; a flood is cut in registers (quad_kth) and a
//    full buffer by sel_cut;
//  * the WR warps that share a query write separate partials, so the CTA
//    writes WR parts a query: (B, parts * WR, k).
// The same inputs give the same slots on every run. smem holds the ring,
// the queries, the tiles' row scales (pipe_words) and then the 128 warp
// buffers (pipe_sel_words; used above 4 kPipeKQ only).
constexpr int kPRows = 128;     // rows per tile
constexpr int kPStages = 3;     // cp.async ring depth
constexpr int kPRowBytes = 128; // bytes of a row a slice
constexpr int kPBufs = 128;     // candidate buffers: 8 warps x 16 queries
constexpr int kPipeKQ = 8;      // register top-k slots a lane: k <= 32

// Resident query row stride in bytes: the query's bytes rounded up to a
// whole slice, plus 16 (A by ldmatrix: rows 16 bytes apart mod 128) or
// 32 (bf16 queries against int8 / int4 codes: 8-byte fragment loads,
// rows 32 bytes apart).
__host__ __device__ inline int pipe_qbytes(int slab, int qtype, int d) {
  const int bytes = qtype == kQI8 ? d : 2 * d;
  return (bytes + kPRowBytes - 1) / kPRowBytes * kPRowBytes +
         (qtype != kQI8 && slab != kBF16 ? 32 : 16);
}

__host__ __device__ inline size_t pipe_words(int slab, int qtype, int qt,
                                             int d) {
  return (size_t)kPStages * kPRows * kPRowBytes / 4 +
         (size_t)qt * pipe_qbytes(slab, qtype, d) / 4 + 2 * kPRows;
}

__host__ __device__ inline size_t pipe_sel_words(int cap) {
  return 2 * (size_t)kPBufs + 2 * (size_t)kPBufs * cap;
}

// int4 rows against bf16 queries with the register top-k convert each
// slice once into a bf16 staging tile of 128 rows x 256 dims, kept where
// the warp buffers would be (the register top-k leaves them unused).
constexpr int kStageRowBytes = 512;
constexpr size_t kStageBytes = (size_t)kPRows * kStageRowBytes;

size_t pipe_smem_bytes(int slab, int qtype, int qt, int cap, int d) {
  size_t sel = pipe_sel_words(cap) * 4;
  if (slab == kI4 && qtype == kQBF16 && sel < kStageBytes) sel = kStageBytes;
  return pipe_words(slab, qtype, qt, d) * 4 + sel;
}

// The 128 warp buffers of the pipelined body, after its tiles.
struct PipeSel {
  int* cnt;    // [kPBufs]
  float* thr;  // [kPBufs]
  float* sv;   // [kPBufs][cap]
  int* si;     // [kPBufs][cap]
  int cap, k;

  __device__ PipeSel(void* p, int cap_, int k_) : cap(cap_), k(k_) {
    cnt = static_cast<int*>(p);
    thr = reinterpret_cast<float*>(cnt + kPBufs);
    sv = thr + kPBufs;
    si = reinterpret_cast<int*>(sv + (size_t)kPBufs * cap);
  }

  __device__ Sel at(int j) const {
    return Sel{sv + (size_t)j * cap, si + (size_t)j * cap, cnt + j, thr + j,
               nullptr};
  }

  // Cut each of this warp's 16 buffers to k and write it (unsorted, -inf
  // / -1 pads) as part `part` of query qbase + j's (b, nparts, k) partials.
  __device__ void write(int qbase, int b, int part, int nparts, float* part_v,
                        int* part_i, int warp, int lane) const {
    for (int j = 0; j < 16; ++j) {
      const int qg = qbase + j;
      if (qg >= b) break;
      const Sel s = at(warp * 16 + j);
      sel_cut(s, k, lane);
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Four int8 codes (bytes 0..3 of w) as two bf16 pairs, exactly: each byte
// biased to 0..255 goes into the low mantissa of 2^23 (a byte permute),
// the float subtraction of 2^23 + 128 gives the code, and the pair
// conversion rounds nothing (|code| <= 128 has 8 significant bits).
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  const float f0 = __uint_as_float(__byte_perm(u, kMagic, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, kMagic, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, kMagic, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, kMagic, 0x7653)) - 8388736.f;
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

// The eight int4 codes of packed bytes 0..3 of w (biased by +8) as four
// bf16 pairs, exactly: lo01 / lo23 hold the low nibbles of bytes 0, 1 /
// 2, 3, hi01 / hi23 their high nibbles. A nibble n in the low mantissa
// bits of bf16 128 (0x4300 | n) is 128 + n, and one bf16x2 subtraction of
// 136 gives n - 8 (no rounding: every value is a small integer).
__device__ __forceinline__ void i4x8_bf16(uint32_t w, uint32_t& lo01,
                                          uint32_t& lo23, uint32_t& hi01,
                                          uint32_t& hi23) {
  const uint32_t p01 = __byte_perm(w, 0u, 0x4140);  // byte 0 | byte 1 << 16
  const uint32_t p23 = __byte_perm(w, 0u, 0x4342);
  auto cvt = [](uint32_t x) {
    const uint32_t y = (x & 0x000f000fu) | 0x43004300u;
    const uint32_t bias = 0x43084308u;  // (136, 136)
    __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y),
                               *reinterpret_cast<const __nv_bfloat162*>(&bias));
    return *reinterpret_cast<uint32_t*>(&v);
  };
  lo01 = cvt(p01);
  lo23 = cvt(p23);
  hi01 = cvt(p01 >> 4);
  hi23 = cvt(p23 >> 4);
}

// m16n8k32 integer products into accumulators kept as float registers
// holding int32 bits (the pipelined body's one accumulator array): s8 x
// s8, or s8 x u8 (U8: int8 queries against biased int4 codes).
template <bool U8>
__device__ __forceinline__ void mma_s8_bits(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint32_t b0,
                                            uint32_t b1) {
  int x[4] = {__float_as_int(c[0]), __float_as_int(c[1]),
              __float_as_int(c[2]), __float_as_int(c[3])};
  if constexpr (U8)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    mma_s8(x, a0, a1, a2, a3, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __int_as_float(x[e]);
}


// Append the survivors of one query held in acc[.][2h + j] (bit 2n + j of
// `bits`: row rowg + 8n + j) to buffer s, from slot c: this lane's
// survivors take ranks r, r + 1, ... in row order, and those of rank
// below `take` are written and cleared from `bits`.
template <int NT>
__device__ __forceinline__ void pipe_put(const Sel& s, const float (&acc)[NT][4],
                                         int h, unsigned& bits, int c, int r,
                                         int take, int rowg) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = 2 * n + j;
      if ((bits >> i) & 1u) {
        if (r >= 0 && r < take) {
          s.v[c + r] = h ? acc[n][2 + j] : acc[n][j];
          s.i[c + r] = rowg + 8 * n + j;
          bits &= ~(1u << i);
        }
        ++r;
      }
    }
}

// A flood (a query's survivors of one tile outnumber k and overflow its
// buffer, as in a CTA's first tile): the k-th best survivor key of each
// quad's query (half H of the accumulators), two bits a step, the three
// counts of a step (at most 128 each) sharing one quad sum. Every lane
// takes part; a quad with no flood computes a key it does not use. The
// scores are turned into their keys in place and back (exact).
template <int H, int NT>
__device__ __forceinline__ unsigned quad_kth(float (&acc)[NT][4],
                                             unsigned bits, int k) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const unsigned key =
          (bits >> (2 * n + j)) & 1u ? f2key(acc[n][2 * H + j]) : 0u;
      acc[n][2 * H + j] = __uint_as_float(key);
    }
  const unsigned want = (unsigned)k;
  unsigned t = 0;
  for (int bit = 30; bit >= 0; bit -= 2) {
    const unsigned t1 = t | (1u << bit), t2 = t | (2u << bit),
                   t3 = t | (3u << bit);
    unsigned n = 0;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned key = __float_as_uint(acc[i][2 * H + j]);
        n += (key >= t1) | (key >= t2) << 8 | (key >= t3) << 16;
      }
    n += __shfl_xor_sync(kFull, n, 1);
    n += __shfl_xor_sync(kFull, n, 2);
    t = (n >> 16) >= want ? t3
        : ((n >> 8) & 255u) >= want ? t2
        : (n & 255u) >= want ? t1 : t;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const unsigned key = __float_as_uint(acc[n][2 * H + j]);
      acc[n][2 * H + j] = key ? key2f(key) : 0.f;
    }
  return t;
}

// Inclusive prefix over the 4 lanes of a quad, and the quad's total.
__device__ __forceinline__ unsigned quad_incl(unsigned x, int t) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o, 4);
    if (t >= o) x += y;
  }
  return x;
}

// Insert one survivor (value v of row `row`, quad-uniform) into the
// quad's register top-k of one query (slots tv / ti, 4 j + t < k active,
// inactive slots +inf) when it beats the quad's minimum qthr: the minimum
// slot (the lowest lane's, then its lowest slot, on ties) takes it, and
// qthr becomes the new minimum. Every lane of the warp calls it.
template <int KQ>
__device__ __forceinline__ void reg_insert(float (&tv)[KQ], int (&ti)[KQ],
                                           float& qthr, float v, int row,
                                           int t) {
  const bool take = v > qthr;  // quad-uniform; every lane shuffles
  float m = INFINITY;
  int lj = 0;
#pragma unroll
  for (int j = 0; j < KQ; ++j)
    if (tv[j] < m) {
      m = tv[j];
      lj = j;
    }
  int who = t;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float om = __shfl_xor_sync(kFull, m, o);
    const int ow = __shfl_xor_sync(kFull, who, o);
    if (om < m || (om == m && ow < who)) {
      m = om;
      who = ow;
    }
  }
  if (take && who == t) {
#pragma unroll
    for (int j = 0; j < KQ; ++j)
      if (j == lj) {
        tv[j] = v;
        ti[j] = row;
      }
  }
  m = INFINITY;
#pragma unroll
  for (int j = 0; j < KQ; ++j) m = fminf(m, tv[j]);
  m = fminf(m, __shfl_xor_sync(kFull, m, 1));
  qthr = fminf(m, __shfl_xor_sync(kFull, m, 2));
}

// The quad's next pending survivor of query half H (bit 2n + j of
// `bits`: row rowg + 8n + j of lane t), taken from `bits` and broadcast to
// the quad as (v, row); v is -inf when the quad has none pending. With
// `best` it is the quad's best (ties to the lower lane, then the lower
// row), else the lowest pending row of the quad's lowest lane holding one.
template <int H, int NT>
__device__ __forceinline__ void reg_next(const float (&acc)[NT][4],
                                         unsigned& bits, int rowg, int lane,
                                         bool best, float& v, int& row) {
  const int t = lane & 3;
  float m = -INFINITY;
  int li = 0, who = t;
  if (best) {
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if ((bits >> (2 * a + j)) & 1u && acc[a][2 * H + j] > m) {
          m = acc[a][2 * H + j];
          li = 2 * a + j;
        }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(kFull, m, o);
      const int ow = __shfl_xor_sync(kFull, who, o);
      if (om > m || (om == m && ow < who)) {
        m = om;
        who = ow;
      }
    }
    li = __shfl_sync(kFull, li, (lane & ~3) | who);
  } else {
    const unsigned qm =
        (__ballot_sync(kFull, bits != 0u) >> (lane & ~3)) & 15u;
    who = qm ? __ffs(qm) - 1 : 0;
    if (t == who && bits) {
      li = __ffs(bits) - 1;
#pragma unroll
      for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (li == 2 * a + j) m = acc[a][2 * H + j];
    }
    m = __shfl_sync(kFull, m, (lane & ~3) | who);
    li = __shfl_sync(kFull, li, (lane & ~3) | who);
  }
  if (t == who && m > -INFINITY) bits &= ~(1u << li);
  v = m;
  row = rowg + 2 * (who - t) + 8 * (li >> 1) + (li & 1);
}

// Drop the pending survivors that no longer beat the quad's threshold.
template <int H, int NT>
__device__ __forceinline__ unsigned reg_drop(const float (&acc)[NT][4],
                                             unsigned bits, float qthr) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (!(acc[i][2 * H + j] > qthr)) bits &= ~(1u << (2 * i + j));
  return bits;
}

// Both queries' survivors of a tile into their quads' register top-k:
// each round every quad inserts one pending survivor of each query, then
// drops what fell below the raised thresholds. While some lane holds two
// or more, the round takes each quad's best (a flood, as in a CTA's first
// tile or a tile of a nearer cluster, then takes k rounds), else the
// cheaper lowest pending row. The order is fixed by the inputs: the same
// inputs give the same slots.
template <int NT, int KQ>
__device__ __forceinline__ void reg_offer(const float (&acc)[NT][4],
                                          unsigned b0, unsigned b1,
                                          float (&tv)[2][KQ], int (&ti)[2][KQ],
                                          float (&qthr)[2], int rowg,
                                          int lane) {
  while (__any_sync(kFull, (b0 | b1) != 0u)) {
    float v0, v1;
    int r0, r1;
    const bool best =
        __any_sync(kFull, (b0 & (b0 - 1)) != 0u || (b1 & (b1 - 1)) != 0u);
    reg_next<0>(acc, b0, rowg, lane, best, v0, r0);
    reg_next<1>(acc, b1, rowg, lane, best, v1, r1);
    reg_insert(tv[0], ti[0], qthr[0], v0, r0, lane & 3);
    reg_insert(tv[1], ti[1], qthr[1], v1, r1, lane & 3);
    b0 = reg_drop<0>(acc, b0, qthr[0]);
    b1 = reg_drop<1>(acc, b1, qthr[1]);
  }
}

template <int SLAB, int QTYPE, int WR, int KQ, class Tiles>
__device__ void scan_mma_pipe(const Tiles& tiles, const PipeSel& sel,
                              unsigned char* smem, const void* __restrict__ db,
                              const void* __restrict__ q,
                              const float* __restrict__ qscale,
                              const uint8_t* __restrict__ valid,
                              const float* __restrict__ scales, int d, int b,
                              int q0, float* __restrict__ part_v,
                              int* __restrict__ part_i, int part,
                              int nparts) {
  static_assert(SLAB != kF32, "float32 slabs take the FMA bodies");
  static_assert(QTYPE == kQBF16 || (QTYPE == kQI8 && SLAB != kBF16),
                "bf16 queries, or int8 queries against int8 / int4 codes");
  static_assert(WR == 1 || WR == 2 || WR == 4, "128, 64 or 32 queries");
  constexpr bool S8 = QTYPE == kQI8;
  constexpr bool I4 = SLAB == kI4;
  constexpr bool SCALED = SLAB != kBF16;  // rows carry a scale
  // bf16 queries against int8 / int4 codes take a 16-byte chunk of a row
  // a k-step (16 or 32 dims), the others 32 bytes (16 bf16 or 32 int8 /
  // 64 int4 dims)
  constexpr bool CHUNK = !S8 && SCALED;
  // int4 rows against bf16 queries with the register top-k: the CTA
  // converts each slice once into the bf16 staging tile (kStageBytes, in
  // the warp buffers' room) and the warps take bf16 fragments from it,
  // instead of every warp converting every row of the slice
  constexpr bool STAGED = CHUNK && I4 && KQ > 0;
  constexpr int QT = 128 / WR, RW = kPRows / WR, NT = RW / 8;
  constexpr int STAGE = kPRows * kPRowBytes;  // bytes per ring stage
  constexpr int SB = CHUNK ? 16 : 32;         // row bytes a k-step
  constexpr int KS = kPRowBytes / SB;         // k-steps a slice
  constexpr int QE = S8 ? 1 : 2;              // bytes a query element
  const int QB = pipe_qbytes(SLAB, QTYPE, d);
  unsigned char* const ring = smem;
  unsigned char* const Qs = smem + kPStages * STAGE;
  float* const rbuf = reinterpret_cast<float*>(Qs + QT * QB);  // [2][128]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qb = warp / WR, rowbase = (warp % WR) * RW;
  const int half = d / 2;
  const int row_bytes = I4 ? half : (SLAB == kBF16 ? 2 * d : d);
  const int slices = (row_bytes + kPRowBytes - 1) / kPRowBytes;
  const int ntiles = tiles.count(kPRows);
  const char* const rb = static_cast<const char*>(db);
  const char* const qsrc = static_cast<const char*>(q);

  unsigned char* const stg = reinterpret_cast<unsigned char*>(sel.cnt);
  if (KQ == 0 && lane < 16) {
    sel.cnt[warp * 16 + lane] = 0;
    sel.thr[warp * 16 + lane] = -INFINITY;
  }
  {  // the queries, once: zero past the batch and past d
    const int qch = QB / 16, dch = d * QE / 16;
    for (int e = tid; e < QT * qch; e += kThreads) {
      const int r = e / qch, c = e - r * qch;
      const bool in = q0 + r < b && c < dch;
      cp_async16(Qs + r * QB + c * 16,
                 in ? qsrc + ((size_t)(q0 + r) * d * QE + c * 16) : q, in);
    }
    cp_async_commit();
  }
  // int8 queries: this thread's two queries' scales and, against int4
  // codes, 8 sum(q) (the bias of the u8 nibbles), the quad's lanes
  // summing every fourth 16-byte chunk
  float qsc[2] = {1.f, 1.f};
  int qbias[2] = {0, 0};
  if constexpr (S8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qg = q0 + qb * 16 + g + 8 * h;
      if (qg < b) qsc[h] = __ldg(qscale + qg);
      if constexpr (I4) {
        int sum = 0;
        if (qg < b)
          for (int c = t; c < d / 16; c += 4) {
            const uint4 v = ldg16(qsrc + (size_t)qg * d + c * 16);
            sum = __dp4a((int)v.x, 0x01010101, sum);
            sum = __dp4a((int)v.y, 0x01010101, sum);
            sum = __dp4a((int)v.z, 0x01010101, sum);
            sum = __dp4a((int)v.w, 0x01010101, sum);
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        qbias[h] = 8 * sum;
      }
    }
  }

  // This thread's 16-byte chunks of a slice: chunk cc of rows cr + 32 u,
  // stored at chunk cc ^ (row & 7) of the row.
  const int cr = tid >> 3, cc = tid & 7;
  int it = 0, isl = 0, ist = 0;  // the copy cursor: tile, slice, stage
  const char* rsrc = rb;
  unsigned rin = 0;
  auto fetch = [&]() {
    if (it < ntiles) {
      if (isl == 0) {
        int r0, rend;
        tiles.tile(it, kPRows, r0, rend);
        rsrc = rb + (size_t)(r0 + cr) * row_bytes + cc * 16;
        rin = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) rin |= (unsigned)(r0 + cr + 32 * u < rend) << u;
      }
      const int col = isl * kPRowBytes;
      const bool cin = col + cc * 16 < row_bytes;
      unsigned char* const st = ring + ist * STAGE;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = cr + 32 * u;
        const bool in = cin && ((rin >> u) & 1u);
        cp_async16(st + r * kPRowBytes + ((cc ^ (r & 7)) << 4),
                       in ? rsrc + (size_t)u * 32 * row_bytes + col : db, in);
      }
      if (++isl == slices) {
        isl = 0;
        ++it;
      }
      ist = ist + 1 == kPStages ? 0 : ist + 1;
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
  };

  // Validity and scale of row tid of a tile, loaded a tile ahead and
  // stored at the tile's first slice: the scale (1 for bf16) or NaN.
  int pend_ok = 0;
  float pend_sc = 1.f;
  auto rowinfo = [&](int tt) {
    if (tid < kPRows && tt < ntiles) {
      int r0, rend;
      tiles.tile(tt, kPRows, r0, rend);
      const int row = r0 + tid;
      pend_ok = row < rend ? (int)__ldg(valid + row) : 0;
      if constexpr (SCALED) pend_sc = row < rend ? __ldg(scales + row) : 1.f;
    }
  };

  // float32 sums, or int32 sums kept as their bits (int8 queries)
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // register top-k (KQ > 0, k <= 4 KQ): the quad of lanes 4g..4g+3 holds
  // queries g (h = 0) and g + 8 (h = 1), slot 4 j + t active below k
  constexpr int KR = KQ > 0 ? KQ : 1;
  float tv[2][KR];
  int ti[2][KR];
  float qthr[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      tv[h][j] = 4 * j + t < sel.k ? -INFINITY : INFINITY;
      ti[h][j] = -1;
    }

  rowinfo(0);
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) fetch();
  int cst = 0;  // the ring stage of the slice being scored
  const unsigned char* const Qw = Qs + qb * 16 * QB;
  for (int tt = 0; tt < ntiles; ++tt) {
    int tile_r0, rend;
    tiles.tile(tt, kPRows, tile_r0, rend);
    float* const ri = rbuf + (tt & 1) * kPRows;
    for (int sl = 0; sl < slices; ++sl) {
      cp_async_wait<kPStages - 2>();
      __syncthreads();  // this slice landed; the previous one is consumed
      if (sl == 0 && tid < kPRows) {
        ri[tid] = pend_ok ? pend_sc : __int_as_float(0x7fffffff);
        rowinfo(tt + 1);
      }
      fetch();
      const unsigned char* const st = ring + cst * STAGE;
      cst = cst + 1 == kPStages ? 0 : cst + 1;
      if constexpr (STAGED) {
        // this thread's chunks cc of rows cr + 32 u: 16 packed bytes give
        // 16 low and 16 high dims, staged as bf16 at chunks 2 cc, 2 cc + 1
        // (low half of the row) and 16 + 2 cc, 17 + 2 cc (high half),
        // swizzled as the ring is
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = cr + 32 * u, sw = r & 7;
          const uint4 w = *reinterpret_cast<const uint4*>(
              st + r * kPRowBytes + ((cc ^ sw) << 4));
          uint32_t lo[8], hi[8];
          i4x8_bf16(w.x, lo[0], lo[1], hi[0], hi[1]);
          i4x8_bf16(w.y, lo[2], lo[3], hi[2], hi[3]);
          i4x8_bf16(w.z, lo[4], lo[5], hi[4], hi[5]);
          i4x8_bf16(w.w, lo[6], lo[7], hi[6], hi[7]);
          unsigned char* const row = stg + r * kStageRowBytes;
          *reinterpret_cast<uint4*>(row + (((2 * cc) ^ sw) << 4)) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(row + (((2 * cc + 1) ^ sw) << 4)) =
              make_uint4(lo[4], lo[5], lo[6], lo[7]);
          *reinterpret_cast<uint4*>(row + (((16 + 2 * cc) ^ sw) << 4)) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(row + (((17 + 2 * cc) ^ sw) << 4)) =
              make_uint4(hi[4], hi[5], hi[6], hi[7]);
        }
        __syncthreads();  // the slice's bf16 tile is complete
        // k16-step kk: staged dims 16 kk, which are the slice's low dims
        // sl * 128 + 16 kk (kk < 8) or its high dims d/2 + sl * 128 +
        // 16 (kk - 8)
        auto sstep = [&](int kk) {
          const int qd = (kk < 8 ? 0 : half - 128) + sl * kPRowBytes + kk * 16;
          uint32_t a[4];
          ldsm_x4(a, Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * QB + qd * 2 +
                         (lane >> 4) * 16);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int r = rowbase + np * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int ch = kk * 2 + ((lane >> 3) & 1);
            uint32_t bq[4];
            ldsm_x4(bq, stg + r * kStageRowBytes + ((ch ^ (r & 7)) << 4));
            mma_bf16(acc[2 * np], a[0], a[1], a[2], a[3], bq[0], bq[1]);
            mma_bf16(acc[2 * np + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
          }
        };
        if ((sl + 1) * kPRowBytes <= row_bytes) {
#pragma unroll
          for (int kk = 0; kk < 16; ++kk) sstep(kk);
        } else {  // a last slice past the row's end: the dims it holds
          const int kl = (row_bytes - sl * kPRowBytes + 15) / 16;
          for (int kk = 0; kk < kl; ++kk) {
            sstep(kk);
            sstep(8 + kk);
          }
        }
        continue;
      }
      // k-step kk: SB bytes of every row of the slice, from row byte col
      auto kstep = [&](int kk) {
        const int col = sl * kPRowBytes + kk * SB;
        if constexpr (CHUNK) {
          // A in the order the code B fragments take: dims 4t..4t+3 of
          // the chunk's (a0 / a2 of query g, a1 / a3 of query g + 8); an
          // int4 chunk's high nibbles are dims d/2 further on
          const unsigned char* const qa = Qw + g * QB + (col + 4 * t) * 2;
          const uint2 x0 = *reinterpret_cast<const uint2*>(qa);
          const uint2 x1 = *reinterpret_cast<const uint2*>(qa + 8 * QB);
          uint2 y0 = x0, y1 = x1;
          if constexpr (I4) {
            y0 = *reinterpret_cast<const uint2*>(qa + 2 * half);
            y1 = *reinterpret_cast<const uint2*>(qa + 8 * QB + 2 * half);
          }
#pragma unroll
          for (int nq = 0; nq < NT / 4; ++nq) {
            const int r = rowbase + nq * 32 + lane;
            uint32_t raw[4];
            ldsm_x4(raw, st + r * kPRowBytes + ((kk ^ (r & 7)) << 4));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if constexpr (I4) {
                uint32_t l01, l23, h01, h23;
                i4x8_bf16(raw[i], l01, l23, h01, h23);
                mma_bf16(acc[nq * 4 + i], x0.x, x1.x, x0.y, x1.y, l01, l23);
                mma_bf16(acc[nq * 4 + i], y0.x, y1.x, y0.y, y1.y, h01, h23);
              } else {
                uint32_t b0, b1;
                i8x4_bf16(raw[i], b0, b1);
                mma_bf16(acc[nq * 4 + i], x0.x, x1.x, x0.y, x1.y, b0, b1);
              }
            }
          }
        } else {
          // 32 row bytes: A for 16 queries by one ldmatrix.x4 (bf16 k16,
          // or int8 k32 whose s8 fragments are the same bytes), B two
          // 8-row n-tiles a ldmatrix.x4
          const unsigned char* const qa =
              Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * QB +
              (lane >> 4) * 16;
          uint32_t a[4], ah[4];
          ldsm_x4(a, qa + col);  // a row byte's query byte: the same offset
          if constexpr (I4) ldsm_x4(ah, qa + half + col);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int r = rowbase + np * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int ch = kk * 2 + ((lane >> 3) & 1);
            uint32_t bq[4];
            ldsm_x4(bq, st + r * kPRowBytes + ((ch ^ (r & 7)) << 4));
            if constexpr (I4) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const uint32_t b0 = bq[2 * u], b1 = bq[2 * u + 1];
                mma_s8_bits<true>(acc[2 * np + u], a[0], a[1], a[2], a[3],
                                  b0 & 0x0f0f0f0fu, b1 & 0x0f0f0f0fu);
                mma_s8_bits<true>(acc[2 * np + u], ah[0], ah[1], ah[2],
                                  ah[3], (b0 >> 4) & 0x0f0f0f0fu,
                                  (b1 >> 4) & 0x0f0f0f0fu);
              }
            } else if constexpr (S8) {
              mma_s8_bits<false>(acc[2 * np], a[0], a[1], a[2], a[3], bq[0],
                                 bq[1]);
              mma_s8_bits<false>(acc[2 * np + 1], a[0], a[1], a[2], a[3],
                                 bq[2], bq[3]);
            } else {
              mma_bf16(acc[2 * np], a[0], a[1], a[2], a[3], bq[0], bq[1]);
              mma_bf16(acc[2 * np + 1], a[0], a[1], a[2], a[3], bq[2],
                       bq[3]);
            }
          }
        }
      };
      if ((sl + 1) * kPRowBytes <= row_bytes) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) kstep(kk);
      } else {  // a last slice past the row's end: the steps with its bytes
        const int kend = (row_bytes - sl * kPRowBytes + SB - 1) / SB;
        for (int kk = 0; kk < kend; ++kk) kstep(kk);
      }
    }
    if (slices == 1) __syncthreads();  // this tile's row scales are stored

    // tile done: scale, mask, compare with the thresholds, append
    const int buf0 = warp * 16 + g, buf1 = buf0 + 8;
    const int qg0 = q0 + qb * 16 + g;
    const float thr0 =
        qg0 < b ? (KQ > 0 ? qthr[0] : sel.thr[buf0]) : INFINITY;
    const float thr1 =
        qg0 + 8 < b ? (KQ > 0 ? qthr[1] : sel.thr[buf1]) : INFINITY;
    const int rowg = tile_r0 + rowbase + 2 * t;
    unsigned bits0 = 0, bits1 = 0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 sc =
          *reinterpret_cast<const float2*>(ri + rowbase + 2 * t + 8 * n);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x = j ? sc.y : sc.x;
        const bool ok = x == x;
        if constexpr (S8) {  // int32 sum (less 8 sum(q)), row, query scale
          acc[n][j] =
              (float)(__float_as_int(acc[n][j]) - qbias[0]) * x * qsc[0];
          acc[n][2 + j] =
              (float)(__float_as_int(acc[n][2 + j]) - qbias[1]) * x * qsc[1];
        } else if constexpr (SCALED) {
          acc[n][j] *= x;
          acc[n][2 + j] *= x;
        }
        if (ok && acc[n][j] > thr0) bits0 |= 1u << (2 * n + j);
        if (ok && acc[n][2 + j] > thr1) bits1 |= 1u << (2 * n + j);
      }
    }
    if constexpr (KQ > 0) {
      if (__any_sync(kFull, (bits0 | bits1) != 0u))
        reg_offer(acc, bits0, bits1, tv, ti, qthr, rowg, lane);
    } else if (__any_sync(kFull, (bits0 | bits1) != 0u)) {
      // both queries' survivor counts in one word (at most 128 a quad)
      unsigned own = __popc(bits0) | (unsigned)__popc(bits1) << 16;
      unsigned incl = quad_incl(own, t);
      unsigned tot = __shfl_sync(kFull, incl, 3, 4);
      const int c0 = sel.cnt[buf0], c1 = sel.cnt[buf1];
      // floods are cut in registers to the tile's k best (and ties),
      // which raises the query's threshold to the k-th of them
      const bool flood0 = (int)(tot & 0xffffu) > sel.k &&
                          c0 + (int)(tot & 0xffffu) > sel.cap;
      const bool flood1 = (int)(tot >> 16) > sel.k &&
                          c1 + (int)(tot >> 16) > sel.cap;
      if (__any_sync(kFull, flood0 || flood1)) {
        if (__any_sync(kFull, flood0)) {
          const unsigned kt = quad_kth<0>(acc, bits0, sel.k);
          if (flood0) {
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                if (!(f2key(acc[n][j]) >= kt)) bits0 &= ~(1u << (2 * n + j));
            if (t == 0 && key2f(kt) > sel.thr[buf0]) sel.thr[buf0] = key2f(kt);
          }
        }
        if (__any_sync(kFull, flood1)) {
          const unsigned kt = quad_kth<1>(acc, bits1, sel.k);
          if (flood1) {
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                if (!(f2key(acc[n][2 + j]) >= kt))
                  bits1 &= ~(1u << (2 * n + j));
            if (t == 0 && key2f(kt) > sel.thr[buf1]) sel.thr[buf1] = key2f(kt);
          }
        }
        own = __popc(bits0) | (unsigned)__popc(bits1) << 16;
        incl = quad_incl(own, t);
        tot = __shfl_sync(kFull, incl, 3, 4);
      }
      const unsigned excl = incl - own;
      const int tot0 = tot & 0xffffu, tot1 = tot >> 16;
      const bool slow0 = tot0 > 0 && c0 + tot0 > sel.cap;
      const bool slow1 = tot1 > 0 && c1 + tot1 > sel.cap;
      {  // the other queries' survivors, one a lane a step (few a tile
         // once the thresholds rise): this lane's slots follow its rank in
         // the quad (lane order), its survivors go lowest row first
        unsigned f0 = slow0 ? 0u : bits0, f1 = slow1 ? 0u : bits1;
        int p0 = buf0 * sel.cap + c0 + (int)(excl & 0xffffu);
        int p1 = buf1 * sel.cap + c1 + (int)(excl >> 16);
        while (__any_sync(kFull, (f0 | f1) != 0u)) {
          if (f0 | f1) {
            const bool h = f0 == 0u;
            const int i = __ffs(h ? f1 : f0) - 1;
            float v = 0.f;
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                v = i == 2 * n + j ? (h ? acc[n][2 + j] : acc[n][j]) : v;
            const int pos = h ? p1++ : p0++;
            sel.sv[pos] = v;
            sel.si[pos] = rowg + 8 * (i >> 1) + (i & 1);
            if (h)
              f1 &= f1 - 1;
            else
              f0 &= f0 - 1;
          }
        }
      }
      __syncwarp();
      if (t == 0) {
        if (!slow0 && tot0 > 0) sel.cnt[buf0] = c0 + tot0;
        if (!slow1 && tot1 > 0) sel.cnt[buf1] = c1 + tot1;
      }
      const unsigned slow = __reduce_or_sync(
          kFull, t == 0 ? (unsigned)slow0 << g | (unsigned)slow1 << (g + 8)
                        : 0u);
      __syncwarp();
      // A query whose buffer overflows: the whole warp appends what fits,
      // cuts the buffer to k (sel_cut), drops the survivors below the new
      // threshold, and goes on until none is left. One copy of the code.
#pragma unroll 1
      for (int j = 0; j < 16; ++j) {
        if (!((slow >> j) & 1u)) continue;
        const int gj = j & 7, hj = j >> 3;
        const Sel s = sel.at(warp * 16 + j);
        unsigned mine = g == gj ? (hj ? bits1 : bits0) : 0u;
        for (;;) {
          const unsigned n = __popc(mine);
          const unsigned inc = quad_incl(n, t);
          const int left = (int)__shfl_sync(kFull, inc, gj * 4 + 3);
          if (left == 0) break;
          const int c = *s.count;
          if (c + left > sel.cap && c > sel.k) {
            sel_cut(s, sel.k, lane);
            const float th = *s.thr;
#pragma unroll
            for (int nn = 0; nn < NT; ++nn)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const float v = hj ? acc[nn][2 + jj] : acc[nn][jj];
                if (!(v > th)) mine &= ~(1u << (2 * nn + jj));
              }
            continue;
          }
          const int take = min(left, sel.cap - c);
          pipe_put(s, acc, hj, mine, c, (int)(inc - n), take, rowg);
          __syncwarp();
          if (lane == 0) *s.count = c + take;
          __syncwarp();
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  cp_async_wait<0>();
  __syncwarp();
  // this warp's 16 queries as part `part` of their (b, nparts, k) partials
  const int qbase = q0 + qb * 16;
  if constexpr (KQ > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qg = qbase + g + 8 * h;
      if (qg >= b) continue;
      const size_t base = ((size_t)qg * nparts + part) * sel.k;
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
        const int e = 4 * j + t;
        if (e < sel.k) {
          part_v[base + e] = tv[h][j];
          part_i[base + e] = ti[h][j];
        }
      }
    }
  } else {
    sel.write(qbase, b, part, nparts, part_v, part_i, warp, lane);
  }
}

}  // namespace
