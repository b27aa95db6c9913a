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
// Bound on an H100 (3.35 TB/s HBM): bytes. Pairs that probe one bucket
// share its rows, so the least the call must move is the valid rows of
// the unique probed buckets, read once, with their validity bytes, plus
// the pair ids, the queries and the results. A row costs 2 d operations
// per pair that probes it, ~1 per byte of a bf16 table at the batches
// served, far below the ~295 a byte at which the tensor cores would be
// the limit. At the dense engine's 1M x 384 bf16 point (nlist 1,024,
// C = 1,408, ~1,000 valid rows a bucket) B = 64 at nprobe 9 is 576 pairs
// on ~440 unique buckets: ~0.35 GB, 0.10 ms (chip_smoke.py's _bound_k5).
//
// Design. The TPU kernel walks the S pairs on a sequential grid (probe
// ids scalar-prefetched into the index maps), keeps every pair's result
// in a VMEM scratch of all S rows, and reads the validity mask as an 8x
// replicated table because Mosaic refuses (1, C) blocks. Here:
//   stage 0 (ivf_group_pairs_kernel, one CTA): a counting sort of the
//     pairs by bucket, with bins in shared memory taken 4,096 at a time.
//     It writes the pair ids in bucket order and a work list of items,
//     each at most g pairs of one bucket (a bucket probed by more pairs
//     is several items), and the item count, which stays on the card.
//     A pair whose probe or query id is out of range lands in an item of
//     bucket -1, which scores nothing.
//   stage 1, grouped (ivf_grouped_partial_kernel): the grid is the
//     resident CTA count, and each warp claims (item, part) units from a
//     counter that stage 0 zeroed, so the tail is under one unit whatever
//     the item count turns out to be. A part is a range of whole 32-row
//     groups of the bucket, fixed by C and the pair count on the host
//     (the partial layout needs it there). Per unit a warp reads the
//     part's validity bytes once (a ballot a group), streams the live
//     rows of the live groups through a private 3-stage ring of 16-byte
//     cp.async.cg copies (a tile is 32 rows x 128 bytes, the DRAM's
//     whole lines; rows padded to 144 bytes so that lane L reads row L's
//     chunks free of bank conflicts), and scores each row against every
//     pair of the item with CUDA-core float32 FMAs, lane L owning row L:
//     no shuffles, the scores land one per lane, as Sel offers them. The
//     pair count is a compile-time constant of the scoring loop and each
//     pair keeps 4 interleaved sums, so the FMAs hide behind the copies;
//     the next unit's item, pair ids and validity load while the current
//     one streams. A row is read from HBM once per item, so once per call
//     unless more than g pairs probe its bucket. No tensor cores: at ~1.3
//     pairs a bucket an m16 tile would idle 15 of its rows, and the FMAs
//     are far below their peak. Each (pair, part) keeps its own candidate
//     buffer (Sel, cut by sel_cut) and writes one partial of (S, parts,
//     k) at the pair's own index.
//   stage 1, per pair (ivf_bucket_partial_kernel): the first port, kept
//     for widths whose rows are not whole 16-byte chunks and unaligned
//     tables, and as the old body to time against. A grid of (pairs) x
//     (row splits); each warp walks groups of 32 rows of its split: one
//     ballot of the group's validity bytes, then the live rows four at a
//     time, each lane streaming its 16-byte chunks of the four rows (a
//     shuffle reduction per row); it writes (S, splits * warps, k).
//   stage 2 is the shared topk_merge_partials of fused_topk.cu with S in
//     the place of B.
// The Python wrapper picks the stage-1 body from the shapes
// (ivf_scan.pick_body); the C entry points refuse arguments a body
// cannot take. Times in PERF.md.

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

// ---------------------------------------------------------------------
// Stage 0: the pairs grouped by bucket.

constexpr int kSortThreads = 1024;
constexpr int kBinWindow = 4096;  // bins counted per pass, 4 a thread

// The bin of pair e: its bucket, or nlist when its probe or query id is
// out of range.
__device__ __forceinline__ int pair_bin(const int* __restrict__ probes,
                                        const int* __restrict__ qidx, int e,
                                        int nlist, int b) {
  const int p = probes[e], qi = qidx[e];
  return p >= 0 && p < nlist && qi >= 0 && qi < b ? p : nlist;
}

// Exclusive scan of (a, c) over the CTA's kSortThreads threads; ta / tc
// get the totals. sh holds 64 ints.
__device__ void block_scan2(int& a, int& c, int* sh, int& ta, int& tc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ic = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xa = __shfl_up_sync(kFull, ia, o);
    const int xc = __shfl_up_sync(kFull, ic, o);
    if (lane >= o) {
      ia += xa;
      ic += xc;
    }
  }
  if (lane == 31) {
    sh[warp] = ia;
    sh[32 + warp] = ic;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = sh[lane], wc = sh[32 + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xa = __shfl_up_sync(kFull, wa, o);
      const int xc = __shfl_up_sync(kFull, wc, o);
      if (lane >= o) {
        wa += xa;
        wc += xc;
      }
    }
    sh[lane] = wa;
    sh[32 + lane] = wc;
  }
  __syncthreads();
  a = (warp ? sh[warp - 1] : 0) + ia - a;
  c = (warp ? sh[31 + warp] : 0) + ic - c;
  ta = sh[31];
  tc = sh[63];
  __syncthreads();  // sh is reused by the next scan
}

// order (s,): the pair ids by bin; items (s, 3): per item its bucket (-1
// for the out-of-range bin), its first position in order and its pair
// count (<= g), in bin order; n_items[0] the item count, n_items[1] = 0
// (stage 1's unit counter).
__global__ void __launch_bounds__(kSortThreads)
ivf_group_pairs_kernel(const int* __restrict__ probes,
                       const int* __restrict__ qidx, int nlist, int b, int s,
                       int g, int* __restrict__ order,
                       int* __restrict__ items, int* __restrict__ n_items) {
  constexpr int PER = kBinWindow / kSortThreads;
  __shared__ int cur[kBinWindow];
  __shared__ int sh[64];
  const int tid = threadIdx.x;
  int pair_base = 0, item_base = 0;  // the same in every thread
  for (int w0 = 0; w0 <= nlist; w0 += kBinWindow) {
    for (int i = tid; i < kBinWindow; i += kSortThreads) cur[i] = 0;
    __syncthreads();
    for (int e = tid; e < s; e += kSortThreads) {
      const int bin = pair_bin(probes, qidx, e, nlist, b) - w0;
      if (bin >= 0 && bin < kBinWindow) atomicAdd(&cur[bin], 1);
    }
    __syncthreads();
    int n[PER], np = 0, ni = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      n[j] = cur[tid * PER + j];
      np += n[j];
      ni += (n[j] + g - 1) / g;
    }
    int tp, ti;
    block_scan2(np, ni, sh, tp, ti);
    int pos = pair_base + np, ipos = item_base + ni;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int bin = w0 + tid * PER + j;
      for (int off = 0; off < n[j]; off += g, ++ipos) {
        int* it = items + 3 * (size_t)ipos;
        it[0] = bin < nlist ? bin : -1;
        it[1] = pos + off;
        it[2] = min(g, n[j] - off);
      }
      cur[tid * PER + j] = pos;  // the bin's scatter cursor
      pos += n[j];
    }
    __syncthreads();
    for (int e = tid; e < s; e += kSortThreads) {
      const int bin = pair_bin(probes, qidx, e, nlist, b) - w0;
      if (bin >= 0 && bin < kBinWindow) order[atomicAdd(&cur[bin], 1)] = e;
    }
    pair_base += tp;
    item_base += ti;
    __syncthreads();
  }
  if (tid == 0) {
    n_items[0] = item_base;
    n_items[1] = 0;  // stage 1's unit counter
  }
}

// ---------------------------------------------------------------------
// Stage 1, grouped: bucket-major, whole-wave.

constexpr int kGWarps = 4;      // warps a CTA; each walks units on its own
constexpr int kGStages = 3;     // tiles of a warp's cp.async ring
constexpr int kSlice = 128;     // bytes of a row a tile holds
constexpr int kPitch = kSlice + 16;  // a tile row's stride: lane L reads
                                     // row L, 8 lanes a 16-byte phase hit
                                     // distinct banks
constexpr int kTile = 32 * kPitch;
constexpr int kMaxGroups = 64;  // 32-row groups a part may hold
constexpr int kMaxItem = 8;     // pairs an item may hold
constexpr int kAcc = 4;         // accumulators a pair: interleaved chains

// One warp's shared memory: its ring, the part's group masks, the item's
// queries as float32, pair ids and candidate buffers; 16-byte multiple.
__host__ __device__ inline size_t grouped_warp_bytes(int d, int cap, int g) {
  const size_t n = (size_t)kGStages * kTile + kMaxGroups * 4 +
                   (size_t)g * (12 + 4 * (size_t)d + 8 * (size_t)cap);
  return (n + 15) & ~(size_t)15;
}

// acc[j][ch % kAcc] += chunk ch of a tile row . pair j's query (qc + j d
// at the slice's first element), for GN pairs; FULL: all CH chunks.
template <int TABLE, int CH, int GN, bool FULL>
__device__ __forceinline__ void score_row(const unsigned char* row,
                                          const float* qc, int d, int nch,
                                          float (&acc)[kMaxItem][kAcc]) {
  constexpr int E = TABLE == kF32 ? 4 : 8;  // elements a 16-byte chunk
  uint4 v[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
    if (FULL || ch < nch)
      v[ch] = *reinterpret_cast<const uint4*>(row + ch * 16);
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    if (FULL || ch < nch) {
      const uint32_t w[4] = {v[ch].x, v[ch].y, v[ch].z, v[ch].w};
      float x[E];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if constexpr (TABLE == kBF16) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[h]));
          x[2 * h] = f.x;
          x[2 * h + 1] = f.y;
        } else {
          x[h] = __uint_as_float(w[h]);
        }
      }
#pragma unroll
      for (int j = 0; j < GN; ++j) {
        const float4* qv =
            reinterpret_cast<const float4*>(qc + j * d + ch * E);
        float& a = acc[j][ch % kAcc];
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          const float4 t = qv[h];  // one address for the warp: a broadcast
          a = fmaf(x[4 * h], t.x, a);
          a = fmaf(x[4 * h + 1], t.y, a);
          a = fmaf(x[4 * h + 2], t.z, a);
          a = fmaf(x[4 * h + 3], t.w, a);
        }
      }
    }
  }
}

// score_row with the item's pair count as a compile-time constant.
template <int TABLE, int CH, bool FULL>
__device__ __forceinline__ void score_item(int gn, const unsigned char* row,
                                           const float* qc, int d, int nch,
                                           float (&acc)[kMaxItem][kAcc]) {
  switch (gn) {
    case 1: score_row<TABLE, CH, 1, FULL>(row, qc, d, nch, acc); break;
    case 2: score_row<TABLE, CH, 2, FULL>(row, qc, d, nch, acc); break;
    case 3: score_row<TABLE, CH, 3, FULL>(row, qc, d, nch, acc); break;
    case 4: score_row<TABLE, CH, 4, FULL>(row, qc, d, nch, acc); break;
    case 5: score_row<TABLE, CH, 5, FULL>(row, qc, d, nch, acc); break;
    case 6: score_row<TABLE, CH, 6, FULL>(row, qc, d, nch, acc); break;
    case 7: score_row<TABLE, CH, 7, FULL>(row, qc, d, nch, acc); break;
    default: score_row<TABLE, CH, 8, FULL>(row, qc, d, nch, acc); break;
  }
}

// n_items[0] is the item count from stage 0, n_items[1] the unit counter
// it zeroed: warps claim (item, part) units from it, item-major.
template <int TABLE>
__global__ void __launch_bounds__(kGWarps * 32)
ivf_grouped_partial_kernel(const void* __restrict__ rows,
                           const uint8_t* __restrict__ valid,
                           const int* __restrict__ qidx,
                           const void* __restrict__ q,
                           const int* __restrict__ order,
                           const int* __restrict__ items,
                           int* __restrict__ n_items, int c, int d, int k,
                           int cap, int g, int parts, int part_rows,
                           float* __restrict__ part_v,
                           int* __restrict__ part_i) {
  constexpr int ES = TABLE == kF32 ? 4 : 2;  // bytes per element
  constexpr int CH = kSlice / 16;            // chunks of a tile row
  constexpr int QTYPE = TABLE == kF32 ? kQF32 : kQBF16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* ring = smem + warp * grouped_warp_bytes(d, cap, g);
  unsigned* masks = reinterpret_cast<unsigned*>(ring + kGStages * kTile);
  float* qs = reinterpret_cast<float*>(masks + kMaxGroups);  // [g][d]
  int* pid = reinterpret_cast<int*>(qs + (size_t)g * d);
  int* cnt = pid + g;
  float* thr = reinterpret_cast<float*>(cnt + g);
  float* sv = thr + g;                                    // [g][cap]
  int* si = reinterpret_cast<int*>(sv + (size_t)g * cap);  // [g][cap]
  const int row_bytes = d * ES;
  const int nsl = (row_bytes + kSlice - 1) / kSlice;  // tiles a row group
  const int units = n_items[0] * parts;
  // The next unit's item, pair ids and first 8 groups' validity bytes
  // (pre_*) load while the current unit streams, so that a unit starts
  // with its first copies rather than a chain of dependent loads.
  int pre_bucket = -1, pre_start = 0, pre_gn = 0, pre_pid = 0;
  uint8_t pre_v[8];
  auto fetch_item = [&](int un) {
    const int* it = items + 3 * (un / parts);
    pre_bucket = it[0];
    pre_start = it[1];
    pre_gn = it[2];
  };
  auto fetch_rest = [&](int un) {  // once fetch_item's loads are back
    const int r_lo = (un % parts) * part_rows;
    const int r_hi = min(c, r_lo + part_rows);
    pre_pid = lane < pre_gn ? order[pre_start + lane] : 0;
    const uint8_t* vb = valid + (size_t)max(pre_bucket, 0) * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = r_lo + j * 32 + lane;
      pre_v[j] = pre_bucket >= 0 && r < r_hi ? vb[r] : 0;
    }
  };
  // lane 0 claims a unit; the answer is read where it is needed
  auto claim = [&]() { return lane == 0 ? atomicAdd(n_items + 1, 1) : 0; };
  int u = __shfl_sync(kFull, claim(), 0);
  if (u < units) {
    fetch_item(u);
    fetch_rest(u);
  }
  while (u < units) {
    const int claimed = claim();
    const int part = u % parts;
    const int bucket = pre_bucket, gn = pre_gn;
    if (lane < gn) {
      pid[lane] = pre_pid;
      cnt[lane] = 0;
      thr[lane] = -INFINITY;
    }
    const int r_lo = part * part_rows;
    const int r_hi = min(c, r_lo + part_rows);
    const int ng = (r_hi - r_lo + 31) / 32;
    if (bucket >= 0) {
      // the part's group masks: eight from pre_v, the rest loaded now
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned m = __ballot_sync(kFull, pre_v[j] != 0);
        if (lane == 0 && j < ng) masks[j] = m;
      }
      for (int g0 = 8; g0 < ng; g0 += 8) {
        uint8_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r_lo + (g0 + j) * 32 + lane;
          v[j] = r < r_hi ? valid[(size_t)bucket * c + r] : 0;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned m = __ballot_sync(kFull, v[j] != 0);
          if (lane == 0 && g0 + j < ng) masks[g0 + j] = m;
        }
      }
    }
    __syncwarp();
    int u_next = units;
    if (bucket >= 0) {
      const char* tb = static_cast<const char*>(rows) +
                       (size_t)bucket * c * row_bytes;
      auto next_live = [&](int gi) {
        while (gi < ng && masks[gi] == 0) ++gi;
        return gi;
      };
      // producer: the next tile to copy (group pg, slice ps, ring slot pst)
      int pg = next_live(0), ps = 0, pst = 0;
      auto issue = [&]() {
        if (pg < ng) {
          const unsigned m = masks[pg];
          const char* src = tb + (size_t)(r_lo + pg * 32) * row_bytes +
                            ps * kSlice;
          const int nch = min(kSlice, row_bytes - ps * kSlice) / 16;
          unsigned char* st = ring + pst * kTile;
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            const int chunk = j * 32 + lane;  // CH lanes a row's slice
            const int r = chunk / CH, col = chunk % CH;
            const bool in = ((m >> r) & 1u) && col < nch;
            cp_async16(st + r * kPitch + col * 16,
                       in ? src + (size_t)r * row_bytes + col * 16 : tb, in);
          }
          if (++ps == nsl) {
            ps = 0;
            pg = next_live(pg + 1);
          }
          pst = pst + 1 == kGStages ? 0 : pst + 1;
        }
        cp_async_commit();  // an empty group keeps the wait count uniform
      };
#pragma unroll
      for (int j = 0; j < kGStages - 1; ++j) issue();
      u_next = __shfl_sync(kFull, claimed, 0);
      if (u_next < units) fetch_item(u_next);
      // the item's queries, while the first tiles are in flight
      for (int j = 0; j < gn; ++j) {
        const size_t qrow = (size_t)qidx[pid[j]] * d;
        for (int e = lane; e < d; e += 32)
          qs[j * d + e] = load_q<QTYPE>(q, qrow + e);
      }
      float acc[kMaxItem][kAcc];
#pragma unroll
      for (int j = 0; j < kMaxItem; ++j)
#pragma unroll
        for (int h = 0; h < kAcc; ++h) acc[j][h] = 0.f;
      int cg = next_live(0), cs = 0, cst = 0;  // consumer
      while (cg < ng) {
        issue();
        cp_async_wait<kGStages - 1>();
        __syncwarp();
        const unsigned char* st = ring + cst * kTile + lane * kPitch;
        const int nch = min(kSlice, row_bytes - cs * kSlice) / 16;
        const float* qc = qs + cs * (kSlice / ES);
        if (nch == CH)
          score_item<TABLE, CH, true>(gn, st, qc, d, nch, acc);
        else
          score_item<TABLE, CH, false>(gn, st, qc, d, nch, acc);
        __syncwarp();  // the slot is free for the next issue
        cst = cst + 1 == kGStages ? 0 : cst + 1;
        if (++cs == nsl) {
          const bool live = (masks[cg] >> lane) & 1u;
          const int r = r_lo + cg * 32 + lane;
#pragma unroll
          for (int j = 0; j < kMaxItem; ++j) {
            if (j < gn) {  // warp-uniform
              const Sel s{sv + j * cap, si + j * cap, cnt + j, thr + j,
                          nullptr};
              const float t =
                  (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
              sel_offer<true>(s, live ? t : -INFINITY, r, k, cap, lane);
            }
#pragma unroll
            for (int h = 0; h < kAcc; ++h) acc[j][h] = 0.f;
          }
          cs = 0;
          cg = next_live(cg + 1);
        }
      }
    } else {
      u_next = __shfl_sync(kFull, claimed, 0);
      if (u_next < units) fetch_item(u_next);
    }
    if (u_next < units) fetch_rest(u_next);
    cp_async_wait<0>();
    for (int j = 0; j < gn; ++j) {
      const Sel s{sv + j * cap, si + j * cap, cnt + j, thr + j, nullptr};
      sel_cut(s, k, lane);
      const int have_n = *s.count;
      const size_t out = ((size_t)pid[j] * parts + part) * k;
      for (int e = lane; e < k; e += 32) {
        const bool have = e < have_n;
        part_v[out + e] = have ? s.v[e] : -INFINITY;
        part_i[out + e] = have ? s.i[e] : -1;
      }
    }
    __syncwarp();  // pid, masks and buffers are rewritten by the next unit
    u = u_next;
  }
}

// The grouped body's resident CTA count on the current card (its grid),
// with the kernel's shared-memory limit and carveout set.
template <int TABLE>
cudaError_t grouped_ctas(int d, int cap, int g, int* ctas) {
  const size_t smem = kGWarps * grouped_warp_bytes(d, cap, g);
  auto kern = ivf_grouped_partial_kernel<TABLE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kGWarps * 32, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  return err;
}

template <int TABLE>
cudaError_t launch_grouped(const void* rows, const void* valid,
                           const void* qidx, const void* q, const void* order,
                           const void* items, void* n_items, int c, int d,
                           int k, int cap, int g, int parts, int part_rows,
                           void* part_v, void* part_i, cudaStream_t stream) {
  int ctas = 0;
  cudaError_t err = grouped_ctas<TABLE>(d, cap, g, &ctas);
  if (err != cudaSuccess) return err;
  ivf_grouped_partial_kernel<TABLE>
      <<<ctas, kGWarps * 32, kGWarps * grouped_warp_bytes(d, cap, g),
         stream>>>(rows, static_cast<const uint8_t*>(valid),
                   static_cast<const int*>(qidx), q,
                   static_cast<const int*>(order),
                   static_cast<const int*>(items),
                   static_cast<int*>(n_items), c, d, k, cap, g, parts,
                   part_rows, static_cast<float*>(part_v),
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

// Stage 0: pair ids by bucket (order (s,)), items (s, 3) int32 of (bucket
// or -1, first position in order, pair count <= g), the item count and a
// zeroed unit counter (n_items, two int32), all on the card. One CTA.
int wdbx_ivf_group_pairs(const void* probes, const void* qidx, int nlist,
                         int b, int s, int g, void* order, void* items,
                         void* n_items, void* stream) {
  if (nlist < 1 || nlist == 0x7fffffff || b < 1 || s < 1 || g < 1 ||
      g > kMaxItem)
    return (int)cudaErrorInvalidValue;
  ivf_group_pairs_kernel<<<1, kSortThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(probes), static_cast<const int*>(qidx), nlist,
      b, s, g, static_cast<int*>(order), static_cast<int*>(items),
      static_cast<int*>(n_items));
  return (int)cudaGetLastError();
}

// Warps of the grouped body resident at once on the current card (its
// grid times kGWarps); 0 when the arguments do not fit.
int wdbx_ivf_grouped_warps(int table, int d, int cap, int g) {
  int ctas = 0;
  if (d < 1 || cap < 1 || g < 1 || g > kMaxItem ||
      kGWarps * grouped_warp_bytes(d, cap, g) > 227 * 1024)
    return 0;
  const cudaError_t err = table == kF32  ? grouped_ctas<kF32>(d, cap, g, &ctas)
                          : table == kBF16 ? grouped_ctas<kBF16>(d, cap, g, &ctas)
                                           : cudaErrorInvalidValue;
  return err == cudaSuccess ? ctas * kGWarps : 0;
}

// Stages 0 and 1 of the grouped body, launched in turn: workspace holds
// 4 s + 2 int32 (order, items, item count and unit counter). g pairs an
// item at most; part j of a bucket is its rows [j * part_rows, (j + 1) *
// part_rows), whole 32-row groups, at most kMaxGroups. Rows must be whole
// 16-byte chunks and the table 16-byte aligned. part_v (s, parts, k)
// float32, part_i the same shape in int32 bucket-local positions.
int wdbx_ivf_grouped_scan(int table, const void* rows, const void* valid,
                          const void* probes, const void* qidx, const void* q,
                          int nlist, int c, int d, int b, int s, int k,
                          int cap, int g, int parts, int part_rows,
                          void* workspace, void* part_v, void* part_i,
                          void* stream) {
  const int es = table == kF32 ? 4 : 2;
  if ((table != kF32 && table != kBF16) || k < 1 || cap < k + 32 || c < 1 ||
      d < 1 || (d * es) % 16 != 0 || !aligned16(rows) || g < 1 ||
      g > kMaxItem || parts < 1 || part_rows < 32 || part_rows % 32 != 0 ||
      part_rows > 32 * kMaxGroups || (long long)parts * part_rows < c ||
      (long long)(parts - 1) * part_rows >= c ||
      kGWarps * grouped_warp_bytes(d, cap, g) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  int* order = static_cast<int*>(workspace);
  int* items = order + s;
  int* n_items = items + 3 * (size_t)s;
  const int rc = wdbx_ivf_group_pairs(probes, qidx, nlist, b, s, g, order,
                                      items, n_items, stream);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(table == kF32
                   ? launch_grouped<kF32>(rows, valid, qidx, q, order, items,
                                          n_items, c, d, k, cap, g, parts,
                                          part_rows, part_v, part_i, st)
                   : launch_grouped<kBF16>(rows, valid, qidx, q, order, items,
                                           n_items, c, d, k, cap, g, parts,
                                           part_rows, part_v, part_i, st));
}

}  // extern "C"
