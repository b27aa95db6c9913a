// K1's stage 1 over bf16 slabs as a Hopper body (sm_90a), CUDA C++: the
// `wgmma` body of fused_topk_partial (body code 4).
//
// Replaces, for the launches the shape rule gives it, the bf16-slab case of
// the Pallas body `_kernel` of wdbx_tpu/kernels/fused_topk.py:153, which
// scan_mma_pipe (topk_common.cuh) served before. Function: stage 1 of
// fused_topk.cu: for bf16 queries q (B, d) and a bf16 slab (N, d), each
// part's k best q . row over the rows of its chunk whose validity byte is
// non-zero, bf16 products summed in float32, unsorted, -inf / -1 pads.
// Stage 2 (topk_merge_partials) merges the parts as before.
//
// Bound on an H100 (3.35 TB/s HBM, 989 TFLOP/s of dense bf16): the slab
// read. At 10M x 768 a launch moves 15.36 GB, 4.59 ms; its products at
// B = 128 are 1.97 TFLOP, 2.0 ms at the dense peak, and only wgmma reaches
// that rate. At 1M x 384 the bytes are 0.24 ms.
//
// Design:
//  * a cluster of two CTAs on neighbouring SMs walks one contiguous chunk
//    of rows for one tile of 128 queries; CTA r keeps queries
//    [64 r, 64 r + 64) of the tile resident in shared memory (64 x d bf16,
//    loaded once by TMA with the 128-byte swizzle: 96 KB at d = 768);
//  * the chunk streams as slices of 128 rows x 64 dims (16 KB, one
//    128-byte swizzle row a row) through a ring of up to 8 stages. Each
//    CTA's producer thread loads 64 rows of a slice by TMA multicast into
//    the same stage of both CTAs' rings, so every slab byte crosses HBM
//    once a launch for all 128 queries. A stage's `full` mbarrier counts
//    its bytes; its `empty` mbarrier the release by the consuming
//    warpgroup of each CTA (both CTAs' producers write into it);
//  * two consumer warpgroups take alternate 128-row tiles. Each runs
//    wgmma m64n128k16 bf16 -> f32 with A the resident queries and B the
//    slice (both K-major in shared memory), the 64 x 128 accumulator in 64
//    registers a thread. An mbarrier pair orders their product phases
//    (warpgroup w starts tile t's products once the other has finished
//    tile t - 1's), so while one selects from its accumulator the other's
//    products run, and a stage's phases are awaited in order;
//  * selection is scan_mma_pipe's register top-k (topk_common.cuh,
//    reg_offer) as it is: a warp's wgmma accumulator is laid out as
//    mma.sync m16n8's, so the quad of 4 lanes holds one query's 128 scores
//    of the tile, keeps its top k in kPipeKQ slots a lane with the quad's
//    minimum as the threshold, and casts one vote a tile when nothing
//    survives. The validity mask is applied before the compare; rows past
//    the chunk or the slab are invalid;
//  * each consumer warpgroup writes its own partials: 2 parts a query a
//    cluster chunk, (B, 2 chunks, k).
// The same inputs give the same slots on every run: tiles go to fixed
// warpgroups and survivors enter in a fixed order.
//
// Shape rule (fused_topk.scan_body given k): bf16 slab and bf16 queries,
// d % 64 == 0, 64 queries of width d fit the 96 KB of resident queries
// (d <= 768), 16-byte aligned slab and queries, k <= 4 kPipeKQ = 32. The
// entry point refuses other launches. fused_topk.pick_body takes it for
// batches of more than 64 queries, which fill both CTAs of a pair: below
// that scan_mma_pipe's smaller query tiles spread the selection over more
// warps and ran as fast or faster.

#include <cuda.h>  // CUtensorMap; the driver's encoder is fetched at run time

#include "topk_common.cuh"

namespace {

constexpr int kWgThreads = 128;             // a warpgroup
constexpr int kWgmmaThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kWgRows = 128;                // rows a tile
constexpr int kWgDims = 64;                 // dims a slice (128 bytes)
constexpr int kWgQueries = 64;              // resident queries a CTA
constexpr int kSliceBytes = kWgRows * kWgDims * 2;        // 16 KB
constexpr int kHalfBytes = kSliceBytes / 2;               // a CTA's load
constexpr int kQAtomBytes = kWgQueries * kWgDims * 2;     // 8 KB
constexpr int kWgMaxStages = 8;
constexpr int kWgMaxD = 768;
constexpr int kWgKQ = kPipeKQ;              // register top-k: k <= 32
constexpr size_t kBlockSmemMax = 232448;    // a CTA's opt-in shared memory
constexpr size_t kWgBarBytes = 256;         // the mbarriers
constexpr size_t kWgValidBytes = 2 * 2 * kWgRows;  // [warpgroup][tile parity]

__host__ __device__ inline size_t wg_fixed_bytes(int d) {
  return 1024 /* alignment */ + (size_t)kWgQueries * d * 2 + kWgBarBytes +
         kWgValidBytes;
}

__host__ __device__ inline int wg_stages(int d) {
  const size_t s = (kBlockSmemMax - wg_fixed_bytes(d)) / kSliceBytes;
  return s < (size_t)kWgMaxStages ? (int)s : kWgMaxStages;
}

size_t wg_smem_bytes(int d) {
  return wg_fixed_bytes(d) + (size_t)wg_stages(d) * kSliceBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive on the mbarrier at offset `bar` of CTA `cta` of the cluster when
// `pred` holds. The predicate stays inside the asm, so the consumers'
// products never follow a branch the compiler takes for divergent.
__device__ __forceinline__ void mbar_arrive_cta(uint32_t bar, uint32_t cta,
                                                bool pred) {
  asm volatile(
      "{\n.reg .b32 ra;\n.reg .pred p;\n"
      "setp.ne.u32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta), "r"((uint32_t)pred)
      : "memory");
}

// The spin stays inside the asm: a loop the compiler sees would make the
// wgmma after it look divergent, and ptxas then serialises the products.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// The box lands at offset `dst` of every CTA in `mask` and completes its
// bytes on the mbarrier at offset `bar` of each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int x, int y,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(x),
      "r"(y)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWgThreads) : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle
// rows (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void acc_fence(float (&c)[16][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[n][e])::"memory");
}

// c (64 queries x 128 rows, float32) += A (64 x 16 bf16) . B (16 x 128
// bf16), or = with scale_d 0.
__device__ __forceinline__ void wgmma_128(float (&c)[16][4], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3]),
        "+f"(c[8][0]), "+f"(c[8][1]), "+f"(c[8][2]), "+f"(c[8][3]),
        "+f"(c[9][0]), "+f"(c[9][1]), "+f"(c[9][2]), "+f"(c[9][3]),
        "+f"(c[10][0]), "+f"(c[10][1]), "+f"(c[10][2]), "+f"(c[10][3]),
        "+f"(c[11][0]), "+f"(c[11][1]), "+f"(c[11][2]), "+f"(c[11][3]),
        "+f"(c[12][0]), "+f"(c[12][1]), "+f"(c[12][2]), "+f"(c[12][3]),
        "+f"(c[13][0]), "+f"(c[13][1]), "+f"(c[13][2]), "+f"(c[13][3]),
        "+f"(c[14][0]), "+f"(c[14][1]), "+f"(c[14][2]), "+f"(c[14][3]),
        "+f"(c[15][0]), "+f"(c[15][1]), "+f"(c[15][2]), "+f"(c[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// grid (2 chunks, query tiles of 128), clusters of the two CTAs of a chunk.
// Warpgroup 0 is the producer (one thread issues every copy), 1 and 2 the
// consumers.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kWgmmaThreads, 1)
fused_topk_pipe_kernel_sm90(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap qmap,
                            const uint8_t* __restrict__ valid, int n, int d,
                            int b, int k, int rows_per_chunk, int stages,
                            float* __restrict__ part_v,
                            int* __restrict__ part_i) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int slices = d / kWgDims;
  unsigned char* const Qs = smem;  // [slices][64 queries][128 bytes]
  unsigned char* const ring = Qs + (size_t)kWgQueries * d * 2;
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      ring + (size_t)stages * kSliceBytes);
  uint64_t* const empty = full + stages;
  uint64_t* const qbar = empty + stages;
  uint64_t* const order = qbar + 1;  // [2]: warpgroup w's turn to multiply
  unsigned char* const vbuf =
      reinterpret_cast<unsigned char*>(full) + kWgBarBytes;

  // the warpgroup, warp-uniform as the compiler sees it (a wgmma in a
  // branch it takes for divergent is serialised)
  const int tid = threadIdx.x, wg = __shfl_sync(kFull, tid / kWgThreads, 0);
  const uint32_t rank = cluster_rank();
  const int chunk = blockIdx.x / 2;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(n, row_begin + rows_per_chunk);
  const int ntiles = (row_end - row_begin + kWgRows - 1) / kWgRows;
  const int q_cta = blockIdx.y * 2 * kWgQueries + (int)rank * kWgQueries;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 2);  // a consumer of each CTA
    }
    mbar_init(smem_u32(qbar), 1);
    mbar_init(smem_u32(order), 1);
    mbar_init(smem_u32(order + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    if (tid == 0) {
      // the resident queries (none past the batch: a CTA without queries
      // scores what its shared memory holds and offers nothing)
      const uint32_t qb = smem_u32(qbar);
      if (q_cta < b) {
        mbar_expect_tx(qb, (uint32_t)kWgQueries * d * 2);
        for (int a = 0; a < slices; ++a)
          tma_load(smem_u32(Qs + a * kQAtomBytes), &qmap, qb, a * kWgDims,
                   q_cta);
      } else {
        mbar_arrive(qb);
      }
      // slice c = (tile, dims): this CTA's 64 rows into both CTAs; a half
      // wholly past the slab is not loaded (its rows are masked)
      const int total = ntiles * slices;
      for (int c = 0; c < total; ++c) {
        const int s = c % stages, tt = c / slices, j = c - tt * slices;
        mbar_wait(smem_u32(empty + s), ((c / stages) & 1) ^ 1);
        const int r0 = row_begin + tt * kWgRows;
        const int halves = (r0 < n) + (r0 + kWgRows / 2 < n);
        const uint32_t fb = smem_u32(full + s);
        mbar_expect_tx(fb, (uint32_t)halves * kHalfBytes);
        const int mine = r0 + (int)rank * (kWgRows / 2);
        if (mine < n)
          tma_load_multicast(
              smem_u32(ring + (size_t)s * kSliceBytes + rank * kHalfBytes),
              &xmap, fb, j * kWgDims, mine, 0x3);
      }
    }
  } else {
    const int w = wg - 1, wt = tid - wg * kWgThreads;
    const int lane = tid & 31, t = lane & 3, g = lane >> 2;
    const int qg0 = q_cta + (wt >> 5) * 16 + g, qg1 = qg0 + 8;
    float tv[2][kWgKQ];
    int ti[2][kWgKQ];
    float qthr[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kWgKQ; ++j) {
        tv[h][j] = 4 * j + t < k ? -INFINITY : INFINITY;
        ti[h][j] = -1;
      }
    float acc[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const uint64_t dq = sw128_desc(smem_u32(Qs));
    const uint64_t dx = sw128_desc(smem_u32(ring));
    // the consuming warpgroup releases stage s to both CTAs' producers
    auto release = [&](int c) {
      const uint32_t eb = smem_u32(empty + c % stages);
      mbar_arrive_cta(eb, 0, wt == 0);
      mbar_arrive_cta(eb, 1, wt == 0);
    };
    mbar_wait(smem_u32(qbar), 0);
    int par = 0;
    for (int tt = w; tt < ntiles; tt += 2, par ^= 1) {
      const int r0 = row_begin + tt * kWgRows;
      const uint8_t ok =
          r0 + wt < row_end ? __ldg(valid + r0 + wt) : (uint8_t)0;
      // the other warpgroup has finished tile tt - 1's products
      if (tt > 0) mbar_wait(smem_u32(order + w), ((tt - 1) >> 1) & 1);
      acc_fence(acc);
      wgmma_fence();
      for (int j = 0; j < slices; ++j) {
        const int c = tt * slices + j, s = c % stages;
        mbar_wait(smem_u32(full + s), (c / stages) & 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_128(acc, dq + ((j * kQAtomBytes + kk * 32) >> 4),
                    dx + ((s * kSliceBytes + kk * 32) >> 4), (j | kk) != 0);
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();
          release(c - 1);
        }
      }
      wgmma_wait<0>();
      acc_fence(acc);
      release(tt * slices + slices - 1);
      mbar_arrive_cta(smem_u32(order + (1 - w)), rank, wt == 0);

      // tile done: mask, compare with the thresholds, insert survivors
      unsigned char* const vb = vbuf + (w * 2 + par) * kWgRows;
      vb[wt] = ok != 0;
      wg_bar(1 + w);
      const float thr0 = qg0 < b ? qthr[0] : INFINITY;
      const float thr1 = qg1 < b ? qthr[1] : INFINITY;
      unsigned bits0 = 0, bits1 = 0;
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
        const unsigned pair =
            *reinterpret_cast<const unsigned short*>(vb + 8 * n8 + 2 * t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool in = (pair >> (8 * j)) & 0xffu;
          if (in && acc[n8][j] > thr0) bits0 |= 1u << (2 * n8 + j);
          if (in && acc[n8][2 + j] > thr1) bits1 |= 1u << (2 * n8 + j);
        }
      }
      if (__any_sync(kFull, (bits0 | bits1) != 0u))
        reg_offer(acc, bits0, bits1, tv, ti, qthr, r0 + 2 * t, lane);
    }
    // this warpgroup's part of its queries: part 2 chunk + w of gridDim.x
    const int part = chunk * 2 + w, nparts = gridDim.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qg = h ? qg1 : qg0;
      if (qg >= b) continue;
      const size_t base = ((size_t)qg * nparts + part) * k;
#pragma unroll
      for (int j = 0; j < kWgKQ; ++j) {
        const int e = 4 * j + t;
        if (e < k) {
          part_v[base + e] = tv[h][j];
          part_i[base + e] = ti[h][j];
        }
      }
    }
  }
  __syncwarp();
  // no CTA leaves while the other may still write into it or arrive on it
  cluster_sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, d) bf16 row-major tensor as boxes of 64 rows x 64 dims in
// 128-byte swizzle rows; boxes past the last row are filled with zeros.
bool bf16_rows_map(CUtensorMap* map, const void* base, int rows, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kWgDims, (cuuint32_t)kWgQueries};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t set_smem(int d) {
  return cudaFuncSetAttribute(fused_topk_pipe_kernel_sm90,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)wg_smem_bytes(d));
}

}  // namespace

// Clusters of two CTAs the card runs at once at width d (-1 on error).
int fused_topk_wgmma_clusters(int d) {
  if (d < kWgDims || d % kWgDims != 0 || d > kWgMaxD) return -1;
  if (set_smem(d) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(kWgmmaThreads, 1, 1);
  cfg.dynamicSmemBytes = wg_smem_bytes(d);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(
          &clusters, (void*)fused_topk_pipe_kernel_sm90, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// Stage 1 by the wgmma body: grid (2 chunks, ceil(b / 128)); part_v
// (b, 2 chunks, k) float32 and part_i int32. The launch's rule: bf16 slab
// and queries (the caller's types), d % 64 == 0, d <= 768, 16-byte aligned
// slab and queries, 1 <= k <= 32, rows_per_chunk a multiple of 128.
int fused_topk_wgmma(const void* db, const void* q, const void* valid, int n,
                     int d, int b, int k, int rows_per_chunk, int chunks,
                     void* part_v, void* part_i, cudaStream_t stream) {
  if (d < kWgDims || d % kWgDims != 0 || d > kWgMaxD || k < 1 ||
      k > 4 * kWgKQ || !aligned16(db) || !aligned16(q) || n < 1 || b < 1 ||
      chunks < 1 || rows_per_chunk % kWgRows != 0 ||
      (long long)rows_per_chunk * (chunks - 1) >= n ||
      (b + 2 * kWgQueries - 1) / (2 * kWgQueries) > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  if (!bf16_rows_map(&xmap, db, n, d) || !bf16_rows_map(&qmap, q, b, d))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(d);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2 * chunks, (b + 2 * kWgQueries - 1) / (2 * kWgQueries));
  fused_topk_pipe_kernel_sm90<<<grid, kWgmmaThreads, wg_smem_bytes(d),
                                stream>>>(
      xmap, qmap, static_cast<const uint8_t*>(valid), n, d, b, k,
      rows_per_chunk, wg_stages(d), static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  return (int)cudaGetLastError();
}
