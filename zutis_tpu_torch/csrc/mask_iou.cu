// Pairwise IoU of binary masks for Hopper (sm_90a), behind a plain C
// interface: the exact intersection counts as an s8 x s8 -> s32 product on
// wgmma, the masks read once from device memory as the bytes they are.
//
// Replaces the IoU product of zutis_tpu/ops/nms.py::mask_nms (:46-51): the
// JAX package casts the [Q, H, W] masks to int8 and contracts them with
// themselves in a dot_general into int32 (XLA's product on the MXU, not a
// Pallas kernel), then runs the IoU in f32. The port's plain version
// (ops/nms.py::pairwise_iou_reference) sums the same counts exactly in a
// float64 bmm. This kernel computes the counts as JAX does and the IoU with
// the plain version's f32 operations in its order: inter and the areas (the
// diagonal) converted from int32 rounding to nearest, union = (a_i + a_j) -
// inter, iou = union > 0 ? inter / max(union, 1e-12) : 0, with IEEE division
// (the library is built without fast math).
//
// Bound: bytes. At the bucketed eval's [32, 100, 512 x 640] the masks are
// 1.05 GB, 0.313 ms at 3.35 TB/s; the product is 2 b Q^2 K = 2.1e14 int8
// operations, 0.106 ms at 1,979 TOP/s. So every mask byte is read from
// device memory once, and the tensor cores have time to spare.
//
// Design:
//   - A tile is 128 mask rows x 128 bytes of K, loaded with the 128-byte
//     swizzle. One tile feeds both operands of its product with itself:
//     consumer warpgroup w takes rows 64w..64w+63 as A (m64) against the
//     whole tile as B (N = 128, which covers Q = 100; rows past Q are
//     zeros), four k32 steps of 32 bytes a tile, the s32 sums in registers
//     (64 a thread). Both operands are K-major, as the masks' rows are, so
//     no transpose is needed. For Q > 128 the [Q, Q] output is cut into
//     128 x 128 tiles and only the pairs (ti <= tj) are computed: a pair's
//     stage holds its row tile and its column tile, and an off-diagonal
//     pair adds its counts to (i, j) and (j, i).
//   - A unit is a stage's work: 4 tiles along K, 512 contiguous bytes of
//     each row, so that device memory serves runs longer than a 128-byte
//     line a row (at eval 0.354-0.356 ms against 0.371 with one tile:
//     tools/selection_bench.py's iou_one_box on an H100 80GB HBM3 at 700
//     W); with tile pairs a row and a column tile, so that the ring still
//     holds 6 stages.
//   - The work is the list of (image, pair, K step) units, and
//     each block takes an equal run of it, one block an SM in one wave:
//     32 images give too few output tiles for 132 SMs, so K is split across
//     blocks, and a run may end or begin inside an image. At the end of each
//     (image, pair) stretch of its run a block adds its nonzero sums to a
//     zeroed int32 count buffer with integer atomics: exact, and the same
//     sums in any order, so the result is the same in every run. A consumer
//     warpgroup waits for each unit's product before it releases the
//     stage, so that no wgmma is issued or awaited on a path that only
//     some runs take (ptxas serialises them there); it has time to spare,
//     at about half the tensor cores' rate for the memory's.
//   - Then iou_kernel, one thread an element, turns the complete counts
//     into the IoU and the areas.
//   - Loads: a loading warpgroup feeds a ring of 192 KB (12 stages of one
//     tile, or 6 of two) on full / empty mbarriers. Where K and the masks'
//     address are multiples of 16 bytes, one thread issues TMA loads of a
//     rank-3 [b, Q, K] map (a box of [128 rows, 128 bytes]; rows past Q and
//     bytes past K arrive as zeros, never the next image's rows). Else (the
//     per-image decode's image sizes such as 375 x 500 = 187,500 bytes a
//     row, which TMA's 16-byte strides refuse) the four warps load the
//     rows themselves, a row a warp at a time as 32 words, realigned with
//     funnel shifts and stored swizzled: no padded copy of the masks.
//
// Launches: a call is three on the stream: the wrapper's fill that zeroes
// the count buffer (b Q^2 int32), mask_counts_kernel and iou_kernel.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxQ = 1024;
constexpr int kRows = 128;                     // rows of a tile: two m64 A tiles, the N of B
constexpr int kTileK = 128;                    // bytes of K a tile: a row of the 128-byte swizzle
constexpr int kTileBytes = kRows * kTileK;     // 16 KB
constexpr int kSteps = kTileK / 32;            // k32 steps of a tile
constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;     // and a loading warpgroup
constexpr int kRingBytes = 12 * kTileBytes;    // 192 KB
constexpr int kMaxStages = kRingBytes / kTileBytes;
constexpr int kBarBytes = 2 * kMaxStages * 8;  // full and empty mbarriers
constexpr int kSmemBytes = kRingBytes + kBarBytes;
constexpr int kIouThreads = 256;               // iou_kernel's block

// Tiles a stage holds along K (see the note).
__host__ __device__ constexpr int boxes(bool pairs) { return pairs ? 1 : 4; }
__host__ __device__ constexpr int unit_k(bool pairs) { return boxes(pairs) * kTileK; }
__host__ __device__ constexpr int stage_bytes(bool pairs) { return (pairs ? 2 : 1) * boxes(pairs) * kTileBytes; }
__host__ __device__ constexpr int stages(bool pairs) { return kRingBytes / stage_bytes(pairs); }

struct Params {
  const unsigned char* masks;  // [b, Q, K] 0 / 1 bytes
  int* counts;                 // [b, Q, Q] int32, zeroed
  long long k;
  long long k_tiles;    // units of K: unit_k bytes each
  long long total;      // units: b * pairs * k_tiles
  long long per_block;  // units a block
  int b, q, tiles;
};

// A unit: image n, the output tile pair (ti, tj) with ti <= tj, and the K
// step kt; units run kt fastest, then the pairs row by row, then images.
struct Cursor {
  long long kt;
  int n, ti, tj;

  __device__ Cursor(const Params& p, long long u) {
    kt = u % p.k_tiles;
    long long rest = u / p.k_tiles;
    const int pairs = p.tiles * (p.tiles + 1) / 2;
    int pair = static_cast<int>(rest % pairs);
    n = static_cast<int>(rest / pairs);
    ti = 0;
    while (pair >= p.tiles - ti) {
      pair -= p.tiles - ti;
      ++ti;
    }
    tj = ti + pair;
  }
  __device__ void advance(const Params& p) {
    if (++kt < p.k_tiles) return;
    kt = 0;
    if (++tj < p.tiles) return;
    if (++ti == p.tiles) {
      ti = 0;
      ++n;
    }
    tj = ti;
  }
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) { return bars + 8 * (kMaxStages + s); }

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A K-major operand of a tile: rows of 128 bytes with the 128-byte swizzle,
// 8-row groups 1 KB apart; a k32 step adds its 32 bytes to the address.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) { return smem_desc(addr, 16, 8 * kTileK, kSwizzle128B); }

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 operands both K-major from
// shared memory, s32 sums; scale_d 0 overwrites D. The accumulators follow
// the f32 layout (hopper.cuh's conventions).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[16][4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void fence_sums(int (&d)[16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
  }
}

// The loading thread's TMA loads of the block's units [u0, u1).
template <bool kPairs>
__device__ void load_tma(const CUtensorMap* map, const Params& p, uint32_t ring, uint32_t bars, long long u0,
                         long long u1) {
  constexpr int S = stages(kPairs);
  Cursor c(p, u0);
  for (long long i = 0; i < u1 - u0; ++i, c.advance(p)) {
    const int s = static_cast<int>(i % S);
    if (i >= S) mbar_wait(empty_bar(bars, s), static_cast<uint32_t>((i / S - 1) & 1));
    const uint32_t tile = ring + s * stage_bytes(kPairs);
    const bool two = kPairs && c.ti != c.tj;
    constexpr int B = boxes(kPairs);
    mbar_arrive_expect_tx(full_bar(bars, s), (two ? 2 : 1) * B * kTileBytes);
#pragma unroll
    for (int x = 0; x < B; ++x) {
      const int k0 = static_cast<int>(c.kt * unit_k(kPairs) + x * kTileK);
      tma_load_4d(tile + x * kTileBytes, map, full_bar(bars, s), k0, c.ti * kRows, c.n, 0);
      if (two) tma_load_4d(tile + (B + x) * kTileBytes, map, full_bar(bars, s), k0, c.tj * kRows, c.n, 0);
    }
  }
}

// One tile (rows t_row0.. of image n, the kt-th 128 bytes of K) by the
// loading warpgroup's own loads: warp w stores rows 32w..32w+31, each as 32 words of 4 bytes (a
// lane each, neighbouring lanes on neighbouring words), realigned by a
// funnel shift with the next lane's word where the row does not start on a
// word; bytes past K and rows past Q are zeros.
__device__ __forceinline__ void load_tile_rows(const Params& p, uint32_t tile, int n, int t_row0, long long kt,
                                               uintptr_t end) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const long long k = kt * kTileK + 4 * lane;  // this lane's first byte of each row
  uint32_t lo[32], hi[32];
#pragma unroll
  for (int rr = 0; rr < 32; ++rr) {
    const int row = t_row0 + warp * 32 + rr;
    lo[rr] = hi[rr] = 0;
    if (row < p.q) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(p.masks + (static_cast<long long>(n) * p.q + row) * p.k + k);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
      if (reinterpret_cast<uintptr_t>(w) < end) lo[rr] = w[0];
      if (lane == 31 && reinterpret_cast<uintptr_t>(w + 1) < end) hi[rr] = w[1];
    }
  }
  const long long left = p.k - k;  // valid bytes of the row from this lane's first
  const uint32_t keep = left >= 4 ? 0xffffffffu : (left <= 0 ? 0u : (1u << (8 * left)) - 1);
#pragma unroll
  for (int rr = 0; rr < 32; ++rr) {
    const int r = warp * 32 + rr;  // row in the tile
    const uint32_t next = __shfl_down_sync(0xffffffffu, lo[rr], 1);
    const uint32_t shift =
        8u * static_cast<uint32_t>((reinterpret_cast<uintptr_t>(p.masks) +
                                    (static_cast<long long>(n) * p.q + t_row0 + r) * p.k + kt * kTileK) & 3);
    const uint32_t v = __funnelshift_r(lo[rr], lane == 31 ? hi[rr] : next, shift) & keep;
    st_shared_u32(tile + r * kTileK + ((((lane >> 2) ^ (r & 7))) << 4) + (lane & 3) * 4, v);
  }
}

// The loading warpgroup's own loads of the block's units [u0, u1).
template <bool kPairs>
__device__ void load_rows(const Params& p, uint32_t ring, uint32_t bars, long long u0, long long u1) {
  constexpr int S = stages(kPairs);
  const uintptr_t end = reinterpret_cast<uintptr_t>(p.masks) + static_cast<uintptr_t>(p.b) * p.q * p.k;
  Cursor c(p, u0);
  for (long long i = 0; i < u1 - u0; ++i, c.advance(p)) {
    const int s = static_cast<int>(i % S);
    if (i >= S) mbar_wait(empty_bar(bars, s), static_cast<uint32_t>((i / S - 1) & 1));
    const uint32_t tile = ring + s * stage_bytes(kPairs);
    constexpr int B = boxes(kPairs);
#pragma unroll 1
    for (int x = 0; x < B; ++x) {
      load_tile_rows(p, tile + x * kTileBytes, c.n, c.ti * kRows, c.kt * B + x, end);
      if (kPairs && c.ti != c.tj) {
        load_tile_rows(p, tile + (B + x) * kTileBytes, c.n, c.tj * kRows, c.kt * B + x, end);
      }
    }
    fence_proxy_async();  // the stores, before wgmma reads them
    warp_arrive(full_bar(bars, s));
  }
}

// The consumer warpgroups: each unit's product into the sums, and each
// (image, pair) stretch's sums added to the counts.
template <bool kPairs>
__device__ void consume(const Params& p, uint32_t ring, uint32_t bars, long long u0, long long u1) {
  constexpr int S = stages(kPairs);
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int acc[16][4];
  Cursor c(p, u0);
  long long start = 0;  // the stretch's first unit, counted from u0
  for (long long i = 0; i < u1 - u0; ++i, c.advance(p)) {
    const int s = static_cast<int>(i % S);
    mbar_wait(full_bar(bars, s), static_cast<uint32_t>((i / S) & 1));
    constexpr int B = boxes(kPairs);
    const uint32_t tile = ring + s * stage_bytes(kPairs);
    const uint32_t b_tile = kPairs && c.ti != c.tj ? tile + B * kTileBytes : tile;
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < B; ++x) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        wgmma_s8_n128(acc, tile_desc(tile + x * kTileBytes + wg * (64 * kTileK) + 32 * ks),
                      tile_desc(b_tile + x * kTileBytes + 32 * ks), i > start || x > 0 || ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_sums(acc);
    warp_arrive(empty_bar(bars, s));
    if (i + 1 < u1 - u0 && c.kt + 1 < p.k_tiles) continue;

    // the stretch ends: its sums into the counts (past Q only zeros)
    int* cnt = p.counts + static_cast<long long>(c.n) * p.q * p.q;
    const int row0 = c.ti * kRows + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int nn = 0; nn < 16; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8, col = c.tj * kRows + nn * 8 + 2 * t + (e & 1);
        const int v = acc[nn][e];
        if (v != 0 && row < p.q && col < p.q) {
          atomicAdd(cnt + static_cast<long long>(row) * p.q + col, v);
          if (c.ti != c.tj) atomicAdd(cnt + static_cast<long long>(col) * p.q + row, v);
        }
      }
    }
    start = i + 1;
  }
}

template <bool kPairs, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    mask_counts_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  extern __shared__ __align__(1024) unsigned char iou_smem[];
  const uint32_t ring = smem_u32(iou_smem);
  const uint32_t bars = ring + kRingBytes;
  const long long u0 = blockIdx.x * p.per_block;
  const long long u1 = u0 + p.per_block < p.total ? u0 + p.per_block : p.total;
  if (threadIdx.x == 0) {
    if (ring % 1024 != 0) __trap();  // the swizzled tiles need the pattern's alignment
    for (int s = 0; s < stages(kPairs); ++s) {
      mbar_init(full_bar(bars, s), kTma ? 1 : 4);  // the TMA thread, or one arrive a loading warp
      mbar_init(empty_bar(bars, s), 8);            // one arrive a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (!kTma) {
      load_rows<kPairs>(p, ring, bars, u0, u1);
    } else if (threadIdx.x == kConsumers) {
      prefetch_tensormap(&map);
      load_tma<kPairs>(&map, p, ring, bars, u0, u1);
    }
  } else {
    consume<kPairs>(p, ring, bars, u0, u1);
  }
}

// The IoU and the areas from the complete counts, one thread an element, with
// the plain version's f32 operations in its order: union = (a_i + a_j) -
// inter, iou = union > 0 ? inter / max(union, 1e-12) : 0.
__global__ void __launch_bounds__(kIouThreads) iou_kernel(const int* __restrict__ counts, float* __restrict__ iou,
                                                          float* __restrict__ areas, int q, long long elements) {
  const long long e = static_cast<long long>(blockIdx.x) * kIouThreads + threadIdx.x;
  if (e >= elements) return;
  const long long qq = static_cast<long long>(q) * q;
  const long long n = e / qq;
  const int i = static_cast<int>((e - n * qq) / q), j = static_cast<int>(e - n * qq - static_cast<long long>(i) * q);
  const int* c = counts + n * qq;
  const float inter = __int2float_rn(counts[e]);
  const float ai = __int2float_rn(c[static_cast<long long>(i) * (q + 1)]);
  const float aj = __int2float_rn(c[static_cast<long long>(j) * (q + 1)]);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  iou[e] = uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
  if (i == j) areas[n * q + i] = inter;
}

template <bool kPairs, bool kTma>
int launch_counts(const CUtensorMap& map, const Params& p, long long grid, cudaStream_t stream) {
  // the attribute is per function: setting it once covers every launch
  static const cudaError_t configured =
      cudaFuncSetAttribute(mask_counts_kernel<kPairs, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  mask_counts_kernel<kPairs, kTma><<<static_cast<unsigned>(grid), kThreads, kSmemBytes, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// masks: [b, Q, K] bytes of 0 or 1 (a bool tensor's storage), contiguous,
// 1 <= Q <= 1024, 1 <= K <= 2^31 - 1; counts: [b, Q, Q] int32, zeroed (the
// intersection counts, summed into it); iou: [b, Q, Q] f32; areas: [b, Q]
// f32. Launches both kernels on `stream` and returns cudaGetLastError() or
// a hopper.cuh error code.
int zutis_mask_iou(const unsigned char* masks, int b, int q, long long k, int* counts, float* iou, float* areas,
                   void* stream) {
  if (b <= 0 || q <= 0 || q > kMaxQ || k <= 0 || k > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.masks = masks;
  p.counts = counts;
  p.k = k;
  p.b = b;
  p.q = q;
  p.tiles = (q + kRows - 1) / kRows;
  const int pairs = p.tiles * (p.tiles + 1) / 2;
  const int step = unit_k(p.tiles > 1);
  p.k_tiles = (k + step - 1) / step;
  p.total = static_cast<long long>(b) * pairs * p.k_tiles;
  long long per_block = (p.total + sms - 1) / sms;  // K split: one block an SM, an equal run of units each
  p.per_block = per_block;
  const long long grid = (p.total + p.per_block - 1) / p.per_block;

  CUtensorMap map{};
  const bool tma = k % 16 == 0 && reinterpret_cast<uintptr_t>(masks) % 16 == 0;
  if (tma) {
    const uint64_t dims[4] = {static_cast<uint64_t>(k), static_cast<uint64_t>(q), static_cast<uint64_t>(b), 1};
    const uint64_t strides[3] = {static_cast<uint64_t>(k), static_cast<uint64_t>(k) * q,
                                 static_cast<uint64_t>(k) * q * b};
    const uint32_t box[4] = {kTileK, kRows, 1, 1};
    const int e = encode_4d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, masks, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = p.tiles == 1 ? (tma ? launch_counts<false, true>(map, p, grid, s)
                                    : launch_counts<false, false>(map, p, grid, s))
                             : (tma ? launch_counts<true, true>(map, p, grid, s)
                                    : launch_counts<true, false>(map, p, grid, s));
  if (e != 0) return e;
  const long long elements = static_cast<long long>(b) * q * q;
  iou_kernel<<<static_cast<unsigned>((elements + kIouThreads - 1) / kIouThreads), kIouThreads, 0, s>>>(
      counts, iou, areas, q, elements);
  return static_cast<int>(cudaGetLastError());
}

const char* zutis_cuda_error_string(int err) {
  const char* own = error_string(err);
  return own != nullptr ? own : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
