// PTX helpers for Hopper (sm_90a) kernels: mbarriers, TMA tensor loads,
// wgmma with A from registers (and, for S = Q K^T at d 256, from shared
// memory), shared-memory matrix descriptors, and the
// host side of a tensor map; then the 64-row attention chunks that the
// `single` and max-free probes (attention_probes.cu) and the bf16 flash
// forward (flash_attention.cu) load with TMA and feed to wgmma.
//
// Conventions:
//   - shared-memory addresses are 32-bit `.shared` addresses (smem_u32);
//   - a tile that TMA writes with a 64-byte swizzle is read by wgmma through
//     a descriptor with layout kSwizzle64B and by threads through
//     swizzle_64b(), all three on absolute address bits, so tiles must start
//     on a 512-byte boundary (the pattern repeats every 8 rows of 64 bytes);
//   - wgmma accumulators follow mma.m16n8k16's C layout per 8-column block:
//     warp w of the warpgroup holds rows 16w..16w+15, d[n][0..1] is (row g,
//     cols 8n+2t, +1) and d[n][2..3] is row g+8, with g = lane / 4 and
//     t = lane % 4; A from registers follows mma's A layout in the same way.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Error codes beside cudaError_t's (which stop below 1000)
// ---------------------------------------------------------------------------

constexpr int kErrNoTensorMapEncoder = 10001;  // the driver has no cuTensorMapEncodeTiled
constexpr int kErrTensorMapEncode = 10002;     // cuTensorMapEncodeTiled refused the map

inline const char* error_string(int err) {
  if (err == kErrNoTensorMapEncoder) return "the CUDA driver offers no cuTensorMapEncodeTiled";
  if (err == kErrTensorMapEncode) return "cuTensorMapEncodeTiled refused a tensor map (shape, strides or address)";
  return nullptr;
}

// Dynamic shared memory one block may use on an H100 (227 KB).
constexpr int kSmemLimit = 232448;

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched through the runtime so that a
// library needs no -lcuda; nullptr if the driver lacks it.
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(f)
                                                                        : nullptr;
  }();
  return fn;
}

// A rank-4 tensor map of `type` (bf16 or f32): extents dims[0..3], innermost
// first; byte strides[0..2] of dims 1..3 (multiples of 16); boxes of
// box[0..3] elements. Loads fill elements past an extent with zeros. Returns
// 0 or one of the error codes above.
inline int encode_4d(CUtensorMap* map, CUtensorMapDataType type, const void* base, const uint64_t (&dims)[4],
                     const uint64_t (&strides)[3], const uint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return kErrNoTensorMapEncoder;
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint32_t gbox[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), gdim, st, gbox, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMapEncode;
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 64-byte swizzle that TMA (CU_TENSOR_MAP_SWIZZLE_64B) and wgmma
// (kSwizzle64B) apply: address bits [4, 6) ^= bits [7, 9).
__device__ __forceinline__ uint32_t swizzle_64b(uint32_t addr) { return addr ^ (((addr >> 7) & 3u) << 4); }

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint64_t ld_shared_u64(uint32_t addr) {
  uint64_t v;
  asm volatile("ld.shared.b64 %0, [%1];\n" : "=l"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u64(uint32_t addr, uint64_t v) {
  asm volatile("st.shared.b64 [%0], %1;\n" ::"r"(addr), "l"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// After the inits, before any thread or TMA uses the barriers (then a
// __syncthreads).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory accesses with later
// async-proxy ones (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One warp's share of releasing a buffer: lane 0 arrives once for the warp,
// after every lane is done with it (a consumer warpgroup counts 4).
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Arrive once and add `bytes` to the transactions the current phase awaits.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Cycles a wait may take before the kernel traps: seconds at the H100's
// clock, where a healthy wait takes microseconds. A trap fails the launch,
// so a pipeline fault surfaces as an error and never as a hung card.
constexpr long long kMbarTimeoutCycles = 1ll << 33;

// Wait until the phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kMbarTimeoutCycles) __trap();
  }
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a rank-4 map at element coordinates (c0 innermost) into shared
// memory at `dst`, completing its bytes on mbarrier `bar`. `map` is a
// __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across a wgmma issue or wait.
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }

template <int R, int C>
__device__ __forceinline__ void fence_operands(float (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) fence_operand(x[i][j]);
  }
}

constexpr int kSwizzle128B = 1, kSwizzle64B = 2, kSwizzle32B = 3;

// The 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (multiples of 16 bytes), swizzle layout. With a
// swizzle, a K-major operand (K contiguous, rows at the swizzle width) takes
// SBO = the step between 8-row groups and no LBO; an MN-major operand takes
// LBO = the step between swizzle-wide column blocks along MN and SBO = the
// step between 8-row groups along K. A K step inside the swizzle width adds
// its bytes to the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(layout) << 62;
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]: bf16 operands, f32 accumulators, A
// from registers (4 x b32 per thread), B through a descriptor; kTransB 0
// for a K-major B, 1 for an MN-major B. scale_d 0 overwrites D.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<8> {
  template <int kTransB>
  static __device__ __forceinline__ void mma(float (&d)[1][4], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %9;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  template <int kTransB>
  static __device__ __forceinline__ void mma(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<96> {
  template <int kTransB>
  static __device__ __forceinline__ void mma(float (&d)[12][4], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, %53;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<256> {
  template <int kTransB>
  static __device__ __forceinline__ void mma(float (&d)[32][4], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %133;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB), "r"(scale_d));
  }
};

// D[64 x 64] (+)= A[64 x 16] B[16 x 64] with A and B both from shared memory
// through descriptors, both K-major; scale_d 0 overwrites D. The bf16 flash
// forward at d 256 reads Q this way: as A fragments it would take 64
// registers a thread beside O's 128.
__device__ __forceinline__ void wgmma_ss_64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Attention chunks: 64 rows (keys, or one warpgroup's query rows) of a
// [b, h, s, d] bf16 tensor, loaded by TMA as d / 32 boxes of [64 rows, 32
// columns] with a 64-byte swizzle (box x holds columns 32x..32x+31, a row of
// a box is 64 bytes), so a chunk is d * 128 bytes and every box starts on a
// 4 KB step from the chunk's start.
// ---------------------------------------------------------------------------

constexpr int kChunkRows = 64;
constexpr int kBoxCols = 32;                                // a box row: 32 bf16 = 64 swizzled bytes
constexpr int kBoxBytes = kChunkRows * kBoxCols * 2;        // one TMA box
constexpr uint32_t kRowStrideBytes = kBoxCols * 2;          // a swizzled row
constexpr uint32_t kGroupStrideBytes = 8 * kRowStrideBytes; // an 8-row group: the swizzle pattern

__host__ __device__ constexpr int chunk_bytes(int d) { return d * kChunkRows * 2; }  // d / 32 boxes

// The tensor map of one [b, h, rows, d] tensor of `type` as rank 4 {d,
// rows, h, b} with its (batch, head, row) strides in elements
// (strides[0..2]), so that rows past the edge arrive as zeros. bf16 comes in
// boxes of one chunk's 64 rows by 32 columns with a 64-byte swizzle, as wgmma
// reads it; f32 in one unswizzled box of 64 rows by d columns (row-major, d * 4
// bytes a row), which threads read. Returns 0 or an error code of encode_4d.
inline int rows_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int b, int h, int rows, int d,
                    const long long* strides) {
  const bool f32 = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint64_t size = f32 ? 4 : 2;
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(rows), static_cast<uint64_t>(h),
                            static_cast<uint64_t>(b)};
  const uint64_t bytes[3] = {static_cast<uint64_t>(strides[2]) * size, static_cast<uint64_t>(strides[1]) * size,
                             static_cast<uint64_t>(strides[0]) * size};
  const uint32_t box[4] = {f32 ? static_cast<uint32_t>(d) : kBoxCols, kChunkRows, 1, 1};
  return encode_4d(map, type, ptr, dims, bytes, box, f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_64B);
}

// rows_map of q, k and v (strides[3i..3i+2] for q, k, v), rows sq for q and
// sk for k and v.
inline int attention_maps(CUtensorMap (&maps)[3], CUtensorMapDataType type, const void* q, const void* k,
                          const void* v, int b, int h, int sq, int sk, int d, const long long* strides) {
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {sq, sk, sk};
  for (int i = 0; i < 3; ++i) {
    const int err = rows_map(&maps[i], type, ptrs[i], b, h, rows[i], d, strides + 3 * i);
    if (err != 0) return err;
  }
  return 0;
}

// One chunk of a rows_map tensor, 64 rows from row0 and all D columns, into
// `dst` as D / 32 boxes, completing on mbarrier `bar`; a block's one
// producer thread issues it.
template <int D>
__device__ __forceinline__ void load_chunk(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row0, int hi,
                                           int bi) {
#pragma unroll
  for (int x = 0; x < D / kBoxCols; ++x) tma_load_4d(dst + x * kBoxBytes, map, bar, x * kBoxCols, row0, hi, bi);
}

// The bf16 pair (row r, columns c and c + 1; c even) of a chunk, as a thread
// reads it for an A fragment.
__device__ __forceinline__ uint32_t ld_chunk_pair(uint32_t chunk, int r, int c) {
  return ld_shared_u32(swizzle_64b(chunk + (c / kBoxCols) * kBoxBytes + r * kRowStrideBytes + (c % kBoxCols) * 2));
}

// Issue S[64 x 64] = Q K^T for this warpgroup's rows and one K chunk (K-major:
// a K step of 16 dims is 32 bytes into a box row) as one wgmma group; the
// caller waits for it.
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[kChunkRows / 8][4], const uint32_t (&qa)[D / 16][4],
                                         uint32_t k_chunk) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t addr = k_chunk + (ks / 2) * kBoxBytes + (ks % 2) * 32;
    const uint64_t desc = smem_desc(addr, 16, kGroupStrideBytes, kSwizzle64B);
    WgmmaRS<kChunkRows>::template mma<0>(s, qa[ks], desc, ks > 0);
  }
  wgmma_commit();
}

// qk_issue with Q from shared memory: the 64 query rows as a chunk that TMA
// laid out like K's, read through a K-major descriptor like K's own.
template <int D>
__device__ __forceinline__ void qk_issue_ss(float (&s)[kChunkRows / 8][4], uint32_t q_chunk, uint32_t k_chunk) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t step = (ks / 2) * kBoxBytes + (ks % 2) * 32;
    wgmma_ss_64(s, smem_desc(q_chunk + step, 16, kGroupStrideBytes, kSwizzle64B),
                smem_desc(k_chunk + step, 16, kGroupStrideBytes, kSwizzle64B), ks > 0);
  }
  wgmma_commit();
}

// Issue S[64 x 64] = Q K^T as one wgmma group, from a chunk of K^T: 64 keys
// by D dims, loaded as two boxes of [D dims, 32 keys] with the 64-byte
// swizzle (a box row is one dim of 32 keys). That is to Q K^T what V's chunk
// is to P V, an MN-major B: a K step of 16 dims is 16 rows further, LBO the
// D * 64-byte step between the two 32-key boxes.
template <int D>
__device__ __forceinline__ void qkt_issue(float (&s)[kChunkRows / 8][4], const uint32_t (&qa)[D / 16][4],
                                          uint32_t kt_chunk) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t addr = kt_chunk + ks * 16 * kRowStrideBytes;
    const uint64_t desc = smem_desc(addr, D * kRowStrideBytes, kGroupStrideBytes, kSwizzle64B);
    WgmmaRS<kChunkRows>::template mma<1>(s, qa[ks], desc, ks > 0);
  }
  wgmma_commit();
}

// acc[64 x D] += P[64 x 16] V[16 x D] of K step c (16 keys). V's chunk is
// MN-major: a K step of 16 keys is 16 rows further, LBO the 4 KB step
// between 32-column boxes.
template <int D>
__device__ __forceinline__ void pv_step(float (&acc)[D / 8][4], const uint32_t (&pa)[4], uint32_t v_chunk, int c) {
  const uint32_t addr = v_chunk + c * 16 * kRowStrideBytes;
  WgmmaRS<D>::template mma<1>(acc, pa, smem_desc(addr, kBoxBytes, kGroupStrideBytes, kSwizzle64B), 1);
}

// Issue acc[64 x D] += P[64 x 64] V[64 x D] as one wgmma group, P as bf16 A
// fragments; the caller waits for it.
template <int D>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 8][4], const uint32_t (&pa)[kChunkRows / 16][4],
                                         uint32_t v_chunk) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunkRows / 16; ++c) pv_step<D>(acc, pa[c], v_chunk, c);
  wgmma_commit();
}

// Bytes of a shared-memory area of bf16 ones, 512-byte aligned: a wgmma B
// operand whose every element is 1, whatever descriptor reads it from there.
constexpr int kOnesBytes = 512;

// pv_issue, and in the same wgmma group rowsum[64 x 8] += P[64 x 64]
// ones[64 x 8]: every column of rowsum gathers P's row sums on the tensor
// cores. `ones` is a kOnesBytes area of ones; its descriptor (K-major, 64-byte
// swizzle, one 8-row group) stays inside it.
template <int D>
__device__ __forceinline__ void pv_rowsum_issue(float (&acc)[D / 8][4], float (&rowsum)[1][4],
                                                const uint32_t (&pa)[kChunkRows / 16][4], uint32_t v_chunk,
                                                uint32_t ones) {
  const uint64_t ones_desc = smem_desc(ones, 16, kGroupStrideBytes, kSwizzle64B);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunkRows / 16; ++c) {
    pv_step<D>(acc, pa[c], v_chunk, c);
    WgmmaRS<8>::template mma<0>(rowsum, pa[c], ones_desc, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {  // a in the low half, both rounded
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// bf16(p) as the A fragments of P V: m64n8 block nn of the S accumulator is
// half of K step nn / 2.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kChunkRows / 16][4], const float (&s)[kChunkRows / 8][4]) {
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
    pa[nn / 2][2 * (nn % 2)] = pack_bf16x2(s[nn][0], s[nn][1]);  // rounds p to bf16
    pa[nn / 2][2 * (nn % 2) + 1] = pack_bf16x2(s[nn][2], s[nn][3]);
  }
}

}  // namespace hopper
