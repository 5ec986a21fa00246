// Flash-attention forward for Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see zutis_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel zutis_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call), together with the
// wrapper's zeroing of items whose kv_mask has no valid key.
//
// Computes  o = softmax(q k^T * d^-1/2, keys masked by kv_mask) v  for
// q [b, h, sq, d], k/v [b, h, sk, d], o [b, h, sq, d]. Each of q, k, v and o is
// addressed through its own (batch, head, sequence) strides in elements with
// the head dim contiguous, so the [b, s, h, d] projections of the model are
// read and written in place with no transpose copies.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   - encoder self-attention, d=64, 577 tokens: ~1.0 GFLOP against ~3.5 MB of
//     q, k, v and o per image per layer (~290 FLOP/byte), roughly at the
//     card's balance point of ~295 FLOP/byte;
//   - decoder cross-attention, d=96, 100 queries over 2304 keys: ~0.7 GFLOP
//     against ~7.4 MB (~96 FLOP/byte), bound by memory: K and V dominate.
// What the design does about it: the [sq, sk] logits never leave the chip.
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// keeps its 16 rows' scores, softmax statistics and output accumulator in
// registers (mma.sync m16n8k16 bf16 -> f32 fragments, FlashAttention-2
// style), and K/V stream through shared memory in 64-key tiles with a
// two-stage cp.async pipeline, so each K/V byte is read once per 64 queries
// and the next tile's load overlaps the current tile's products. The ragged
// key edge and kv_mask are applied per tile from a staged validity vector;
// masked keys get exactly zero weight, so an item with no valid key comes out
// as zeros with no extra pass. wgmma, TMA and warp specialisation are left
// for later work.
//
// f32 inputs are split into bf16 high and low parts (x = hi + lo) and each
// product takes three bf16 MMAs (hi*hi + hi*lo + lo*hi), which keeps about
// 16 mantissa bits: close to f32 attention without a slow f32 datapath.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // [b, sk] int32, nonzero = valid key; may be null
  void* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int sq, sk;
  float scale_log2;  // d^-1/2 * log2(e): softmax runs in base 2
};

// Shared-memory rows are padded by 16 bytes so that the fragment loads of
// neighbouring rows fall on different banks.
template <typename T>
__host__ __device__ constexpr int row_stride(int d) {
  return d + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  // Q tile + two stages of (K tile, V tile) + two stages of key validity
  return (5 * kBlockN * row_stride<T>(D)) * sizeof(T) + 2 * kBlockN * sizeof(int);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of a [rows, D] slice with row stride `ss` into a
// padded shared tile; rows at or past `rows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* tile, const T* g, long long ss, int row0, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = D / kVec;
  constexpr int kChunks = kBlockN * kChunksPerRow;
  constexpr int kStride = row_stride<T>(D);
  static_assert(kChunks % kThreads == 0, "tile chunks must split evenly over the block");
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * kVec;
    const int gr = row0 + r;
    const bool ok = gr < rows;
    cp_async16(tile + r * kStride + col, g + (ok ? gr : 0) * ss + col, ok);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two values as a bf16x2 operand register (first value in the low half) and,
// for f32 inputs, the bf16x2 register of what bf16 rounding left over.
__device__ __forceinline__ void pack(float a, float b, uint32_t& hi, uint32_t& lo, bool split) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  if (split) {
    lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
  }
}

__device__ __forceinline__ void pair(const __nv_bfloat16* p0, const __nv_bfloat16* p1,
                                     uint32_t& hi, uint32_t& lo) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(p0);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(p1);
  hi = a | (b << 16);
  lo = 0;
}

__device__ __forceinline__ void pair(const float* p0, const float* p1, uint32_t& hi, uint32_t& lo) {
  pack(*p0, *p1, hi, lo, true);
}

// Two neighbouring elements (4-byte aligned for bf16, 8-byte for f32).
__device__ __forceinline__ void pair_adjacent(const __nv_bfloat16* p, uint32_t& hi, uint32_t& lo) {
  hi = *reinterpret_cast<const uint32_t*>(p);
  lo = 0;
}

__device__ __forceinline__ void pair_adjacent(const float* p, uint32_t& hi, uint32_t& lo) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  pack(f.x, f.y, hi, lo, true);
}

// D[16x8] += A[16x16] * B[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8, "col"):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (16x8 f32):         c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kStride = row_stride<T>(D);
  constexpr int kTile = kBlockN * kStride;
  constexpr int kKSteps = D / 16;  // k-steps of q k^T
  constexpr int kOTiles = D / 8;   // n8 tiles of the output row block
  constexpr int kSTiles = kBlockN / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + kTile;      // two stages
  T* s_v = s_k + 2 * kTile;  // two stages
  int* s_valid = reinterpret_cast<int*>(s_v + 2 * kTile);  // two stages

  const int bi = blockIdx.z, hi = blockIdx.y, q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  T* o = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;
  const int* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(bi) * p.sk;
  const int n_tiles = (p.sk + kBlockN - 1) / kBlockN;

  auto prefetch = [&](int j) {
    const int stage = j & 1;
    load_tile<T, D>(s_k + stage * kTile, k, p.k_ss, j * kBlockN, p.sk);
    load_tile<T, D>(s_v + stage * kTile, v, p.v_ss, j * kBlockN, p.sk);
    if (threadIdx.x < kBlockN) {
      const int col = j * kBlockN + threadIdx.x;
      s_valid[stage * kBlockN + threadIdx.x] = col < p.sk && (mask == nullptr || mask[col] != 0);
    }
  };

  load_tile<T, D>(s_q, q, p.q_ss, q0, p.sq);
  cp_async_commit();
  if (n_tiles > 0) prefetch(0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q group has landed
  __syncthreads();

  uint32_t qa[kKSteps][4], qa_lo[kKSteps][4];
  {
    const T* base = s_q + (warp * 16) * kStride;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c = ks * 16 + 2 * t;
      pair_adjacent(base + g * kStride + c, qa[ks][0], qa_lo[ks][0]);
      pair_adjacent(base + (g + 8) * kStride + c, qa[ks][1], qa_lo[ks][1]);
      pair_adjacent(base + g * kStride + c + 8, qa[ks][2], qa_lo[ks][2]);
      pair_adjacent(base + (g + 8) * kStride + c + 8, qa[ks][3], qa_lo[ks][3]);
    }
  }

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (base-2 logits) and this thread's share of the running sum
  // for rows g and g + 8 of the warp's 16
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) prefetch(j + 1);
    cp_async_commit();  // possibly empty, so that wait<1> always means "tile j landed"
    cp_async_wait<1>();
    __syncthreads();

    const int stage = j & 1;
    const T* kt = s_k + stage * kTile;
    const T* vt = s_v + stage * kTile;
    const int* valid = s_valid + stage * kBlockN;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const T* kp = kt + (n * 8 + g) * kStride + ks * 16 + 2 * t;
        uint32_t b0, b1, b0_lo, b1_lo;
        pair_adjacent(kp, b0, b0_lo);
        pair_adjacent(kp + 8, b1, b1_lo);
        mma(s[n], qa[ks], b0, b1);
        if constexpr (kSplit) {
          mma(s[n], qa[ks], b0_lo, b1_lo);
          mma(s[n], qa_lo[ks], b0, b1);
        }
      }
    }

    // online softmax: masked keys are -inf, so they get exactly zero weight
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        s[n][e] = valid[col] ? s[n][e] * p.scale_log2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the score accumulators are already in the A-operand layout
#pragma unroll
    for (int c = 0; c < kBlockN / 16; ++c) {
      uint32_t pa[4], pa_lo[4];
      pack(s[2 * c][0], s[2 * c][1], pa[0], pa_lo[0], kSplit);
      pack(s[2 * c][2], s[2 * c][3], pa[1], pa_lo[1], kSplit);
      pack(s[2 * c + 1][0], s[2 * c + 1][1], pa[2], pa_lo[2], kSplit);
      pack(s[2 * c + 1][2], s[2 * c + 1][3], pa[3], pa_lo[3], kSplit);
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const T* vp = vt + (c * 16 + 2 * t) * kStride + n * 8 + g;
        uint32_t b0, b1, b0_lo, b1_lo;
        pair(vp, vp + kStride, b0, b0_lo);
        pair(vp + 8 * kStride, vp + 9 * kStride, b1, b1_lo);
        mma(acc[n], pa, b0, b1);
        if constexpr (kSplit) {
          mma(acc[n], pa, b0_lo, b1_lo);
          mma(acc[n], pa_lo, b0, b1);
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch refills this stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / fmaxf(l_run[r], 1e-30f);  // no valid key: l = 0 and acc = 0
  }
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < p.sq) store2(o + row_a * p.o_ss + col, acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (row_b < p.sq) store2(o + row_b * p.o_ss + col, acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int b, int h, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<T, D>();
  static bool configured = false;  // the attribute is per function, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, h, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32. strides: 12 values, the (batch, head,
// sequence) strides in elements of q, k, v and o in that order. Returns a
// cudaError_t (0 on success), or cudaErrorInvalidValue for a dtype or head dim
// this library was not built for. Launches on `stream`, allocates nothing and
// does not synchronise.
int zutis_flash_attention_fwd(const void* q, const void* k, const void* v, const int* kv_mask, void* o,
                              int dtype, int b, int h, int sq, int sk, int d, const long long* strides,
                              float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = kv_mask;
  p.o = o;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.sq = sq;
  p.sk = sk;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return launch<__nv_bfloat16, 64>(p, b, h, s);
  if (dtype == 0 && d == 96) return launch<__nv_bfloat16, 96>(p, b, h, s);
  if (dtype == 1 && d == 64) return launch<float, 64>(p, b, h, s);
  if (dtype == 1 && d == 96) return launch<float, 96>(p, b, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* zutis_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
