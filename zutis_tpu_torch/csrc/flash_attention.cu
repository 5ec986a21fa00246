// Flash-attention forward for Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see zutis_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel zutis_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call), together with the
// wrapper's zeroing of items whose kv_mask has no valid key.
//
// Computes  o = softmax(q k^T * d^-1/2, keys masked by kv_mask) v  for
// q [b, h, sq, d], k/v [b, h, sk, d], o [b, h, sq, d], d 64 or 96. Each of q,
// k, v and o is addressed through its own (batch, head, sequence) strides in
// elements with the head dim contiguous, so the [b, s, h, d] projections of
// the model are read and written in place with no transpose copies. Both
// kernels keep f32 running max and sum in base 2, round P to bf16 before
// P V (hi/lo parts for f32), give masked keys exactly zero weight, floor l
// at 1e-30 and so give an item with no valid key an all-zero output.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   - encoder self-attention, d=64, 577 tokens: ~1.0 GFLOP against ~3.5 MB of
//     q, k, v and o per image per layer (~290 FLOP/byte), roughly at the
//     card's balance point of ~295 FLOP/byte;
//   - decoder cross-attention, d=96, 100 queries over 2304 keys: ~0.7 GFLOP
//     against ~7.4 MB (~96 FLOP/byte), bound by memory: K and V dominate.
// The [sq, sk] logits never leave the chip in either kernel.
//
// Two kernels, chosen by dtype:
//   - bf16 (the serving path): flash_wgmma_kernel, on Hopper's TMA,
//     mbarriers and wgmma (helpers in hopper.cuh; design note at the kernel).
//   - f32: flash_fwd_kernel, FlashAttention-2 style on mma.sync with a
//     two-stage cp.async K/V ring. Inputs are split into bf16 high and low
//     parts (x = hi + lo) and each product takes three bf16 MMAs (hi*hi +
//     hi*lo + lo*hi), which keeps about 16 mantissa bits: close to f32
//     attention without a slow f32 datapath.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------------------
// f32: flash_fwd_kernel
//
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// keeps its 16 rows' scores, softmax statistics and output accumulator in
// registers (mma.sync m16n8k16 bf16 -> f32 fragments, FlashAttention-2
// style), and K/V stream through shared memory in 64-key tiles with a
// two-stage cp.async pipeline, so each K/V byte is read once per 64 queries
// and the next tile's load overlaps the current tile's products. The ragged
// key edge and kv_mask are applied per tile from a staged validity vector.
// ---------------------------------------------------------------------------

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Shared-memory rows are padded by 16 bytes so that the fragment loads of
// neighbouring rows fall on different banks.
__host__ __device__ constexpr int row_stride(int d) { return d + 4; }

template <int D>
constexpr size_t smem_bytes() {
  // Q tile + two stages of (K tile, V tile) + two stages of key validity
  return (5 * kBlockN * row_stride(D)) * sizeof(float) + 2 * kBlockN * sizeof(int);
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
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* g, long long ss, int row0, int rows) {
  constexpr int kVec = 4;
  constexpr int kChunksPerRow = D / kVec;
  constexpr int kChunks = kBlockN * kChunksPerRow;
  constexpr int kStride = row_stride(D);
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

// Two values as a bf16x2 operand register (first value in the low half) and
// the bf16x2 register of what bf16 rounding left over.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

__device__ __forceinline__ void pair(const float* p0, const float* p1, uint32_t& hi, uint32_t& lo) {
  split(*p0, *p1, hi, lo);
}

// Two neighbouring f32 elements (8-byte aligned).
__device__ __forceinline__ void pair_adjacent(const float* p, uint32_t& hi, uint32_t& lo) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  split(f.x, f.y, hi, lo);
}

// D[16x8] += A[16x16] * B[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8, "col"):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (16x8 f32):         c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kStride = row_stride(D);
  constexpr int kTile = kBlockN * kStride;
  constexpr int kKSteps = D / 16;  // k-steps of q k^T
  constexpr int kOTiles = D / 8;   // n8 tiles of the output row block
  constexpr int kSTiles = kBlockN / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + kTile;      // two stages
  float* s_v = s_k + 2 * kTile;  // two stages
  int* s_valid = reinterpret_cast<int*>(s_v + 2 * kTile);  // two stages

  const int bi = blockIdx.z, hi = blockIdx.y, q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* q = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  float* o = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh;
  const int* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(bi) * p.sk;
  const int n_tiles = (p.sk + kBlockN - 1) / kBlockN;

  auto prefetch = [&](int j) {
    const int stage = j & 1;
    load_tile<D>(s_k + stage * kTile, k, p.k_ss, j * kBlockN, p.sk);
    load_tile<D>(s_v + stage * kTile, v, p.v_ss, j * kBlockN, p.sk);
    if (threadIdx.x < kBlockN) {
      const int col = j * kBlockN + threadIdx.x;
      s_valid[stage * kBlockN + threadIdx.x] = col < p.sk && (mask == nullptr || mask[col] != 0);
    }
  };

  load_tile<D>(s_q, q, p.q_ss, q0, p.sq);
  cp_async_commit();
  if (n_tiles > 0) prefetch(0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q group has landed
  __syncthreads();

  uint32_t qa[kKSteps][4], qa_lo[kKSteps][4];
  {
    const float* base = s_q + (warp * 16) * kStride;
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
    const float* kt = s_k + stage * kTile;
    const float* vt = s_v + stage * kTile;
    const int* valid = s_valid + stage * kBlockN;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const float* kp = kt + (n * 8 + g) * kStride + ks * 16 + 2 * t;
        uint32_t b0, b1, b0_lo, b1_lo;
        pair_adjacent(kp, b0, b0_lo);
        pair_adjacent(kp + 8, b1, b1_lo);
        mma(s[n], qa[ks], b0, b1);
        mma(s[n], qa[ks], b0_lo, b1_lo);
        mma(s[n], qa_lo[ks], b0, b1);
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
      split(s[2 * c][0], s[2 * c][1], pa[0], pa_lo[0]);
      split(s[2 * c][2], s[2 * c][3], pa[1], pa_lo[1]);
      split(s[2 * c + 1][0], s[2 * c + 1][1], pa[2], pa_lo[2]);
      split(s[2 * c + 1][2], s[2 * c + 1][3], pa[3], pa_lo[3]);
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const float* vp = vt + (c * 16 + 2 * t) * kStride + n * 8 + g;
        uint32_t b0, b1, b0_lo, b1_lo;
        pair(vp, vp + kStride, b0, b0_lo);
        pair(vp + 8 * kStride, vp + 9 * kStride, b1, b1_lo);
        mma(acc[n], pa, b0, b1);
        mma(acc[n], pa, b0_lo, b1_lo);
        mma(acc[n], pa_lo, b0, b1);
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

template <int D>
cudaError_t launch(const Params& p, int b, int h, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<D>();
  static bool configured = false;  // the attribute is per function, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, h, b);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: flash_wgmma_kernel
//
// Design (Hopper). A block is one consumer warpgroup, owning 64 query rows
// of one (batch, head), and one producer warp: 160 threads. Two warpgroups
// sharing each K/V chunk in a 288-thread block (128 rows) lost to this at
// every serving shape on an H100 (PERF.md): two 64-row blocks fit an SM, so
// one block's first loads and last stores overlap the other's work.
//   - The producer warp loads with TMA (tensor maps over [b, h, s, d] with
//     s's extent sq or sk, so rows past the edge arrive as zeros) in 64-row x
//     32-column boxes with a 64-byte swizzle, each completing on an mbarrier:
//     the Q tile once, then every 64-key chunk of K and of V through a ring
//     of kFlashStages stages with full and empty barriers, K and V apart so
//     that Q K^T starts before V lands. A stage is 16 KB at d 64 and 24 KB at
//     d 96: a ring of 4 lets three stages (48 KB, 72 KB) load while one is
//     consumed, above the ~26 KB per SM that 3.35 TB/s needs at ~1 us of
//     latency, and two blocks still fit an SM. Beside each K
//     chunk the warp writes the chunk's key validity (in range and not
//     masked) as one 64-bit word, from a ballot over kv_mask, so consumers
//     apply the ragged edge and the mask with one shared load per chunk.
//   - Consumers read Q once into wgmma A fragments. Both products are
//     wgmma.mma_async with A from registers: S = Q K^T (m64n64k16, K chunk
//     K-major through a descriptor) and O += P V (m64n{64,96}k16, the S
//     accumulator rounded to bf16 is P's A fragment, V MN-major). The online
//     softmax of chunk j runs while P V of chunk j - 1 is on the tensor
//     cores: each iteration issues Q K_j^T and P_{j-1} V_{j-1} together,
//     waits for the first, takes chunk j's softmax, waits for the second,
//     then rescales O and packs P_j. No wgmma group stays in flight across
//     an iteration, which keeps ptxas from serialising them.
//   - O leaves with per-thread bf16x2 stores through o's strides.
// Left for later: split keys for the cross-attention's 64-128 blocks,
// cluster multicast of K/V across a head's q tiles, persistent blocks.
// ---------------------------------------------------------------------------

using hopper::kChunkRows;
using hopper::kSmemLimit;
constexpr int kFlashStages = 4;          // K/V ring depth
constexpr int kFlashThreads = 128 + 32;  // a consumer warpgroup and the producer warp

__host__ __device__ constexpr int flash_chunks(int sk) { return (sk + kChunkRows - 1) / kChunkRows; }

// Byte offsets into a block's dynamic shared memory (mirrored by
// ops/flash_attention.py::smem_layout): the Q tile, kFlashStages K chunks,
// kFlashStages V chunks, every one a multiple of 4 KB from the 1 KB-aligned
// base; then a 64-bit key-validity word per stage and the mbarriers q_full,
// k_full[S], k_empty[S], v_full[S], v_empty[S].
struct FlashLayout {
  int q, k, v, valid, bars, total;
};

__host__ __device__ constexpr FlashLayout flash_layout(int d) {
  const int c = hopper::chunk_bytes(d);
  const int k = c, v = k + kFlashStages * c, valid = v + kFlashStages * c;
  const int bars = valid + kFlashStages * 8;
  return FlashLayout{0, k, v, valid, bars, bars + (1 + 4 * kFlashStages) * 8};
}

struct FlashBars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (1 + kFlashStages + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (1 + 2 * kFlashStages + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (1 + 3 * kFlashStages + s); }
};

// The producer warp: lane 0 issues every TMA load of the block; the warp
// computes each chunk's key validity while lane 0 waits for a free stage.
template <int D>
__device__ void flash_producer(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv, const Params& p,
                               uint32_t base, const FlashLayout& lay, const FlashBars& bar, int bi, int hi, int q0) {
  constexpr uint32_t kChunk = hopper::chunk_bytes(D);
  const int lane = threadIdx.x & 31;
  const int n = flash_chunks(p.sk);
  const int* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(bi) * p.sk;
  if (lane == 0) {
    hopper::prefetch_tensormap(tq);
    hopper::prefetch_tensormap(tk);
    hopper::prefetch_tensormap(tv);
    hopper::mbar_arrive_expect_tx(bar.q_full(), kChunk);
    hopper::load_chunk<D>(base + lay.q, tq, bar.q_full(), q0, hi, bi);
  }
  for (int j = 0; j < n; ++j) {
    const int s = j % kFlashStages;
    const uint32_t parity = ((j / kFlashStages) + 1) & 1;  // the release of chunk j - kFlashStages
    const int c0 = j * kChunkRows + lane, c1 = c0 + 32;
    const bool ok0 = c0 < p.sk && (mask == nullptr || mask[c0] != 0);
    const bool ok1 = c1 < p.sk && (mask == nullptr || mask[c1] != 0);
    const uint64_t lo = __ballot_sync(0xffffffffu, ok0), hi_bits = __ballot_sync(0xffffffffu, ok1);
    const uint64_t valid = lo | (hi_bits << 32);
    if (lane == 0) {
      if (j >= kFlashStages) hopper::mbar_wait(bar.k_empty(s), parity);
      // released with the arrive below, acquired by the consumers' k_full wait
      hopper::st_shared_u64(base + lay.valid + 8 * s, valid);
      hopper::mbar_arrive_expect_tx(bar.k_full(s), kChunk);
      hopper::load_chunk<D>(base + lay.k + s * kChunk, tk, bar.k_full(s), j * kChunkRows, hi, bi);
      if (j >= kFlashStages) hopper::mbar_wait(bar.v_empty(s), parity);
      hopper::mbar_arrive_expect_tx(bar.v_full(s), kChunk);
      hopper::load_chunk<D>(base + lay.v + s * kChunk, tv, bar.v_full(s), j * kChunkRows, hi, bi);
    }
    __syncwarp();
  }
}

// The online softmax of one chunk, in base 2: keys whose validity bit is 0
// get -inf and so exactly zero weight; s becomes p = exp2(s * scale_log2 -
// m_new), m the running max of the scaled logits, l this thread's share of
// the running sum (rescaled, plus p in f32), alpha the factor that rescales O.
__device__ __forceinline__ void chunk_softmax(float (&s)[kChunkRows / 8][4], uint64_t valid, float scale_log2,
                                              float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  const int t = threadIdx.x & 3;
  if (valid != ~0ull) {
#pragma unroll
    for (int nn = 0; nn < kChunkRows / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((valid >> (nn * 8 + 2 * t + (e & 1))) & 1)) s[nn][e] = -CUDART_INF_F;
      }
    }
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nn][e]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // scale_log2 > 0: max commutes with it
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nn][e] = exp2f(fmaf(s[nn][e], scale_log2, neg_m[e >> 1]));
      l[e >> 1] += s[nn][e];
    }
  }
}

// The consumer warpgroup: its 64 query rows against every key chunk.
template <int D>
__device__ void flash_consumer(const Params& p, uint32_t base, const FlashLayout& lay, const FlashBars& bar, int bi,
                               int hi, int q0) {
  constexpr uint32_t kChunk = hopper::chunk_bytes(D);
  const int n = flash_chunks(p.sk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto k_chunk = [&](int j) { return base + lay.k + (j % kFlashStages) * kChunk; };
  auto v_chunk = [&](int j) { return base + lay.v + (j % kFlashStages) * kChunk; };
  auto valid = [&](int j) { return hopper::ld_shared_u64(base + lay.valid + 8 * (j % kFlashStages)); };
  auto parity = [](int j) { return static_cast<uint32_t>((j / kFlashStages) & 1); };

  // Q as A fragments; rows past sq arrived as zeros
  hopper::mbar_wait(bar.q_full(), 0);
  uint32_t qa[D / 16][4];
  const uint32_t q_tile = base + lay.q;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[ks][i] = hopper::ld_chunk_pair(q_tile, warp * 16 + g + (i & 1) * 8, ks * 16 + 2 * t + (i >> 1) * 8);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
  float s[kChunkRows / 8][4] = {};
  uint32_t pa[kChunkRows / 16][4];
  float m[2] = {-1e30f, -1e30f};  // running max of the scaled logits (base 2)
  float l[2] = {0.f, 0.f};
  float alpha[2];

  // chunk 0: O is still zero, so it needs no P V beside it
  hopper::mbar_wait(bar.k_full(0), 0);
  hopper::qk_issue<D>(s, qa, k_chunk(0));
  uint64_t bits = valid(0);
  hopper::wgmma_wait<0>();
  hopper::warp_arrive(bar.k_empty(0));
  chunk_softmax(s, bits, p.scale_log2, m, l, alpha);
  hopper::pack_p(pa, s);
  for (int j = 1; j < n; ++j) {
    hopper::mbar_wait(bar.k_full(j % kFlashStages), parity(j));
    hopper::qk_issue<D>(s, qa, k_chunk(j));
    hopper::mbar_wait(bar.v_full((j - 1) % kFlashStages), parity(j - 1));
    hopper::pv_issue<D>(acc, pa, v_chunk(j - 1));
    bits = valid(j);
    hopper::wgmma_wait<1>();  // Q K^T of chunk j is done
    hopper::warp_arrive(bar.k_empty(j % kFlashStages));
    chunk_softmax(s, bits, p.scale_log2, m, l, alpha);
    hopper::wgmma_wait<0>();  // P V of chunk j - 1 is done with pa and V
    hopper::fence_operands(acc);
    hopper::warp_arrive(bar.v_empty((j - 1) % kFlashStages));
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      acc[nn][0] *= alpha[0];
      acc[nn][1] *= alpha[0];
      acc[nn][2] *= alpha[1];
      acc[nn][3] *= alpha[1];
    }
    hopper::pack_p(pa, s);
  }
  hopper::mbar_wait(bar.v_full((n - 1) % kFlashStages), parity(n - 1));
  hopper::pv_issue<D>(acc, pa, v_chunk(n - 1));
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
  hopper::warp_arrive(bar.v_empty((n - 1) % kFlashStages));

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);  // no valid key: l = 0 and acc = 0
  }
  bf16* o = static_cast<bf16*>(p.o) + bi * p.o_sb + hi * p.o_sh;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    const int col = nn * 8 + 2 * t;
    if (row_a < p.sq) {
      *reinterpret_cast<uint32_t*>(o + row_a * p.o_ss + col) =
          hopper::pack_bf16x2(acc[nn][0] * inv[0], acc[nn][1] * inv[0]);
    }
    if (row_b < p.sq) {
      *reinterpret_cast<uint32_t*>(o + row_b * p.o_ss + col) =
          hopper::pack_bf16x2(acc[nn][2] * inv[1], acc[nn][3] * inv[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads, 2)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ __align__(1024) unsigned char flash_smem[];
  const uint32_t base = hopper::smem_u32(flash_smem);
  const FlashLayout lay = flash_layout(D);
  const FlashBars bar{base + static_cast<uint32_t>(lay.bars)};
  if (threadIdx.x == 0) {
    if (base % 1024 != 0) __trap();  // the swizzled tiles need the pattern's alignment
    hopper::mbar_init(bar.q_full(), 1);
    for (int s = 0; s < kFlashStages; ++s) {
      hopper::mbar_init(bar.k_full(s), 1);
      hopper::mbar_init(bar.k_empty(s), 4);  // one arrive per consumer warp
      hopper::mbar_init(bar.v_full(s), 1);
      hopper::mbar_init(bar.v_empty(s), 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int bi = blockIdx.z, hi = blockIdx.y, q0 = blockIdx.x * kChunkRows;
  if (threadIdx.x >= 128) {
    flash_producer<D>(&tq, &tk, &tv, p, base, lay, bar, bi, hi, q0);
  } else {
    flash_consumer<D>(p, base, lay, bar, bi, hi, q0);
  }
}

template <int D>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[3], const Params& p, int b, int h, cudaStream_t stream) {
  // the attribute is per function: raising it to the limit once covers
  // every launch
  static const cudaError_t configured =
      cudaFuncSetAttribute(flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.sq + kChunkRows - 1) / kChunkRows, h, b);
  flash_wgmma_kernel<D><<<grid, kFlashThreads, flash_layout(D).total, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16 (flash_wgmma_kernel), 1 = float32 (flash_fwd_kernel).
// strides: 12 values, the (batch, head, sequence) strides in elements of q,
// k, v and o in that order. Both kernels take 64 query rows a block. bf16
// reads q, k and v through tensor maps and needs sk >= 1; a map the CUDA
// driver will not encode returns hopper::kErrTensorMapEncode, and a pipeline wait
// that never completes traps the kernel, which fails the launch at the next
// synchronisation. Returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a dtype, head dim or size this library does not
// take. Launches on `stream`, allocates nothing and does not synchronise.
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
  if (dtype == 1 && d == 64) return launch<64>(p, b, h, s);
  if (dtype == 1 && d == 96) return launch<96>(p, b, h, s);
  if (dtype != 0 || (d != 64 && d != 96) || sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const int err = hopper::attention_maps(maps, q, k, v, b, h, sq, sk, d, strides);
  if (err != 0) return err;
  if (d == 64) return launch_wgmma<64>(maps, p, b, h, s);
  return launch_wgmma<96>(maps, p, b, h, s);
}

// The dynamic shared memory of one bf16 block, and the blocks of that kernel
// an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int zutis_flash_occupancy(int d, int* smem_bytes, int* blocks_per_sm) {
  if (d != 64 && d != 96) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = d == 64 ? flash_wgmma_kernel<64> : flash_wgmma_kernel<96>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = flash_layout(d).total;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kFlashThreads, *smem_bytes));
}

const char* zutis_cuda_error_string(int err) {
  const char* own = hopper::error_string(err);
  return own != nullptr ? own : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
