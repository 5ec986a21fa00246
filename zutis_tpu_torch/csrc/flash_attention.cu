// Flash-attention forward for Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see zutis_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel zutis_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call), together with the
// wrapper's zeroing of items whose kv_mask has no valid key.
//
// Computes  o = softmax(q k^T * d^-1/2 + key_bias, keys masked by kv_mask) v
// for q [b, h, sq, d], k/v [b, h, sk, d], o [b, h, sq, d], d 64, 96 or 256
// (256 in bf16 only: the RN decoders' 2048 channels over 8 heads), and
// key_bias [b, sk] f32 added to every query's logit of a key (ToMe's
// log(size), the pooled decoder memory's log(count); the JAX package sends
// such a bias to XLA's einsum attention). Each of q,
// k, v and o is addressed through its own (batch, head, sequence) strides in
// elements with the head dim contiguous, so the [b, s, h, d] projections of
// the model are read and written in place with no transpose copies. Both
// kernels keep f32 running max and sum in base 2, round P to bf16 before
// P V (hi/lo parts for f32), give masked keys exactly zero weight, floor l
// at 1e-30 and so give an item with no valid key an all-zero output.
//
// The key bias is a compile-time flag: flash_wgmma_bias_kernel and
// flash_f32_bias_kernel are the two kernels with kBias set, and the
// unbiased kernels compile as they did without it. Where a kernel forms a
// chunk's validity word, its producer also writes the chunk's 64 biases,
// times log2(e), to a ring in shared memory, with -inf for a key out of
// range or masked; chunk_softmax adds them to s * scale_log2 before the row
// max, since a bias a key does not commute with the max as the positive
// scale does.
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
//   - f32 (SelfMask, the f32 image bank, the f32 checks):
//     flash_f32_kernel, on the same TMA, mbarriers and wgmma. Inputs are
//     split into bf16 high and low parts (x = hi + lo) and each product takes
//     three bf16 wgmma (hi*hi + hi*lo + lo*hi), which keeps about 16 mantissa
//     bits: close to f32 attention without a slow f32 datapath. A producer
//     warpgroup splits each f32 K/V chunk once for two consumer warpgroups;
//     calls too small to fill the card split their keys into ranges and
//     merge them in flash_combine_kernel (design note at the kernel).

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
//
// At d 256 (the RN50/RN101 decoders, 8 heads over 2048 channels) the same
// block takes another shape, chosen at compile time by D:
//   - Q stays in shared memory and S = Q K^T reads it through a descriptor
//     (SS wgmma, qk_issue_ss): as A fragments it would cost 64 registers a
//     thread beside O's 64 x 256 f32 accumulator (128), S (32) and P (16),
//     past ptxas's 255. O += P V is one m64n256k16 a 16-key step.
//   - A K or V chunk is 32 KB, so the ring holds kFlashStagesWide = 3
//     stages: Q and three stages of K and V take 224 KB, the key biases
//     1.5 KB more, and one block fits an SM (__launch_bounds__ min 1).
//     Bound by bytes at the decoder's shapes (~128 FLOP a byte), with 128
//     blocks for 132 SMs.
// ---------------------------------------------------------------------------

using hopper::kChunkRows;
using hopper::kSmemLimit;
constexpr int kFlashStages = 4;          // K/V ring depth at d 64 and 96
constexpr int kFlashStagesWide = 3;      // at d 256, where a chunk is 32 KB
constexpr int kFlashThreads = 128 + 32;  // a consumer warpgroup and the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBiasSlotBytes = kChunkRows * 4;  // one chunk's 64 f32 key biases

// Key-bias slots in a ring twice as deep as the K ring it rides beside: the
// last reader of chunk j's slot, the softmax of chunk j - 2 * stages, comes
// before the consumers release chunk j - 1 - stages, which the producer
// has waited for before it writes chunk j's biases.
__host__ __device__ constexpr int bias_slots(int stages) { return 2 * stages; }

__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// A warp writes one chunk's key biases into the slot at `slot`: lane i
// those of keys k0 + i and k0 + i + 32, times log2(e), or -inf where the
// key is out of range or masked (ok0, ok1 false).
__device__ __forceinline__ void store_chunk_bias(uint32_t slot, const float* bias, int k0, bool ok0, bool ok1) {
  const int lane = threadIdx.x & 31;
  st_shared_f32(slot + 4 * lane, ok0 ? bias[k0 + lane] * kLog2e : -CUDART_INF_F);
  st_shared_f32(slot + 4 * (lane + 32), ok1 ? bias[k0 + lane + 32] * kLog2e : -CUDART_INF_F);
}

__host__ __device__ constexpr int flash_chunks(int sk) { return (sk + kChunkRows - 1) / kChunkRows; }

// The K/V ring's depth and the blocks an SM holds at head dim d, and
// whether the consumers read Q from shared memory (d 256) rather than from
// registers.
__host__ __device__ constexpr bool flash_wide(int d) { return d > 128; }
__host__ __device__ constexpr int flash_stages(int d) { return flash_wide(d) ? kFlashStagesWide : kFlashStages; }
__host__ __device__ constexpr int flash_min_blocks(int d) { return flash_wide(d) ? 1 : 2; }

// Byte offsets into a block's dynamic shared memory (mirrored by
// ops/flash_attention.py::smem_layout): the Q tile, S = flash_stages(d) K
// chunks, S V chunks, every one a multiple of 4 KB from the 1 KB-aligned
// base; then a 64-bit key-validity word per stage and the mbarriers q_full,
// k_full[S], k_empty[S], v_full[S], v_empty[S]; the biased kernel appends
// bias_slots(S) chunks' key biases.
struct FlashLayout {
  int q, k, v, valid, bars, bias, total;
};

__host__ __device__ constexpr FlashLayout flash_layout(int d, bool bias = false) {
  const int c = hopper::chunk_bytes(d), s = flash_stages(d);
  const int k = c, v = k + s * c, valid = v + s * c;
  const int bars = valid + s * 8, end = bars + (1 + 4 * s) * 8;
  return FlashLayout{0, k, v, valid, bars, end, end + (bias ? bias_slots(s) * kBiasSlotBytes : 0)};
}

template <int S>
struct FlashBars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (1 + S + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (1 + 2 * S + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (1 + 3 * S + s); }
};

// The producer warp: lane 0 issues every TMA load of the block; the warp
// computes each chunk's key validity (and with kBias writes its biases)
// while lane 0 waits for a free stage.
template <int D, bool kBias>
__device__ void flash_producer(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv, const Params& p,
                               const float* key_bias, uint32_t base, const FlashLayout& lay,
                               const FlashBars<flash_stages(D)>& bar, int bi, int hi, int q0) {
  constexpr uint32_t kChunk = hopper::chunk_bytes(D);
  constexpr int kStages = flash_stages(D);
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
    const int s = j % kStages;
    const uint32_t parity = ((j / kStages) + 1) & 1;  // the release of chunk j - kStages
    const int c0 = j * kChunkRows + lane, c1 = c0 + 32;
    const bool ok0 = c0 < p.sk && (mask == nullptr || mask[c0] != 0);
    const bool ok1 = c1 < p.sk && (mask == nullptr || mask[c1] != 0);
    const uint64_t lo = __ballot_sync(0xffffffffu, ok0), hi_bits = __ballot_sync(0xffffffffu, ok1);
    const uint64_t valid = lo | (hi_bits << 32);
    if constexpr (kBias) {
      // the slot is free since the k_empty wait of the iteration before
      // (bias_slots); released with lane 0's arrive below
      store_chunk_bias(base + lay.bias + (j % bias_slots(kStages)) * kBiasSlotBytes,
                       key_bias + static_cast<long long>(bi) * p.sk, j * kChunkRows, ok0, ok1);
      __syncwarp();
    }
    if (lane == 0) {
      if (j >= kStages) hopper::mbar_wait(bar.k_empty(s), parity);
      // released with the arrive below, acquired by the consumers' k_full wait
      hopper::st_shared_u64(base + lay.valid + 8 * s, valid);
      hopper::mbar_arrive_expect_tx(bar.k_full(s), kChunk);
      hopper::load_chunk<D>(base + lay.k + s * kChunk, tk, bar.k_full(s), j * kChunkRows, hi, bi);
      if (j >= kStages) hopper::mbar_wait(bar.v_empty(s), parity);
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
// With kBias, s becomes s * scale_log2 + the key's bias from the chunk's
// slot at `bias` (-inf for a key out of range or masked, so `valid` is not
// read) before the max, and p = exp2(s - m_new).
template <bool kBias>
__device__ __forceinline__ void chunk_softmax(float (&s)[kChunkRows / 8][4], uint64_t valid, float scale_log2,
                                              float (&m)[2], float (&l)[2], float (&alpha)[2], uint32_t bias) {
  const int t = threadIdx.x & 3;
  if constexpr (kBias) {
#pragma unroll
    for (int nn = 0; nn < kChunkRows / 8; ++nn) {
      const float2 b = ld_shared_f32x2(bias + 4 * (nn * 8 + 2 * t));
      s[nn][0] = fmaf(s[nn][0], scale_log2, b.x);
      s[nn][1] = fmaf(s[nn][1], scale_log2, b.y);
      s[nn][2] = fmaf(s[nn][2], scale_log2, b.x);
      s[nn][3] = fmaf(s[nn][3], scale_log2, b.y);
    }
  } else if (valid != ~0ull) {
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
    // scale_log2 > 0: the max commutes with it; a bias is in s already
    const float m_new = fmaxf(m[r], kBias ? mx[r] : mx[r] * scale_log2);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nn][e] = kBias ? exp2f(s[nn][e] + neg_m[e >> 1]) : exp2f(fmaf(s[nn][e], scale_log2, neg_m[e >> 1]));
      l[e >> 1] += s[nn][e];
    }
  }
}

// S = Q K^T of one K chunk: Q from the A fragments `qa` at d 64 and 96, from
// its tile in shared memory at d 256 (qa unused there).
template <int D>
__device__ __forceinline__ void flash_qk(float (&s)[kChunkRows / 8][4], const uint32_t (&qa)[flash_wide(D) ? 1 : D / 16][4],
                                         uint32_t q_tile, uint32_t k_chunk) {
  if constexpr (flash_wide(D)) {
    hopper::qk_issue_ss<D>(s, q_tile, k_chunk);
  } else {
    hopper::qk_issue<D>(s, qa, k_chunk);
  }
}

// The consumer warpgroup: its 64 query rows against every key chunk.
template <int D, bool kBias>
__device__ void flash_consumer(const Params& p, uint32_t base, const FlashLayout& lay,
                               const FlashBars<flash_stages(D)>& bar, int bi, int hi, int q0) {
  constexpr uint32_t kChunk = hopper::chunk_bytes(D);
  constexpr int kStages = flash_stages(D);
  const int n = flash_chunks(p.sk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto k_chunk = [&](int j) { return base + lay.k + (j % kStages) * kChunk; };
  auto v_chunk = [&](int j) { return base + lay.v + (j % kStages) * kChunk; };
  auto valid = [&](int j) { return hopper::ld_shared_u64(base + lay.valid + 8 * (j % kStages)); };
  auto parity = [](int j) { return static_cast<uint32_t>((j / kStages) & 1); };
  auto bias = [&](int j) { return base + lay.bias + (j % bias_slots(kStages)) * kBiasSlotBytes; };

  // Q as A fragments (at d 256 read from its tile by each product); rows
  // past sq arrived as zeros
  hopper::mbar_wait(bar.q_full(), 0);
  uint32_t qa[flash_wide(D) ? 1 : D / 16][4];
  const uint32_t q_tile = base + lay.q;
  if constexpr (!flash_wide(D)) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[ks][i] = hopper::ld_chunk_pair(q_tile, warp * 16 + g + (i & 1) * 8, ks * 16 + 2 * t + (i >> 1) * 8);
      }
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
  flash_qk<D>(s, qa, q_tile, k_chunk(0));
  uint64_t bits = valid(0);
  hopper::wgmma_wait<0>();
  hopper::warp_arrive(bar.k_empty(0));
  chunk_softmax<kBias>(s, bits, p.scale_log2, m, l, alpha, bias(0));
  hopper::pack_p(pa, s);
  for (int j = 1; j < n; ++j) {
    hopper::mbar_wait(bar.k_full(j % kStages), parity(j));
    flash_qk<D>(s, qa, q_tile, k_chunk(j));
    hopper::mbar_wait(bar.v_full((j - 1) % kStages), parity(j - 1));
    hopper::pv_issue<D>(acc, pa, v_chunk(j - 1));
    bits = valid(j);
    hopper::wgmma_wait<1>();  // Q K^T of chunk j is done
    hopper::warp_arrive(bar.k_empty(j % kStages));
    chunk_softmax<kBias>(s, bits, p.scale_log2, m, l, alpha, bias(j));
    hopper::wgmma_wait<0>();  // P V of chunk j - 1 is done with pa and V
    hopper::fence_operands(acc);
    hopper::warp_arrive(bar.v_empty((j - 1) % kStages));
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      acc[nn][0] *= alpha[0];
      acc[nn][1] *= alpha[0];
      acc[nn][2] *= alpha[1];
      acc[nn][3] *= alpha[1];
    }
    hopper::pack_p(pa, s);
  }
  hopper::mbar_wait(bar.v_full((n - 1) % kStages), parity(n - 1));
  hopper::pv_issue<D>(acc, pa, v_chunk(n - 1));
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
  hopper::warp_arrive(bar.v_empty((n - 1) % kStages));

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

// The block of flash_wgmma_kernel (kBias false) and flash_wgmma_bias_kernel.
template <int D, bool kBias>
__device__ __forceinline__ void flash_wgmma_block(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                                  const Params& p, const float* key_bias, unsigned char* flash_smem) {
  const uint32_t base = hopper::smem_u32(flash_smem);
  const FlashLayout lay = flash_layout(D, kBias);
  const FlashBars<flash_stages(D)> bar{base + static_cast<uint32_t>(lay.bars)};
  if (threadIdx.x == 0) {
    if (base % 1024 != 0) __trap();  // the swizzled tiles need the pattern's alignment
    hopper::mbar_init(bar.q_full(), 1);
    for (int s = 0; s < flash_stages(D); ++s) {
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
    flash_producer<D, kBias>(tq, tk, tv, p, key_bias, base, lay, bar, bi, hi, q0);
  } else {
    flash_consumer<D, kBias>(p, base, lay, bar, bi, hi, q0);
  }
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads, flash_min_blocks(D))
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ __align__(1024) unsigned char flash_smem[];
  flash_wgmma_block<D, false>(&tq, &tk, &tv, p, nullptr, flash_smem);
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads, flash_min_blocks(D))
    flash_wgmma_bias_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const Params p, const float* key_bias) {
  extern __shared__ __align__(1024) unsigned char flash_smem[];
  flash_wgmma_block<D, true>(&tq, &tk, &tv, p, key_bias, flash_smem);
}

template <int D>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[3], const Params& p, const float* key_bias, int b, int h,
                         cudaStream_t stream) {
  // the attribute is per function: raising it to the limit once covers
  // every launch
  static const cudaError_t configured =
      cudaFuncSetAttribute(flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  static const cudaError_t configured_bias =
      cudaFuncSetAttribute(flash_wgmma_bias_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (configured != cudaSuccess) return configured;
  if (configured_bias != cudaSuccess) return configured_bias;
  const dim3 grid((p.sq + kChunkRows - 1) / kChunkRows, h, b);
  if (key_bias != nullptr) {
    flash_wgmma_bias_kernel<D>
        <<<grid, kFlashThreads, flash_layout(D, true).total, stream>>>(maps[0], maps[1], maps[2], p, key_bias);
  } else {
    flash_wgmma_kernel<D><<<grid, kFlashThreads, flash_layout(D).total, stream>>>(maps[0], maps[1], maps[2], p);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: flash_f32_kernel
//
// Numerics. Every product a·b takes three bf16 wgmma on hi/lo splits (x = hi
// + lo, hi = bf16(x), lo = bf16(x - hi)): a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,
// f32 accumulation, which keeps about 16 mantissa bits. Q and P are split in
// registers as A operands; K and V are split once per chunk into bf16 tiles in
// shared memory, because wgmma reads B only from there and only in bf16.
//
// Design (Hopper). What bounds it is shared memory, not the tensor cores: at
// d 64 a 64-key chunk costs each 64-row warpgroup 48 KB of wgmma B reads (six
// products on 8 KB tiles) beside ~770 cycles of tensor-core work, and
// splitting the chunk's f32 K and V costs 64 KB more (read 32 KB, write 32
// KB) on top of the 32 KB TMA writes. So the split is shared: a block is a
// producer warpgroup and kNC consumer warpgroups of 64 query rows each (2,
// 128 rows, at d 64 for sq > 64; 1 for the 20-query SelfMask shapes and at d
// 96), FlashAttention-3 style.
//   - Blocks are persistent: one an SM walks the tiles (a tile is kNC x 64
//     query rows of one head against one key range), so the producer runs
//     ahead into a block's next tile while its consumers finish the last.
//   - The producer warpgroup's thread 0 loads a tile's f32 Q rows (one TMA
//     box of 64 rows x d per consumer, rows past sq as zeros) as it starts
//     the tile, and every f32 K and V chunk (the same boxes, keys past sk as
//     zeros) into a ring of kF32Stages, completing on kf_full / vf_full. The
//     whole warpgroup then splits each chunk into a bf16 hi and a bf16 lo
//     tile of the split ring (kSplitStages), written in the exact
//     64-byte-swizzled layout in which TMA lays out a bf16 chunk
//     (hopper.cuh), so the bf16 kernel's K-major (K) and MN-major (V)
//     descriptors read them unchanged (split_chunk: no bank conflicts, one
//     offset for every pass). Each thread fences its writes to the async
//     proxy (fence.proxy.async) before a named barrier of the warpgroup,
//     after which thread 0 arrives on k_full / v_full and reuses the f32
//     stage for the chunk kF32Stages further. K and V go apart, so that Q
//     K^T starts while V is being split. The first warp writes each chunk's
//     key validity (in range, not masked) as one 64-bit word.
//   - setmaxnreg moves registers from the producer (kProducerRegs) to the two
//     consumers (kConsumerRegs): S and O accumulators and the Q and P hi/lo
//     fragments take ~214 a thread at d 64 (ptxas). At d 96 they take ~240,
//     so d 96 keeps one consumer a block and needs no setmaxnreg; only the
//     f32 checks run d 96.
//   - A consumer warpgroup splits its 64 Q rows into A fragments once a
//     tile, then runs the bf16 kernel's loop: Q K_j^T and P_{j-1} V_{j-1}
//     issued together as two wgmma groups (12 and 12 or 18 and 12
//     instructions), chunk j's online softmax (chunk_softmax) while P V is on
//     the tensor cores, O rescaled and P split after its wait.
//   - Split keys: a call whose b·h·q-tile tiles cannot fill the card cuts
//     the keys into ranges of `per` chunks, one block a tile. Such a block
//     writes its unnormalised O, running max m (base 2) and sum l to an f32
//     workspace, and flash_combine_kernel merges the ranges.
// Tried on an H100 and not kept, as they did not make it faster (PERF.md):
// deeper rings, the two consumers taking turns at the tensor cores, and
// narrow products for a last chunk of <= 16 keys.
// ---------------------------------------------------------------------------

constexpr int kF32Stages = 2;     // f32 K and V chunks in the TMA ring
constexpr int kSplitStages = 2;   // bf16 hi/lo K and V tiles in the split ring
constexpr int kProducerRegs = 56;   // setmaxnreg of the producer warpgroup
constexpr int kConsumerRegs = 224;  // and of each consumer (56 + 2 * 224 = 504 = 65,536 / 128)

__host__ __device__ constexpr int f32_chunk_bytes(int d) { return 4 * kChunkRows * d; }
__host__ __device__ constexpr int f32_threads(int nc) { return 128 * (nc + 1); }

// What one launch covers: `tiles` tiles, each kNC x 64 query rows of one
// (batch, head) against one key range of `per` chunks, numbered with the q
// tile fastest, then the range, head and batch. Block x takes tiles x, x +
// gridDim.x, ... In the split path (splits > 1) a block takes one tile and
// writes its unnormalised O rows to o_part [splits, b, h, sq, d] and (m, l)
// to ml [splits, b, h, sq, 2], both f32 and contiguous; null when the call
// is not split.
struct F32Params {
  float* o_part;
  float* ml;
  int per, splits, b, h, q_tiles, tiles;
};

struct F32Tile {
  int bi, hi, q0, split, c0, n;  // key chunks c0 .. c0 + n - 1
};

template <int kNC>
__device__ __forceinline__ F32Tile f32_tile(const Params& p, const F32Params& fp, int t) {
  const int chunks = flash_chunks(p.sk);
  F32Tile tile;
  tile.q0 = (t % fp.q_tiles) * kNC * kChunkRows;
  t /= fp.q_tiles;
  tile.split = t % fp.splits;
  t /= fp.splits;
  tile.hi = t % fp.h;
  tile.bi = t / fp.h;
  tile.c0 = min(tile.split * fp.per, chunks);
  tile.n = min(tile.c0 + fp.per, chunks) - tile.c0;
  return tile;
}

// Consumer warpgroups (of 64 query rows) in a block of the f32 kernel: two
// at d 64 for sq > 64, else one (ops/flash_attention.py::block_rows). At d 96
// a consumer needs ~240 registers, more than setmaxnreg can give two.
__host__ __device__ constexpr int f32_consumers(int sq, int d) { return d == 64 && sq > kChunkRows ? 2 : 1; }

// Byte offsets into a block's dynamic shared memory (mirrored by
// ops/flash_attention.py::f32_smem_layout): the f32 Q rows of a tile (one
// 64-row TMA box per consumer: two at d 64, one at d 96), kF32Stages f32 K
// chunks and as many V chunks, then kSplitStages bf16 tiles each of K hi, K
// lo, V hi and V lo, every one a multiple of 4 KB from the 1 KB-aligned base;
// a 64-bit key-validity word per split stage; the mbarriers kf_full[F],
// vf_full[F], k_full[S], k_empty[S], v_full[S], v_empty[S], q_full, q_empty;
// the biased kernel appends bias_slots(S) chunks' key biases.
struct F32Layout {
  int q, kf, vf, khi, klo, vhi, vlo, valid, bars, bias, total;
};

__host__ __device__ constexpr F32Layout f32_layout(int d, bool bias = false) {
  const int f = f32_chunk_bytes(d), c = hopper::chunk_bytes(d);
  const int kf = f32_consumers(2 * kChunkRows, d) * f, vf = kf + kF32Stages * f, khi = vf + kF32Stages * f;
  const int klo = khi + kSplitStages * c, vhi = klo + kSplitStages * c, vlo = vhi + kSplitStages * c;
  const int valid = vlo + kSplitStages * c, bars = valid + kSplitStages * 8;
  const int end = bars + (2 * kF32Stages + 4 * kSplitStages + 2) * 8;
  const int total = end + (bias ? bias_slots(kSplitStages) * kBiasSlotBytes : 0);
  return F32Layout{0, kf, vf, khi, klo, vhi, vlo, valid, bars, end, total};
}

struct F32Bars {
  uint32_t base;
  __device__ uint32_t kf_full(int f) const { return base + 8 * f; }
  __device__ uint32_t vf_full(int f) const { return base + 8 * (kF32Stages + f); }
  __device__ uint32_t k_full(int s) const { return base + 8 * (2 * kF32Stages + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (2 * kF32Stages + kSplitStages + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (2 * kF32Stages + 2 * kSplitStages + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (2 * kF32Stages + 3 * kSplitStages + s); }
  __device__ uint32_t q_full() const { return base + 8 * (2 * kF32Stages + 4 * kSplitStages); }
  __device__ uint32_t q_empty() const { return base + 8 * (2 * kF32Stages + 4 * kSplitStages + 1); }
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// Two values as a bf16x2 operand register (first value in the low half) and
// the bf16x2 register of what bf16 rounding left over.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// The producer warpgroup's own barrier (id 1; __syncthreads is 0).
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// The f32 chunk at `src` (64 rows of D floats, as TMA wrote it) as bf16 tiles
// hi and lo in the chunk layout of hopper.cuh (D / 32 boxes of 64 rows x 32
// columns, 64-byte swizzle), by the 128 threads of the producer warpgroup.
// Thread t takes columns 4 (t % 8) .. + 3 of a box in rows t / 8 + 16 p (p
// < 4) of every box: one 16-byte f32 read (8 threads read 128 contiguous
// bytes) and 8 bytes to each tile, so 16 threads write two whole 64-byte box
// rows, one 128-byte line that the swizzle only permutes: no bank conflict.
// A pass of 16 rows is 1 KB, a multiple of the swizzle's 512-byte period,
// so one swizzled offset serves every pass and box.
template <int D>
__device__ __forceinline__ void split_chunk(uint32_t src, uint32_t hi, uint32_t lo, int tid) {
  constexpr int kPassRows = 128 / 8;
  static_assert(kChunkRows % kPassRows == 0 && D % hopper::kBoxCols == 0, "passes must tile the chunk");
  const int r = tid >> 3, q = tid & 7;
  const uint32_t from = src + r * D * 4 + q * 16;
  const uint32_t to = hopper::swizzle_64b(r * hopper::kRowStrideBytes + q * 8);  // hi, lo: 4 KB-aligned
#pragma unroll
  for (int box = 0; box < D / hopper::kBoxCols; ++box) {
#pragma unroll
    for (int pass = 0; pass < kChunkRows / kPassRows; ++pass) {
      float x0, x1, x2, x3;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3)
                   : "r"(from + pass * kPassRows * D * 4 + box * hopper::kBoxCols * 4)
                   : "memory");
      uint32_t h0, l0, h1, l1;
      split(x0, x1, h0, l0);
      split(x2, x3, h1, l1);
      const uint32_t off = to + box * hopper::kBoxBytes + pass * kPassRows * hopper::kRowStrideBytes;
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(hi + off), "r"(h0), "r"(h1) : "memory");
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(lo + off), "r"(l0), "r"(l1) : "memory");
    }
  }
}

// The producer warpgroup over every key chunk of the block's tiles in turn,
// running ahead into the next tile while the consumers finish one. Every
// tile of a block has the same n chunks: all of them unsplit, and a split
// launch gives each block one tile. With kBias its first warp writes each
// chunk's biases beside the validity word.
template <int D, int kNC, bool kBias>
__device__ void f32_producer(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv, const Params& p,
                             const F32Params& fp, const float* key_bias, uint32_t base, const F32Layout& lay,
                             const F32Bars& bar) {
  constexpr uint32_t kF32Chunk = f32_chunk_bytes(D);
  constexpr uint32_t kTile = hopper::chunk_bytes(D);
  const int tid = threadIdx.x - 128 * kNC, lane = tid & 31;
  // a cursor over the block's chunks: its tile decoded once, on entering it
  struct Cursor {
    int t, j;
    F32Tile tile;
  };
  auto start = [&]() { return Cursor{static_cast<int>(blockIdx.x), 0, f32_tile<kNC>(p, fp, blockIdx.x)}; };
  auto advance = [&](Cursor& c) {
    if (++c.j == c.tile.n) {
      c.j = 0;
      c.t += gridDim.x;
      if (c.t < fp.tiles) c.tile = f32_tile<kNC>(p, fp, c.t);
    }
  };
  const int n = f32_tile<kNC>(p, fp, blockIdx.x).n;
  const int items = n * ((fp.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto load = [&](const CUtensorMap* map, int area, uint32_t full, int g, const Cursor& c) {  // thread 0
    hopper::mbar_arrive_expect_tx(full, kF32Chunk);
    hopper::tma_load_4d(base + area + (g % kF32Stages) * kF32Chunk, map, full, 0, (c.tile.c0 + c.j) * kChunkRows,
                        c.tile.hi, c.tile.bi);
  };
  Cursor at = start(), ahead = start();  // chunk g, and the chunk kF32Stages further that TMA loads
  if (tid == 0) {
    hopper::prefetch_tensormap(tq);
    hopper::prefetch_tensormap(tk);
    hopper::prefetch_tensormap(tv);
  }
  int tiles_begun = 0;
  for (int g = 0; g < kF32Stages && g < items; ++g) {
    if (tid == 0) {
      load(tk, lay.kf, bar.kf_full(g), g, ahead);
      load(tv, lay.vf, bar.vf_full(g), g, ahead);
    }
    advance(ahead);
  }
  for (int g = 0; g < items; ++g) {
    const int f = g % kF32Stages, s = g % kSplitStages;
    const uint32_t f_parity = (g / kF32Stages) & 1;
    const uint32_t e_parity = ((g / kSplitStages) + 1) & 1;  // the release of chunk g - kSplitStages
    const bool more = g + kF32Stages < items;
    if (at.j == 0 && tid == 0) {  // a tile begins: its Q rows, once the last tile's are read
      if (tiles_begun > 0) hopper::mbar_wait(bar.q_empty(), (tiles_begun - 1) & 1);
      hopper::mbar_arrive_expect_tx(bar.q_full(), kNC * kF32Chunk);
      for (int w = 0; w < kNC; ++w) {
        hopper::tma_load_4d(base + lay.q + w * kF32Chunk, tq, bar.q_full(), 0, at.tile.q0 + w * kChunkRows,
                            at.tile.hi, at.tile.bi);
      }
    }
    tiles_begun += at.j == 0;

    hopper::mbar_wait(bar.kf_full(f), f_parity);
    if (g >= kSplitStages) hopper::mbar_wait(bar.k_empty(s), e_parity);
    split_chunk<D>(base + lay.kf + f * kF32Chunk, base + lay.khi + s * kTile, base + lay.klo + s * kTile, tid);
    if (tid < 32) {
      const int* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(at.tile.bi) * p.sk;
      const int k0 = (at.tile.c0 + at.j) * kChunkRows + lane, k1 = k0 + 32;
      const bool ok0 = k0 < p.sk && (mask == nullptr || mask[k0] != 0);
      const bool ok1 = k1 < p.sk && (mask == nullptr || mask[k1] != 0);
      const uint64_t lo = __ballot_sync(0xffffffffu, ok0), hi = __ballot_sync(0xffffffffu, ok1);
      if (lane == 0) hopper::st_shared_u64(base + lay.valid + 8 * s, lo | (hi << 32));
      if constexpr (kBias) {  // the slot is free since this chunk's k_empty wait (bias_slots)
        store_chunk_bias(base + lay.bias + (g % bias_slots(kSplitStages)) * kBiasSlotBytes,
                         key_bias + static_cast<long long>(at.tile.bi) * p.sk, k0 - lane, ok0, ok1);
      }
    }
    hopper::fence_proxy_async();  // the tiles, to wgmma; the f32 stage's reads, before TMA refills it
    producer_sync();
    if (tid == 0) {
      hopper::mbar_arrive(bar.k_full(s));
      if (more) load(tk, lay.kf, bar.kf_full(f), g + kF32Stages, ahead);
    }

    hopper::mbar_wait(bar.vf_full(f), f_parity);
    if (g >= kSplitStages) hopper::mbar_wait(bar.v_empty(s), e_parity);
    split_chunk<D>(base + lay.vf + f * kF32Chunk, base + lay.vhi + s * kTile, base + lay.vlo + s * kTile, tid);
    hopper::fence_proxy_async();
    producer_sync();
    if (tid == 0) {
      hopper::mbar_arrive(bar.v_full(s));
      if (more) load(tv, lay.vf, bar.vf_full(f), g + kF32Stages, ahead);
    }
    advance(at);
    if (more) advance(ahead);
  }
}

// Issue S[64 x 64] = Q K^T as one wgmma group of three products a K step:
// Q_hi K_hi, Q_hi K_lo, Q_lo K_hi (K-major tiles, as qk_issue reads them).
template <int D>
__device__ __forceinline__ void qk3_issue(float (&s)[kChunkRows / 8][4], const uint32_t (&qh)[D / 16][4],
                                          const uint32_t (&ql)[D / 16][4], uint32_t k_hi, uint32_t k_lo) {
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 2) * hopper::kBoxBytes + (ks % 2) * 32;
    const uint64_t dh = hopper::smem_desc(k_hi + off, 16, hopper::kGroupStrideBytes, hopper::kSwizzle64B);
    const uint64_t dl = hopper::smem_desc(k_lo + off, 16, hopper::kGroupStrideBytes, hopper::kSwizzle64B);
    hopper::WgmmaRS<kChunkRows>::template mma<0>(s, qh[ks], dh, ks > 0);
    hopper::WgmmaRS<kChunkRows>::template mma<0>(s, qh[ks], dl, 1);
    hopper::WgmmaRS<kChunkRows>::template mma<0>(s, ql[ks], dh, 1);
  }
  hopper::wgmma_commit();
}

// Issue acc[64 x D] += P V as one wgmma group of three products a K step:
// P_hi V_hi, P_hi V_lo, P_lo V_hi (MN-major tiles, as pv_issue reads them).
template <int D>
__device__ __forceinline__ void pv3_issue(float (&acc)[D / 8][4], const uint32_t (&ph)[kChunkRows / 16][4],
                                          const uint32_t (&pl)[kChunkRows / 16][4], uint32_t v_hi, uint32_t v_lo) {
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunkRows / 16; ++c) {
    hopper::pv_step<D>(acc, ph[c], v_hi, c);
    hopper::pv_step<D>(acc, ph[c], v_lo, c);
    hopper::pv_step<D>(acc, pl[c], v_hi, c);
  }
  hopper::wgmma_commit();
}

// p split into the hi and lo A fragments of P V (pack_p's layout).
__device__ __forceinline__ void split_p(uint32_t (&ph)[kChunkRows / 16][4], uint32_t (&pl)[kChunkRows / 16][4],
                                        const float (&s)[kChunkRows / 8][4]) {
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
    split(s[nn][0], s[nn][1], ph[nn / 2][2 * (nn % 2)], pl[nn / 2][2 * (nn % 2)]);
    split(s[nn][2], s[nn][3], ph[nn / 2][2 * (nn % 2) + 1], pl[nn / 2][2 * (nn % 2) + 1]);
  }
}

// A consumer warpgroup: its 64 query rows of each of the block's tiles
// against the tile's key chunks. The split rings and the Q barriers count
// the block's chunks and tiles across its tiles, as the producer does.
template <int D, int kNC, bool kBias>
__device__ void f32_consumer(const Params& p, const F32Params& fp, uint32_t base, const F32Layout& lay,
                             const F32Bars& bar) {
  constexpr uint32_t kTile = hopper::chunk_bytes(D);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto tile = [&](int area, int c) { return base + area + (c % kSplitStages) * kTile; };
  auto valid = [&](int c) { return hopper::ld_shared_u64(base + lay.valid + 8 * (c % kSplitStages)); };
  auto parity = [](int c) { return static_cast<uint32_t>((c / kSplitStages) & 1); };
  auto bias = [&](int c) { return base + lay.bias + (c % bias_slots(kSplitStages)) * kBiasSlotBytes; };
  int c0 = 0, tiles_begun = 0;  // chunks and tiles (with chunks) of the block's earlier tiles
  for (int ti = blockIdx.x; ti < fp.tiles; ti += gridDim.x) {
    const F32Tile tl = f32_tile<kNC>(p, fp, ti);
    const int row_a = tl.q0 + wg * kChunkRows + warp * 16 + g, row_b = row_a + 8;
    const int n = tl.n;

    // Q rows as split A fragments, from the f32 rows TMA brought (rows past
    // sq are zeros); a range with no chunk has no Q either
    uint32_t qh[D / 16][4], ql[D / 16][4];
    if (n > 0) {
      hopper::mbar_wait(bar.q_full(), tiles_begun & 1);
      const uint32_t q = base + lay.q + wg * f32_chunk_bytes(D) + (warp * 16 + g) * D * 4;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x0, x1;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                       : "=f"(x0), "=f"(x1)
                       : "r"(q + ((i & 1) * 8 * D + ks * 16 + 2 * t + (i >> 1) * 8) * 4)
                       : "memory");
          split(x0, x1, qh[ks][i], ql[ks][i]);
        }
      }
      hopper::fence_proxy_async();  // the reads, before TMA writes the next tile's Q
      hopper::warp_arrive(bar.q_empty());
      ++tiles_begun;
    }

    float acc[D / 8][4];
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
    float s[kChunkRows / 8][4] = {};
    uint32_t ph[kChunkRows / 16][4], pl[kChunkRows / 16][4];
    float m[2] = {-1e30f, -1e30f};  // running max of the scaled logits (base 2)
    float l[2] = {0.f, 0.f};
    float alpha[2];

    if (n > 0) {  // a key range past the last chunk has nothing to read
      // chunk 0: O is still zero, so it needs no P V beside it
      hopper::mbar_wait(bar.k_full(c0 % kSplitStages), parity(c0));
      qk3_issue<D>(s, qh, ql, tile(lay.khi, c0), tile(lay.klo, c0));
      uint64_t bits_j = valid(c0);
      hopper::wgmma_wait<0>();
      hopper::warp_arrive(bar.k_empty(c0 % kSplitStages));
      chunk_softmax<kBias>(s, bits_j, p.scale_log2, m, l, alpha, bias(c0));
      split_p(ph, pl, s);
      for (int j = c0 + 1; j < c0 + n; ++j) {
        hopper::mbar_wait(bar.k_full(j % kSplitStages), parity(j));
        qk3_issue<D>(s, qh, ql, tile(lay.khi, j), tile(lay.klo, j));
        hopper::mbar_wait(bar.v_full((j - 1) % kSplitStages), parity(j - 1));
        pv3_issue<D>(acc, ph, pl, tile(lay.vhi, j - 1), tile(lay.vlo, j - 1));
        bits_j = valid(j);
        hopper::wgmma_wait<1>();  // Q K^T of chunk j is done
        hopper::warp_arrive(bar.k_empty(j % kSplitStages));
        chunk_softmax<kBias>(s, bits_j, p.scale_log2, m, l, alpha, bias(j));
        hopper::wgmma_wait<0>();  // P V of chunk j - 1 is done with ph, pl and V
        hopper::fence_operands(acc);
        hopper::warp_arrive(bar.v_empty((j - 1) % kSplitStages));
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn) {
          acc[nn][0] *= alpha[0];
          acc[nn][1] *= alpha[0];
          acc[nn][2] *= alpha[1];
          acc[nn][3] *= alpha[1];
        }
        split_p(ph, pl, s);
      }
      const int last = c0 + n - 1;
      hopper::mbar_wait(bar.v_full(last % kSplitStages), parity(last));
      pv3_issue<D>(acc, ph, pl, tile(lay.vhi, last), tile(lay.vlo, last));
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      hopper::warp_arrive(bar.v_empty(last % kSplitStages));
    }
    c0 += n;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (fp.o_part == nullptr) {
      float* o = static_cast<float*>(p.o) + tl.bi * p.o_sb + tl.hi * p.o_sh;
      const float inv_a = 1.f / fmaxf(l[0], 1e-30f), inv_b = 1.f / fmaxf(l[1], 1e-30f);  // no valid key: 0
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        const int col = nn * 8 + 2 * t;
        if (row_a < p.sq) {
          *reinterpret_cast<float2*>(o + row_a * p.o_ss + col) = make_float2(acc[nn][0] * inv_a, acc[nn][1] * inv_a);
        }
        if (row_b < p.sq) {
          *reinterpret_cast<float2*>(o + row_b * p.o_ss + col) = make_float2(acc[nn][2] * inv_b, acc[nn][3] * inv_b);
        }
      }
      continue;
    }
    // the split path: unnormalised O, m and l of this key range
    const long long item = (static_cast<long long>(tl.split) * fp.b + tl.bi) * fp.h + tl.hi;
    float* o = fp.o_part + item * p.sq * D;
    float* ml = fp.ml + item * p.sq * 2;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      const int col = nn * 8 + 2 * t;
      if (row_a < p.sq) *reinterpret_cast<float2*>(o + row_a * D + col) = make_float2(acc[nn][0], acc[nn][1]);
      if (row_b < p.sq) *reinterpret_cast<float2*>(o + row_b * D + col) = make_float2(acc[nn][2], acc[nn][3]);
    }
    if (t == 0) {
      if (row_a < p.sq) *reinterpret_cast<float2*>(ml + 2 * row_a) = make_float2(m[0], l[0]);
      if (row_b < p.sq) *reinterpret_cast<float2*>(ml + 2 * row_b) = make_float2(m[1], l[1]);
    }
  }
}

// The block of flash_f32_kernel (kBias false) and flash_f32_bias_kernel.
template <int D, int kNC, bool kBias>
__device__ __forceinline__ void flash_f32_block(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                                const Params& p, const F32Params& fp, const float* key_bias,
                                                unsigned char* flash_f32_smem) {
  const uint32_t base = hopper::smem_u32(flash_f32_smem);
  const F32Layout lay = f32_layout(D, kBias);
  const F32Bars bar{base + static_cast<uint32_t>(lay.bars)};
  if (threadIdx.x == 0) {
    if (base % 1024 != 0) __trap();  // the swizzled tiles need the pattern's alignment
    for (int f = 0; f < kF32Stages; ++f) {
      hopper::mbar_init(bar.kf_full(f), 1);
      hopper::mbar_init(bar.vf_full(f), 1);
    }
    for (int s = 0; s < kSplitStages; ++s) {
      hopper::mbar_init(bar.k_full(s), 1);
      hopper::mbar_init(bar.k_empty(s), 4 * kNC);  // one arrive per consumer warp
      hopper::mbar_init(bar.v_full(s), 1);
      hopper::mbar_init(bar.v_empty(s), 4 * kNC);
    }
    hopper::mbar_init(bar.q_full(), 1);
    hopper::mbar_init(bar.q_empty(), 4 * kNC);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128 * kNC) {
    if constexpr (kNC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    f32_producer<D, kNC, kBias>(tq, tk, tv, p, fp, key_bias, base, lay, bar);
  } else {
    if constexpr (kNC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    f32_consumer<D, kNC, kBias>(p, fp, base, lay, bar);
  }
}

template <int D, int kNC>
__global__ void __launch_bounds__(f32_threads(kNC), 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p, const F32Params fp) {
  extern __shared__ __align__(1024) unsigned char flash_f32_smem[];
  flash_f32_block<D, kNC, false>(&tq, &tk, &tv, p, fp, nullptr, flash_f32_smem);
}

template <int D, int kNC>
__global__ void __launch_bounds__(f32_threads(kNC), 1)
    flash_f32_bias_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p, const F32Params fp,
                          const float* key_bias) {
  extern __shared__ __align__(1024) unsigned char flash_f32_smem[];
  flash_f32_block<D, kNC, true>(&tq, &tk, &tv, p, fp, key_bias, flash_f32_smem);
}

// The split path's second pass, one warp a query row:
//   O = sum_s 2^(m_s - M) O_s / max(sum_s 2^(m_s - M) l_s, 1e-30),
// M the largest m_s over the ranges with l_s > 0. A range with no valid key
// (l_s = 0) gets weight 0 and its m_s is never read into an exponent; a row
// with no valid key at all comes out zero.
template <int D>
__global__ void __launch_bounds__(128) flash_combine_kernel(const Params p, const F32Params fp) {
  constexpr int kPairs = (D / 2 + 31) / 32;  // float2 columns a lane
  const long long rows = static_cast<long long>(fp.b) * fp.h * p.sq;
  const long long row = static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float big_m = -CUDART_INF_F;
  for (int s = 0; s < fp.splits; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(fp.ml + 2 * (s * rows + row));
    if (ml.y > 0.f) big_m = fmaxf(big_m, ml.x);
  }
  float2 acc[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) acc[i] = make_float2(0.f, 0.f);
  float big_l = 0.f;
  for (int s = 0; s < fp.splits; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(fp.ml + 2 * (s * rows + row));
    if (!(ml.y > 0.f)) continue;
    const float w = exp2f(ml.x - big_m);
    big_l = fmaf(w, ml.y, big_l);
    const float* o = fp.o_part + (s * rows + row) * D;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int c = 2 * (lane + 32 * i);
      if (c < D) {
        const float2 x = *reinterpret_cast<const float2*>(o + c);
        acc[i].x = fmaf(w, x.x, acc[i].x);
        acc[i].y = fmaf(w, x.y, acc[i].y);
      }
    }
  }
  const float inv = 1.f / fmaxf(big_l, 1e-30f);
  const int r = static_cast<int>(row % p.sq);
  const long long bh = row / p.sq;
  float* o = static_cast<float*>(p.o) + (bh / fp.h) * p.o_sb + (bh % fp.h) * p.o_sh + r * p.o_ss;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int c = 2 * (lane + 32 * i);
    if (c < D) *reinterpret_cast<float2*>(o + c) = make_float2(acc[i].x * inv, acc[i].y * inv);
  }
}

// The f32 launch: flash_f32_kernel (flash_f32_bias_kernel given a key
// bias), one block an SM walking the tiles (one block a tile when the call
// is split), then the combine when it is split.
template <int D, int kNC>
cudaError_t launch_f32(const CUtensorMap (&maps)[3], const Params& p, F32Params fp, const float* key_bias,
                       cudaStream_t stream) {
  static const cudaError_t configured =
      cudaFuncSetAttribute(flash_f32_kernel<D, kNC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  static const cudaError_t configured_bias =
      cudaFuncSetAttribute(flash_f32_bias_kernel<D, kNC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (configured != cudaSuccess) return configured;
  if (configured_bias != cudaSuccess) return configured_bias;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  fp.q_tiles = (p.sq + kNC * kChunkRows - 1) / (kNC * kChunkRows);
  const long long tiles = static_cast<long long>(fp.q_tiles) * fp.splits * fp.h * fp.b;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  fp.tiles = static_cast<int>(tiles);
  const int blocks = fp.splits > 1 || fp.tiles < sms ? fp.tiles : sms;
  if (key_bias != nullptr) {
    flash_f32_bias_kernel<D, kNC>
        <<<blocks, f32_threads(kNC), f32_layout(D, true).total, stream>>>(maps[0], maps[1], maps[2], p, fp, key_bias);
  } else {
    flash_f32_kernel<D, kNC>
        <<<blocks, f32_threads(kNC), f32_layout(D).total, stream>>>(maps[0], maps[1], maps[2], p, fp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || fp.splits == 1) return err;
  const long long rows = static_cast<long long>(fp.b) * fp.h * p.sq;
  flash_combine_kernel<D><<<static_cast<unsigned>((rows + 3) / 4), 128, 0, stream>>>(p, fp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16 (flash_wgmma_kernel; d 64, 96 or 256), 1 = float32
// (flash_f32_kernel; d 64 or 96);
// with a key_bias [b, sk] f32 (contiguous; null for none), their biased
// instantiations flash_wgmma_bias_kernel and flash_f32_bias_kernel.
// strides: 12 values, the (batch, head, sequence) strides in elements of q,
// k, v and o in that order. bf16 takes 64 query rows a block; f32 takes 128
// (64 for sq <= 64 and at d 96) and reads q, k and v through f32 tensor
// maps.
// splits (f32 only; 1 for bf16): key ranges of one call. Above 1, o_part
// [splits, b, h, sq, d] and ml [splits, b, h, sq, 2] are the f32 workspace
// the caller allocated, and a combine kernel follows the main one. Both read
// tensor maps and need sk >= 1; a map the CUDA driver will not encode returns
// hopper::kErrTensorMapEncode, and a pipeline wait that never completes traps
// the kernel, which fails the launch at the next synchronisation. Returns a
// cudaError_t (0 on success), or cudaErrorInvalidValue for a dtype, head dim,
// size or split count this library does not take. Launches on `stream`,
// allocates nothing and does not synchronise.
int zutis_flash_attention_fwd(const void* q, const void* k, const void* v, const int* kv_mask, const float* key_bias,
                              void* o,
                              int dtype, int b, int h, int sq, int sk, int d, const long long* strides,
                              float scale, int splits, float* o_part, float* ml, void* stream) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 96 && (dtype != 0 || d != 256)) || sk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits < 1 || splits > 65535 || (dtype == 0 && splits != 1) ||
      (splits > 1 && (o_part == nullptr || ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype == 1) {
    CUtensorMap maps[3];
    const int err = hopper::attention_maps(maps, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, q, k, v, b, h, sq, sk, d, strides);
    if (err != 0) return err;
    F32Params fp{};
    fp.o_part = splits > 1 ? o_part : nullptr;
    fp.ml = splits > 1 ? ml : nullptr;
    fp.per = (flash_chunks(sk) + splits - 1) / splits;
    fp.splits = splits;
    fp.b = b;
    fp.h = h;
    if (d == 96) return launch_f32<96, 1>(maps, p, fp, key_bias, s);
    if (f32_consumers(sq, d) == 1) return launch_f32<64, 1>(maps, p, fp, key_bias, s);
    return launch_f32<64, 2>(maps, p, fp, key_bias, s);
  }
  CUtensorMap maps[3];
  const int err = hopper::attention_maps(maps, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, b, h, sq, sk, d, strides);
  if (err != 0) return err;
  if (d == 64) return launch_wgmma<64>(maps, p, key_bias, b, h, s);
  if (d == 96) return launch_wgmma<96>(maps, p, key_bias, b, h, s);
  return launch_wgmma<256>(maps, p, key_bias, b, h, s);
}

// The dynamic shared memory of one block of the kernel of `dtype` at head
// dim d with block_q query rows (bf16: 64; f32: 64, or 128 at d 64), biased
// (bias 1) or not, and the blocks of that kernel an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int zutis_flash_occupancy(int dtype, int d, int block_q, int bias, int* smem_bytes, int* blocks_per_sm) {
  if (d != 64 && d != 96 && (dtype != 0 || d != 256)) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = nullptr;
  int threads = 0;
  if (dtype == 0 && block_q == kChunkRows) {
    if (d == 256) {
      kernel = bias ? reinterpret_cast<const void*>(flash_wgmma_bias_kernel<256>)
                    : reinterpret_cast<const void*>(flash_wgmma_kernel<256>);
    } else {
      kernel = bias ? reinterpret_cast<const void*>(d == 64 ? flash_wgmma_bias_kernel<64> : flash_wgmma_bias_kernel<96>)
                    : reinterpret_cast<const void*>(d == 64 ? flash_wgmma_kernel<64> : flash_wgmma_kernel<96>);
    }
    threads = kFlashThreads;
    *smem_bytes = flash_layout(d, bias != 0).total;
  } else if (dtype == 1 && (block_q == kChunkRows || (d == 64 && block_q == 2 * kChunkRows))) {
    const bool one = block_q == kChunkRows;
    if (bias) {
      kernel = reinterpret_cast<const void*>(
          d == 96 ? flash_f32_bias_kernel<96, 1> : (one ? flash_f32_bias_kernel<64, 1> : flash_f32_bias_kernel<64, 2>));
    } else {
      kernel = reinterpret_cast<const void*>(d == 96 ? flash_f32_kernel<96, 1>
                                                     : (one ? flash_f32_kernel<64, 1> : flash_f32_kernel<64, 2>));
    }
    threads = f32_threads(one ? 1 : 2);
    *smem_bytes = f32_layout(d, bias != 0).total;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, *smem_bytes));
}

const char* zutis_cuda_error_string(int err) {
  const char* own = hopper::error_string(err);
  return own != nullptr ? own : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
