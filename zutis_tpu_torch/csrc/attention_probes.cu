// Attention-tuning probes for Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see zutis_tpu_torch/ops/attention_probes.py).
//
// Two kernels replace the three Pallas probes of tools/pallas_tune.py: `single`
// replaces make_single's, and `maxfree` make_fastsm's and make_kt's. Each
// computes, for q [b, h, sq, d] and k, v [b, h, sk, d] in bf16, the probe's
// function exactly as its JAX `fn` does (wrapper plus kernel), not textbook
// attention:
//   - q is pre-scaled in f32 by d^-1/2 and rounded back to bf16 before the
//     products; the kernels do that as they read q into registers;
//   - the JAX fn pads sk to a multiple of 128 with zero K/V rows and an
//     additive per-key bias. With the "mul" exp mode the padded keys add to
//     the row sum l, so the kernels count ceil(sk/128)*128 - sk virtual padded
//     keys into l without reading any padding from memory;
//   - logits and sums are f32, P is rounded to bf16 for P V.
// The exp modes are compile-time: "exp" (__expf on f32), "mul" (s * 1.0002, a
// timing probe that breaks the softmax on purpose) and "bf16" (round s to
// bf16, expf, round the result to bf16).
//
// What bounds them on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// probes' shape [64, 12, 577, 577, 64] the call moves 227 MB of q, k, v and o
// against 65.5 GFLOP of products, 0.068 ms against 0.066 ms: at the card's
// balance point. Each row also takes sk exponentials on the SFU.
//
// Both kernels run on Hopper's TMA, mbarriers and wgmma (helpers and the
// accumulator layout in hopper.cuh): one producer warp whose one thread
// issues every TMA load, and block_q / 64 consumer warpgroups of 64 query
// rows each. Design notes at each kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"


namespace {

using bf16 = __nv_bfloat16;
using hopper::chunk_bytes;
using hopper::kChunkRows;
using hopper::kSmemLimit;
using hopper::pack_bf16x2;

constexpr int kExp = 0, kMul = 1, kBf16 = 2;
constexpr int kLane = 0, kMxu = 1;
constexpr int kProbeThreads = 2 * 128 + 32;  // block_q 128: two consumer warpgroups + producer

// What the kernels need beside their tensor maps of q, k (or K^T) and v.
struct Params {
  bf16* o;
  long long o_sb, o_sh, o_ss;
  int h, sq, sk;
  int n_pad;  // padded keys of the JAX layout: ceil(sk / 128) * 128 - sk
  float scale;
};

__host__ __device__ constexpr int key_chunks(int sk) { return (sk + kChunkRows - 1) / kChunkRows; }

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The probe's exponential. Products and sums that follow are written with _rn
// intrinsics where the compiler could otherwise contract them into an FMA, so
// that every instantiation rounds alike.
template <int kMode>
__device__ __forceinline__ float probe_exp(float x) {
  if constexpr (kMode == kMul) {
    return __fmul_rn(x, 1.0002f);
  } else if constexpr (kMode == kBf16) {
    return round_bf16(expf(round_bf16(x)));
  } else {
    return __expf(x);
  }
}

// This warp's 16 rows of a warpgroup's Q chunk as wgmma A fragments,
// pre-scaled in f32 and rounded to bf16 as the JAX fn does before its kernel;
// rows past sq arrived as zeros.
template <int D>
__device__ __forceinline__ void scaled_q(uint32_t (&qa)[D / 16][4], uint32_t q_tile, float scale) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + (i & 1) * 8;
      const int c = ks * 16 + 2 * t + (i >> 1) * 8;
      const uint32_t raw = hopper::ld_chunk_pair(q_tile, r, c);
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
      qa[ks][i] = pack_bf16x2(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
    }
  }
}

// The row sums of the accumulator rows g and g + 8 across the 4 lanes of a
// quad.
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// acc / l of this warp's 16 rows (from row0) into o, rows at or past sq
// skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* o, long long ss, int row0, int sq, const float (&acc)[D / 8][4],
                                           const float (&l)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_a = row0 + g, row_b = row_a + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < sq) {
      *reinterpret_cast<uint32_t*>(o + row_a * ss + col) = pack_bf16x2(acc[n][0] / l[0], acc[n][1] / l[0]);
    }
    if (row_b < sq) {
      *reinterpret_cast<uint32_t*>(o + row_b * ss + col) = pack_bf16x2(acc[n][2] / l[1], acc[n][3] / l[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// single: replaces tools/pallas_tune.py::make_single's `kernel` (:54, heads
// unrolled in a cell, or one head per cell) and `kernel_batched` (:76, heads
// batched in one dot). The exact single-shot softmax over the whole key axis:
// s = q k^T + bias (0 on keys, -1e30 on padding), m = row max,
// p = exp_mode(s - m), l = sum of the f32 p, o = (bf16(p) V) / l.
//
// Bound: bytes at both probe shapes, 227 MB in 0.0677 ms at
// [64, 12, 577, 577, 64] and 28 MB in 0.0085 ms at batch 8. The row max needs
// the whole row before any exponential, so the kernel sweeps K twice:
// 6 b h sq sk d tensor operations where a streaming softmax does 4.
//
// Design (Hopper): on the TPU the cell holds K, V and the [block_q, sk_pad]
// f32 logits in VMEM. Here a block is one producer warp and block_q / 64
// consumer warpgroups, each owning 64 query rows.
//   - The producer's one thread loads with TMA (tensor maps over [b, h, s, d]
//     with s's extent sq or sk, so rows past the edge arrive as zeros) in
//     64-row x 32-column boxes with a 64-byte swizzle, each completing on an
//     mbarrier: the Q tile; every 64-key chunk of K into a resident K area,
//     one "full" barrier per chunk, so sweep 1 starts on chunk 0 while the
//     rest lands; and V, which only sweep 2 reads, through a 2-stage ring
//     with full and empty barriers that fills during sweep 1.
//   - Consumers read Q once into wgmma A fragments, pre-scaled in f32 and
//     rounded to bf16, and release its tile. Both products are
//     wgmma.mma_async with A from registers: S = Q K^T (m64n64k16, K chunk
//     K-major through a descriptor) and O += P V (m64n{64,96}k16, the S
//     accumulator rounded to bf16 is P's A fragment, V MN-major). Logits
//     live only as one 64 x 64 f32 accumulator per warpgroup.
//   - Head-loop blocks (the TPU's "unroll" and "batched" cells) own (batch,
//     q tile) and walk the heads: the producer loads head h+1's Q as soon as
//     head h's is in registers, head h+1's K chunk j as soon as sweep 2 of
//     head h has released it, and V straight on through the ring, so no
//     head waits for a whole restage. "grid" blocks own one head. All run
//     the same per-head code, so their outputs are bit-identical.
//   - Both sweeps overlap the exponential work with the tensor cores inside a
//     warpgroup (design at single_consumer), and the block's two warpgroups
//     interleave on the SM.
//   - Shared memory: K (sk rounded up to 64 keys) + Q + 2 V stages, 112 KB at
//     d 64 and sk 577, 168 KB at d 96. With block_q 128, one block per SM:
//     the overlapped sweeps hold two S accumulators and P beside O and Q,
//     122 registers at d 64 and 146-149 at d 96, where two 288-thread blocks
//     would have to fit in 96 and spill. So a block's first K load and last
//     stores overlap only its own two warpgroups' work. block_q 64 (one
//     warpgroup, 160 threads, 104 KB) fits two blocks per SM at d 64, at
//     the cost of loading K once per 64 query rows; persistent blocks would
//     overlap both without that cost.
// ---------------------------------------------------------------------------

// keys per K/V chunk and query rows per warpgroup: hopper.cuh's attention chunks
using hopper::pack_p;
using hopper::pv_issue;
using hopper::qk_issue;
constexpr int kVStages = 2;

// Byte offsets into a `single` block's dynamic shared memory. Every tile area
// is a multiple of 4 KB from the 1 KB-aligned base; the mbarriers follow:
// k_full[n], k_empty[n], q_full, q_empty, v_full[kVStages], v_empty[kVStages].
struct SingleLayout {
  int k, q, v, bars, total;
};

__host__ __device__ constexpr SingleLayout single_layout(int d, int sk, int groups) {
  const int n = key_chunks(sk), c = chunk_bytes(d);
  const int q = n * c, v = q + groups * c, bars = v + kVStages * c;
  return SingleLayout{0, q, v, bars, bars + (2 * n + 2 + 2 * kVStages) * 8};
}

struct SingleBars {
  uint32_t base;
  int n;
  __device__ uint32_t k_full(int j) const { return base + 8 * j; }
  __device__ uint32_t k_empty(int j) const { return base + 8 * (n + j); }
  __device__ uint32_t q_full() const { return base + 8 * (2 * n); }
  __device__ uint32_t q_empty() const { return base + 8 * (2 * n + 1); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (2 * n + 2 + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (2 * n + 2 + kVStages + s); }
};

// The producer: one thread issues every TMA load of the block, in an order in
// which each wait depends only on loads issued before it.
template <int D>
__device__ void single_producer(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv, const Params& p,
                                uint32_t base, const SingleLayout& lay, const SingleBars& bar, int groups, int bi,
                                int head0, int n_heads, int q0) {
  constexpr uint32_t kChunk = chunk_bytes(D);
  const int n = bar.n, items = n * n_heads;  // V items: (head, chunk) in walk order
  hopper::prefetch_tensormap(tq);
  hopper::prefetch_tensormap(tk);
  hopper::prefetch_tensormap(tv);
  auto load_q = [&](int hh) {
    hopper::mbar_arrive_expect_tx(bar.q_full(), groups * kChunk);
    for (int g = 0; g < groups; ++g) {
      const int row0 = q0 + g * kChunkRows;
      // a warpgroup whose rows all lie past sq loads some valid rows instead
      // (its results are never stored)
      hopper::load_chunk<D>(base + lay.q + g * kChunk, tq, bar.q_full(), row0 < p.sq ? row0 : 0, head0 + hh, bi);
    }
  };
  auto load_k = [&](int hh, int j) {
    hopper::mbar_arrive_expect_tx(bar.k_full(j), kChunk);
    hopper::load_chunk<D>(base + lay.k + j * kChunk, tk, bar.k_full(j), j * kChunkRows, head0 + hh, bi);
  };
  auto load_v = [&](int t) {
    const int s = t % kVStages;
    hopper::mbar_arrive_expect_tx(bar.v_full(s), kChunk);
    hopper::load_chunk<D>(base + lay.v + s * kChunk, tv, bar.v_full(s), (t % n) * kChunkRows, head0 + t / n, bi);
  };

  load_q(0);
  for (int j = 0; j < n; ++j) load_k(0, j);
  for (int t = 0; t < kVStages && t < items; ++t) load_v(t);
  for (int hh = 0; hh < n_heads; ++hh) {
    if (hh + 1 < n_heads) {
      hopper::mbar_wait(bar.q_empty(), hh & 1);  // head hh's Q is in registers
      load_q(hh + 1);
    }
    for (int j = 0; j < n; ++j) {
      const int t = hh * n + j;
      if (hh + 1 < n_heads) {
        hopper::mbar_wait(bar.k_empty(j), hh & 1);  // sweep 2 of head hh is past chunk j
        load_k(hh + 1, j);
      }
      if (t + kVStages < items) {
        hopper::mbar_wait(bar.v_empty(t % kVStages), (t / kVStages) & 1);
        load_v(t + kVStages);
      }
    }
  }
}

// The row max of one chunk's logits, keys at or past sk excluded.
__device__ __forceinline__ void chunk_max(float (&m)[2], const float (&s)[kChunkRows / 8][4], int col0, int sk) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col0 + nn * 8 + 2 * t + (e & 1) < sk) m[e >> 1] = fmaxf(m[e >> 1], s[nn][e]);
    }
  }
}

// p = exp_mode(s - m) of one chunk in place, 0 at or past sk, and the f32 p
// into the row sums l.
template <int kMode>
__device__ __forceinline__ void chunk_softmax(float (&s)[kChunkRows / 8][4], float (&l)[2], const float (&m)[2],
                                              int col0, int sk) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + nn * 8 + 2 * t + (e & 1);
      s[nn][e] = col < sk ? probe_exp<kMode>(__fsub_rn(s[nn][e], m[e >> 1])) : 0.f;
      l[e >> 1] = __fadd_rn(l[e >> 1], s[nn][e]);
    }
  }
}

// A consumer warpgroup: for each head of the block, its 64 query rows. No
// wgmma group stays in flight across a loop iteration. Sweep 1 issues two
// chunks' Q K^T before it takes the first one's max. Sweep 2 issues chunk j's
// Q K^T and chunk j-1's P V together, and takes chunk j's softmax while P V
// runs.
template <int D, int kMode>
__device__ void single_consumer(const Params& p, uint32_t base, const SingleLayout& lay, const SingleBars& bar, int bi,
                                int head0, int n_heads, int q0) {
  constexpr uint32_t kChunk = chunk_bytes(D);
  const int n = bar.n;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int row0 = q0 + wg * kChunkRows + warp * 16;  // this warp's 16 rows
  const uint32_t q_tile = base + lay.q + wg * kChunk;
  auto k_chunk = [&](int j) { return base + lay.k + j * kChunk; };
  float sa[kChunkRows / 8][4] = {}, sb[kChunkRows / 8][4] = {};
  for (int hh = 0; hh < n_heads; ++hh) {
    hopper::mbar_wait(bar.q_full(), hh & 1);
    uint32_t qa[D / 16][4];
    scaled_q<D>(qa, q_tile, p.scale);
    hopper::fence_proxy_async();  // these reads come before the next Q's TMA write
    hopper::warp_arrive(bar.q_empty());

    // sweep 1: the exact row max, two chunks at a time as K lands (an odd
    // last chunk is taken twice, which leaves the max as it is)
    float m[2] = {-1e30f, -1e30f};  // padded keys' logit: their max changes nothing
    for (int j = 0; j < n; j += 2) {
      const int j1 = j + 1 < n ? j + 1 : j;
      hopper::mbar_wait(bar.k_full(j), hh & 1);
      qk_issue<D>(sa, qa, k_chunk(j));
      hopper::mbar_wait(bar.k_full(j1), hh & 1);
      qk_issue<D>(sb, qa, k_chunk(j1));
      hopper::wgmma_wait<1>();
      chunk_max(m, sa, j * kChunkRows, p.sk);
      hopper::wgmma_wait<0>();
      chunk_max(m, sb, j1 * kChunkRows, p.sk);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }

    // sweep 2: exponentials, the f32 row sum and bf16(p) V, V from the ring
    float acc[D / 8][4];
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
    float l[2] = {0.f, 0.f};
    uint32_t pa[kChunkRows / 16][4];
    const int item0 = hh * n;  // chunk 0's place in the block's V stream
    auto pv = [&](int j) {     // issue P V of chunk j, P in pa
      const int item = item0 + j;
      hopper::mbar_wait(bar.v_full(item % kVStages), (item / kVStages) & 1);
      pv_issue<D>(acc, pa, base + lay.v + (item % kVStages) * kChunk);
    };
    qk_issue<D>(sa, qa, k_chunk(0));
    hopper::wgmma_wait<0>();
    hopper::warp_arrive(bar.k_empty(0));
    chunk_softmax<kMode>(sa, l, m, 0, p.sk);
    pack_p(pa, sa);
    for (int j = 1; j < n; ++j) {
      qk_issue<D>(sa, qa, k_chunk(j));
      pv(j - 1);
      hopper::wgmma_wait<1>();  // Q K^T of chunk j is done
      hopper::warp_arrive(bar.k_empty(j));
      chunk_softmax<kMode>(sa, l, m, j * kChunkRows, p.sk);
      hopper::wgmma_wait<0>();  // P V of chunk j - 1 is done with pa and V
      hopper::warp_arrive(bar.v_empty((item0 + j - 1) % kVStages));
      pack_p(pa, sa);
    }
    pv(n - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    hopper::warp_arrive(bar.v_empty((item0 + n - 1) % kVStages));
    quad_sum(l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p_pad = probe_exp<kMode>(__fsub_rn(-1e30f, m[r]));  // 0 unless "mul"
      l[r] = __fadd_rn(l[r], __fmul_rn(static_cast<float>(p.n_pad), p_pad));
    }
    store_rows<D>(p.o + bi * p.o_sb + (head0 + hh) * p.o_sh, p.o_ss, row0, p.sq, acc, l);
  }
}

template <int D, int kMode, bool kHeadLoop>
__global__ void __launch_bounds__(kProbeThreads, 1)
    single_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p, int groups) {
  extern __shared__ __align__(1024) unsigned char single_smem[];
  const uint32_t base = hopper::smem_u32(single_smem);
  const SingleLayout lay = single_layout(D, p.sk, groups);
  const SingleBars bar{base + static_cast<uint32_t>(lay.bars), key_chunks(p.sk)};
  const int consumers = 128 * groups;
  if (threadIdx.x == 0) {
    if (base % 1024 != 0) __trap();  // the swizzled tiles need the pattern's alignment
    for (int j = 0; j < bar.n; ++j) {
      hopper::mbar_init(bar.k_full(j), 1);
      hopper::mbar_init(bar.k_empty(j), 4 * groups);
    }
    hopper::mbar_init(bar.q_full(), 1);
    hopper::mbar_init(bar.q_empty(), 4 * groups);
    for (int s = 0; s < kVStages; ++s) {
      hopper::mbar_init(bar.v_full(s), 1);
      hopper::mbar_init(bar.v_empty(s), 4 * groups);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int bi = kHeadLoop ? blockIdx.y : blockIdx.z;
  const int head0 = kHeadLoop ? 0 : blockIdx.y;
  const int n_heads = kHeadLoop ? p.h : 1;
  const int q0 = blockIdx.x * kChunkRows * groups;
  if (threadIdx.x >= consumers) {  // the producer warp; one thread issues
    if (threadIdx.x == consumers) {
      single_producer<D>(&tq, &tk, &tv, p, base, lay, bar, groups, bi, head0, n_heads, q0);
    }
  } else {
    single_consumer<D, kMode>(p, base, lay, bar, bi, head0, n_heads, q0);
  }
}

// ---------------------------------------------------------------------------
// maxfree (fastsm and kt): replaces tools/pallas_tune.py::make_fastsm's
// `kernel` (:173) and make_kt's `kernel` (:252). The max-free clamped
// softmax: s = clip(q k^T, -80, 80) + bias (0 on keys, -200 on padding),
// p = bf16(exp_mode(s)), l = sum of f32(p) ("lane" on the vector unit, "mxu"
// as p @ ones on the matrix unit), o = (p V) / l. kt reads K pre-transposed,
// [b, h, d, sk]; its dots-only probe takes p = bf16(s) with no clamp and no
// bias, and l = 1.
//
// Bound: as above, bytes at both probe shapes (0.0677 ms at
// [64, 12, 577, 577, 64], 0.0085 ms at batch 8), with the tensor-core time
// (0.0662 ms) and the sk exponentials per row on the SFU close behind.
//
// Design (Hopper): with no running max nothing is ever rescaled, so the
// TPU's whole-K residency buys nothing and K and V stream, as in
// flash_attention.cu's flash_wgmma_kernel with the max and the rescale taken
// out. A block is one producer warp and block_q / 64 consumer warpgroups
// (block_q 64 or 128), which share every K and V chunk.
//   - The producer's one thread loads with TMA: the block's Q rows once, then
//     every 64-key chunk of K (or K^T) and of V through a ring of
//     kMaxfreeStages stages with full and empty mbarriers, K and V apart so
//     that Q K^T starts before V lands. q, k and v are tensor maps over the
//     caller's strided [b, h, s, d] views with s's extent sq or sk; K^T is a
//     map {sk, d, h, b} read in boxes of 32 keys by d dims. Keys past sk
//     arrive as zeros.
//   - Consumers read Q once into wgmma A fragments. Each iteration issues
//     S_j = Q K_j^T (K-major K, or MN-major K^T through qkt_issue) and
//     P_{j-1} V_{j-1} together, waits for S_j, and takes chunk j's clamp,
//     exponential, bf16 rounding and lane sum while P V runs. The zero keys
//     past sk would give s = 0 and p = 1, so p is zeroed at column >= sk. No
//     wgmma group stays in flight across an iteration.
//   - "mxu" keeps the row sum on the tensor cores, as the TPU's p @ ones: a
//     wgmma m64n8k16 of each bf16 P fragment against a ones tile in shared
//     memory, issued in P V's group, whose every column holds the row sum.
//     "lane" adds the rounded f32 p and reduces across the quad at the end.
//     The two differ only in summation order.
//   - The virtual padded keys of the JAX layout are counted into l after the
//     loop.
//   - Shared memory: Q + 4 K stages + 4 V stages (16 KB each at d 64, 24 KB
//     at d 96) + the ones tile, 74-83 KB at d 64 and 109-121 KB at d 96.
// ---------------------------------------------------------------------------

constexpr int kMaxfreeStages = 4;  // K/V ring depth

// Byte offsets into a maxfree block's dynamic shared memory (mirrored by
// ops/attention_probes.py::maxfree_smem_layout): `groups` Q chunks,
// kMaxfreeStages K chunks, kMaxfreeStages V chunks, every one a multiple of
// 4 KB from the 1 KB-aligned base; the ones tile; then the mbarriers q_full,
// k_full[S], k_empty[S], v_full[S], v_empty[S].
struct MaxfreeLayout {
  int q, k, v, ones, bars, total;
};

__host__ __device__ constexpr MaxfreeLayout maxfree_layout(int d, int groups) {
  const int c = chunk_bytes(d);
  const int k = groups * c, v = k + kMaxfreeStages * c, ones = v + kMaxfreeStages * c;
  const int bars = ones + hopper::kOnesBytes;
  return MaxfreeLayout{0, k, v, ones, bars, bars + (1 + 4 * kMaxfreeStages) * 8};
}

struct MaxfreeBars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (1 + kMaxfreeStages + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (1 + 2 * kMaxfreeStages + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (1 + 3 * kMaxfreeStages + s); }
};

// The tensor map of K^T [b, h, d, >= sk] as rank 4 {sk, d, h, b} with its
// (batch, head, dim-row) strides in elements, in boxes of 32 keys by d dims
// with the 64-byte swizzle: a 64-key chunk is two boxes, as qkt_issue reads
// it. Keys past sk arrive as zeros.
int kt_map(CUtensorMap* map, const void* kt, int b, int h, int sk, int d, const long long* strides) {
  const uint64_t dims[4] = {static_cast<uint64_t>(sk), static_cast<uint64_t>(d), static_cast<uint64_t>(h),
                            static_cast<uint64_t>(b)};
  const uint64_t bytes[3] = {static_cast<uint64_t>(strides[2]) * 2, static_cast<uint64_t>(strides[1]) * 2,
                             static_cast<uint64_t>(strides[0]) * 2};
  const uint32_t box[4] = {hopper::kBoxCols, static_cast<uint32_t>(d), 1, 1};
  return hopper::encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kt, dims, bytes, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// The producer: one thread issues every TMA load of the block.
template <int D, bool kKT>
__device__ void maxfree_producer(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                 const Params& p, uint32_t base, const MaxfreeLayout& lay, const MaxfreeBars& bar,
                                 int groups, int bi, int hi, int q0) {
  constexpr uint32_t kChunk = chunk_bytes(D);
  const int n = key_chunks(p.sk);
  hopper::prefetch_tensormap(tq);
  hopper::prefetch_tensormap(tk);
  hopper::prefetch_tensormap(tv);
  hopper::mbar_arrive_expect_tx(bar.q_full(), groups * kChunk);
  for (int g = 0; g < groups; ++g) {
    const int row0 = q0 + g * kChunkRows;
    // a warpgroup whose rows all lie past sq loads some valid rows instead
    // (its results are never stored)
    hopper::load_chunk<D>(base + lay.q + g * kChunk, tq, bar.q_full(), row0 < p.sq ? row0 : 0, hi, bi);
  }
  for (int j = 0; j < n; ++j) {
    const int s = j % kMaxfreeStages;
    const uint32_t parity = ((j / kMaxfreeStages) + 1) & 1;  // the release of chunk j - kMaxfreeStages
    const uint32_t k_dst = base + lay.k + s * kChunk;
    if (j >= kMaxfreeStages) hopper::mbar_wait(bar.k_empty(s), parity);
    hopper::mbar_arrive_expect_tx(bar.k_full(s), kChunk);
    if constexpr (kKT) {
      for (int y = 0; y < kChunkRows / hopper::kBoxCols; ++y) {
        hopper::tma_load_4d(k_dst + y * D * hopper::kRowStrideBytes, tk, bar.k_full(s),
                            j * kChunkRows + y * hopper::kBoxCols, 0, hi, bi);
      }
    } else {
      hopper::load_chunk<D>(k_dst, tk, bar.k_full(s), j * kChunkRows, hi, bi);
    }
    if (j >= kMaxfreeStages) hopper::mbar_wait(bar.v_empty(s), parity);
    hopper::mbar_arrive_expect_tx(bar.v_full(s), kChunk);
    hopper::load_chunk<D>(base + lay.v + s * kChunk, tv, bar.v_full(s), j * kChunkRows, hi, bi);
  }
}

// p of one chunk in place of its logits s (keys col0..col0+63):
// exp_mode(clip(s, -80, 80)), or s for dots-only, and 0 at or past sk;
// pack_p rounds it to bf16 later. The lane sum rounds each pair of p with
// one conversion and adds the rounded values into l.
template <int kMode, int kSum, bool kDotsOnly>
__device__ __forceinline__ void maxfree_p(float (&s)[kChunkRows / 8][4], float (&l)[2], int col0, int sk) {
  const int t = threadIdx.x & 3;
  const bool edge = col0 + kChunkRows > sk;  // the chunk holds keys past sk
#pragma unroll
  for (int nn = 0; nn < kChunkRows / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = kDotsOnly ? s[nn][e] : probe_exp<kMode>(fminf(fmaxf(s[nn][e], -80.f), 80.f));
      if (edge && col0 + nn * 8 + 2 * t + (e & 1) >= sk) x = 0.f;
      s[nn][e] = x;
    }
    if constexpr (kSum == kLane && !kDotsOnly) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows g and g + 8
        const uint32_t pair = pack_bf16x2(s[nn][2 * r], s[nn][2 * r + 1]);
        s[nn][2 * r] = __uint_as_float(pair << 16);
        s[nn][2 * r + 1] = __uint_as_float(pair & 0xffff0000u);
        l[r] += s[nn][2 * r];
        l[r] += s[nn][2 * r + 1];
      }
    }
  }
}

// A consumer warpgroup: its 64 query rows against every key chunk.
template <int D, int kMode, int kSum, bool kKT, bool kDotsOnly>
__device__ void maxfree_consumer(const Params& p, uint32_t base, const MaxfreeLayout& lay, const MaxfreeBars& bar,
                                 int bi, int hi, int q0) {
  constexpr uint32_t kChunk = chunk_bytes(D);
  constexpr bool kRowSumMma = kSum == kMxu && !kDotsOnly;
  const int n = key_chunks(p.sk);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  auto k_chunk = [&](int j) { return base + lay.k + (j % kMaxfreeStages) * kChunk; };
  auto v_chunk = [&](int j) { return base + lay.v + (j % kMaxfreeStages) * kChunk; };
  auto parity = [](int j) { return static_cast<uint32_t>((j / kMaxfreeStages) & 1); };

  hopper::mbar_wait(bar.q_full(), 0);
  uint32_t qa[D / 16][4];
  scaled_q<D>(qa, base + lay.q + wg * kChunk, p.scale);

  float acc[D / 8][4];
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
  float rowsum[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  float l[2] = {0.f, 0.f};
  float s[kChunkRows / 8][4] = {};
  uint32_t pa[kChunkRows / 16][4];
  auto qk = [&](int j) {
    hopper::mbar_wait(bar.k_full(j % kMaxfreeStages), parity(j));
    if constexpr (kKT) {
      hopper::qkt_issue<D>(s, qa, k_chunk(j));
    } else {
      hopper::qk_issue<D>(s, qa, k_chunk(j));
    }
  };
  auto pv = [&](int j) {  // P of chunk j is in pa
    hopper::mbar_wait(bar.v_full(j % kMaxfreeStages), parity(j));
    if constexpr (kRowSumMma) {
      hopper::pv_rowsum_issue<D>(acc, rowsum, pa, v_chunk(j), base + lay.ones);
    } else {
      hopper::pv_issue<D>(acc, pa, v_chunk(j));
    }
  };
  auto pv_done = [&](int j) {
    hopper::wgmma_wait<0>();  // P V of chunk j is done with pa and V
    hopper::fence_operands(acc);
    if constexpr (kRowSumMma) hopper::fence_operands(rowsum);
    hopper::warp_arrive(bar.v_empty(j % kMaxfreeStages));
  };

  // chunk 0: O is still zero, so it needs no P V beside it. P is packed
  // only once the previous P V is done with pa: writing it while that
  // wgmma runs would serialise every wgmma of the kernel
  qk(0);
  hopper::wgmma_wait<0>();
  hopper::warp_arrive(bar.k_empty(0));
  maxfree_p<kMode, kSum, kDotsOnly>(s, l, 0, p.sk);
  pack_p(pa, s);
  for (int j = 1; j < n; ++j) {
    qk(j);
    pv(j - 1);
    hopper::wgmma_wait<1>();  // Q K^T of chunk j is done
    hopper::warp_arrive(bar.k_empty(j % kMaxfreeStages));
    maxfree_p<kMode, kSum, kDotsOnly>(s, l, j * kChunkRows, p.sk);
    pv_done(j - 1);
    pack_p(pa, s);
  }
  pv(n - 1);
  pv_done(n - 1);

  if constexpr (kDotsOnly) {
    l[0] = l[1] = 1.f;
  } else {
    if constexpr (kRowSumMma) {
      l[0] = rowsum[0][0];  // every column of P ones holds the row sum
      l[1] = rowsum[0][2];
    } else {
      quad_sum(l);
    }
    // padded keys: clip(0) + (-200), exp_mode, bf16; 0 unless "mul"
    const float p_pad = round_bf16(probe_exp<kMode>(-200.f));
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fadd_rn(l[r], __fmul_rn(static_cast<float>(p.n_pad), p_pad));
  }
  const int row0 = q0 + wg * kChunkRows + warp * 16;  // this warp's 16 rows
  store_rows<D>(p.o + bi * p.o_sb + hi * p.o_sh, p.o_ss, row0, p.sq, acc, l);
}

template <int D, int kMode, int kSum, bool kKT, bool kDotsOnly>
__global__ void __launch_bounds__(kProbeThreads, 1)
    maxfree_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p, int groups) {
  extern __shared__ __align__(1024) unsigned char maxfree_smem[];
  const uint32_t base = hopper::smem_u32(maxfree_smem);
  const MaxfreeLayout lay = maxfree_layout(D, groups);
  const MaxfreeBars bar{base + static_cast<uint32_t>(lay.bars)};
  const int consumers = 128 * groups;
  if constexpr (kSum == kMxu && !kDotsOnly) {
    if (threadIdx.x < hopper::kOnesBytes / 8) {
      hopper::st_shared_u64(base + lay.ones + 8 * threadIdx.x, 0x3F803F803F803F80ull);  // bf16 1.0 x 4
      hopper::fence_proxy_async();  // before wgmma reads the tile
    }
  }
  if (threadIdx.x == 0) {
    if (base % 1024 != 0) __trap();  // the swizzled tiles need the pattern's alignment
    hopper::mbar_init(bar.q_full(), 1);
    for (int s = 0; s < kMaxfreeStages; ++s) {
      hopper::mbar_init(bar.k_full(s), 1);
      hopper::mbar_init(bar.k_empty(s), 4 * groups);  // one arrive per consumer warp
      hopper::mbar_init(bar.v_full(s), 1);
      hopper::mbar_init(bar.v_empty(s), 4 * groups);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int bi = blockIdx.z, hi = blockIdx.y, q0 = blockIdx.x * kChunkRows * groups;
  if (threadIdx.x >= consumers) {  // the producer warp; one thread issues
    if (threadIdx.x == consumers) maxfree_producer<D, kKT>(&tq, &tk, &tv, p, base, lay, bar, groups, bi, hi, q0);
  } else {
    maxfree_consumer<D, kMode, kSum, kKT, kDotsOnly>(p, base, lay, bar, bi, hi, q0);
  }
}

// ---------------------------------------------------------------------------
// Launch and dispatch
// ---------------------------------------------------------------------------

// The attribute is per function: raising it to the limit once covers every
// launch of that function, whatever its size.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
}

// The kernel of one (head dim, exp mode, layout), passed to `fn` as compile-time
// constants; cudaErrorInvalidValue for a mode it does not know.
template <int D, typename Fn>
cudaError_t with_single_kernel(int head_loop, int exp_mode, Fn&& fn) {
  using std::integral_constant;
  if (head_loop) {
    if (exp_mode == kExp) return fn(integral_constant<int, kExp>(), std::true_type());
    if (exp_mode == kMul) return fn(integral_constant<int, kMul>(), std::true_type());
    if (exp_mode == kBf16) return fn(integral_constant<int, kBf16>(), std::true_type());
  } else {
    if (exp_mode == kExp) return fn(integral_constant<int, kExp>(), std::false_type());
    if (exp_mode == kMul) return fn(integral_constant<int, kMul>(), std::false_type());
    if (exp_mode == kBf16) return fn(integral_constant<int, kBf16>(), std::false_type());
  }
  return cudaErrorInvalidValue;
}

// The maxfree kernel of one (exp mode, sum mode, K layout, dots-only),
// passed to `fn` as compile-time constants: fastsm (kt 0) takes every exp
// and sum mode, kt the lane sum with every exp mode or dots-only;
// cudaErrorInvalidValue otherwise.
template <typename Fn>
cudaError_t with_maxfree_kernel(int kt, int sum_mode, int exp_mode, int dots_only, Fn&& fn) {
  using std::integral_constant;
  auto modes = [&](auto sum, auto is_kt) -> cudaError_t {
    if (exp_mode == kExp) return fn(integral_constant<int, kExp>(), sum, is_kt, std::false_type());
    if (exp_mode == kMul) return fn(integral_constant<int, kMul>(), sum, is_kt, std::false_type());
    if (exp_mode == kBf16) return fn(integral_constant<int, kBf16>(), sum, is_kt, std::false_type());
    return cudaErrorInvalidValue;
  };
  if (kt) {
    if (sum_mode != kLane) return cudaErrorInvalidValue;
    if (dots_only) {
      return fn(integral_constant<int, kExp>(), integral_constant<int, kLane>(), std::true_type(), std::true_type());
    }
    return modes(integral_constant<int, kLane>(), std::true_type());
  }
  if (dots_only) return cudaErrorInvalidValue;
  if (sum_mode == kLane) return modes(integral_constant<int, kLane>(), std::false_type());
  if (sum_mode == kMxu) return modes(integral_constant<int, kMxu>(), std::false_type());
  return cudaErrorInvalidValue;
}

template <int D, int kMode, bool kHeadLoop>
cudaError_t launch_single(const CUtensorMap (&maps)[3], const Params& p, int b, int groups, cudaStream_t stream) {
  static const cudaError_t configured = allow_smem(single_kernel<D, kMode, kHeadLoop>);
  if (configured != cudaSuccess) return configured;
  const int smem = single_layout(D, p.sk, groups).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int block_q = kChunkRows * groups;
  const int nq = (p.sq + block_q - 1) / block_q;
  const dim3 grid = kHeadLoop ? dim3(nq, b, 1) : dim3(nq, p.h, b);
  single_kernel<D, kMode, kHeadLoop><<<grid, 128 * groups + 32, smem, stream>>>(maps[0], maps[1], maps[2], p, groups);
  return cudaGetLastError();
}

template <int D, int kMode, int kSum, bool kKT, bool kDotsOnly>
cudaError_t launch_maxfree(const CUtensorMap (&maps)[3], const Params& p, int b, int groups, cudaStream_t stream) {
  static const cudaError_t configured = allow_smem(maxfree_kernel<D, kMode, kSum, kKT, kDotsOnly>);
  if (configured != cudaSuccess) return configured;
  const int block_q = kChunkRows * groups;
  const dim3 grid((p.sq + block_q - 1) / block_q, p.h, b);
  maxfree_kernel<D, kMode, kSum, kKT, kDotsOnly>
      <<<grid, 128 * groups + 32, maxfree_layout(D, groups).total, stream>>>(maps[0], maps[1], maps[2], p, groups);
  return cudaGetLastError();
}

Params make_params(void* o, int h, int sq, int sk, const long long* strides, float scale) {
  Params p;
  p.o = static_cast<bf16*>(o);
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.n_pad = (sk + 127) / 128 * 128 - sk;
  p.scale = scale;
  return p;
}

template <int D>
cudaError_t single_d(const CUtensorMap (&maps)[3], const Params& p, int b, int groups, int head_loop, int exp_mode,
                     cudaStream_t s) {
  return with_single_kernel<D>(head_loop, exp_mode, [&](auto mode, auto loop) {
    return launch_single<D, decltype(mode)::value, decltype(loop)::value>(maps, p, b, groups, s);
  });
}

template <int D>
cudaError_t single_occupancy_d(int sk, int groups, int head_loop, int exp_mode, int* smem, int* blocks) {
  return with_single_kernel<D>(head_loop, exp_mode, [&](auto mode, auto loop) {
    const auto kernel = single_kernel<D, decltype(mode)::value, decltype(loop)::value>;
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return err;
    *smem = single_layout(D, sk, groups).total;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, 128 * groups + 32, *smem);
  });
}

template <int D>
cudaError_t maxfree_d(const CUtensorMap (&maps)[3], const Params& p, int b, int groups, int kt, int sum_mode,
                      int exp_mode, int dots_only, cudaStream_t s) {
  return with_maxfree_kernel(kt, sum_mode, exp_mode, dots_only, [&](auto mode, auto sum, auto is_kt, auto dots) {
    return launch_maxfree<D, decltype(mode)::value, decltype(sum)::value, decltype(is_kt)::value,
                          decltype(dots)::value>(maps, p, b, groups, s);
  });
}

template <int D>
cudaError_t maxfree_occupancy_d(int groups, int kt, int sum_mode, int exp_mode, int dots_only, int* smem,
                                int* blocks) {
  return with_maxfree_kernel(kt, sum_mode, exp_mode, dots_only, [&](auto mode, auto sum, auto is_kt, auto dots) {
    const auto kernel = maxfree_kernel<D, decltype(mode)::value, decltype(sum)::value, decltype(is_kt)::value,
                                       decltype(dots)::value>;
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return err;
    *smem = maxfree_layout(D, groups).total;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, 128 * groups + 32, *smem);
  });
}

// fastsm (kt 0) and kt: the tensor maps, then the launch.
int launch_maxfree_entry(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk, int d,
                         const long long* strides, float scale, int block_q, int kt, int sum_mode, int exp_mode,
                         int dots_only, void* stream) {
  if (block_q != 64 && block_q != 128) return static_cast<int>(cudaErrorInvalidValue);
  if ((d != 64 && d != 96) || sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  int err = hopper::rows_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, b, h, sq, d, strides);
  if (err == 0) {
    err = kt ? kt_map(&maps[1], k, b, h, sk, d, strides + 3)
             : hopper::rows_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, b, h, sk, d, strides + 3);
  }
  if (err == 0) err = hopper::rows_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, b, h, sk, d, strides + 6);
  if (err != 0) return err;
  const Params p = make_params(o, h, sq, sk, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = block_q / kChunkRows;
  if (d == 64) return maxfree_d<64>(maps, p, b, groups, kt, sum_mode, exp_mode, dots_only, s);
  return maxfree_d<96>(maps, p, b, groups, kt, sum_mode, exp_mode, dots_only, s);
}

}  // namespace

extern "C" {

// Common arguments: q, k (K^T for kt), v and o are bf16 with a contiguous last
// dim; strides holds 12 values, the (batch, head, row) strides in elements of
// q, k, v and o in that order (a row of K^T is one of its d rows), each a
// multiple of 8 (16 bytes), and the four addresses 16-byte aligned. scale is
// d^-1/2 as f32. exp_mode: 0 = exp, 1 = mul, 2 = bf16. block_q is 64 or 128:
// the block has one or two consumer warpgroups of 64 query rows. q, k and v
// are read through tensor maps; a map the driver will not encode returns
// hopper::kErrTensorMapEncode. Each returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a mode, head dim, block_q or size this library
// does not take. Each launches on `stream`, allocates nothing and does not
// synchronise. A pipeline wait that never completes traps the kernel, which
// fails the launch at the next synchronisation.

// single: head_loop 1 = blocks own (batch, q tile) and walk the heads
// ("unroll", "batched"); 0 = blocks own (batch, head, q tile) ("grid").
int zutis_probe_single(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk, int d,
                       const long long* strides, float scale, int block_q, int head_loop, int exp_mode,
                       void* stream) {
  if (block_q != 64 && block_q != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (d != 64 && d != 96) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const int err = hopper::attention_maps(maps, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, b, h, sq, sk, d, strides);
  if (err != 0) return err;
  const Params p = make_params(o, h, sq, sk, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return single_d<64>(maps, p, b, block_q / kChunkRows, head_loop, exp_mode, s);
  return single_d<96>(maps, p, b, block_q / kChunkRows, head_loop, exp_mode, s);
}

// The dynamic shared memory of one `single` block at this sk, and the blocks
// of that kernel an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int zutis_probe_single_occupancy(int d, int sk, int block_q, int head_loop, int exp_mode, int* smem_bytes,
                                 int* blocks_per_sm) {
  if (block_q != 64 && block_q != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = block_q / kChunkRows;
  if (d == 64) return single_occupancy_d<64>(sk, groups, head_loop, exp_mode, smem_bytes, blocks_per_sm);
  if (d == 96) return single_occupancy_d<96>(sk, groups, head_loop, exp_mode, smem_bytes, blocks_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

// fastsm: sum_mode 0 = lane, 1 = mxu.
int zutis_probe_fastsm(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk, int d,
                       const long long* strides, float scale, int block_q, int sum_mode, int exp_mode,
                       void* stream) {
  return launch_maxfree_entry(q, k, v, o, b, h, sq, sk, d, strides, scale, block_q, 0, sum_mode, exp_mode, 0,
                              stream);
}

// kt: kt is K^T [b, h, d, >= sk]; dots_only 1 = p = bf16(s), l = 1
// (exp_mode ignored).
int zutis_probe_kt(const void* q, const void* kt, const void* v, void* o, int b, int h, int sq, int sk, int d,
                   const long long* strides, float scale, int block_q, int exp_mode, int dots_only,
                   void* stream) {
  return launch_maxfree_entry(q, kt, v, o, b, h, sq, sk, d, strides, scale, block_q, 1, kLane, exp_mode, dots_only,
                              stream);
}

// The dynamic shared memory of one fastsm (kt 0) or kt block, and the blocks
// of that kernel an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int zutis_probe_maxfree_occupancy(int d, int block_q, int kt, int sum_mode, int exp_mode, int dots_only,
                                  int* smem_bytes, int* blocks_per_sm) {
  if (block_q != 64 && block_q != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = block_q / kChunkRows;
  if (d == 64) return maxfree_occupancy_d<64>(groups, kt, sum_mode, exp_mode, dots_only, smem_bytes, blocks_per_sm);
  if (d == 96) return maxfree_occupancy_d<96>(groups, kt, sum_mode, exp_mode, dots_only, smem_bytes, blocks_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* zutis_cuda_error_string(int err) {
  const char* own = hopper::error_string(err);
  return own != nullptr ? own : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
