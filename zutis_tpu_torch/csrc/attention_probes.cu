// Attention-tuning probes for Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see zutis_tpu_torch/ops/attention_probes.py).
//
// Three kernel families replace the three Pallas probes of
// tools/pallas_tune.py. Each computes, for q [b, h, sq, d] and k, v
// [b, h, sk, d] in bf16, the probe's function exactly as its JAX `fn` does
// (wrapper plus kernel), not textbook attention:
//   - q is pre-scaled in f32 by d^-1/2 and rounded back to bf16 before the
//     products; the kernels do that as they load q;
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
// `single` runs on Hopper's TMA, mbarriers and wgmma (helpers in hopper.cuh;
// design note at its kernel). `fastsm` and `kt` run on mma.sync with ldmatrix
// operands and a cp.async ring. Fragment layouts of mma.m16n8k16 (PTX ISA),
// with g = lane / 4, t = lane % 4 (wgmma's A and accumulator fragments repeat
// them per warp of the warpgroup):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8, "col"):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (16x8 f32):         c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// In fastsm and kt every warp owns 16 query rows; a block holds block_q / 16
// warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"


namespace {

using bf16 = __nv_bfloat16;
using hopper::kSmemLimit;
using hopper::pack_bf16x2;

constexpr int kTileN = 64;          // keys per tile
constexpr int kMaxThreads = 256;    // block_q up to 128
constexpr int kExp = 0, kMul = 1, kBf16 = 2;
constexpr int kLane = 0, kMxu = 1;

struct Params {
  const bf16* q;
  const bf16* k;  // K [b, h, sk, d], or K^T [b, h, d, >= sk] for the kt family
  const bf16* v;
  bf16* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;  // k_ss: a key row of K, or a dim row of K^T
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int h, sq, sk;
  int n_pad;  // padded keys of the JAX layout: ceil(sk / 128) * 128 - sk
  float scale;
};

// Shared-memory rows are padded by 16 bytes so that the 8 row addresses of an
// ldmatrix fall on different banks.
__host__ __device__ constexpr int row_stride(int cols) { return cols + 8; }

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

// Four 8x8 b16 matrices; lane L gives the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// D[16x8] += A[16x16] * B[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// This warp's 16 query rows as A fragments, q pre-scaled in f32 and rounded
// to bf16 as the JAX fn does before its kernel; rows at or past sq are zero.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const bf16* q, long long ss, int row0,
                                       int sq, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8;
      const int col = ks * 16 + 2 * t + (i >> 1) * 8;
      qa[ks][i] = 0;
      if (row < sq) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + row * ss + col));
        qa[ks][i] = pack_bf16x2(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
      }
    }
  }
}

// Rows [row0, row0 + n_rows) of a [rows, D] slice into a padded shared tile;
// rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* g, long long ss, int row0, int n_rows,
                                          int valid) {
  constexpr int kChunksPerRow = D / 8;
  for (int c = threadIdx.x; c < n_rows * kChunksPerRow; c += blockDim.x) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int gr = row0 + r;
    const bool ok = gr < valid;
    cp_async16(tile + r * row_stride(D) + col, g + (ok ? gr : 0) * ss + col, ok);
  }
}

// Keys [key0, key0 + 64) of K^T [D, >= sk] (row stride ss) into a padded
// [D, 64] shared tile. The caller's K^T holds at least round_up(sk, 8)
// columns, so a chunk of 8 keys that starts before sk is read whole; later
// chunks are zero-filled.
template <int D>
__device__ __forceinline__ void load_kt_tile(bf16* tile, const bf16* g, long long ss, int key0, int sk) {
  constexpr int kChunksPerRow = kTileN / 8;
  for (int c = threadIdx.x; c < D * kChunksPerRow; c += blockDim.x) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const bool ok = key0 + col < sk;
    cp_async16(tile + r * row_stride(kTileN) + col, g + r * ss + (ok ? key0 + col : 0), ok);
  }
}

// S[16 x 64] = Q K^T for this warp's rows and one tile of 64 keys. The tile is
// K [64, D] (row = key) or, with kKT, K^T [D, 64] (row = dim). mma's B operand
// wants (dim, key) pairs of one key in a register: plain ldmatrix gives that
// from K's rows, ldmatrix.trans from K^T's.
template <int D, bool kKT>
__device__ __forceinline__ void qk_tile(float (&s)[kTileN / 8][4], const uint32_t (&qa)[D / 16][4],
                                        const bf16* tile) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < kTileN / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      // matrix j holds dims kk*32 + j*8 .. +7 of keys n*8 .. +7:
      // b0, b1 of k-step 2kk, then b0, b1 of k-step 2kk + 1
      uint32_t b[4];
      if constexpr (kKT) {
        ldsm_x4_trans(b, tile + (kk * 32 + j * 8 + r) * row_stride(kTileN) + n * 8);
      } else {
        ldsm_x4(b, tile + (n * 8 + r) * row_stride(D) + kk * 32 + j * 8);
      }
      mma(s[n], qa[2 * kk], b[0], b[1]);
      mma(s[n], qa[2 * kk + 1], b[2], b[3]);
    }
  }
}

// acc[16 x D] += P[16 x 64] V[64 x D]; P is already rounded to bf16 values, so
// packing it is exact. V's tile is [64, D] (row = key) and takes ldmatrix.trans.
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 8][4], const float (&p)[kTileN / 8][4],
                                        const bf16* tile) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int c = 0; c < kTileN / 16; ++c) {
    const uint32_t pa[4] = {pack_bf16x2(p[2 * c][0], p[2 * c][1]), pack_bf16x2(p[2 * c][2], p[2 * c][3]),
                            pack_bf16x2(p[2 * c + 1][0], p[2 * c + 1][1]),
                            pack_bf16x2(p[2 * c + 1][2], p[2 * c + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      // matrix j: keys c*16 + (j & 1)*8 .. +7 of dims (n + j / 2)*8 .. +7
      uint32_t b[4];
      ldsm_x4_trans(b, tile + (c * 16 + (j & 1) * 8 + r) * row_stride(D) + (n + (j >> 1)) * 8);
      mma(acc[n], pa, b[0], b[1]);
      mma(acc[n + 1], pa, b[2], b[3]);
    }
  }
}

// The row sums of the C fragment's rows g and g + 8 across the 4 lanes of a
// quad.
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

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
using hopper::chunk_bytes;
using hopper::kBoxBytes;
using hopper::kBoxCols;
using hopper::kChunkRows;
using hopper::pack_p;
using hopper::pv_issue;
using hopper::qk_issue;
constexpr int kVStages = 2;
constexpr int kSingleThreads = 2 * 128 + 32;                // block_q 128: two consumer warpgroups + producer

__host__ __device__ constexpr int single_chunks(int sk) { return (sk + kChunkRows - 1) / kChunkRows; }

// Byte offsets into a `single` block's dynamic shared memory. Every tile area
// is a multiple of 4 KB from the 1 KB-aligned base; the mbarriers follow:
// k_full[n], k_empty[n], q_full, q_empty, v_full[kVStages], v_empty[kVStages].
struct SingleLayout {
  int k, q, v, bars, total;
};

__host__ __device__ constexpr SingleLayout single_layout(int d, int sk, int groups) {
  const int n = single_chunks(sk), c = chunk_bytes(d);
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
  auto load_rows = [&](const CUtensorMap* map, uint32_t dst, uint32_t full, int row0, int hi) {
#pragma unroll
    for (int x = 0; x < D / kBoxCols; ++x) {
      hopper::tma_load_4d(dst + x * kBoxBytes, map, full, x * kBoxCols, row0, hi, bi);
    }
  };
  auto load_q = [&](int hh) {
    hopper::mbar_arrive_expect_tx(bar.q_full(), groups * kChunk);
    for (int g = 0; g < groups; ++g) {
      const int row0 = q0 + g * kChunkRows;
      // a warpgroup whose rows all lie past sq loads some valid rows instead
      // (its results are never stored)
      load_rows(tq, base + lay.q + g * kChunk, bar.q_full(), row0 < p.sq ? row0 : 0, head0 + hh);
    }
  };
  auto load_k = [&](int hh, int j) {
    hopper::mbar_arrive_expect_tx(bar.k_full(j), kChunk);
    load_rows(tk, base + lay.k + j * kChunk, bar.k_full(j), j * kChunkRows, head0 + hh);
  };
  auto load_v = [&](int t) {
    const int s = t % kVStages;
    hopper::mbar_arrive_expect_tx(bar.v_full(s), kChunk);
    load_rows(tv, base + lay.v + s * kChunk, bar.v_full(s), (t % n) * kChunkRows, head0 + t / n);
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
__device__ __forceinline__ void chunk_max(float (&m)[2], const float (&s)[kTileN / 8][4], int col0, int sk) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nn = 0; nn < kTileN / 8; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col0 + nn * 8 + 2 * t + (e & 1) < sk) m[e >> 1] = fmaxf(m[e >> 1], s[nn][e]);
    }
  }
}

// p = exp_mode(s - m) of one chunk in place, 0 at or past sk, and the f32 p
// into the row sums l.
template <int kMode>
__device__ __forceinline__ void chunk_softmax(float (&s)[kTileN / 8][4], float (&l)[2], const float (&m)[2], int col0,
                                              int sk) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nn = 0; nn < kTileN / 8; ++nn) {
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
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * kChunkRows + warp * 16;  // this warp's 16 rows
  const uint32_t q_tile = base + lay.q + wg * kChunk;
  auto k_chunk = [&](int j) { return base + lay.k + j * kChunk; };
  float sa[kTileN / 8][4] = {}, sb[kTileN / 8][4] = {};
  for (int hh = 0; hh < n_heads; ++hh) {
    // Q as A fragments, pre-scaled in f32 and rounded to bf16 as the JAX fn
    // does before its kernel; rows past sq arrived as zeros
    hopper::mbar_wait(bar.q_full(), hh & 1);
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 16 + g + (i & 1) * 8;
        const int c = ks * 16 + 2 * t + (i >> 1) * 8;
        const uint32_t raw = hopper::ld_chunk_pair(q_tile, r, c);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        qa[ks][i] = pack_bf16x2(__fmul_rn(f.x, p.scale), __fmul_rn(f.y, p.scale));
      }
    }
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
      chunk_max(m, sa, j * kTileN, p.sk);
      hopper::wgmma_wait<0>();
      chunk_max(m, sb, j1 * kTileN, p.sk);
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
    uint32_t pa[kTileN / 16][4];
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
      chunk_softmax<kMode>(sa, l, m, j * kTileN, p.sk);
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
__global__ void __launch_bounds__(kSingleThreads, 1)
    single_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p, int groups) {
  extern __shared__ __align__(1024) unsigned char single_smem[];
  const uint32_t base = hopper::smem_u32(single_smem);
  const SingleLayout lay = single_layout(D, p.sk, groups);
  const SingleBars bar{base + static_cast<uint32_t>(lay.bars), single_chunks(p.sk)};
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
// fastsm and kt: replace tools/pallas_tune.py::make_fastsm's `kernel` (:173)
// and make_kt's `kernel` (:252). The max-free clamped softmax:
// s = clip(q k^T, -80, 80) + bias (0 on keys, -200 on padding),
// p = bf16(exp_mode(s)), l = sum of f32(p) ("lane" on the vector unit, "mxu"
// as p @ ones on the matrix unit), o = (p V) / l. kt reads K pre-transposed,
// [b, h, d, sk]; its dots-only probe takes p = bf16(s) with no clamp and no
// bias, and l = 1.
//
// Bound: as above. Design: with no running max nothing is ever rescaled, so
// the TPU's whole-K residency buys nothing; K (or K^T) and V stream through
// shared memory in 64-key tiles on a two-stage cp.async ring, as in
// flash_attention.cu, and each K/V byte is read once per block_q queries.
// "mxu" takes the row sum on the tensor cores, an mma of the bf16 p fragment
// with a B fragment of ones (the TPU's p @ ones), whose every column then
// holds the row sum; "lane" adds the f32 values and reduces across the quad.
// The two differ only in summation order. For kt, K^T's tile [d, 64] is the
// transposed layout for mma's B operand, so it is read with ldmatrix.trans.
// ---------------------------------------------------------------------------

template <int D, bool kKT>
__host__ __device__ constexpr int maxfree_k_tile() {  // elements of one K stage
  return kKT ? D * row_stride(kTileN) : kTileN * row_stride(D);
}

template <int D, bool kKT>
__host__ __device__ constexpr int maxfree_smem_bytes() {
  return 2 * (maxfree_k_tile<D, kKT>() + kTileN * row_stride(D)) * static_cast<int>(sizeof(bf16));
}

template <int D, int kMode, int kSum, bool kKT, bool kDotsOnly>
__global__ void __launch_bounds__(kMaxThreads) maxfree_kernel(const Params p) {
  constexpr int kKTile = maxfree_k_tile<D, kKT>();
  constexpr int kVTile = kTileN * row_stride(D);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);  // two stages
  bf16* s_v = s_k + 2 * kKTile;               // two stages

  const int bi = blockIdx.z, hi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = blockIdx.x * (blockDim.x / 32) * 16 + warp * 16;
  const bf16* q = p.q + bi * p.q_sb + hi * p.q_sh;
  const bf16* k = p.k + bi * p.k_sb + hi * p.k_sh;
  const bf16* v = p.v + bi * p.v_sb + hi * p.v_sh;
  bf16* o = p.o + bi * p.o_sb + hi * p.o_sh;
  const int n_tiles = (p.sk + kTileN - 1) / kTileN;

  auto prefetch = [&](int j) {
    const int stage = j & 1;
    if constexpr (kKT) {
      load_kt_tile<D>(s_k + stage * kKTile, k, p.k_ss, j * kTileN, p.sk);
    } else {
      load_rows<D>(s_k + stage * kKTile, k, p.k_ss, j * kTileN, kTileN, p.sk);
    }
    load_rows<D>(s_v + stage * kVTile, v, p.v_ss, j * kTileN, kTileN, p.sk);
  };

  prefetch(0);
  cp_async_commit();
  uint32_t qa[D / 16][4];
  load_q<D>(qa, q, p.q_ss, row0, p.sq, p.scale);

  const uint32_t ones = pack_bf16x2(1.f, 1.f);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l[2] = {0.f, 0.f};
  float l_mma[4] = {0.f, 0.f, 0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) prefetch(j + 1);
    cp_async_commit();  // possibly empty, so that wait<1> always means "tile j landed"
    cp_async_wait<1>();
    __syncthreads();
    const int stage = j & 1;

    float s[kTileN / 8][4];
    qk_tile<D, kKT>(s, qa, s_k + stage * kKTile);
#pragma unroll
    for (int n = 0; n < kTileN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kTileN + n * 8 + 2 * t + (e & 1);
        float pe;
        if constexpr (kDotsOnly) {
          pe = round_bf16(s[n][e]);
        } else {
          pe = round_bf16(probe_exp<kMode>(fminf(fmaxf(s[n][e], -80.f), 80.f)));
        }
        pe = col < p.sk ? pe : 0.f;  // padded keys are counted after the loop
        s[n][e] = pe;
        if constexpr (kSum == kLane) l[e >> 1] = __fadd_rn(l[e >> 1], pe);
      }
    }
    if constexpr (kSum == kMxu && !kDotsOnly) {
#pragma unroll
      for (int c = 0; c < kTileN / 16; ++c) {
        const uint32_t pa[4] = {pack_bf16x2(s[2 * c][0], s[2 * c][1]), pack_bf16x2(s[2 * c][2], s[2 * c][3]),
                                pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3])};
        mma(l_mma, pa, ones, ones);
      }
    }
    pv_tile<D>(acc, s, s_v + stage * kVTile);
    __syncthreads();  // the next iteration's prefetch refills this stage
  }

  if constexpr (kDotsOnly) {
    l[0] = l[1] = 1.f;
  } else {
    if constexpr (kSum == kMxu) {
      l[0] = l_mma[0];  // every column of the product holds the row sum
      l[1] = l_mma[2];
    } else {
      quad_sum(l);
    }
    // padded keys: clip(0) + (-200), exp_mode, bf16; 0 unless "mul"
    const float p_pad = round_bf16(probe_exp<kMode>(-200.f));
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = __fadd_rn(l[r], __fmul_rn(static_cast<float>(p.n_pad), p_pad));
  }
  store_rows<D>(o, p.o_ss, row0, p.sq, acc, l);
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
cudaError_t launch_maxfree(const Params& p, int b, int block_q, cudaStream_t stream) {
  constexpr int kSmem = maxfree_smem_bytes<D, kKT>();
  static const cudaError_t configured = allow_smem(maxfree_kernel<D, kMode, kSum, kKT, kDotsOnly>);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.sq + block_q - 1) / block_q, p.h, b);
  maxfree_kernel<D, kMode, kSum, kKT, kDotsOnly><<<grid, block_q * 2, kSmem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o, int h, int sq, int sk,
                   const long long* strides, float scale) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.n_pad = (sk + 127) / 128 * 128 - sk;
  p.scale = scale;
  return p;
}

bool block_q_ok(int block_q) { return block_q >= 16 && block_q <= 128 && block_q % 16 == 0; }

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

template <int D, int kSum>
cudaError_t fastsm_d(const Params& p, int b, int block_q, int exp_mode, cudaStream_t s) {
  if (exp_mode == kExp) return launch_maxfree<D, kExp, kSum, false, false>(p, b, block_q, s);
  if (exp_mode == kMul) return launch_maxfree<D, kMul, kSum, false, false>(p, b, block_q, s);
  if (exp_mode == kBf16) return launch_maxfree<D, kBf16, kSum, false, false>(p, b, block_q, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t kt_d(const Params& p, int b, int block_q, int exp_mode, int dots_only, cudaStream_t s) {
  if (dots_only) return launch_maxfree<D, kExp, kLane, true, true>(p, b, block_q, s);
  if (exp_mode == kExp) return launch_maxfree<D, kExp, kLane, true, false>(p, b, block_q, s);
  if (exp_mode == kMul) return launch_maxfree<D, kMul, kLane, true, false>(p, b, block_q, s);
  if (exp_mode == kBf16) return launch_maxfree<D, kBf16, kLane, true, false>(p, b, block_q, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Common arguments: q, k (K^T for kt), v and o are bf16 with a contiguous last
// dim; strides holds 12 values, the (batch, head, row) strides in elements of
// q, k, v and o in that order (a row of K^T is one of its d rows). scale is
// d^-1/2 as f32. exp_mode: 0 = exp, 1 = mul, 2 = bf16. block_q is a multiple
// of 16 up to 128; the block has block_q / 16 warps. Each returns a
// cudaError_t (0 on success), or cudaErrorInvalidValue for a mode, head dim,
// block_q or size this library does not take. Each launches on `stream`,
// allocates nothing and does not synchronise.

// single: block_q is 64 or 128 (one or two consumer warpgroups); head_loop
// 1 = blocks own (batch, q tile) and walk the heads ("unroll", "batched");
// 0 = blocks own (batch, head, q tile) ("grid"). q, k and v are read through
// tensor maps; a map the driver will not encode returns
// hopper::kErrTensorMapEncode. A pipeline wait that never completes traps the
// kernel, which fails the launch at the next synchronisation.
int zutis_probe_single(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk, int d,
                       const long long* strides, float scale, int block_q, int head_loop, int exp_mode,
                       void* stream) {
  if (block_q != 64 && block_q != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (d != 64 && d != 96) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const int err = hopper::attention_maps(maps, q, k, v, b, h, sq, sk, d, strides);
  if (err != 0) return err;
  const Params p = make_params(q, k, v, o, h, sq, sk, strides, scale);
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
  if (!block_q_ok(block_q)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, o, h, sq, sk, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && sum_mode == kLane) return fastsm_d<64, kLane>(p, b, block_q, exp_mode, s);
  if (d == 64 && sum_mode == kMxu) return fastsm_d<64, kMxu>(p, b, block_q, exp_mode, s);
  if (d == 96 && sum_mode == kLane) return fastsm_d<96, kLane>(p, b, block_q, exp_mode, s);
  if (d == 96 && sum_mode == kMxu) return fastsm_d<96, kMxu>(p, b, block_q, exp_mode, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// kt: kt is K^T [b, h, d, >= round_up(sk, 8)] with 16-byte aligned rows;
// dots_only 1 = p = bf16(s), l = 1 (exp_mode ignored).
int zutis_probe_kt(const void* q, const void* kt, const void* v, void* o, int b, int h, int sq, int sk, int d,
                   const long long* strides, float scale, int block_q, int exp_mode, int dots_only,
                   void* stream) {
  if (!block_q_ok(block_q)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, kt, v, o, h, sq, sk, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return kt_d<64>(p, b, block_q, exp_mode, dots_only, s);
  if (d == 96) return kt_d<96>(p, b, block_q, exp_mode, dots_only, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* zutis_cuda_error_string(int err) {
  const char* own = hopper::error_string(err);
  return own != nullptr ? own : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
