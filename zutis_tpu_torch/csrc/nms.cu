// The rounds of per-category greedy mask NMS for Hopper (sm_90a), behind a
// plain C interface: one warp an image, every round in one launch.
//
// Replaces the selection loop of zutis_tpu/ops/nms.py::mask_nms, which the
// JAX package runs on the device as one lax.fori_loop of Q rounds (:58-87),
// vmapped over the batch inside the jitted serving and eval steps. This is
// not the counterpart of a Pallas kernel but of XLA's loop: eager PyTorch
// writes the rounds out as a Python loop of a dozen small launches each
// (ops/nms.py::nms_rounds_reference, 100 rounds at Q = 100), and the kernel
// runs them all in one. The pairwise IoU is computed before it, as in JAX,
// by its own kernel (csrc/mask_iou.cu: exact int32 intersection counts on
// s8 wgmma, as JAX's int8 product; ops/nms.py::pairwise_iou).
//
// Design: one block of one warp an image. Lane l holds candidates
// l, l + 32, ... (K = Q / 32 rounded up to a power of two, a template
// argument): their current score, its key and their category in
// registers, the candidate flags (eligible, not yet kept or dropped) as
// bits of one register. A score's key is an unsigned integer in the order
// torch.argmax and jnp.argmax give the scores: a NaN above every number,
// -0 equal to +0. Each round takes the warp's first maximum in two
// redux.sync reductions, the largest key and then the lowest index holding
// it, so that ties go to the first maximum; a NaN winner is not selected,
// since NaN > -inf is false. The winner's category is read from shared
// memory. Each lane then reads the winner's IoU row at its own candidates
// of that category and re-weights them with the plain loop's f32
// operations in its order: hard where(iou > thr, 0, 1), linear
// where(iou > thr, 1 - iou, 1), gaussian exp(-(iou * iou) * (1 / sigma))
// (PyTorch on the card divides a tensor by a host scalar as a product with
// its reciprocal; built without fast math), then cur * w and the floor
// test cur > score_floor. Only __syncwarp is used.
//
// The [Q, Q] IoU block goes into shared memory where it fits beside the
// categories (Q <= 240 within 227 KB), by one cp.async.bulk on an mbarrier
// when its address and size are multiples of 16 bytes, else by the warp's
// own loads; the bulk copy flies while the lanes load their candidates and
// take the first round's maximum. A larger block stays in device memory and
// each round reads the winner's row there (coalesced). Q > 1024 is refused.
//
// Early stop: the loop ends at the first round that selects nothing. Such a
// round changes neither keep, the scores nor the candidates (every weight
// is 1), so every later round repeats it, and stopping there gives what Q
// rounds give, the NaN case included (once a NaN score is live, nothing is
// ever selected again).
//
// Bound: bytes. At serving's [8, 100] the IoU block is 320,000 B and the
// rest ~17 KB (0.1 us at 3.35 TB/s); at eval's [32, 100] 1.28 MB (0.4 us).
// What bounds it on the card is latency: a chain of (selected + 1) rounds an
// image, each two warp reductions and two shared-memory reads (the
// winner's category, then its IoU row) deep; the images run side by side on
// their own SMs.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxQ = 1024;
constexpr int kHard = 0, kLinear = 1, kGaussian = 2;

// Dynamic shared memory: the categories [Q] int64, then, where it fits, the
// IoU block [Q, Q] f32 from a 16-byte boundary; the static mbarrier aside.
__host__ __device__ constexpr size_t cats_bytes(int q) { return (8 * static_cast<size_t>(q) + 15) / 16 * 16; }
__host__ __device__ constexpr bool iou_in_smem(int q) {
  return cats_bytes(q) + 4 * static_cast<size_t>(q) * q <= static_cast<size_t>(kSmemLimit) - 64;
}

// The key of a live score: unsigned order is torch.argmax's order of the
// floats, with every NaN above +inf and -0 equal to +0.
__device__ __forceinline__ uint32_t score_key(float f) {
  if (f != f) return 0xffffffffu;
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
constexpr uint32_t kNegInfKey = ~0xff800000u;  // score_key(-inf)
constexpr uint32_t kNanKey = 0xffffffffu;

// The warp's first maximum: the largest key, and the lowest index among
// the lanes that hold it; every lane gets both.
__device__ __forceinline__ uint32_t warp_first_max(uint32_t key, int index, int* first) {
  const uint32_t top = __reduce_max_sync(0xffffffffu, key);
  *first = static_cast<int>(__reduce_min_sync(0xffffffffu, key == top ? static_cast<uint32_t>(index) : 0xffffffffu));
  return top;
}

struct Params {
  const float* iou;       // [b, Q, Q]
  const float* areas;     // [b, Q]
  const float* scores;    // [b, Q]
  const long long* cats;  // [b, Q]
  unsigned char* keep;    // [b, Q]
  float* out;             // [b, Q]
  int q;
  int type;
  float threshold;
  float floor;
  float inv_sigma;
};

// K candidates a lane; kSmem: the IoU block in shared memory, else each
// round's row read from device memory
template <int K, bool kSmem>
__global__ void __launch_bounds__(32) nms_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const int q = p.q;
  const size_t img = blockIdx.x;
  const float* iou_g = p.iou + img * q * q;
  long long* cats_s = reinterpret_cast<long long*>(smem);
  float* iou_s = reinterpret_cast<float*>(smem + cats_bytes(q));
  const uint32_t bar_addr = smem_u32(&bar);
  bool waited = true;
  if (kSmem) {
    const uint32_t bytes = 4u * q * q;
    if ((reinterpret_cast<uintptr_t>(iou_g) & 15) == 0 && (bytes & 15) == 0) {
      waited = false;
      if (lane == 0) {
        mbar_init(bar_addr, 1);
        fence_barrier_init();
        mbar_arrive_expect_tx(bar_addr, bytes);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                smem_u32(iou_s)),
            "l"(iou_g), "r"(bytes), "r"(bar_addr)
            : "memory");
      }
    } else {
      for (int t = lane; t < q * q; t += 32) iou_s[t] = iou_g[t];
    }
  }

  // this lane's candidates j = lane + 32 k
  float cur[K];
  uint32_t key[K];
  long long cat[K];
  uint32_t cand = 0;  // bit k: a candidate (eligible, not yet kept or dropped)
  uint32_t kept = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    cur[k] = 0.0f;
    cat[k] = 0;
    if (j < q) {
      cur[k] = p.scores[img * q + j];
      cat[k] = p.cats[img * q + j];
      cats_s[j] = cat[k];
      if (cat[k] != 0 && p.areas[img * q + j] > 0.0f) cand |= 1u << k;
    }
    key[k] = score_key(cur[k]);
  }
  __syncwarp();  // the categories and the warp's own copy of the block are written

  for (int round = 0; round < q; ++round) {
    uint32_t best = 0;  // below every live key
    int first = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((cand >> k) & 1u) && key[k] > best) {
        best = key[k];
        first = lane + 32 * k;
      }
    }
    int i;
    best = warp_first_max(best, first, &i);
    if (best <= kNegInfKey || best == kNanKey) break;  // nothing selected: see the note

    if (lane == (i & 31)) {
      kept |= 1u << (i >> 5);
      cand &= ~(1u << (i >> 5));
    }
    if (!waited) {
      mbar_wait(bar_addr, 0);
      waited = true;
    }
    const long long wcat = cats_s[i];
    const float* row = (kSmem ? iou_s : iou_g) + static_cast<size_t>(i) * q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((cand >> k) & 1u) && cat[k] == wcat) {
        const float x = row[lane + 32 * k];
        float w;
        if (p.type == kHard) {
          w = x > p.threshold ? 0.0f : 1.0f;
        } else if (p.type == kLinear) {
          w = x > p.threshold ? 1.0f - x : 1.0f;
        } else {
          w = expf(-(x * x) * p.inv_sigma);
        }
        cur[k] = cur[k] * w;
        key[k] = score_key(cur[k]);
        if (!(cur[k] > p.floor)) cand &= ~(1u << k);
      }
    }
  }
  // a bulk copy may not be left in flight when the block exits
  if (!waited) mbar_wait(bar_addr, 0);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < q) {
      p.keep[img * q + j] = (kept >> k) & 1u;
      p.out[img * q + j] = cur[k];
    }
  }
}

template <int K, bool kSmem>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = cats_bytes(p.q) + (kSmem ? 4 * static_cast<size_t>(p.q) * p.q : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(nms_kernel<K, kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // a later launch check must not see it again
      return static_cast<int>(err);
    }
  }
  nms_kernel<K, kSmem><<<b, 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// iou: [b, Q, Q] f32; areas, scores: [b, Q] f32; cats: [b, Q] int64, all
// contiguous, 1 <= Q <= 1024; keep: [b, Q] uint8 (bool), out: [b, Q] f32.
// type: 0 hard, 1 linear, 2 gaussian; inv_sigma = 1 / sigma in f32.
// Launches on `stream` and returns cudaGetLastError().
int zutis_nms_rounds(const float* iou, const float* areas, const float* scores, const long long* cats,
                     unsigned char* keep, float* out, int b, int q, int type, float threshold, float floor,
                     float inv_sigma, void* stream) {
  if (b <= 0 || q <= 0 || q > kMaxQ || type < kHard || type > kGaussian) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{iou, areas, scores, cats, keep, out, q, type, threshold, floor, inv_sigma};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q <= 32) return launch<1, true>(p, b, s);
  if (q <= 64) return launch<2, true>(p, b, s);
  if (q <= 128) return launch<4, true>(p, b, s);
  if (iou_in_smem(q)) return launch<8, true>(p, b, s);
  if (q <= 256) return launch<8, false>(p, b, s);
  if (q <= 512) return launch<16, false>(p, b, s);
  return launch<32, false>(p, b, s);
}

// Whether the kernel keeps a [Q, Q] IoU block in shared memory.
int zutis_nms_iou_in_smem(int q) { return iou_in_smem(q); }

const char* zutis_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
