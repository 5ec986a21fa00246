// Batched Hungarian assignment (Jonker-Volgenant shortest augmenting path
// with dual potentials) for Hopper (sm_90a), behind a plain C interface.
//
// Replaces zutis_tpu/ops/hungarian.py::hungarian / batched_hungarian, which
// the JAX package runs on the device inside the training step as two
// lax.while_loops (no host round trip). This is not the counterpart of a
// Pallas kernel but of XLA's while loops: eager PyTorch would need a host
// sync per loop step, or a fixed unrolling of about a thousand small launches.
//
// Design: one block per problem, one thread per column (C <= 1024). The
// [R, C] cost, the potentials u and v, shortest, path, row4col, col4row and
// the scanned flags live in shared memory. Each Dijkstra step updates every
// column in parallel, then takes a block-wide argmin over (value, column)
// with the lowest column winning ties, as jnp.argmin does; one thread then
// marks the column and follows row4col. The dual updates run in parallel,
// the augment on one thread. The arithmetic is the JAX loop's, in its
// order: ((minval + cost[i][j]) - u[i]) - v[j], u + (minval - shortest),
// v - (minval - shortest). It holds no multiply, so no FMA contraction can
// change a rounding; built without fast math, the result equals the plain
// version (ops/hungarian.py) bit for bit.
//
// Both loops keep the JAX bounds: a sink is forced after C Dijkstra steps
// and the augment stops after R + 1, so NaN costs terminate. Indices that
// only a NaN-corrupted path produces (-1) wrap from the end, as JAX reads
// them, and never leave the arrays.
//
// Bound: the bytes are tiny (at the training step's [48, 10, 100], 192,000
// B in and 1,920 B out, ~0.06 us at 3.35 TB/s), and so are the operations.
// What bounds it is latency: ~55 serial Dijkstra steps per problem, each a
// block-wide argmin through shuffles and two barriers, plus R serial
// augments; the 48 problems run side by side on 48 SMs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// column index of the padding entries of an argmin: above every real column
constexpr int kPadIndex = 1 << 20;

struct ArgMin {
  float value;
  int index;
};

// The smaller value; on a tie the lower column. Values here are never NaN:
// `shortest` only takes a reduced cost that compares below it.
__device__ __forceinline__ ArgMin take_min(ArgMin a, ArgMin b) {
  return (b.value < a.value || (b.value == a.value && b.index < a.index)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    ArgMin other;
    other.value = __shfl_down_sync(0xffffffffu, x.value, offset);
    other.index = __shfl_down_sync(0xffffffffu, x.index, offset);
    x = take_min(x, other);
  }
  return x;
}

__device__ __forceinline__ int wrap(int idx, int n) { return idx < 0 ? idx + n : idx; }

__global__ void hungarian_kernel(const float* __restrict__ cost, int* __restrict__ out, int R, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* c = reinterpret_cast<float*>(smem);            // [R * C]
  float* v = c + R * C;                                  // [C]
  float* shortest = v + C;                               // [C]
  int* path = reinterpret_cast<int*>(shortest + C);      // [C]
  int* row4col = path + C;                               // [C]
  float* u = reinterpret_cast<float*>(row4col + C);      // [R]
  int* col4row = reinterpret_cast<int*>(u + R);          // [R]
  unsigned char* sc = reinterpret_cast<unsigned char*>(col4row + R);  // [C]
  unsigned char* sr = sc + C;                            // [R]
  __shared__ ArgMin warp_best[32];
  __shared__ float s_minval;
  __shared__ int s_row, s_sink;

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const float* src = cost + static_cast<size_t>(blockIdx.x) * R * C;
  for (int t = tid; t < R * C; t += n_threads) c[t] = src[t];
  if (tid < C) {
    v[tid] = 0.0f;
    row4col[tid] = -1;
  }
  if (tid < R) {
    u[tid] = 0.0f;
    col4row[tid] = -1;
  }

  for (int cur = 0; cur < R; ++cur) {
    if (tid < C) {
      shortest[tid] = __int_as_float(0x7f800000);  // +inf
      path[tid] = -1;
      sc[tid] = 0;
    }
    if (tid < R) sr[tid] = 0;
    if (tid == 0) {
      s_row = cur;
      s_minval = 0.0f;
      s_sink = -1;
    }
    __syncthreads();

    for (int it = 1;; ++it) {
      const int i = s_row;
      const float minval = s_minval;
      if (tid == 0) sr[i] = 1;
      ArgMin best{__int_as_float(0x7f800000), kPadIndex + tid};
      if (tid < C) {
        const float reduced = ((minval + c[i * C + tid]) - u[i]) - v[tid];
        const bool scanned = sc[tid] != 0;
        if (reduced < shortest[tid] && !scanned) {
          shortest[tid] = reduced;
          path[tid] = i;
        }
        best.value = scanned ? __int_as_float(0x7f800000) : shortest[tid];
        best.index = tid;
      }
      best = warp_argmin(best);
      if ((tid & 31) == 0) warp_best[tid >> 5] = best;
      __syncthreads();  // every read of s_row and s_minval is done
      if (tid < 32) {
        ArgMin x = tid < ((n_threads + 31) >> 5)
                       ? warp_best[tid]
                       : ArgMin{__int_as_float(0x7f800000), 2 * kPadIndex + tid};
        x = warp_argmin(x);
        if (tid == 0) {
          const int j = x.index;
          s_minval = x.value;
          sc[j] = 1;
          const int next = row4col[j];
          s_sink = (next < 0 || it >= C) ? j : -1;
          s_row = next;
        }
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }

    // dual updates, each from the values before any of them
    const float minval = s_minval;
    if (tid < R && tid != cur && sr[tid]) {
      u[tid] = u[tid] + (minval - shortest[wrap(col4row[tid], C)]);
    }
    if (tid < C && sc[tid]) v[tid] = v[tid] - (minval - shortest[tid]);
    __syncthreads();
    if (tid == 0) {
      u[cur] = u[cur] + minval;
      // augment along the alternating path back to `cur`; R + 1 steps
      // bound it when a NaN cost left `path` garbage
      int j = s_sink;
      for (int it = 1;; ++it) {
        const int jw = wrap(j, C);
        const int i = path[jw];
        row4col[jw] = i;
        const int iw = wrap(i, R);
        const int prev = col4row[iw];
        col4row[iw] = j;
        j = prev;
        if (i == cur || it > R) break;
      }
    }
    __syncthreads();
  }
  if (tid < R) out[static_cast<size_t>(blockIdx.x) * R + tid] = col4row[tid];
}

}  // namespace

extern "C" {

// cost: [P, R, C] float32, contiguous, R <= C <= 1024; out: [P, R] int32.
// Launches on `stream` and returns cudaGetLastError().
int zutis_hungarian(const float* cost, int* out, int P, int R, int C, void* stream) {
  if (P <= 0 || R <= 0 || R > C || C > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(R) * C + 16 * static_cast<size_t>(C) + 8 * static_cast<size_t>(R) +
                      static_cast<size_t>(C) + static_cast<size_t>(R);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(hungarian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // a later launch check must not see it again
      return static_cast<int>(err);
    }
  }
  const int threads = (C + 31) / 32 * 32;
  hungarian_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(cost, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

const char* zutis_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
