// Batched Hungarian assignment (Jonker-Volgenant shortest augmenting path
// with dual potentials) for Hopper (sm_90a), behind a plain C interface.
//
// Replaces zutis_tpu/ops/hungarian.py::hungarian / batched_hungarian, which
// the JAX package runs on the device inside the training step as two
// lax.while_loops (no host round trip). This is not the counterpart of a
// Pallas kernel but of XLA's while loops: eager PyTorch would need a host
// sync per loop step, or a fixed unrolling of about a thousand small launches.
//
// Design: one warp a problem, a block each, with no block barrier (only
// __syncwarp); four problems a block ran 7-12% slower on an H100. Lane
// l holds columns l, l + 32, ... (K = C / 32 rounded up to a power of two, a
// template argument chosen by C): their `shortest`, `v` and `path` in
// registers, the scanned flags as bits of one register, and the flags of the
// rows it owns (r % 32 == l) as bits of another. The [R, C] costs, u,
// col4row and row4col live in the warp's shared memory. Each Dijkstra step
// reads the current row's costs and u (a broadcast), updates the lane's
// columns, and takes the argmin over (value, column) with the lowest column
// winning ties, as jnp.argmin does: a local pass over the lane's columns on
// order-preserving integer keys of the values, then two redux.sync
// reductions (the least key, then the lowest column holding it), after
// which every lane holds the winner, reads its row4col and takes its value
// from its lane by one shuffle. At the end of a row's search the lanes write
// `shortest` and `path` to shared memory for the dual updates of the rows
// and the augment, which lane 0 walks. The arithmetic is the JAX loop's, in
// its order: ((minval + cost[i][j]) - u[i]) - v[j], u + (minval - shortest),
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
// B in and 1,920 B out, ~0.06 us at 3.35 TB/s: less than a launch), and so
// are the operations. What bounds it is latency: the serial chain of up to
// R (R + 1) / 2 Dijkstra steps a problem (55 at R = 10; fewer where a row's
// best column is free), each a shared-memory read, three dependent adds,
// the lane's K compares and two warp reductions deep, plus each row's dual
// updates and serial augment; the problems run side by side on their own
// SMs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxCols = 1024;

// The key of a value: unsigned order is the floats' order, -0 equal to
// +0. Values here are never NaN: `shortest` only takes a reduced cost that
// compares below it.
__device__ __forceinline__ uint32_t value_key(float f) {
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's first minimum: the least key, and the lowest column among the
// lanes that hold it; every lane gets the column.
__device__ __forceinline__ int warp_first_min(uint32_t key, int column) {
  const uint32_t least = __reduce_min_sync(0xffffffffu, key);
  return static_cast<int>(__reduce_min_sync(0xffffffffu, key == least ? static_cast<uint32_t>(column) : 0xffffffffu));
}

__device__ __forceinline__ int wrap(int idx, int n) { return idx < 0 ? idx + n : idx; }

// Bytes of a problem's shared memory: costs, u, col4row, row4col, shortest,
// path.
constexpr size_t problem_smem(int R, int C) {
  return 4 * static_cast<size_t>(R) * C + 8 * static_cast<size_t>(R) + 12 * static_cast<size_t>(C);
}

template <int K>
__global__ void __launch_bounds__(32) hungarian_kernel(const float* __restrict__ cost, int* __restrict__ out, int R,
                                                       int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const size_t prob = blockIdx.x;
  float* c = reinterpret_cast<float*>(smem);           // [R * C]
  float* u = c + R * C;                                // [R]
  int* col4row = reinterpret_cast<int*>(u + R);        // [R]
  int* row4col = col4row + R;                          // [C]
  float* shortest_s = reinterpret_cast<float*>(row4col + C);  // [C]
  int* path_s = reinterpret_cast<int*>(shortest_s + C);       // [C]
  const float inf = __int_as_float(0x7f800000);

  const float* src = cost + prob * R * C;
  const int n = R * C;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* c4 = reinterpret_cast<float4*>(c);
#pragma unroll 4
    for (int t = lane; t < n / 4; t += 32) c4[t] = s4[t];
  } else {
#pragma unroll 4
    for (int t = lane; t < n; t += 32) c[t] = src[t];
  }
  for (int r = lane; r < R; r += 32) {
    u[r] = 0.0f;
    col4row[r] = -1;
  }
  for (int j = lane; j < C; j += 32) row4col[j] = -1;
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0f;
  __syncwarp();

  for (int cur = 0; cur < R; ++cur) {
    float shortest[K];
    int path[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      shortest[k] = inf;
      path[k] = -1;
    }
    uint32_t sc = 0;  // bit k: column lane + 32 k scanned
    uint32_t sr = 0;  // bit m: row lane + 32 m scanned
    int i = cur;
    float minval = 0.0f;
    int sink = -1;
    for (int it = 1;; ++it) {
      if (lane == (i & 31)) sr |= 1u << (i >> 5);
      const float ui = u[i];
      const float* ci = c + i * C;
      uint32_t best = 0xffffffffu;  // above every value's key
      int first = 0x7fffffff;
      float value = inf;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        if (j < C) {
          const float reduced = ((minval + ci[j]) - ui) - v[k];
          const bool scanned = (sc >> k) & 1u;
          if (reduced < shortest[k] && !scanned) {
            shortest[k] = reduced;
            path[k] = i;
          }
          const float masked = scanned ? inf : shortest[k];
          const uint32_t key = value_key(masked);
          if (key < best) {
            best = key;
            first = j;
            value = masked;
          }
        }
      }
      const int j = warp_first_min(best, first);
      minval = __shfl_sync(0xffffffffu, value, j & 31);  // the winner's own bits
      if (lane == (j & 31)) sc |= 1u << (j >> 5);
      const int next = row4col[j];
      if (next < 0 || it >= C) {
        sink = j;
        break;
      }
      i = next;
    }

    // dual updates, each from the values before any of them
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      if (j < C) {
        shortest_s[j] = shortest[k];
        path_s[j] = path[k];
        if ((sc >> k) & 1u) v[k] = v[k] - (minval - shortest[k]);
      }
    }
    __syncwarp();
    for (int r = lane, m = 0; r < R; r += 32, ++m) {
      if (r != cur && ((sr >> m) & 1u)) u[r] = u[r] + (minval - shortest_s[wrap(col4row[r], C)]);
    }
    __syncwarp();
    if (lane == 0) {
      u[cur] = u[cur] + minval;
      // augment along the alternating path back to `cur`; R + 1 steps
      // bound it when a NaN cost left `path` garbage
      int j = sink;
      for (int it = 1;; ++it) {
        const int jw = wrap(j, C);
        const int row = path_s[jw];
        row4col[jw] = row;
        const int rw = wrap(row, R);
        const int prev = col4row[rw];
        col4row[rw] = j;
        j = prev;
        if (row == cur || it > R) break;
      }
    }
    __syncwarp();
  }
  for (int r = lane; r < R; r += 32) out[prob * R + r] = col4row[r];
}

template <int K>
int launch(const float* cost, int* out, int P, int R, int C, cudaStream_t stream) {
  const size_t smem = problem_smem(R, C);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(hungarian_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // a later launch check must not see it again
      return static_cast<int>(err);
    }
  }
  hungarian_kernel<K><<<P, 32, smem, stream>>>(cost, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cost: [P, R, C] float32, contiguous, R <= C <= 1024; out: [P, R] int32.
// Launches on `stream` and returns cudaGetLastError().
int zutis_hungarian(const float* cost, int* out, int P, int R, int C, void* stream) {
  if (P <= 0 || R <= 0 || R > C || C > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32) return launch<1>(cost, out, P, R, C, s);
  if (C <= 64) return launch<2>(cost, out, P, R, C, s);
  if (C <= 128) return launch<4>(cost, out, P, R, C, s);
  if (C <= 256) return launch<8>(cost, out, P, R, C, s);
  if (C <= 512) return launch<16>(cost, out, P, R, C, s);
  return launch<32>(cost, out, P, R, C, s);
}

const char* zutis_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
