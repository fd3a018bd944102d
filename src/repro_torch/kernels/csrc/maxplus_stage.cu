// Sparse-option (max,+) DP stage with a first-max backpointer: one stage of
// the fused EcoShift round's leaf DP (paper §3.2.2, DESIGN.md §14).
//
//   out[r, b] = max_j dp[r, b - kb[r, j]] + vb[r, j]     (T = double or float)
//   arg[r, b] = the first maximizing j                    (int32)
//
// with dp[r, i] read as -inf for i outside [0, nb).  Replaces the Pallas TPU
// kernel maxplus_stage_pallas_batched (src/repro/kernels/mckp_dp.py:126,
// body _maxplus_stage_kernel_batched at :88).  Like the TPU kernel it keeps
// its input type: the fused round runs it in float64.
//
// Semantics: each thread scans j in ascending order from acc = -inf,
// arg = 0 and updates only on a strict `>`, exactly the Pallas body, so a
// row that is -inf everywhere gives arg = 0 and ties keep the first j.  The
// kernel only adds and compares, so it is bitwise equal to the plain
// version: build without --use_fast_math and keep the order of j.
//
// Bound: operations.  A stage does 2 * R * NB * K add-and-compare steps
// against 8 * R * NB + 12 * R * K + 12 * R * NB bytes of traffic (float64);
// at R = 1, NB = 4096, K = 1024 that is 8.4e6 operations against ~92 KB.
// Both bounds are well under a microsecond there, so launch latency and
// the serial j chain of one thread set the time.
//
// Design: one thread per output b, TILE threads a block, grid =
// [ceil(nb / TILE), R].  The options walk in TILE-wide tiles staged in
// shared memory (kb and vb of one tile, 12 bytes an option in float64), so
// any K runs in a fixed 3 KB of shared memory: K is not capped (the tree
// waves of the hierarchical round reuse this kernel with K up to 4096).
// The dp row is read straight from global memory through __ldg: the
// window a block reads per option is TILE contiguous values, served from
// L1/L2, so nothing has to hold the whole padded row (64 KB at NB = 4096
// in float64, above the 48 KB static shared-memory limit).  At R = 1 the
// grid is only nb / TILE blocks; a persistent kernel that runs all stages
// of a row with dp resident in shared memory is the later speed work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TILE = 128;

template <typename T>
__global__ void maxplus_stage_kernel(const T* __restrict__ dp,
                                     const int32_t* __restrict__ kb,
                                     const T* __restrict__ vb,
                                     T* __restrict__ out,
                                     int32_t* __restrict__ arg, int nb,
                                     int k) {
  __shared__ int32_t s_kb[TILE];
  __shared__ T s_vb[TILE];

  const int t = threadIdx.x;
  const int b = blockIdx.x * TILE + t;
  const int64_t row = blockIdx.y;
  const T* dp_row = dp + row * nb;
  const int32_t* kb_row = kb + row * k;
  const T* vb_row = vb + row * k;
  const T neg_inf = static_cast<T>(-INFINITY);

  T acc = neg_inf;
  int32_t best = 0;
  for (int j0 = 0; j0 < k; j0 += TILE) {
    const int jt = j0 + t;
    if (jt < k) {
      s_kb[t] = kb_row[jt];
      s_vb[t] = vb_row[jt];
    }
    __syncthreads();
    const int j_end = min(TILE, k - j0);
    for (int jj = 0; jj < j_end; ++jj) {
      const int i = b - s_kb[jj];
      const T x = (i >= 0 && i < nb) ? __ldg(dp_row + i) : neg_inf;
      const T cand = x + s_vb[jj];
      if (cand > acc) {
        acc = cand;
        best = j0 + jj;
      }
    }
    __syncthreads();
  }
  if (b < nb) {
    out[row * nb + b] = acc;
    arg[row * nb + b] = best;
  }
}

template <typename T>
int launch(const T* dp, const int32_t* kb, const T* vb, T* out, int32_t* arg,
           int rows, int nb, int k, void* stream) {
  if (rows <= 0 || rows > 65535 || nb <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nb + TILE - 1) / TILE, rows);
  maxplus_stage_kernel<T><<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      dp, kb, vb, out, arg, nb, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one row-batched stage on `stream`.  dp, out: [rows, nb]; kb, vb:
// [rows, k]; arg: [rows, nb] int32; all contiguous on the current device.
// Returns cudaGetLastError() right after the launch (0 = launched).
int maxplus_stage_batched_f64(const double* dp, const int32_t* kb,
                              const double* vb, double* out, int32_t* arg,
                              int rows, int nb, int k, void* stream) {
  return launch<double>(dp, kb, vb, out, arg, rows, nb, k, stream);
}

int maxplus_stage_batched_f32(const float* dp, const int32_t* kb,
                              const float* vb, float* out, int32_t* arg,
                              int rows, int nb, int k, void* stream) {
  return launch<float>(dp, kb, vb, out, arg, rows, nb, k, stream);
}

const char* maxplus_stage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
