// Dense (max,+) convolution: one EcoShift cluster-DP stage (paper §3.2.2).
//
//   out[r, b] = max_{0 <= k <= b} dp[r, b - k] + f[r, k]      (float32)
//   arg[r, b] = the smallest maximizing k                       (int32)
//
// Replaces the Pallas TPU kernels maxplus_conv_pallas_batched
// (src/repro/kernels/mckp_dp.py:194) and maxplus_conv_pallas
// (src/repro/kernels/mckp_dp.py:247); the single-row form is the R = 1
// call of this kernel, so both are bitwise the same row.
//
// Semantics: each thread scans k in ascending order from acc = -inf,
// arg = 0 and updates only on a strict `>`, exactly the Pallas body
// (mckp_dp.py:64-85).  The kernel only adds and compares in float32, so it
// is bitwise equal to the plain version: build without --use_fast_math
// and keep the order of k.
//
// Bound: operations.  One stage reads and writes 16 * R * NB bytes but
// does R * NB * (NB + 1) / 2 add-and-compare candidates; at NB = 11288 that
// is ~6.4e7 candidates per row against ~0.2 MB of traffic.
//
// Design: one block of TILE threads owns TILE consecutive outputs of one
// row (grid = [ceil(NB / TILE), R]).  k walks the row in TILE-wide tiles;
// each tile stages f[k0, k0 + TILE) and the dp window the block's outputs
// read for those k (2 * TILE - 1 values, -inf left of dp[0]) in shared
// memory, so any NB runs in 3 KB of shared memory per block.  Blocks to
// the right do more tiles (output b needs b + 1 candidates); that load
// imbalance and the few blocks one row gives (NB / TILE = 89 at
// NB = 11288, on 132 SMs) are what a faster version would fix.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TILE = 128;

__global__ void maxplus_conv_kernel(const float* __restrict__ dp,
                                    const float* __restrict__ f,
                                    float* __restrict__ out,
                                    int32_t* __restrict__ arg, int nb) {
  __shared__ float s_f[TILE];
  __shared__ float s_dp[2 * TILE];

  const int t = threadIdx.x;
  const int b0 = blockIdx.x * TILE;
  const int b = b0 + t;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * nb;
  const float* dp_row = dp + row;
  const float* f_row = f + row;

  float acc = -INFINITY;
  int32_t best = 0;
  // the last output of the block is b0 + TILE - 1 (or nb - 1): no k beyond
  // it can reach a real dp entry
  const int k_end = min(b0 + TILE, nb);
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    // s_dp[p] = dp[b0 - k0 - (TILE - 1) + p]; thread t at k = k0 + j reads
    // dp[b - k] = s_dp[TILE - 1 + t - j]
    const int w0 = b0 - k0 - (TILE - 1);
    for (int p = t; p < 2 * TILE; p += TILE) {
      const int i = w0 + p;
      s_dp[p] = (i >= 0 && i < nb) ? dp_row[i] : -INFINITY;
    }
    const int kf = k0 + t;
    s_f[t] = kf < nb ? f_row[kf] : -INFINITY;
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) {
      const float cand = s_dp[TILE - 1 + t - j] + s_f[j];
      if (cand > acc) {
        acc = cand;
        best = k0 + j;
      }
    }
    __syncthreads();
  }
  if (b < nb) {
    out[row + b] = acc;
    arg[row + b] = best;
  }
}

}  // namespace

extern "C" {

// Launches the row-batched convolution on `stream`.  dp, f, out: [rows, nb]
// float32 and arg: [rows, nb] int32, all contiguous on the current device.
// Returns cudaGetLastError() right after the launch (0 = launched).
int maxplus_conv_batched(const float* dp, const float* f, float* out,
                         int32_t* arg, int rows, int nb, void* stream) {
  if (rows <= 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nb + TILE - 1) / TILE, rows);
  maxplus_conv_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      dp, f, out, arg, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* maxplus_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
