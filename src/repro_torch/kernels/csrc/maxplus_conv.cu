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
// Semantics: the Pallas body (mckp_dp.py:64-85) scans k in ascending order
// from acc = -inf, arg = 0 and updates only on a strict `>`: the result is
// the first k whose candidate equals the row's maximum (-0.0 == +0.0), and
// out is that candidate's bits.  This kernel only adds and compares in
// float32 and keeps that rule exactly, so it is bitwise equal to the plain
// version: build without --use_fast_math.  The inputs hold no NaN (DP
// values are finite or -inf); the merge below relies on that.
//
// Bound: operations.  One stage reads and writes 16 * R * NB bytes but
// does R * NB * (NB + 1) / 2 add-and-compare candidates; at NB = 11288 that
// is ~6.4e7 candidates per row against ~0.2 MB of traffic.
//
// Design: the triangle of (output b, candidate k <= b) is cut into work
// items spread over the whole card, merged exactly by one 64-bit atomicMax
// per output and item, and decoded in the same launch.
// * A work item is (row, b-tile of BT = 256 outputs, k-chunk of KC = 1024
//   candidates) with a k-chunk that reaches the tile (k <= the tile's last
//   output): at R = 1, NB = 11288 that is 276 items of 256 threads (the
//   grid is (k-chunks, b-tiles, R); a block whose chunk lies wholly past
//   its tile returns at once).  Every full item does the same work, so
//   the triangle's skew only sets how many items a tile has.
// * Inside an item, warp w takes the k sub-chunk [k0 + 128 w, k0 + 128
//   (w + 1)) for all 256 outputs; lane l owns the 8 consecutive outputs
//   b0 + 8 l + i.  The item's f chunk and dp window (1 280 values, -inf
//   outside [0, NB)) are staged in shared memory, the dp window with one
//   pad word every 8 so that lanes 8 values apart read banks 9 apart.  A
//   lane walks its k in groups of 8 with a 16-value register window of dp
//   that shifts by 8 a group: one shared load of dp and a quarter of a
//   broadcast f load serve 8 add-and-compares.  Per output and group it
//   takes the max of the 8 candidates (fmaxf) and keeps the group only on
//   a strict `>` over its running max; after the walk it finds, inside
//   the kept group, the first k whose candidate equals that max.  That is
//   the ascending strict-`>` scan, with one compare-and-select per 8
//   candidates instead of one per candidate.
// * The 8 warps' results are merged in ascending k order with strict `>`
//   (the same scan over the item's chunk), then each output's (value, k)
//   becomes a 64-bit key: the float's order-preserving bits (with -0.0
//   mapped to +0.0, so that equal values tie) in the high word and
//   0xFFFFFFFF - k in the low word.  The larger value wins and, on equal
//   values, the smaller k: again the ascending strict-`>` scan.  One
//   atomicMax a key merges the items.  The key buffer starts at 0, below
//   every key; since every output has the item with k = 0, a row whose
//   candidates are all -inf decodes to arg 0, as the scan gives it.
// * The last item of a b-tile to finish (a per-tile counter, after a
//   fence) decodes the tile's keys: arg = k, and out = dp[b - k] + f[k]
//   recomputed, so its bits are the scan's even where the key canonicalised
//   a zero.
// * The keys and counters live in a workspace that the caller allocates
//   for each call (maxplus_conv_plan gives its size) and that the entry
//   zeroes on the stream before the launch, so nothing outlives a call: a
//   CUDA graph captures the memset with the launch.  One kernel launch a
//   call.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int P = 8;                // consecutive outputs a lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BT = 32 * P;          // outputs a b-tile: one per thread in the merge
constexpr int KW = 128;             // candidates a warp takes in an item
constexpr int KC = WARPS * KW;      // candidates an item takes
constexpr int G = 8;                // candidates a group: one compare-and-select
constexpr int SPAN = BT + KC;       // dp window of an item
static_assert(BT == THREADS, "the merge gives each thread one output");
static_assert(P == G, "the register window shifts by one group");

// shared-memory index of dp window entry x: one pad word every 8
__device__ __forceinline__ int padded(int x) { return x + (x >> 3); }

__device__ __forceinline__ unsigned long long make_key(float v, int k) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;  // -0.0 ties with +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(k));
}

__global__ void __launch_bounds__(THREADS)
    maxplus_conv_kernel(const float* __restrict__ dp, const float* __restrict__ f,
                        float* __restrict__ out, int32_t* __restrict__ arg,
                        unsigned long long* __restrict__ keys,
                        unsigned int* __restrict__ done, int nb, int ntiles) {
  __shared__ float s_dp[SPAN + SPAN / 8];
  __shared__ __align__(16) float s_f[KC];
  __shared__ float s_val[WARPS][BT];
  __shared__ int s_k[WARPS][BT];
  __shared__ bool s_last;

  const int kc = blockIdx.x, tile = blockIdx.y;
  const int b0 = tile * BT;
  const int b_last = min(b0 + BT, nb) - 1;
  const int items = b_last / KC + 1;  // k-chunks that reach the tile
  if (kc >= items) return;
  const int k0 = kc * KC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = static_cast<size_t>(blockIdx.z) * nb;
  const float* dp_row = dp + row;
  const float* f_row = f + row;

  // s_f[i] = f[k0 + i]; s_dp[padded(x)] = dp[b0 - k0 - KC + x]; unrolled,
  // so that a thread's loads are all in flight together
  static_assert(KC % THREADS == 0 && SPAN % THREADS == 0, "whole staging rounds");
  const int base = b0 - k0 - KC;
  float fv[KC / THREADS], dv[SPAN / THREADS];
#pragma unroll
  for (int u = 0; u < KC / THREADS; ++u) {
    const int k = k0 + tid + u * THREADS;
    fv[u] = k < nb ? f_row[k] : -INFINITY;
  }
#pragma unroll
  for (int u = 0; u < SPAN / THREADS; ++u) {
    const int i = base + tid + u * THREADS;
    dv[u] = (i >= 0 && i < nb) ? dp_row[i] : -INFINITY;
  }
#pragma unroll
  for (int u = 0; u < KC / THREADS; ++u) s_f[tid + u * THREADS] = fv[u];
#pragma unroll
  for (int u = 0; u < SPAN / THREADS; ++u) s_dp[padded(tid + u * THREADS)] = dv[u];
  __syncthreads();

  // warp `warp`: k in [kw, kw + KW); lane: outputs b0 + P * lane + i.
  // Candidate (i, k = kw + G * g + j) reads window entry
  // x = xw + i - j - G * g, xw = P * lane + KC - KW * warp.
  const int kw = k0 + warp * KW;
  const int xw = P * lane + KC - KW * warp;
  if (kw <= b0 + BT - 1) {  // else no output of the tile reaches this k
    float acc[P];
    int grp[P];
    float hi[G];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      acc[i] = -INFINITY;
      grp[i] = 0;
      hi[i] = s_dp[padded(xw + i)];
    }
#pragma unroll 2
    for (int g = 0; g < KW / G; ++g) {
      float lo[G], fk[G];
      const int xg = xw - G * g - G;
#pragma unroll
      for (int t = 0; t < G; ++t) lo[t] = s_dp[padded(xg + t)];
      const float4 f0 = *reinterpret_cast<const float4*>(&s_f[warp * KW + G * g]);
      const float4 f1 = *reinterpret_cast<const float4*>(&s_f[warp * KW + G * g + 4]);
      fk[0] = f0.x; fk[1] = f0.y; fk[2] = f0.z; fk[3] = f0.w;
      fk[4] = f1.x; fk[5] = f1.y; fk[6] = f1.z; fk[7] = f1.w;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        // window entry t = i - j + G: lo[t] below G, hi[t - G] from G on
        float mx = hi[i] + fk[0];
#pragma unroll
        for (int j = 1; j < G; ++j) {
          const int t = i - j + G;
          mx = fmaxf(mx, (t < G ? lo[t % G] : hi[t % G]) + fk[j]);
        }
        if (mx > acc[i]) {
          acc[i] = mx;
          grp[i] = g;
        }
      }
#pragma unroll
      for (int t = 0; t < G; ++t) hi[t] = lo[t];
    }
    // the first k of the kept group whose candidate equals the max
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int g = grp[i];
      int best = G - 1;
#pragma unroll
      for (int j = G - 1; j >= 0; --j) {
        const float cand = s_dp[padded(xw + i - j - G * g)] + s_f[warp * KW + G * g + j];
        if (cand == acc[i]) best = j;
      }
      s_val[warp][P * lane + i] = acc[i];
      s_k[warp][P * lane + i] = kw + G * g + best;
    }
  }
  __syncthreads();

  // merge the warps in ascending k (strict >), one output a thread, and
  // fold the item's result into the output's key
  const int b = b0 + tid;
  if (b < nb && k0 <= b) {
    float best = -INFINITY;
    int kbest = k0;
    for (int w = 0; w < WARPS && k0 + w * KW <= b; ++w) {
      const float v = s_val[w][tid];
      if (v > best) {
        best = v;
        kbest = s_k[w][tid];
      }
    }
    atomicMax(&keys[row + b], make_key(best, kbest));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&done[static_cast<size_t>(blockIdx.z) * ntiles + tile], 1u) ==
             static_cast<unsigned>(items - 1);
  __syncthreads();
  if (!s_last) return;

  // the tile's last item: decode every key
  __threadfence();
  if (b < nb) {
    const unsigned long long key = __ldcg(&keys[row + b]);
    const int k = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    out[row + b] = dp_row[b - k] + f_row[k];
    arg[row + b] = k;
  }
}

}  // namespace

extern "C" {

// Sizes of a call over [rows, nb]: plan[0] = workspace bytes (the keys, then
// the per-tile counters), plan[1] = work items.  Returns 0, or
// cudaErrorInvalidValue for a shape past the grid's limits.
int maxplus_conv_plan(int rows, int nb, long long* plan) {
  if (rows <= 0 || rows > 65535 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (nb + BT - 1) / BT;
  if (ntiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long items = 0;
  for (long long b0 = 0; b0 < nb; b0 += BT) items += (std::min<long long>(b0 + BT, nb) - 1) / KC + 1;
  plan[0] = static_cast<long long>(rows) * (8LL * nb + 4 * ntiles);
  plan[1] = rows * items;
  return 0;
}

// Launches the row-batched convolution on `stream`.  dp, f, out: [rows, nb]
// float32 and arg: [rows, nb] int32, all contiguous on the current device;
// workspace: maxplus_conv_plan's bytes, 8-byte aligned, which the entry
// zeroes first.  Returns the first CUDA error of the memset or the launch
// (0 = launched).
int maxplus_conv_batched(const float* dp, const float* f, float* out, int32_t* arg,
                         void* workspace, int rows, int nb, void* stream) {
  long long plan[2];
  if (const int err = maxplus_conv_plan(rows, nb, plan)) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  if (const cudaError_t err = cudaMemsetAsync(workspace, 0, plan[0], st))
    return static_cast<int>(err);
  const int ntiles = (nb + BT - 1) / BT;
  auto* keys = static_cast<unsigned long long*>(workspace);
  auto* done = reinterpret_cast<unsigned int*>(keys + static_cast<size_t>(rows) * nb);
  const dim3 grid((nb - 1) / KC + 1, ntiles, rows);
  maxplus_conv_kernel<<<grid, THREADS, 0, st>>>(dp, f, out, arg, keys, done, nb, ntiles);
  return static_cast<int>(cudaGetLastError());
}

const char* maxplus_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
