// Sparse-option (max,+) DP stages with a first-max backpointer: the leaf
// scan of the fused EcoShift round (paper §3.2.2, DESIGN.md §14).  One
// stage is
//
//   out[r, b] = max_j dp[r, b - kb[r, j]] + vb[r, j]     (T = double or float)
//   arg[r, b] = the first maximizing j                    (int32)
//
// with dp[r, i] read as -inf for i outside [0, nb).  Replaces the Pallas TPU
// kernel maxplus_stage_pallas_batched (src/repro/kernels/mckp_dp.py:126,
// body _maxplus_stage_kernel_batched at :88) and the lax.scan around it in
// the JAX leaf_scan (src/repro/core/mckp.py:1912-1927): the multi-stage
// entry runs S stages in one launch, each stage's out set to -inf where
// b > tmax[r] when tmax is given, and writes every stage's arg into
// wins[S, R, NB].  The single stage is its S = 1, unmasked call.  Like the
// TPU kernel it keeps its input type: the fused round runs float64.
//
// Semantics: the serial scan over j in ascending order from (-inf, 0) that
// updates only on a strict `>`, so an all -inf column gives arg = 0, ties
// keep the first j and the sign of a zero is the first maximizer's.  The
// kernel only adds and compares: build without --use_fast_math.
//
// Bound: operations.  A stage does 2 * R * NB * K add-and-compare steps
// against 8 * R * NB + 12 * R * K + 12 * R * NB bytes (float64); at R = 1,
// NB = 4096, K = 1024 that is 8.4e6 operations (0.25 us at 34 TFLOP/s)
// against ~92 KB.  A stage is too small to be bound by either on the card:
// its time is latency — one dependent compare chain, the reload of the dp
// row and the barrier between stages — so the design spreads each stage
// over every SM and keeps each chain short.
//
// Design: a persistent cooperative grid, one block of 32 warps an SM.
// * Work items are (row, 32-wide b-group) pairs; each block takes a
//   contiguous range of them, the same in every stage.  At R = 1 and
//   NB = 4096 that is 128 blocks of one group each.
// * In a block, lane l of every warp holds output b = 32 g + l, and warp w
//   takes the options j = w, w + 32, ... in ascending order with a strict
//   `>`, starting from (-inf, w): 32 options a warp at K = 1024, four
//   loaded ahead of their compares.
// * The warps' partials of a b merge by a butterfly of shuffles under the
//   lexicographic rule: a larger value wins; on equal values (`==`, so
//   -0.0 ties +0.0) the smaller j wins and keeps its value.  The partials'
//   j are distinct, so the rule is a total order and any merge tree gives
//   the serial scan's result bit for bit, including arg = 0 on an all -inf
//   column.  No atomics, no packed keys.
// * Reads without branches: an index b - kb off [0, nb) is clamped onto a
//   -inf sentinel kept after the row in shared memory, so every candidate
//   is computed as the serial scan computes it; kb need not be sorted.  A
//   warp-vote skip of options that give a group only -inf candidates was
//   timed and cost more than the reads it saved.
// * Options stream through shared memory in chunks of KC, double-buffered
//   with cp.async: the next step's chunk (of this stage or the next) loads
//   while the current one is scanned.  Any K runs.
// * Stages inside the launch: each stage writes its masked out into a row
//   buffer in device memory, ping-ponging between `out` and a workspace row
//   so that the last stage lands in `out`; a grid barrier (cooperative
//   launch) separates the stages.  Resident route: at its first item of a
//   row in a stage, a block copies the whole previous dp row into shared
//   memory (32 KB at NB = 4096 in float64) through L2 (ld.global.cg, so no
//   stale L1 line is read) and every candidate reads it there.  Global
//   route, where the row does not fit (float64 NB above ~23 000): every
//   candidate reads dp through L2.
// * Why not one thread-block cluster a row, with dp in every block's shared
//   memory and cluster barriers between stages: a cluster holds at most 16
//   of the 132 SMs, so a stage costs the compare chain of 256 outputs a
//   block.  On an H100 80GB HBM3 at 700 W that design took 0.80 ms for the
//   fused round's 40 stages, this one 0.22 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 32;  // warps a block = j-subsets of a b-group
constexpr int THREADS = WARPS * 32;
constexpr int KC = 1024;   // options a shared-memory chunk
constexpr int UNROLL = 4;  // options a warp loads ahead of their compares
constexpr int PAD = 33;    // row stride of the partials (spreads the banks)

template <typename T>
struct Opt {
  T v;
  int32_t k;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  if constexpr (sizeof(T) == 8) {
    cp_async8(dst, src);
  } else {
    cp_async4(dst, src);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
constexpr size_t base_smem() {
  return 2 * KC * sizeof(Opt<T>) + WARPS * PAD * (sizeof(T) + sizeof(int32_t));
}

// S stages over rows [R, nb]: dp0 [R, nb]; kb, vb [S, R, k]; tmax [R] or
// null; out [R, nb] (the last stage, masked); wins [S, R, nb]; ws [R, nb]
// (S > 1 only).  Launched cooperatively with at most R * ceil(nb / 32)
// blocks, so every block has at least one item.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    maxplus_stages_kernel(const T* __restrict__ dp0, const int32_t* __restrict__ kb,
                          const T* __restrict__ vb, const int32_t* __restrict__ tmax, T* out,
                          int32_t* __restrict__ wins, T* ws, int stages, int rows, int nb,
                          int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  Opt<T>* obuf = reinterpret_cast<Opt<T>*>(smem);               // [2][KC]
  T* pv = reinterpret_cast<T*>(smem + 2 * KC * sizeof(Opt<T>));  // [WARPS][PAD]
  int32_t* pa = reinterpret_cast<int32_t*>(pv + WARPS * PAD);
  T* sdp = reinterpret_cast<T*>(pa + WARPS * PAD);  // [nb + 1], resident route

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const long long groups = (static_cast<long long>(nb) + 31) >> 5;
  const long long items = groups * rows;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
  const int chunks = (k + KC - 1) / KC;
  const long long steps = (i1 - i0) * chunks * stages;
  const T neg_inf = static_cast<T>(-INFINITY);
  const unsigned nbu = static_cast<unsigned>(nb);
  // stage s writes B(s); the last one is `out`
  auto stage_buf = [&](int s) { return ((stages - 1 - s) & 1) ? ws : out; };

  // a step is one option chunk of one item of one stage; the block walks
  // its steps in order (stage, item, chunk) and prefetches one ahead
  struct Step {
    int s;
    long long it;  // item: row r, group g
    int r;
    long long g;
    int kc;
  };
  const Step first{0, i0, static_cast<int>(i0 / groups), i0 % groups, 0};
  auto advance = [&](Step& p) {
    if (++p.kc < chunks) return;
    p.kc = 0;
    if (++p.it < i1) {
      if (++p.g == groups) {
        p.g = 0;
        ++p.r;
      }
      return;
    }
    p = Step{p.s + 1, i0, first.r, first.g, 0};
  };
  auto fetch = [&](const Step& p, int buf) {  // the step's options into obuf[buf]
    const size_t base =
        (static_cast<size_t>(p.s) * rows + p.r) * k + static_cast<size_t>(p.kc) * KC;
    const int len = min(KC, k - p.kc * KC);
    Opt<T>* o = obuf + buf * KC;
    for (int j = tid; j < len; j += THREADS) {
      cp_async(&o[j].v, vb + base + j);
      cp_async4(&o[j].k, kb + base + j);
    }
  };
  Step cur = first, nxt = first;
  fetch(nxt, 0);
  cp_async_commit();
  advance(nxt);
  if (RESIDENT && tid == 0) sdp[nb] = neg_inf;  // the sentinel that off-row reads hit

  long long loaded = -1;  // s * rows + r of the row in sdp
  T acc = neg_inf;
  int32_t arg = 0;
  for (long long n = 0; n < steps; ++n, advance(cur)) {
    cp_async_wait_all();
    __syncthreads();  // chunk n landed; every warp is done with step n - 1
    if (n + 1 < steps) {
      fetch(nxt, (n + 1) & 1);
      cp_async_commit();
      advance(nxt);
    }
    const int s = cur.s;
    const int r = cur.r;
    const int kc = cur.kc;
    const long long b0 = 32 * cur.g;
    // read now, used by the merge: its latency hides behind the scan
    const long long tm = tmax != nullptr ? tmax[r] : LLONG_MAX;
    const T* src = (s == 0 ? dp0 : stage_buf(s - 1)) + static_cast<size_t>(r) * nb;
    const T* dp = src;
    if constexpr (RESIDENT) {
      if (static_cast<long long>(s) * rows + r != loaded) {  // block-uniform
        int i = tid;
        for (; i + (UNROLL - 1) * THREADS < nb; i += UNROLL * THREADS) {
          T x[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) x[u] = __ldcg(src + i + u * THREADS);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) sdp[i + u * THREADS] = x[u];
        }
        for (; i < nb; i += THREADS) sdp[i] = __ldcg(src + i);
        __syncthreads();
        loaded = static_cast<long long>(s) * rows + r;
      }
      dp = sdp;
    }
    if (kc == 0) {
      acc = neg_inf;
      arg = w;
    }

    const Opt<T>* o = obuf + (n & 1) * KC;
    const int len = min(KC, k - kc * KC);
    const int jbase = kc * KC;
    const unsigned ub = static_cast<unsigned>(b0) + lane;
    // dp[b - kb] with idx = b - kb mod 2^32 (< nb iff on the row), -inf
    // off the row; no branch
    auto read = [&](unsigned idx) -> T {
      if constexpr (RESIDENT) {
        return dp[min(idx, nbu)];  // dp[nb] is the -inf sentinel
      } else {
        const T y = __ldcg(dp + min(idx, nbu - 1));
        return idx < nbu ? y : neg_inf;
      }
    };
    int jj = w;
    for (; jj + (UNROLL - 1) * WARPS < len; jj += UNROLL * WARPS) {
      Opt<T> op[UNROLL];
      T x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) op[u] = o[jj + u * WARPS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) x[u] = read(ub - static_cast<unsigned>(op[u].k));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const T cand = x[u] + op[u].v;
        if (cand > acc) {
          acc = cand;
          arg = jbase + jj + u * WARPS;
        }
      }
    }
    for (; jj < len; jj += WARPS) {
      const Opt<T> op = o[jj];
      const T cand = read(ub - static_cast<unsigned>(op.k)) + op.v;
      if (cand > acc) {
        acc = cand;
        arg = jbase + jj;
      }
    }
    if (kc != chunks - 1) continue;

    // the group's options are done: warp w merges the 32 partials of b0 + w
    pv[w * PAD + lane] = acc;
    pa[w * PAD + lane] = arg;
    __syncthreads();
    T v = pv[lane * PAD + w];
    int32_t a = pa[lane * PAD + w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T v2 = __shfl_xor_sync(0xffffffffu, v, off);
      const int32_t a2 = __shfl_xor_sync(0xffffffffu, a, off);
      if (v2 > v || (v2 == v && a2 < a)) {
        v = v2;
        a = a2;
      }
    }
    const long long b = b0 + w;
    if (lane == 0 && b < nb) {
      const size_t at = static_cast<size_t>(r) * nb + b;
      wins[static_cast<size_t>(s) * rows * nb + at] = a;
      if (b > tm) v = neg_inf;
      stage_buf(s)[at] = v;
    }
    // every block's stage-s outputs are written before any reads them
    if (cur.it == i1 - 1 && s < stages - 1) cg::this_grid().sync();
  }
}

// Blocks of one instantiation that the card holds at once at `smem` bytes
// of dynamic shared memory (one an SM: 1024 threads of at most 64
// registers), asked once per (device, smem) and kept.  The kernel's
// dynamic shared memory limit is raised to the device's opt-in limit once
// per device before.  ctypes calls without the GIL, so the cache is locked.
template <typename T, bool RESIDENT>
cudaError_t capacity(int device, size_t smem, int* blocks) {
  struct Fit {
    int device;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<int> configured;
  static std::vector<Fit> fits;
  std::lock_guard<std::mutex> lock(mu);
  for (const Fit& f : fits) {
    if (f.device == device && f.smem == smem) {
      *blocks = f.blocks;
      return cudaSuccess;
    }
  }
  auto kernel = maxplus_stages_kernel<T, RESIDENT>;
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess &&
      std::find(configured.begin(), configured.end(), device) == configured.end()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess) configured.push_back(device);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  fits.push_back(Fit{device, smem, per_sm * sms});
  *blocks = per_sm * sms;
  return cudaSuccess;
}

struct Plan {
  bool resident;
  int blocks;
  size_t smem;
};

// Route and grid of a launch over [rows, nb], from the shapes and the
// device's limits alone (never from device data, so a call stays
// asynchronous and capturable in a CUDA graph).
template <typename T>
cudaError_t make_plan(int rows, int nb, Plan* p) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t resident_smem = base_smem<T>() + (static_cast<size_t>(nb) + 1) * sizeof(T);
  p->resident = resident_smem <= static_cast<size_t>(optin);
  p->smem = p->resident ? resident_smem : base_smem<T>();
  int blocks = 0;
  err = p->resident ? capacity<T, true>(device, p->smem, &blocks)
                    : capacity<T, false>(device, p->smem, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  const long long items = (static_cast<long long>(nb) + 31) / 32 * rows;
  p->blocks = static_cast<int>(std::min<long long>(blocks, items));
  return cudaSuccess;
}

template <typename T>
int launch(const T* dp0, const int32_t* kb, const T* vb, const int32_t* tmax, T* out,
           int32_t* wins, T* ws, int stages, int rows, int nb, int k, void* stream) {
  if (stages <= 0 || rows <= 0 || rows > 65535 || nb <= 0 || k <= 0 ||
      (stages > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = make_plan<T>(rows, nb, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = p.resident
            ? cudaLaunchKernelEx(&cfg, maxplus_stages_kernel<T, true>, dp0, kb, vb, tmax, out,
                                 wins, ws, stages, rows, nb, k)
            : cudaLaunchKernelEx(&cfg, maxplus_stages_kernel<T, false>, dp0, kb, vb, tmax, out,
                                 wins, ws, stages, rows, nb, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch `stages` stages in one launch on `stream`.  dp0, out: [rows, nb];
// kb, vb: [stages, rows, k]; tmax: [rows] int32 or null (no mask); wins:
// [stages, rows, nb] int32; ws: [rows, nb] when stages > 1, else unused
// (may be null); all contiguous on the current device.  Returns
// cudaGetLastError() right after the launch (0 = launched).  The single
// stage of maxplus_stage_pallas_batched is the stages = 1, unmasked call.
int maxplus_stages_batched_f64(const double* dp0, const int32_t* kb, const double* vb,
                               const int32_t* tmax, double* out, int32_t* wins, double* ws,
                               int stages, int rows, int nb, int k, void* stream) {
  return launch<double>(dp0, kb, vb, tmax, out, wins, ws, stages, rows, nb, k, stream);
}

int maxplus_stages_batched_f32(const float* dp0, const int32_t* kb, const float* vb,
                               const int32_t* tmax, float* out, int32_t* wins, float* ws,
                               int stages, int rows, int nb, int k, void* stream) {
  return launch<float>(dp0, kb, vb, tmax, out, wins, ws, stages, rows, nb, k, stream);
}

// The launch plan over [rows, nb] for elements of `itemsize` bytes (8 or 4)
// on the current device: plan[0] = 1 for the resident route (the dp row in
// shared memory), plan[1] = grid blocks, plan[2] = dynamic shared memory
// bytes.
int maxplus_stages_plan(int rows, int nb, int itemsize, int* plan) {
  if (rows <= 0 || nb <= 0 || (itemsize != 8 && itemsize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err =
      itemsize == 8 ? make_plan<double>(rows, nb, &p) : make_plan<float>(rows, nb, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.resident ? 1 : 0;
  plan[1] = p.blocks;
  plan[2] = static_cast<int>(p.smem);
  return 0;
}

const char* maxplus_stage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
