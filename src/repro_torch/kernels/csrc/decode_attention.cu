// One-token grouped-query attention over a KV cache (flash decode): the
// attention of every layer of the serving path's decode step.
//
//   out[b, h, :] = sum_j softmax_j(s[b, h, j]) v[b, j, h / group, :]
//   s[b, h, j] = softcap * tanh((scale * q[b, h, :]) . k[b, j, h / group, :] / softcap)
//
// over the cache slots j < min(lengths[b], S) with lengths[b] - j <= window
// when a window is given; scale = 1 / sqrt(D), softcap optional.  Replaces
// the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention.py:96, body _decode_kernel at :30),
// with its masking: masked logits are NEG_INF = -1e30, their
// probabilities are 0, the denominator is max(l, 1e-30).  Running max,
// denominator and accumulator are float32 (expf, tanhf; no
// --use_fast_math); q, the cache and out are bf16 or float32.
//
// Bound: bytes.  The valid K and V rows are read once: at the serving
// path's decode shape (q [8, 32, 64], cache [8, 1024, 8, 64] bf16, lengths
// 513-543) that is ~8.9 MB, 2.7 us at 3.35 TB/s; the operations (4 * Hq *
// D per valid key and sequence, 36 MFLOP) are far below either peak.
//
// Design: split-KV over the card, combined inside the launch.
// * Grid (splits, Hkv, B): each (sequence, KV head) gets `splits` blocks
//   of 128 threads, one thread-block cluster.  The host picks `splits`
//   (at most 8, the portable cluster size) from the shapes alone: the
//   most for which the card holds all B * Hkv clusters at once (the
//   cluster occupancy API; clusters must fit inside one GPC, and a grid
//   past that ran a second wave that cost more than the extra splits
//   saved), each split at least 32 slots of the cache.  It never reads
//   `lengths`, so the call stays asynchronous and capturable in a CUDA
//   graph.  Each block reads lengths[b] and takes its even share of the
//   valid range [max(0, len - window), min(len, S)); a share may be empty.
//   At the serving shape that is a few hundred blocks of under 140 keys,
//   against the 64 blocks of ~530 keys a one-block-per-head grid gives.
// * All `group` query heads of the KV head are in the block, so each K and
//   V row is fetched from device memory once for the group.  A warp takes
//   keys in steps of 32 / LPK: LPK lanes (a power of two) share one key,
//   each lane one or more 16-byte vectors of its K and V rows (8 bf16 or 4
//   float32 values), loaded coalesced, with the next PREFETCH steps' rows
//   in flight in a ring of registers while the current one is computed
//   (four at the serving path's widths).  The ring is unrolled so that no
//   entry is ever moved (a register move of a pending load would wait for
//   it).  A lane keeps its heads' scaled q
//   and accumulators for its own columns in registers; the logits are
//   summed over the key's lanes by shuffles.  When the group has more
//   heads than a warp holds (HPW), the warps split the heads and the keys
//   between them.  Every key slot of a warp runs its own online softmax
//   (one expf a key and head), so no slot waits on another; the slots are
//   merged by shuffles at the end, and each warp's (m, l, acc) goes to
//   shared memory.
// * The combine: after a cluster barrier, every block weighs each (split,
//   warp) partial of each head, read from the other blocks' shared memory
//   (distributed shared memory): m = max m_i, l = sum e^(m_i - m) l_i;
//   then it takes a share of the group's (head, column) outputs, acc =
//   sum e^(m_i - m) acc_i, out = acc / max(l, 1e-30).  Each pass issues
//   all its remote loads together, so the combine costs two remote-load
//   latencies.  A split with no valid key contributes m = -1e30 and l = 0.
//   A second cluster barrier keeps every block's shared memory alive until
//   all have read it.  One launch a call, no workspace, no atomics: the
//   result does not depend on the blocks' order.

#include "common.cuh"

#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

using serving::from_f;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLITS = 8;        // portable thread-block cluster size
constexpr int MIN_SPLIT_KEYS = 32;   // cache slots a split covers at least
constexpr int MAXG = 16;             // query heads per KV head
constexpr int MAX_GROUP_DIM = 2048;  // group * D

// Eight bf16 or four float32 values of one 16-byte vector, as float32.
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Heads a warp holds: its q and accumulators take HPW * CPL * VEC floats
// each (32, or 64 at the widest head dims).
// PREFETCH: warp steps of K and V rows in flight (four at the serving
// path's widths, fewer where a lane's rows are wider).
template <typename T, int CPL>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);  // values a 16-byte vector
  static constexpr int HPW = 32 / (CPL * VEC) > 1 ? 32 / (CPL * VEC) : 1;
  static constexpr int PREFETCH = CPL >= 4 ? 1 : 4 / CPL;
};

// CPL: 16-byte vectors of a row a lane takes (a row of D / VEC vectors
// over LPK <= 32 lanes).
template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, const int* __restrict__ lengths,
                            T* __restrict__ out, int s, int hq, int hkv, int d, int window,
                            float softcap, float scale) {
  using L = Layout<T, CPL>;
  constexpr int VEC = L::VEC, HPW = L::HPW, PREFETCH = L::PREFETCH;
  // acc [wk][group][d], m and l [wk][group]; the block's merged m and l,
  // the splits' weights and the denominators [group] each
  extern __shared__ float smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x;  // the cluster spans x
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // lanes: LPK share one key, KPW keys a warp step
  const int nvec = d / VEC;
  int lpk = 1;
  while (lpk < nvec && lpk < 32) lpk <<= 1;
  const int kpw = 32 / lpk, slot = lane / lpk, li = lane % lpk;
  // warps: wh head groups of hpw heads x wk key groups
  const int wh = (group + HPW - 1) / HPW;
  const int hpw = (group + wh - 1) / wh;
  const int wk = WARPS / wh;
  const int hg = warp % wh, kg = warp / wh;
  const int h0 = hg * hpw;
  const int nh = kg < wk ? max(0, min(hpw, group - h0)) : 0;

  float* part = smem;
  float* mpart = smem + wk * group * d;
  float* lpart = mpart + wk * group;
  float* wts = lpart + wk * group;  // [MAX_SPLITS][WARPS][group]
  float* den = wts + MAX_SPLITS * WARPS * group;

  if (nh > 0) {
    float qr[HPW][CPL][VEC], acc[HPW][CPL][VEC], m[HPW], l[HPW];
    // q first: its loads need not wait for lengths[b]
    const T* qb = q + (static_cast<size_t>(b) * hq + static_cast<size_t>(hk) * group + h0) * d;
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int vi = li + c * lpk;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (h < nh && vi < nvec) u = *reinterpret_cast<const uint4*>(qb + h * d + vi * VEC);
        unpack(u, qr[h][c], T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          qr[h][c][e] *= scale;
          acc[h][c][e] = 0.0f;
        }
      }
    }

    // this split's even share of the valid keys
    const int len = lengths[b];
    const int kv_end = min(len, s);
    const int kv_begin = window > 0 ? max(0, len - window) : 0;
    const long long n = max(0, kv_end - kv_begin);
    const int lo = kv_begin + static_cast<int>(n * split / nsplit);
    const int hi = kv_begin + static_cast<int>(n * (split + 1) / nsplit);

    const size_t key_stride = static_cast<size_t>(hkv) * d;
    const T* kb = kc + static_cast<size_t>(b) * s * key_stride + static_cast<size_t>(hk) * d;
    const T* vb = vc + static_cast<size_t>(b) * s * key_stride + static_cast<size_t>(hk) * d;
    const int step = wk * kpw;
    auto fetch = [&](int j, uint4 (&kr)[CPL], uint4 (&vr)[CPL]) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int vi = li + c * lpk;
        kr[c] = vr[c] = make_uint4(0, 0, 0, 0);
        if (j < hi && vi < nvec) {
          const size_t off = static_cast<size_t>(j) * key_stride + vi * VEC;
          kr[c] = *reinterpret_cast<const uint4*>(kb + off);
          vr[c] = *reinterpret_cast<const uint4*>(vb + off);
        }
      }
    };
    // a ring of PREFETCH steps' K and V rows in registers
    uint4 kr[PREFETCH][CPL], vr[PREFETCH][CPL];
    int jb = lo + kg * kpw;  // the warp's first key of the step
#pragma unroll
    for (int f = 0; f < PREFETCH; ++f) fetch(jb + f * step + slot, kr[f], vr[f]);
    // ring entry f is statically named: it is read, refilled PREFETCH steps
    // ahead and read again, never moved
    for (; jb < hi; jb += PREFETCH * step) {
#pragma unroll
      for (int f = 0; f < PREFETCH; ++f) {
        const int js = jb + f * step;
        if (js >= hi) break;  // warp-uniform: every lane shuffles
        const int j = js + slot;
        float kf[CPL][VEC], vf[CPL][VEC];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          unpack(kr[f][c], kf[c], T());
          unpack(vr[f][c], vf[c], T());
        }
        fetch(j + PREFETCH * step, kr[f], vr[f]);
        float sv[HPW];
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          float a = 0.0f;
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e) a += qr[h][c][e] * kf[c][e];
          sv[h] = a;
        }
        for (int o = 1; o < lpk; o <<= 1)
#pragma unroll
          for (int h = 0; h < HPW; ++h) sv[h] += __shfl_xor_sync(0xffffffffu, sv[h], o);
        if (j < hi) {
#pragma unroll
          for (int h = 0; h < HPW; ++h) {
            float x = sv[h];
            if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
            // online softmax, one expf: the smaller of m and x is rescaled
            const float e = expf(-fabsf(x - m[h]));
            const bool up = x > m[h];
            const float cs = up ? e : 1.0f, p = up ? 1.0f : e;
            m[h] = up ? x : m[h];
            l[h] = l[h] * cs + p;
#pragma unroll
            for (int c = 0; c < CPL; ++c)
#pragma unroll
              for (int e2 = 0; e2 < VEC; ++e2)
                acc[h][c][e2] = acc[h][c][e2] * cs + p * vf[c][e2];
          }
        }
      }
    }

    // merge the warp's key slots (lanes lpk, 2 lpk, ... apart)
    for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[h], o);
        const float mx = fmaxf(m[h], mo);
        const float a = expf(m[h] - mx), c2 = expf(mo - mx);
        l[h] = l[h] * a + lo_ * c2;
        m[h] = mx;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[h][c][e] = acc[h][c][e] * a +
                           __shfl_xor_sync(0xffffffffu, acc[h][c][e], o) * c2;
      }
    }
    if (slot == 0) {
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        if (h < nh) {
          const int row = kg * group + h0 + h;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int vi = li + c * lpk;
            if (vi < nvec)
#pragma unroll
              for (int e = 0; e < VEC; ++e) part[row * d + vi * VEC + e] = acc[h][c][e];
          }
          if (li == 0) {
            mpart[row] = m[h];
            lpart[row] = l[h];
          }
        }
      }
    }
  }

  // the combine over the cluster, one partial for each (split r, key group
  // g): every block first weighs the partials of each head, w = e^(m_rg -
  // m) with m = max m_rg and l = sum w l_rg, then takes the outputs e =
  // split * THREADS + tid (mod nsplit * THREADS), acc = sum w acc_rg.  All
  // remote loads of a pass are issued together.
  const int gd = group * d;
  cluster.sync();
  if (threadIdx.x < group) {
    const int h = threadIdx.x;
    float mr[MAX_SPLITS][WARPS], lr[MAX_SPLITS][WARPS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const float* rm = cluster.map_shared_rank(mpart, r < nsplit ? r : 0);
      const float* rl = cluster.map_shared_rank(lpart, r < nsplit ? r : 0);
#pragma unroll
      for (int g = 0; g < WARPS; ++g) {
        const bool live = r < nsplit && g < wk;
        const int i = (live ? g : 0) * group + h;  // in bounds either way
        mr[r][g] = live ? rm[i] : NEG_INF;
        lr[r][g] = live ? rl[i] : 0.0f;
      }
    }
    float mx = NEG_INF, sum = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
#pragma unroll
      for (int g = 0; g < WARPS; ++g) mx = fmaxf(mx, mr[r][g]);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
#pragma unroll
      for (int g = 0; g < WARPS; ++g) {
        const float w = expf(mr[r][g] - mx);
        wts[(r * WARPS + g) * group + h] = w;
        sum += w * lr[r][g];
      }
    den[h] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  T* ob = out + (static_cast<size_t>(b) * hq + static_cast<size_t>(hk) * group) * d;
  for (int e = split * THREADS + threadIdx.x; e < gd; e += nsplit * THREADS) {
    const int h = e / d;
    float pr[MAX_SPLITS][WARPS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const float* rp = cluster.map_shared_rank(part, r < nsplit ? r : 0);
#pragma unroll
      for (int g = 0; g < WARPS; ++g) {
        const bool live = r < nsplit && g < wk;
        pr[r][g] = live ? rp[(live ? g : 0) * gd + e] : 0.0f;
      }
    }
    float num = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
#pragma unroll
      for (int g = 0; g < WARPS; ++g) num += wts[(r * WARPS + g) * group + h] * pr[r][g];
    ob[e] = from_f<T>(num / den[h]);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Split count of decode_attention_kernel<T, CPL>: the largest cluster
// size c <= most for which the card holds `heads` clusters of c blocks at
// once (cudaOccupancyMaxActiveClusters), else 1.  Clusters must fit inside
// one GPC, so this is tighter than SMs times the blocks an SM holds, and a
// grid past it runs in a second wave.  The answers for every c are asked
// once for each (device, dynamic shared memory) and kept; ctypes calls
// without the GIL, so the cache is locked.
template <typename T, int CPL>
int fit_splits(long long heads, int most, size_t smem) {
  struct Fit {
    int device;
    size_t smem;
    int clusters[MAX_SPLITS + 1];
  };
  static std::mutex mu;
  static std::vector<Fit> fits;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  Fit fit{device, smem, {}};
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = std::find_if(fits.begin(), fits.end(), [&](const Fit& x) {
      return x.device == device && x.smem == smem;
    });
    if (it != fits.end()) {
      fit = *it;
    } else {
      for (int c = 1; c <= MAX_SPLITS; ++c) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(c, 1, 1);
        cfg.blockDim = dim3(THREADS);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = c;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        if (cudaOccupancyMaxActiveClusters(&fit.clusters[c], decode_attention_kernel<T, CPL>,
                                           &cfg) != cudaSuccess) {
          fit.clusters[c] = 0;
          cudaGetLastError();  // not sticky: clear it for the launch's own check
        }
      }
      fits.push_back(fit);
    }
  }
  for (int c = std::min(most, MAX_SPLITS); c > 1; --c)
    if (fit.clusters[c] >= heads) return c;
  return 1;
}

template <typename T, int CPL>
int launch_cpl(const void* q, const void* k, const void* v, const void* lengths, void* out,
               int b, int s, int hq, int hkv, int d, int window, float softcap,
               cudaStream_t stream) {
  using L = Layout<T, CPL>;
  const int group = hq / hkv;
  const int wh = (group + L::HPW - 1) / L::HPW;
  if (wh > WARPS) return static_cast<int>(cudaErrorInvalidValue);
  const int wk = WARPS / wh;
  const size_t smem = sizeof(float) * group * (wk * (d + 2) + MAX_SPLITS * WARPS + 1);
  // splits, from the shapes alone: each at least MIN_SPLIT_KEYS slots of
  // the cache (or of the window), and the grid in one wave
  const long long range = window > 0 ? std::min(s, window) : s;
  const int most = static_cast<int>(std::min<long long>(
      MAX_SPLITS, (range + MIN_SPLIT_KEYS - 1) / MIN_SPLIT_KEYS));
  const int splits = fit_splits<T, CPL>(static_cast<long long>(b) * hkv, most, smem);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, hkv, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<T, CPL>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), s, hq, hkv, d, window, softcap, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           int b, int s, int hq, int hkv, int d, int window, float softcap, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || d <= 0 || d % 8 != 0 ||
      hq / hkv > MAXG || (hq / hkv) * d > MAX_GROUP_DIM || b > 65535 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VEC = 16 / sizeof(T);
  const int lanes_vecs = (d / VEC + 31) / 32;  // 16-byte vectors a lane at 32 lanes a key
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes_vecs <= 1)
    return launch_cpl<T, 1>(q, k, v, lengths, out, b, s, hq, hkv, d, window, softcap, st);
  if (lanes_vecs <= 2)
    return launch_cpl<T, 2>(q, k, v, lengths, out, b, s, hq, hkv, d, window, softcap, st);
  if (lanes_vecs <= 4)
    return launch_cpl<T, 4>(q, k, v, lengths, out, b, s, hq, hkv, d, window, softcap, st);
  if (lanes_vecs <= 8)
    return launch_cpl<T, 8>(q, k, v, lengths, out, b, s, hq, hkv, d, window, softcap, st);
  if constexpr (sizeof(T) == 4) {  // float32 rows of up to 2048 values
    if (lanes_vecs <= 16)
      return launch_cpl<T, 16>(q, k, v, lengths, out, b, s, hq, hkv, d, window, softcap, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Decode attention of q [b, hq, d] over k, v [b, s, hkv, d] with lengths
// [b] int32, all contiguous, 16-byte aligned and (but lengths) of one type,
// into out [b, hq, d], on `stream`.  window: 0 for none; softcap: 0 for
// none.  Returns cudaGetLastError() right after the launch (0 = launched).
int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* out, int b, int s, int hq,
                          int hkv, int d, int window, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, out, b, s, hq, hkv, d, window,
                               softcap, stream);
}

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int b, int s, int hq,
                         int hkv, int d, int window, float softcap, void* stream) {
  return launch<float>(q, k, v, lengths, out, b, s, hq, hkv, d, window, softcap,
                       stream);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
