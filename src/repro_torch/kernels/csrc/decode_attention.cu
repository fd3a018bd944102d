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
// probabilities are set to 0, the denominator is max(l, 1e-30).  Running
// max, denominator and accumulator are float32 (expf, tanhf; no
// --use_fast_math); q, the cache and out are bf16 or float32.
//
// Bound: bytes.  The valid K and V rows are read once: at the serving
// path's decode shape (q [8, 32, 64], cache [8, 1024, 8, 64] bf16, lengths
// 513-543) that is ~8.9 MB, 2.7 us at 3.35 TB/s; the operations (4 * Hq *
// D per valid key and sequence, 36 MFLOP) are far below either peak.
//
// Design: one block of 128 threads per (KV head, sequence), with all
// `group` query heads of that KV head together, so each K and V row is
// fetched from device memory once for the whole group.  The scaled q rows
// sit in shared memory.  The key loop runs from max(0, length - window) to
// min(length, S) and no further, in tiles of 128 keys: thread t computes
// the group's logits for key t of the tile (16-byte loads of its K row),
// each warp then takes the tile's max, probabilities and denominator of
// some heads (warp shuffles), and each thread accumulates p @ V for its
// (head, dim) pairs, reading V rows coalesced across threads.  With
// B * Hkv = 64 blocks on 132 SMs and a serial tile loop, this kernel is
// bound by latency, not by the card's bandwidth; split-KV with a combine
// step is the later speed work.

#include "common.cuh"

namespace {

using serving::from_f;
using serving::load8;
using serving::to_f;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // keys per tile, one thread each
constexpr int MAXG = 16;      // query heads per KV head
constexpr int MAXACC = 16;    // (head, dim) pairs per thread: group * D <= 2048

template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, const int* __restrict__ lengths,
                            T* __restrict__ out, int s, int hq, int hkv, int d,
                            int window, float softcap, float scale) {
  __shared__ float qs[MAXG * THREADS];  // group * d scaled q values
  __shared__ float sc[MAXG][THREADS];   // logits, then probabilities
  __shared__ int vk[THREADS];           // key of the tile is valid
  __shared__ float ms[MAXG], ls[MAXG], cs[MAXG];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int kv_end = min(len, s);
  const int kv_begin = window > 0 ? max(0, len - window) : 0;
  const int npair = group * d;
  const size_t key_stride = static_cast<size_t>(hkv) * d;
  const T* kbase = kc + static_cast<size_t>(b) * s * key_stride + static_cast<size_t>(hk) * d;
  const T* vbase = vc + static_cast<size_t>(b) * s * key_stride + static_cast<size_t>(hk) * d;

  const T* qb = q + (static_cast<size_t>(b) * hq + static_cast<size_t>(hk) * group) * d;
  for (int e = tid; e < npair; e += THREADS) qs[e] = to_f(qb[e]) * scale;
  if (tid < MAXG) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.0f;
  }
  float acc[MAXACC];
#pragma unroll
  for (int a = 0; a < MAXACC; ++a) acc[a] = 0.0f;
  __syncthreads();

  for (int t0 = kv_begin; t0 < kv_end; t0 += THREADS) {
    const int j = t0 + tid;
    const bool valid = j < kv_end;
    // the group's logits of key j
    float sv[MAXG];
#pragma unroll
    for (int h = 0; h < MAXG; ++h) sv[h] = 0.0f;
    if (valid) {
      const T* kr = kbase + static_cast<size_t>(j) * key_stride;
      for (int c = 0; c < d; c += 8) {
        float f[8];
        load8(kr + c, f);
#pragma unroll
        for (int h = 0; h < MAXG; ++h) {
          if (h < group) {
            const float* qh = qs + h * d + c;
            float a = sv[h];
#pragma unroll
            for (int i = 0; i < 8; ++i) a += qh[i] * f[i];
            sv[h] = a;
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MAXG; ++h) {
      if (h < group) {
        float x = sv[h];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        sc[h][tid] = valid ? x : NEG_INF;
      }
    }
    vk[tid] = valid;
    __syncthreads();

    // per head: the tile's max, the rescale, the probabilities and the
    // denominator; warp w takes heads w, w + 4, ...
    for (int h = warp; h < group; h += THREADS / 32) {
      float mx = NEG_INF;
      for (int i = lane; i < THREADS; i += 32) mx = fmaxf(mx, sc[h][i]);
      mx = serving::warp_max(mx);
      const float m_old = ms[h];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.0f;
      for (int i = lane; i < THREADS; i += 32) {
        const float p = vk[i] ? expf(sc[h][i] - m_new) : 0.0f;
        sc[h][i] = p;
        ps += p;
      }
      ps = serving::warp_sum(ps);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        cs[h] = c;
        ls[h] = c * ls[h] + ps;
        ms[h] = m_new;
      }
    }
    __syncthreads();

    // p @ V for this thread's (head, dim) pairs
    const int nt = min(THREADS, kv_end - t0);
#pragma unroll
    for (int a = 0; a < MAXACC; ++a) {
      const int e = tid + a * THREADS;
      if (e < npair) {
        const int h = e / d, c = e % d;
        const T* vcol = vbase + static_cast<size_t>(t0) * key_stride + c;
        float sum = cs[h] * acc[a];
        for (int jj = 0; jj < nt; ++jj) sum += sc[h][jj] * to_f(vcol[jj * key_stride]);
        acc[a] = sum;
      }
    }
    __syncthreads();  // sc and cs are rewritten by the next tile
  }

  T* ob = out + (static_cast<size_t>(b) * hq + static_cast<size_t>(hk) * group) * d;
#pragma unroll
  for (int a = 0; a < MAXACC; ++a) {
    const int e = tid + a * THREADS;
    if (e < npair) ob[e] = from_f<T>(acc[a] / fmaxf(ls[e / d], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           int b, int s, int hq, int hkv, int d, int window, float softcap,
           void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || d % 8 != 0 ||
      hq / hkv > MAXG || (hq / hkv) * d > MAXACC * THREADS || b > 65535 ||
      hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const dim3 grid(hkv, b);
  decode_attention_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), s, hq, hkv, d, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
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
