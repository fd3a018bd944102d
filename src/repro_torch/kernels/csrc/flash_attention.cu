// Grouped-query flash attention for prefill: the attention of every layer
// of the serving path's prompt pass.
//
//   out[b, i, h, :] = sum_j softmax_j(s[i, j]) v[b, j, h / group, :]
//   s[i, j] = softcap * tanh((scale * q[b, i, h, :]) . k[b, j, h / group, :] / softcap)
//
// over the keys j that the causal bound (j <= i) and the sliding window
// (i - j < window) let through; scale = 1 / sqrt(D), softcap optional.
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:114, body _flash_kernel at :33),
// with its masking: masked logits are NEG_INF = -1e30, their
// probabilities are set to 0, and the denominator is max(l, 1e-30).  The
// running max, denominator and accumulator are float32 (expf, tanhf; no
// --use_fast_math); q, k, v and out are bf16 or float32.
//
// Bound: operations.  At the serving path's prefill shape (q [8, 512, 32,
// 64], k/v [8, 512, 8, 64] bf16, causal) the valid (i, j) pairs need
// 4 * B * Hq * D * Sq (Sq + 1) / 2 = 8.6 GFLOP: 8.7 us at 989 TFLOP/s
// (bf16 tensor cores), above its 21 MB of traffic (6.3 us at 3.35 TB/s).
//
// Design: this kernel runs on the CUDA cores in float32, not on the tensor
// cores, so it stays far from that bound (the tensor-core form with wgmma
// and TMA is later work).  One block per (q-tile of BQ = 64 rows, query
// head, batch); one thread per query row, holding its scaled q row and its
// accumulator in registers.  K and V tiles of BK = 32 keys for KV head
// h / group are staged in shared memory as float32 and read by every
// thread of the block at the same address (a broadcast), so GQA never
// materialises repeated KV.  The causal bound and the window end the key
// loop: a block visits only keys in [q0 - window + 1, min(q0 + BQ, Sq)),
// not the masked blocks a Pallas grid still walks.  The online softmax
// updates every SUB = 8 keys (one rescale of the accumulator per 8 keys).
// D is a template parameter (32, 64 or 128) so the per-row arrays stay in
// registers; at D = 128 they spill (see nvcc's -Xptxas -v summary).

#include "common.cuh"

namespace {

using serving::from_f;
using serving::load8;
using serving::to_f;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block, one thread each
constexpr int BK = 32;  // keys per shared-memory tile
constexpr int SUB = 8;  // keys per online-softmax update

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int sq,
                           int skv, int hq, int hkv, int causal, int window,
                           float softcap, float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + threadIdx.x;
  const bool live = row < sq;
  const int hk = h / (hq / hkv);

  float qr[D], acc[D];
  {
    const T* qp = q + ((static_cast<size_t>(b) * sq + (live ? row : 0)) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      float f[8];
      load8(qp + c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qr[c + i] = live ? f[i] * scale : 0.0f;
        acc[c + i] = 0.0f;
      }
    }
  }
  float m = NEG_INF, l = 0.0f;

  // the keys this block's rows can see
  const int q_last = min(q0 + BQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const size_t key_stride = static_cast<size_t>(hkv) * D;
  const T* kbase = k + static_cast<size_t>(b) * skv * key_stride + static_cast<size_t>(hk) * D;
  const T* vbase = v + static_cast<size_t>(b) * skv * key_stride + static_cast<size_t>(hk) * D;

  for (int t0 = kv_begin; t0 < kv_end; t0 += BK) {
    const int nt = min(BK, kv_end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < BK * (D / 8); e += BQ) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      float fk[8], fv[8];
      if (j < nt) {
        load8(kbase + (t0 + j) * key_stride + c, fk);
        load8(vbase + (t0 + j) * key_stride + c, fv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) fk[i] = fv[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ks[j][c + i] = fk[i];
        vs[j][c + i] = fv[i];
      }
    }
    __syncthreads();

    for (int j0 = 0; j0 < nt; j0 += SUB) {
      float s[SUB];
      bool ok[SUB];
      float smax = NEG_INF;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        const int j = j0 + u, kp = t0 + j;
        float dot = 0.0f;
        if (j < nt) {
          const float4* kr = reinterpret_cast<const float4*>(ks[j]);
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            const float4 kv = kr[c];
            dot += qr[4 * c] * kv.x + qr[4 * c + 1] * kv.y + qr[4 * c + 2] * kv.z +
                   qr[4 * c + 3] * kv.w;
          }
        }
        if (softcap > 0.0f) dot = softcap * tanhf(dot / softcap);
        const bool valid = live && j < nt && (!causal || row >= kp) &&
                           (window <= 0 || row - kp < window);
        s[u] = valid ? dot : NEG_INF;
        ok[u] = valid;
        smax = fmaxf(smax, s[u]);
      }
      const float m_new = fmaxf(m, smax);
      const float corr = expf(m - m_new);
      float p[SUB];
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        p[u] = ok[u] ? expf(s[u] - m_new) : 0.0f;
        psum += p[u];
      }
      l = corr * l + psum;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        float4 a = make_float4(corr * acc[4 * c], corr * acc[4 * c + 1],
                               corr * acc[4 * c + 2], corr * acc[4 * c + 3]);
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
          if (j0 + u < nt) {
            const float4 vv = reinterpret_cast<const float4*>(vs[j0 + u])[c];
            a.x += p[u] * vv.x;
            a.y += p[u] * vv.y;
            a.z += p[u] * vv.z;
            a.w += p[u] * vv.w;
          }
        }
        acc[4 * c] = a.x;
        acc[4 * c + 1] = a.y;
        acc[4 * c + 2] = a.z;
        acc[4 * c + 3] = a.w;
      }
      m = m_new;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = out + ((static_cast<size_t>(b) * sq + row) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) op[c] = from_f<T>(acc[c] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int sq, int skv, int hq, int hkv, int causal, int window,
             float softcap, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_attention_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, hq, hkv, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
           int skv, int hq, int hkv, int d, int causal, int window, float softcap,
           void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_d<T, 32>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap, s);
    case 64:
      return launch_d<T, 64>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap, s);
    case 128:
      return launch_d<T, 128>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Attention of q [b, sq, hq, d] over k, v [b, skv, hkv, d], all contiguous,
// 16-byte aligned and of one type, into out [b, sq, hq, d], on `stream`.
// causal: 0 or 1; window: 0 for none; softcap: 0 for none.  Returns
// cudaGetLastError() right after the launch (0 = launched).
int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                         int b, int sq, int skv, int hq, int hkv, int d, int causal,
                         int window, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, d, causal, window,
                               softcap, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int b, int sq, int skv, int hq, int hkv, int d, int causal,
                        int window, float softcap, void* stream) {
  return launch<float>(q, k, v, out, b, sq, skv, hq, hkv, d, causal, window, softcap,
                       stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
