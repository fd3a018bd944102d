// RMSNorm over the trailing axis, the norm of every transformer layer of
// the serving path (two a layer, plus the final one).
//
//   out[r, :] = (x[r, :] * (1 / sqrtf(mean(x[r, :]^2) + eps)) * (1 + scale))
//               cast to x's type                    (x bf16 or float32)
//
// with the mean of squares, the reciprocal square root and the scale in
// float32; scale is float32 (the model's param dtype).  Replaces the Pallas
// TPU kernel rmsnorm (src/repro/kernels/rmsnorm.py:27, body _rmsnorm_kernel
// at :18), whose plain version is ref.rmsnorm.  The reciprocal square root
// is 1.0f / sqrtf(...): both correctly rounded, no --use_fast_math.
//
// Bound: bytes.  Each element is read once and written once (plus the
// d-wide scale), against ~4 float32 operations an element.  At the serving
// path's prefill shape, 4096 rows of 2048 bf16, that is 33.6 MB: 10 us at
// 3.35 TB/s.  The decode call (8 rows) moves 66 KB and is bound by launch
// latency, not by the card.
//
// Design: one block per row, ceil(d / 8) threads rounded up to whole warps
// (at most 256), so at d = 2048 each thread holds exactly one 16-byte
// vector of eight bf16.  Sum of squares per thread, warp-shuffle sum, then
// the warps' partials through shared memory.  The second pass re-reads the
// row from L1 (4 KB at d = 2048) and reads each scale element once per
// block.  Rows that are not 16-byte aligned or whose width is not a
// multiple of 8 take a scalar loop with the same arithmetic.

#include "common.cuh"

namespace {

using serving::from_f;
using serving::load8;
using serving::store8;
using serving::to_f;

constexpr int MAX_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int d, float eps, int vec) {
  __shared__ float partial[MAX_THREADS / 32];
  __shared__ float inv_shared;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.0f;
  if (vec) {
    for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
      float f[8];
      load8(xr + c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float f = to_f(xr[c]);
      ss += f * f;
    }
  }
  ss = serving::warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < blockDim.x / 32; ++w) total += partial[w];
    inv_shared = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = inv_shared;

  if (vec) {
    for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
      float f[8];
      load8(xr + c, f);
      const float4 s0 = reinterpret_cast<const float4*>(scale + c)[0];
      const float4 s1 = reinterpret_cast<const float4*>(scale + c)[1];
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = (f[i] * inv) * (1.0f + s[i]);
      store8(orow + c, f);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      orow[c] = from_f<T>((to_f(xr[c]) * inv) * (1.0f + scale[c]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(scale) % 16 == 0);
  const int vec = (aligned && d % 8 == 0) ? 1 : 0;
  const int work = vec ? (d + 7) / 8 : d;
  int threads = ((work + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  rmsnorm_kernel<T><<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Normalise `rows` contiguous rows of width d on `stream`.  x, out: [rows,
// d] of one type; scale: [d] float32.  Returns cudaGetLastError() right
// after the launch (0 = launched).
int rmsnorm_bf16(const void* x, const void* scale, void* out, int rows, int d,
                 float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}

int rmsnorm_f32(const void* x, const void* scale, void* out, int rows, int d,
                float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, stream);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
