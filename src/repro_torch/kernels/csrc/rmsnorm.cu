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
// Design: one block of up to 256 threads walks rows blockIdx.x,
// blockIdx.x + gridDim.x, ... (a grid of at most 8 blocks an SM).  On the
// vector path each thread owns VPT (1 to 4) 16-byte vectors of eight
// elements of a row and of scale: it loads its x vectors once into
// registers, sums their squares, and writes the normalised vectors from
// the same registers, so x is read from device memory once; its scale
// vectors stay in registers across the block's rows.  Warp-shuffle sums,
// then the warps' partials through shared memory, double-buffered by row
// parity so one __syncthreads a row suffices.  VPT is the smallest of 1-4
// that covers the row at 256 threads: 2048 (granite-3-2b) takes 1, 4096
// (chatglm3-6b) 2, 5120 (mistral-nemo-12b) and 5376 (gemma3-27b) 3; up to
// 8192 elements stay in registers.  Rows that are not 16-byte aligned,
// widths that are not a multiple of 8 or wider than 8192 take a scalar
// loop with the same arithmetic that reads the row twice.

#include "common.cuh"

namespace {

using serving::from_f;
using serving::load8;
using serving::store8;
using serving::to_f;

constexpr int MAX_THREADS = 256;
constexpr int MAX_VPT = 4;
constexpr int WARPS = MAX_THREADS / 32;

// Sum of `ss` over the block; partial[2][WARPS] is indexed by row parity,
// so a row's partials are never overwritten while another thread still
// reads them.
__device__ __forceinline__ float block_sum(float ss, float (*partial)[WARPS], int parity) {
  ss = serving::warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[parity][warp] = ss;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < blockDim.x / 32; ++w) total += partial[parity][w];
  return total;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       T* __restrict__ out, int rows, int d, float eps) {
  __shared__ float partial[2][WARPS];
  float s1[VPT][8];  // 1 + scale of this thread's vectors
  bool own[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int c = (threadIdx.x + v * blockDim.x) * 8;
    own[v] = c < d;
    if (own[v]) {
      const float4 a = reinterpret_cast<const float4*>(scale + c)[0];
      const float4 b = reinterpret_cast<const float4*>(scale + c)[1];
      const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) s1[v][i] = 1.0f + f[i];
    }
  }
  int parity = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x, parity ^= 1) {
    const T* xr = x + static_cast<size_t>(r) * d;
    T* orow = out + static_cast<size_t>(r) * d;
    float f[VPT][8];
    float ss = 0.0f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      if (own[v]) {
        load8(xr + (threadIdx.x + v * blockDim.x) * 8, f[v]);
#pragma unroll
        for (int i = 0; i < 8; ++i) ss += f[v][i] * f[v][i];
      }
    }
    const float inv =
        1.0f / sqrtf(block_sum(ss, partial, parity) / static_cast<float>(d) + eps);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      if (own[v]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[v][i] = (f[v][i] * inv) * s1[v][i];
        store8(orow + (threadIdx.x + v * blockDim.x) * 8, f[v]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          T* __restrict__ out, int rows, int d, float eps) {
  __shared__ float partial[2][WARPS];
  int parity = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x, parity ^= 1) {
    const T* xr = x + static_cast<size_t>(r) * d;
    T* orow = out + static_cast<size_t>(r) * d;
    float ss = 0.0f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float f = to_f(xr[c]);
      ss += f * f;
    }
    const float inv =
        1.0f / sqrtf(block_sum(ss, partial, parity) / static_cast<float>(d) + eps);
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      orow[c] = from_f<T>((to_f(xr[c]) * inv) * (1.0f + scale[c]));
    }
  }
}

int max_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    blocks = 8 * sms;
  }
  return blocks;
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = max_blocks();
  if (cap == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = rows < cap ? rows : cap;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(scale) % 16 == 0);
  const int nvec = d / 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (aligned && d % 8 == 0 && nvec <= MAX_VPT * MAX_THREADS) {
    const int threads = nvec < MAX_THREADS ? ((nvec + 31) / 32) * 32 : MAX_THREADS;
    switch ((nvec + threads - 1) / threads) {
      case 1:
        rmsnorm_vec_kernel<T, 1><<<grid, threads, 0, s>>>(xt, sc, ot, rows, d, eps);
        break;
      case 2:
        rmsnorm_vec_kernel<T, 2><<<grid, threads, 0, s>>>(xt, sc, ot, rows, d, eps);
        break;
      case 3:
        rmsnorm_vec_kernel<T, 3><<<grid, threads, 0, s>>>(xt, sc, ot, rows, d, eps);
        break;
      default:
        rmsnorm_vec_kernel<T, 4><<<grid, threads, 0, s>>>(xt, sc, ot, rows, d, eps);
        break;
    }
  } else {
    const int threads = d < MAX_THREADS ? ((d + 31) / 32) * 32 : MAX_THREADS;
    rmsnorm_scalar_kernel<T><<<grid, threads, 0, s>>>(xt, sc, ot, rows, d, eps);
  }
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
