// Grouped-query flash attention for prefill: the attention of every layer
// of the serving path's prompt pass.
//
//   out[b, i, h, :] = sum_j softmax_j(s[i, j]) v[b, j, h / group, :]
//   s[i, j] = softcap * tanh(scale * (q[b, i, h, :] . k[b, j, h / group, :]) / softcap)
//
// over the keys j that the causal bound (j <= i) and the sliding window
// (i - j < window) let through; scale = 1 / sqrt(D), softcap optional.
// The kernels are instantiated at D = 32, 64 and 128; the wrapper runs any
// other head dim the model zoo has (80: zamba2-2.7b, hubert-xlarge) by
// zero-padding q, k and v to the next instantiated D and passing the true
// scale, 1 / sqrt(80): zero columns add exact zeros to every q . k, and the
// padded columns of V give output columns the wrapper drops, so the result
// is the same function (kernels/flash_attention.py says why padding, and
// not a fourth instantiation).
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:114, body _flash_kernel at :33),
// with its masking: masked logits are NEG_INF = -1e30, their
// probabilities are set to 0, and the denominator is max(l, 1e-30).  The
// running max, denominator and accumulator are float32 (tanhf, and expf
// in float32 or exp2f of base-2 logits in bf16; no --use_fast_math).
//
// Bound: operations.  At the serving path's prefill shape (q [8, 512, 32,
// 64], k/v [8, 512, 8, 64] bf16, causal) the valid (i, j) pairs need
// 4 * B * Hq * D * Sq (Sq + 1) / 2 = 8.6 GFLOP: 8.7 us at 989 TFLOP/s
// (bf16 tensor cores), against 42 MB of q, k, v and out (12.5 us at
// 3.35 TB/s), so on this card the bytes bound it by a small margin.
//
// Design: two kernels, one for each type.
//
// * bf16 takes flash_attention_wgmma_kernel, on the tensor cores.  One
//   block per (query head, sequence, q-tile of BQ = 128 rows): two
//   warpgroups of 64 rows each, two blocks an SM at D <= 64 (128
//   registers a thread at most), one at D = 128.  K/V tiles of BK = 64
//   keys come by TMA into a ring of three shared-memory stages, each with
//   a full mbarrier; the q tile is loaded once.  One thread issues the q
//   tile and the first three K/V tiles; after that, the warp that frees a
//   stage last (a shared counter per stage, no empty barrier) issues the
//   stage's next tile, so two tiles' loads stay in flight while the
//   warpgroups compute on the third, and no warp idles as a producer.
//   Each warpgroup runs S = Q K^T as wgmma.m64n64k16 (A = its 64 q rows,
//   B = the K tile, both from shared memory, D / 16 k-steps), scales the
//   float32 accumulator by 1/sqrt(D) (q is not rounded after scaling),
//   applies the softcap and, on tiles that straddle the causal bound, the
//   window or the end of the keys only, the mask; then the online softmax
//   with m and l per row in registers, P rounded to bf16 in registers
//   straight from S's accumulator fragment, and O += P V as
//   wgmma.m64nDk16 with P as the register A operand and V read MN-major
//   through the transpose bit (BK / 16 k-steps), O in float32 registers
//   (D / 2 a thread).  Rounding P to bf16 is the one departure from the
//   TPU kernel's float32 P: 2^-9 relative per probability, summed in
//   float32.  Each tensor map is 4-D
//   over [B, S, H, D], so a tile past the end of a sequence reads TMA's
//   zero fill, never the next sequence's rows; the row width sets the
//   swizzle (64 B rows at D = 32, 128 B at D = 64, two 128 B column boxes
//   at D = 128) and the wgmma descriptors follow it.  The key loop covers
//   only [q0 - window + 1, min(q0 + BQ, Skv)); a warpgroup skips a tile
//   that is wholly masked for its rows.  The q-tiles with the most keys
//   are launched first (blockIdx.z reversed, the slowest grid axis).  K/V
//   of the KV head h / group are read by TMA per block; GQA never
//   materialises repeated KV.  The tensor maps are encoded on the host
//   through cudaGetDriverEntryPoint (no -lcuda) and passed as
//   __grid_constant__ parameters.
// * float32 takes flash_attention_simt_kernel, on the CUDA cores (wgmma on
//   float32 inputs is TF32, about three decimal digits, which would break
//   the float32 tolerance of 2e-5).  One block per (q-tile of 64 rows,
//   query head, sequence); one thread per query row, holding its scaled q
//   row and its accumulator in registers; K and V tiles of 32 keys staged
//   in shared memory as float32 and read by every thread at the same
//   address; the causal bound and the window end the key loop; the online
//   softmax updates every 8 keys.

#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)

namespace {

using serving::from_f;
using serving::load8;
using serving::to_f;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: flash_attention_simt_kernel
// ---------------------------------------------------------------------------

constexpr int SIMT_BQ = 64;  // query rows per block, one thread each
constexpr int SIMT_BK = 32;  // keys per shared-memory tile
constexpr int SIMT_SUB = 8;  // keys per online-softmax update

template <typename T, int D>
__global__ void __launch_bounds__(SIMT_BQ)
    flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out, int sq,
                                int skv, int hq, int hkv, int causal, int window,
                                float softcap, float scale) {
  constexpr int BQ = SIMT_BQ, BK = SIMT_BK, SUB = SIMT_SUB;
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

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* out, int b, int sq,
                int skv, int hq, int hkv, int causal, int window, float softcap, float scale,
                cudaStream_t stream) {
  const dim3 grid((sq + SIMT_BQ - 1) / SIMT_BQ, hq, b);
  flash_attention_simt_kernel<float, D><<<grid, SIMT_BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, hq, hkv, causal,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: flash_attention_wgmma_kernel (Hopper: TMA, mbarrier, wgmma)
// ---------------------------------------------------------------------------

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups
constexpr int BK = 64;         // keys per K/V tile
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128;
constexpr int CONSUMER_WARPS = CONSUMERS * 4;  // warps that must free a stage

// Tile geometry of head dim D: TMA boxes of BOX columns (one swizzle row
// each), ROW_BYTES per row in shared memory.
template <int D>
struct Geo {
  static constexpr int BOX = D < 64 ? D : 64;
  static constexpr int BOXES = D / BOX;
  static constexpr int ROW_BYTES = BOX * 2;
  static constexpr int STAGES = 3;
  // blocks an SM: two at D <= 64 (<= 128 registers a thread), one at 128
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or one V tile
  // wgmma descriptor layout: 1 = 128 B swizzle, 2 = 64 B swizzle
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map (coordinates innermost first: column, head,
// row, sequence) into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (bf16 pairs),
// B from shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n32k16_tb(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs),
// B from shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (bf16 pairs),
// B from shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 32) {
    wgmma_rs_m64n32k16_tb(o, a, desc_v);
  } else if constexpr (D == 64) {
    wgmma_rs_m64n64k16_tb(o, a, desc_v);
  } else {
    wgmma_rs_m64n128k16_tb(o, a, desc_v);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K and V tile `it` of the block (keys t0 .. t0 + BK of KV head hk of
// sequence b) into ring stage `s`, completing on that stage's barrier.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        uint32_t k_smem, uint32_t v_smem, uint32_t full,
                                        int s, int t0, int hk, int b) {
  using G = Geo<D>;
  mbar_expect_tx(full, 2 * G::KV_BYTES);
#pragma unroll
  for (int x = 0; x < G::BOXES; ++x) {
    const uint32_t off = s * G::KV_BYTES + x * BK * G::ROW_BYTES;
    tma_load_4d(k_smem + off, tm_k, full, x * G::BOX, hk, t0, b);
    tma_load_4d(v_smem + off, tm_v, full, x * G::BOX, hk, t0, b);
  }
}

// Accumulator fragment of wgmma m64nN (N / 2 floats a thread): register j
// holds row (warp * 16 + lane / 4 + 8 * ((j >> 1) & 1)) of the warpgroup's
// 64 and column (8 * (j >> 2) + 2 * (lane % 4) + (j & 1)).
template <int D>
__global__ void __launch_bounds__(THREADS, Geo<D>::MIN_BLOCKS)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 __nv_bfloat16* __restrict__ out, int sq, int skv, int hq,
                                 int hkv, int causal, int window, float softcap,
                                 float scale) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int released[G::STAGES];  // warps done with each stage, all rounds
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t k_smem = q_smem + G::Q_BYTES;
  const uint32_t v_smem = k_smem + G::STAGES * G::KV_BYTES;
  const uint32_t bars = v_smem + G::STAGES * G::KV_BYTES;
  const uint32_t q_full = bars;
  const uint32_t full0 = bars + 8;  // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (hq / hkv);
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int kv_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the q tile and the first STAGES K/V tiles; the warp that frees a
    // stage last loads its next tile (below)
    mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
    for (int x = 0; x < G::BOXES; ++x)
      tma_load_4d(q_smem + x * BQ * G::ROW_BYTES, &tm_q, q_full, x * G::BOX, h, q0, b);
    for (int it = 0; it < G::STAGES && it < n_tiles; ++it)
      load_kv<D>(&tm_k, &tm_v, k_smem, v_smem, full0 + 8 * it, it, kv_begin + it * BK, hk, b);
  }

  // consumer warpgroup wg: block rows [64 wg, 64 wg + 64)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, base-2 units
  float l[2] = {0.0f, 0.0f};  // this thread's partial sums; the quad's at the end
  const float scale_log2 = scale * LOG2E;

  mbar_wait(q_full, 0);
  const uint32_t q_wg = q_smem + 64 * wg * G::ROW_BYTES;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % G::STAGES;
    const int t0 = kv_begin + it * BK;
    mbar_wait(full0 + 8 * s, (it / G::STAGES) & 1);
    const bool skip = (causal && t0 > wg_last) ||
                      (window > 0 && wg_first - (t0 + BK - 1) >= window);
    if (!skip) {
      const bool need_mask = t0 + BK > skv || (causal && t0 + BK - 1 > wg_first) ||
                             (window > 0 && wg_last - t0 >= window);
      const uint32_t k_tile = k_smem + s * G::KV_BYTES;
      const uint32_t v_tile = v_smem + s * G::KV_BYTES;

      // S = Q K^T, float32 accumulator
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = (kk * 16) / G::BOX, cb = ((kk * 16) % G::BOX) * 2;
        const uint64_t da = make_desc(q_wg + x * BQ * G::ROW_BYTES + cb, 16,
                                      8 * G::ROW_BYTES, G::LAYOUT);
        const uint64_t db = make_desc(k_tile + x * BK * G::ROW_BYTES + cb, 16,
                                      8 * G::ROW_BYTES, G::LAYOUT);
        wgmma_ss_m64n64k16(sc, da, db, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // scale, softcap, mask; logits kept in base-2 units (x log2 e) so
      // that the softmax takes exp2f
      uint32_t valid = 0xffffffffu;
      if (softcap > 0.0f) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = softcap * tanhf(sc[j] * scale / softcap) * LOG2E;
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] *= scale_log2;
      }
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int row = row0 + ((j & 2) ? 8 : 0);
          const int col = t0 + 8 * (j >> 2) + col0 + (j & 1);
          const bool ok = col < skv && (!causal || row >= col) &&
                          (window <= 0 || row - col < window);
          if (!ok) {
            sc[j] = NEG_INF;
            valid &= ~(1u << j);
          }
        }
      }

      // online softmax over the tile, two rows a thread
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        const float p = ((valid >> j) & 1u) ? exp2f(sc[j] - mx[r]) : 0.0f;
        sc[j] = p;
        l[r] += p;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];

      // P (bf16) as the A fragments of the BK / 16 k-steps of O += P V
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = make_desc(v_tile + kk * 16 * G::ROW_BYTES, BK * G::ROW_BYTES,
                                      8 * G::ROW_BYTES, G::LAYOUT);
        wgmma_pv<D>(o, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    // stage s is free once every consumer warp is past its wgmma on it
    // (waited above); the last warp to get there loads tile it + STAGES
    if (lane == 0 && atomicAdd(&released[s], 1) == (it / G::STAGES + 1) * CONSUMER_WARPS - 1 &&
        it + G::STAGES < n_tiles)
      load_kv<D>(&tm_k, &tm_v, k_smem, v_smem, full0 + 8 * s, s, t0 + G::STAGES * BK, hk, b);
    __syncwarp();
  }

  // O / max(l, 1e-30), rows past sq not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row < sq) {
      __nv_bfloat16* op = out + ((static_cast<size_t>(b) * sq + row) * hq + h) * D + col0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] / denom, o[4 * n + 2 * r + 1] / denom);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime, so that the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map over x [b, s, h, d] bf16 (contiguous) with boxes of `box`
// columns x 1 head x `rows` rows x 1 sequence.
template <int D>
bool encode_map(CUtensorMap* map, const void* x, int b, int s, int h, int rows) {
  using G = Geo<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(h) * D * 2,
                                 static_cast<cuuint64_t>(s) * h * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::BOX), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        G::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int sq,
                 int skv, int hq, int hkv, int causal, int window, float softcap, float scale,
                 cudaStream_t stream) {
  using G = Geo<D>;
  if ((sq + BQ - 1) / BQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  CUtensorMap mq, mk, mv;
  if (!encode_map<D>(&mq, q, b, sq, hq, BQ) || !encode_map<D>(&mk, k, b, skv, hkv, BK) ||
      !encode_map<D>(&mv, v, b, skv, hkv, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(hq, b, (sq + BQ - 1) / BQ);
  flash_attention_wgmma_kernel<D><<<grid, THREADS, G::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), sq, skv, hq, hkv, causal, window, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int b, int sq, int skv, int hq, int hkv) {
  return b > 0 && sq > 0 && skv > 0 && hkv > 0 && hq % hkv == 0 && hq <= 65535 && b <= 65535;
}

}  // namespace

extern "C" {

// Attention of q [b, sq, hq, d] over k, v [b, skv, hkv, d], all contiguous,
// 16-byte aligned and of one type, into out [b, sq, hq, d], on `stream`.
// causal: 0 or 1; window: 0 for none; softcap: 0 for none; d: 32, 64 or
// 128; scale: the logits' factor, 1 / sqrt(the caller's head dim), which
// differs from 1 / sqrt(d) where the caller zero-padded its head dim up to
// d.  Returns cudaGetLastError() right after the launch (0 = launched),
// or cudaErrorInvalidValue for a shape the kernel does not take.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                         int b, int sq, int skv, int hq, int hkv, int d, int causal,
                         int window, float softcap, float scale, void* stream) {
  if (!valid_shape(b, sq, skv, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_wgmma<32>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap,
                               scale, s);
    case 64:
      return launch_wgmma<64>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap,
                               scale, s);
    case 128:
      return launch_wgmma<128>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap,
                               scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int b, int sq, int skv, int hq, int hkv, int d, int causal,
                        int window, float softcap, float scale, void* stream) {
  if (!valid_shape(b, sq, skv, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_simt<32>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap,
                               scale, s);
    case 64:
      return launch_simt<64>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap,
                               scale, s);
    case 128:
      return launch_simt<128>(q, k, v, out, b, sq, skv, hq, hkv, causal, window, softcap,
                               scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
