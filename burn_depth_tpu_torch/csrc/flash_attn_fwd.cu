// Flash-attention forward for Hopper (sm_90a): out = softmax(q·kᵀ·scale)·v
// over [B·H, T, hd] tensors, f32 scores and softmax, output in q's dtype.
//
// Replaces the TPU kernel burn_depth_tpu/ops/attention.py::_flash_kernel
// (wrapper _attention_pallas).  Same function, default math only: keys are
// never padded (positions >= T are simply not read), and `quiet` adds
// exp(-m_final) to the softmax denominator ("softmax with one").
//
// What bounds it on this card.  Per (batch·head) the work is 4·T²·hd
// operations against 4·T·hd elements moved, so at the main-path T = 577 the
// kernel does ~144 operations per f32 byte — far above the H100's f32 ridge
// (67 TFLOP/s over 3.35 TB/s ≈ 20): it is bound by operations.  This first
// version runs them on the f32 FMA pipe (no tensor cores), so its ceiling is
// the card's 67 TFLOP/s non-tensor f32 rate.
//
// Design.  The TPU kernel keeps all of K/V resident for each query block;
// at T = 577 in f32 that is 295 KB, more than the 227 KB a block may use,
// and DA3's T ≈ 1374 is far beyond.  So this kernel streams K/V:
//   * one block per (batch·head, 64-query tile), one thread per query row;
//     the row's q and its output accumulator live in registers;
//   * K/V tiles of 64 keys are staged in shared memory as f32 (bf16 inputs
//     are widened while staging); every thread reads the same key row at
//     the same time, so shared-memory reads are broadcasts with no bank
//     conflicts, and each K/V element is read from device memory once per
//     64 query rows;
//   * an online softmax (running max m, running sum l, accumulator rescaled
//     by exp(m_old - m_new)) over steps of 16 keys, so the rescale costs one
//     exp per 16 scores and the 16 independent dot products give the
//     scheduler instruction-level parallelism.
// wgmma/TMA tiles come in a later version.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;  // query rows per block, one thread each
constexpr int BLOCK_K = 64;  // keys per shared-memory tile
constexpr int SUB_K = 16;    // keys per online-softmax step

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int HD>
__global__ void __launch_bounds__(BLOCK_Q)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int t,
                      float scale, int quiet) {
  __shared__ __align__(16) float ks[BLOCK_K * HD];
  __shared__ __align__(16) float vs[BLOCK_K * HD];
  constexpr int VPR = HD / 4;  // 4-element vectors per row

  const int tid = threadIdx.x;
  const size_t head = static_cast<size_t>(blockIdx.x) * t * HD;
  const int row = blockIdx.y * BLOCK_Q + tid;
  const bool active = row < t;

  float qr[HD];
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 f = active ? load4(q + head + static_cast<size_t>(row) * HD + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = f.x; qr[d + 1] = f.y; qr[d + 2] = f.z; qr[d + 3] = f.w;
    acc[d] = 0.f; acc[d + 1] = 0.f; acc[d + 2] = 0.f; acc[d + 3] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < t; k0 += BLOCK_K) {
    const int kn = min(BLOCK_K, t - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BLOCK_K * VPR; i += BLOCK_Q) {
      const int r = i / VPR;
      const int c = (i % VPR) * 4;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vf = kf;
      if (r < kn) {  // rows past the sequence end stay zero
        const size_t off = head + static_cast<size_t>(k0 + r) * HD + c;
        kf = load4(k + off);
        vf = load4(v + off);
      }
      *reinterpret_cast<float4*>(&ks[r * HD + c]) = kf;
      *reinterpret_cast<float4*>(&vs[r * HD + c]) = vf;
    }
    __syncthreads();
    if (!active) continue;

    for (int j0 = 0; j0 < kn; j0 += SUB_K) {
      float s[SUB_K];
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < SUB_K; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(&ks[(j0 + jj) * HD]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < VPR; ++d4) {
          const float4 kv = kr[d4];
          dot = fmaf(qr[4 * d4], kv.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
        }
        s[jj] = (j0 + jj < kn) ? dot * scale : -INFINITY;  // keys >= T excluded
        mt = fmaxf(mt, s[jj]);
      }
      const float m_new = fmaxf(m, mt);  // finite: key j0 < kn is valid
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB_K; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(&vs[(j0 + jj) * HD]);
#pragma unroll
        for (int d4 = 0; d4 < VPR; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float denom = quiet ? l + expf(-m) : l;
    const float inv = 1.f / denom;
    T* op = o + head + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      store4(op + d, make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
                                 acc[d + 3] * inv));
    }
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int bh, int t,
            float scale, int quiet, cudaStream_t stream) {
  const dim3 grid(bh, (t + BLOCK_Q - 1) / BLOCK_Q);
  flash_attn_fwd_kernel<T, HD><<<grid, BLOCK_Q, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t, scale, quiet);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o: contiguous [bh, t, hd],
// 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int bdt_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  int bh, int t, int hd, int dtype, float scale,
                                  int quiet, void* stream) {
  if (bh <= 0 || t <= 0 || (t + BLOCK_Q - 1) / BLOCK_Q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) {
    launch<float, 64>(q, k, v, o, bh, t, scale, quiet, s);
  } else if (dtype == 0 && hd == 32) {
    launch<float, 32>(q, k, v, o, bh, t, scale, quiet, s);
  } else if (dtype == 1 && hd == 64) {
    launch<__nv_bfloat16, 64>(q, k, v, o, bh, t, scale, quiet, s);
  } else if (dtype == 1 && hd == 32) {
    launch<__nv_bfloat16, 32>(q, k, v, o, bh, t, scale, quiet, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
