// Single-token GQA decode attention over a KV cache, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_dec_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py. Same function: q [B,1,H,D] attends
// over k, v [B,C,Hkv,D] under a bool mask [B,C]; the g = H/Hkv query heads of
// kv head hk form one [g, D] tile; f32 online softmax (m, l, acc) with scale
// 1/sqrt(D) applied to q; masked slots get -FLT_MAX (finfo(f32).min), so a
// row with no valid slot yields the mean of V as the reference's softmax over
// equal logits does; a zero denominator becomes 1; output in q's dtype.
//
// What bounds it on the H100: bytes. Each (b, kv head) reads its C*D k and v
// values once and does 4*g*D FLOPs per slot, an arithmetic intensity of about
// g/2 FLOP per byte in f32, far below the card's ridge.
//
// Design: one CTA of 256 threads per (b, kv head). The reference's
// sequential grid axis (C/bk, "arbitrary"), which carried m, l, acc in VMEM,
// becomes a loop inside the CTA: q is loaded once into shared memory, then
// the cache is walked in tiles of BK = 64 slots (k, v and the mask staged in
// shared memory as f32), scores for the g x 64 tile, a per-row online softmax
// (one warp per q head, shuffles for max and sum) and p.v accumulated into
// registers (each thread owns up to 8 fixed (head, d) outputs, g*D <= 2048).
// Known limit, left for the first performance PR: only B*Hkv CTAs run (32 for
// llama3.2-1b at B=4 on 132 SMs), and every tile is read even when the mask
// is all false. Splitting C across CTAs with a combine pass, and skipping
// masked tiles, are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BK = 64;
constexpr int NT = 256;
constexpr int MAX_ACC = 8;  // outputs per thread: g*D <= NT*MAX_ACC

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int g, int D) {
  // q [g][D], k [BK][D+1], v [BK][D], p [g][BK], m, l, alpha [g]
  return sizeof(float) * ((size_t)g * D + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)g * BK + 3 * (size_t)g);
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ mask, T* __restrict__ o,
              int C, int H, int Hkv, int D, float scale) {
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int g = H / Hkv;
  const int KS = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;            // [g][D]
  float* k_s = q_s + g * D;     // [BK][KS]
  float* v_s = k_s + BK * KS;   // [BK][D]
  float* p_s = v_s + BK * D;    // [g][BK]
  float* m_s = p_s + g * BK;    // [g]
  float* l_s = m_s + g;         // [g]
  float* a_s = l_s + g;         // [g]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const T* qb = q + ((size_t)b * H + (size_t)hk * g) * D;
  for (int i = tid; i < g * D; i += NT) q_s[i] = to_f32(qb[i]) * scale;
  for (int r = tid; r < g; r += NT) {
    m_s[r] = -FLT_MAX;
    l_s[r] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();  // previous tile consumed; q, m, l initialised on the first pass
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const int slot = c0 + c;
      float kx = 0.f, vx = 0.f;
      if (slot < C) {
        const size_t off = (((size_t)b * C + slot) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[c * KS + d] = kx;
      v_s[c * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < g * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int slot = c0 + c;
      float x;
      if (slot >= C) {
        x = -INFINITY;  // past the cache: no weight at all
      } else if (!mask[(size_t)b * C + slot]) {
        x = -FLT_MAX;
      } else {
        x = 0.f;
        const float* qr = q_s + r * D;
        const float* kr = k_s + c * KS;
        for (int d = 0; d < D; ++d) x += qr[d] * kr[d];
      }
      p_s[i] = x;
    }
    __syncthreads();

    for (int r = warp; r < g; r += NT / 32) {
      float* pr = p_s + r * BK;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mc = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mc);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + rs;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < MAX_ACC; ++a) {
      const int e = tid + NT * a;
      if (e < g * D) {
        const int r = e / D, d = e % D;
        const float* pr = p_s + r * BK;
        float sum = 0.f;
        for (int c = 0; c < BK; ++c) sum += pr[c] * v_s[c * D + d];
        acc[a] = acc[a] * a_s[r] + sum;
      }
    }
  }

  T* ob = o + ((size_t)b * H + (size_t)hk * g) * D;
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int e = tid + NT * a;
    if (e < g * D) {
      const float l = l_s[e / D];
      ob[e] = from_f32<T>(acc[a] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   int B, int C, int H, int Hkv, int D, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  decode_kernel<T><<<B * Hkv, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(o), C, H, Hkv, D, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask is one byte per slot (torch.bool).
// Returns the CUDA error code of the launch (0 on success). Asynchronous on
// `stream`.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, int B, int C, int H,
                                    int Hkv, int D, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      (H / Hkv) * D > NT * MAX_ACC || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(q, k, v, mask, o, B, C, H, Hkv, D, st)
                 : launch<__nv_bfloat16>(q, k, v, mask, o, B, C, H, Hkv, D, st);
  return (int)err;
}
