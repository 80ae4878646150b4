// Causal GQA prefill attention (flash attention forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function: q [B,S,H,D] and
// k, v [B,S,Hkv,D] give o [B,S,H,D]; flat q-head h = b*H + hq reads kv head
// b*Hkv + hq/(H/Hkv); optional sliding window (col > row - window); f32
// online softmax (m, l, acc) with scale 1/sqrt(D) applied to q; masked logits
// are -FLT_MAX (finfo(f32).min), never -inf, so an all-masked tile followed
// by a valid one self-corrects through alpha = exp(m_prev - m_new) = 0; a zero
// denominator becomes 1. bf16 inputs are accumulated in f32.
//
// What bounds it on the H100: at prefill lengths the q.k^T and p.v products
// (4*S^2*D/2 FLOPs per head, causal) dominate, so the bound is operations;
// at the serving shapes (S=32) the whole call moves a few MB and is bound by
// launch and latency, not by either roof.
//
// Design: grid (B*H, ceil(S/BQ)); one CTA of 256 threads owns BQ=64 query
// rows of one head and loops over kv tiles of BK=64 only from the first tile
// that intersects the window up to the diagonal tile, so fully masked tiles
// are neither launched nor loaded (the Pallas kernel walks the full grid and
// skips them with pl.when). The TPU's sequential "arbitrary" grid axis that
// carried m, l, acc in VMEM becomes this loop, with m, l, acc in registers.
// q and the current k, v tiles sit in shared memory as f32 (padded to DP,
// 64 or 128, with zeros, so D = 80 runs in the 128 variant). Each thread
// computes a 4x4 block of the 64x64 score tile (rows ty+16i, cols tx+16j),
// reduces row max and row sum over the 16 lanes that share its rows with
// warp shuffles, writes p to shared memory and accumulates p.v for its rows
// and DP/16 columns. Plain SIMT FMA: wgmma/TMA tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cfloat>
#include <cmath>
#include <cstddef>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DP>
constexpr size_t smem_bytes() {
  // q tile, k tile (rows padded by 4 floats), v tile, p tile
  return sizeof(float) * (size_t)(BQ * (DP + 4) + BK * (DP + 4) + BK * DP + BQ * (BK + 4));
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int Hkv, int D, int causal, int window, float scale) {
  constexpr int QS = DP + 4;    // row stride of the q and k tiles
  constexpr int PS = BK + 4;    // row stride of the p tile
  constexpr int CG = DP / 64;   // float4 column groups of acc per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][QS]
  float* k_s = q_s + BQ * QS;                    // [BK][QS]
  float* v_s = k_s + BK * QS;                    // [BK][DP]
  float* p_s = v_s + BK * DP;                    // [BQ][PS]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int D4 = (D + 3) & ~3;   // dot-product length, zero padded

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, d = i % DP;
    const int s = q0 + r;
    float x = 0.f;
    if (s < S && d < D) x = to_f32(q[((size_t)(b * S + s) * H + h) * D + d]) * scale;
    q_s[r * QS + d] = x;
  }

  float m[4], l[4], acc[4][CG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int hi = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile consumed; q tile stored on the first pass
    for (int i = tid; i < BK * DP; i += NT) {
      const int r = i / DP, d = i % DP;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S && d < D) {
        const size_t off = ((size_t)(b * S + s) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[r * QS + d] = kx;
      v_s[r * DP + d] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&q_s[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] += qa[i].x * kb[j].x + qa[i].y * kb[j].y + qa[i].z * kb[j].z + qa[i].w * kb[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = sc[i][j];
        if (c >= S) x = -INFINITY;  // past the sequence: no weight at all
        else if ((causal && c > r) || (window > 0 && c <= r - window)) x = -FLT_MAX;
        sc[i][j] = x;
        mc = fmaxf(mc, x);
      }
      mc = group16_max(mc);
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      rs = group16_sum(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        acc[i][c][0] *= alpha; acc[i][c][1] *= alpha;
        acc[i][c][2] *= alpha; acc[i][c][3] *= alpha;
      }
    }
    __syncthreads();

    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(&p_s[(ty + 16 * i) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          const float4 vb = *reinterpret_cast<const float4*>(&v_s[(j + jj) * DP + c * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
            acc[i][c][0] += p * vb.x; acc[i][c][1] += p * vb.y;
            acc[i][c][2] += p * vb.z; acc[i][c][3] += p * vb.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)(b * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 64 + tx * 4 + e;
        if (d < D) orow[d] = from_f32<T>(acc[i][c][e] / denom);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int Hkv, int D, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  const float scale = 1.0f / sqrtf((float)D);
  flash_fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, D, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. Returns the CUDA
// error code of the launch (0 on success). Asynchronous on `stream`.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int Hkv, int D, int causal,
                                   int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D <= 64 ? launch<float, 64>(q, k, v, o, B, S, H, Hkv, D, causal, window, st)
                  : launch<float, 128>(q, k, v, o, B, S, H, Hkv, D, causal, window, st);
  else
    err = D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, Hkv, D, causal, window, st)
                  : launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, Hkv, D, causal, window, st);
  return (int)err;
}
