// Gated combine of a mixture-of-experts layer: the experts' outputs added
// back into token order, for Hopper, sm_90a.
//
// Replaces no TPU kernel. The JAX package's MoE (src/repro/nn/moe.py:
// _dispatch_compute_combine) is plain jnp: it gates each expert's outputs
// and scatter-adds them into a float32 [B, S, d]. The port used to build that
// sum from a zero-filled float32 [B, E, S, d] buffer, one scatter and a sum
// over E (no atomics, so the same bits on every run): at granite-moe's B 32 x
// S 448 (E 48 with padding, C 112, d 1536) about 11 GB of traffic a layer
// and a 3.9 GiB transient, to add back the 28% of slots that hold a token.
//
// Function: ye [B, E, C, d] (bf16 or f32; any strides on b, e, c, the last
// axis contiguous), gsel [B, E, C] f32, slot_of [B, E, S] int32 (the slot c
// that token s holds in expert e, or -1) -> y [B, S, d] in f32 or in ye's
// type, where y[b, s] = sum over e ascending of term(b, e, slot_of[b, e, s])
// for every slot >= 0, each term the JAX package's: g = to(T, gsel), term =
// to(T, ye * g), added in f32 (f32 products and sums rounded to nearest, no
// FMA contraction), then rounded once to the output type. The plain version,
// kernels/ref.py:moe_combine_ref, repeats this arithmetic in the same order,
// so the two agree bit for bit. The one difference from the JAX package is
// the association of the f32 sum, ascending expert order where JAX
// scatter-adds.
//
// What bounds it on the H100: bytes. Each term is one multiply and one add
// per element. The least traffic is the used rows of ye, slot_of, the used
// gates and y written once: at the shape above 148 MB + 2.75 MB + 0.7 MB +
// 44 MB (bf16 y), about 0.058 ms at 3.35 TB/s.
//
// Design:
// - Grid (ceil(S / tok), B): a block of 256 threads owns `tok` tokens of one
//   row (the host's plan_tokens: 16, halved while the grid is under two
//   blocks an SM). Every output element has one writer and no atomics are
//   used, so every run gives the same bits; the kernel allocates nothing, so
//   a captured decode step (S 1, C 1) stays capturable.
// - The block stages its tokens' slot_of column block [E, tok] in shared
//   memory with coalesced reads, then one warp a token compacts it with
//   ballots into the token's list of (ye row offset, gate in T), in
//   ascending e. Empty slots are never read.
// - Each thread then owns 16 bytes of d of one token (8 bf16 or 4 f32
//   values; a d that the vector does not divide, or a ye whose rows are not
//   16-byte aligned, takes the same loop with scalar loads and a masked
//   tail) and walks the token's list four rows at a time: four 16-byte
//   loads in flight, then the four terms added in order. The result is
//   written once, as vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int MAX_TOK = 16;      // tokens per block
constexpr int UNROLL = 4;        // ye rows in flight per thread
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* ye;
  const float* gsel;
  const int* slot;
  void* y;
  long long sb, se, sc;  // ye strides (elements) over b, e, c
  int E, C, S, d, tok;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// to(T, ye * g) as a float: the product of two T values rounded to T.
template <typename T>
__device__ __forceinline__ float term(float v, float g) {
  return to_f(from_f<T>(__fmul_rn(v, g)));
}

__host__ __device__ constexpr size_t smem_bytes(int E, int tok) {
  // per token E row offsets (8 B) and E gates (4 B), the staged slots [E][tok | 1], a count
  // per token
  return (size_t)E * (tok | 1) * 4 + (size_t)tok * E * 12 + (size_t)tok * 4;
}

template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(NT) moe_combine_kernel(const Args a) {
  constexpr int V = 16 / (int)sizeof(T);  // elements a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = a.E, tok = a.tok, pitch = tok | 1;
  long long* offs = reinterpret_cast<long long*>(smem);          // [tok][E]
  float* gates = reinterpret_cast<float*>(offs + (size_t)tok * E);  // [tok][E]
  int* stage = reinterpret_cast<int*>(gates + (size_t)tok * E);     // [E][pitch]
  int* count = stage + (size_t)E * pitch;                           // [tok]
  const int b = blockIdx.y, s0 = blockIdx.x * tok;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* slot_b = a.slot + (size_t)b * E * a.S;
  const float* gsel_b = a.gsel + (size_t)b * E * a.C;

  for (int i = tid; i < E * tok; i += NT) {
    const int e = i / tok, t = i - e * tok, s = s0 + t;
    stage[e * pitch + t] = s < a.S ? slot_b[(size_t)e * a.S + s] : -1;
  }
  __syncthreads();

  for (int t = warp; t < tok; t += NW) {
    int n = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < E ? stage[e * pitch + t] : -1;
      const bool used = (unsigned)c < (unsigned)a.C;
      const unsigned ballot = __ballot_sync(FULL, used);
      if (used) {
        const int k = n + __popc(ballot & ((1u << lane) - 1u));
        offs[t * E + k] = (long long)b * a.sb + (long long)e * a.se + (long long)c * a.sc;
        gates[t * E + k] = to_f(from_f<T>(gsel_b[(size_t)e * a.C + c]));
      }
      n += __popc(ballot);
    }
    if (lane == 0) count[t] = n;
  }
  __syncthreads();

  const T* ye = static_cast<const T*>(a.ye);
  const int nv = (a.d + V - 1) / V;
  for (int item = tid; item < tok * nv; item += NT) {
    const int t = item / nv, col = (item - t * nv) * V, s = s0 + t;
    if (s >= a.S) break;  // items run in token order: every later one is past S too
    const int n = count[t];
    const long long* off = offs + t * E;
    const float* g = gates + t * E;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int k = 0; k < n; k += UNROLL) {
      uint4 raw[UNROLL];  // UNROLL rows of V values each
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k + u < n) {
          const T* row = ye + off[k + u] + col;
          if constexpr (VEC) {
            raw[u] = __ldg(reinterpret_cast<const uint4*>(row));
          } else {
            T* v = reinterpret_cast<T*>(&raw[u]);
#pragma unroll
            for (int i = 0; i < V; ++i) v[i] = col + i < a.d ? row[i] : from_f<T>(0.0f);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k + u < n) {
          const float gu = g[k + u];
          const T* v = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], term<T>(to_f(v[i]), gu));
        }
      }
    }
    O* dst = static_cast<O*>(a.y) + ((size_t)b * a.S + s) * a.d + col;
    if constexpr (VEC) {
      constexpr int BYTES = V * (int)sizeof(O);  // 8, 16 or 32
      uint4 out[(BYTES + 15) / 16];
      O* o = reinterpret_cast<O*>(out);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = from_f<O>(acc[i]);
      if constexpr (BYTES == 8) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(out);
      } else {
#pragma unroll
        for (int q = 0; q < BYTES / 16; ++q) reinterpret_cast<uint4*>(dst)[q] = out[q];
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (col + i < a.d) dst[i] = from_f<O>(acc[i]);
    }
  }
}

template <typename T, typename O>
cudaError_t launch_o(const Args& a, int B, bool vec, cudaStream_t st) {
  const dim3 grid((a.S + a.tok - 1) / a.tok, B);
  const size_t smem = smem_bytes(a.E, a.tok);
  if (vec)
    moe_combine_kernel<T, O, true><<<grid, NT, smem, st>>>(a);
  else
    moe_combine_kernel<T, O, false><<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, int B, bool out_f32, bool vec, cudaStream_t st) {
  return out_f32 ? launch_o<T, float>(a, B, vec, st) : launch_o<T, T>(a, B, vec, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (ye); out_f32: y in f32 (else in ye's type); vec:
// ye's rows and strides are whole 16-byte vectors (else scalar loads).
// Returns a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int moe_combine_fwd(const void* ye, const void* gsel, const void* slot_of, void* y,
                               long long sb, long long se, long long sc, int B, int E, int C,
                               int S, int d, int tok, int dtype, int out_f32, int vec,
                               void* stream) {
  if (B <= 0 || B > 65535 || E <= 0 || C <= 0 || S <= 0 || d <= 0 || tok <= 0 ||
      tok > MAX_TOK || (dtype != 0 && dtype != 1) || smem_bytes(E, tok) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const Args a{ye, static_cast<const float*>(gsel), static_cast<const int*>(slot_of), y,
               sb, se, sc, E, C, S, d, tok};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_t<float>(a, B, out_f32 != 0, vec != 0, st)
                                     : launch_t<__nv_bfloat16>(a, B, out_f32 != 0, vec != 0, st);
  return (int)err;
}
