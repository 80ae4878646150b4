// Single-token GQA decode attention over a KV cache, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_dec_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py. Same function: q [B,1,H,D] attends
// over k, v [B,C,Hkv,D] under a bool mask [B,C]; the g = H/Hkv query heads of
// kv head hk form one [g, D] tile; f32 online softmax (m, l, acc) with scale
// 1/sqrt(D) applied to q; masked slots get -FLT_MAX (finfo(f32).min), so a
// row with no valid slot yields the mean of V as the reference's softmax over
// equal logits does; a zero denominator becomes 1; output in q's dtype.
// Optionally (a non-null `lse`) it also writes each (b, head)'s log-sum-exp
// of the scaled logits over the valid slots, f32 [B, H]: what a caller needs
// to merge attention over disjoint slices of one cache (ranks that each hold
// C/M slots). In that mode a row with no valid slot reads no tile and gives
// out = 0, lse = -inf, which merge with zero weight.
//
// What bounds it on the H100: bytes. Each (b, kv head) reads its valid
// slots' k and v once and does 4*g*D FLOPs per slot, about g/2 FLOP per byte
// in f32 (2 for llama3.2-1b, 6 for starcoder2-3b), far below the card's
// ridge; g = 4..12 query rows cannot fill a 64-row wgmma tile, so the
// arithmetic stays SIMT FMA and the design goes after bytes in flight, bytes
// not read, and the fixed latency of a launch that moves only a few MB.
//
// Design (flash-decoding on a thread-block cluster):
// - Grid (B*Hkv*row_groups, n_splits), cluster (1, n_splits). A CTA of 4
//   warps serves up to 4 of the g query heads (one warp per head; row_groups
//   = ceil(g/4) CTAs per kv head, which read the same k, v tiles, the second
//   and third time from L2) over one chunk of the cache. The host planner
//   (kernels/decode_attention.py: plan_splits) picks n_splits <= 8 (a portable
//   cluster), aiming at two CTAs per SM.
// - Masked tiles are not read. Each CTA reduces its row's whole mask
//   (16-byte loads, __syncthreads_or) and takes one ballot per 32-slot tile
//   of its chunk; the q, mask-scan and ballot loads are all issued before
//   any is used, so the set-up costs one trip to device memory. When the row
//   has a valid slot, a tile whose mask is all false is skipped: its weight
//   exp(-FLT_MAX - m) is exactly 0 in the reference. A row with no valid slot
//   does the full work, as the reference does, and gives the mean of V (with
//   `lse`: reads nothing, gives 0). Any mask is taken, not only a prefix
//   (ring caches).
// - The kept tiles stream through a 2-stage cp.async ring in shared memory,
//   16 bytes per copy (one slot's row of one kv head is D contiguous
//   elements): the copy of tile t+1 overlaps the arithmetic on tile t, and
//   the CTAs on an SM (3-4, by head_dim and dtype) keep more in flight. One
//   __syncthreads per tile. Rows are padded by 16 bytes so the per-slot
//   16-byte reads are free of bank conflicts.
// - Per tile, a warp computes its head's 32 scores (lane = slot, four
//   partial sums), the online softmax (shuffles) and p.v (lane = 4 output
//   columns; with D = 64 two lanes share a column group and split the
//   slots); p passes through the warp's own row of shared memory, so the
//   warps never wait on each other inside a tile.
// - Each CTA leaves its partial (m, l, acc) in f32 in its shared memory; a
//   split without a kept tile leaves m = -inf, acc = 0. After a cluster
//   barrier the CTAs merge the output column groups round robin, reading
//   their peers' partials through distributed shared memory. No scratch in
//   device memory, no atomics, no second launch.
// - The dynamic shared-memory attribute is set once per template instance
//   and device, not on every launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;          // threads per CTA
constexpr int NW = NT / 32;      // warps per CTA
constexpr int BK = 32;           // slots per tile (one per lane)
constexpr int STAGES = 2;        // cp.async ring depth
constexpr int MAX_G = 16;        // query heads per kv head
constexpr int MAX_SPLITS = 8;    // CTAs per cluster (the portable limit)
constexpr int MAX_CHUNK = 16384; // slots per split
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int D>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  static constexpr int CPR = D / EPC;              // copies per slot row
  static constexpr int RS = D + EPC;               // padded shared-memory row (elements)
  static constexpr int ELEMS = BK * RS;            // one k (or v) tile
  static constexpr int COPIES = BK * CPR;          // 16-byte copies per k (or v) tile
  static constexpr int DG = D / 4;                 // 4-column groups of an output row
  static constexpr int LSPLIT = 32 % DG == 0 ? 32 / DG : 1;   // lanes sharing a group
  static constexpr int SPL = BK / LSPLIT;          // slots per lane in p.v
  static_assert(D % EPC == 0 && D % 4 == 0 && DG <= 32, "unsupported head_dim");
};

__host__ __device__ constexpr size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

struct Layout {           // byte offsets into dynamic shared memory
  size_t q, p, bits, list, misc, total;
};

// The partial (acc [NW][D] f32, then (m, l) [NW]) reuses the ring after the loop.
template <typename T, int D>
__host__ __device__ Layout layout(int chunk) {
  Layout s{};
  const int n_tiles = (chunk + BK - 1) / BK;
  size_t o = (size_t)STAGES * 2 * Tile<T, D>::ELEMS * sizeof(T);   // k, v ring
  s.q = o;    o += (size_t)NW * D * 4;                              // q * scale, f32
  s.p = o;    o += (size_t)NW * BK * 4;                             // probabilities
  s.bits = o; o += up16((size_t)n_tiles * 4);                       // mask ballot per tile
  s.list = o; o += up16((size_t)n_tiles * 2);                       // kept tiles, in order
  s.misc = o; o += 16;                                              // n_keep
  s.total = o;
  return s;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  void* o;
  float* lse;   // [B, H] f32, or null
  int C, H, Hkv, g, chunk;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  // fill == false writes 16 zero bytes and reads nothing
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one 16-byte chunk of a shared-memory row -> f32
__device__ __forceinline__ void load_chunk(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = y.x;
    f[2 * i + 1] = y.y;
  }
}

// four consecutive elements of shared memory -> f32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void fma4(float4& acc, float w, float4 x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ float4 shfl_xor4(float4 x, int off) {
  return make_float4(__shfl_xor_sync(FULL, x.x, off), __shfl_xor_sync(FULL, x.y, off),
                     __shfl_xor_sync(FULL, x.z, off), __shfl_xor_sync(FULL, x.w, off));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 4)
decode_split_kernel(const Args a) {
  using K = Tile<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout<T, D>(a.chunk);
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  unsigned* bits_s = reinterpret_cast<unsigned*>(smem + L.bits);
  uint16_t* list_s = reinterpret_cast<uint16_t*>(smem + L.list);
  int* misc_s = reinterpret_cast<int*>(smem + L.misc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rgs = (a.g + NW - 1) / NW;                // row groups of one kv head
  const int bh = blockIdx.x / rgs, rg = blockIdx.x - bh * rgs;
  const int b = bh / a.Hkv, hk = bh - b * a.Hkv;
  const int r0 = rg * NW, nr = min(NW, a.g - r0);     // this CTA's query rows
  const bool has_row = warp < nr;                     // warp owns row r0 + warp
  const int split = (int)cluster.block_rank(), ns = (int)cluster.num_blocks();
  const int c_begin = split * a.chunk;
  const int c_end = min(a.C, c_begin + a.chunk);
  const int len = c_end - c_begin;
  const int n_tiles = (len + BK - 1) / BK;

  // 1. Set-up loads, all issued before any is used: q, the first 16 bytes
  //    of the row-mask scan, the first mask byte of each warp's tiles.
  const uint8_t* mrow = a.mask + (size_t)b * a.C;
  const T* qb = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)hk * a.g + r0) * D;
  constexpr int QPT = (NW * D + NT - 1) / NT;
  float qv[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int e = tid + i * NT;
    qv[i] = e < nr * D ? to_f32(qb[e]) : 0.f;
  }
  const int head = min(a.C, (int)((16u - (unsigned)((uintptr_t)mrow & 15u)) & 15u));
  const int nvec = (a.C - head) >> 4;
  const int tail = head + (nvec << 4);
  const uint4* vrow = reinterpret_cast<const uint4*>(mrow + head);
  const uint4 x0 = tid < nvec ? __ldg(vrow + tid) : make_uint4(0u, 0u, 0u, 0u);
  const int c0 = warp * BK + lane;
  const bool m0 = warp < n_tiles && c0 < len && mrow[c_begin + c0] != 0;

  // whether the row has any valid slot, and one ballot per tile of the chunk
  int any = (x0.x | x0.y | x0.z | x0.w) != 0u;
  if (tid < head) any |= mrow[tid];
  for (int i = tid + NT; i < nvec; i += NT) {
    const uint4 x = __ldg(vrow + i);
    any |= (x.x | x.y | x.z | x.w) != 0u;
  }
  if (tail + tid < a.C) any |= mrow[tail + tid];
  for (int j = warp; j < n_tiles; j += NW) {
    const int c = j * BK + lane;
    const bool m = j == warp ? m0 : (c < len && mrow[c_begin + c] != 0);
    const unsigned bal = __ballot_sync(FULL, m);
    if (lane == 0) bits_s[j] = bal;
    any |= bal != 0u;
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int e = tid + i * NT;
    if (e < nr * D) q_s[e] = qv[i] * a.scale;
  }
  const bool row_any = __syncthreads_or(any) != 0;

  // 2. The tiles to read, in order: all of them when the row has no valid
  //    slot, otherwise those with a valid slot.
  if (warp == 0) {
    int cnt = 0;
    for (int j0 = 0; j0 < n_tiles; j0 += 32) {
      const int j = j0 + lane;
      const bool keep = j < n_tiles && ((!row_any && a.lse == nullptr) || bits_s[j] != 0u);
      const unsigned bal = __ballot_sync(FULL, keep);
      if (keep) list_s[cnt + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)j;
      cnt += __popc(bal);
    }
    if (lane == 0) misc_s[0] = cnt;
  }
  __syncthreads();
  const int n_keep = misc_s[0];

  // 3. Stream the kept tiles through the cp.async ring.
  const size_t slot_stride = (size_t)a.Hkv * D;
  const size_t kv0 = ((size_t)b * a.C * a.Hkv + hk) * D;
  const T* kbase = static_cast<const T*>(a.k) + kv0;
  const T* vbase = static_cast<const T*>(a.v) + kv0;
  auto issue = [&](int li) {
    if (li < n_keep) {
      T* ks = ring + (size_t)(li % STAGES) * 2 * K::ELEMS;
      T* vs = ks + K::ELEMS;
      const int s0 = c_begin + list_s[li] * BK;
#pragma unroll
      for (int it = 0; it < (K::COPIES + NT - 1) / NT; ++it) {
        const int i = tid + it * NT;
        if (K::COPIES % NT == 0 || i < K::COPIES) {
          const int c = i / K::CPR, ch = i - c * K::CPR;
          const bool in = s0 + c < c_end;
          const size_t off = (size_t)(in ? s0 + c : s0) * slot_stride + ch * K::EPC;
          cp_async16(ks + c * K::RS + ch * K::EPC, kbase + off, in);
          cp_async16(vs + c * K::RS + ch * K::EPC, vbase + off, in);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // p.v: lane owns columns 4*dg .. 4*dg+3 of the warp's row, for slots
  // [half*SPL, (half+1)*SPL); LSPLIT lanes share one column group
  const int dg = lane % K::DG, half = lane / K::DG;
  const bool pv_lane = half < K::LSPLIT;
  const float* qr = q_s + warp * D;
  float* pr = p_s + warp * BK;

  for (int li = 0; li < n_keep; ++li) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile li has landed; every warp is done with tile li-1
    issue(li + STAGES - 1);
    if (!has_row) continue;
    const T* ks = ring + (size_t)(li % STAGES) * 2 * K::ELEMS;
    const T* vs = ks + K::ELEMS;
    const int j_tile = list_s[li];
    const bool in = j_tile * BK + lane < len;
    const bool valid = (bits_s[j_tile] >> lane) & 1u;

    // score of slot `lane`; four partial sums for ILP
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const T* krow = ks + lane * K::RS;
#pragma unroll
    for (int ch = 0; ch < K::CPR; ++ch) {
      float kf[K::EPC];
      load_chunk(krow + ch * K::EPC, kf);
#pragma unroll
      for (int e = 0; e < K::EPC; e += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + ch * K::EPC + e);
        float& sp = s[(ch * K::EPC + e) / 4 % 4];
        sp = fmaf(qq.x, kf[e], sp);
        sp = fmaf(qq.y, kf[e + 1], sp);
        sp = fmaf(qq.z, kf[e + 2], sp);
        sp = fmaf(qq.w, kf[e + 3], sp);
      }
    }
    // past the chunk: no weight at all; masked: the reference's finfo.min
    const float x = in ? (valid ? (s[0] + s[1]) + (s[2] + s[3]) : -FLT_MAX) : -INFINITY;
    const float m_new = fmaxf(m, warp_max(x));
    const float p = expf(x - m_new);
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
    m = m_new;
    pr[lane] = p;
    __syncwarp();

    if (pv_lane) {
      float4 o0 = scale4(acc, alpha), o1 = make_float4(0.f, 0.f, 0.f, 0.f);
      const T* vcol = vs + half * K::SPL * K::RS + dg * 4;
#pragma unroll
      for (int c4 = 0; c4 < K::SPL; c4 += 4) {
        const float4 pp = *reinterpret_cast<const float4*>(pr + half * K::SPL + c4);
        fma4(o0, pp.x, load4(vcol + (c4 + 0) * K::RS));
        fma4(o1, pp.y, load4(vcol + (c4 + 1) * K::RS));
        fma4(o0, pp.z, load4(vcol + (c4 + 2) * K::RS));
        fma4(o1, pp.w, load4(vcol + (c4 + 3) * K::RS));
      }
      acc = make_float4(o0.x + o1.x, o0.y + o1.y, o0.z + o1.z, o0.w + o1.w);
    }
  }
  cp_async_wait<0>();
  if (K::LSPLIT == 2) {
    const float4 o = shfl_xor4(acc, K::DG);
    acc.x += o.x; acc.y += o.y; acc.z += o.z; acc.w += o.w;
  }
  __syncthreads();   // the ring is free: it takes this CTA's partial

  // 4. The partial (acc, m, l) in shared memory; after the cluster barrier
  //    the CTAs of the cluster merge the output column groups round robin.
  float4* acc_s = reinterpret_cast<float4*>(ring);                // [nr][DG]
  float2* ml_s = reinterpret_cast<float2*>(acc_s + NW * K::DG);   // [nr]
  if (has_row) {
    if (half == 0) acc_s[warp * K::DG + dg] = acc;
    if (lane == 0) ml_s[warp] = make_float2(m, l);
  }
  cluster.sync();
  T* ob = static_cast<T*>(a.o) + ((size_t)b * a.H + (size_t)hk * a.g + r0) * D;
  for (int u = split + ns * tid; u < nr * K::DG; u += ns * NT) {
    const int r = u / K::DG;
    float2 ml[MAX_SPLITS];
    float4 y[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < ns) {
        ml[s] = cluster.map_shared_rank(ml_s, s)[r];
        y[s] = cluster.map_shared_rank(acc_s, s)[u];
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < ns) M = fmaxf(M, ml[s].x);
    float lsum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < ns) {
        // a split without a kept tile has m = -inf and acc = 0: no weight
        const float w = ml[s].x == -INFINITY ? 0.f : expf(ml[s].x - M);
        lsum += w * ml[s].y;
        fma4(o, w, y[s]);
      }
    }
    const float den = lsum == 0.f ? 1.f : lsum;
    store4(ob + u * 4, scale4(o, 1.f / den));
    if (a.lse != nullptr && u % K::DG == 0)
      a.lse[(size_t)b * a.H + (size_t)hk * a.g + r0 + r] = lsum == 0.f ? -INFINITY : M + logf(lsum);
  }
  cluster.sync();   // peers' shared memory stays until every CTA has read it
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, int n_splits, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};   // one bit per device
  auto kernel = decode_split_kernel<T, D>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (!(attr_set.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)layout<T, D>(MAX_CHUNK).total);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.Hkv * ((a.g + NW - 1) / NW), n_splits, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = layout<T, D>(a.chunk).total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, int n_splits, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, n_splits, stream);
    case 80: return launch<T, 80>(a, B, n_splits, stream);
    case 128: return launch<T, 128>(a, B, n_splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask is one byte per slot (torch.bool);
// lse is null or a float32 [B, H] output (see the header).
// D is 64, 80 or 128; H/Hkv <= 16. The plan (n_splits <= 16, chunk <= 16384)
// covers [0, C): (n_splits - 1) * chunk < C <= n_splits * chunk. q, k, v and
// o are 16-byte aligned. Returns the CUDA error code of the launch (0 on
// success). Asynchronous on `stream`.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, void* lse, int B, int C, int H,
                                    int Hkv, int D, int dtype, int n_splits, int chunk,
                                    void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_G ||
      (dtype != 0 && dtype != 1) || n_splits < 1 || n_splits > MAX_SPLITS || chunk < 1 ||
      chunk > MAX_CHUNK || (long long)(n_splits - 1) * chunk >= C ||
      (long long)n_splits * chunk < C)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const uint8_t*>(mask), o, static_cast<float*>(lse), C, H,
               Hkv, H / Hkv, chunk, 1.0f / sqrtf((float)D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_d<float>(a, B, D, n_splits, st)
                                     : launch_d<__nv_bfloat16>(a, B, D, n_splits, st);
  return (int)err;
}
