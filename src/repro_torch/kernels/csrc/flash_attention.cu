// GQA prefill attention (flash attention forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function: q [B,S,H,D] and
// k, v [B,S,Hkv,D] give o [B,S,H,D]; q-head h reads kv head h / (H/Hkv);
// causal or not, with an optional sliding window (col > row - window); f32
// online softmax (m, l, acc) with the scale 1/sqrt(D) on q.k (applied to the
// f32 product, which equals scaling q up to f32 rounding); masked logits are
// -FLT_MAX (finfo(f32).min), never -inf, so an all-masked tile followed by a
// valid one self-corrects through alpha = exp(m_prev - m_new) = 0; columns
// past S are -inf; a zero denominator becomes 1; bf16 outputs are rounded
// once at the end.
//
// What bounds it on the H100: at prefill lengths the q.k^T and p.v products
// (4*D FLOPs per unmasked (row, col) pair) make it operation-bound; at the
// serving shapes (S = 32) a call moves a few MB and is bound by the launch
// and two trips to device memory.
//
// Design:
// - GQA-packed tiles. One CTA owns one (b, kv head, packed tile). A consumer
//   warpgroup's 64 rows are P = 64/g positions x the g query heads of the kv
//   head, position-major: row r is (position q0 + r/g, head hk*g + r%g). In
//   [B,S,H,D] the g heads of a position are contiguous, so the q tile is one
//   3-D TMA box (D, g, P) and the o tile is stored the same way. Each K/V
//   tile is loaded once for all g heads. The host planner (plan_tiles in
//   kernels/flash_attention.py) picks P, one or two consumer warpgroups per
//   CTA, the kv rows per tile and the grid (B*Hkv, n_tiles); heavy (late)
//   tiles are scheduled first.
// - Loads in flight. The last warpgroup is the producer: one thread issues
//   TMA loads of the q tile and of K and V tiles (64 rows; in bf16 128 once
//   S > 64, in f32 32 while S <= 32) into a 2-3 stage ring guarded by mbarriers (full: transaction
//   bytes, empty: one arrival per consumer warp). With two consumer
//   warpgroups the producer hands its registers to them (setmaxnreg). Tiles
//   use the 128-byte swizzle in boxes of 128-byte rows; D = 128 in bf16 (and
//   every f32 tile) is split into several boxes. TMA's zero fill covers rows
//   past S and pads D = 80 to 128 columns. The kv range of a CTA runs from
//   the window's first tile to the causal diagonal of its last position;
//   masked tiles are never loaded.
// - bf16: S = Q.K^T is wgmma.m64nBKk16 with both operands in shared memory
//   (K-major); the online softmax runs in registers (quad shuffles, exp2);
//   P is rounded to bf16 in registers and is the register A operand of
//   O += P.V, whose B operand (V) is read MN-major from shared memory.
//   Inside a warpgroup, Q.K^T of tile t and P.V of tile t-1 run on the
//   tensor cores while the softmax of tile t runs (one S register set, one
//   P set), and two consumer warpgroups take turns to issue their products
//   (ping-pong on named barriers); O is rescaled only when a row's max moved.
// - f32: the same CTA, ring and softmax; the products are 3xTF32 on
//   mma.sync.m16n8k8 (hi = tf32(x), lo = x - hi read as TF32, a.b ~ hi.lo +
//   lo.hi + hi.hi, f32 accumulation): f32 accuracy on the tensor cores. Each
//   k step issues its 24 products as three passes over eight accumulators.
//   The kv index inside each 8-column step is permuted (logical k <->
//   columns 2k, 2k+1) so that the score accumulators are the A operand of
//   P.V without shuffles, and V is read in place, with no transposed copy.
// - Epilogue: O is normalised in registers, written over the warpgroup's q
//   tile in shared memory and stored by one TMA store per box (rows past S
//   and columns past D are clipped by the tensor map).
// - The dynamic shared-memory attribute is set once per template instance
//   and device; the tensor maps are encoded on every call (the pointers
//   change) through cuTensorMapEncodeTiled from cudaGetDriverEntryPoint, so
//   the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int BK = 64;             // kv rows per tile; f32 also takes 32, bf16 128
constexpr int ROWS = 64;           // rows per consumer warpgroup (wgmma M)
constexpr int WG = 128;            // threads per warpgroup
constexpr int BOX = 8192;          // one box: 64 rows of 128 bytes, 128-byte swizzle
constexpr int MAX_G = 16;
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int SMEM_MAX = 232448;   // dynamic shared memory of one CTA

template <typename T, int DP, int NWG, int BKT>
struct Cfg {
  static constexpr int NB = DP * (int)sizeof(T) / 128;   // boxes per tile row
  static constexpr int DBOX = 128 / (int)sizeof(T);      // elements per box row
  static constexpr int TILE = NB * BOX;                  // one q tile
  static constexpr int KV_TILE = NB * BKT * 128;         // one K or V tile
  // three stages where they fit, else two
  static constexpr int STAGES = NWG * TILE + 6 * KV_TILE + 2048 <= SMEM_MAX ? 3 : 2;
  static constexpr int K_OFF = NWG * TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;   // + alignment slack
  static constexpr int THREADS = (NWG + 1) * WG;
  static_assert(SMEM <= SMEM_MAX, "tiles exceed the shared memory of a CTA");
};

// ---- shared memory, barriers, TMA -----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of element (r, c) of a tile stored as boxes of R rows x 128
// bytes with the 128-byte swizzle (the 16-byte chunk index XOR r % 8).
template <typename T, int R = ROWS>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  constexpr int E = 128 / (int)sizeof(T);
  const int cb = (c % E) * (int)sizeof(T);
  return (c / E) * (R * 128) + r * 128 + ((((cb >> 4) ^ r) & 7) << 4) + (cb & 15);
}

// ---- wgmma (bf16) -----------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand: 8-row groups 1024 bytes apart
// (SBO); LBO is the stride between 64-element column blocks of an MN-major
// operand and is not read for K-major ones.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(BOX >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define WG_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 8N] (+)= A[64x16] . B[16 x 8N], A and B K-major in shared memory, N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d), WG_OUT32((d + 32))
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] (+)= A[64x16] . B[16x64], A and B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] += A[64x16] . B[16x64], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mma.sync 3xTF32 (f32) --------------------------------------------------

// hi: x rounded to nearest to TF32's 10 mantissa bits (ties away from zero);
// lo = x - hi, exact in f32, passed whole: the tensor core reads its top 19
// bits (truncation), an error below 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a.b ~ a_hi.b_lo + a_lo.b_hi + a_hi.b_hi (small terms first)
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi, const uint32_t* alo,
                                           uint32_t bhi0, uint32_t bhi1, uint32_t blo0,
                                           uint32_t blo1) {
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

// ---- the two products ----------------------------------------------------------
//
// Accumulator layout (wgmma m64nN and mma m16n8, per warp w of the
// warpgroup, lane = 4*gq + tq): element 4*j + 2*h + c is row 16*w + gq + 8*h,
// column 8*j + 2*tq + c.

// bf16: s[64 x BKT] = Q[64 x DP] . K[BKT x DP]^T, issued and committed, not waited for
template <int DP, int BKT>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {   // 4 k16 steps per 128-byte box
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss<BKT>(s, desc(q + (kk / 4) * BOX + step), desc(k + (kk / 4) * BKT * 128 + step),
                  kk > 0);
  }
  wg_commit();
}

// bf16: o[64 x DP] += P[64 x BKT] . V[BKT x DP], P in registers, issued and committed
template <int DP, int BKT>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*p)[4], uint32_t v) {
#pragma unroll
  for (int nb = 0; nb < DP / 64; ++nb)
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk)
      wgmma_rs(o + 32 * nb, p[kk], desc(v + nb * BKT * 128 + kk * 2048));
  wg_commit();
}

// P (f32, accumulator layout) -> the bf16 A fragments of BKT/16 k16 steps
template <int BKT>
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*p)[4]) {
#pragma unroll
  for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// f32: s[16 x BKT] per warp = Q . K^T in 3xTF32. The three products of one
// k step are issued as three passes over the BKT/8 accumulators, so that no
// mma waits on the one before it.
template <int DP, int BKT>
__device__ __forceinline__ void qk_3xtf32(float* s, const uint8_t* q, const uint8_t* k, int warp,
                                          int gq, int tq) {
#pragma unroll
  for (int i = 0; i < BKT / 2; ++i) s[i] = 0.f;
  const int r0 = 16 * warp + gq;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int c = 8 * kk + 2 * tq;   // logical k tq, tq + 4 <-> columns c, c + 1
    const float2 x0 = *reinterpret_cast<const float2*>(q + sw<float>(r0, c));
    const float2 x1 = *reinterpret_cast<const float2*>(q + sw<float>(r0 + 8, c));
    uint32_t ahi[4], alo[4], bh[BKT / 8][2], bl[BKT / 8][2];
    split(x0.x, ahi[0], alo[0]);
    split(x1.x, ahi[1], alo[1]);
    split(x0.y, ahi[2], alo[2]);
    split(x1.y, ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
      const float2 y = *reinterpret_cast<const float2*>(k + sw<float, BKT>(8 * j + gq, c));
      split(y.x, bh[j][0], bl[j][0]);
      split(y.y, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) mma_tf32(s + 4 * j, ahi, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) mma_tf32(s + 4 * j, alo, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) mma_tf32(s + 4 * j, ahi, bh[j][0], bh[j][1]);
  }
}

// f32: o[16 x DP] per warp += P[16 x BKT] . V in 3xTF32, eight output column
// blocks per pass
template <int DP, int BKT>
__device__ __forceinline__ void pv_3xtf32(float* o, const float* s, const uint8_t* v, int gq,
                                          int tq) {
#pragma unroll
  for (int jj = 0; jj < BKT / 8; ++jj) {
    // logical k tq, tq + 4 <-> kv rows 8*jj + 2*tq, + 1 (the columns of s)
    uint32_t ahi[4], alo[4];
    split(s[4 * jj + 0], ahi[0], alo[0]);
    split(s[4 * jj + 2], ahi[1], alo[1]);
    split(s[4 * jj + 1], ahi[2], alo[2]);
    split(s[4 * jj + 3], ahi[3], alo[3]);
    const int r = 8 * jj + 2 * tq;
#pragma unroll
    for (int n8 = 0; n8 < DP / 64; ++n8) {
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * n8 + 8 * i + gq;
        split(*reinterpret_cast<const float*>(v + sw<float, BKT>(r, col)), bh[i][0], bl[i][0]);
        split(*reinterpret_cast<const float*>(v + sw<float, BKT>(r + 1, col)), bh[i][1],
              bl[i][1]);
      }
      float* on = o + 32 * n8;
#pragma unroll
      for (int i = 0; i < 8; ++i) mma_tf32(on + 4 * i, ahi, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < 8; ++i) mma_tf32(on + 4 * i, alo, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < 8; ++i) mma_tf32(on + 4 * i, ahi, bh[i][0], bh[i][1]);
    }
  }
}

// ---- online softmax over one BK-column tile, in the accumulator layout ------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// m is kept in units of log2, scaled: m = max(q.k) * scale * log2(e). A tile
// with masked or out-of-range columns is scaled and masked first; any other
// tile folds the scale into one FFMA per element.
template <bool MASK, int BKT>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l, float* alpha,
                                             const int* pos, int col0, int S, int causal,
                                             int window, float scale_log2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * j + 2 * h + c];
        if (MASK) {
          x *= scale_log2;
          const int col = col0 + 8 * j + c;
          if (col >= S)
            x = -INFINITY;   // past the sequence: no weight at all
          else if ((causal && col > pos[h]) || (window > 0 && col <= pos[h] - window))
            x = -FLT_MAX;
          s[4 * j + 2 * h + c] = x;
        }
        mx = fmaxf(mx, x);
      }
    if (!MASK) mx *= scale_log2;
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[h], mx);
    alpha[h] = ex2(m[h] - mn);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * h + c];
        x = MASK ? ex2(x - mn) : ex2(fmaf(x, scale_log2, -mn));
        rs += x;
      }
    l[h] = alpha[h] * l[h] + rs;   // this thread's columns; summed over the quad at the end
    m[h] = mn;
  }
}

template <typename T> __device__ __forceinline__ void store_pair(uint8_t* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(uint8_t* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(uint8_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// ---- the kernel ---------------------------------------------------------------

template <typename T, int DP, int NWG, int BKT>
__global__ void __launch_bounds__(Cfg<T, DP, NWG, BKT>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 int S, int D, int Hkv, int g, int P, int n_tiles, int causal, int window,
                 float scale_log2) {
  using C = Cfg<T, DP, NWG, BKT>;
  static_assert(sizeof(T) == 2 ? BKT >= BK : BKT <= BK, "bf16 takes 64 or 128 kv rows, f32 32 or 64");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + C::BAR_OFF;
  const uint32_t empty = full + 8 * C::STAGES;
  const uint32_t qbar = empty + 8 * C::STAGES;

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int q0 = (n_tiles - 1 - blockIdx.y) * NWG * P;   // heavy tiles first
  const int q_last = min(q0 + NWG * P, S) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) / BKT : 0;
  const int hi = causal ? q_last / BKT + 1 : (S + BKT - 1) / BKT;
  const int n_kv = hi - lo;
  const int rows = P * g;
  const int wg = threadIdx.x / WG;

  // zero the rows of each q box that TMA does not fill (read by the products)
  if (rows < ROWS) {
    const int chunks = (ROWS - rows) * 8;   // 16-byte chunks per box
    for (int i = threadIdx.x; i < NWG * C::NB * chunks; i += C::THREADS) {
      const int box = i / chunks, ci = i % chunks;
      *reinterpret_cast<uint4*>(smem + box * BOX + rows * 128 + ci * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NWG * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (wg == NWG) {   // producer warpgroup: one thread issues every load
    // two consumer warpgroups take the registers the producer does not need
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == NWG * WG) {
      mbar_expect_tx(qbar, NWG * C::NB * rows * 128);
      for (int w = 0; w < NWG; ++w)
        for (int nb = 0; nb < C::NB; ++nb)
          tma_load(sbase + w * C::TILE + nb * BOX, &tm_q, qbar, nb * C::DBOX, hk * g, q0 + w * P, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * C::KV_TILE);
        const int k0 = (lo + it) * BKT;
        for (int nb = 0; nb < C::NB; ++nb) {
          const uint32_t off = s * C::KV_TILE + nb * BKT * 128;
          tma_load(sbase + C::K_OFF + off, &tm_k, full + 8 * s, nb * C::DBOX, hk, k0, b);
          tma_load(sbase + C::V_OFF + off, &tm_v, full + 8 * s, nb * C::DBOX, hk, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: positions q0w .. q0w + P - 1
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int q0w = q0 + wg * P;
  const int r0 = 16 * warp + gq;
  const int pos[2] = {q0w + r0 / g, q0w + (r0 + 8) / g};
  const int pmin = q0w, pmax = q0w + P - 1;
  uint8_t* qs = smem + wg * C::TILE;
  const uint32_t qa = sbase + wg * C::TILE;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  float s[BKT / 2];
#pragma unroll
  for (int i = 0; i < BKT / 2; ++i) s[i] = 0.f;

  // the online softmax of kv tile `it`, masked only where the tile needs it
  auto softmax = [&](int it, float* alpha) {
    const int k0 = (lo + it) * BKT;
    if (k0 + BKT > S || (causal && k0 + BKT - 1 > pmin) || (window > 0 && k0 <= pmax - window))
      softmax_tile<true, BKT>(s, m, l, alpha, pos, k0 + 2 * tq, S, causal, window, scale_log2);
    else
      softmax_tile<false, BKT>(s, m, l, alpha, pos, k0 + 2 * tq, S, causal, window, scale_log2);
  };
  // O *= alpha, skipped when no row's max moved in the warp
  auto rescale = [&](const float* alpha) {
    if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * j + 2 * h] *= alpha[h];
        o[4 * j + 2 * h + 1] *= alpha[h];
      }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };
  const uint32_t ka = sbase + C::K_OFF, va = sbase + C::V_OFF;
  float alpha[2];
  mbar_wait(qbar, 0);

  if constexpr (sizeof(T) == 2) {
    // Software pipeline inside the warpgroup: Q.K^T of tile it and P.V of
    // tile it-1 are in flight on the tensor cores while the softmax of tile
    // it runs; a stage is released once its P.V is done. Two warpgroups take
    // turns to issue their products (named barriers 3 and 4), so that one's
    // softmax runs while the other's products hold the tensor cores.
    const int my_turn = 3 + wg, their_turn = 3 + (wg ^ 1);
    auto turn = [&] {
      if constexpr (NWG == 2) bar_sync(my_turn, 2 * WG);
    };
    auto pass = [&] {
      if constexpr (NWG == 2) bar_arrive(their_turn, 2 * WG);
    };
    if (NWG == 2 && wg == 1) pass();   // warpgroup 0 goes first
    uint32_t p[BKT / 16][4];
    mbar_wait(full, 0);
    turn();
    wg_fence();
    issue_qk<DP, BKT>(s, qa, ka);
    pass();
    wg_wait<0>();
    pin<BKT / 2>(s);
    softmax(0, alpha);
    pack_p<BKT>(s, p);
    for (int it = 1; it < n_kv; ++it) {
      const int st = it % C::STAGES, prev = (it - 1) % C::STAGES;
      mbar_wait(full + 8 * st, (it / C::STAGES) & 1);
      pin<BKT / 2>(s);
      pin<DP / 2>(o);
      turn();
      wg_fence();
      issue_qk<DP, BKT>(s, qa, ka + st * C::KV_TILE);
      issue_pv<DP, BKT>(o, p, va + prev * C::KV_TILE);
      pass();
      wg_wait<1>();
      pin<BKT / 2>(s);
      softmax(it, alpha);
      wg_wait<0>();
      pin<DP / 2>(o);
      release(prev);
      rescale(alpha);
      pack_p<BKT>(s, p);
    }
    const int last = (n_kv - 1) % C::STAGES;
    pin<DP / 2>(o);
    turn();
    wg_fence();
    issue_pv<DP, BKT>(o, p, va + last * C::KV_TILE);
    pass();
    wg_wait<0>();
    pin<DP / 2>(o);
    release(last);
    if (NWG == 2 && wg == 0) turn();   // takes warpgroup 1's last pass
  } else {
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % C::STAGES;
      mbar_wait(full + 8 * st, (it / C::STAGES) & 1);
      qk_3xtf32<DP, BKT>(s, qs, smem + C::K_OFF + st * C::KV_TILE, warp, gq, tq);
      softmax(it, alpha);
      rescale(alpha);
      pv_3xtf32<DP, BKT>(o, s, smem + C::V_OFF + st * C::KV_TILE, gq, tq);
      release(st);
    }
  }

  // epilogue: normalise, write over the q tile, one TMA store per box
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = l[h];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[h] = 1.f / (x == 0.f ? 1.f : x);
  }
  bar_sync(1 + wg, WG);   // every warp is done reading the q tile
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pair<T>(qs + sw<T>(r0 + 8 * h, 8 * j + 2 * tq), o[4 * j + 2 * h] * inv[h],
                    o[4 * j + 2 * h + 1] * inv[h]);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bar_sync(1 + wg, WG);
  if (threadIdx.x % WG == 0 && q0w < S) {
    for (int nb = 0; nb < C::NB; ++nb)
      if (nb * C::DBOX < D) tma_store(&tm_o, qa + nb * BOX, nb * C::DBOX, hk * g, q0w, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ---- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, S, Hn, D] in boxes of (dbox, box_h, box_s, 1), 128-byte swizzle, zero fill.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool bf16, int B, int S, int Hn, int D,
                     int dbox, int box_h, int box_s) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elt = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hn, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * elt, (cuuint64_t)Hn * D * elt, (cuuint64_t)S * Hn * D * elt};
  const cuuint32_t box[4] = {(cuuint32_t)dbox, (cuuint32_t)box_h, (cuuint32_t)box_s, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         4, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, S, H, Hkv, D, causal, window, P, n_tiles;
};

template <typename T, int DP, int NWG, int BKT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<T, DP, NWG, BKT>;
  static std::atomic<unsigned long long> attr_set{0};   // one bit per device
  auto kernel = flash_fwd_kernel<T, DP, NWG, BKT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (!(attr_set.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit);
  }
  constexpr bool bf16 = sizeof(T) == 2;
  const int g = a.H / a.Hkv;
  CUtensorMap mq, mk, mv, mo;
  if ((err = make_map(&mq, a.q, bf16, a.B, a.S, a.H, a.D, C::DBOX, g, a.P)) != cudaSuccess ||
      (err = make_map(&mk, a.k, bf16, a.B, a.S, a.Hkv, a.D, C::DBOX, 1, BKT)) != cudaSuccess ||
      (err = make_map(&mv, a.v, bf16, a.B, a.S, a.Hkv, a.D, C::DBOX, 1, BKT)) != cudaSuccess ||
      (err = make_map(&mo, a.o, bf16, a.B, a.S, a.H, a.D, C::DBOX, g, a.P)) != cudaSuccess)
    return err;
  const float scale_log2 = LOG2E / sqrtf((float)a.D);
  const dim3 grid(a.B * a.Hkv, a.n_tiles);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, mo, a.S, a.D, a.Hkv, g, a.P,
                                                a.n_tiles, a.causal, a.window, scale_log2);
  return cudaGetLastError();
}

template <typename T, int BKT>
cudaError_t launch_t(const Args& a, int warpgroups, cudaStream_t st) {
  if (a.D <= 64)
    return warpgroups == 1 ? launch<T, 64, 1, BKT>(a, st) : launch<T, 64, 2, BKT>(a, st);
  return warpgroups == 1 ? launch<T, 128, 1, BKT>(a, st) : launch<T, 128, 2, BKT>(a, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window. The plan (from
// plan_tiles): P positions per consumer warpgroup with P * (H/Hkv) <= 64,
// `warpgroups` consumer warpgroups per CTA (1 or 2), n_tiles packed tiles
// covering [0, S), block_k kv rows per K/V tile (64; f32 also 32, bf16 128). q, k, v
// and o are contiguous and 16-byte aligned, and D is a multiple of 8 up to
// 128. Returns the CUDA error code of the launch (0 on success).
// Asynchronous on `stream`.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int Hkv, int D, int causal, int window,
                                   int dtype, int P, int warpgroups, int n_tiles, int block_k,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_G || D <= 0 ||
      D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1) || P < 1 ||
      P * (H / Hkv) > ROWS || (warpgroups != 1 && warpgroups != 2) || n_tiles < 1 ||
      n_tiles > 65535 || (long long)n_tiles * warpgroups * P < S ||
      (long long)(n_tiles - 1) * warpgroups * P >= S ||
      !(block_k == BK || block_k == (dtype == 1 ? 2 * BK : BK / 2)))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, S, H, Hkv, D, causal, window, P, n_tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = block_k == BK ? launch_t<float, BK>(a, warpgroups, st)
                        : launch_t<float, BK / 2>(a, warpgroups, st);
  else
    err = block_k == BK ? launch_t<__nv_bfloat16, BK>(a, warpgroups, st)
                        : launch_t<__nv_bfloat16, 2 * BK>(a, warpgroups, st);
  return (int)err;
}
