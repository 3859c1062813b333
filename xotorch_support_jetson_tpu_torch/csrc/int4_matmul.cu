// K4 — packed-int4 weight matmul for Hopper (sm_90a): y = (x @ unpack(w)) * scale.
//
// Replaces the TPU kernel `_int4_kernel` / `int4_matmul`
// (xotorch_support_jetson_tpu/ops/pallas_int4.py:36, :71; pallas_call at :102).
// Semantics are the same: x [T,in] bf16 or f32, w [in/2,out] int8 holding two
// sign-extended 4-bit codes per byte (in-row 2r in the low nibble, 2r+1 in
// the high), a per-output-channel f32 scale [out]; y[t,f] = (sum_d x[t,d] *
// unpack(w)[d,f]) * scale[f], summed in f32 and written in x's dtype. f32 x is
// rounded to bf16 for the tensor cores, as the TPU kernel rounds it for the
// matrix unit (pallas_int4.py:50-51); y is then f32, with no final rounding.
//
// What bounds it on the H100. At decode (T = 1..8) memory: each packed byte
// feeds 2*T multiply-adds, far below the ~295 flop/byte where the tensor cores
// would bound it; the bound is the packed weight (0.5 byte/param) plus scales,
// x and y over 3.35 TB/s, and at these sizes (0.5-8 MB for a layer) launch
// latency and the few dependent memory round trips of a short stream. At
// prefill (T >= 64) the bf16 tensor-core operations bound it.
//
// Design: every product runs on the tensor cores, weights on the M side
// ("swap AB"): output channels are M, tokens N, in-channels K. An A register
// of mma.sync m16n8k16 (and of wgmma with A in registers, whose per-warp
// fragment is the same) holds two consecutive k of one row, here in-rows 2r
// and 2r+1 of one output channel: exactly one packed byte, so the stored
// layout needs no repacking. The M order inside a warp is permuted so that
// the bytes a lane needs are adjacent in a packed row (one 8-byte shared load
// for mma.sync, 2 for wgmma); the epilogue undoes the permutation. A byte
// becomes a bf16 pair in registers: flipping each nibble's sign bit gives
// v + 8 in [0, 15], put by byte permutes into the mantissa of bf16 128.0
// (0x4300) that is 136 + v, and one bf16x2 subtract of 136 leaves v exactly
// (|v| <= 8): about three instructions a pair. x, row-major [T, in], is the B operand as it
// lies (K-major). Which instruction at which T (the token tile is picked by
// ops/int4_matmul.py plan from measurements):
//   T <= 8    mma.sync, 64 channels x 8 tokens, 4 warps on the in-axis;
//   T > 8     mma.sync, 64 x 32 (4 warps on the in-axis), B by ldmatrix.x4;
//   long products past T = 32 (>= 2^30 multiply-adds) with bf16 x on
//             16-byte-aligned rows: 128 x 128 tiles, wgmma m64n128k16 (two
//             warpgroups of 64 channels, A from registers, B from the x tile
//             in the 128-byte swizzle). f32 or unaligned x keeps the 64 x 32
//             mma.sync tile at any T.
//
// Packed weight tiles and x tiles stream through a 4-stage ring in shared
// memory by cp.async (16-byte copies, zero-filled past T, in and out), so
// three stages stay in flight while the tensor cores work on the fourth; at
// T = 128 each packed byte is read once per block that covers all 128 rows.
// Small decode shapes cannot fill 132 SMs with output tiles (wk/wv: 512
// channels, 8 tiles), so the in-axis is split across the blocks of a
// thread-block cluster (up to 16): each block sums its range in shared
// memory, and after a cluster barrier each block reads its share of the tile
// from every peer's shared memory (distributed shared memory), sums it,
// applies the scale and writes y. One launch per product, no partial sums in
// device memory. Ragged T, out and in are masked; when out or in breaks the
// 16-byte alignment of cp.async the tiles are loaded element by element.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 4;    // depth of the cp.async ring
constexpr int kWPad = 32;     // bytes after each packed row of a weight tile: rows an odd multiple of 32 bytes apart, conflict-free reads
constexpr int kXPad = 8;      // elements after each token row of an x tile: conflict-free pair reads
constexpr int kMaxSplit = 16; // largest cluster (16 is non-portable; the H100 runs it)

// A launch geometry: BN tokens per block, BK packed rows (2*BK in-channels)
// per stage, MIN_BLOCKS per SM for __launch_bounds__ (without it ptxas holds
// the decode tile to 64 registers and spills). mma.sync: WK warps split the
// k16 steps of a stage, each over all 64 channels of the block (4 m16 tiles;
// a lane reads 8 consecutive bytes of a packed row) and all BN tokens.
// wgmma: two warpgroups of 64 channels each, 128 x 128.
template <int BN_, int WK_, int BK_, int MIN_BLOCKS_, bool WG_ = false>
struct Cfg {
  static constexpr int BN = BN_, WK = WK_, BK = BK_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool WG = WG_;
  static constexpr int BM = WG ? 128 : 64;
  static constexpr int NT = BN / 8;     // n8 tiles per warp
  static constexpr int kThreads = WG ? 256 : 32 * WK;
  static constexpr int kSteps = BK / 8;  // k16 steps per stage (8 packed rows each)
  static_assert(kSteps % WK == 0, "whole k16 steps per warp");
  static_assert(!WG || (BK == 32 && BN == 128 && WK == 1), "wgmma: 128-byte x rows, m64n128k16");
};
using CfgDecode = Cfg<8, 4, 64, 4>;          // T <= 8: 64 channels x 8 tokens, 4 warps on the in-axis
using CfgNarrow = Cfg<32, 4, 64, 4>;         // 64 x 32
using CfgWgmma = Cfg<128, 1, 32, 1, true>;  // 128 x 128, 2 warpgroups of 64 channels (aligned bf16 x)

// A ring slot holds the stage's weight tile (BK packed rows, kWRow bytes
// apart) and x tile (BN token rows). For wgmma the x tile comes first, in the
// 128-byte-swizzled K-major layout the B descriptor names (token rows of 128
// bytes, 16-byte chunk j of row t at chunk j ^ (t % 8), 1024-byte aligned).
template <class C, class XT>
struct Smem {
  static constexpr int kWRow = C::BM + kWPad;              // bytes: an odd multiple of 32
  static constexpr int kWStage = C::BK * kWRow;
  static constexpr int kXRow = C::WG ? 2 * C::BK : 2 * C::BK + kXPad;  // elements
  static constexpr int kXStage = C::BN * kXRow * (int)sizeof(XT);
  static constexpr int kWOff = C::WG ? kXStage : 0, kXOff = C::WG ? 0 : kWStage;
  static constexpr int kAlign = C::WG ? 1024 : 16;
  static constexpr int kStage = (kWStage + kXStage + kAlign - 1) / kAlign * kAlign;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kTile = C::BN * C::BM;              // f32 sums of one block
  static constexpr int kRed = C::WK * kTile * 4;
  static constexpr int kBytes = (kRing > kRed ? kRing : kRed) + (C::WG ? kAlign : 0);  // slack to align the base
  static_assert(kWStage % 16 == 0 && kStage % 16 == 0 && (kXRow * sizeof(XT)) % 16 == 0, "16-byte cp.async targets");
  static_assert(!C::WG || (sizeof(XT) == 2 && kXRow * 2 == 128), "wgmma: bf16 x in 128-byte rows");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 packed bytes of `w` as 4 bf16 pairs, pair j = (low nibble, high
// nibble) of byte j = (in-row 2r, 2r+1) in the (low, high) halves of an A
// register. Each nibble's sign bit is flipped (v + 8 in [0, 15]) and the
// nibbles are spread one per byte; two byte permutes put each in the mantissa
// of bf16 128.0 (high byte 0x43): 136 + v, and one bf16x2 subtract leaves v.
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t (&p)[4]) {
  const uint32_t lo = (w ^ 0x08080808u) & 0x0F0F0F0Fu;         // low nibbles, flipped, one per byte
  const uint32_t hi = ((w >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;  // high nibbles
  const uint32_t m01 = __byte_perm(lo, hi, 0x5140u);           // lo0 hi0 lo1 hi1
  const uint32_t m23 = __byte_perm(lo, hi, 0x7362u);           // lo2 hi2 lo3 hi3
  const uint32_t q[4] = {__byte_perm(m01, 0x43434343u, 0x4140u), __byte_perm(m01, 0x43434343u, 0x4342u),
                         __byte_perm(m23, 0x43434343u, 0x4140u), __byte_perm(m23, 0x43434343u, 0x4342u)};
  const uint32_t off = 0x43084308u;  // (136, 136)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&q[j]), *reinterpret_cast<const __nv_bfloat162*>(&off));
    p[j] = *reinterpret_cast<uint32_t*>(&r);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& d0, uint32_t& d1, uint32_t& d2, uint32_t& d3, const void* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
               : "r"(a)
               : "memory");
}

// wgmma B operand: a K-major tile in the 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO), start address in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// d[64 x 128] += a[64 x 16] (registers, this warp's 16 rows) . B[16 x 128] (shared memory).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Two consecutive in-channels of one token as a bf16 pair (B register).
__device__ __forceinline__ uint32_t x_pair(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }
__device__ __forceinline__ uint32_t x_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  __nv_bfloat162 r = __floats2bfloat162_rn(v.x, v.y);  // round to nearest even, as the TPU kernel's cast
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void store_y(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }
__device__ __forceinline__ void store_y(float* y, float v) { *y = v; }

// Stage `kt` (packed rows kt*BK ...) of the weight and x into ring slot `st`.
template <class C, class XT, bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* st, const XT* __restrict__ x, const int8_t* __restrict__ w,
                                           int T, int K, int N, int n0, int m0, int kt) {
  using S = Smem<C, XT>;
  const int r0 = kt * C::BK, in = 2 * K;
  unsigned char* ws = st + S::kWOff;
  XT* xs = reinterpret_cast<XT*>(st + S::kXOff);
  if constexpr (VEC) {
    constexpr int kWPer = C::BM / 16;
    for (int c = threadIdx.x; c < C::BK * kWPer; c += C::kThreads) {
      const int r = c / kWPer, j = c % kWPer, gr = r0 + r, gc = m0 + 16 * j;
      const bool ok = gr < K && gc < N;  // out % 16 == 0: a chunk is whole or absent
      cp_async16(ws + r * S::kWRow + 16 * j, ok ? (const void*)(w + (size_t)gr * N + gc) : (const void*)w, ok ? 16 : 0);
    }
    constexpr int kEl = 16 / (int)sizeof(XT), kXPer = 2 * C::BK / kEl;
    for (int c = threadIdx.x; c < C::BN * kXPer; c += C::kThreads) {
      const int t = c / kXPer, j = c % kXPer, gt = n0 + t, gi = 2 * r0 + kEl * j;
      const bool ok = gt < T && gi < in;  // in * sizeof(x) % 16 == 0: whole or absent
      const int jj = C::WG ? j ^ (t & 7) : j;  // the 128-byte swizzle
      cp_async16(xs + t * S::kXRow + kEl * jj, ok ? (const void*)(x + (size_t)gt * in + gi) : (const void*)x, ok ? 16 : 0);
    }
  } else {
    using Raw = std::conditional_t<sizeof(XT) == 2, uint16_t, uint32_t>;
    for (int c = threadIdx.x; c < C::BK * C::BM; c += C::kThreads) {
      const int r = c / C::BM, j = c % C::BM, gr = r0 + r, gc = m0 + j;
      ws[r * S::kWRow + j] = (gr < K && gc < N) ? (unsigned char)w[(size_t)gr * N + gc] : (unsigned char)0;
    }
    const Raw* xr = reinterpret_cast<const Raw*>(x);
    Raw* xsr = reinterpret_cast<Raw*>(xs);
    for (int c = threadIdx.x; c < C::BN * 2 * C::BK; c += C::kThreads) {
      const int t = c / (2 * C::BK), j = c % (2 * C::BK), gt = n0 + t, gi = 2 * r0 + j;
      xsr[t * S::kXRow + j] = (gt < T && gi < in) ? xr[(size_t)gt * in + gi] : (Raw)0;
    }
  }
}

// The cp.async ring over this block's k-tiles: stage i + kStages - 1 is in
// flight while compute(slot) works on stage i. Returns with the ring free.
template <class C, class XT, bool VEC, class F>
__device__ __forceinline__ void pipeline(unsigned char* base, const XT* __restrict__ x, const int8_t* __restrict__ w, int T,
                                         int K, int N, int n0, int m0, int kt0, int nk, F&& compute) {
  using S = Smem<C, XT>;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<C, XT, VEC>(base + s * S::kStage, x, w, T, K, N, n0, m0, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();  // stage i has landed (this thread's copies) ...
    if constexpr (C::WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... visible to wgmma ...
    __syncthreads();               // ... everyone's, and slot (i - 1) % kStages is free
    const int nxt = i + kStages - 1;
    if (nxt < nk) load_stage<C, XT, VEC>(base + (nxt % kStages) * S::kStage, x, w, T, K, N, n0, m0, kt0 + nxt);
    cp_async_commit();
    compute(base + (i % kStages) * S::kStage);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// grid (split, ceil(out/BM), ceil(T/BN)); clusters of `split` blocks along x,
// block rank r sums k-tiles [r*n/split, (r+1)*n/split) of n = ceil(K/BK).
template <class C, class XT, bool VEC>
__global__ void __launch_bounds__(C::kThreads, C::MIN_BLOCKS)
int4_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                   XT* __restrict__ y, int T, int K, int N, int split) {
  using S = Smem<C, XT>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = smem;
  if constexpr (C::WG) base += (S::kAlign - (uint32_t)__cvta_generic_to_shared(smem) % S::kAlign) % S::kAlign;
  constexpr int BM = C::BM;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * C::BN;
  const int rank = blockIdx.x;  // == this_cluster().block_rank(): the cluster spans grid x
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  const int n_kt = (K + C::BK - 1) / C::BK;
  const int kt0 = (int)((long long)rank * n_kt / split), kt1 = (int)((long long)(rank + 1) * n_kt / split);
  float* red = reinterpret_cast<float*>(base);  // the block's sums, red[wk][token][channel], once the ring is free

  if constexpr (C::WG) {
    // Warp w of warpgroup wg owns channels ch0 .. ch0 + 15: M rows g and g + 8
    // are channels ch0 + 2g and ch0 + 2g + 1, so a lane's two bytes of a
    // packed row are adjacent.
    const int ch0 = warp / 4 * 64 + warp % 4 * 16;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    pipeline<C, XT, VEC>(base, x, w, T, K, N, n0, m0, kt0, kt1 - kt0, [&](const unsigned char* st) {
      const unsigned char* wr = st + S::kWOff + tig * S::kWRow + ch0 + 2 * g;
      const uint32_t xs = (uint32_t)__cvta_generic_to_shared(st + S::kXOff);
      uint32_t a[C::kSteps][4];
#pragma unroll
      for (int s = 0; s < C::kSteps; ++s) {
        // Bytes: (packed row 8s + tig, channels ch0 + 2g, + 1), (row 8s + tig + 4, same channels).
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(wr + 8 * s * S::kWRow);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(wr + (8 * s + 4) * S::kWRow);
        unpack4(lo | hi << 16, a[s]);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C::kSteps; ++s) wgmma_m64n128k16(d, a[s], desc_sw128(xs + 32 * s));  // in-channels 16s .. 16s + 15
      wgmma_commit();
      wgmma_wait0();  // the slot and a[] are reused after this
    });
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int ch = ch0 + 2 * g, t = 8 * i + 2 * tig;  // d[4i + e]: row g / g + 8 (e / 2), token t + e % 2
      float* r = red + t * BM + ch;
      *reinterpret_cast<float2*>(r) = make_float2(d[4 * i], d[4 * i + 2]);
      *reinterpret_cast<float2*>(r + BM) = make_float2(d[4 * i + 1], d[4 * i + 3]);
    }
  } else {
    constexpr int MT = 4;  // m16 tiles per warp: the block's 64 channels
    const int wk = warp;
    float acc[MT][C::NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    pipeline<C, XT, VEC>(base, x, w, T, K, N, n0, m0, kt0, kt1 - kt0, [&](const unsigned char* st) {
      const unsigned char* ws = st + S::kWOff;
      const XT* xs = reinterpret_cast<const XT*>(st + S::kXOff);
#pragma unroll
      for (int s = 0; s < C::kSteps / C::WK; ++s) {
        const int pr = (s * C::WK + wk) * 8;  // first packed row of this k16 step
        // The lane's 8 bytes of packed rows pr + tig and pr + tig + 4: byte j
        // is channel 8g + j, row g (j even) or g + 8 (j odd) of m16 tile j/2.
        const unsigned char* wr = ws + (pr + tig) * S::kWRow + 8 * g;
        const uint2 l = *reinterpret_cast<const uint2*>(wr), h = *reinterpret_cast<const uint2*>(wr + 4 * S::kWRow);
        const uint32_t lo[2] = {l.x, l.y}, hi[2] = {h.x, h.y};
        uint32_t a[MT][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t pl[4], ph[4];
          unpack4(lo[q], pl);
          unpack4(hi[q], ph);
          a[2 * q][0] = pl[0]; a[2 * q][1] = pl[1]; a[2 * q][2] = ph[0]; a[2 * q][3] = ph[1];
          a[2 * q + 1][0] = pl[2]; a[2 * q + 1][1] = pl[3]; a[2 * q + 1][2] = ph[2]; a[2 * q + 1][3] = ph[3];
        }
        uint32_t b[C::NT][2];
        const XT* xw = xs + 2 * pr;
        if constexpr (sizeof(XT) == 2 && C::NT % 2 == 0) {
          // ldmatrix.x4: lanes 8j..8j+7 address the 8 token rows of matrix j =
          // (n8 tile 2p + j/2, in-channels 0-7 or 8-15 of the step by j%2).
#pragma unroll
          for (int p = 0; p < C::NT / 2; ++p)
            ldmatrix_x4(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0], b[2 * p + 1][1],
                        xw + ((2 * p + lane / 16) * 8 + lane % 8) * S::kXRow + (lane / 8 % 2) * 8);
        } else {
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt) {
            const XT* xr = xw + (nt * 8 + g) * S::kXRow + 2 * tig;
            b[nt][0] = x_pair(xr);
            b[nt][1] = x_pair(xr + 8);
          }
        }
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
    });
    // Each warp's sums into red[wk][token][channel], channels back in order.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int ch = 8 * g + 2 * mt, t = nt * 8 + 2 * tig;
        float* r = red + (wk * C::BN + t) * BM + ch;
        *reinterpret_cast<float2*>(r) = make_float2(acc[mt][nt][0], acc[mt][nt][2]);       // channels ch, ch + 1 of token t
        *reinterpret_cast<float2*>(r + BM) = make_float2(acc[mt][nt][1], acc[mt][nt][3]);  // ... of token t + 1
      }
  }
  __syncthreads();
  float4* red4 = reinterpret_cast<float4*>(red);
  constexpr int kTile4 = S::kTile / 4;
  if constexpr (C::WK > 1) {
    for (int i = threadIdx.x; i < kTile4; i += C::kThreads) {
      float4 s = red4[i];
#pragma unroll
      for (int q = 1; q < C::WK; ++q) {
        const float4 v = red4[q * kTile4 + i];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      red4[i] = s;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();  // every block's sums are in its shared memory
  else
    __syncthreads();

  // Block `rank` finishes its share of the tile from every peer's sums, four
  // channels at a time, summed in rank order; four peers' loads are in
  // flight at once, so the remote latencies overlap.
  const int per = (kTile4 + split - 1) / split;
  const int e1 = min(kTile4, (rank + 1) * per);
  for (int i = rank * per + (int)threadIdx.x; i < e1; i += C::kThreads) {
    const int t = n0 + 4 * i / BM, c = m0 + 4 * i % BM;
    if (t >= T || c >= N) continue;
    float4 s = red4[i];
    if (split > 1) {
      s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q0 = 0; q0 < split; q0 += 4) {
        float4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q0 + j < split) v[j] = cluster.map_shared_rank(red4, q0 + j)[i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q0 + j < split) { s.x += v[j].x; s.y += v[j].y; s.z += v[j].z; s.w += v[j].w; }
      }
    }
    XT* yr = y + (size_t)t * N + c;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < N) store_y(yr + e, sv[e] * scale[c + e]);
  }
  if (split > 1) cluster.sync();  // peers keep their shared memory until every read is done
}

template <class C, class XT, bool VEC>
int launch(const void* x, const void* w, const void* scale, void* y, int T, int K, int N, int split, cudaStream_t st) {
  using S = Smem<C, XT>;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(int4_matmul_kernel<C, XT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(int4_matmul_kernel<C, XT, VEC>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(split, (N + C::BM - 1) / C::BM, (T + C::BN - 1) / C::BN);
  lc.blockDim = dim3(C::kThreads);
  lc.dynamicSmemBytes = S::kBytes;
  lc.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  lc.attrs = at;
  lc.numAttrs = split > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&lc, int4_matmul_kernel<C, XT, VEC>, static_cast<const XT*>(x), static_cast<const int8_t*>(w),
                                     static_cast<const float*>(scale), static_cast<XT*>(y), T, K, N, split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class C, class XT>
int launch_vec(bool vec, const void* x, const void* w, const void* scale, void* y, int T, int K, int N, int split, cudaStream_t st) {
  if (vec) return launch<C, XT, true>(x, w, scale, y, T, K, N, split, st);
  return launch<C, XT, false>(x, w, scale, y, T, K, N, split, st);
}

template <class XT>
int launch_cfg(int cfg, bool vec, const void* x, const void* w, const void* scale, void* y, int T, int K, int N, int split,
               cudaStream_t st) {
  if (cfg == 0) return launch_vec<CfgDecode, XT>(vec, x, w, scale, y, T, K, N, split, st);
  if (cfg == 1) return launch_vec<CfgNarrow, XT>(vec, x, w, scale, y, T, K, N, split, st);
  if constexpr (std::is_same_v<XT, __nv_bfloat16>)
    if (vec) return launch<CfgWgmma, XT, true>(x, w, scale, y, T, K, N, split, st);
  return (int)cudaErrorInvalidValue;  // the wide tile takes aligned bf16 x only
}

}  // namespace

// C interface (bound with ctypes). x [T, 2K] bf16 (x_f32 = 0) or f32 (1);
// w int8 [K, N] packed codes; scale f32 [N]; y [T, N] in x's dtype. `cfg`
// picks the token tile (0: 8, 1: 32, 2: 128 tokens per block; 2 takes bf16
// x with 16-byte-aligned rows only) and `split` (1..16) the blocks of a
// cluster that share the in-axis. Returns the launch's cudaError_t.
extern "C" int xot_int4_matmul(const void* x, const void* w, const void* scale, void* y, int T, int K, int N, int x_f32,
                               int cfg, int split, void* stream) {
  if (T < 0 || K <= 0 || N <= 0 || cfg < 0 || cfg > 2 || split < 1 || split > kMaxSplit) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t xsize = x_f32 ? 4 : 2;
  const bool vec = N % 16 == 0 && (2 * (size_t)K * xsize) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_f32) return launch_cfg<float>(cfg, vec, x, w, scale, y, T, K, N, split, st);
  return launch_cfg<__nv_bfloat16>(cfg, vec, x, w, scale, y, T, K, N, split, st);
}
