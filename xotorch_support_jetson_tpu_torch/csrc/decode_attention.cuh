// The device core of K2 (flash_decode.cu) and K3 (paged_decode.cu): one-query
// decode attention for Hopper (sm_90a), one launch per call. The two kernels
// differ only in how a slot of the KV window becomes a row address (a dense
// slot cache, or a page through the block table) and in the code type of
// the rows (bf16, int8, packed int4); both are template arguments here.
//
// What bounds it on the H100: memory. A call reads every live K/V slot once
// and does about 4 flops per K/V element, far below the ~295 flop/byte at
// which the tensor cores would bound it; the bound is those bytes over
// 3.35 TB/s. At a 4k context that is 8.4 MB in ~2.5 us (B=1), so what
// matters is keeping enough loads in flight (Little's law: ~2.3 MB across the
// card, ~18 KB per SM), keeping the few warps an SM holds at B=1 busy, and
// not paying for a second kernel.
//
// Design. The blocks that share one (batch row, kv head) form a thread-block
// cluster along the KV axis (grid x = cluster size, up to 16; the host picks
// it and the per-block slot range from the window and the card's SM count).
// Each block of 16 warps (8 at hd 128, 4 at hd 256, for their registers):
//   * stages the block table entries of its range once (paged), before it
//     knows the row's length;
//   * cuts its live range into octets of 8 slots, dealt to its warps in
//     turn. Every warp streams its own octets through its own ring of
//     shared-memory stages (4 to 16 octets deep, about 128 KB per block: at
//     bf16 hd 64, 4 octets of 2 KB per warp, two in flight while two are
//     used) by 16-byte cp.async.cg copies, zero-filled past the row's
//     length, so junk slots and table entries are never read. Warps never
//     wait for each other inside the loop. Rows land XOR-swizzled in 16-byte
//     chunks, so the reads below hit distinct banks;
//   * scores each octet for all the q heads of the kv head (up to 8, the whole
//     GQA group, so K/V bytes are read once) with mma.sync m16n8k16: q (bf16,
//     held in registers) is A, its rows the heads; the octet's K rows are B
//     as they lie (ldmatrix for bf16; int8 codes and int4 nibbles widened to
//     bf16 pairs in registers, exactly); the products sum in f32, and the k
//     scale and log2(e)/sqrt(hd) multiply the score (softmax in base 2);
//   * runs the online softmax per head over two octets on the score fragments
//     itself: one max and one exp per score, two shuffles each for the max
//     and the sum; the running max moves only when a score passes it by
//     more than 8, so the sums are rescaled rarely; p takes the v scale
//     after the denominator update;
//   * does P.V with mma.sync m16n8k16 (k = 16 slots: a warp takes two
//     octets a step) straight from those registers: p (f32) is split into a
//     bf16 high part (A row g) and the bf16 rounding of the remainder (row
//     g + 8, otherwise a padding row), so p keeps ~16 bits and every product
//     sums in f32; V rows are B by transposed ldmatrix.
//     int8 and int4 codes of K and V are widened to bf16 pairs exactly by
//     byte permutes and adds (the conversion unit, a quarter of the rate,
//     is left to the exps);
//   * merges its warps' partials into the block's (m, l, acc) and writes it
//     straight into the shared memory of the cluster's first block through
//     distributed shared memory (after a barrier every block arrived at when
//     it started, so the target exists). After one more cluster barrier the
//     other blocks are done and the first block merges the cluster's
//     partials and writes the output.
// No partials go to device memory and there is no merge kernel. Blocks whose
// range lies past their row's length load nothing but reach both barriers.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xot_decode {

namespace cg = cooperative_groups;

constexpr int kOctet = 8;        // slots a warp takes at a time: the n of one mma
constexpr int kMaxHeads = 8;     // q heads per block (a kv head's group is split in eights): A rows 0-7
// 16 is a non-portable cluster size; the H100 runs it. The host's plan picks
// at most 8 (ops/kernels.py MAX_CLUSTER): 16 is taken only so that
// scripts/attn_sweep.py can time it beside the others.
constexpr int kMaxCluster = 16;
constexpr float kNegInf = -1e30f;
constexpr float kSlack = 8.f;    // how far a score (base 2) may pass the running max before the max moves

enum KvKind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

template <int HD, int KIND>
struct Geom {
  // Warps of a block: as many as the registers of one block per SM allow.
  static constexpr int kWarps = HD == 64 ? 16 : HD == 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowBytes = KIND == kBf16 ? 2 * HD : KIND == kInt8 ? HD : HD / 2;
  static constexpr int kCpr = kRowBytes / 16;  // 16-byte chunks per row
  static constexpr int kKsteps = HD / 16;      // k16 steps of a score
  static constexpr bool kScales = KIND != kBf16;
  static constexpr int kKv = kOctet * kRowBytes;  // bytes of an octet's K (or V) rows
  static constexpr int kStage = 2 * kKv + (kScales ? 2 * kOctet * 4 : 0);
  // Depth of a warp's ring: about 128 KB of rings per block, an even number
  // of octets from 4 to 16 (a step takes two).
  static constexpr int kDepth = 131072 / (kWarps * kStage) / 2 * 2;
  static constexpr int kStages = kDepth < 4 ? 4 : kDepth > 16 ? 16 : kDepth;
  static constexpr int kNtiles = HD / 8;  // 8-channel n-tiles of the P.V product
  // Shared memory: the warps' rings (after the loop: the warps' partial
  // sums) | warps' m, l | peer weights | the cluster's partials, one per
  // block (rank 0's is read) | block table (both sized at launch).
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kWarpAcc = kWarps * kMaxHeads * HD * 4;
  static constexpr int kWmOff = kRing > kWarpAcc ? kRing : kWarpAcc;
  static constexpr int kWtsOff = kWmOff + 2 * kWarps * kMaxHeads * 4;
  static constexpr int kPartOff = kWtsOff + kMaxCluster * kMaxHeads * 4;
  static constexpr int kPart = kMaxHeads * (HD + 2);  // floats of a block's partial: acc [8][hd], m [8], l [8]
  static constexpr int kMaxBytes = 232448;            // all a block may have; the launch checks what it asks
  static_assert(kRowBytes % 16 == 0 && HD % 64 == 0 && kKsteps % 2 == 0, "geometry");
  static_assert(kStage % 16 == 0 && kWmOff % 16 == 0, "16-byte aligned regions");
};

// Chunk c of slot s in an octet, XOR-swizzled: within each aligned group of 8
// chunks (128 bytes) the low three bits are XORed with the slot (rows of 128
// bytes or more) or with the group index (shorter rows), so chunk c of the 8
// slots lies in 8 distinct chunks of the bank cycle (one ldmatrix phase, or
// one quarter-warp of loads).
template <int CPR>
__device__ __forceinline__ int swz(int s, int c) {
  const int idx = s * CPR + c;
  return idx ^ ((CPR >= 8 ? s : idx >> 3) & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t& d0, uint32_t& d1, uint32_t& d2, uint32_t& d3, const void* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& d0, uint32_t& d1, uint32_t& d2, uint32_t& d3, const void* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
               : "r"(a)
               : "memory");
}

// 2^x (the scores are in base 2: the host folds log2(e) into the scale).
__device__ __forceinline__ float exp2f_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Split cluster barrier: arrive (release) now, wait (acquire) later.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// D += A * B, m16n8k16, bf16 operands, f32 sums.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two int8 codes in the low 16 bits of x as a bf16 pair, exactly, on
// the FMA pipe: code + 128 in the mantissa of 2^23, minus 2^23 + 128.
__device__ __forceinline__ uint32_t i8pair(uint32_t x) {
  const uint32_t u = x ^ 0x8080u;
  const float f0 = __uint_as_float(0x4B000000u | (u & 0xFFu)) - 8388736.f;
  const float f1 = __uint_as_float(0x4B000000u | (u >> 8 & 0xFFu)) - 8388736.f;
  return bf16x2(f0, f1);
}

// The 4 bytes of w as 4 bf16 pairs, pair j = (low nibble, high nibble) of
// byte j, sign-extended, exactly: each nibble's sign bit is flipped (v + 8 in
// [0, 15]) and put by byte permutes into the mantissa of bf16 128.0, giving
// 136 + v, and one bf16x2 subtract leaves v (csrc/int4_matmul.cu unpack4).
__device__ __forceinline__ void i4pairs(uint32_t w, uint32_t* p) {
  const uint32_t lo = (w ^ 0x08080808u) & 0x0F0F0F0Fu;
  const uint32_t hi = ((w >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
  const uint32_t m01 = __byte_perm(lo, hi, 0x5140u);  // lo0 hi0 lo1 hi1
  const uint32_t m23 = __byte_perm(lo, hi, 0x7362u);  // lo2 hi2 lo3 hi3
  const uint32_t q[4] = {__byte_perm(m01, 0x43434343u, 0x4140u), __byte_perm(m01, 0x43434343u, 0x4342u),
                         __byte_perm(m23, 0x43434343u, 0x4140u), __byte_perm(m23, 0x43434343u, 0x4342u)};
  const uint32_t off = 0x43084308u;  // (136, 136)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&q[j]), *reinterpret_cast<const __nv_bfloat162*>(&off));
    p[j] = *reinterpret_cast<const uint32_t*>(&r);
  }
}

// Byte `sel` (0-3) of each of w0..w3, as the bytes of one word.
__device__ __forceinline__ uint32_t gather4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, uint32_t sel) {
  const uint32_t s2 = sel | (sel + 4) << 4;
  return __byte_perm(__byte_perm(w0, w1, s2), __byte_perm(w2, w3, s2), 0x5410u);
}

// Chunk c (4 words) of row s of an octet of code rows.
template <int CPR>
__device__ __forceinline__ uint4 row_chunk(const unsigned char* tile, int s, int c) {
  return *reinterpret_cast<const uint4*>(tile + swz<CPR>(s, c) * 16);
}

// The B fragments of every k16 step for an octet of int8 or int4 K rows:
// lane (g, t) = (slot lane / 4, pair lane % 4) holds channels (16kk + 2t,
// +1) in b[kk][0] and (16kk + 8 + 2t, +1) in b[kk][1] of slot g as bf16
// pairs, widened exactly. (bf16 rows go by ldmatrix in the caller.)
template <int KIND, int HD>
__device__ __forceinline__ void k_frags(const unsigned char* kt, int lane, uint32_t (&b)[HD / 16][2]) {
  constexpr int CPR = (KIND == kInt8 ? HD : HD / 2) / 16;
  const int g = lane / 4, t = lane % 4;
  if constexpr (KIND == kInt8) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const unsigned char* ch = kt + swz<CPR>(g, kk) * 16;
      b[kk][0] = i8pair(*reinterpret_cast<const uint16_t*>(ch + 2 * t));
      b[kk][1] = i8pair(*reinterpret_cast<const uint16_t*>(ch + 8 + 2 * t));
    }
  } else {
    // Channels 16kk + 2t, +1 are byte t of word 2kk of the row, and
    // 16kk + 8 + 2t, +1 byte t of word 2kk + 1: one chunk (4 words) gives
    // two k16 steps.
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      const uint4 w = row_chunk<CPR>(kt, g, c);
      uint32_t p[4];
      i4pairs(gather4(w.x, w.y, w.z, w.w, t), p);
      b[2 * c][0] = p[0];
      b[2 * c][1] = p[1];
      b[2 * c + 1][0] = p[2];
      b[2 * c + 1][1] = p[3];
    }
  }
}

// The B fragments of every 8-channel n-tile for an octet of int8 or int4 V
// rows: lane (g, t) holds channel 8n + g of slots 2t and 2t + 1 in v[n] as a
// bf16 pair, widened exactly.
template <int KIND, int HD>
__device__ __forceinline__ void v_frags(const unsigned char* vt, int lane, uint32_t (&v)[HD / 8]) {
  constexpr int CPR = (KIND == kInt8 ? HD : HD / 2) / 16;
  const int g = lane / 4, s = 2 * (lane % 4);
  if constexpr (KIND == kInt8) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int ch = 8 * n + g, o = ch % 16;
      const uint32_t x0 = vt[swz<CPR>(s, ch / 16) * 16 + o], x1 = vt[swz<CPR>(s + 1, ch / 16) * 16 + o];
      v[n] = i8pair(x0 | x1 << 8);
    }
  } else {
    // Channel 8n + g is nibble g % 2 of byte g / 2 of word n of the row:
    // per chunk (4 words, 4 n-tiles) gather that byte from both slots, keep
    // the nibble and pair slot 2t (low) with 2t + 1 (high) in one byte.
    const uint32_t sh = 4 * (g % 2);
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      const uint4 a = row_chunk<CPR>(vt, s, c), d = row_chunk<CPR>(vt, s + 1, c);
      const uint32_t lo = (gather4(a.x, a.y, a.z, a.w, g / 2) >> sh) & 0x0F0F0F0Fu;
      const uint32_t hi = (gather4(d.x, d.y, d.z, d.w, g / 2) >> sh) & 0x0F0F0F0Fu;
      i4pairs(lo | hi << 4, &v[4 * c]);
    }
  }
}

// The address functions. rows() gives a cursor at one slot of a (row, kv
// head); cursor(s) is the pool row of the slot s after it, and advance(d)
// moves it d slots on.
//
// K2's: the dense slot cache [B, Skv, Hkv, hd], up to
// pos[b] inclusive. Row indices fit 32 bits (a row is at least 32 bytes, and
// 2^32 rows would be 128 GB).
struct DenseSlots {
  const int* pos;
  int Skv, Hkv;
  __device__ int length(int b) const {
    const int p = pos[b];
    return p < 0 ? 0 : min(p + 1, Skv);
  }
  __device__ int window() const { return Skv; }
  __device__ void stage_table(int*, int, int, int) const {}
  struct Rows {  // a cursor at slot j of kv head g of row b
    unsigned base;
    int Hkv, j;
    __device__ unsigned operator()(int s) const { return base + (unsigned)(j + s) * Hkv; }  // slot j + s
    __device__ void advance(int d) { j += d; }
  };
  __device__ Rows rows(int b, int g, const int*, int, int j) const { return {(unsigned)b * Skv * Hkv + g, Hkv, j}; }
};

// K3's address function: slot j of row b is offset j % ps of page
// bt[b, j / ps] in the pool [P, Hkv, ps, kd]. A block stages the table
// entries of its range once, without waiting for the row's length; entries
// past the length are staged but never used as addresses.
struct PagedSlots {
  const int* bt;
  const int* lengths;
  int Hkv, ps, mp;
  __device__ int length(int b) const { return max(0, min(lengths[b], mp * ps)); }
  __device__ int window() const { return mp * ps; }
  __device__ void stage_table(int* table, int b, int start, int stop) const {
    const int first = start / ps, n = (stop - 1) / ps - first + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) table[i] = bt[(size_t)b * mp + first + i];
  }
  struct Rows {  // a cursor at offset o of staged page p: no division after the first
    const int* table;
    int ps, Hkv, g, p, o;
    __device__ unsigned operator()(int s) const {  // slot cursor + s, s < 8
      int q = p, r = o + s;
      while (r >= ps) {  // at most once for pages of 8 slots or more
        r -= ps;
        ++q;
      }
      return ((unsigned)table[q] * Hkv + g) * ps + r;
    }
    __device__ void advance(int d) {
      for (o += d; o >= ps; o -= ps) ++p;
    }
  };
  __device__ Rows rows(int, int g, const int* table, int start, int j) const {
    return {table, ps, Hkv, g, j / ps - start / ps, j % ps};
  }
};

template <int HD, int KIND, class Slots>
__global__ void __launch_bounds__(Geom<HD, KIND>::kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const unsigned char* __restrict__ kc,
                        const unsigned char* __restrict__ vc, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, __nv_bfloat16* __restrict__ out, Slots slots, int Hq, int group,
                        int n_sub, int range, float scale) {
  using G = Geom<HD, KIND>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int csize = gridDim.x, rank = blockIdx.x;  // the cluster spans grid x
  float* part = reinterpret_cast<float*>(smem + G::kPartOff);  // [csize][kPart]
  int* table = reinterpret_cast<int*>(part + csize * G::kPart);
  if (csize > 1) cluster_arrive();  // this block has started: peers may write its shared memory after their wait
  const int kvh = blockIdx.y / n_sub, sub = blockIdx.y % n_sub, b = blockIdx.z;
  const int h0 = kvh * group + sub * kMaxHeads, nh = min(kMaxHeads, group - sub * kMaxHeads);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int start = rank * range, stop = min(start + range, slots.window());
  if (start < stop) slots.stage_table(table, b, start, stop);
  const int end = min(stop, slots.length(b));
  const int n_oct = end > start ? (end - start + kOctet - 1) / kOctet : 0;
  const int my_n = warp < n_oct ? (n_oct - 1 - warp) / G::kWarps + 1 : 0;  // octets warp, warp + kWarps, ...
  unsigned char* ring = smem + warp * G::kStages * G::kStage;
  __syncthreads();  // the table

  // The warp's i-th octet into stage i % kStages, for i = 0, 1, 2, ... in
  // turn (the row cursor steps); slots at or past `end` are zero-filled
  // without a read. Every call commits a group (empty past the last
  // octet), so the wait below counts stages.
  auto rows = slots.rows(b, kvh, table, start, start + warp * kOctet);  // at the warp's first octet; issue() steps it
  constexpr int kChunks = kOctet * G::kCpr, kPer = (kChunks + 31) / 32;  // 16-byte chunks of an octet's rows, per lane
  auto issue = [&](int i) {
    if (i < (my_n + 1) / 2 * 2) {  // an odd last octet's partner: zero-filled (no live slot)
      unsigned char* st = ring + (i % G::kStages) * G::kStage;
      const int j0 = start + (warp + i * G::kWarps) * kOctet;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int x = lane + 32 * u, s = x / G::kCpr, c = x % G::kCpr;
        if (kChunks % 32 == 0 || x < kChunks) {
          const bool live = j0 + s < end;
          const size_t off = (size_t)(live ? rows(s) : 0u) * G::kRowBytes + c * 16;
          const int o = swz<G::kCpr>(s, c) * 16;
          cp_async16(st + o, kc + off, live ? 16 : 0);
          cp_async16(st + G::kKv + o, vc + off, live ? 16 : 0);
        }
      }
      if constexpr (G::kScales) {
        if (lane < 2 * kOctet) {  // lanes 0-7 the k scales, 8-15 the v scales
          const bool live = j0 + lane % kOctet < end;
          const size_t r = live ? rows(lane % kOctet) : 0u;
          cp_async4(reinterpret_cast<float*>(st + 2 * G::kKv) + lane, (lane < kOctet ? ksc : vsc) + r, live ? 4 : 0);
        }
      }
      rows.advance(G::kWarps * kOctet);  // to the warp's next octet
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < G::kStages - 2; ++i) issue(i);

  // q as the A operand, rows = heads (rows 8-15 zero): a0 = (head g,
  // channels 16kk + 2t, +1), a2 = (head g, channels 16kk + 8 + 2t, +1).
  uint32_t qa[G::kKsteps][2];
#pragma unroll
  for (int kk = 0; kk < G::kKsteps; ++kk) {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + ((size_t)b * Hq + h0 + g) * HD + 16 * kk + 2 * t);
    qa[kk][0] = g < nh ? qr[0] : 0u;
    qa[kk][1] = g < nh ? qr[4] : 0u;
  }

  float m = kNegInf, l = 0.f;  // online softmax state of head g (lanes 4g..4g+3 hold copies)
  // P.V sums, the C fragments of mma m16n8k16 per 8-channel n-tile: row g
  // (o[n][0..1]) sums the bf16 high part of p, row g + 8 (o[n][2..3]) the
  // low part; their sum is the head's output at channels 8n + 2t, +1.
  float o[G::kNtiles][4];
#pragma unroll
  for (int n = 0; n < G::kNtiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // A step takes two octets (stages 2i, 2i + 1: the ring depth is even), 16
  // slots, while the next steps' octets are in flight.
  for (int i = 0; 2 * i < my_n; ++i) {
    issue(2 * i + G::kStages - 2);
    issue(2 * i + G::kStages - 1);
    cp_async_wait<G::kStages - 2>();
    __syncwarp();  // every lane's copies of octets 2i and 2i + 1 have landed
    const unsigned char* kt[2] = {ring + (2 * i % G::kStages) * G::kStage, ring + ((2 * i + 1) % G::kStages) * G::kStage};

    // Scores: D[head g][slot 2t, 2t + 1] of q (16 x hd) times K^T (hd x 8),
    // per octet u.
    float x[2][2];
    bool live[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (KIND == kBf16) {
#pragma unroll
        for (int kk = 0; kk < G::kKsteps; kk += 2) {
          // Matrices (step kk: channels 0-7, 8-15; step kk + 1: ...) = chunks
          // 2kk .. 2kk + 3 of the 8 rows; lane 8j + r addresses row r of matrix j.
          uint32_t r0, r1, r2, r3;
          ldmatrix_x4(r0, r1, r2, r3, kt[u] + swz<G::kCpr>(lane % 8, 2 * kk + lane / 8) * 16);
          mma16816(c, qa[kk][0], 0u, qa[kk][1], 0u, r0, r1);
          mma16816(c, qa[kk + 1][0], 0u, qa[kk + 1][1], 0u, r2, r3);
        }
      } else {
        uint32_t kb[G::kKsteps][2];
        k_frags<KIND, HD>(kt[u], lane, kb);
#pragma unroll
        for (int kk = 0; kk < G::kKsteps; ++kk) mma16816(c, qa[kk][0], 0u, qa[kk][1], 0u, kb[kk][0], kb[kk][1]);
      }
      const float* ks_t = reinterpret_cast<const float*>(kt[u] + 2 * G::kKv);
      const int j0 = start + (warp + (2 * i + u) * G::kWarps) * kOctet;  // an octet past my_n has no live slot
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        live[u][e] = j0 + 2 * t + e < end;
        x[u][e] = live[u][e] ? c[e] * scale * (G::kScales ? ks_t[2 * t + e] : 1.f) : kNegInf;
      }
    }

    // Online softmax of head g over the 16 slots: lanes 4g..4g+3 hold its scores.
    float mx = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    // The reference max moves only when a score passes it by more than
    // kSlack: p stays below 2^kSlack, and otherwise alpha is 1 and the sums
    // need no rescale (softmax is the same for any reference).
    const float m_new = mx > m + kSlack ? mx : m;
    float p[2][2], sum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[u][e] = live[u][e] ? exp2f_fast(x[u][e] - m_new) : 0.f;
        sum += p[u][e];
      }
    sum += __shfl_xor_sync(0xffffffff, sum, 1);
    sum += __shfl_xor_sync(0xffffffff, sum, 2);
    const float alpha = exp2f_fast(m - m_new);
    m = m_new;
    l = l * alpha + sum;

    // P.V on the tensor cores, k = the 16 slots: A = p of head g, times the
    // v scale, split into a bf16 high part (row g) and the bf16 rounding of
    // the rest (row g + 8), so the products keep ~16 bits of p and sum in
    // f32. a0/a1: octet 0's slots 2t, 2t + 1 (high, low); a2/a3: octet 1's.
    uint32_t a[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* vs_t = reinterpret_cast<const float*>(kt[u] + 2 * G::kKv) + kOctet;
      const float w0 = G::kScales ? p[u][0] * vs_t[2 * t] : p[u][0], w1 = G::kScales ? p[u][1] * vs_t[2 * t + 1] : p[u][1];
      a[u][0] = bf16x2(w0, w1);
      const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[u][0]));
      a[u][1] = bf16x2(w0 - hf.x, w1 - hf.y);
    }
    if (__any_sync(0xffffffff, alpha != 1.f)) {  // the max moved for some head
#pragma unroll
      for (int n = 0; n < G::kNtiles; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[n][r] *= alpha;
    }
    if constexpr (KIND == kBf16) {
#pragma unroll
      for (int n = 0; n < G::kNtiles; n += 2) {
        // Transposed matrices (octet 0, chunk n), (octet 1, chunk n),
        // (octet 0, chunk n + 1), (octet 1, chunk n + 1): lane (g, t) gets
        // V[slot 2t, 2t + 1][channel 8n + g] of each, the B fragments.
        uint32_t r0, r1, r2, r3;
        ldmatrix_x4_trans(r0, r1, r2, r3, (lane & 8 ? kt[1] : kt[0]) + G::kKv + swz<G::kCpr>(lane % 8, n + lane / 16) * 16);
        mma16816(o[n], a[0][0], a[0][1], a[1][0], a[1][1], r0, r1);
        mma16816(o[n + 1], a[0][0], a[0][1], a[1][0], a[1][1], r2, r3);
      }
    } else {
      uint32_t vb[2][G::kNtiles];
      v_frags<KIND, HD>(kt[0] + G::kKv, lane, vb[0]);
      v_frags<KIND, HD>(kt[1] + G::kKv, lane, vb[1]);
#pragma unroll
      for (int n = 0; n < G::kNtiles; ++n) mma16816(o[n], a[0][0], a[0][1], a[1][0], a[1][1], vb[0][n], vb[1][n]);
    }
    __syncwarp();  // the stages are refilled on a later step
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: they take the warps' partial sums

  float* wacc = reinterpret_cast<float*>(smem) + warp * kMaxHeads * HD;
  float* wm = reinterpret_cast<float*>(smem + G::kWmOff);
  float* wl = wm + G::kWarps * kMaxHeads;
  if (g < nh) {
#pragma unroll
    for (int n = 0; n < G::kNtiles; ++n)
      *reinterpret_cast<float2*>(wacc + g * HD + 8 * n + 2 * t) = make_float2(o[n][0] + o[n][2], o[n][1] + o[n][3]);
    if (t == 0) {
      wm[warp * kMaxHeads + g] = m;
      wl[warp * kMaxHeads + g] = l;
    }
  }
  __syncthreads();
  // The block's partial, its warps' partials merged (a block without a live
  // slot gives m = -1e30, l = 0, acc = 0), goes straight into slot `rank` of
  // rank 0's shared memory.
  float* dst = (csize > 1 ? cg::this_cluster().map_shared_rank(part, 0) : part) + rank * G::kPart;
  if (csize > 1) cluster_wait();  // every block of the cluster has started
  for (int e = tid; e < nh * HD; e += G::kThreads) {
    const int h = e / HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < G::kWarps; ++w) M = fmaxf(M, wm[w * kMaxHeads + h]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < G::kWarps; ++w) {
      const float x = exp2f_fast(wm[w * kMaxHeads + h] - M);  // warps without a live slot: 2^(-1e30 - M) = 0
      L += wl[w * kMaxHeads + h] * x;
      A += reinterpret_cast<const float*>(smem)[(w * kMaxHeads + h) * HD + e % HD] * x;
    }
    dst[e] = A;
    if (e % HD == 0) {
      dst[kMaxHeads * HD + h] = M;
      dst[kMaxHeads * HD + kMaxHeads + h] = L;
    }
  }
  if (csize > 1) {
    cluster_arrive();  // release: the partial is written
    cluster_wait();    // rank 0 sees every partial; the other blocks are done
    if (rank != 0) return;
  } else {
    __syncthreads();
  }

  // Rank 0 merges the cluster's partials. Per head (a warp each), lane r <
  // csize takes block r's (m, l): the weights exp(m_r - M) / L.
  float* wts = reinterpret_cast<float*>(smem + G::kWtsOff);  // [block][head]
  for (int h = warp; h < nh; h += G::kWarps) {
    const bool peer = lane < csize;
    const float pm = peer ? part[lane * G::kPart + kMaxHeads * HD + h] : kNegInf;
    const float pl = peer ? part[lane * G::kPart + kMaxHeads * HD + kMaxHeads + h] : 0.f;
    float M = pm;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffff, M, w));
    const float x = peer ? exp2f_fast(pm - M) : 0.f;  // empty blocks: 2^(-1e30 - M) = 0
    float L = pl * x;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) L += __shfl_xor_sync(0xffffffff, L, w);
    if (peer) wts[lane * kMaxHeads + h] = x / (L == 0.f ? 1.f : L);  // no live slot: zeros
  }
  __syncthreads();
  for (int e = tid; e < nh * HD; e += G::kThreads) {
    float A = 0.f;
    for (int r = 0; r < csize; ++r) A += wts[r * kMaxHeads + e / HD] * part[r * G::kPart + e];  // merge: every block's partial
    out[((size_t)b * Hq + h0 + e / HD) * HD + e % HD] = __float2bfloat16(A);
  }
}

// One launch: grid (cluster, Hkv x ceil(group / 8), B), the cluster along x.
// A cluster that cannot be scheduled makes the launch fail; nothing retries.
template <int HD, int KIND, class Slots>
int launch(const void* q, const void* kc, const void* vc, const void* ksc, const void* vsc, void* out, Slots slots,
           int B, int Hq, int Hkv, int window, int cluster, int range, int n_table, cudaStream_t st) {
  using G = Geom<HD, KIND>;
  if (Hkv <= 0 || Hq % Hkv != 0 || cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) || range < 1 ||
      (long long)cluster * range < window || G::kPartOff + (cluster * G::kPart + n_table) * 4 > G::kMaxBytes)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto kernel = decode_attention_kernel<HD, KIND, Slots>;
  static const cudaError_t attr = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kMaxBytes);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int group = Hq / Hkv, n_sub = (group + kMaxHeads - 1) / kMaxHeads;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(cluster, Hkv * n_sub, B);
  lc.blockDim = dim3(G::kThreads);
  lc.dynamicSmemBytes = G::kPartOff + (cluster * G::kPart + n_table) * 4;
  lc.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  lc.attrs = at;
  lc.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&lc, kernel, static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(kc),
                                     static_cast<const unsigned char*>(vc), static_cast<const float*>(ksc),
                                     static_cast<const float*>(vsc), static_cast<__nv_bfloat16*>(out), slots, Hq, group,
                                     n_sub, range, 1.4426950408889634f / sqrtf((float)HD));  // log2(e) / sqrt(hd)
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace xot_decode
