// K1 — causal flash-attention prefill for Hopper (sm_90a), bf16 or int8 KV.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_prefill`
// (xotorch_support_jetson_tpu/ops/pallas_attention.py:32, :106). Semantics
// are the same: query row i of batch row b sits at absolute position
// q_offset[b] + i and attends cache slots j <= that position; q head h reads
// kv head h / group; scale 1/sqrt(hd); online softmax in f32. With int8 KV
// the k scale multiplies score columns and the v scale folds into p after
// the denominator update. Slots past a row's position (stale cache junk)
// and past Skv are masked by position, so ragged Sq and Skv edges are masked
// here and no tile-size gate applies.
//
// What bounds it on the H100. A long prompt is bound by the tensor cores:
// causal attention at Sq 4096 (Hq 32, hd 64) is 69 GFLOP, 0.07 ms at 989
// TFLOP/s, against 10 MB of q, k, v and out. At hd 64 the exponentials (one
// per 256 tensor-core operations, on a unit with 1/256 of their rate) cost as
// much as the products, so both have to run at once. A short prompt (Sq 128)
// is bound by fixed cost: the launch, the first loads, one tile per block.
//
// Design:
// - wgmma for both products. A block holds one producer warpgroup and two or
//   three consumer warpgroups (ops/kernels.py prefill_plan: three at hd 64
//   once such a grid covers the card more than once); each consumer owns 64
//   query rows, the `group` q heads sharing one kv head times 64/group
//   positions, so every K/V tile is read once for 128 or 192 rows. S = Q·Kᵀ
//   is wgmma m64nBKk16 with Q and K in shared memory, both K-major; O += P·V
//   takes P from registers (the S accumulator re-packed to bf16) and V from
//   shared memory through wgmma's transposed B read. Shared tiles are
//   64-column pieces in the 128-byte swizzle the TMA writes, and the
//   descriptors name that swizzle.
// - An asynchronous K/V ring. One thread of the producer warpgroup (which
//   gives its registers to the consumers with setmaxnreg) keeps 2-4 stages
//   in flight by TMA over 4-D tensor maps of q, k and v (encoded on the host
//   per call), on full/empty mbarriers: the consumers never meet a block-wide
//   barrier in the loop. Q's fetch is issued first and overlaps the first
//   K/V tiles. int8 codes arrive by TMA into a raw ring and the producer
//   warpgroup widens them to bf16 in shared memory with byte permutes (codes
//   exact in bf16); their scales come with them and are applied in f32.
// - Products under softmax. Each consumer issues tile t's S with tile t-1's
//   P·V, and runs tile t's softmax while that P·V is in flight (the loop has
//   no branch, so ptxas keeps the wgmmas asynchronous); the consumers take
//   turns to issue (named barriers), so one's softmax runs under another's
//   products.
// - Causality at tile grain. Tiles past a consumer's causal horizon are
//   neither loaded nor computed; tiles wholly below its diagonal skip the
//   mask, which runs only on diagonal tiles and at the ragged Skv edge. The
//   grid hands out the last (heaviest) q tiles first.
// - Softmax in the wgmma accumulator layout: base-2 exponentials with
//   log2(e) folded into one FFMA, one rescale per tile, and a guard for rows
//   that have seen no unmasked slot (padding rows, the reference's
//   new_m <= NEG_INF/2 case).
// - For a short prompt: one launch, no scratch, Q and the first K/V tiles
//   fetched together, and two consumers per block so more SMs share the work.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsWG = 64;  // query rows per consumer warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Launch geometry per head dim and KV type (mirrored by ops/kernels.py
// prefill_plan): consumer warpgroups, kv slots per tile, bf16 stages in the
// ring, raw int8 stages, and the registers setmaxnreg gives each role (the
// block's 64K split between one producer and the consumers).
template <int HD, bool QUANT, int NC>
struct Cfg {
  static_assert(NC == 2 || (NC == 3 && HD == 64), "three consumers only where their registers allow (hd 64)");
  static constexpr int kConsumers = NC;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 232;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "registers");
  static constexpr int BK = HD == 256 ? 64 : 128;
  static constexpr int kStages = HD == 256 ? 2 : HD == 128 ? (QUANT ? 2 : 3) : (QUANT ? 3 : 4);
  static constexpr int kRaw = QUANT ? (HD == 64 ? 2 : 1) : 0;
  static constexpr int kPieces = HD / 64;                // 64-column (128-byte) pieces of a row
  static constexpr int kTile = BK * 128;                 // one [BK][64] bf16 piece
  static constexpr int kQPiece = kRowsWG * 128;          // one consumer's [64][64] Q piece
  static constexpr int kQBytes = kConsumers * kPieces * kQPiece;
  static constexpr int kStageBytes = 2 * kPieces * kTile;  // K pieces, then V pieces
  static constexpr int kRawBytes = 2 * BK * HD;            // int8 K codes, then V codes
  static constexpr int kScaleBytes = QUANT ? 2 * BK * 4 : 0;  // k scales, then v scales
  static constexpr int kStageOff = kQBytes;
  static constexpr int kRawOff = kStageOff + kStages * kStageBytes;
  static constexpr int kScaleOff = kRawOff + kRaw * kRawBytes;
  static constexpr int kBarOff = kScaleOff + kStages * kScaleBytes;
  static constexpr int kSmem = 1024 + kBarOff + 256;  // 1024: alignment slack for the swizzled tiles
  static_assert(kSmem <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of parity `parity` to complete. A wait that lasts
// seconds can only be a broken protocol: trap (the launch fails) rather
// than hang the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (4ll << 30)) __trap();
  }
}
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma operand descriptors, 128-byte swizzle (layout type 1), start address
// in 16-byte units. K-major (Q and K as A and B of Q·Kᵀ): 128-byte rows, 8-row
// groups 1024 bytes apart (SBO); a k16 step moves the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_k(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// MN-major (V as the transposed B of P·V): 64-column pieces `piece` bytes
// apart (LBO), 8-slot groups 1024 bytes apart (SBO); a k16 step (16 slots)
// moves the start by 2048 bytes.
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr, uint32_t piece) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(piece >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an in-flight wgmma reads or writes: no access may move across
// this point (the wgmma's own operands end at its issue, not at its wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64], B MN-major in shared memory (transposed read, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 128] += A[64 x 16] (registers) . B[16 x 128], B MN-major in shared memory (transposed read, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 256] += A[64 x 16] (registers) . B[16 x 256], B MN-major in shared memory (transposed read, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 codes as four exact bf16 (two words): each code + 128 is put by a
// byte permute into the mantissa of the float 2^23, and 2^23 + 128 is taken
// off (K3's core widens its codes the same way). The results are small
// integers, exact in bf16, so the low halves of the floats are zero and a
// second byte permute packs the high halves: no conversion instruction.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541u)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542u)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543u)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u), __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632u));
}

struct Params {
  const float* k_scale;  // [B,Skv,Hkv] f32 (int8 KV), else null
  const float* v_scale;
  const int* q_offset;   // [B]
  __nv_bfloat16* out;    // [B,Sq,Hq,hd]
  int B, Sq, Skv, Hq, Hkv, group, bq, n_qt;
  float scale_log2;      // log2(e) / sqrt(hd)
};

// Grid: one block per (q tile, kv head, batch row), the last q tile first
// (ops/kernels.py prefill_item mirrors this order). A q tile is NC·bq
// positions: consumer c holds positions [c·bq, (c+1)·bq) of it, its row r
// being (position r / group, head r % group).
template <int HD, bool QUANT, int NC>
__global__ void __launch_bounds__(Cfg<HD, QUANT, NC>::kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<HD, QUANT, NC>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const uint32_t sbase = smem_u32(base);
  const uint32_t bars = sbase + C::kBarOff;
  const uint32_t q_bar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + C::kStages + s); };
  auto raw_full = [&](int s) { return bars + 8 * (1 + 2 * C::kStages + s); };

  const int per_qt = p.Hkv * p.B;
  const int qt = p.n_qt - 1 - (int)blockIdx.x / per_qt;
  const int b = ((int)blockIdx.x % per_qt) / p.Hkv, g = (int)blockIdx.x % p.Hkv;
  const int off = __shfl_sync(0xffffffff, p.q_offset[b], 0);
  const int s_first = qt * C::kConsumers * p.bq;
  const int n_kv = (p.Skv + BK - 1) / BK;
  // Tiles a consumer whose first position is s0 needs: up to the last
  // position it holds, and no further than Skv.
  auto tiles_for = [&](int s0) {
    if (s0 >= p.Sq) return 0;
    const int horizon = off + min(s0 + p.bq, p.Sq) - 1;
    return min(n_kv, horizon / BK + 1);
  };
  int n_tiles = 0;  // the block's: its last consumer that holds a position
  for (int c = 0; c < C::kConsumers; ++c) n_tiles = max(n_tiles, tiles_for(s_first + c * p.bq));
  const int used = p.bq * p.group;  // rows of a consumer's 64 that the Q box fills

  if (threadIdx.x == 0) {
    bar_init(q_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      bar_init(full(s), QUANT ? 128 : 1);
      bar_init(empty(s), 128 * C::kConsumers);
    }
    for (int s = 0; s < C::kRaw; ++s) bar_init(raw_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Rows the Q box leaves unwritten (64 % group != 0): zero, so that they
  // stay finite in tiles that skip the mask. They are never stored.
  for (int i = threadIdx.x; i < C::kConsumers * C::kPieces * (kRowsWG - used) * 8; i += C::kThreads) {
    const int piece = i / ((kRowsWG - used) * 8), r = used + i / 8 % (kRowsWG - used), c = i % 8;
    *reinterpret_cast<uint4*>(base + piece * C::kQPiece + r * 128 + c * 16) = make_uint4(0, 0, 0, 0);
  }
  fence_async_shared();
  __syncthreads();

  // Warp-uniform by construction (a shuffle of lane 0's value): ptxas then
  // knows each role's path is taken by whole warpgroups and keeps wgmma async.
  const int wg = __shfl_sync(0xffffffff, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int tid = threadIdx.x;
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
      bar_expect_tx(q_bar, C::kConsumers * C::kPieces * used * 128);
      for (int c = 0; c < C::kConsumers; ++c)
        for (int pc = 0; pc < C::kPieces; ++pc)
          tma_load(sbase + (c * C::kPieces + pc) * C::kQPiece, &tq, q_bar, 64 * pc, g * p.group, s_first + c * p.bq, b);
    }
    if constexpr (!QUANT) {
      if (tid == 0) {
        for (int t = 0; t < n_tiles; ++t) {
          const int s = t % C::kStages;
          bar_wait(empty(s), ((t / C::kStages) & 1) ^ 1);
          bar_expect_tx(full(s), C::kStageBytes);
          const uint32_t st = sbase + C::kStageOff + s * C::kStageBytes;
          for (int pc = 0; pc < C::kPieces; ++pc) {
            tma_load(st + pc * C::kTile, &tk, full(s), 64 * pc, g, t * BK, b);
            tma_load(st + (C::kPieces + pc) * C::kTile, &tv, full(s), 64 * pc, g, t * BK, b);
          }
        }
      }
    } else {
      // int8: codes by TMA into the raw ring, widened here into the bf16 ring.
      auto fetch_raw = [&](int t) {
        const int r = t % C::kRaw;
        const uint32_t dst = sbase + C::kRawOff + r * C::kRawBytes;
        bar_expect_tx(raw_full(r), C::kRawBytes);
        tma_load(dst, &tk, raw_full(r), 0, g, t * BK, b);
        tma_load(dst + BK * HD, &tv, raw_full(r), 0, g, t * BK, b);
      };
      if (tid == 0)
        for (int t = 0; t < min(C::kRaw, n_tiles); ++t) fetch_raw(t);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kStages, r = t % C::kRaw;
        const int slot = t * BK + tid;
        float ksv = 0.f, vsv = 0.f;
        if (tid < BK && slot < p.Skv) {
          ksv = p.k_scale[((size_t)b * p.Skv + slot) * p.Hkv + g];
          vsv = p.v_scale[((size_t)b * p.Skv + slot) * p.Hkv + g];
        }
        bar_wait(raw_full(r), (t / C::kRaw) & 1);
        bar_wait(empty(s), ((t / C::kStages) & 1) ^ 1);
        const unsigned char* raw = base + C::kRawOff + r * C::kRawBytes;
        unsigned char* st = base + C::kStageOff + s * C::kStageBytes;
        constexpr int kPerRow = HD / 16, kPerSide = BK * kPerRow;
#pragma unroll 4
        for (int i = tid; i < 2 * kPerSide; i += 128) {
          const int side = i / kPerSide, j = i % kPerSide / kPerRow, cc = i % kPerRow;
          const uint4 w = *reinterpret_cast<const uint4*>(raw + side * BK * HD + j * HD + cc * 16);
          const uint2 a = widen4(w.x), bb = widen4(w.y), c2 = widen4(w.z), d2 = widen4(w.w);
          // Columns 16cc .. 16cc + 15: piece cc / 4, 16-byte chunks 2(cc % 4) and +1, swizzled by the row.
          unsigned char* row = st + (side * C::kPieces + cc / 4) * C::kTile + j * 128;
          const int q0 = 2 * (cc % 4);
          *reinterpret_cast<uint4*>(row + ((q0 ^ (j & 7)) * 16)) = make_uint4(a.x, a.y, bb.x, bb.y);
          *reinterpret_cast<uint4*>(row + (((q0 + 1) ^ (j & 7)) * 16)) = make_uint4(c2.x, c2.y, d2.x, d2.y);
        }
        if (tid < BK) {
          float* sc = reinterpret_cast<float*>(base + C::kScaleOff + s * C::kScaleBytes);
          sc[tid] = ksv;
          sc[BK + tid] = vsv;
        }
        fence_async_shared();  // the widened tile is read by wgmma (the async proxy)
        bar_arrive(full(s));
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // every thread is done with raw slot r
        if (tid == 0 && t + C::kRaw < n_tiles) {
          fence_async_shared();
          fetch_raw(t + C::kRaw);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int c = wg - 1;
    const int ltid = threadIdx.x % 128, warp = ltid / 32, lane = ltid % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int s_wg = s_first + c * p.bq;
    const int my_tiles = tiles_for(s_wg);
    // This thread's two rows: gid and gid + 8 of the warp's 16.
    int qpos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gid + 8 * h;
      const int i = r / p.group, s = s_wg + i;
      qpos[h] = (r < used && s < p.Sq) ? off + s : -1;  // -1: padding row, fully masked
    }
    const int min_pos = off + s_wg;  // the first valid row's position
    const uint32_t q_base = sbase + c * C::kPieces * C::kQPiece;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_row[2] = {kNegInf, kNegInf};  // running row max of the (k-scaled) raw scores
    float l_part[2] = {0.f, 0.f};         // this thread's share of the denominators
    float alpha[2] = {1.f, 1.f};           // rescale of o due before the next P·V
    float sacc[BK / 2];                    // S of the current tile, then its probabilities
    uint32_t pa[BK / 16][4];               // P as bf16 A fragments of the P·V product

    auto stage_addr = [&](int t) { return sbase + C::kStageOff + (t % C::kStages) * C::kStageBytes; };
    auto scales = [&](int t) { return reinterpret_cast<const float*>(base + C::kScaleOff + (t % C::kStages) * C::kScaleBytes); };
    auto issue_s = [&](int t) {  // S_t = Q·K_tᵀ
      const uint32_t st = stage_addr(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t koff = 32 * (kk % 4);  // k16 step kk: bytes 32(kk % 4) of piece kk / 4
        wgmma_ss(sacc, desc_k(q_base + (kk / 4) * C::kQPiece + koff), desc_k(st + (kk / 4) * C::kTile + koff), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int t) {  // o = alpha·o + P_t·V_t
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      const uint32_t vt = stage_addr(t) + C::kPieces * C::kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(o, pa[kk], desc_mn(vt + kk * 2048, C::kTile));
      wgmma_commit();
    };
    // Tile t's scores (landed in sacc) → probabilities in sacc; updates the
    // row max, the denominators and alpha.
    auto softmax = [&](int t) {
      const int slot0 = t * BK;
      if constexpr (QUANT) {  // k scale per column
        const float* ks = scales(t);
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          const float2 ksc = *reinterpret_cast<const float2*>(ks + 8 * i + 2 * tig);
          sacc[4 * i] *= ksc.x, sacc[4 * i + 1] *= ksc.y, sacc[4 * i + 2] *= ksc.x, sacc[4 * i + 3] *= ksc.y;
        }
      }
      // Mask only where the tile is not wholly below this warpgroup's
      // diagonal: column c of row h is live while c <= lim[h] (its position
      // and Skv both bound it).
      if (!(slot0 + BK - 1 <= min_pos && slot0 + BK <= p.Skv)) {
        int lim[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) lim[h] = min(qpos[h], p.Skv - 1) - slot0 - 2 * tig;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * i + (e & 1) > lim[e >> 1]) sacc[4 * i + e] = kNegInf;
      }
      float blk_max[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        blk_max[0] = fmaxf(blk_max[0], fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        blk_max[1] = fmaxf(blk_max[1], fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
      float neg_m[2];
      bool dead[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        blk_max[h] = fmaxf(blk_max[h], __shfl_xor_sync(0xffffffff, blk_max[h], 1));
        blk_max[h] = fmaxf(blk_max[h], __shfl_xor_sync(0xffffffff, blk_max[h], 2));
        const float m_new = fmaxf(m_row[h], blk_max[h]);
        alpha[h] = exp2_approx((m_row[h] - m_new) * p.scale_log2);
        m_row[h] = m_new;
        dead[h] = m_new <= kNegInf * 0.5f;  // no unmasked slot yet: p = 0
        neg_m[h] = dead[h] ? 0.f : -m_new * p.scale_log2;
      }
      // p = 2^((s - m)·scale·log2 e): one FFMA and one exp each (a dead
      // row's scores are all kNegInf, so its p underflow to 0).
      float row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2_approx(fmaf(sacc[4 * i + e], p.scale_log2, neg_m[e >> 1]));
          row_sum[e >> 1] += pe;
          sacc[4 * i + e] = pe;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_part[h] = l_part[h] * alpha[h] + row_sum[h];
    };
    auto pack = [&](int t) {  // sacc → pa (int8: the v scale folds in after the denominator update)
      const float* vs = scales(t) + BK;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        float pv[4] = {sacc[4 * i], sacc[4 * i + 1], sacc[4 * i + 2], sacc[4 * i + 3]};
        if constexpr (QUANT) {
          const float2 vsc = *reinterpret_cast<const float2*>(vs + 8 * i + 2 * tig);
          pv[0] *= vsc.x, pv[1] *= vsc.y, pv[2] *= vsc.x, pv[3] *= vsc.y;
        }
        // A fragment of k16 step i / 2: (row g, cols 2t..), (row g + 8, ...), then cols + 8.
        pa[i / 2][2 * (i % 2)] = pack_bf16(pv[0], pv[1]);
        pa[i / 2][2 * (i % 2) + 1] = pack_bf16(pv[2], pv[3]);
      }
    };

    // Ping-pong: the consumers take turns, in order, to issue their products
    // (consumer c waits on named barrier 2 + c and passes to the next), so
    // one's softmax runs under another's products. Each takes exactly
    // n_tiles + 1 turns, turn t after tile t has landed (idle turns for tiles
    // past its horizon), the first consumer first; the last skips its last
    // pass, so every barrier is met as often as it is waited on.
    const int turns = n_tiles + 1;
    int turn = 0;
    auto take_turn = [&](auto&& issue) {
      asm volatile("bar.sync %0, 256;\n" ::"r"(2 + c) : "memory");
      issue();
      if (!(c == C::kConsumers - 1 && turn == turns - 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 + (c + 1) % C::kConsumers) : "memory");
      ++turn;
    };
    if (c == C::kConsumers - 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(2) : "memory");

    if (my_tiles > 0) {
      bar_wait(q_bar, 0);
      bar_wait(full(0), 0);
      take_turn([&] { issue_s(0); });
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax(0);
      pack(0);
    }
    // Tile t's S is issued with tile t - 1's P·V; tile t's softmax runs while
    // that product is in flight, and tile t - 1's stage is released once it
    // lands.
    for (int t = 1; t < my_tiles; ++t) {
      bar_wait(full(t % C::kStages), (t / C::kStages) & 1);
      take_turn([&] {
        issue_s(t);
        issue_pv(t - 1);
      });
      wgmma_wait<1>();
      fence_regs(sacc);
      softmax(t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      bar_arrive(empty((t - 1) % C::kStages));
      pack(t);
    }
    if (my_tiles > 0) {
      take_turn([&] { issue_pv(my_tiles - 1); });
      wgmma_wait<0>();
      fence_regs(o);
      bar_arrive(empty((my_tiles - 1) % C::kStages));
    }
    // Tiles past this warpgroup's horizon (a later consumer's): released
    // unread, one idle turn each, in step with the other consumers' turns.
    for (int t = my_tiles; t < n_tiles; ++t) {
      bar_wait(full(t % C::kStages), (t / C::kStages) & 1);
      bar_arrive(empty(t % C::kStages));
      take_turn([] {});
    }
    if (my_tiles == 0) take_turn([] {});  // the turn an active consumer spends on its last P·V

    // Finish: full denominators, normalise, store the valid rows.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_part[h];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      if (qpos[h] < 0) continue;
      const int r = warp * 16 + gid + 8 * h;
      const int s = s_wg + r / p.group;
      __nv_bfloat16* orow = p.out + (((size_t)b * p.Sq + s) * p.Hq + g * p.group + r % p.group) * HD + 2 * tig;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map of a contiguous [d3][d2][d1][d0] tensor (d0 innermost), boxes of
// b0 x b1 x b2 x 1; reads past an edge land as zeros.
bool encode4(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr, int d0, int d1, int d2, int d3, int b0,
             int b1, int b2, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * esize, (cuuint64_t)d0 * d1 * esize, (cuuint64_t)d0 * d1 * d2 * esize};
  const cuuint32_t box[4] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool QUANT, int NC>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* q_offset, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int block_k, int stages, int smem, cudaStream_t stream) {
  using C = Cfg<HD, QUANT, NC>;
  if (block_k != C::BK || stages != C::kStages || smem != C::kSmem) return (int)cudaErrorInvalidValue;  // plan and build disagree
  auto kernel = flash_prefill_kernel<HD, QUANT, NC>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  Params p;
  p.k_scale = static_cast<const float*>(ks);
  p.v_scale = static_cast<const float*>(vs);
  p.q_offset = static_cast<const int*>(q_offset);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B, p.Sq = Sq, p.Skv = Skv, p.Hq = Hq, p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.bq = kRowsWG / p.group;
  p.n_qt = (Sq + C::kConsumers * p.bq - 1) / (C::kConsumers * p.bq);
  p.scale_log2 = kLog2e / sqrtf((float)HD);
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType kv_type = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle kv_swizzle = QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const int kv_box0 = QUANT ? HD : 64;
  if (!encode4(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, HD, Hq, Sq, B, 64, p.group, p.bq, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode4(&tk, kv_type, QUANT ? 1 : 2, k, HD, Hkv, Skv, B, kv_box0, 1, C::BK, kv_swizzle) ||
      !encode4(&tv, kv_type, QUANT ? 1 : 2, v, HD, Hkv, Skv, B, kv_box0, 1, C::BK, kv_swizzle))
    return (int)cudaErrorInvalidValue;
  kernel<<<p.n_qt * Hkv * B, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). q/out bf16 [B,Sq,Hq,hd]; k/v bf16 or int8
// [B,Skv,Hkv,hd]; k_scale/v_scale f32 [B,Skv,Hkv,1] (int8 only, else null);
// q_offset int32 [B]. All contiguous, 16-byte aligned, on the current
// device. block_k, stages and smem are ops/kernels.py prefill_plan's, checked
// against the build. Returns the launch's cudaGetLastError() (non-zero: the
// kernel did not run).
extern "C" int xot_flash_prefill(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                                 const void* q_offset, void* out, int B, int Sq, int Skv, int Hq, int Hkv, int hd, int quantized,
                                 int consumers, int block_k, int stages, int smem, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRowsWG || Skv <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XOT_CASE(HD, NC)                                                                                                         \
  if (hd == HD && consumers == NC)                                                                                              \
    return quantized ? launch<HD, true, NC>(q, k, v, k_scale, v_scale, q_offset, out, B, Sq, Skv, Hq, Hkv, block_k, stages, smem, st) \
                     : launch<HD, false, NC>(q, k, v, k_scale, v_scale, q_offset, out, B, Sq, Skv, Hq, Hkv, block_k, stages, smem, st);
  XOT_CASE(64, 2)
  XOT_CASE(64, 3)
  XOT_CASE(128, 2)
  XOT_CASE(256, 2)
#undef XOT_CASE
  return (int)cudaErrorInvalidValue;
}
