// K1 — causal flash-attention prefill for Hopper (sm_90a), bf16 or int8 KV.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_prefill`
// (xotorch_support_jetson_tpu/ops/pallas_attention.py:32, :106). Semantics
// are the same: query row i of batch row b sits at absolute position
// q_offset[b] + i and attends cache slots j <= that position; q head h reads
// kv head h / group; scale 1/sqrt(hd); online softmax in f32. With int8 KV
// the k scale multiplies score columns and the v scale folds into p after
// the denominator update. Slots past a row's position (stale cache junk)
// and past Skv are masked by position, so no tile-size gate applies:
// ragged Sq and Skv edges are masked here.
//
// What bounds it on the H100: at the serving shapes (Sq 128..512, hd 64,
// group 4) the work is small matrix products, so the bound is the tensor
// cores (989 TFLOP/s bf16) for long prompts and launch/latency for short
// ones; the K/V stream is read once per block from L2.
//
// Design: one block per (q tile, kv head, batch row). Its 64 query rows are
// the `group` q heads that share the kv head times 64/group positions, so
// each K/V tile is loaded into shared memory ONCE for all of them. Four
// warps each own 16 rows and run mma.sync m16n8k16 (bf16 in, f32 out) for
// S = Q·Kᵀ and O += P·V; the S accumulators are re-packed in registers as
// the A operand of P·V (no round trip through shared memory), and the
// per-row max/denominator live in registers (quad shuffles). The KV loop
// stops at the tile's causal horizon: tiles past it are neither loaded nor
// computed (the TPU version still streamed their DMA). int8 codes are
// exact in bf16, so the quantized variant (a template flag) converts codes
// while staging the tile and applies the scales in f32.
//
// A simple first kernel: plain loads (no cp.async/TMA pipeline, no wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;             // kv slots per tile
constexpr int kPad = 8;             // bf16 row padding: conflict-free fragment loads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Stage kBK rows of one kv head into shared memory as bf16 [kBK][HD + kPad];
// rows past Skv are zero (they are masked by position as well).
template <int HD, bool QUANT>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst, const void* src, const float* scale_src, float* scale_dst,
                                             int b, int g, int slot0, int Skv, int Hkv) {
  constexpr int LD = HD + kPad;
  if constexpr (!QUANT) {
    const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(src);
    constexpr int CH = HD / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < kBK * CH; idx += blockDim.x) {
      const int j = idx / CH, c = idx % CH;
      const int slot = slot0 + j;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (slot < Skv) val = *reinterpret_cast<const uint4*>(s + ((size_t)(b * Skv + slot) * Hkv + g) * HD + c * 8);
      *reinterpret_cast<uint4*>(dst + j * LD + c * 8) = val;
    }
  } else {
    const int8_t* s = static_cast<const int8_t*>(src);
    constexpr int CH = HD / 16;  // 16 codes per 16-byte load
    for (int idx = threadIdx.x; idx < kBK * CH; idx += blockDim.x) {
      const int j = idx / CH, c = idx % CH;
      const int slot = slot0 + j;
      int4 raw = make_int4(0, 0, 0, 0);
      if (slot < Skv) raw = *reinterpret_cast<const int4*>(s + ((size_t)(b * Skv + slot) * Hkv + g) * HD + c * 16);
      const int8_t* codes = reinterpret_cast<const int8_t*>(&raw);
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = pack2((float)codes[2 * e], (float)codes[2 * e + 1]);  // exact in bf16
      *reinterpret_cast<uint4*>(dst + j * LD + c * 16) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + j * LD + c * 16 + 8) = make_uint4(w[4], w[5], w[6], w[7]);
    }
    for (int j = threadIdx.x; j < kBK; j += blockDim.x) {
      const int slot = slot0 + j;
      scale_dst[j] = slot < Skv ? scale_src[(size_t)(b * Skv + slot) * Hkv + g] : 0.f;
    }
  }
}

template <int HD, bool QUANT>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
                     const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ q_offset,
                     __nv_bfloat16* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int group, int bq, float scale) {
  constexpr int LD = HD + kPad;
  constexpr int NT_S = kBK / 8;  // n-tiles of the score tile
  constexpr int NT_O = HD / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kRows * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;
  float* ks_s = reinterpret_cast<float*>(Vs + kBK * LD);
  float* vs_s = ks_s + kBK;

  const int qt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int off = q_offset[b];
  const int s_first = qt * bq;

  // Stage Q: block row r = (position i = r / group, head h = r % group).
  for (int idx = threadIdx.x; idx < kRows * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8), c = idx % (HD / 8);
    const int i = r / group, s = s_first + i;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (i < bq && s < Sq) val = *reinterpret_cast<const uint4*>(q + ((size_t)(b * Sq + s) * Hq + g * group + r % group) * HD + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * LD + c * 8) = val;
  }

  // This thread's two rows (gid and gid + 8 of the warp's 16).
  int qpos[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + gid + half * 8;
    const int i = r / group, s = s_first + i;
    qpos[half] = (i < bq && s < Sq) ? off + s : -1;  // -1: padding row, fully masked
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // per-thread partial denominators (quad-reduced at the end)

  // Causal horizon of the tile: the last position any of its rows holds.
  const int horizon = off + min(s_first + bq, Sq) - 1;
  const int n_tiles = horizon < 0 ? 0 : min((Skv + kBK - 1) / kBK, horizon / kBK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int slot0 = t * kBK;
    __syncthreads();  // previous tile fully consumed (and Q staged, on t == 0)
    load_kv_tile<HD, QUANT>(Ks, k, k_scale, ks_s, b, g, slot0, Skv, Hkv);
    load_kv_tile<HD, QUANT>(Vs, v, v_scale, vs_s, b, g, slot0, Skv, Hkv);
    __syncthreads();

    // S = Q·Kᵀ for the warp's 16 rows × kBK slots.
    float s_acc[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s_acc[n][0] = s_acc[n][1] = s_acc[n][2] = s_acc[n][3] = 0.f;
    const __nv_bfloat16* qrow = Qs + (warp * 16 + gid) * LD + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qrow + kk * 16);
      a[1] = *reinterpret_cast<const uint32_t*>(qrow + 8 * LD + kk * 16);
      a[2] = *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qrow + 8 * LD + kk * 16 + 8);
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const __nv_bfloat16* krow = Ks + (n * 8 + gid) * LD + kk * 16 + 2 * tig;
        mma16816(s_acc[n], a, *reinterpret_cast<const uint32_t*>(krow), *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }

    // Scale, dequantize, mask; tile row max.
    float blk_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tig + (e & 1);
        const int slot = slot0 + col;
        float sv = s_acc[n][e] * scale;
        if constexpr (QUANT) sv *= ks_s[col];
        sv = (slot <= qpos[e >> 1] && slot < Skv) ? sv : kNegInf;
        s_acc[n][e] = sv;
        blk_max[e >> 1] = fmaxf(blk_max[e >> 1], sv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      blk_max[half] = fmaxf(blk_max[half], __shfl_xor_sync(0xffffffff, blk_max[half], 1));
      blk_max[half] = fmaxf(blk_max[half], __shfl_xor_sync(0xffffffff, blk_max[half], 2));
      const float m_new = fmaxf(m_row[half], blk_max[half]);
      alpha[half] = __expf(m_row[half] - m_new);
      m_row[half] = m_new;
    }
    // p = exp(s - m_new) (0 while the row has seen no unmasked slot).
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const float p = m_row[half] <= kNegInf * 0.5f ? 0.f : __expf(s_acc[n][e] - m_row[half]);
        row_sum[half] += p;
        float pv = p;
        if constexpr (QUANT) pv *= vs_s[n * 8 + 2 * tig + (e & 1)];  // v scale folds in after the l update
        s_acc[n][e] = pv;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l_part[half] = l_part[half] * alpha[half] + row_sum[half];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P·V: the score accumulators re-packed as the A operand.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2(s_acc[2 * kk][0], s_acc[2 * kk][1]);
      a[1] = pack2(s_acc[2 * kk][2], s_acc[2 * kk][3]);
      a[2] = pack2(s_acc[2 * kk + 1][0], s_acc[2 * kk + 1][1]);
      a[3] = pack2(s_acc[2 * kk + 1][2], s_acc[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * tig) * LD + gid;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vp = v0 + n * 8;
        const uint32_t b0 = pack2_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack2_raw(vp[8 * LD], vp[9 * LD]);
        mma16816(o[n], a, b0, b1);
      }
    }
  }

  // Finish: full denominators, normalise, store the valid rows.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_part[half];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    if (qpos[half] < 0) continue;
    const int r = warp * 16 + gid + half * 8;
    const int s = s_first + r / group;
    __nv_bfloat16* orow = out + ((size_t)(b * Sq + s) * Hq + g * group + r % group) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
  }
}

template <int HD, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* q_offset, void* out,
           int B, int Sq, int Skv, int Hq, int Hkv, cudaStream_t stream) {
  constexpr int LD = HD + kPad;
  const size_t smem = (size_t)(kRows + 2 * kBK) * LD * sizeof(__nv_bfloat16) + 2 * kBK * sizeof(float);
  auto kernel = flash_prefill_kernel<HD, QUANT>;
  static bool smem_set = false;  // above 48 KB (hd 128/256) only after this opt-in
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int group = Hq / Hkv;
  const int bq = kRows / group;
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(q_offset), static_cast<__nv_bfloat16*>(out), Sq, Skv, Hq, Hkv, group, bq, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). q/out bf16 [B,Sq,Hq,hd]; k/v bf16 or int8
// [B,Skv,Hkv,hd]; k_scale/v_scale f32 [B,Skv,Hkv,1] (int8 only, else null);
// q_offset int32 [B]. All contiguous, on the current device. Returns the
// launch's cudaGetLastError() (non-zero: the kernel did not run).
extern "C" int xot_flash_prefill(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                                 const void* q_offset, void* out, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                                 int quantized, void* stream) {
  if (Hq % Hkv != 0 || Hq / Hkv > kRows) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XOT_CASE(HD)                                                                               \
  if (hd == HD) return quantized ? launch<HD, true>(q, k, v, k_scale, v_scale, q_offset, out, B, Sq, Skv, Hq, Hkv, st) \
                                 : launch<HD, false>(q, k, v, k_scale, v_scale, q_offset, out, B, Sq, Skv, Hq, Hkv, st);
  XOT_CASE(64)
  XOT_CASE(128)
  XOT_CASE(256)
#undef XOT_CASE
  return (int)cudaErrorInvalidValue;
}
