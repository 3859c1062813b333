// K3 — paged decode attention for Hopper (sm_90a): bf16, int8 and packed-int4
// KV pages.
//
// Replaces the TPU kernel `_paged_decode_kernel` / `paged_decode_attention`
// (xotorch_support_jetson_tpu/ops/paged.py:236, :324; pallas_call at :413).
// Semantics are the same: one query per batch row (q [B,Hq,hd]) attends the
// first lengths[b] slots of its logical window, where slot j lives in page
// block_tables[b, j / ps] at offset j % ps of the page pool [P,Hkv,ps,kd];
// q head h reads kv head h / group; scale 1/sqrt(hd); online softmax in f32.
// int8 pools hold codes with per-(slot, head) f32 scales [P,Hkv,ps,1]; int4
// pools hold two codes per byte along hd (channel 2i in the low nibble, 2i+1
// in the high, sign-extended) with the same scales. The k scale multiplies
// the score; the v scale folds into the probability after the denominator
// update. Block-table entries past a row's last valid page may hold
// anything: only entries for slots < lengths[b] are ever read.
//
// What bounds it on the H100: memory. A decode step reads every live K/V
// slot once (2 · len · Hkv · (hd·elem + scale) bytes per row) and does about
// 4 flops per K/V element, far below the ~295 flop/byte at which the tensor
// cores would bound it; the bound is those bytes over 3.35 TB/s.
//
// Design: the TPU kernel walked G-page tiles in order on one core, with the
// block table scalar-prefetched into clamped BlockSpec index maps and q
// de-interleaved outside the kernel for a two-dot int4 product. Here each
// block reads its own row's table entries, one per slot it touches, and the
// logical window is split into chunks of `chunk` slots: one block per
// (chunk, kv head, batch row) reduces its chunk to a partial (m, l, acc) for
// the (up to four) q heads that share the kv head, so K/V bytes are read
// once for all of them, and B=1-8 at a 4k context fills the 132 SMs (B=1:
// 16 chunks x 8 kv heads = 128 blocks). Chunks past a row's length exit
// before any load, so the cost follows the live context. A second small
// kernel merges the chunk partials. Within a block hd/8 lanes cover one slot
// row, each lane owning 8 channels: a 16-byte load for bf16, 8 bytes of
// int8 codes, or 4 bytes of packed int4 that the lane unpacks in registers
// (shift and sign-extend, channel order kept, so q needs no reordering).
// Dot products reduce over those lanes with shuffles. A simple first kernel:
// plain loads, no cp.async/TMA pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kHeads = 4;  // q heads per block (a kv head's group is split in fours)
constexpr float kNegInf = -1e30f;

enum KvKind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// Channels [8*li, 8*li + 8) of pool row `row` (a (page, kv head, offset)
// triple flattened), as f32 codes or values.
template <int HD, int KIND>
__device__ __forceinline__ void load_row8(const void* __restrict__ pool, size_t row, int li, float f[8]) {
  if (KIND == kBf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(pool) + row * HD + li * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
  } else if (KIND == kInt8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(pool) + row * HD + li * 8);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)e[i];
  } else {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(static_cast<const int8_t*>(pool) + row * (HD / 2) + li * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t byte = (raw >> (8 * i)) & 0xffu;
      f[2 * i] = (float)(((int)(byte << 28)) >> 28);      // low nibble, sign-extended
      f[2 * i + 1] = (float)(((int)(byte << 24)) >> 28);  // high nibble, sign-extended
    }
  }
}

template <int HD, int KIND>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool, const void* __restrict__ vpool,
                          const float* __restrict__ kscale, const float* __restrict__ vscale, const int* __restrict__ bt,
                          const int* __restrict__ lengths, float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int Hq, int Hkv, int group, int n_sub, int ps, int mp, int chunk,
                          int n_chunks, float scale) {
  constexpr int LPS = HD / 8;       // lanes per slot row
  constexpr int SPW = 32 / LPS;     // slots per warp step
  constexpr int NG = kWarps * SPW;  // independent slot streams per block
  __shared__ float sm_m[NG][kHeads];
  __shared__ float sm_l[NG][kHeads];
  __shared__ float sm_acc[NG][kHeads][HD];

  const int c = blockIdx.x, g = blockIdx.y / n_sub, sub = blockIdx.y % n_sub, b = blockIdx.z;
  const int len = min(lengths[b], mp * ps);
  const int start = c * chunk;
  if (start >= len) return;  // past the row's length: nothing to read
  const int end = min(start + chunk, len);
  const int h0 = g * group + sub * kHeads;
  const int nh = min(kHeads, group - sub * kHeads);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = lane % LPS;
  const int stream = warp * SPW + lane / LPS;
  const int* row_bt = bt + (size_t)b * mp;

  float qf[kHeads][8];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (hh < nh) raw = *reinterpret_cast<const uint4*>(q + (size_t)(b * Hq + h0 + hh) * HD + li * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[hh][i] = __bfloat162float(e[i]) * scale;
  }

  float m[kHeads], l[kHeads], acc[kHeads][8];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[hh][i] = 0.f;
  }

  // The loop bound is warp-uniform (the shuffles need every lane); lanes
  // whose slot is past the end compute on zeros and keep their state.
  for (int base = start + warp * SPW; base < end; base += NG) {
    const int slot = base + lane / LPS;
    const bool live = slot < end;
    float kf[8], vf[8];
    float ks = 1.f, vs = 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    if (live) {
      const int page = row_bt[slot / ps];  // slot < lengths[b]: a valid entry
      const size_t row = ((size_t)page * Hkv + g) * ps + slot % ps;
      load_row8<HD, KIND>(kpool, row, li, kf);
      load_row8<HD, KIND>(vpool, row, li, vf);
      if (KIND != kBf16) {
        ks = kscale[row];
        vs = vscale[row];
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += qf[hh][i] * kf[i];
#pragma unroll
      for (int w = LPS / 2; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffff, s, w);
      if (!live) continue;
      s *= ks;
      const float m_new = fmaxf(m[hh], s);
      const float alpha = __expf(m[hh] - m_new);
      const float pr = __expf(s - m_new);
      m[hh] = m_new;
      l[hh] = l[hh] * alpha + pr;
      const float pv = pr * vs;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[hh][i] = acc[hh][i] * alpha + pv * vf[i];
    }
  }

  // Merge the NG streams of the block.
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (li == 0) {
      sm_m[stream][hh] = m[hh];
      sm_l[stream][hh] = l[hh];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[stream][hh][li * 8 + i] = acc[hh][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nh * HD; idx += blockDim.x) {
    const int hh = idx / HD, d = idx % HD;
    float M = kNegInf;
    for (int s = 0; s < NG; ++s) M = fmaxf(M, sm_m[s][hh]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < NG; ++s) {
      const float w = __expf(sm_m[s][hh] - M);  // empty streams: exp(-1e30 - M) = 0
      L += sm_l[s][hh] * w;
      A += sm_acc[s][hh][d] * w;
    }
    const size_t pidx = (size_t)(b * Hq + h0 + hh) * n_chunks + c;
    part_acc[pidx * HD + d] = A;
    if (d == 0) {
      part_m[pidx] = M;
      part_l[pidx] = L;
    }
  }
}

template <int HD>
__global__ void paged_decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc, const int* __restrict__ lengths,
                                            __nv_bfloat16* __restrict__ out, int Hq, int window, int chunk, int n_chunks) {
  const int bh = blockIdx.x, b = bh / Hq, d = threadIdx.x;
  const int len = min(lengths[b], window);
  const int n_valid = len <= 0 ? 0 : min(n_chunks, (len + chunk - 1) / chunk);
  const float* pm = part_m + (size_t)bh * n_chunks;
  const float* pl = part_l + (size_t)bh * n_chunks;
  float M = kNegInf;
  for (int c = 0; c < n_valid; ++c) M = fmaxf(M, pm[c]);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < n_valid; ++c) {
    const float w = __expf(pm[c] - M);
    L += pl[c] * w;
    A += part_acc[((size_t)bh * n_chunks + c) * HD + d] * w;
  }
  out[(size_t)bh * HD + d] = __float2bfloat16(A / (L == 0.f ? 1.f : L));  // length 0: zeros
}

template <int HD, int KIND>
int launch(const void* q, const void* kpool, const void* vpool, const void* kscale, const void* vscale, const void* bt,
           const void* lengths, void* part_m, void* part_l, void* part_acc, void* out, int B, int Hq, int Hkv, int ps,
           int mp, int chunk, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int n_sub = (group + kHeads - 1) / kHeads;
  const int window = mp * ps;
  const int n_chunks = (window + chunk - 1) / chunk;
  dim3 grid(n_chunks, Hkv * n_sub, B);
  paged_decode_split_kernel<HD, KIND><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kpool, vpool, static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const int*>(bt), static_cast<const int*>(lengths),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc), Hq, Hkv, group, n_sub, ps,
      mp, chunk, n_chunks, 1.f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<HD><<<B * Hq, HD, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l), static_cast<const float*>(part_acc),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Hq, window, chunk, n_chunks);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_kind(int kind, const void* q, const void* kpool, const void* vpool, const void* kscale, const void* vscale,
                const void* bt, const void* lengths, void* part_m, void* part_l, void* part_acc, void* out, int B, int Hq,
                int Hkv, int ps, int mp, int chunk, cudaStream_t st) {
  if (kind == kBf16) return launch<HD, kBf16>(q, kpool, vpool, kscale, vscale, bt, lengths, part_m, part_l, part_acc, out, B, Hq, Hkv, ps, mp, chunk, st);
  if (kind == kInt8) return launch<HD, kInt8>(q, kpool, vpool, kscale, vscale, bt, lengths, part_m, part_l, part_acc, out, B, Hq, Hkv, ps, mp, chunk, st);
  if (kind == kInt4) return launch<HD, kInt4>(q, kpool, vpool, kscale, vscale, bt, lengths, part_m, part_l, part_acc, out, B, Hq, Hkv, ps, mp, chunk, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). q/out bf16 [B,Hq,hd]; k/v pools [P,Hkv,ps,kd]
// (bf16 with kd = hd for kind 0, int8 codes with kd = hd for kind 1, packed
// int4 with kd = hd/2 for kind 2); k/v scales f32 [P,Hkv,ps,1] (kinds 1 and 2;
// ignored for kind 0); bt int32 [B,mp]; lengths int32 [B]; scratch part_m /
// part_l f32 [B,Hq,n_chunks] and part_acc f32 [B,Hq,n_chunks,hd] with
// n_chunks = ceil(mp*ps / chunk). Returns cudaGetLastError() of the launches.
extern "C" int xot_paged_decode(const void* q, const void* kpool, const void* vpool, const void* kscale,
                                const void* vscale, const void* bt, const void* lengths, void* part_m, void* part_l,
                                void* part_acc, void* out, int B, int Hq, int Hkv, int hd, int ps, int mp, int kind,
                                int chunk, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || mp <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_kind<64>(kind, q, kpool, vpool, kscale, vscale, bt, lengths, part_m, part_l, part_acc, out, B, Hq, Hkv, ps, mp, chunk, st);
  if (hd == 128) return launch_kind<128>(kind, q, kpool, vpool, kscale, vscale, bt, lengths, part_m, part_l, part_acc, out, B, Hq, Hkv, ps, mp, chunk, st);
  if (hd == 256) return launch_kind<256>(kind, q, kpool, vpool, kscale, vscale, bt, lengths, part_m, part_l, part_acc, out, B, Hq, Hkv, ps, mp, chunk, st);
  return (int)cudaErrorInvalidValue;
}
