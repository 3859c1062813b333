// K2 — split-K flash decoding for Hopper (sm_90a), bf16 KV.
//
// Replaces the TPU kernel `_flash_decode_kernel` / `flash_decode_attention`
// (xotorch_support_jetson_tpu/ops/pallas_attention.py:190, :254): one query
// per batch row attends the dense slot-indexed cache [B,Skv,Hkv,hd] up to
// q_positions[b] (inclusive), scale 1/sqrt(hd), online softmax in f32.
//
// What bounds it on the H100: memory. Each decode step reads every live
// K/V slot once (2·(pos+1)·Hkv·hd·2 bytes per row) and does ~4 flops per
// byte, far below the ~295 flop/byte the card needs to be compute bound;
// the bound is cache bytes over 3.35 TB/s.
//
// Design: the TPU kernel walked the cache in order on one core; here the
// cache is split into chunks of `chunk` slots and one block per (chunk, kv
// head, batch row) reduces its chunk to a partial (m, l, acc) for the (up
// to four) q heads that share the kv head, so K/V bytes are read once for
// all of them. At B=1 llama-3.2-1b has only 8 kv heads; without the split
// 8 blocks would leave 124 of 132 SMs idle. Chunks past a row's position
// exit at once (no load), so the cost follows the live context, not the
// cache allocation. A second small kernel merges the chunk partials. Loads
// are 16 bytes per lane with hd/8 lanes covering one contiguous slot row;
// dot products reduce over those lanes with shuffles. The block-diagonal
// query and the 0/1 fold matrix of the TPU kernel were Mosaic layout
// workarounds and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kHeads = 4;  // q heads per block (a kv head's group is split in fours)
constexpr float kNegInf = -1e30f;

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos, float* __restrict__ part_m,
                          float* __restrict__ part_l, float* __restrict__ part_acc, int Skv, int Hq, int Hkv, int group,
                          int n_sub, int chunk, int n_chunks, float scale) {
  constexpr int LPS = HD / 8;          // lanes per slot row (8 bf16 = 16 bytes each)
  constexpr int SPW = 32 / LPS;        // slots per warp step
  constexpr int NG = kWarps * SPW;     // independent slot streams per block
  __shared__ float sm_m[NG][kHeads];
  __shared__ float sm_l[NG][kHeads];
  __shared__ float sm_acc[NG][kHeads][HD];

  const int c = blockIdx.x, g = blockIdx.y / n_sub, sub = blockIdx.y % n_sub, b = blockIdx.z;
  const int p = pos[b];
  const int start = c * chunk;
  if (p < 0 || start > p) return;  // past the row's position: nothing to read
  const int end = min(min(start + chunk, p + 1), Skv);
  const int h0 = g * group + sub * kHeads;
  const int nh = min(kHeads, group - sub * kHeads);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = lane % LPS;                 // this lane's 8-element slice of hd
  const int stream = warp * SPW + lane / LPS;  // which slot stream this lane serves

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
    uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
    if (live) {
      const size_t row = ((size_t)(b * Skv + slot) * Hkv + g) * HD + li * 8;
      kraw = *reinterpret_cast<const uint4*>(k + row);
      vraw = *reinterpret_cast<const uint4*>(v + row);
    }
    const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kraw);
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vraw);
    float kf[8], vf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      kf[i] = __bfloat162float(ke[i]);
      vf[i] = __bfloat162float(ve[i]);
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += qf[hh][i] * kf[i];
#pragma unroll
      for (int w = LPS / 2; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffff, s, w);
      if (!live) continue;
      const float m_new = fmaxf(m[hh], s);
      const float alpha = __expf(m[hh] - m_new);
      const float pr = __expf(s - m_new);
      m[hh] = m_new;
      l[hh] = l[hh] * alpha + pr;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[hh][i] = acc[hh][i] * alpha + pr * vf[i];
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
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc, const int* __restrict__ pos,
                                            __nv_bfloat16* __restrict__ out, int Hq, int chunk, int n_chunks) {
  const int bh = blockIdx.x, b = bh / Hq, d = threadIdx.x;
  const int p = pos[b];
  const int n_valid = p < 0 ? 0 : min(n_chunks, p / chunk + 1);
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
  out[(size_t)bh * HD + d] = __float2bfloat16(A / (L == 0.f ? 1.f : L));
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* pos, void* part_m, void* part_l, void* part_acc,
           void* out, int B, int Skv, int Hq, int Hkv, int chunk, int n_chunks, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int n_sub = (group + kHeads - 1) / kHeads;
  dim3 grid(n_chunks, Hkv * n_sub, B);
  flash_decode_split_kernel<HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(pos), static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      Skv, Hq, Hkv, group, n_sub, chunk, n_chunks, 1.f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<HD><<<B * Hq, HD, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l), static_cast<const float*>(part_acc),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), Hq, chunk, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). q/out bf16 [B,Hq,hd] (the [B,1,Hq,hd]
// decode query); k/v bf16 [B,Skv,Hkv,hd]; pos int32 [B]; scratch part_m /
// part_l f32 [B,Hq,n_chunks] and part_acc f32 [B,Hq,n_chunks,hd] with
// n_chunks = ceil(Skv / chunk). Returns cudaGetLastError() of the launches.
extern "C" int xot_flash_decode(const void* q, const void* k, const void* v, const void* pos, void* part_m, void* part_l,
                                void* part_acc, void* out, int B, int Skv, int Hq, int Hkv, int hd, int chunk, void* stream) {
  if (Hq % Hkv != 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int n_chunks = (Skv + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, pos, part_m, part_l, part_acc, out, B, Skv, Hq, Hkv, chunk, n_chunks, st);
  if (hd == 128) return launch<128>(q, k, v, pos, part_m, part_l, part_acc, out, B, Skv, Hq, Hkv, chunk, n_chunks, st);
  if (hd == 256) return launch<256>(q, k, v, pos, part_m, part_l, part_acc, out, B, Skv, Hq, Hkv, chunk, n_chunks, st);
  return (int)cudaErrorInvalidValue;
}
