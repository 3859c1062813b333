// K4 — packed-int4 weight matmul for Hopper (sm_90a): y = (x @ unpack(w)) * scale.
//
// Replaces the TPU kernel `_int4_kernel` / `int4_matmul`
// (xotorch_support_jetson_tpu/ops/pallas_int4.py:36, :71; pallas_call at :102).
// Semantics are the same: x [T,in] bf16, w [in/2,out] int8 holding two
// sign-extended 4-bit codes per byte (in-row 2r in the low nibble, 2r+1 in the
// high), a per-output-channel f32 scale [out]; y[t,f] = (sum_d x[t,d] *
// unpack(w)[d,f]) * scale[f], accumulated in f32, written as bf16.
//
// What bounds it on the H100: at decode (T = 1..8) memory. Each packed byte
// feeds 2*T multiply-adds, far below the ~295 flop/byte at which the tensor
// cores would bound it; the bound is the packed weight (0.5 byte/param) plus
// scales, x and y over 3.35 TB/s. At prefill (T = 128..256) this kernel does
// its multiply-adds on the CUDA cores in f32, so it is bound by those
// operations; a tensor-core path (wgmma) for large T is later work.
//
// Design: the TPU kernel walked (out tile, in tile) grid steps in order on one
// core, carrying the sum in VMEM scratch, and took x split host-side into its
// even and odd in-channels for two half-dots. Here each packed byte is read
// from device memory once and both of its nibbles are unpacked in registers,
// so x is not reordered. A warp reads one packed row's 256 consecutive bytes
// (8 per lane, one 8-byte load: consecutive output channels are consecutive
// bytes), and each lane accumulates its 8 output channels for the TT rows of
// x its block covers. The four warps of a block take interleaved packed rows;
// their sums merge through shared memory at the end. To fill 132 SMs at
// decode shapes (wk/wv have out = 512: two column tiles) the in-axis is split
// into `n_split` ranges, one block each, and a second small kernel sums the
// splits and applies the scale; with one split the first kernel writes y
// itself. x is staged per 32-row chunk in shared memory as f32 pairs. Nibbles
// become floats without an int-to-float conversion: flipping each nibble's
// sign bit gives v + 8 in [0, 15], which OR-ed into the mantissa of 2^23 and
// less 2^23 + 8 is exactly v. Ragged output columns, rows of x and split ends
// are masked. A simple first kernel: plain loads, no cp.async/TMA pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 8;               // output channels per lane: one 8-byte load of packed codes
constexpr int kBlockN = 32 * kCols;    // output channels per block
constexpr int kChunk = 32;             // packed rows of x staged at a time
constexpr int kUnroll = 4;             // packed rows per warp in flight
constexpr int kStep = kWarps * kUnroll;

static_assert(kChunk % kStep == 0, "a chunk is a whole number of unrolled warp steps");

__device__ __forceinline__ float nibble(uint32_t flipped, int shift) {
  return __uint_as_float(0x4B000000u | ((flipped >> shift) & 0xFu)) - 8388616.0f;
}

template <int TT, bool VEC>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                   float* __restrict__ partial, __nv_bfloat16* __restrict__ y, int T, int K, int N,
                   int rows_per_split) {
  __shared__ float2 xs[kChunk][TT];           // (x[t][2r], x[t][2r+1]) of the chunk's packed rows
  __shared__ float red[kWarps][TT][kBlockN];  // each warp's sums

  const int n0 = blockIdx.x * kBlockN;
  const int split = blockIdx.y;
  const int t0 = blockIdx.z * TT;
  const int k_begin = split * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + lane * kCols;
  const int in = 2 * K;

  float acc[TT][kCols];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[t][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    const int rows = min(kChunk, k_end - kc);
    for (int i = threadIdx.x; i < kChunk * TT; i += kThreads) {
      const int t = i / kChunk, r = i % kChunk;  // consecutive threads: consecutive pairs of one x row
      float2 v = make_float2(0.f, 0.f);
      if (r < rows && t0 + t < T)
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(t0 + t) * in + 2 * (kc + r)));
      xs[r][t] = v;
    }
    __syncthreads();
#pragma unroll
    for (int base = 0; base < kChunk; base += kStep) {
      uint32_t word[kUnroll][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = base + warp + u * kWarps;
        word[u][0] = word[u][1] = 0x88888888u;  // flipped zero codes: value 0
        if (r < rows) {
          const int8_t* src = w + (size_t)(kc + r) * N + col;
          if (VEC) {
            if (col < N) {
              const uint2 raw = *reinterpret_cast<const uint2*>(src);
              word[u][0] = raw.x ^ 0x88888888u;
              word[u][1] = raw.y ^ 0x88888888u;
            }
          } else {
            uint32_t lo = 0, hi = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (col + j < N) lo |= (uint32_t)(uint8_t)src[j] << (8 * j);
              if (col + 4 + j < N) hi |= (uint32_t)(uint8_t)src[4 + j] << (8 * j);
            }
            word[u][0] = lo ^ 0x88888888u;
            word[u][1] = hi ^ 0x88888888u;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = base + warp + u * kWarps;  // rows past `rows` have zero x and zero codes
        float2 xv[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) xv[t] = xs[r][t];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const uint32_t wd = word[u][j / 4];
          const float we = nibble(wd, 8 * (j % 4));      // in-row 2r (low nibble)
          const float wo = nibble(wd, 8 * (j % 4) + 4);  // in-row 2r+1 (high nibble)
#pragma unroll
          for (int t = 0; t < TT; ++t) acc[t][j] = fmaf(xv[t].y, wo, fmaf(xv[t].x, we, acc[t][j]));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[warp][t][lane * kCols + j] = acc[t][j];
  __syncthreads();
  for (int i = threadIdx.x; i < TT * kBlockN; i += kThreads) {
    const int t = i / kBlockN, c = i % kBlockN;
    const int n = n0 + c;
    if (t0 + t >= T || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q][t][c];
    const size_t o = (size_t)(t0 + t) * N + n;
    if (partial != nullptr)
      partial[(size_t)split * T * N + o] = s;
    else
      y[o] = __float2bfloat16(s * scale[n]);
  }
}

__global__ void int4_matmul_combine_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                                           __nv_bfloat16* __restrict__ y, int T, int N, int n_split) {
  const size_t total = (size_t)T * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += partial[(size_t)k * total + i];
  y[i] = __float2bfloat16(s * scale[i % N]);
}

template <int TT, bool VEC>
int launch(const void* x, const void* w, const void* scale, void* partial, void* y, int T, int K, int N, int n_split,
           int rows_per_split, cudaStream_t st) {
  dim3 grid((N + kBlockN - 1) / kBlockN, n_split, (T + TT - 1) / TT);
  int4_matmul_kernel<TT, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      n_split > 1 ? static_cast<float*>(partial) : nullptr, static_cast<__nv_bfloat16*>(y), T, K, N, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const size_t total = (size_t)T * N;
  int4_matmul_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), T, N,
      n_split);
  return (int)cudaGetLastError();
}

template <int TT>
int launch_tt(bool vec, const void* x, const void* w, const void* scale, void* partial, void* y, int T, int K, int N,
              int n_split, int rows_per_split, cudaStream_t st) {
  if (vec) return launch<TT, true>(x, w, scale, partial, y, T, K, N, n_split, rows_per_split, st);
  return launch<TT, false>(x, w, scale, partial, y, T, K, N, n_split, rows_per_split, st);
}

}  // namespace

// C interface (bound with ctypes). x bf16 [T, 2K]; w int8 [K, N] packed codes;
// scale f32 [N]; y bf16 [T, N]; partial f32 [n_split, T, N] scratch (unused,
// may be null, when n_split == 1). `tt` rows of x per block (1, 2, 4 or 8);
// the in-axis is cut into n_split ranges of rows_per_split packed rows (a
// multiple of 32; the last range may be shorter, none may be empty). Returns
// cudaGetLastError() of the launches.
extern "C" int xot_int4_matmul(const void* x, const void* w, const void* scale, void* partial, void* y, int T, int K,
                               int N, int tt, int n_split, int rows_per_split, void* stream) {
  if (T < 0 || K <= 0 || N <= 0 || n_split <= 0 || rows_per_split <= 0 || rows_per_split % kChunk != 0 ||
      (long long)(n_split - 1) * rows_per_split >= K || (long long)n_split * rows_per_split < K ||
      (n_split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
  if (tt == 1) return launch_tt<1>(vec, x, w, scale, partial, y, T, K, N, n_split, rows_per_split, st);
  if (tt == 2) return launch_tt<2>(vec, x, w, scale, partial, y, T, K, N, n_split, rows_per_split, st);
  if (tt == 4) return launch_tt<4>(vec, x, w, scale, partial, y, T, K, N, n_split, rows_per_split, st);
  if (tt == 8) return launch_tt<8>(vec, x, w, scale, partial, y, T, K, N, n_split, rows_per_split, st);
  return (int)cudaErrorInvalidValue;
}
