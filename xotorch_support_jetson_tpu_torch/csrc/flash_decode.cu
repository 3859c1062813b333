// K2 — flash decoding for Hopper (sm_90a), bf16 KV, one launch per call.
//
// Replaces the TPU kernel `_flash_decode_kernel` / `flash_decode_attention`
// (xotorch_support_jetson_tpu/ops/pallas_attention.py:190, :254): one query
// per batch row attends the dense slot-indexed cache [B,Skv,Hkv,hd] up to
// q_positions[b] (inclusive), scale 1/sqrt(hd), online softmax in f32.
//
// What bounds it on the H100: memory (cache bytes over 3.35 TB/s; see
// decode_attention.cuh). The TPU kernel walked the cache in order on one
// core; here the cache of one (row, kv head) is split over the blocks of a
// thread-block cluster, each streams its slots through a cp.async ring and
// the partials merge through distributed shared memory, all in one kernel
// (decode_attention.cuh). A slot is a 2·hd-byte row at a stride of
// Hkv·hd·2 bytes. The block-diagonal query and the 0/1 fold matrix of the
// TPU kernel were Mosaic layout workarounds and have no counterpart here.

#include "decode_attention.cuh"

using namespace xot_decode;

// C interface (bound with ctypes). q/out bf16 [B,Hq,hd] (the [B,1,Hq,hd]
// decode query); k/v bf16 [B,Skv,Hkv,hd], 16-byte aligned; pos int32 [B].
// `cluster` (1..16) blocks per (row, kv head) each take `range` slots, with
// cluster·range >= Skv. Returns the launch's cudaError_t.
extern "C" int xot_flash_decode(const void* q, const void* k, const void* v, const void* pos, void* out, int B, int Skv,
                                int Hq, int Hkv, int hd, int cluster, int range, void* stream) {
  const DenseSlots slots{static_cast<const int*>(pos), Skv, Hkv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64, kBf16>(q, k, v, nullptr, nullptr, out, slots, B, Hq, Hkv, Skv, cluster, range, 0, st);
  if (hd == 128) return launch<128, kBf16>(q, k, v, nullptr, nullptr, out, slots, B, Hq, Hkv, Skv, cluster, range, 0, st);
  if (hd == 256) return launch<256, kBf16>(q, k, v, nullptr, nullptr, out, slots, B, Hq, Hkv, Skv, cluster, range, 0, st);
  return (int)cudaErrorInvalidValue;
}
