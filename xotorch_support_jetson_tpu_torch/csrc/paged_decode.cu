// K3 — paged decode attention for Hopper (sm_90a): bf16, int8 and packed-int4
// KV pages, one launch per call.
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
// What bounds it on the H100: memory (2 · len · Hkv · (hd·elem + scale)
// bytes per row over 3.35 TB/s; see decode_attention.cuh). The TPU kernel
// walked G-page tiles in order on one core, with the block table
// scalar-prefetched into clamped BlockSpec index maps and q de-interleaved
// outside the kernel for a two-dot int4 product. Here the window of one
// (row, kv head) is split over the blocks of a thread-block cluster; each
// block stages its range's table entries once (one per page), streams the
// pages' contiguous ps·kd-byte runs (and their scales) through a cp.async
// ring, keeps int8/int4 codes at their width in shared memory and widens
// them in registers (channel order kept, so q needs no reordering), and the
// partials merge through distributed shared memory in the same kernel
// (decode_attention.cuh).

#include "decode_attention.cuh"

using namespace xot_decode;

namespace {

template <int HD>
int launch_kind(int kind, const void* q, const void* kpool, const void* vpool, const void* kscale, const void* vscale,
                void* out, const PagedSlots& slots, int B, int Hq, int Hkv, int cluster, int range, int n_table,
                cudaStream_t st) {
  const int window = slots.mp * slots.ps;
  if (kind == kBf16) return launch<HD, kBf16>(q, kpool, vpool, kscale, vscale, out, slots, B, Hq, Hkv, window, cluster, range, n_table, st);
  if (kind == kInt8) return launch<HD, kInt8>(q, kpool, vpool, kscale, vscale, out, slots, B, Hq, Hkv, window, cluster, range, n_table, st);
  if (kind == kInt4) return launch<HD, kInt4>(q, kpool, vpool, kscale, vscale, out, slots, B, Hq, Hkv, window, cluster, range, n_table, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). q/out bf16 [B,Hq,hd]; k/v pools [P,Hkv,ps,kd],
// 16-byte aligned (bf16 with kd = hd for kind 0, int8 codes with kd = hd for
// kind 1, packed int4 with kd = hd/2 for kind 2); k/v scales f32 [P,Hkv,ps,1]
// (kinds 1 and 2; ignored for kind 0); bt int32 [B,mp]; lengths int32 [B].
// `cluster` (1..16) blocks per (row, kv head) each take `range` slots of the
// mp·ps window, with cluster·range >= mp·ps. Returns the launch's cudaError_t.
extern "C" int xot_paged_decode(const void* q, const void* kpool, const void* vpool, const void* kscale,
                                const void* vscale, const void* bt, const void* lengths, void* out, int B, int Hq, int Hkv,
                                int hd, int ps, int mp, int kind, int cluster, int range, void* stream) {
  if (ps <= 0 || mp <= 0 || range < 1) return (int)cudaErrorInvalidValue;
  const PagedSlots slots{static_cast<const int*>(bt), static_cast<const int*>(lengths), Hkv, ps, mp};
  const int n_table = (range + ps - 1) / ps + 1;  // pages one block's range can touch
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_kind<64>(kind, q, kpool, vpool, kscale, vscale, out, slots, B, Hq, Hkv, cluster, range, n_table, st);
  if (hd == 128) return launch_kind<128>(kind, q, kpool, vpool, kscale, vscale, out, slots, B, Hq, Hkv, cluster, range, n_table, st);
  if (hd == 256) return launch_kind<256>(kind, q, kpool, vpool, kscale, vscale, out, slots, B, Hq, Hkv, cluster, range, n_table, st);
  return (int)cudaErrorInvalidValue;
}
