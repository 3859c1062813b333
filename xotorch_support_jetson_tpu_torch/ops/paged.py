"""Paged KV cache: a shared page pool addressed through per-row block
tables, and the paged decode attention (K3). Counterpart of the
reference's ``ops/paged.py``.

Pool layout: ``[L, P, Hkv, ps, kd]`` per leaf — one logical page id
addresses the same page in every layer, and each (page, head) ``[ps, kd]``
tile is contiguous. ``kd`` is ``hd`` for bf16 and int8 codes and ``hd/2``
for packed int4 codes; quantized pools carry ``k_scale``/``v_scale``
``[L, P, Hkv, ps, 1]`` f32 leaves. An MLA (deepseek) pool takes the
config's cache geometry: "k" holds the kv latent (``kv_lora_rank`` wide),
"v" the rope channel (``qk_rope_head_dim``), one head entry, never
quantized; its decode attention is ``paged_mla_attention_ref``, the
reference's gather and absorbed op (no kernel, as in the reference).
Page 0 is a trash page: unallocated block-table entries point there, and
writes of padding or inactive rows land there, so no write needs a
condition.

The reference's pool ops return new pools; here they UPDATE THE POOL IN
PLACE (``write_token_kv``, ``write_window_kv``, ``scatter_row_pages``) and
return it.

Batched speculation's verify window (W tokens per row) writes its KV with
one indexed write per leaf (``write_window_kv``) and attends through K3 in
ONE launch over the B·W window rows, each with its own length
(``paged_window_attention``; the reference launches K3 once per window
position). Both clamp where a held row's window runs past its table.

``paged_decode_attention`` takes the plain version
(``paged_decode_attention_ref``) for a tensor on the CPU and launches the
hand-written kernel ``csrc/paged_decode.cu`` for a CUDA tensor — or raises
on what the kernel does not take. There is no fallback from a CUDA tensor
to the plain version. ``LAUNCHES`` counts kernel launches
(a call recorded into a CUDA graph is counted at the graph's replays,
``kernels.count_launch``).
"""

from __future__ import annotations

import torch

from ..utils.helpers import env_flag
from .attention import gqa_attention, mla_absorbed_attention
from .kernels import check_cuda, count_launch, decode_plan, decode_rows, load, sm_count, stream_ptr

HEAD_DIMS = (64, 128, 256)

LAUNCHES = {"paged_decode": 0}


def reset_launch_counts() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def init_paged_pool(cfg, n_shard_layers: int, n_pages: int, page_size: int, dtype=None, quant: str | None = None, device=None) -> dict:
  """Page pool for a shard. ``n_pages`` INCLUDES the reserved trash page 0.
  Geometry from the config (``cache_kv_heads``, ``cache_k_dim``,
  ``cache_v_dim``; MLA's k and v differ in width). ``quant`` ("", "int8",
  "int4"; default ``XOT_TPU_KV_QUANT``, always "" for MLA) as in
  ``models/decoder.py init_kv_cache``: int8 adds per-(slot, head) scale
  leaves, int4 halves the code axis and keeps the same scales."""
  from ..models.decoder import kv_quant_mode

  mode = kv_quant_mode(cfg, quant)
  kd, vd = cfg.cache_k_dim, cfg.cache_v_dim
  if mode == "int4":
    if kd % 2 or vd % 2:
      raise ValueError(f"int4 KV pages need even cache dims; got k={kd} v={vd}")
    kd, vd = kd // 2, vd // 2
  k_shape = (n_shard_layers, n_pages, cfg.cache_kv_heads, page_size, kd)
  v_shape = (n_shard_layers, n_pages, cfg.cache_kv_heads, page_size, vd)
  if mode:
    scale_shape = k_shape[:-1] + (1,)
    return {
      "k": torch.zeros(k_shape, dtype=torch.int8, device=device),
      "v": torch.zeros(v_shape, dtype=torch.int8, device=device),
      "k_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
      "v_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
    }
  dtype = dtype or cfg.dtype
  return {"k": torch.zeros(k_shape, dtype=dtype, device=device), "v": torch.zeros(v_shape, dtype=dtype, device=device)}


def write_token_kv(pool_l: torch.Tensor, new: torch.Tensor, block_tables: torch.Tensor, pos: torch.Tensor, page_size: int) -> torch.Tensor:
  """Write one decode step's KV into one layer's pool, in place.

  pool_l [P, Hkv, ps, kd]; new [B, Hkv, kd]; block_tables [B, mp]; pos [B]
  (the logical position being written). Rows own disjoint pages, so only
  rows pinned to the trash page can collide."""
  pos = pos.long()
  page = torch.gather(block_tables, 1, (pos // page_size)[:, None]).long()[:, 0]
  pool_l[page, :, pos % page_size] = new.to(pool_l.dtype)
  return pool_l


def _window_targets(block_tables: torch.Tensor, positions: torch.Tensor, page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
  """(page [B, W], slot [B, W]) of each window position. The table column
  clamps to the row's last one: an inactive row holds its position while
  its window still writes W tokens, which near the context window reaches
  past its table; its table is pinned to the trash page, so the clamped
  write lands there (the reference gets the same from XLA's index clamp)."""
  pos = positions.long()
  col = torch.clamp(pos // page_size, max=block_tables.shape[1] - 1)
  return torch.gather(block_tables, 1, col).long(), pos % page_size


def write_window_kv(pool_l: torch.Tensor, new: torch.Tensor, block_tables: torch.Tensor, positions: torch.Tensor, page_size: int) -> torch.Tensor:
  """Write a verify window's KV into one layer's pool, in place, with one
  indexed write: pool_l [P, Hkv, ps, kd]; new [B, W, Hkv, kd]; positions
  [B, W]. Only rows pinned to the trash page can collide."""
  page, slot = _window_targets(block_tables, positions, page_size)
  pool_l[page, :, slot] = new.to(pool_l.dtype)
  return pool_l


def write_window_kv_ref(pool_l: torch.Tensor, new: torch.Tensor, block_tables: torch.Tensor, positions: torch.Tensor, page_size: int) -> torch.Tensor:
  """Plain version of ``write_window_kv``: one ``write_token_kv`` per window
  position, as the reference writes the window (same clamp)."""
  page, slot = _window_targets(block_tables, positions, page_size)
  for j in range(new.shape[1]):
    pool_l[page[:, j], :, slot[:, j]] = new[:, j].to(pool_l.dtype)
  return pool_l


def gather_pages(pool_l: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
  """[P, Hkv, ps, kd] × [B, mp] → position-ordered [B, mp·ps, Hkv, kd]."""
  B, mp = block_tables.shape
  _, H, ps, kd = pool_l.shape
  g = pool_l.index_select(0, block_tables.reshape(-1).long()).view(B, mp, H, ps, kd)
  return g.transpose(2, 3).reshape(B, mp * ps, H, kd)


def gather_row_pages(pool_part: torch.Tensor, bt_rows: torch.Tensor) -> torch.Tensor:
  """All-layer per-row gather: [L, P, H, ps, kd] × [K, mp] → position-ordered
  [L, K, mp·ps, H, kd] (a fresh tensor)."""
  K, mp = bt_rows.shape
  L, _, H, ps, kd = pool_part.shape
  g = pool_part.index_select(1, bt_rows.reshape(-1).long()).view(L, K, mp, H, ps, kd)
  # A one-page window reshapes as a strided view: K1 takes contiguous K/V.
  return g.transpose(3, 4).reshape(L, K, mp * ps, H, kd).contiguous()


def touched_page_targets(bt_rows: torch.Tensor, prefix_lens: torch.Tensor, prompt_lens: torch.Tensor, page_size: int) -> torch.Tensor:
  """Per-row scatter targets for a prefill: each row's pages from its reused
  prefix boundary up to its prompt end keep their page ids; everything else
  (shared prefix pages, unallocated entries, padding rows) targets the trash
  page 0."""
  mp = bt_rows.shape[1]
  page_ids = torch.arange(mp, dtype=torch.int32, device=bt_rows.device)[None, :]
  touched = (page_ids >= (prefix_lens[:, None] // page_size)) & (page_ids * page_size < prompt_lens[:, None])
  return torch.where(touched, bt_rows, torch.zeros_like(bt_rows))


def scatter_row_pages(pool_part: torch.Tensor, t: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
  """Inverse of ``gather_row_pages`` restricted to ``target`` pages, in
  place: t [L, K, mp·ps, H, kd] → pool [L, P, H, ps, kd]."""
  L, K, N, H, kd = t.shape
  mp = target.shape[1]
  ps = pool_part.shape[3]
  pages = t.view(L, K, mp, ps, H, kd).transpose(3, 4).reshape(L, K * mp, H, ps, kd)
  pool_part[:, target.reshape(-1).long()] = pages.to(pool_part.dtype)
  return pool_part


def paged_gqa_attention_ref(q, k_pool_l, v_pool_l, block_tables, lengths, page_size: int, k_scale_pool_l=None, v_scale_pool_l=None, q_positions=None, **attn_opts) -> torch.Tensor:
  """Paged attention by gather (q [B, Sq, Hq, hd]; Sq is 1 on the decode
  path). With scale pools the gathered codes stay the einsum operand (int4
  codes unpack after the gather) and the scales gather alongside.
  ``q_positions`` [B, Sq] overrides the single-query default (each row's
  ``lengths - 1``). ``attn_opts`` carry gemma2's scale, softcap and
  sliding window to ``gqa_attention`` (models/decoder.py ``_attn_opts``)."""
  k = gather_pages(k_pool_l, block_tables)
  v = gather_pages(v_pool_l, block_tables)
  kv_positions = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
  if q_positions is None:
    q_positions = (lengths - 1)[:, None]
  scales = {}
  if k_scale_pool_l is not None:
    if k.shape[-1] * 2 == q.shape[-1]:  # packed int4 codes
      from ..models.quantize import unpack_int4_kv

      k, v = unpack_int4_kv(k), unpack_int4_kv(v)
    scales = dict(k_scale=gather_pages(k_scale_pool_l, block_tables), v_scale=gather_pages(v_scale_pool_l, block_tables))
  return gqa_attention(q, k, v, q_positions, kv_positions, **scales, **attn_opts)


def paged_mla_attention_ref(q_nope, q_pe, k_pool_l, v_pool_l, block_tables, lengths, w_kv_b, v_dim: int, page_size: int) -> torch.Tensor:
  """Paged MLA decode attention: gather the latent pages, then the absorbed
  op (q_nope [B, 1, H, nope], q_pe [B, 1, H, rope] → [B, 1, H, v_dim])."""
  ckv = gather_pages(k_pool_l, block_tables)[:, :, 0, :]  # [B, mp·ps, rank]
  kpe = gather_pages(v_pool_l, block_tables)[:, :, 0, :]
  kv_positions = torch.arange(ckv.shape[1], dtype=torch.int32, device=ckv.device)
  return mla_absorbed_attention(q_nope, q_pe, ckv, kpe, w_kv_b, (lengths - 1)[:, None], kv_positions, v_dim)


def paged_decode_attention_ref(q, k_pool_l, v_pool_l, block_tables, lengths, page_size: int, k_scale_pool_l=None, v_scale_pool_l=None) -> torch.Tensor:
  """Plain version of K3, same signature as ``paged_decode_attention``:
  q [B, Hq, hd] → [B, Hq, hd] through the gather reference."""
  return paged_gqa_attention_ref(q[:, None], k_pool_l, v_pool_l, block_tables, lengths, page_size, k_scale_pool_l, v_scale_pool_l)[:, 0]


def paged_decode_attention(q, k_pool_l, v_pool_l, block_tables, lengths, page_size: int, k_scale_pool_l=None, v_scale_pool_l=None) -> torch.Tensor:
  """Decode attention straight off the page pool (dense GQA models).

  q [B, Hq, hd] (one new token per row); k/v pool [P, Hkv, ps, kd];
  block_tables [B, mp] int32 (entries past a row's last valid page may hold
  anything: they are never read); lengths [B] int32 = valid KV slots
  INCLUDING the token just written (≥ 1). With ``k_scale_pool_l`` /
  ``v_scale_pool_l`` [P, Hkv, ps, 1] f32 the pools hold int8 codes, or
  packed int4 codes when their last axis is hd/2. Returns [B, Hq, hd] in
  q's dtype. On CUDA: bf16 q (and pools unless quantized), hd ∈ {64, 128,
  256}, Hq a multiple of Hkv, int32 tables and lengths, all contiguous."""
  if (k_scale_pool_l is None) != (v_scale_pool_l is None):
    raise ValueError("paged_decode_attention: k_scale_pool_l and v_scale_pool_l must be passed together")
  if q.device.type == "cpu":
    return paged_decode_attention_ref(q, k_pool_l, v_pool_l, block_tables, lengths, page_size, k_scale_pool_l, v_scale_pool_l)
  if q.device.type != "cuda":
    raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
  B, Hq, hd = q.shape
  P, Hkv, ps, kd = k_pool_l.shape
  mp = block_tables.shape[1]
  quantized = k_scale_pool_l is not None
  kind = 0 if not quantized else (2 if kd * 2 == hd else 1)
  if hd not in HEAD_DIMS or Hq % Hkv or ps != page_size or kd != (hd // 2 if kind == 2 else hd):
    raise ValueError(f"paged_decode_attention: unsupported geometry Hq={Hq} Hkv={Hkv} hd={hd} page={ps} (page_size {page_size}) code axis {kd}")
  dev = q.device
  pool_dtype = torch.int8 if quantized else torch.bfloat16
  check_cuda("q", q, torch.bfloat16, (B, Hq, hd), dev)
  check_cuda("k_pool", k_pool_l, pool_dtype, (P, Hkv, ps, kd), dev)
  check_cuda("v_pool", v_pool_l, pool_dtype, (P, Hkv, ps, kd), dev)
  if quantized:
    check_cuda("k_scale_pool", k_scale_pool_l, torch.float32, (P, Hkv, ps, 1), dev)
    check_cuda("v_scale_pool", v_scale_pool_l, torch.float32, (P, Hkv, ps, 1), dev)
  check_cuda("block_tables", block_tables, torch.int32, (B, mp), dev)
  check_cuda("lengths", lengths, torch.int32, (B,), dev)
  for name, t in (("k_pool", k_pool_l), ("v_pool", v_pool_l)):
    if t.data_ptr() % 16:
      raise ValueError(f"paged_decode_attention: {name} must be 16-byte aligned")
  cluster, range_ = decode_plan(mp * ps, decode_rows(B, Hq, Hkv), sm_count(dev.index))
  out = torch.empty_like(q)
  rc = load("paged_decode")(
    q.data_ptr(), k_pool_l.data_ptr(), v_pool_l.data_ptr(),
    k_scale_pool_l.data_ptr() if quantized else None, v_scale_pool_l.data_ptr() if quantized else None,
    block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, ps, mp, kind, cluster, range_, stream_ptr(dev),
  )
  if rc != 0:
    raise RuntimeError(f"paged_decode kernel launch failed (cluster of {cluster}, {range_} slots per block): cudaError {rc}")
  count_launch(LAUNCHES, "paged_decode")
  return out


def window_block_tables(block_tables: torch.Tensor, window: int) -> torch.Tensor:
  """[B, mp] → [B·W, mp]: each row's table repeated once per window
  position, the layout ``paged_window_attention`` takes. Tables are constant
  over a spec chunk, so this runs once per chunk, not per layer. An expand
  and one copy, so a CUDA-graph capture records it with no read of the
  device."""
  B, mp = block_tables.shape
  return block_tables[:, None, :].expand(B, window, mp).reshape(B * window, mp).contiguous()


def paged_window_attention_ref(q, k_pool_l, v_pool_l, block_tables, positions, page_size: int, k_scale_pool_l=None, v_scale_pool_l=None, **attn_opts) -> torch.Tensor:
  """Plain version of ``paged_window_attention`` (the reference's gather
  route): q [B, W, Hq, hd] at positions [B, W], each query attending to the
  slots at or below its own position. block_tables [B, mp]; ``attn_opts``
  as in ``paged_gqa_attention_ref``."""
  return paged_gqa_attention_ref(q, k_pool_l, v_pool_l, block_tables, positions[:, -1] + 1, page_size, k_scale_pool_l, v_scale_pool_l, q_positions=positions, **attn_opts)


def paged_window_attention(q, k_pool_l, v_pool_l, bt_window, positions, page_size: int, k_scale_pool_l=None, v_scale_pool_l=None) -> torch.Tensor:
  """Verify-window attention through K3 in ONE launch: q [B, W, Hq, hd]
  flattens to B·W single-query rows, each with its own length
  ``position + 1`` over its row's table (``bt_window`` [B·W, mp] from
  ``window_block_tables``). This is exactly what the reference's W
  one-query launches compute (its kernel route, reference
  ``models/decoder.py _paged_window_layer_step``). Lengths clamp to the
  table's reach ``mp·page_size``: an inactive row's window can run past it
  near the context window, and its output is discarded. On the CPU the
  rows go through K3's plain version, as ``paged_decode_attention`` does."""
  B, W, Hq, hd = q.shape
  lengths = torch.clamp(positions.reshape(B * W) + 1, max=bt_window.shape[1] * page_size).to(torch.int32)
  out = paged_decode_attention(q.reshape(B * W, Hq, hd).contiguous(), k_pool_l, v_pool_l, bt_window, lengths, page_size, k_scale_pool_l, v_scale_pool_l)
  return out.view(B, W, Hq, hd)


def paged_kernel_tile(cfg, batch: int, context: int, page_size: int, device) -> int:
  """Pages of a row's window that one K3 block covers at this pool's shape
  (the slot range per block of ``decode_plan``, as the wrapper launches
  it), 0 off the card. The batched server's ``paged_kernel_tile`` gauge;
  the reference reports its kernel's pages per grid step there, a
  parameter K3 does not have."""
  device = torch.device(device)
  if device.type != "cuda":
    return 0
  _, range_ = decode_plan(context, decode_rows(batch, cfg.n_heads, cfg.n_kv_heads), sm_count(device.index))
  return -(-int(range_) // int(page_size))


def paged_kernel_supported(cfg) -> bool:
  """Whether paged decode attention goes through ``paged_decode_attention``
  (K3 on a CUDA tensor, its plain version on the CPU) rather than the
  gather reference. Only an explicit ``XOT_TPU_PAGED_KERNEL=0`` asks for
  the gather path, and a config with attention variations (gemma2) or MLA
  has no other: the kernel implements neither. Whether it should run at a
  (batch, window, KV quant) point is the decode-path table's call
  (``inference/paging.py select_decode_path``; models/decoder.py
  ``paged_use_kernel`` resolves through both)."""
  return cfg.plain_attention and not cfg.is_mla and env_flag("XOT_TPU_PAGED_KERNEL", default=True)


def check_paged_kernel(cfg, device) -> None:
  """Refuse batched decode on a CUDA ``device`` for a head dim K3 has no
  variant for, instead of serving it through the gather path."""
  if torch.device(device).type == "cuda" and paged_kernel_supported(cfg) and cfg.head_dim not in HEAD_DIMS:
    raise NotImplementedError(
      f"paged decode kernel has no variant for head dim {cfg.head_dim} (has {HEAD_DIMS}); "
      "set XOT_TPU_PAGED_KERNEL=0 for the gather path"
    )
