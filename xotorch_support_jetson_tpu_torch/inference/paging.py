"""Host-side page bookkeeping for the paged KV pool: the page allocator with
its content-keyed prefix cache, and the block math the scheduler sizes the
pool with. Own copy of the part of the reference's ``inference/paging.py``
the batched serving slice uses (``PageAllocator``, ``pages_to_cover``,
``kv_cache_bytes``, the mixed-tick budget policy ``select_mixed_budget``,
and the per-row speculation policy ``spec_adapt_gamma``,
``spec_select_proposer``, ``spec_reprobe_proposer``, ``spec_worst_advance``
and ``ewma_update``, and the adapter stacks' ``lora_device_bytes`` and
``lora_pages_equivalent``), with the host KV tier's hooks on the allocator
(``spill_hook``, ``chain_keys_extend``, ``is_cached``, ``adopt_restored``),
and the decode-path dispatch (``select_decode_path``,
``resolved_decode_path``): the reference's walk and forcing, off the card
its "gather" answer, and on a CUDA device a table measured on the H100
(``_H100_DECODE_PATH_TABLE``) in place of the reference's TPU one, which is
not carried over. Nor is its page-tile table (pages per grid step of its
TPU kernel): K3 has no such parameter, and ``ops/paged.py
paged_kernel_tile`` reports the pages one K3 block covers instead.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict

import numpy as np


def kv_cache_bytes(cfg, n_layers: int, n_tokens: int, quant: str = "") -> int:
  """Device bytes of ``n_tokens`` cached positions under ``quant``, from
  the config's cache geometry (an MLA model's latent and rope channel):
  int4 packs two code nibbles per byte, and both quantized modes pay one
  f32 scale per (token, head) per side."""
  heads = cfg.cache_kv_heads
  per_side = cfg.cache_k_dim + cfg.cache_v_dim
  if quant == "int4":
    per_token = heads * (per_side // 2 + 2 * 4)
  elif quant:
    per_token = heads * (per_side + 2 * 4)
  else:
    per_token = heads * per_side * cfg.dtype.itemsize
  return int(n_layers) * int(n_tokens) * int(per_token)


def lora_device_bytes(n_layers: int, d_in: int, d_out: int, rank: int, n_slots: int, itemsize: int = 4) -> int:
  """Device bytes of ONE target projection's stacked adapter slots
  (inference/adapters.py): ``A [L, n_slots, d_in, r]`` + ``B [L, n_slots,
  r, d_out]``. The registry's capacity is allocated up front, so the
  batched server deducts it from the default page budget, as it does the
  draft's cache."""
  return int(n_layers) * int(n_slots) * int(rank) * (int(d_in) + int(d_out)) * int(itemsize)


def lora_pages_equivalent(device_bytes: int, page_bytes: int) -> int:
  """Adapter-stack bytes in pages of the serving pool (rounded up): what
  the scheduler takes off the default pool size."""
  return -(-int(device_bytes) // max(int(page_bytes), 1))


def adapter_chain_seed(adapter: str | None) -> bytes:
  """The prefix-cache chain's seed for a row serving ``adapter``: empty for
  the base model (its keys stay the plain content chain), else a digest of
  the adapter's name. An adapter changes every layer's K/V past the first
  layer's k, so a page is reusable only under the adapter that wrote it.
  The reference keys its prefix cache on tokens alone; the port does not
  carry that over."""
  return hashlib.blake2b(b"adapter:" + adapter.encode(), digest_size=16).digest() if adapter else b""


def pages_to_cover(end_pos: int, page_size: int) -> int:
  """Pages a row needs so every position in ``[0, end_pos)`` maps to an
  allocated block-table entry. The scheduler's growth check runs this
  against the row's DISPATCH-time position, which under the lookahead
  pipeline already includes the in-flight chunk's advance, so a row always
  holds one extra chunk of page headroom."""
  return max((int(end_pos) + page_size - 1) // page_size, 0)


class PageAllocator:
  """Free-list + refcounted prefix cache over a fixed page pool. Page 0 is
  the trash page and is never handed out."""

  def __init__(self, n_pages: int, page_size: int):
    self.n_pages = n_pages
    self.page_size = page_size
    self._free: list[int] = list(range(n_pages - 1, 0, -1))  # pop() -> low ids first
    self._refs: dict[int, int] = {}  # page -> active readers (cached pages only)
    self._by_key: dict[bytes, int] = {}  # chain key -> cached page
    self._key_of: dict[int, bytes] = {}  # cached page -> chain key
    self._lru: OrderedDict[int, None] = OrderedDict()  # refcount-0 cached pages
    # Host KV tier spill hook (inference/kv_tier.py): called with the whole
    # batch of (chain_key, page) pairs an eviction run frees, BEFORE the
    # pages return to the free list, so the tier can copy them out first.
    self.spill_hook = None

  # ------------------------------------------------------------- allocation

  @property
  def n_free(self) -> int:
    """Pages on the free list (never-cached or evicted)."""
    return len(self._free)

  @property
  def n_available(self) -> int:
    """Free pages plus idle cached pages (evicted on demand)."""
    return len(self._free) + len(self._lru)

  def cached_keys(self) -> list[bytes]:
    """Chain keys currently device-cached, newest first (insertion order:
    donations append as requests finish) — the device half of the server's
    prefix advertisement; the host half lives in the KV tier."""
    return list(reversed(self._by_key))

  def alloc(self, n: int) -> list[int] | None:
    """n fresh private pages, evicting idle cached pages (oldest first) if
    needed; None if even eviction can't cover it (caller backpressures).
    Evictions run as one batch, so the spill hook's device gather and host
    copy are one operation, not one per page."""
    if n > self.n_available:
      return None
    if len(self._free) < n:
      self._evict(n - len(self._free))
    return [self._free.pop() for _ in range(n)]

  def free(self, pages: list[int]) -> None:
    """Return PRIVATE (never-cached) pages to the free list."""
    for p in pages:
      assert p not in self._key_of, f"page {p} is cached; use release()"
      self._free.append(p)

  def _evict(self, n: int) -> None:
    batch: list[tuple[bytes, int]] = []
    for _ in range(n):
      page, _ = self._lru.popitem(last=False)
      key = self._key_of.pop(page)
      del self._by_key[key]
      self._refs.pop(page, None)
      batch.append((key, page))
    if self.spill_hook is not None:
      # The hook's gather is enqueued on the compute stream before any later
      # dispatch can reuse these pages, so the copy reads the cached bytes.
      self.spill_hook(batch)
    self._free.extend(p for _, p in batch)

  # ----------------------------------------------------------- prefix cache

  @staticmethod
  def chain_keys(tokens, page_size: int, seed: bytes = b"") -> list[bytes]:
    """Cumulative content keys for each FULL page of ``tokens``: key i
    hashes key i-1 with page i's token ids (int64 bytes). ``seed`` starts
    the chain: the scheduler seeds an adapter row's chain with its adapter
    (``adapter_chain_seed``), so pages whose KV an adapter computed never
    serve another adapter's or the base model's rows."""
    return PageAllocator.chain_keys_extend([], tokens, page_size, seed)

  @staticmethod
  def chain_keys_extend(prev_keys: list[bytes], tokens, page_size: int, seed: bytes = b"") -> list[bytes]:
    """Extend a chain-key list over a LONGER token sequence, carrying the
    running hash forward from ``prev_keys[-1]`` (O(new tokens); ``seed``
    when there is none yet). ``prev_keys`` must be the chain of
    ``tokens[: len(prev_keys) * page_size]``. The release path uses it to
    donate a row's generated pages under the keys a later admission of the
    same stream computes."""
    arr = np.asarray(tokens, dtype=np.int64)  # normalize dtype: same ids -> same bytes
    keys = list(prev_keys)
    prev = keys[-1] if keys else seed
    for i in range(len(keys), len(arr) // page_size):
      prev = hashlib.blake2b(prev + arr[i * page_size : (i + 1) * page_size].tobytes(), digest_size=16).digest()
      keys.append(prev)
    return keys

  def lookup_prefix(self, keys: list[bytes]) -> list[int]:
    """Longest cached prefix; bumps each hit's refcount (caller must
    ``release`` every returned page exactly once)."""
    pages: list[int] = []
    for key in keys:
      page = self._by_key.get(key)
      if page is None:
        break
      self._refs[page] = self._refs.get(page, 0) + 1
      self._lru.pop(page, None)
      pages.append(page)
    return pages

  def release(self, page: int) -> None:
    """Drop one reader of a cached page; idle pages become evictable."""
    self._refs[page] -= 1
    if self._refs[page] <= 0:
      self._refs.pop(page)
      self._lru[page] = None

  def insert_cached(self, key: bytes, page: int) -> bool:
    """Donate a private page to the cache (refcount 0, evictable). Returns
    False (page NOT adopted — caller should ``free`` it) when the chain is
    already cached."""
    if key in self._by_key:
      return False
    self._by_key[key] = page
    self._key_of[page] = key
    self._lru[page] = None
    return True

  def is_cached(self, key: bytes) -> bool:
    """Whether ``key``'s page is device-cached (referenced or idle). A
    chain's suffix can outlive its evicted prefix in the LRU; the host
    restore stops its run at the first such key."""
    return key in self._by_key

  def adopt_restored(self, key: bytes, page: int) -> None:
    """Register a host-tier restore target as a CACHED page with one reader
    (the restoring request, which releases it exactly once like any
    ``lookup_prefix`` hit). The page was allocated private and written with
    the key's content, so later admissions share it at once."""
    if key in self._by_key:
      raise ValueError("restore raced an identical cached chain")
    self._by_key[key] = page
    self._key_of[page] = key
    self._refs[page] = 1

  def audit(self) -> dict:
    """Internal-consistency check: every pool page is in exactly one of
    {free, cached-idle (LRU), cached-referenced (prefix hits and restored
    pages), caller-held private}; the first three are visible here, so
    ``free + cached == n_pages - 1 - in_use`` must hold for the caller's
    private count."""
    free = set(self._free)
    assert len(free) == len(self._free), "double-freed page on the free list"
    cached = set(self._key_of)
    assert not (free & cached), f"pages both free and cached: {sorted(free & cached)}"
    lru = set(self._lru)
    reffed = set(self._refs)
    assert lru <= cached and reffed <= cached, "ref/LRU entry for a non-cached page"
    assert not (lru & reffed), "cached page both idle and referenced"
    assert lru | reffed == cached, "cached page neither idle nor referenced"
    assert all(n > 0 for n in self._refs.values()), "non-positive refcount survived release"
    assert len(self._by_key) == len(self._key_of), "key<->page maps diverged"
    assert 0 not in free | cached, "trash page 0 escaped into the pool"
    return {"free": len(free), "cached": len(cached), "lru": len(lru), "referenced": len(reffed)}


# ------------------------------------------------- decode-path dispatch
#
# Which batched decode attention a (batch, window, KV quant) point takes:
# - "kernel": K3 (csrc/paged_decode.cu) straight off the page pool;
# - "gather": the page windows gathered, then the plain attention;
# - "dense": the dense slot cache (models/decoder.py fused_batch_decode:
#   K2 with XOT_TPU_FLASH_DECODE=1, else the plain attention). Advisory:
#   honoured only where the layout is still free (the batched server under
#   XOT_TPU_PAGED=auto); inside a paged program it degrades to "kernel".
#   int4 KV has no dense layout in the table, so its rows never say "dense".
#
# Rows are (max_batch, max_context_tokens, kv_quant, path); None = any; the
# first row whose bounds cover the query wins. The reference's table is a
# TPU measurement and answers only on a TPU; on a CUDA device the port walks
# this one, measured by ``scripts/decode_paths.py`` at llama-3.2-1b's
# shapes: the captured batched decode chunk per token for each path, the
# median of the script's runs, a path other than "kernel" taking a point
# only where it beat "kernel" by more than both medians' spread (PERF.md §6).

_H100_DECODE_PATH_TABLE = (
  # Every measured point: B 1…64, windows 1024 / 4096 / 8192, bf16 / int8 /
  # int4 KV. K3 beat gather 1.3–18× and the dense cache's plain attention
  # 1.1–12.6× per token (B=64, window 8192, bf16: kernel 121.6, dense 1526.5,
  # gather 2092.7 µs/token; B=1, 1024, bf16: 3095.8 / 4076.4 / 4812.1) —
  # scripts/decode_paths.py, 7 replays of an 8-step chunk per path, NVIDIA
  # H100 80GB HBM3, 700.00 W. K2 on the dense cache (XOT_TPU_FLASH_DECODE=1,
  # off by default) ran 0.85–1.09× K3's time and is no verdict.
  (None, None, None, "kernel"),
)


def _table_match(table, batch: int, context: int, kv_quant: str):
  """First-row-wins walk of a (max_batch, max_context, quant, verdict)
  dispatch table."""
  for max_b, max_ctx, quant, verdict in table:
    if max_b is not None and batch > max_b:
      continue
    if max_ctx is not None and context > max_ctx:
      continue
    if quant is not None and quant != kv_quant:
      continue
    return verdict
  return table[-1][-1]


def _platform(device) -> str:
  """The reference's platform word for a torch device: "gpu" for CUDA,
  "cpu" otherwise."""
  if device is None:
    return "cpu"
  return "gpu" if getattr(device, "type", str(device).split(":")[0]) == "cuda" else "cpu"


def select_decode_path(batch: int, context: int, kv_quant: str = "", platform: str | None = None, device=None) -> str:
  """Pick the decode attention path for a (batch, context, quant) point:
  "gather" | "kernel" | "dense". ``context`` is the per-row KV window in
  tokens. ``XOT_TPU_PAGED_KERNEL=1`` forces "kernel", ``=0`` forces
  "gather" (the reference's forcing); otherwise a CPU device answers
  "gather", as the reference does off-TPU, and a CUDA device walks the H100
  table. ``platform`` ("cpu" / "gpu") overrides what ``device`` says."""
  forced = os.getenv("XOT_TPU_PAGED_KERNEL")
  if forced is not None:
    from ..utils.helpers import env_flag

    return "kernel" if env_flag("XOT_TPU_PAGED_KERNEL") else "gather"
  if (platform or _platform(device)) != "gpu":
    return "gather"
  return _table_match(_H100_DECODE_PATH_TABLE, batch, context, kv_quant)


def resolved_decode_path(batch: int, context: int, kv_quant: str = "", paged: bool = True, cfg=None, platform: str | None = None, device=None) -> str:
  """The decode path a dispatch actually runs, the label of
  ``decode_chunks_total{path=}``: "dense" for the dense layout; inside a
  paged program a "dense" verdict degrades to "kernel" and a config K3
  cannot serve (gemma2, MLA, ``XOT_TPU_PAGED_KERNEL=0``) pins "gather" —
  the resolution of the paged programs' ``use_kernel=None``
  (models/decoder.py ``paged_use_kernel``)."""
  if not paged:
    return "dense"
  path = select_decode_path(batch, context, kv_quant, platform=platform, device=device)
  if path == "gather":
    return "gather"
  if cfg is not None:
    from ..ops.paged import paged_kernel_supported

    if not paged_kernel_supported(cfg):
      return "gather"
  return "kernel"


# Mixed prefill+decode ticks (inference/batch_scheduler.py): a chunked
# prefill advances by a token-budgeted slice fused into the batched decode
# dispatch (models/decoder.py ``fused_mixed_paged_batch_decode``), so
# resident decode rows never stall for a whole prefill chunk. Every slice
# token delays every resident row's next token, while smaller slices stretch
# the prefilling request's TTFT over more ticks, so the budget follows the
# interactive class's fast-window ITL burn rate (orchestration/slo.py).
# Rows are (min_burn, fraction-of-cap); the first row whose bound covers the
# burn wins. ``burn=None`` (no ITL signal) with resident rows takes the
# half-cap hedge; with no residents the slice is the whole
# ``XOT_TPU_PREFILL_CHUNK``.
_MIXED_BUDGET_TABLE = (
  (4.0, 1 / 16),  # ITL budget burning >= 4x: minimum forward progress only
  (2.0, 1 / 8),
  (1.0, 1 / 4),  # burning at exactly budget: quarter-chunk slices
  (0.0, 1 / 2),  # healthy (or unmeasured) with residents: half-chunk hedge
)


def mixed_tick_enabled() -> bool:
  """``XOT_TPU_MIXED_TICK`` (default on): fuse chunked prefill into the
  batched decode dispatch. ``0`` restores the strictly alternating
  prefill-tick / decode-tick schedule."""
  return os.getenv("XOT_TPU_MIXED_TICK", "1") not in ("0", "false")


def select_mixed_budget(cap: int, burn: float | None, residents: int = 1, backlog: int = 1, floor: int = 16) -> int:
  """Prefill-token budget for one mixed tick. ``cap`` is
  ``XOT_TPU_PREFILL_CHUNK`` (the ceiling, and the idle verdict); ``burn``
  the interactive fast-window ITL burn rate (None = no signal);
  ``residents`` how many decode rows the slice delays; ``backlog`` how many
  admissions are mid-prefill. While ITL is not burning (burn < 1) a deeper
  backlog grows the slice toward the cap: smaller slices never reduce the
  total stall the backlog imposes, they only smooth it, while the queued
  prompts' TTFT grows with the tick count. ``XOT_TPU_MIXED_BUDGET``
  (tokens) pins the verdict, clamped to [1, cap]."""
  cap = max(int(cap), 1)
  forced = int(os.getenv("XOT_TPU_MIXED_BUDGET", "0") or 0)
  if forced > 0:
    return max(min(forced, cap), 1)
  if residents <= 0:
    return cap  # idle: nothing to protect, prefill at full chunk
  frac = _MIXED_BUDGET_TABLE[-1][1]
  if burn is not None:
    for bound, f in _MIXED_BUDGET_TABLE:
      if burn >= bound:
        frac = f
        break
  budget = int(cap * frac)
  if (burn is None or burn < 1.0) and backlog > 1:
    budget = min(budget * int(backlog), cap)
  return max(min(budget, cap), min(floor, cap))


# Per-row speculation policy (inference/batch_scheduler.py batched
# speculation): each greedy row carries an acceptance EWMA per proposer, and
# its draft depth walks this table at every settle, so neither "always
# speculate" nor "never" is hardwired. The thresholds are the reference's:
# with a draft about 4x cheaper than the target a round costs about
# gamma/4 + 1 target steps and yields 1 + acceptance·gamma tokens, so
# break-even acceptance sits near 0.25-0.35; demote below 0.30, deepen only
# above 0.55, hold in between. Interactive rows demote later: an accepted
# run cuts their inter-token latency even where throughput breaks even.
# Rows are (min_ewma, action); the first row whose bound covers the EWMA
# wins.
_SPEC_GAMMA_TABLE = (
  (0.55, "promote"),  # paying well: deepen by 1 toward gamma_max
  (0.30, "hold"),  # marginal: keep the depth (hysteresis band)
  (0.0, "demote"),  # not paying: halve toward the floor
)
_SPEC_DEMOTE_FLOOR = {"interactive": 0.15}  # class-specific demote bar


def spec_adapt_gamma(ewma: float | None, gamma: int, gamma_max: int, priority: str = "standard") -> int:
  """Next chunk's speculation depth for one row, from its acceptance EWMA.
  Depth 0 is plain decode; the policy never raises a depth from 0 (the
  scheduler's re-probe every ``XOT_TPU_SPEC_REPROBE`` plain chunks does)."""
  if ewma is None or gamma <= 0:
    return max(min(gamma, gamma_max), 0)
  demote_bar = _SPEC_DEMOTE_FLOOR.get(priority, _SPEC_GAMMA_TABLE[1][0])
  for bound, action in _SPEC_GAMMA_TABLE:
    if ewma >= bound:
      if action == "promote":
        return min(gamma + 1, gamma_max)
      if action == "hold" or (action == "demote" and ewma >= demote_bar):
        return min(gamma, gamma_max)
      return gamma // 2
  return gamma // 2


# Proposer preference for probes and switches: the n-gram proposer costs
# nothing to try (host dict lookups), so it is probed before a model draft.
SPEC_PROPOSERS = ("ngram", "model")


def spec_select_proposer(current: str, ewmas: dict, available: tuple, priority: str = "standard") -> tuple[str, int]:
  """Next (proposer, depth) for a row whose depth just reached 0 on
  ``current``. ``ewmas`` maps proposer -> this row's acceptance EWMA
  (absent = never measured). An untried alternative is probed at depth 1;
  a measured one only if its EWMA still clears the row's demote bar; else
  ``("plain", 0)`` until the scheduler's re-probe."""
  demote_bar = _SPEC_DEMOTE_FLOOR.get(priority, _SPEC_GAMMA_TABLE[1][0])
  for cand in SPEC_PROPOSERS:
    if cand == current or cand not in available:
      continue
    e = ewmas.get(cand)
    if e is None or e >= demote_bar:
      return cand, 1
  return "plain", 0


def spec_reprobe_proposer(ewmas: dict, available: tuple) -> str | None:
  """The proposer a re-probe round tries for one row: an unmeasured one
  first (in ``SPEC_PROPOSERS`` order), else the best measured EWMA; None
  when nothing is available."""
  best, best_e = None, -1.0
  for cand in SPEC_PROPOSERS:
    if cand not in available:
      continue
    e = ewmas.get(cand)
    if e is None:
      return cand
    if e > best_e:
      best, best_e = cand, e
  return best


def spec_worst_advance(n_rounds: int, gamma_max: int) -> int:
  """Worst-case tokens one spec chunk advances a row (every round fully
  accepted). Page growth and the context-window band run against it."""
  return int(n_rounds) * (int(gamma_max) + 1)


def ewma_update(prev: float | None, obs: float, alpha: float = 0.3) -> float:
  """One acceptance-EWMA step (the first observation seeds the average)."""
  obs = min(max(float(obs), 0.0), 1.0)
  return obs if prev is None else (1.0 - alpha) * float(prev) + alpha * obs
