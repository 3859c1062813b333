"""Continuous batching over the paged KV pool for single-node serving: a
fixed set of batch rows ("slots"), each holding one in-flight request.

Counterpart of the reference's ``inference/batch_scheduler.py`` as it
behaves with ``XOT_TPU_QOS=0 XOT_TPU_KV_TIER=0 XOT_TPU_SPEC_BATCH=0
XOT_TPU_MIXED_TICK=0`` and the paged layout:

- one page pool ``[L, P, Hkv, ps, kd]`` (ops/paged.py) with per-row block
  tables; page-aligned prompt prefixes are shared between requests through
  the allocator's content-keyed prefix cache (inference/paging.py);
- admission is batched: every request admissible at a chunk boundary
  prefills in one padded dispatch (``prefill_into_pages_many[_sampled]``),
  rows bucketed to a power of two;
- prompts longer than ``XOT_TPU_PREFILL_CHUNK`` tokens prefill in chunks
  with decode chunks between them;
- decode runs ``fused_paged_batch_decode`` chunks of ``XOT_TPU_BATCH_CHUNK``
  steps over all rows (per-row positions, temperature, top-k, active mask);
  K3 (csrc/paged_decode.cu) carries the attention on the card;
- the decode loop is a one-chunk-lookahead pipeline (default;
  ``XOT_TPU_SCHED_LOOKAHEAD=0`` is the synchronous tick): chunk N+1 is
  enqueued from chunk N's device-resident next token while chunk N's tokens
  copy into pinned host memory, and the settle waits on that copy's CUDA
  event off the event loop. Correctness is by drop-on-read: a row that
  finishes inside chunk N was decoded one extra chunk, whose tokens the
  host discards; page growth runs against dispatch-time positions, so the
  extra chunk never overflows a block table. Membership changes happen
  only at dispatch boundaries, and the pipeline drains whenever a waiting
  request could admit. Greedy streams are identical to the synchronous
  loop's.

All device work runs on the engine's single executor thread. Random draws
for sampling come from one generator per dispatch, seeded on the event-loop
thread by ``engine.split_key()``.

QoS, the KV tier, batched speculation, mixed ticks, LoRA, disaggregation,
drain and the dense batched layout are not ported yet; asking for one
explicitly raises ``NotImplementedError`` when the server is built, as does
a CUDA engine whose head dim K3 has no variant for (unless
``XOT_TPU_PAGED_KERNEL=0`` asks for the gather path).

Enable with ``XOT_TPU_BATCHED=1`` (orchestration/node.py routes full-model
prompts here). ``XOT_TPU_BATCH_SLOTS`` (default 4), ``XOT_TPU_BATCH_CHUNK``
(default 8), ``XOT_TPU_PAGE_SIZE`` (default 64), ``XOT_TPU_BATCH_PAGES``
(default: the dense bf16 budget in pages), ``XOT_TPU_BATCH_MAX_QUEUE``
(default 64) and ``XOT_TPU_BATCH_TOP_K_MAX`` (default 64) size it.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass, field

import numpy as np

from ..ops.paged import check_paged_kernel
from ..utils.helpers import DEBUG, env_flag
from .batch_ops import to_host_async
from .engine import PromptTooLongError, ServerOverloadedError
from .paging import PageAllocator, kv_cache_bytes, pages_to_cover
from .sched_admission import AdmissionControl, _Request

__all__ = ["BatchedServer", "_Request", "check_unported_knobs"]

PREFILL_BUCKET = 128


def _round_up(n: int, multiple: int) -> int:
  return ((n + multiple - 1) // multiple) * multiple


def check_unported_knobs() -> None:
  """Refuse an environment that explicitly asks for a batched-serving
  feature the port does not have yet, instead of serving without it."""
  asked = []
  if os.getenv("XOT_TPU_PAGED", "1").strip().lower() in ("0", "false", "auto"):
    asked.append("XOT_TPU_PAGED=%s (the dense batched layout)" % os.getenv("XOT_TPU_PAGED"))
  if os.getenv("XOT_TPU_SPEC_BATCH", "auto").strip().lower() not in ("auto", "", "0", "false", "no", "off"):
    asked.append("XOT_TPU_SPEC_BATCH (batched speculation)")
  for knob, what in (("XOT_TPU_KV_TIER", "the host KV tier"), ("XOT_TPU_MIXED_TICK", "mixed prefill+decode ticks"), ("XOT_TPU_QOS", "QoS admission")):
    if env_flag(knob):
      asked.append(f"{knob} ({what})")
  if asked:
    raise NotImplementedError(f"the PyTorch port's batched server does not have {', '.join(asked)} yet; unset these knobs or set them to 0")


@dataclass
class _Ready:
  """A host-prepared admission awaiting its batched prefill dispatch (or,
  mid-chunked-prefill, its NEXT chunk dispatch — ``prefix_len`` advances to
  the end of each completed chunk)."""

  req: _Request
  row: int
  pad_to: int  # this request's own padded suffix length (current chunk)
  prefix_len: int = 0
  shared_pages: list = field(default_factory=list)
  new_pages: list = field(default_factory=list)
  chain_keys: list = field(default_factory=list)
  chunk_end: int = 0  # 0 = the dispatch covers the full prompt; else the chunk's end position


@dataclass
class _Slot:
  req: _Request
  pos: int  # next cache slot to write (== tokens absorbed)
  generated: int = 0
  last_token: int = 0
  finished: bool = False
  cancelled: bool = False
  out_tokens: list = field(default_factory=list)
  # Reused read-only prefix pages, then the request's private pages, in
  # logical order; chain keys for every FULL prompt page (private ones are
  # donated to the prefix cache on finish).
  shared_pages: list = field(default_factory=list)
  pages: list = field(default_factory=list)
  chain_keys: list = field(default_factory=list)


@dataclass
class _Plan:
  """Dispatch-time snapshot for one decode chunk: who steps, who is
  page-starved, and each row's dispatch position (confirmed position plus
  the in-flight chunk's advance under lookahead)."""

  rows: list  # [(row, _Slot)] resident at dispatch
  active: np.ndarray  # [B] bool
  starved: set  # rows resident but skipped this chunk (page-starved)
  positions: np.ndarray  # [B] int32 dispatch positions
  deadlocked: bool = False  # every resident row starved, nothing finishing


@dataclass
class _Chunk:
  """One dispatched decode chunk, possibly still executing on the device:
  its tokens' host copy (valid once ``ready`` fires), the device-resident
  next token that seeds the next dispatch, and the dispatch-time plan."""

  toks: object  # host [B, chunk] int32 (pinned on the card), filled asynchronously
  ready: object  # torch.cuda.Event | None
  next_tok: object  # device [B, 1] int32 — chunk N+1's input token
  rows: list  # [(row, _Slot)] resident at dispatch
  active: np.ndarray  # [B] bool — rows that stepped in this chunk
  starved: frozenset
  chained: bool  # dispatched on top of an in-flight chunk


class BatchedServer:
  """Owns the slot pool and the decode loop for one engine."""

  def __init__(self, engine, n_slots: int | None = None, chunk: int | None = None, top_k: int | None = None, max_queue: int | None = None, lookahead: bool | None = None):
    check_unported_knobs()
    if engine.cfg is not None:
      check_paged_kernel(engine.cfg, engine.device)
    self.engine = engine
    self.ops = engine.batch_ops
    self.n_slots = self.ops.round_slots(n_slots or int(os.getenv("XOT_TPU_BATCH_SLOTS", "4")))
    self.chunk = chunk or int(os.getenv("XOT_TPU_BATCH_CHUNK", "8"))
    # Per-request top_k is honoured per row; ``k_max`` caps the candidates.
    self.k_max = top_k or int(os.getenv("XOT_TPU_BATCH_TOP_K_MAX", "64"))
    self.admission = AdmissionControl(max_queue=max_queue if max_queue is not None else int(os.getenv("XOT_TPU_BATCH_MAX_QUEUE", "64")))
    self.page_size = int(os.getenv("XOT_TPU_PAGE_SIZE", "64"))
    # Chunked prefill: a prompt longer than this many tokens prefills in
    # chunks with decode chunks between them. 0 disables.
    self.prefill_chunk = int(os.getenv("XOT_TPU_PREFILL_CHUNK", "2048"))
    self._prefilling: list[_Ready] = []  # admissions mid-chunked-prefill (rows reserved)
    self.allocator: PageAllocator | None = None
    self.block_tables: np.ndarray | None = None
    self.cache = None
    self.pages_per_row = 0
    self.max_seq = 0
    self.prefix_hit_pages = 0  # prompt pages served from the prefix cache
    self.slots: list[_Slot | None] = [None] * self.n_slots
    self._loop_task: asyncio.Task | None = None
    if lookahead is None:
      lookahead = env_flag("XOT_TPU_SCHED_LOOKAHEAD", default=True)
    self.lookahead = bool(lookahead)
    # Persistent per-row dispatch arrays, updated on admission / advance /
    # release.
    self._h_tokens = np.zeros((self.n_slots, 1), dtype=np.int32)
    self._h_positions = np.zeros((self.n_slots,), dtype=np.int32)
    self._h_temps = np.zeros((self.n_slots,), dtype=np.float32)
    self._h_top_ks = np.ones((self.n_slots,), dtype=np.int32)
    self._h_generated = np.zeros((self.n_slots,), dtype=np.int64)
    self._h_max_tokens = np.zeros((self.n_slots,), dtype=np.int64)
    self._h_occupied = np.zeros((self.n_slots,), dtype=bool)
    # Page availability as of the last admission pass: the lookahead drain
    # gate retries parked requests only when this grows.
    self._parked_avail_seen: int = -1

  # --------------------------------------------- admission-layer views

  @property
  def queue(self):
    return self.admission.queue

  @property
  def _parked(self):
    return self.admission.parked

  @property
  def _queued(self):
    return self.admission.queued

  @property
  def _cancelled_ids(self):
    return self.admission.cancelled_ids

  @property
  def _admitting(self):
    return self.admission.admitting

  # ------------------------------------------------------------- public API

  async def submit(self, request_id: str, tokens: np.ndarray, *, max_tokens: int, temp: float, top_k: int, eos_ids, emit) -> list:
    """Enqueue a request; resolves with its tokens when it finishes. Tokens
    stream out via ``emit(request_id, new_tokens, finished)`` as chunks
    complete. Raises ``ServerOverloadedError`` when the queue is full."""
    tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
    self.admission.admit()
    req = _Request(
      request_id=request_id, tokens=tokens, max_tokens=int(max_tokens), temp=float(temp), top_k=int(top_k),
      eos_ids=tuple(int(e) for e in eos_ids), emit=emit, future=asyncio.get_running_loop().create_future(),
    )
    await self.admission.enqueue(req)
    if self._loop_task is None or self._loop_task.done():
      self._loop_task = asyncio.create_task(self._run())
    return await req.future

  def cancel(self, request_id: str) -> None:
    """Stop a request (client gone): a resident row frees at the next chunk
    boundary; a queued request finishes at admission; a cancel racing a
    request mid-admission is remembered. Unknown ids are ignored."""
    for slot in self.slots:
      if slot is not None and slot.req.request_id == request_id:
        slot.cancelled = True
        return
    for r in self._prefilling:
      if r.req.request_id == request_id:
        self._cancelled_ids.add(request_id)  # settled at the next admission pass
        return
    queued = self._queued.get(request_id)
    if queued is not None and not queued.future.done():
      queued.max_tokens = 0  # admitted-then-finished immediately
      self._parked_avail_seen = -1  # a cancelled parked request settles at the next boundary
      return
    if request_id in self._admitting:
      self._cancelled_ids.add(request_id)

  def busy(self) -> bool:
    """Any work still resident, queued, parked, or mid-prefill?"""
    return any(s is not None for s in self.slots) or not self.queue.empty() or bool(self._parked) or bool(self._prefilling)

  def shutdown(self) -> None:
    """Stop the decode loop and drop the pool (model unload/reload).
    Callable from the engine's executor thread: the task cancel is
    marshalled onto the loop that owns it."""
    task = self._loop_task
    self._loop_task = None
    self.cache = None
    if task is not None and not task.done():
      task.get_loop().call_soon_threadsafe(task.cancel)

  # ---------------------------------------------------------------- pool

  def _ensure_cache(self) -> None:
    if self.cache is not None:
      return
    from ..models.decoder import kv_quant_mode

    eng = self.engine
    kv_quant = kv_quant_mode()
    self.max_seq = min(eng.max_seq_len, eng.cfg.max_seq_len)
    ps = self.page_size
    self.pages_per_row = pages_to_cover(self.max_seq, ps)
    # Default pool size: the dense bf16 layout's budget (n_slots full
    # windows) expressed in pages of the actual quant mode — int8 pages
    # hold ~1.9x, int4 ~3.6x the contexts at hd 64.
    per_dense = self.n_slots * self.pages_per_row
    if kv_quant:
      n_layers = eng._effective_shard.n_shard_layers
      dense_budget = n_layers * per_dense * ps * eng.cfg.n_kv_heads * 2 * eng.cfg.head_dim * 2
      per_dense = dense_budget // max(kv_cache_bytes(eng.cfg, n_layers, ps, kv_quant), 1)
    n_pages = int(os.getenv("XOT_TPU_BATCH_PAGES", "0")) or per_dense + 1
    self.allocator = PageAllocator(n_pages, ps)
    self.block_tables = np.zeros((self.n_slots, self.pages_per_row), dtype=np.int32)
    self.cache = self.ops.init_pool(n_pages, ps)

  def _page_window(self, end_pos: int) -> int:
    """Block-table width for a prefill covering ``[0, end_pos)``: pages
    needed, rounded up to a power of two and clamped to the row maximum."""
    need = pages_to_cover(end_pos, self.page_size)
    mp_used = 1
    while mp_used < need:
      mp_used *= 2
    return min(mp_used, self.pages_per_row)

  def _free_slot(self, taken: frozenset | set = frozenset()) -> int | None:
    for i, s in enumerate(self.slots):
      if s is None and i not in taken:
        return i
    return None

  # ------------------------------------------------------------- admission

  def _prepare(self, req: _Request, row: int, *, reserve: int = 0, others_active: bool = False) -> tuple[str, _Ready | None]:
    """Host-side admission of one request: validate and allocate pages.

    Returns ``("ready", _Ready)`` when the request awaits the batched
    prefill; ``("done", None)`` when it settled here (its future resolved:
    cancelled while queued, or failed validation); ``("park", None)`` when
    pages are scarce while other requests hold them (``req.page_demand``
    set; re-registered in ``_queued`` so a cancel still finds it).
    ``reserve`` pages are kept back for earlier parked requests."""
    self._queued.pop(req.request_id, None)
    shared_pages: list = []
    new_pages: list | None = None
    try:
      if req.max_tokens <= 0:  # cancelled while queued (or degenerate request)
        req.emit(req.request_id, [], True)
        if not req.future.done():
          req.future.set_result([])
        return "done", None
      S = int(req.tokens.shape[0])
      if S + 1 >= self.max_seq:
        raise PromptTooLongError(f"prompt of {S} tokens exceeds the {self.max_seq}-token context window")
      ps = self.page_size
      chain_keys = self.allocator.chain_keys(req.tokens, ps)
      # Reuse at most (S-1)//ps pages: at least one suffix token must run
      # through prefill to produce the last-position logits.
      shared_pages = self.allocator.lookup_prefix(chain_keys[: (S - 1) // ps])
      prefix_len = len(shared_pages) * ps
      need = pages_to_cover(S + 1, ps) - len(shared_pages)  # cover [0, S]: the first generated token
      new_pages = None if self.allocator.n_available - need < reserve else self.allocator.alloc(need)
      if new_pages is None:
        for p in shared_pages:
          self.allocator.release(p)
        shared_pages = []  # already released — the except handler must not release again
        if others_active or any(s is not None for s in self.slots):
          # Other requests are draining pages — park to retry at the next
          # chunk boundary, keeping arrival order.
          req.page_demand = need
          self._queued[req.request_id] = req
          return "park", None
        raise ServerOverloadedError(f"prompt of {S} tokens cannot fit the page pool even when idle")
      self.prefix_hit_pages += len(shared_pages)
      return "ready", _Ready(req=req, row=row, pad_to=0, prefix_len=prefix_len, shared_pages=shared_pages, new_pages=list(new_pages), chain_keys=chain_keys)
    except Exception as e:  # noqa: BLE001 — a failed request never blocks the pool
      for p in shared_pages:
        self.allocator.release(p)
      if new_pages:
        self.allocator.free(new_pages)
      if not req.future.done():
        req.future.set_exception(e)
      self._cancelled_ids.discard(req.request_id)
      return "done", None

  async def _admit_pending(self, woken: _Request | None = None) -> None:
    """Collect every admissible request — chunked-prefill continuations,
    then parked (page-starved) ones in arrival order, then the queue — and
    prefill them in one batched dispatch. ``woken`` is a request the idle
    wait already popped from the queue. Every still-unmet parked demand
    accumulates into ``reserve``: younger requests may only admit out of
    the surplus beyond it."""
    ready: list[_Ready] = []
    taken: set[int] = set()
    reserve = 0
    prefilling, self._prefilling = self._prefilling, []
    for r in prefilling:
      if r.req.request_id in self._cancelled_ids:
        self._cancelled_ids.discard(r.req.request_id)
        self._release_ready_pages(r)
        r.req.emit(r.req.request_id, [], True)
        if not r.req.future.done():
          r.req.future.set_result([])
        continue
      ready.append(r)
      taken.add(r.row)
    if woken is not None and (row := self._free_slot(taken)) is not None:
      status, r = self._prepare(woken, row)
      if status == "park":
        self._parked.append(woken)
      elif r is not None:
        ready.append(r)
        taken.add(row)
    scan = 0  # parked entries stay IN the deque while retried: a teardown during the dispatch still sees them
    while scan < len(self._parked) and (row := self._free_slot(taken)) is not None:
      req = self._parked[scan]
      status, r = self._prepare(req, row, reserve=reserve, others_active=bool(ready))
      if status == "park":
        reserve += req.page_demand
        scan += 1
        continue
      del self._parked[scan]
      if r is not None:
        ready.append(r)
        taken.add(row)
    while (row := self._free_slot(taken)) is not None and not self.queue.empty():
      req = self.queue.get_nowait()
      status, r = self._prepare(req, row, reserve=reserve, others_active=bool(ready))
      if status == "park":
        self._parked.append(req)
        break
      if r is not None:
        ready.append(r)
        taken.add(row)
    self._parked_avail_seen = self.allocator.n_available
    if ready:
      await self._dispatch(ready)

  def _chunk_ready(self, r: _Ready) -> None:
    """Set this dispatch's padded span, capping long prompts to one chunk:
    cover [prefix_len, chunk_end) only; the next admission pass dispatches
    the rest. The pad stays inside the row's logical window."""
    S = int(r.req.tokens.shape[0])
    cap = self.prefill_chunk
    if cap <= 0 or S - r.prefix_len <= cap:
      r.chunk_end = 0
      r.pad_to = min(_round_up(max(S - r.prefix_len, 1), PREFILL_BUCKET), self.max_seq - r.prefix_len)
      return
    r.chunk_end = r.prefix_len + cap
    r.pad_to = min(_round_up(cap, PREFILL_BUCKET), self.max_seq - r.prefix_len)

  def _release_ready_pages(self, r: _Ready) -> None:
    """Free a not-yet-finished admission's pages (cancel or failure)."""
    for p in r.shared_pages:
      self.allocator.release(p)
    if r.new_pages:
      self.allocator.free(r.new_pages)
    r.shared_pages, r.new_pages = [], []

  def _dispatch_groups(self, ready: list[_Ready]) -> list[list[_Ready]]:
    """Split admissions so every row in a group keeps ``prefix_len + S_pad
    <= max_seq`` (a row reusing a long cached prefix cannot share a
    dispatch with a fresh long prompt). Seeded longest-first, so a group's
    S_pad is its first member's pad_to; in practice one group."""
    groups: list[list[_Ready]] = []
    for r in sorted(ready, key=lambda x: x.pad_to, reverse=True):
      for g in groups:
        if r.prefix_len + g[0].pad_to <= self.max_seq:
          g.append(r)
          break
      else:
        groups.append([r])
    return groups

  async def _dispatch(self, ready: list[_Ready]) -> None:
    """Prefill prepared admissions, one device call per group, and emit
    their first tokens. A device failure fails every request of its group
    and releases their pages; the pool keeps serving."""
    for r in ready:
      self._chunk_ready(r)
      self._admitting.add(r.req.request_id)
    try:
      for group in self._dispatch_groups(ready):
        await self._dispatch_group(group)
    except BaseException as e:  # loop teardown mid-dispatch: no admitted future may leak unresolved
      for r in ready:
        self._admitting.discard(r.req.request_id)
        if not r.req.future.done():
          r.req.future.set_exception(RuntimeError(f"batched server shut down mid-admission: {e!r}"))
      raise

  def _row_bucket(self, K: int) -> int:
    """The admission batch rounded up to a power of two (capped at n_slots)."""
    kpad = 1
    while kpad < K:
      kpad *= 2
    return max(min(kpad, self.n_slots), K)

  async def _dispatch_group(self, group: list[_Ready]) -> None:
    eng = self.engine
    K = len(group)
    S_pad = max(r.pad_to for r in group)
    n_rows = self._row_bucket(K)
    tok = np.zeros((n_rows, S_pad), dtype=np.int32)
    prompt_lens = np.ones((n_rows,), dtype=np.int32)  # padding rows: prefix 0, prompt_len 1
    temps = np.zeros((n_rows,), dtype=np.float32)
    top_ks = np.ones((n_rows,), dtype=np.int32)
    for i, r in enumerate(group):
      # A chunked prefill covers [prefix_len, chunk_end) only; the final
      # chunk (chunk_end == 0) runs to the prompt's end and samples.
      end = r.chunk_end or int(r.req.tokens.shape[0])
      tok[i, : end - r.prefix_len] = r.req.tokens[r.prefix_len : end]
      prompt_lens[i] = end
      temps[i] = r.req.temp
      top_ks[i] = min(r.req.top_k, self.k_max)
    # The gathered window covers each row's padded write reach only; padding
    # rows keep an all-zero table (their writes land in the trash page).
    mp_used = self._page_window(max(int(r.prefix_len) for r in group) + S_pad)
    bts = np.zeros((n_rows, mp_used), dtype=np.int32)
    prefix_lens = np.zeros((n_rows,), dtype=np.int32)
    for i, r in enumerate(group):
      row_pages = (r.shared_pages + r.new_pages)[:mp_used]
      bts[i, : len(row_pages)] = row_pages
      prefix_lens[i] = r.prefix_len
    key = eng.split_key()  # on the event-loop thread; the executor only runs device work

    def run():
      firsts, self.cache = self.ops.prefill_into_pages_many_sampled(tok, self.cache, bts, prefix_lens, prompt_lens, self.page_size, temps, top_ks, self.k_max, key)
      return firsts.cpu().numpy()

    try:
      firsts = await asyncio.get_running_loop().run_in_executor(eng.executor, run)
    except Exception as e:  # noqa: BLE001
      for r in group:
        self._release_ready_pages(r)
        if not r.req.future.done():
          r.req.future.set_exception(e)
        self._cancelled_ids.discard(r.req.request_id)
      return
    finally:
      for r in group:
        self._admitting.discard(r.req.request_id)
    for i, r in enumerate(group):
      if r.chunk_end:  # intermediate chunk: advance and re-queue; no sample
        r.prefix_len = r.chunk_end
        self._prefilling.append(r)
        continue
      self._finish_admission(r, int(firsts[i]))

  def _finish_admission(self, r: _Ready, first: int) -> None:
    req = r.req
    slot = _Slot(
      req=req, pos=int(req.tokens.shape[0]), generated=1, last_token=first,
      shared_pages=r.shared_pages, pages=list(r.new_pages), chain_keys=r.chain_keys,
    )
    slot.out_tokens.append(first)
    cancelled = req.request_id in self._cancelled_ids  # raced during prefill
    finished = cancelled or first in req.eos_ids or slot.generated >= req.max_tokens
    slot.finished = finished
    req.emit(req.request_id, [] if cancelled else [first], finished)
    if finished:
      self._cancelled_ids.discard(req.request_id)
      self._release_pages(slot)
      if not req.future.done():
        req.future.set_result(slot.out_tokens)
      return
    self.slots[r.row] = slot
    self._h_occupied[r.row] = True
    self._h_tokens[r.row, 0] = first
    self._h_positions[r.row] = slot.pos
    self._h_temps[r.row] = req.temp
    self._h_top_ks[r.row] = min(req.top_k, self.k_max)
    self._h_generated[r.row] = slot.generated
    self._h_max_tokens[r.row] = req.max_tokens
    self.block_tables[r.row, :] = 0
    n = len(slot.shared_pages) + len(slot.pages)
    self.block_tables[r.row, :n] = slot.shared_pages + slot.pages

  # ----------------------------------------------------------- page lifecycle

  def _release_pages(self, slot: _Slot) -> None:
    """Return a finished slot's pages: shared prefix refs drop; private FULL
    prompt pages are donated to the prefix cache; the rest (the partial
    prompt tail and generated positions) free at once."""
    for p in slot.shared_pages:
      self.allocator.release(p)
    n_shared = len(slot.shared_pages)
    to_free = []
    for i, p in enumerate(slot.pages):
      logical = n_shared + i
      if logical < len(slot.chain_keys) and self.allocator.insert_cached(slot.chain_keys[logical], p):
        continue
      to_free.append(p)
    self.allocator.free(to_free)
    slot.shared_pages, slot.pages = [], []

  def _clear_row(self, row: int) -> None:
    """Reset a freed row's block table and dispatch arrays."""
    self.block_tables[row, :] = 0
    self._h_occupied[row] = False
    self._h_tokens[row, 0] = 0
    self._h_positions[row] = 0
    self._h_temps[row] = 0.0
    self._h_top_ks[row] = 1
    self._h_generated[row] = 0
    self._h_max_tokens[row] = 0

  def _grow_pages(self, row: int, slot: _Slot, pos: int) -> bool:
    """Ensure ``slot`` has pages covering the chunk dispatched at ``pos``
    (the dispatch-time position: under lookahead it includes the in-flight
    chunk's advance, so growth keeps one chunk of headroom)."""
    needed = pages_to_cover(pos + self.chunk, self.page_size)
    have = len(slot.shared_pages) + len(slot.pages)
    if needed <= have:
      return True
    got = self.allocator.alloc(needed - have)
    if got is None:
      return False
    self.block_tables[row, have : have + len(got)] = got
    slot.pages.extend(got)
    return True

  def _parked_admissible(self) -> bool:
    """Should the pipeline drain for the parked set? Only when page
    availability grew since the last admission pass looked (a shrink just
    moves the baseline)."""
    if not self._parked:
      return False
    avail = self.allocator.n_available
    if avail > self._parked_avail_seen:
      return True
    self._parked_avail_seen = avail
    return False

  # ----------------------------------------------------------------- decode

  def _plan_chunk(self, inflight: _Chunk | None) -> _Plan:
    """Snapshot the next chunk's dispatch state: confirmed slot state plus
    the in-flight chunk's advance. Cancelled rows and rows without cache
    room deactivate (they settle as finishes at this chunk's boundary);
    page-starved rows skip the chunk but stay resident. Under lookahead a
    row whose in-flight chunk reaches max_tokens is left out: the in-flight
    settle resolves it first."""
    spec = inflight.active if inflight is not None else None
    positions = self._h_positions.copy()
    generated = self._h_generated.copy()
    if spec is not None:
      positions[spec] += self.chunk
      generated[spec] += self.chunk
    active = self._h_occupied.copy()
    starved: set[int] = set()
    rows: list = []
    finishing = 0
    for i, s in enumerate(self.slots):
      if s is None:
        continue
      rows.append((i, s))
      if spec is not None and spec[i] and generated[i] >= self._h_max_tokens[i]:
        active[i] = False  # finishes at the in-flight settle; drop-on-read covers the rest
      elif s.cancelled or int(positions[i]) + self.chunk >= self.max_seq:
        active[i] = False
        finishing += 1
      elif not self._grow_pages(i, s, int(positions[i])):
        active[i] = False
        starved.add(i)
    deadlocked = inflight is None and bool(starved) and not active.any() and finishing == 0
    return _Plan(rows=rows, active=active, starved=starved, positions=positions, deadlocked=deadlocked)

  def _preempt_starved(self, plan: _Plan) -> None:
    """Every resident row is starved (none can run, and no finishing row is
    about to free pages): fail the youngest so the others make progress."""
    victim = min(plan.starved, key=lambda i: self.slots[i].generated)
    s = self.slots[victim]
    self._release_pages(s)
    self.slots[victim] = None
    self._clear_row(victim)
    if not s.req.future.done():
      s.req.future.set_exception(ServerOverloadedError("page pool exhausted with no runnable rows"))

  async def _dispatch_decode(self, plan: _Plan, inflight: _Chunk | None) -> _Chunk:
    """Enqueue one decode chunk and return its in-flight record without
    waiting for the device: the executor call only queues the chunk and
    the copy of its tokens into pinned host memory."""
    eng = self.engine
    # Chained dispatch: the input token is the in-flight chunk's
    # device-resident next token; a synchronous one uses the host arrays.
    tokens = inflight.next_tok if inflight is not None else self._h_tokens
    key = eng.split_key()

    def run():
      toks, next_tok, _pos, self.cache = self.ops.paged_batch_decode(
        tokens, self.cache, self.block_tables, plan.positions, plan.active, self._h_temps, self._h_top_ks,
        self.chunk, k_max=self.k_max, page_size=self.page_size, key=key,
      )
      host, ready = to_host_async(toks)
      return host, ready, next_tok

    host, ready, next_tok = await asyncio.get_running_loop().run_in_executor(eng.executor, run)
    return _Chunk(toks=host, ready=ready, next_tok=next_tok, rows=plan.rows, active=plan.active, starved=frozenset(plan.starved), chained=inflight is not None)

  async def _settle(self, record: _Chunk) -> None:
    """Read one chunk's tokens and run the host bookkeeping: emit,
    EOS/max_tokens/cancel finishes, page release. Under lookahead this runs
    while the next chunk computes. Rows that finished at an earlier settle
    (while this chunk was in flight) are dropped on read: their tokens
    here are overrun and never emitted, and their pages can only be
    re-granted to dispatches that run after this chunk on the one stream."""

    def fetch():
      if record.ready is not None:
        record.ready.synchronize()
      return record.toks.numpy()

    rows_host = await asyncio.get_running_loop().run_in_executor(self.engine.executor, fetch)
    for i, slot in record.rows:
      if slot.finished or self.slots[i] is not slot:
        continue  # drop-on-read: overrun tokens of a row settled earlier
      req = slot.req
      if i in record.starved:  # skipped this chunk; retried at the next dispatch
        continue
      if not record.active[i]:  # cache exhausted or cancelled at dispatch
        slot.finished = True
        self._cancelled_ids.discard(req.request_id)
        self._release_pages(slot)
        req.emit(req.request_id, [], True)
        if not req.future.done():
          req.future.set_result(slot.out_tokens)
        self.slots[i] = None
        self._clear_row(i)
        continue
      emit: list[int] = []
      done = False
      for t in rows_host[i]:
        t = int(t)
        emit.append(t)
        slot.generated += 1
        if t in req.eos_ids or slot.generated >= req.max_tokens:
          done = True
          break
      slot.out_tokens.extend(emit)
      slot.pos += len(emit)
      slot.last_token = emit[-1] if emit else slot.last_token
      self._h_positions[i] = slot.pos
      self._h_generated[i] = slot.generated
      self._h_tokens[i, 0] = slot.last_token
      req.emit(req.request_id, emit, done)
      if done:
        slot.finished = True
        self._cancelled_ids.discard(req.request_id)
        self._release_pages(slot)
        if not req.future.done():
          req.future.set_result(slot.out_tokens)
        self.slots[i] = None
        self._clear_row(i)

  async def _run(self) -> None:
    self._ensure_cache()
    inflight: _Chunk | None = None
    try:
      while True:
        if inflight is not None:
          # Drain the pipeline whenever a waiting request could admit, a
          # chunked prefill needs its next chunk, or lookahead is off. A
          # backlog with no free slot cannot admit, so the pipeline keeps
          # chaining at saturation.
          admissible = self._free_slot() is not None and (not self.queue.empty() or self._parked_admissible())
          if not self.lookahead or self._prefilling or admissible:
            await self._settle(inflight)
            inflight = None
            continue
        else:
          await self._admit_pending()
          if all(s is None for s in self.slots):
            if self._prefilling or self._parked:
              # A chunked prefill is mid-flight, or parked requests can now
              # retry with every slot free (each pass resolves at least one).
              continue
            req = await self.queue.get()  # idle: block on the queue
            await self._admit_pending(woken=req)
            continue
        plan = self._plan_chunk(inflight)
        if inflight is not None and (not plan.rows or not plan.active.any()):
          # Nothing would step: settle instead of spending a dead chunk.
          await self._settle(inflight)
          inflight = None
          continue
        if plan.deadlocked:
          self._preempt_starved(plan)
          continue
        prev, inflight = inflight, await self._dispatch_decode(plan, inflight)
        if prev is not None:
          await self._settle(prev)  # chunk N settles while chunk N+1 runs
    except asyncio.CancelledError:
      self._fail_all(RuntimeError("batched server shut down"))
      raise
    except Exception as e:  # noqa: BLE001 — fail every in-flight request loudly
      if DEBUG >= 1:
        import traceback

        traceback.print_exc()
      self.cache = None  # rebuilt at the next submit
      self._fail_all(e)

  def _fail_all(self, exc: Exception) -> None:
    for i, slot in enumerate(self.slots):
      if slot is not None and not slot.req.future.done():
        slot.req.future.set_exception(exc)
      self.slots[i] = None
      if self.block_tables is not None:
        self._clear_row(i)
    while self._prefilling:
      r = self._prefilling.pop()
      if not r.req.future.done():
        r.req.future.set_exception(exc)
    self.admission.fail_queued(exc)
