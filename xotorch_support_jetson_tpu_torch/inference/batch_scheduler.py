"""Continuous batching for single-node serving: a fixed set of batch rows
("slots"), each holding one in-flight request.

Counterpart of the reference's ``inference/batch_scheduler.py`` at its
defaults and in both of its layouts:

- the paged layout (default) keeps one page pool ``[L, P, Hkv, ps, kd]``
  (ops/paged.py) with per-row block tables; page-aligned prompt prefixes
  are shared between requests through the allocator's content-keyed
  prefix cache (inference/paging.py);
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
  loop's;
- admission runs through the QoS layer (inference/qos.py, ``XOT_TPU_QOS``,
  default on): priority classes with aging, weighted-fair tenants,
  per-tenant rate limits, deadline shedding, and an overload policy that
  sheds or preempts ``batch`` work before rejecting ``interactive``
  requests. A preempted row re-enqueues and resumes token-identically (its
  prompt absorbs the tokens generated so far; its KV comes back through the
  prefix cache and the host tier, or is recomputed);
  ``XOT_TPU_QOS=0`` is the plain FIFO queue;
- a host-RAM KV tier sits under the pool (inference/kv_tier.py,
  ``XOT_TPU_KV_TIER``, default on): pages evicted from the prefix LRU spill
  to a byte-budgeted host store, admission restores the longest
  host-resident chain run into fresh pages (copy-on-write), and finished
  and preempted rows donate their generated full pages too, under chain
  keys extended over the absorbed stream, so a preempted row resumes and a
  conversation's next turn starts by transfer instead of recompute.
  ``XOT_TPU_KV_TIER=0`` is the single-tier pool;
- while decode rows are resident, a chunked prefill advances by a
  token-budgeted slice fused into the decode dispatch
  (``fused_mixed_paged_batch_decode``: K1 for the slice, K3 for the decode
  half) instead of stalling every resident row for a whole prefill chunk
  (``XOT_TPU_MIXED_TICK``, default on). The budget follows the interactive
  class's ITL burn rate (inference/paging.py ``select_mixed_budget``;
  ``XOT_TPU_MIXED_BUDGET`` pins it); the final, sampling slice dispatches
  through the ordinary admission path. ``XOT_TPU_MIXED_TICK=0`` restores
  the strictly alternating schedule;
- ``XOT_TPU_PAGED=0`` (or ``false``) keeps the dense layout instead: one
  slot-cache row of the whole window per slot, admissions prefilled whole
  (no chunking, no prefix cache, no host tier, no mixed ticks) through
  ``prefill_into_slots_sampled``, each padding row on a distinct spare free
  slot, and decode chunks through ``fused_batch_decode`` (K2 with
  ``XOT_TPU_FLASH_DECODE=1``, K1 in its verify windows).
  ``XOT_TPU_PAGED=auto`` lets the decode-path table choose at pool build
  (inference/paging.py ``select_decode_path``: "dense" there picks the
  dense layout);
- greedy rows speculate by default (``XOT_TPU_SPEC_BATCH``,
  default ``auto``; only ``0`` and ``false`` turn it off, as in the
  reference): each row drafts from its own prompt+generated history
  (inference/ngram.py ``NgramIndex``, ``XOT_TPU_SPEC_NGRAM``, ``_NGRAM_N``,
  ``_NGRAM_MAX``), the target verifies every row's window in one forward
  per round (``fused_spec_paged_batch_decode``: K3 over the B·W window rows
  in one launch per layer; ``fused_spec_batch_decode`` on the dense cache),
  and each row advances by its accepted run plus one. With a draft loaded
  (``XOT_TPU_SPEC_DECODE=int8`` or ``XOT_TPU_SPEC_DRAFT``) greedy rows open
  on the "model" proposer instead: the draft proposes from its own slot
  cache, built with the pool (its bytes come out of the page budget;
  ``kv_draft_*`` gauges) and prefilled with each admission's whole prompt
  in the same executor call. Sampled rows run at depth 0. A per-row
  acceptance EWMA walks each row's depth (inference/paging.py
  ``spec_adapt_gamma``), so rows that stop paying fall back to plain
  chunks, or to another proposer; once every row is plain, a depth-1
  probe runs every ``XOT_TPU_SPEC_REPROBE`` plain chunks. Proposals key on
  settled history, so a chunk with n-gram rows never chains behind an
  in-flight one; a mixed tick takes precedence over speculation;
- with the engine's adapter registry built (``enable_multi_lora``,
  ``XOT_TPU_LORA_DIR``), each request may name an adapter (``submit``'s
  ``adapter``): admission pins its slot (inference/adapters.py; a cold
  adapter swaps in from the host tier), every prefill, plain, mixed and
  speculative dispatch carries each row's slot (``adapter_ids``; the mixed
  slice its own ``pf_adapter``), and every path a row leaves the pool by
  unpins it. The registry's slots come off the default page budget. An
  adapter row's prefix-cache chain is seeded with its adapter
  (inference/paging.py ``adapter_chain_seed``): pages are shared only
  between rows of one adapter (the reference shares them across adapters,
  which serves one adapter's K/V to another's rows);
- every latency it sees goes to utils/metrics.py (TTFT, inter-token
  latency, queue wait, chunk times) and, per QoS class, to the SLO engine
  (orchestration/slo.py, ``XOT_TPU_SLO``).

Every device dispatch is one program, as in the reference: the page pool
(or the slot cache, and the draft's cache with it) comes with its captured
programs (models/decoder.py ``BatchedPrograms``, through
inference/batch_ops.py), so on the card each admission prefill, draft
prefill and plain, mixed or speculative chunk is one CUDA-graph replay,
built at the first dispatch of its signature. The program ledger (utils/programs.py)
records them under the reference's families, and ``warmup_manifest`` /
``warmup`` (``POST /v1/warmup``) drive them before traffic — capturing the
graphs that traffic needs — and mark the ledger steady. A chained dispatch
takes the in-flight chunk's next token (and a spec chunk's positions) as
device-to-device fills of the next replay's inputs, and each chunk's host
copies are queued behind its replay, before the next one. The graphs go
with the pool (``shutdown``, a failed loop).

All device work runs on the engine's single executor thread. Random draws
for sampling come from the programs' generator, reseeded before each
dispatch with a key drawn on the event-loop thread by
``engine.split_key()``.

Multi-LoRA rows (inference/adapters.py) pin their adapter's slot at
admission; a cold adapter's install is queued on the executor thread ahead
of the admission's prefill, so the event loop never copies factors or
waits on the card. Disaggregation and drain over a ring are not ported
yet. A paged server on a CUDA engine whose head dim K3 has no variant for raises
``NotImplementedError`` (unless ``XOT_TPU_PAGED_KERNEL=0`` asks for the
gather path).

Enable with ``XOT_TPU_BATCHED=1`` (orchestration/node.py routes full-model
prompts here). ``XOT_TPU_BATCH_SLOTS`` (default 4), ``XOT_TPU_BATCH_CHUNK``
(default 8), ``XOT_TPU_PAGE_SIZE`` (default 64), ``XOT_TPU_BATCH_PAGES``
(default: the dense bf16 budget in pages), ``XOT_TPU_BATCH_MAX_QUEUE``
(default 64) and ``XOT_TPU_BATCH_TOP_K_MAX`` (default 64) size it.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..ops.paged import check_paged_kernel, paged_kernel_tile
from ..orchestration import slo
from ..utils.helpers import DEBUG, env_flag
from ..utils.metrics import FRACTION_BUCKETS, metrics
from ..utils.programs import ledger
from .batch_ops import to_host_async
from .engine import PromptTooLongError, ServerOverloadedError
from .kv_tier import KvTierManager, kv_tier_enabled, prefix_registry
from .ngram import NgramIndex, ngram_enabled, ngram_knobs
from .paging import (
  PageAllocator, adapter_chain_seed, ewma_update, kv_cache_bytes, lora_pages_equivalent, mixed_tick_enabled, pages_to_cover, resolved_decode_path, select_decode_path, select_mixed_budget,
  spec_adapt_gamma, spec_reprobe_proposer, spec_select_proposer, spec_worst_advance,
)
from .qos import DeadlineUnmeetableError
from .sched_admission import AdmissionControl, _Request

__all__ = ["BatchedServer", "_Request"]

PREFILL_BUCKET = 128
# Smallest pad of a mixed slice's prefill. K1 takes two or more query rows
# (one is a decode step), so a slice of 1 to 15 tokens (the last one before
# the final cap) pads to 16 where the window has room: every slice
# prefills through K1, at the shapes the card checks (16 to 2048). The pad
# rows are junk that ``touched_page_targets`` keeps out of the pool.
MIXED_MIN_PAD = 16

# spec_proposer{row} gauge encoding: 0 plain decode, 1 n-gram lookup, 2 a
# model draft (the reference's codes).
PROPOSER_CODE = {"plain": 0, "ngram": 1, "model": 2}


def _round_up(n: int, multiple: int) -> int:
  return ((n + multiple - 1) // multiple) * multiple


@dataclass
class _Ready:
  """A host-prepared admission awaiting its batched prefill dispatch (or,
  mid-chunked-prefill, its NEXT chunk dispatch — ``prefix_len`` advances to
  the end of each completed chunk or mixed slice)."""

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
  t_first: float = 0.0  # perf_counter at the first emitted token (goodput's realized ITL)
  # Batched speculation: the row's draft depth, its proposer ("model",
  # "ngram" or "plain"), its acceptance EWMA per proposer, and its n-gram
  # index over prompt+generated history (None for sampled rows or with the
  # family off).
  spec_gamma: int = 0
  spec_proposer: str = "plain"
  spec_ewmas: dict = field(default_factory=dict)
  ngram: object = None


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
  mixed: tuple | None = None  # (ready, start, end): a prefill slice fused into this dispatch
  gmax: int = 0  # > 0: dispatch the spec program at this depth cap


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
  t_dispatch: float = 0.0
  # The admission whose prefill slice rode this dispatch: its prefix_len
  # advances to mixed_end at the settle, never before, so a cancel or a
  # teardown while the chunk flies releases pages against the confirmed
  # prefix, and the slice's pages stay allocated until then.
  mixed_ready: object = None  # _Ready | None
  mixed_start: int = 0
  mixed_end: int = 0
  # Spec chunks advance each row by a variable count. ``worst`` is the
  # per-row worst case (the chunk size for a plain chunk), which the next
  # plan assumes while this chunk flies; ``counts`` and ``n_prop`` are host
  # copies behind ``ready`` (tokens valid per row, tokens proposed per row);
  # ``pos_dev`` is the device handle of the post-chunk positions that a
  # chained spec dispatch consumes.
  spec: bool = False
  worst: int = 0
  rounds: int = 0
  counts: object = None
  pos_dev: object = None
  gammas: np.ndarray | None = None  # [B] dispatched depths
  proposers: list | None = None  # [n_slots] "model" | "ngram" | "plain"
  n_prop: object = None


class BatchedServer:
  """Owns the slot pool and the decode loop for one engine."""

  def __init__(self, engine, n_slots: int | None = None, chunk: int | None = None, top_k: int | None = None, max_queue: int | None = None, lookahead: bool | None = None, qos=None, spec_batch: bool | None = None):
    # The layout: XOT_TPU_PAGED=0|false is the dense slot cache, "auto"
    # lets the decode-path table choose at pool build (_ensure_cache).
    self._paged_mode = os.getenv("XOT_TPU_PAGED", "1")
    self.paged = self._paged_mode not in ("0", "false")
    if engine.cfg is not None and self._paged_mode != "auto" and self.paged:
      check_paged_kernel(engine.cfg, engine.device)
    self.engine = engine
    self.ops = engine.batch_ops
    self.n_slots = self.ops.round_slots(n_slots or int(os.getenv("XOT_TPU_BATCH_SLOTS", "4")))
    self.chunk = chunk or int(os.getenv("XOT_TPU_BATCH_CHUNK", "8"))
    # Per-request top_k is honoured per row; ``k_max`` caps the candidates.
    self.k_max = top_k or int(os.getenv("XOT_TPU_BATCH_TOP_K_MAX", "64"))
    # ``qos``: None resolves from XOT_TPU_QOS (default on), False is the
    # FIFO queue, True or a QosPolicy instance turns it on.
    self.admission = AdmissionControl(
      n_slots=self.n_slots, max_queue=max_queue if max_queue is not None else int(os.getenv("XOT_TPU_BATCH_MAX_QUEUE", "64")), qos=qos,
    )
    self.page_size = int(os.getenv("XOT_TPU_PAGE_SIZE", "64"))
    # Chunked prefill: a prompt longer than this many tokens prefills in
    # chunks with decode chunks between them (or, under mixed ticks, in
    # budgeted slices fused into them). 0 disables.
    # The dense layout always prefills whole.
    self.prefill_chunk = int(os.getenv("XOT_TPU_PREFILL_CHUNK", "2048"))
    self.mixed = mixed_tick_enabled()
    # Batched speculation: ``spec_batch=None`` resolves from
    # XOT_TPU_SPEC_BATCH (default auto); the verdict lands in ``self.spec``
    # with the pool (``_ensure_cache``).
    self._spec_batch_arg = spec_batch
    self.spec = False
    self.spec_proposers: tuple = ()
    # The model draft's depth cap (the reference's XOT_TPU_SPEC_BATCH_GAMMA);
    # n-gram rows use ``spec_ngram_max``.
    self.spec_gamma_max = int(os.getenv("XOT_TPU_SPEC_BATCH_GAMMA", "0") or 0) or int(getattr(engine, "spec_gamma", 4))
    # Plain chunks between depth-1 re-probes once every row is plain (0: never).
    self.spec_reprobe = int(os.getenv("XOT_TPU_SPEC_REPROBE", "32"))
    self._spec_plain_chunks = 0
    self.spec_ngram_n, self.spec_ngram_max = ngram_knobs()
    # Host proposals staged by _spec_intent for the next dispatch (row ->
    # int32 stream), only ever with the pipeline drained.
    self._spec_props: dict | None = None
    self._spec_needs_host = False
    # Boundary-pass counter: groups one _admit_pending pass's admissions into
    # one observation of the deadline estimator's measured drain.
    self._admit_pass = 0
    self._prefilling: list[_Ready] = []  # admissions mid-chunked-prefill (rows reserved)
    self.allocator: PageAllocator | None = None
    self.tier: KvTierManager | None = None  # the host KV tier, built with the pool
    self.block_tables: np.ndarray | None = None
    self.cache = None
    self.draft_cache = None  # the draft's slot cache (the "model" proposer), built with the pool
    self.kv_quant: str | None = None
    self.decode_path = "dense"  # decode_chunks_total's path label, resolved with the pool
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
    self._h_adapters = np.zeros((self.n_slots,), dtype=np.int32)  # each row's adapter slot (0: base)
    # Page availability as of the last admission pass: the lookahead drain
    # gate retries parked requests only when this grows.
    self._parked_avail_seen: int = -1
    # When the last chunk's tokens reached the host (None until the first
    # settle / after idle): decode_chunk_seconds and sched_host_gap_seconds.
    self._t_last_ready: float | None = None

  # --------------------------------------------- admission-layer views

  @property
  def qos(self):
    return self.admission.qos

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

  async def submit(self, request_id: str, tokens: np.ndarray, *, max_tokens: int, temp: float, top_k: int, eos_ids, emit, priority: str = "standard", tenant: str = "default", deadline_ms: float | None = None, adapter: str | None = None) -> list:
    """Enqueue a request; resolves with its tokens when it finishes. Tokens
    stream out via ``emit(request_id, new_tokens, finished)`` as chunks
    complete. ``priority`` / ``tenant`` / ``deadline_ms`` feed the QoS layer
    (ignored with QoS off); ``adapter`` names a registered adapter (None:
    the base model). Raises ``ServerOverloadedError`` (or a QoS subclass
    carrying ``retry_after_ms``) when the request is refused; an unknown
    adapter fails the request with ``UnknownAdapterError`` at admission."""
    tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
    ticket = self.admission.admit(request_id, int(tokens.shape[0]), int(max_tokens), priority, tenant, deadline_ms)
    req = _Request(
      request_id=request_id, tokens=tokens, max_tokens=int(max_tokens), temp=float(temp), top_k=int(top_k),
      eos_ids=tuple(int(e) for e in eos_ids), emit=emit, future=asyncio.get_running_loop().create_future(),
      t_submit=time.perf_counter(), qos=ticket, adapter=adapter or None,
    )
    await self.admission.enqueue(req)
    self._update_gauges()
    if self._loop_task is None or self._loop_task.done():
      self._loop_task = asyncio.create_task(self._run())
    return await req.future

  def _preempt_victim_for(self, req) -> int | None:
    """Row of the resident slot a waiting ``req`` may preempt: the
    lowest-priority resident strictly below the waiter's class, ties broken
    by most generated. None when preemption is off or nothing outranked is
    resident."""
    if self.qos is None or not self.qos.cfg.preempt or req is None:
      return None
    ticket = getattr(req, "qos", None)
    if ticket is None:
      return None
    best = None
    for i, s in enumerate(self.slots):
      if s is None or s.finished or s.cancelled:
        continue
      if s.pos + 1 >= self.max_seq:
        # At the context window: it finishes imminently (freeing the slot
        # anyway), and its resume prompt could not re-admit.
        continue
      st = s.req.qos
      srank = st.rank if st is not None else 1
      if srank <= ticket.rank:
        continue
      key = (srank, s.generated)
      if best is None or key > best[0]:
        best = (key, i)
    return best[1] if best is not None else None

  def _extract_row(self, row: int, *, keep_kv: bool) -> _Request:
    """Pull a resident row out of the pool for a carry_tokens resume: its
    pages release now (donated under extended chain keys when ``keep_kv``,
    so the resume finds its whole stream as a prefix), its prompt absorbs
    the tokens generated so far, and ``carry_tokens`` carries the emitted
    span. Runs only at a dispatch boundary with the pipeline drained, so no
    in-flight chunk references the row."""
    s = self.slots[row]
    req = s.req
    self._release_pages(s, extend=keep_kv)
    self.slots[row] = None
    self._clear_row(row)
    new_toks = s.out_tokens[len(req.carry_tokens):]
    if new_toks:
      req.tokens = np.concatenate([req.tokens, np.asarray(new_toks, np.int32)])
    req.carry_tokens = list(s.out_tokens)
    req.max_tokens -= s.generated
    req.t_submit = 0.0  # queue wait and TTFT were observed at the first admission
    return req

  def _preempt_resume(self, row: int) -> None:
    """Preempt a resident row for higher-priority work and re-enqueue it at
    the front of its lane (not a failure): the resumed prefill continues the
    stream token-identically. With the KV tier on (and
    ``XOT_TPU_QOS_PREEMPT_SPILL``), the victim's prompt AND generated pages
    are donated under extended chain keys: the resume finds them as a
    prefix (device-cached, or restored from the host after a spill) and
    recomputes only the last partial page; ``carry_tokens`` stays the
    fallback when every copy is gone."""
    metrics.inc("qos_preemptions_total")
    keep_kv = self.tier is not None and self.qos.cfg.preempt_spill
    self.admission.requeue_resumed(self._extract_row(row, keep_kv=keep_kv))

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

  # ------------------------------------------------ warmup manifest

  def warmup_manifest(self) -> list[dict]:
    """The program families this configuration is expected to build, from
    its active facets (the reference's, on the port's one backend: paged
    or dense KV, with the sampling epilogue fused into the prefill). The
    layout under ``auto`` and the spec facet resolve with the pool, as in
    the reference."""
    fams: list[dict] = []

    def add(family: str, why: str) -> None:
      fams.append({"family": family, "why": why})

    if self.paged:
      add("prefill.pages_many_sampled", "paged batched prefill")
    else:
      add("prefill.slots_sampled", "dense batched prefill")
    if self.spec:
      add("spec.paged_batch" if self.paged else "spec.batch", "batched speculative decode (greedy rows)")
    if self.paged:
      add("decode.paged_batch", "paged batched decode")
      if self.mixed:
        add("decode.mixed_paged_batch", "mixed prefill+decode tick")
    else:
      add("decode.batch", "dense batched decode")
    return fams

  async def warmup(self) -> dict:
    """Build the manifest off the serving path (``POST /v1/warmup``): tiny
    synthetic requests through the real submit path — the same programs,
    shapes bucketed the same way — then mark the ledger steady, so any
    later build counts as a steady compile. Families the synthetic traffic
    cannot reach (the mixed tick needs a prefill arriving mid-decode) are
    reported ``warmed: false``."""
    manifest = self.warmup_manifest()
    before = ledger.dispatch_counts()
    before_c = {f["family"]: ledger.compile_count(f["family"]) for f in manifest}
    t0 = time.perf_counter()
    errors: list[str] = []

    def sink(_rid, _toks, _fin) -> None:
      return None

    async def one(tag: str, temp: float) -> None:
      try:
        await self.submit(
          f"_warmup-{tag}-{id(self):x}", np.ones((4,), dtype=np.int32),
          max_tokens=max(int(self.chunk), 1) + 1, temp=temp, top_k=5 if temp > 0 else 0, eos_ids=(), emit=sink,
        )
      except Exception as e:  # noqa: BLE001 — warmup must never take the API down
        errors.append(f"{tag}: {e!r}")

    await one("sampled", 0.7)
    if self.spec:
      await one("greedy", 0.0)  # spec programs dispatch for greedy rows only
    total_s = time.perf_counter() - t0
    after = ledger.dispatch_counts()
    fams = ledger.snapshot()["families"]
    per_family_s: dict[str, float] = {}
    for entry in manifest:
      fam = entry["family"]
      entry["warmed"] = after.get(fam, 0) > before.get(fam, 0) or ledger.compile_count(fam) > before_c.get(fam, 0)
      if fam in fams:
        per_family_s[fam] = fams[fam]["compile_s"]
    ledger.note_warmup(manifest, per_family_s, total_s)
    ledger.mark_steady(manifest)
    return {"manifest": manifest, "warmup_s": round(total_s, 6), "steady": True, "errors": errors}

  def shutdown(self) -> None:
    """Stop the decode loop and drop the pool (model unload/reload).
    Callable from the engine's executor thread: the task cancel is
    marshalled onto the loop that owns it."""
    task = self._loop_task
    self._loop_task = None
    self._drop_pool()
    if self.tier is not None:
      # A model swap invalidates the host copies: chain keys hash token ids,
      # not weights, so the same chain must not restore the old model's KV.
      self.tier.clear()
    if task is not None and not task.done():
      task.get_loop().call_soon_threadsafe(task.cancel)

  # ---------------------------------------------------------- multi-LoRA

  def _lora_active(self) -> bool:
    """Adapter-aware serving applies: the engine built its registry
    (``enable_multi_lora``) and the backend's programs take the per-row
    slots."""
    return self.ops.lora_supported() and getattr(self.engine, "adapter_registry", None) is not None

  def _lora_acquire(self, req: _Request) -> None:
    """Resolve (and pin) the request's named adapter to a device slot at
    admission: a cold adapter is a host restore or a checkpoint load (a
    swap, in ``lora_swap_seconds``), never a new graph. An unknown name
    raises the client-error type, a fully pinned slot set the retryable
    overload type; both fail the request through ``_prepare``'s failure
    path, its pages released."""
    if not req.adapter:
      req.adapter_slot = 0
      return
    from .adapters import check_known

    reg = self.engine.adapter_registry if self._lora_active() else None
    check_known(reg, req.adapter)
    req.adapter_slot = reg.acquire(req.adapter, holder=req.request_id)
    req.adapter_install = reg.pending_install(req.adapter_slot)  # queued on the executor: read by the prefill

  def _lora_unpin(self, req: _Request | None) -> None:
    """Drop the request's slot pin (idempotent): called on every path a row
    leaves the pool by (finish, cancel, preemption, failure, teardown), so
    the registry's LRU never reassigns a slot a resident row still indexes,
    and a departed row never pins one for good."""
    if req is None or not req.adapter:
      return
    reg = getattr(self.engine, "adapter_registry", None)
    if reg is not None:
      reg.unpin(req.request_id)

  def _lora_kw(self, rows: np.ndarray) -> dict:
    """``adapter_ids=`` of a dispatch (a copy of ``rows``) while the engine
    holds a registry, else nothing: base serving's dispatches stay as they
    were."""
    return {"adapter_ids": np.array(rows, dtype=np.int32)} if self._lora_active() else {}

  # ---------------------------------------------------------------- pool

  def _ensure_cache(self) -> None:
    if self.cache is not None:
      return
    from ..models.decoder import kv_quant_mode

    eng = self.engine
    kv_quant = kv_quant_mode(eng.cfg)
    self.max_seq = min(eng.max_seq_len, eng.cfg.max_seq_len)
    if self._paged_mode == "auto":
      # The layout from the decode-path table: "dense" at this pool's
      # (slots, window, quant) point means the slot cache beats both paged
      # paths there (never on the CPU, which answers "gather").
      self.paged = select_decode_path(self.n_slots, self.max_seq, kv_quant, device=eng.device) != "dense"
      if self.paged:
        check_paged_kernel(eng.cfg, eng.device)
    # Batched speculation verdict, the reference's parse: only "0" and
    # "false" turn it off. It needs the resolved layout (an MLA model's
    # paged server does not speculate, as the reference's does not: no
    # verify window over latent pages; its dense one does) and lands before
    # the pool is sized, so the draft cache's bytes enter the page budget.
    want = self._spec_batch_arg if self._spec_batch_arg is not None else os.getenv("XOT_TPU_SPEC_BATCH", "auto") not in ("0", "false")
    proposers = []
    if self.ops.spec_supported():
      proposers.append("model")
    if ngram_enabled() and self.ops.spec_ngram_supported():
      proposers.append("ngram")
    self.spec = bool(want) and bool(proposers) and not (self.paged and eng.cfg.is_mla)
    self.spec_proposers = tuple(proposers) if self.spec else ()
    ps = self.page_size
    draft_pages_equiv = 0
    if self.spec and "model" in self.spec_proposers:
      cfg_d, shard_d = self.ops.draft_geometry()
      draft_bytes = kv_cache_bytes(cfg_d, shard_d.n_shard_layers, self.n_slots * self.max_seq, "")
      page_bytes = max(kv_cache_bytes(eng.cfg, eng._effective_shard.n_shard_layers, ps, kv_quant), 1)
      draft_pages_equiv = -(-draft_bytes // page_bytes)
      metrics.set_gauge("kv_draft_bytes", draft_bytes)
      metrics.set_gauge("kv_draft_slots", self.n_slots)
      metrics.set_gauge("kv_draft_pages_equivalent", draft_pages_equiv)
    elif self.spec:
      # The n-gram proposer holds no device state: the gauges read 0 and
      # the page budget stays whole.
      for name in ("kv_draft_bytes", "kv_draft_slots", "kv_draft_pages_equivalent"):
        metrics.set_gauge(name, 0)
    if self.paged:
      self.pages_per_row = pages_to_cover(self.max_seq, ps)
      # Default pool size: the dense bf16 layout's budget (n_slots full
      # windows) expressed in pages of the actual quant mode — int8 pages
      # hold ~1.9x, int4 ~3.6x the contexts at hd 64.
      per_dense = self.n_slots * self.pages_per_row
      if kv_quant:
        n_layers = eng._effective_shard.n_shard_layers
        dense_budget = n_layers * per_dense * ps * eng.cfg.cache_kv_heads * (eng.cfg.cache_k_dim + eng.cfg.cache_v_dim) * 2
        per_dense = dense_budget // max(kv_cache_bytes(eng.cfg, n_layers, ps, kv_quant), 1)
      if draft_pages_equiv:
        # The draft cache rides in the same budget (floored at one row's
        # window); an explicit XOT_TPU_BATCH_PAGES is the operator's own.
        per_dense = max(per_dense - draft_pages_equiv, self.pages_per_row + 1)
      if self._lora_active():
        # So do the registry's adapter slots, allocated up front: their
        # bytes in pages come off the default pool, with the same floor.
        page_bytes = max(kv_cache_bytes(eng.cfg, eng._effective_shard.n_shard_layers, ps, kv_quant), 1)
        lora_pages = lora_pages_equivalent(eng.adapter_registry.device_bytes(), page_bytes)
        if lora_pages:
          per_dense = max(per_dense - lora_pages, self.pages_per_row + 1)
      n_pages = int(os.getenv("XOT_TPU_BATCH_PAGES", "0")) or per_dense + 1
      self.allocator = PageAllocator(n_pages, ps)
      self.block_tables = np.zeros((self.n_slots, self.pages_per_row), dtype=np.int32)
      self.cache = self.ops.init_pool(n_pages, ps)
      if self.tier is None and kv_tier_enabled():
        self.tier = KvTierManager.from_env(page_size=ps, read_pages=self._tier_read, write_pages=self._tier_write)
      if self.tier is not None:
        # Rewired onto every (re)built allocator: device evictions spill their
        # pages host-side before the free list reuses them.
        self.allocator.spill_hook = self.tier.spill
        self.tier.kv_quant = kv_quant
      metrics.set_gauge("page_pool_pages_total", n_pages - 1)  # page 0 is the trash page
    else:
      self.cache = self.ops.init_cache(self.n_slots, self.max_seq)
    if self.spec and "model" in self.spec_proposers:
      self.draft_cache = self.ops.init_draft_cache(self.n_slots, self.max_seq)
    self.kv_quant = kv_quant
    window = self.pages_per_row * ps if self.paged else self.max_seq
    self.decode_path = resolved_decode_path(self.n_slots, window, kv_quant, paged=self.paged, cfg=eng.cfg, device=eng.device)
    metrics.set_gauge("paged_kernel_tile", paged_kernel_tile(eng.cfg, self.n_slots, window, ps, eng.device) if self.decode_path == "kernel" else 0)
    metrics.set_gauge("kv_quant_bits", {"": 16, "int8": 8, "int4": 4}[kv_quant])
    self._update_gauges()

  def _drop_pool(self) -> None:
    """Let the pool (or slot cache) go, the draft cache and the captured
    programs with it."""
    if self.cache is not None:
      self.ops.drop_pool(self.cache)
    self.cache = None
    self.draft_cache = None

  def _tier_read(self, pages: list[int]):
    """The tier's spill-side read: start the pages' copy to the host. (None,
    None) when the pool is already torn down (a shutdown racing an
    eviction): the tier degrades to plain eviction."""
    if self.cache is None:
      return None, None
    return self.ops.read_pages(self.cache, pages)

  def _tier_write(self, pages: list[int], data: dict) -> None:
    """The tier's restore-side write into freshly allocated pages, in place;
    runs at admission, before the prefill that reads them is enqueued."""
    if self.cache is None:
      raise RuntimeError("page pool torn down under a restore")
    self.cache = self.ops.write_pages(self.cache, pages, data)

  def prefix_hexes(self, limit: int = 512) -> list[str]:
    """Chain-key hexes this server can serve as a prefix hit: the device
    prefix cache first (newest donations first), then the host tier's
    entries. Per server, unlike the process-wide ``prefix_registry``."""
    keys: list[bytes] = []
    seen: set[bytes] = set()
    for source in (self.allocator.cached_keys() if self.allocator is not None else [], self.tier.host_keys() if self.tier is not None else []):
      for k in source:
        if k not in seen:
          seen.add(k)
          keys.append(k)
    return [k.hex() for k in keys[:limit]]

  def _update_gauges(self) -> None:
    """Scheduler health gauges, refreshed at every loop boundary."""
    metrics.set_gauge("scheduler_batch_occupancy", sum(1 for s in self.slots if s is not None))
    metrics.set_gauge("scheduler_queue_depth", self.admission.waiting())
    metrics.set_gauge("scheduler_parked", len(self._parked))
    metrics.set_gauge("scheduler_prefilling", len(self._prefilling))
    metrics.set_gauge("scheduler_slots_total", self.n_slots)
    if self.allocator is not None:
      total = max(self.allocator.n_pages - 1, 1)
      metrics.set_gauge("page_pool_pages_free", self.allocator.n_free)
      metrics.set_gauge("page_pool_pages_cached", self.allocator.n_available - self.allocator.n_free)
      metrics.set_gauge("page_pool_utilization", round(1.0 - self.allocator.n_available / total, 6))
    if self.qos is not None:
      for cls, depth in self.queue.class_depths().items():
        metrics.set_gauge("qos_queue_depth", depth, labels={"class": cls})

  def _page_window(self, end_pos: int) -> int:
    """Block-table width for a prefill covering ``[0, end_pos)``: pages
    needed, rounded up to a power of two and clamped to the row maximum.
    The one bucketing the admission dispatch and the mixed slice share."""
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
    cancelled while queued, deadline expired, or failed validation);
    ``("park", None)`` when pages are scarce while other requests hold them
    (``req.page_demand`` set; re-registered in ``_queued`` so a cancel
    still finds it). ``reserve`` pages are kept back for earlier parked
    requests."""
    self._queued.pop(req.request_id, None)
    shared_pages: list = []
    new_pages: list | None = None
    try:
      if req.max_tokens <= 0:  # cancelled while queued (or degenerate request)
        req.emit(req.request_id, [], True)
        if not req.future.done():
          req.future.set_result([])
        return "done", None
      if self.qos is not None and req.qos is not None and not req.carry_tokens and self.qos.deadline_expired(req.qos):
        # The deadline lapsed while the request waited: shed it instead of
        # spending a prefill on a response its client has given up on. A
        # resumed request (carry tokens) is mid-stream and exempt.
        self.qos.refund(req.qos.tenant, int(req.tokens.shape[0]))  # never ran
        metrics.inc("qos_shed_total", labels={"reason": "deadline"})
        slo.note_bad(req.qos.priority, "shed")
        raise DeadlineUnmeetableError(
          f"deadline {req.qos.deadline_ms:.0f} ms expired while queued",
          retry_after_ms=self.qos.retry_after_ms(self.admission.waiting(), self.n_slots),
        )
      S = int(req.tokens.shape[0])
      if S + 1 >= self.max_seq:
        if req.carry_tokens:
          # A resumed row whose absorbed stream reached the context window
          # finishes with what it already streamed (a "length" finish).
          req.emit(req.request_id, [], True)
          if not req.future.done():
            req.future.set_result(list(req.carry_tokens))
          return "done", None
        raise PromptTooLongError(f"prompt of {S} tokens exceeds the {self.max_seq}-token context window")
      if not self.paged:
        # A slot row holds the whole window: nothing to allocate. pad_to is
        # set per dispatch by _chunk_ready.
        self._lora_acquire(req)
        self._note_admitted(req)
        return "ready", _Ready(req=req, row=row, pad_to=0)
      ps = self.page_size
      chain_keys = self.allocator.chain_keys(req.tokens, ps, adapter_chain_seed(req.adapter))
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
          if not req.t_parked:
            req.t_parked = time.perf_counter()
          metrics.inc("scheduler_parked_total")
          return "park", None
        raise ServerOverloadedError(f"prompt of {S} tokens cannot fit the page pool even when idle")
      new_pages = list(new_pages)
      if self.tier is not None and new_pages:
        # Host-tier restore: extend the device prefix hit with the longest
        # host-resident chain run. The leading fresh pages become restore
        # targets (written, then adopted as cached read-only prefix pages;
        # the host copies stay) and the prefill skips those tokens too.
        run = self.tier.host_run(chain_keys, len(shared_pages), (S - 1) // ps)
        # Pages evict in chain order, so a chain's suffix can outlive its
        # evicted prefix in the device LRU: stop the run at the first key
        # still device-cached (adopt_restored needs the key absent); those
        # tokens recompute and re-link the chain.
        for j, key in enumerate(run):
          if self.allocator.is_cached(key):
            run = run[:j]
            break
        if run:
          dest = new_pages[: len(run)]
          try:
            self.tier.restore_into(run, dest)
          except Exception as e:  # noqa: BLE001 — a failed restore recomputes the prefill, counted
            metrics.inc("kv_tier_restore_failures_total", labels={"error": type(e).__name__})
          else:
            for key, page in zip(run, dest):
              self.allocator.adopt_restored(key, page)
            shared_pages = shared_pages + dest
            del new_pages[: len(run)]
            prefix_len = len(shared_pages) * ps
        nxt = len(shared_pages)
        if nxt < (S - 1) // ps and prefix_registry.locate(chain_keys[nxt]):
          # Neither tier holds the next link, but a peer advertises it.
          metrics.inc("kv_prefix_registry_hits_total", labels={"scope": "remote"})
      self.prefix_hit_pages += len(shared_pages)
      if shared_pages:
        metrics.inc("prefix_cache_hit_pages_total", len(shared_pages))
      self._lora_acquire(req)  # pin the adapter's slot; a failure releases the pages below
      self._note_admitted(req)
      return "ready", _Ready(req=req, row=row, pad_to=0, prefix_len=prefix_len, shared_pages=shared_pages, new_pages=new_pages, chain_keys=chain_keys)
    except Exception as e:  # noqa: BLE001 — a failed request never blocks the pool
      for p in shared_pages:
        self.allocator.release(p)
      if new_pages:
        # Still-private fresh pages (adopted restore targets moved into
        # shared_pages and were released above).
        self.allocator.free(new_pages)
      if not req.future.done():
        req.future.set_exception(e)
      if not isinstance(e, DeadlineUnmeetableError):
        metrics.inc("scheduler_admission_failures_total")  # deadline sheds are counted in qos_shed_total
      self._cancelled_ids.discard(req.request_id)
      return "done", None

  def _note_admitted(self, req: _Request) -> None:
    metrics.inc("scheduler_admissions_total")
    if self.qos is not None:
      # The deadline estimator's measured admission cadence: only gaps taken
      # while work was still waiting count; the pass id groups this
      # boundary's batch into one observation.
      self.qos.note_admission(waiting=self.admission.waiting(), pass_id=self._admit_pass)
    if req.t_submit:
      metrics.observe_hist("queue_wait_seconds", time.perf_counter() - req.t_submit)
    req.t_parked = 0.0

  async def _admit_pending(self, woken: _Request | None = None) -> None:
    """Collect every admissible request — chunked-prefill continuations,
    then parked (page-starved) ones in arrival order, then the queue — and
    prefill them in one batched dispatch. ``woken`` is a request the idle
    wait already popped from the queue. Every still-unmet parked demand
    accumulates into ``reserve``: younger requests may only admit out of
    the surplus beyond it. Under QoS, a waiting request that outranks a
    resident row preempts it (one victim per boundary); under mixed ticks,
    admissions whose remaining prompt exceeds one final slice stage into
    ``_prefilling`` for the decode dispatches to slice."""
    self._admit_pass += 1
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
    if self.qos is not None and not self.queue.empty() and self._free_slot(taken) is None:
      # Overload policy: a waiting request that outranks a resident row
      # preempts it (the row re-enqueues and resumes token-identically)
      # instead of queueing behind it.
      victim = self._preempt_victim_for(self.queue.peek())
      if victim is not None:
        self._preempt_resume(victim)
    while (row := self._free_slot(taken)) is not None and not self.queue.empty():
      req = self.queue.get_nowait()
      status, r = self._prepare(req, row, reserve=reserve, others_active=bool(ready))
      if status == "park":
        self._parked.append(req)
        break
      if r is not None:
        ready.append(r)
        taken.add(row)
    if self.allocator is not None:
      self._parked_avail_seen = self.allocator.n_available
    if ready and self._mixed_active() and any(s is not None for s in self.slots):
      # The budget sees the pass's full depth, or the first deferral would
      # be sized for a backlog of one.
      budget = self._mixed_budget(backlog=max(len(ready), 1))
      still: list[_Ready] = []
      for r in ready:
        if self._mixed_defer(r, budget):
          self._prefilling.append(r)
        else:
          still.append(r)
      ready = still
    if ready:
      await self._dispatch(ready)

  def _chunk_ready(self, r: _Ready) -> None:
    """Set this dispatch's padded span, capping long prompts to one chunk
    (paged layout): cover [prefix_len, chunk_end) only; the next admission
    pass dispatches the rest. The dense layout prefills whole (its program
    has no resume offset). The pad stays inside the row's logical
    window."""
    S = int(r.req.tokens.shape[0])
    cap = self.prefill_chunk
    if not self.paged or cap <= 0 or S - r.prefix_len <= cap:
      r.chunk_end = 0
      r.pad_to = min(_round_up(max(S - r.prefix_len, 1), PREFILL_BUCKET), self.max_seq - r.prefix_len)
      return
    r.chunk_end = r.prefix_len + cap
    r.pad_to = min(_round_up(cap, PREFILL_BUCKET), self.max_seq - r.prefix_len)

  def _release_ready_pages(self, r: _Ready) -> None:
    """Free a not-yet-finished admission's pages and adapter pin (cancel or
    failure)."""
    self._lora_unpin(r.req)
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
        await self._dispatch_group(group, all_rows={r.row for r in ready})
    except BaseException as e:  # loop teardown mid-dispatch: no admitted future may leak unresolved
      for r in ready:
        self._admitting.discard(r.req.request_id)
        self._lora_unpin(r.req)  # in neither the slots nor _prefilling: _fail_all would miss the pin
        if not r.req.future.done():
          r.req.future.set_exception(RuntimeError(f"batched server shut down mid-admission: {e!r}"))
      raise

  def _row_bucket(self, K: int) -> int:
    """The admission batch rounded up to a power of two (capped at n_slots)."""
    kpad = 1
    while kpad < K:
      kpad *= 2
    return max(min(kpad, self.n_slots), K)

  async def _dispatch_group(self, group: list[_Ready], all_rows: set[int]) -> None:
    eng = self.engine
    K = len(group)
    S_pad = max(r.pad_to for r in group)
    n_rows = self._row_bucket(K)
    spare: list[int] = []
    if not self.paged:
      # Dense padding rows write junk into a real slot row, so each takes a
      # distinct spare free slot (never one another admission owns: index
      # writes between duplicates are undefined). Without enough spares the
      # batch stays nearer exact-K.
      spare = [i for i, s in enumerate(self.slots) if s is None and i not in all_rows]
      n_rows = K + min(n_rows - K, len(spare))
    tok = np.zeros((n_rows, S_pad), dtype=np.int32)
    prompt_lens = np.ones((n_rows,), dtype=np.int32)  # padding rows: prefix 0, prompt_len 1
    temps = np.zeros((n_rows,), dtype=np.float32)
    top_ks = np.ones((n_rows,), dtype=np.int32)
    adapters = np.zeros((n_rows,), dtype=np.int32)  # padding rows: the base slot
    for i, r in enumerate(group):
      # A chunked prefill covers [prefix_len, chunk_end) only; the final
      # chunk (chunk_end == 0) runs to the prompt's end and samples.
      end = r.chunk_end or int(r.req.tokens.shape[0])
      tok[i, : end - r.prefix_len] = r.req.tokens[r.prefix_len : end]
      prompt_lens[i] = end
      temps[i] = r.req.temp
      top_ks[i] = min(r.req.top_k, self.k_max)
      adapters[i] = r.req.adapter_slot
    lora_kw = self._lora_kw(adapters)
    key = eng.split_key()  # on the event-loop thread; the executor only runs device work
    draft_job = self._draft_prefill_job(group)
    if self.paged:
      # The gathered window covers each row's padded write reach only;
      # padding rows keep an all-zero table (their writes land in the trash
      # page).
      mp_used = self._page_window(max(int(r.prefix_len) for r in group) + S_pad)
      bts = np.zeros((n_rows, mp_used), dtype=np.int32)
      prefix_lens = np.zeros((n_rows,), dtype=np.int32)
      for i, r in enumerate(group):
        row_pages = (r.shared_pages + r.new_pages)[:mp_used]
        bts[i, : len(row_pages)] = row_pages
        prefix_lens[i] = r.prefix_len

      def prefill():
        firsts, self.cache = self.ops.prefill_into_pages_many_sampled(tok, self.cache, bts, prefix_lens, prompt_lens, self.page_size, temps, top_ks, self.k_max, key, **lora_kw)
        return firsts
    else:
      rows = np.asarray([r.row for r in group] + spare[: n_rows - K], dtype=np.int32)

      def prefill():
        firsts, self.cache = self.ops.prefill_into_slots_sampled(tok, self.cache, rows, prompt_lens, temps, top_ks, self.k_max, key, **lora_kw)
        return firsts

    def run():
      # A queued adapter install ran before this call (one worker, in
      # order); one that failed fails its group here, before any prefill.
      for r in group:
        if r.req.adapter_install is not None:
          r.req.adapter_install.result()
          r.req.adapter_install = None
      # The draft's prefill rides the same executor call, queued behind the
      # target's before the first tokens are read back.
      firsts = prefill()
      if draft_job is not None:
        draft_job()
      return firsts.cpu().numpy()

    t_dispatch = time.perf_counter()
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
      # The device idles from here until the next dispatch (failure path too).
      self._t_last_ready = time.perf_counter()
      for r in group:
        self._admitting.discard(r.req.request_id)
    metrics.observe_hist("prefill_chunk_seconds", self._t_last_ready - t_dispatch)
    metrics.inc("prefill_chunks_total")
    for i, r in enumerate(group):
      if r.chunk_end:  # intermediate chunk: advance and re-queue; no sample
        r.prefix_len = r.chunk_end
        self._prefilling.append(r)
        continue
      self._finish_admission(r, int(firsts[i]))

  def _draft_prefill_job(self, group: list[_Ready]):
    """The draft's prefill for this admission group, or None: each final
    (sampling) greedy admission prefills its whole prompt into the draft's
    slot cache, one padded forward for the group. The draft has no prefix
    cache and prefills a chunked prompt once, at its final chunk. Greedy
    output never depends on this cache (the verify is exact for any
    draft); it only sets the acceptance."""
    if not self.spec or self.draft_cache is None:
      return None
    final = [r for r in group if not r.chunk_end and r.req.temp <= 0.0]
    if not final:
      return None
    d_pad = min(_round_up(max(int(r.req.tokens.shape[0]) for r in final), PREFILL_BUCKET), self.max_seq)
    dtok = np.zeros((len(final), d_pad), dtype=np.int32)
    dlens = np.ones((len(final),), dtype=np.int32)
    drows = np.asarray([r.row for r in final], dtype=np.int32)
    for i, r in enumerate(final):
      S = int(r.req.tokens.shape[0])
      dtok[i, :S] = r.req.tokens
      dlens[i] = S

    def job():
      self.draft_cache = self.ops.prefill_draft_into_slots(dtok, self.draft_cache, drows, dlens)

    return job

  def _finish_admission(self, r: _Ready, first: int) -> None:
    req = r.req
    slot = _Slot(
      req=req, pos=int(req.tokens.shape[0]), generated=1, last_token=first,
      shared_pages=r.shared_pages, pages=list(r.new_pages), chain_keys=r.chain_keys,
    )
    if req.carry_tokens:
      # Resumed after a preemption: the finish paths report carry + new
      # (``generated``/``max_tokens`` already net out the carried span).
      slot.out_tokens.extend(req.carry_tokens)
    slot.out_tokens.append(first)
    slot.t_first = time.perf_counter()
    if req.t_submit:
      ttft = slot.t_first - req.t_submit
      metrics.observe_hist("ttft_seconds", ttft)
      req.slo_ttft_s = ttft
      slo.observe_ttft(self._slo_class(req), ttft)
    cancelled = req.request_id in self._cancelled_ids  # raced during prefill
    finished = cancelled or first in req.eos_ids or slot.generated >= req.max_tokens
    slot.finished = finished
    req.emit(req.request_id, [] if cancelled else [first], finished)
    if not cancelled:
      slo.note_tokens(self._slo_class(req), self._slo_tenant(req), 1)
    if finished:
      self._cancelled_ids.discard(req.request_id)
      self._release_pages(slot)
      self._slo_note_complete(slot)
      if not req.future.done():
        req.future.set_result(slot.out_tokens)
      return
    if self.spec and req.temp <= 0.0:
      # Starting depth by QoS class: interactive and standard rows open at
      # the proposer's full depth, batch rows at half and must earn the
      # rest. Sampled rows stay at 0. The index covers the (absorbed)
      # prompt and the first token, so a preempted row resumes with a
      # fresh index over its whole stream.
      # A loaded draft opens every greedy row on the model proposer; a
      # draft-free server opens on the n-gram proposer at its own cap.
      cls = req.qos.priority if req.qos is not None else "standard"
      if "model" in self.spec_proposers:
        slot.spec_proposer = "model"
        slot.spec_gamma = max(self.spec_gamma_max // 2, 1) if cls == "batch" else self.spec_gamma_max
      else:
        slot.spec_proposer = "ngram"
        slot.spec_gamma = max(self.spec_ngram_max // 2, 1) if cls == "batch" else self.spec_ngram_max
      if "ngram" in self.spec_proposers:
        slot.ngram = NgramIndex(self.spec_ngram_n)
        slot.ngram.extend(req.tokens)
        slot.ngram.extend([first])
    self.slots[r.row] = slot
    self._h_occupied[r.row] = True
    self._h_tokens[r.row, 0] = first
    self._h_positions[r.row] = slot.pos
    self._h_temps[r.row] = req.temp
    self._h_top_ks[r.row] = min(req.top_k, self.k_max)
    self._h_generated[r.row] = slot.generated
    self._h_max_tokens[r.row] = req.max_tokens
    self._h_adapters[r.row] = req.adapter_slot
    if self.paged:
      self.block_tables[r.row, :] = 0
      n = len(slot.shared_pages) + len(slot.pages)
      self.block_tables[r.row, :n] = slot.shared_pages + slot.pages

  # ------------------------------------------------------------------- SLO

  @staticmethod
  def _slo_class(req: _Request) -> str:
    return req.qos.priority if req.qos is not None else "standard"

  @staticmethod
  def _slo_tenant(req: _Request) -> str:
    return req.qos.tenant if req.qos is not None else "default"

  def _slo_note_complete(self, slot: _Slot) -> None:
    """Goodput at the completion points: a finished request's tokens count
    as goodput only when both its realized latencies met the class
    objectives. The realized ITL is over this incarnation's tokens only
    (a resumed request's t_first is the resumed incarnation's)."""
    if not slo.slo_enabled():
      return
    req = slot.req
    n = len(slot.out_tokens)
    n_new = n - len(req.carry_tokens)
    itl_s = None
    if slot.t_first and n_new > 1:
      itl_s = max(time.perf_counter() - slot.t_first, 0.0) / (n_new - 1)
    if slo.within_slo(self._slo_class(req), req.slo_ttft_s, itl_s):
      slo.note_good_tokens(self._slo_class(req), self._slo_tenant(req), n)

  # ----------------------------------------------------------- page lifecycle

  def _release_pages(self, slot: _Slot, extend: bool | None = None) -> None:
    """Return a finished slot's pages: shared prefix refs drop; private FULL
    prompt pages are donated to the prefix cache; the rest (the partial
    prompt tail and generated positions) free at once.

    Under the KV tier (``extend`` defaults to tier-on) the donation also
    covers the row's GENERATED full pages: the chain keys extend over the
    absorbed stream (prompt + new tokens), so a preempted row's resume and
    a conversation's next turn find the whole history as a prefix, on the
    device now and on the host once LRU pressure spills it. The dense
    layout holds no pages. The row's adapter pin drops here too: every
    caller takes the row out of the pool."""
    self._lora_unpin(slot.req)
    if not self.paged:
      return
    for p in slot.shared_pages:
      self.allocator.release(p)
    n_shared = len(slot.shared_pages)
    keys = slot.chain_keys
    if extend is None:
      extend = self.tier is not None
    if extend and slot.pos // self.page_size > len(keys):
      new_toks = slot.out_tokens[len(slot.req.carry_tokens):]
      absorbed = np.concatenate([slot.req.tokens, np.asarray(new_toks, np.int64)]) if new_toks else slot.req.tokens
      # Positions [0, pos) hold exactly the KV of absorbed[:pos]; only FULL
      # pages are donatable.
      keys = PageAllocator.chain_keys_extend(keys, absorbed[: (slot.pos // self.page_size) * self.page_size], self.page_size, adapter_chain_seed(slot.req.adapter))
    to_free = []
    donated = []
    for i, p in enumerate(slot.pages):
      logical = n_shared + i
      if logical < len(keys) and self.allocator.insert_cached(keys[logical], p):
        donated.append(keys[logical])
        continue
      to_free.append(p)
    self.allocator.free(to_free)
    if donated and self.tier is not None:
      prefix_registry.note(donated)  # this node now holds these chains
    if slot.shared_pages or slot.pages:
      metrics.inc("page_release_events_total")
    slot.shared_pages, slot.pages = [], []

  def _clear_row(self, row: int) -> None:
    """Reset a freed row's block table and dispatch arrays."""
    if self.paged and self.block_tables is not None:
      self.block_tables[row, :] = 0
    if self.spec:
      metrics.set_gauge("spec_gamma", 0, labels={"row": str(row)})
      metrics.set_gauge("spec_proposer", 0, labels={"row": str(row)})
    self._h_occupied[row] = False
    self._h_tokens[row, 0] = 0
    self._h_positions[row] = 0
    self._h_temps[row] = 0.0
    self._h_top_ks[row] = 1
    self._h_generated[row] = 0
    self._h_max_tokens[row] = 0
    self._h_adapters[row] = 0

  def _grow_pages(self, row: int, slot: _Slot, pos: int, headroom: int | None = None) -> bool:
    """Ensure ``slot`` has pages covering the chunk dispatched at ``pos``
    (the dispatch-time position: under lookahead it includes the in-flight
    chunk's advance, so growth keeps one chunk of headroom). ``headroom``
    overrides the chunk size for a spec dispatch: its worst-case advance
    ``spec_worst_advance(chunk, gamma_max)``."""
    needed = pages_to_cover(pos + (headroom if headroom is not None else self.chunk), self.page_size)
    have = len(slot.shared_pages) + len(slot.pages)
    if needed <= have:
      return True
    got = self.allocator.alloc(needed - have)
    if got is None:
      return False
    metrics.inc("page_grow_events_total")
    metrics.inc("page_grow_pages_total", len(got))
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

  # ----------------------------------------------------------- mixed ticks

  def _mixed_active(self) -> bool:
    """Mixed prefill+decode ticks apply: knob on, the paged layout (a slice
    resumes from a per-row prefix offset), chunking on, and a backend with
    the fused mixed program."""
    return self.mixed and self.paged and self.prefill_chunk > 0 and self.ops.mixed_tick_supported()

  def _itl_burn(self) -> float | None:
    """Interactive-class fast-window ITL burn — the budget policy's input.
    The SLO tick's gauge when it has run; before the first tick, the live
    ``qos_itl_seconds{class=interactive}`` median against the class
    objective. None = no ITL signal at all."""
    if not slo.slo_enabled():
      return None
    fast = int(min(slo.slo_windows_s()))
    b = metrics.gauge_value("slo_burn_rate", labels={"class": "interactive", "window": f"{fast}s"})
    if b is not None:
      return float(b)
    itl = metrics.quantile("qos_itl_seconds", 0.5, labels={"class": "interactive"})
    if itl is None:
      return None
    return (itl * 1e3) / max(slo.objectives("interactive")["itl_p99_ms"], 1e-9)

  def _mixed_budget(self, backlog: int | None = None) -> int:
    residents = sum(1 for s in self.slots if s is not None)
    budget = select_mixed_budget(self.prefill_chunk, self._itl_burn(), residents, backlog=backlog if backlog is not None else max(len(self._prefilling), 1))
    metrics.set_gauge("mixed_budget_tokens", budget)
    return budget

  @staticmethod
  def _mixed_final_cap(budget: int) -> int:
    """Largest remaining suffix the final (sampling) dispatch may cover: it
    runs alone at a boundary, a pure prefill stall, so one pad bucket — or
    the budget, when that is smaller."""
    return min(budget, PREFILL_BUCKET)

  def _mixed_defer(self, r: _Ready, budget: int) -> bool:
    """Should this admission's next prefill advance ride mixed ticks? Yes
    while decode rows are resident and the remaining suffix exceeds the
    final cap."""
    if not self._mixed_active() or r.req.request_id in self._cancelled_ids:
      return False
    if not any(s is not None for s in self.slots):
      return False  # nothing to mix with: the alternating dispatch stalls no one
    return int(r.req.tokens.shape[0]) - r.prefix_len > self._mixed_final_cap(budget)

  def _mixed_intent(self, inflight: _Chunk | None, budget: int | None = None) -> tuple | None:
    """(ready, start, end) of the slice the next decode dispatch fuses in,
    or None for a plain tick. One admission per tick (the head of
    ``_prefilling``, arrival order); a chained dispatch continues from the
    in-flight slice's end. ``budget`` is the loop iteration's one verdict."""
    if not self._mixed_active() or not self._prefilling:
      return None
    if not any(s is not None for s in self.slots):
      return None
    r = self._prefilling[0]
    if r.req.request_id in self._cancelled_ids:
      return None  # force a boundary: the admission sweep settles the cancel
    start = r.prefix_len
    if inflight is not None and inflight.mixed_ready is r:
      start = inflight.mixed_end  # the in-flight slice has not settled yet
    if budget is None:
      budget = self._mixed_budget()
    final_cap = self._mixed_final_cap(budget)
    remaining = int(r.req.tokens.shape[0]) - start
    if remaining <= final_cap:
      return None  # final slice: the boundary dispatch prefills and samples it
    # The last slice shrinks so the sampling dispatch stays one bucket wide.
    slice_len = min(budget, remaining - final_cap)
    # A power-of-two pad inside the window (prefix + pad <= max_seq): near
    # the window end the slice shrinks rather than the pad clamping.
    pad = 1
    while pad < slice_len:
      pad *= 2
    while pad > self.max_seq - start and pad > 1:
      pad //= 2
    slice_len = max(min(slice_len, pad), 1)
    return (r, start, start + slice_len)

  def _prefill_boundary_needed(self, budget: int | None = None) -> bool:
    """Does a mid-flight chunked prefill need a synchronous boundary (settle
    and an admission dispatch)? Always under the alternating schedule; under
    mixed ticks only when an entry is final-slice-ready, cancelled, or no
    decode row is resident to mix with."""
    if not self._prefilling:
      return False
    if not self._mixed_active() or not any(s is not None for s in self.slots):
      return True
    if budget is None:
      budget = self._mixed_budget()
    final_cap = self._mixed_final_cap(budget)
    for r in self._prefilling:
      if r.req.request_id in self._cancelled_ids:
        return True
      if int(r.req.tokens.shape[0]) - r.prefix_len <= final_cap:
        return True
    return False

  # ----------------------------------------------------------------- decode

  def _plan_chunk(self, inflight: _Chunk | None, gmax: int = 0) -> _Plan:
    """Snapshot the next chunk's dispatch state: confirmed slot state plus
    the in-flight chunk's advance. Cancelled rows and rows without cache
    room deactivate (they settle as finishes at this chunk's boundary);
    page-starved rows skip the chunk but stay resident. Under lookahead a
    row whose in-flight chunk reaches max_tokens is left out: the in-flight
    settle resolves it first.

    An in-flight SPEC chunk advances each row by a variable count: the plan
    assumes its worst case for positions and page growth, and skips the
    max_tokens exclusion (a worst-case ``generated`` could drop a row that
    does not finish). ``gmax > 0`` means this dispatch is a spec chunk:
    growth reserves ``spec_worst_advance(chunk, gmax)`` tokens."""
    spec = inflight.active if inflight is not None else None
    headroom = spec_worst_advance(self.chunk, gmax) if gmax > 0 else self.chunk
    positions = self._h_positions.copy()
    generated = self._h_generated.copy()
    if spec is not None:
      positions[spec] += inflight.worst
      if not inflight.spec:
        generated[spec] += inflight.worst
    active = self._h_occupied.copy()
    starved: set[int] = set()
    rows: list = []
    finishing = 0
    for i, s in enumerate(self.slots):
      if s is None:
        continue
      rows.append((i, s))
      if spec is not None and not inflight.spec and spec[i] and generated[i] >= self._h_max_tokens[i]:
        active[i] = False  # finishes at the in-flight settle; drop-on-read covers the rest
      elif s.cancelled or int(positions[i]) + self.chunk >= self.max_seq:
        active[i] = False
        finishing += 1
      elif self.paged and not self._grow_pages(i, s, int(positions[i]), headroom):
        active[i] = False
        starved.add(i)
    deadlocked = inflight is None and bool(starved) and not active.any() and finishing == 0
    return _Plan(rows=rows, active=active, starved=starved, positions=positions, deadlocked=deadlocked, gmax=gmax)

  def _note_ngram_miss(self, row: int, slot: _Slot) -> None:
    """Charge a proposal miss (no suffix match in the row's history) to the
    n-gram EWMA as a zero-acceptance observation. A miss costs no device
    work, but a row holding n-gram depth forces synchronous dispatch, so
    rows whose text never matches must converge back to plain."""
    ewma = ewma_update(slot.spec_ewmas.get("ngram"), 0.0)
    slot.spec_ewmas["ngram"] = ewma
    prio = slot.req.qos.priority if slot.req.qos is not None else "standard"
    slot.spec_gamma = spec_adapt_gamma(ewma, slot.spec_gamma, self.spec_ngram_max, prio)
    if slot.spec_gamma == 0:
      slot.spec_proposer, slot.spec_gamma = spec_select_proposer("ngram", slot.spec_ewmas, self.spec_proposers, prio)
    metrics.set_gauge("spec_proposer", PROPOSER_CODE[slot.spec_proposer], labels={"row": str(row)})

  def _spec_intent(self, inflight: _Chunk | None) -> int:
    """gamma_max for the next decode chunk; 0 dispatches the plain program.

    Plain wins when speculation is off, no greedy row holds depth, or any
    live row sits within the chunk's worst-case advance of the context
    window (plain chunks carry it to its end). When every depth is 0, a
    probe chunk runs every ``spec_reprobe`` plain chunks, each row on the
    proposer the policy ranks best for it (``spec_reprobe_proposer``).

    N-gram proposals key on settled history: when a row holds n-gram depth
    while a chunk is in flight, this sets ``_spec_needs_host`` and the loop
    settles first; with the pipeline drained the proposals are computed
    here (one suffix lookup per row) and staged in ``_spec_props``. A miss
    contributes no depth and charges the miss policy. Model-drafted rows
    need no host proposal: the draft runs inside the chunk."""
    self._spec_props = None
    self._spec_needs_host = False
    if not self.spec:
      return 0
    live = [(i, s) for i, s in enumerate(self.slots) if s is not None and not s.finished and not s.cancelled]
    greedy = [(i, s) for i, s in live if s.req.temp <= 0.0]
    if not greedy:
      return 0
    model_ok = self.draft_cache is not None
    if all(s.spec_gamma <= 0 or (s.spec_proposer == "model" and not model_ok) for _, s in greedy):
      if self.spec_reprobe <= 0 or self._spec_plain_chunks < self.spec_reprobe:
        return 0
      available = self.spec_proposers if model_ok else tuple(p for p in self.spec_proposers if p != "model")
      for i, s in greedy:  # probe round: depth 1, the best proposer per row
        prop = spec_reprobe_proposer(s.spec_ewmas, available)
        if prop is None:
          continue
        s.spec_proposer, s.spec_gamma = prop, 1
        metrics.set_gauge("spec_proposer", PROPOSER_CODE[prop], labels={"row": str(i)})
      self._spec_plain_chunks = 0
    if inflight is not None and any(s.spec_proposer == "ngram" and s.spec_gamma > 0 and s.ngram is not None for _, s in greedy):
      self._spec_needs_host = True  # host proposals need settled history: drain first
      return max(s.spec_gamma for _, s in greedy)
    gmax = 0
    props: dict[int, np.ndarray] = {}
    stream_cap = spec_worst_advance(self.chunk, self.spec_ngram_max)
    for i, s in greedy:
      if s.spec_gamma <= 0:
        continue
      if s.spec_proposer == "ngram":
        if s.ngram is None:
          continue
        cand = s.ngram.propose(stream_cap)
        if len(cand) == 0:
          self._note_ngram_miss(i, s)
          continue
        props[i] = cand
        gmax = max(gmax, min(s.spec_gamma, len(cand)))
      elif model_ok:
        gmax = max(gmax, s.spec_gamma)
    if gmax == 0:
      return 0
    worst = spec_worst_advance(self.chunk, gmax)
    adv = inflight.worst if inflight is not None else 0
    for i, s in live:
      pos = int(self._h_positions[i]) + (adv if (inflight is not None and inflight.active[i]) else 0)
      if pos + worst >= self.max_seq:
        return 0  # near-window band: plain chunks carry the row to its end
    self._spec_props = props or None
    return gmax

  def _preempt_starved(self, plan: _Plan) -> None:
    """Every resident row is starved (none can run, and no finishing row is
    about to free pages): fail the youngest so the others make progress."""
    victim = min(plan.starved, key=lambda i: self.slots[i].generated)
    s = self.slots[victim]
    metrics.inc("scheduler_preemptions_total")
    self._release_pages(s)
    self.slots[victim] = None
    self._clear_row(victim)
    if not s.req.future.done():
      s.req.future.set_exception(ServerOverloadedError("page pool exhausted with no runnable rows"))

  async def _dispatch_decode(self, plan: _Plan, inflight: _Chunk | None) -> _Chunk:
    """Enqueue one decode chunk (with the plan's prefill slice fused in, if
    any) and return its in-flight record without waiting for the device:
    the executor call only queues the work and the copy of its tokens into
    pinned host memory.

    ``plan.gmax > 0`` dispatches the spec program (``chunk`` verify rounds,
    per-row depths and n-gram streams from the slots, variable advance),
    with the draft's cache only when a model-drafted row is in it (else the
    draft-free program). A chained spec dispatch takes the in-flight
    chunk's device positions: the host learns a spec chunk's advance only
    at its settle."""
    eng = self.engine
    gmax = plan.gmax
    spec = gmax > 0
    # Chained dispatch: the input token is the in-flight chunk's
    # device-resident next token; a synchronous one uses the host arrays.
    tokens = inflight.next_tok if inflight is not None else self._h_tokens
    positions = inflight.pos_dev if (spec and inflight is not None) else plan.positions
    gammas = proposers = props_arr = prop_counts = None
    use_draft = False
    if spec:
      props_map, self._spec_props = self._spec_props, None
      gammas = np.zeros((self.n_slots,), dtype=np.int32)
      proposers = ["plain"] * self.n_slots
      if props_map:
        stream_w = spec_worst_advance(self.chunk, gmax) + gmax
        props_arr = np.zeros((self.n_slots, stream_w), dtype=np.int32)
        prop_counts = np.zeros((self.n_slots,), dtype=np.int32)
      for i, s in plan.rows:
        if not (plan.active[i] and s.req.temp <= 0.0):
          continue
        if s.spec_proposer == "ngram" and props_map and i in props_map:
          stream = props_map[i][:stream_w]
          props_arr[i, : len(stream)] = stream
          prop_counts[i] = len(stream)
          gammas[i] = min(s.spec_gamma, gmax)
          proposers[i] = "ngram"
        elif s.spec_proposer == "model" and self.draft_cache is not None and s.spec_gamma > 0:
          gammas[i] = min(s.spec_gamma, gmax)
          proposers[i] = "model"
          use_draft = True
      self._spec_plain_chunks = 0
    elif self.spec:
      self._spec_plain_chunks += 1
    worst = spec_worst_advance(self.chunk, gmax) if spec else self.chunk
    mixed_r, m_start, m_end = plan.mixed if plan.mixed is not None else (None, 0, 0)  # never with spec: a mixed tick plans gmax 0
    if mixed_r is not None:
      # The slice pads to a power of two of at least MIXED_MIN_PAD inside
      # the window (the planner kept the slice's own power of two there),
      # and its page window buckets like an admission dispatch's.
      s_slice = m_end - m_start
      pad = MIXED_MIN_PAD
      while pad < s_slice:
        pad *= 2
      while pad > self.max_seq - m_start and pad // 2 >= s_slice:
        pad //= 2
      pf_tokens = np.zeros((1, pad), dtype=np.int32)
      pf_tokens[0, :s_slice] = mixed_r.req.tokens[m_start:m_end]
      mp_used = self._page_window(m_start + pad)
      pf_bt = np.zeros((1, mp_used), dtype=np.int32)
      row_pages = (mixed_r.shared_pages + mixed_r.new_pages)[:mp_used]
      pf_bt[0, : len(row_pages)] = row_pages
      pf_bounds = (np.asarray([m_start], dtype=np.int32), np.asarray([m_end], dtype=np.int32))
    key = eng.split_key()
    lora_kw = self._lora_kw(self._h_adapters)
    now = time.perf_counter()
    if self._t_last_ready is not None:
      # The device-idle window this dispatch waited for host work (0 when
      # chained: the chunk queues behind its predecessor).
      metrics.observe_hist("sched_host_gap_seconds", 0.0 if inflight is not None else now - self._t_last_ready)

    def run():
      kw = dict(k_max=self.k_max, key=key, **lora_kw)
      if self.paged:
        kw["page_size"] = self.page_size
      if spec:
        # The draft's cache rides only a chunk with a model-drafted row; it
        # is written in place, so a later model probe finds it as it was.
        cd = self.draft_cache if use_draft else None
        common = (positions, plan.active, gammas, self._h_temps, self._h_top_ks, self.chunk, gmax)
        if self.paged:
          toks, counts, n_prop, next_tok, pos_dev, self.cache, _ = self.ops.spec_paged_batch_decode(
            tokens, self.cache, cd, self.block_tables, *common, props=props_arr, prop_counts=prop_counts, **kw,
          )
        else:
          toks, counts, n_prop, next_tok, pos_dev, self.cache, _ = self.ops.spec_batch_decode(tokens, self.cache, cd, *common, props=props_arr, prop_counts=prop_counts, **kw)
        host, ready = to_host_async(toks, counts, n_prop)
        return host, ready, next_tok, pos_dev
      if not self.paged:
        toks, next_tok, _pos, self.cache = self.ops.batch_decode(tokens, self.cache, plan.positions, plan.active, self._h_temps, self._h_top_ks, self.chunk, **kw)
        host, ready = to_host_async(toks)
        return host, ready, next_tok, None
      args = (tokens, self.cache, self.block_tables, plan.positions, plan.active, self._h_temps, self._h_top_ks, self.chunk)
      if mixed_r is not None:
        # The slice carries its own admission's adapter (pf_adapter).
        pf_kw = {"pf_adapter": np.asarray([mixed_r.req.adapter_slot], np.int32)} if lora_kw else {}
        toks, next_tok, _pos, self.cache = self.ops.mixed_paged_batch_decode(*args, **kw, **pf_kw, pf_tokens=pf_tokens, pf_bt=pf_bt, pf_prefix=pf_bounds[0], pf_end=pf_bounds[1])
      else:
        toks, next_tok, _pos, self.cache = self.ops.paged_batch_decode(*args, **kw)
      host, ready = to_host_async(toks)
      return host, ready, next_tok, None

    if plan.starved:
      metrics.inc("scheduler_page_starved_total", len(plan.starved))
    t_dispatch = time.perf_counter()
    host, ready, next_tok, pos_dev = await asyncio.get_running_loop().run_in_executor(eng.executor, run)
    return _Chunk(
      toks=host[0], ready=ready, next_tok=next_tok, rows=plan.rows, active=plan.active, starved=frozenset(plan.starved),
      chained=inflight is not None, t_dispatch=t_dispatch, mixed_ready=mixed_r, mixed_start=m_start, mixed_end=m_end,
      spec=spec, worst=worst, rounds=self.chunk if spec else 0, counts=host[1] if spec else None, pos_dev=pos_dev,
      gammas=gammas, proposers=proposers, n_prop=host[2] if spec else None,
    )

  def _note_spec_settle(self, row: int, slot: _Slot, record: _Chunk, avail: int, proposed: int) -> None:
    """Per-row spec bookkeeping at the settle: the per-proposer accepted
    and proposed counters, the EWMA step and the depth policy, the
    proposer switch at the depth floor, and the row's gauges."""
    g = int(record.gammas[row])
    prop = record.proposers[row]
    accepted = max(avail - record.rounds, 0)
    metrics.inc("spec_accepted_tokens_total", accepted, labels={"proposer": prop})
    if g > 0 and proposed > 0:
      metrics.inc("spec_proposed_tokens_total", proposed, labels={"proposer": prop})
      ewma = ewma_update(slot.spec_ewmas.get(prop), accepted / float(proposed))
      slot.spec_ewmas[prop] = ewma
      prio = slot.req.qos.priority if slot.req.qos is not None else "standard"
      cap = self.spec_ngram_max if prop == "ngram" else self.spec_gamma_max
      slot.spec_gamma = spec_adapt_gamma(ewma, g, cap, prio)
      if slot.spec_gamma == 0:
        # Depth floor on this proposer: probe the next candidate, or park
        # the row on plain until a re-probe.
        slot.spec_proposer, slot.spec_gamma = spec_select_proposer(prop, slot.spec_ewmas, self.spec_proposers, prio)
      metrics.observe_hist("spec_acceptance_ewma", ewma, buckets=FRACTION_BUCKETS)
    metrics.set_gauge("spec_gamma", slot.spec_gamma, labels={"row": str(row)})
    metrics.set_gauge("spec_proposer", PROPOSER_CODE[slot.spec_proposer], labels={"row": str(row)})

  async def _settle(self, record: _Chunk) -> None:
    """Read one chunk's tokens and run the host bookkeeping: the fused
    slice's prefix advance, emit, EOS/max_tokens/cancel finishes, page
    release, metrics. Under lookahead this runs while the next chunk
    computes. Rows that finished at an earlier settle (while this chunk was
    in flight) are dropped on read: their tokens here are overrun and never
    emitted, and their pages can only be re-granted to dispatches that run
    after this chunk on the one stream."""

    def fetch():
      if record.ready is not None:
        record.ready.synchronize()
      if record.spec:
        return record.toks.numpy(), record.counts.numpy(), record.n_prop.numpy()
      return record.toks.numpy(), None, None

    rows_host, counts_host, n_prop_host = await asyncio.get_running_loop().run_in_executor(self.engine.executor, fetch)
    t_ready = time.perf_counter()
    # While the pipeline is full the device runs chunks back to back, so a
    # chunk's device time is ready-to-ready; the first chunk after a
    # boundary times dispatch-to-ready.
    base = self._t_last_ready if (record.chained and self._t_last_ready is not None) else record.t_dispatch
    chunk_dt = max(t_ready - base, 1e-9)
    self._t_last_ready = t_ready
    if record.mixed_ready is not None:
      # The fused slice is confirmed: advance the admission's prefix
      # (max-guarded: a settle never rewinds past a later chained slice).
      # A fused dispatch has its own latency family, so it skews neither the
      # prefill nor the decode histogram.
      r = record.mixed_ready
      r.prefix_len = max(r.prefix_len, record.mixed_end)
      metrics.observe_hist("mixed_tick_seconds", chunk_dt)
      metrics.inc("sched_tick_prefill_tokens_total", record.mixed_end - record.mixed_start)
    if record.active.any():
      if record.mixed_ready is None:
        metrics.observe_hist("decode_chunk_seconds", chunk_dt)
      metrics.inc("decode_chunks_total", labels={"path": "spec" if record.spec else self.decode_path})
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
        self._slo_note_complete(slot)
        req.emit(req.request_id, [], True)
        if not req.future.done():
          req.future.set_result(slot.out_tokens)
        self.slots[i] = None
        self._clear_row(i)
        continue
      # A spec chunk's counts say how many of the row's slots are real; EOS
      # and max_tokens cut inside an accepted run as inside a plain chunk.
      avail = int(counts_host[i]) if record.spec else rows_host.shape[1]
      emit: list[int] = []
      done = False
      for t in rows_host[i][:avail]:
        t = int(t)
        emit.append(t)
        slot.generated += 1
        if t in req.eos_ids or slot.generated >= req.max_tokens:
          done = True
          break
      if record.spec:
        self._note_spec_settle(i, slot, record, avail, int(n_prop_host[i]))
      if slot.ngram is not None and emit:
        slot.ngram.extend(emit)  # the next proposal keys on this chunk's tokens too
      slot.out_tokens.extend(emit)
      slot.pos += len(emit)
      slot.last_token = emit[-1] if emit else slot.last_token
      self._h_positions[i] = slot.pos
      self._h_generated[i] = slot.generated
      self._h_tokens[i, 0] = slot.last_token
      if emit:
        metrics.inc("decode_tokens_total", len(emit), labels={"path": "spec" if record.spec else self.decode_path})
        # The chunk's wall-clock over its tokens: one weighted observation.
        metrics.observe_hist("itl_seconds", chunk_dt / len(emit), n=len(emit))
        slo.observe_itl(self._slo_class(req), chunk_dt / len(emit), n=len(emit))
        slo.note_tokens(self._slo_class(req), self._slo_tenant(req), len(emit))
      req.emit(req.request_id, emit, done)
      if done:
        slot.finished = True
        self._cancelled_ids.discard(req.request_id)
        self._release_pages(slot)
        self._slo_note_complete(slot)
        if not req.future.done():
          req.future.set_result(slot.out_tokens)
        self.slots[i] = None
        self._clear_row(i)
    self._update_gauges()

  async def _run(self) -> None:
    self._ensure_cache()
    inflight: _Chunk | None = None
    try:
      while True:
        # One mixed-budget verdict per loop iteration: the boundary gate,
        # the tick planner and the admission sweep agree within a tick.
        mixed_budget = self._mixed_budget() if (self._prefilling and self._mixed_active()) else None
        if inflight is not None:
          # Drain the pipeline whenever a waiting request could admit (or,
          # under QoS, preempt a resident row it outranks), a chunked
          # prefill needs a boundary, or lookahead is off. A backlog with no
          # free slot and nothing to preempt cannot admit, so the pipeline
          # keeps chaining at saturation.
          admissible = self._free_slot() is not None and (not self.queue.empty() or self._parked_admissible())
          if not admissible and self.qos is not None and self._free_slot() is None and not self.queue.empty() and self._preempt_victim_for(self.queue.peek()) is not None:
            admissible = True
          if not self.lookahead or self._prefill_boundary_needed(mixed_budget) or admissible:
            await self._settle(inflight)
            inflight = None
            continue
        else:
          await self._admit_pending()
          self._update_gauges()
          if all(s is None for s in self.slots):
            if self._prefilling or self._parked:
              # A chunked prefill is mid-flight, or parked requests can now
              # retry with every slot free (each pass resolves at least one).
              continue
            self._t_last_ready = None  # idle by design is not a host gap
            req = await self.queue.get()  # idle: block on the queue
            await self._admit_pending(woken=req)
            continue
        if mixed_budget is None and self._prefilling and self._mixed_active():
          mixed_budget = self._mixed_budget()  # the admission pass just staged a prefill
        mixed = self._mixed_intent(inflight, mixed_budget)
        if mixed is not None:
          # A mixed tick takes precedence: the fused program composes with
          # the plain decode loop only, so spec rows run plain this tick.
          self._spec_props = None
          self._spec_needs_host = False
          gmax = 0
        else:
          gmax = self._spec_intent(inflight)
        if inflight is not None and (inflight.spec != (gmax > 0) or self._spec_needs_host):
          # A spec<->plain switch (the two programs chain differently:
          # device positions against the host plan), or host proposals that
          # need settled history: settle, then dispatch synchronously.
          await self._settle(inflight)
          inflight = None
          continue
        plan = self._plan_chunk(inflight, gmax)
        plan.mixed = mixed
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
      self._drop_pool()  # rebuilt at the next submit
      self._fail_all(e)

  def _fail_all(self, exc: Exception) -> None:
    for i, slot in enumerate(self.slots):
      if slot is not None:
        self._lora_unpin(slot.req)
        if not slot.req.future.done():
          slot.req.future.set_exception(exc)
      self.slots[i] = None
      self._clear_row(i)
    self._t_last_ready = None
    while self._prefilling:
      r = self._prefilling.pop()
      self._lora_unpin(r.req)
      if not r.req.future.done():
        r.req.future.set_exception(exc)
    self.admission.fail_queued(exc)
