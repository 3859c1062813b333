"""Device operations of the continuous-batching scheduler, behind one small
interface (counterpart of the reference's ``inference/batch_ops.py``
``DecoderBatchOps``; the pp/sp mesh backends are not ported yet).
It serves both layouts: the page pool (``init_pool``) and the dense slot
cache (``init_cache``, ``XOT_TPU_PAGED=0``). It runs the speculative
chunks on either, with the n-gram proposer and, when the engine holds a
draft (``XOT_TPU_SPEC_DECODE=int8`` or ``XOT_TPU_SPEC_DRAFT``), the model
proposer on the draft's own slot cache (``init_draft_cache``,
``prefill_draft_into_slots``). It also carries the host KV tier's page
copies (inference/kv_tier.py): ``read_pages`` starts a spill's
device-to-host copy and ``write_pages`` writes a restore's host pages back
into the pool.

The pool or cache made by ``init_pool`` / ``init_cache`` comes with its
captured programs (models/decoder.py ``BatchedPrograms``), and the draft
cache joins them: every dispatch against it — the admission prefill, the
draft's prefill, the plain, mixed and speculative chunks — is one
CUDA-graph replay on the card (its body run eagerly through the same
buffers on the CPU). The eager functions serve any other store (tests, the
uncaptured comparison). ``drop_pool`` forgets a store's programs with it.

The scheduler hands host operands as numpy arrays. They reach the card as
non-blocking copies out of pinned host memory, so a dispatch never waits
for the device work queued before it — the lookahead pipeline depends on
that. A ``key`` is an integer seed drawn from the engine
(``TorchShardedInferenceEngine.split_key``); each dispatch samples as a
generator freshly seeded with it would (the programs reseed their own
generator before each replay). The decode contract is the reference's:
``(tokens [B, chunk], next_token [B, 1], positions [B], pool)`` with
``next_token`` left on the device as the next chunk's input; a program's
outputs stay valid until its next dispatch, so the scheduler queues its
host copies (``to_host_async``) right behind the dispatch. Every prefill
and decode method takes ``adapter_ids`` (each row's slot in the engine's
stacked adapter leaves, ``lora_supported``), and the mixed chunk its
slice's ``pf_adapter``; the scheduler passes them only while the engine
holds an adapter registry.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(x, device) -> torch.Tensor:
  """A numpy array (copied now, so the caller may reuse it) or a tensor, on
  ``device``, without blocking the host on a CUDA stream."""
  if isinstance(x, torch.Tensor):
    return x.to(device, non_blocking=True)
  t = torch.from_numpy(np.array(x, copy=True))
  if torch.device(device).type == "cuda":
    return t.pin_memory().to(device, non_blocking=True)
  return t


def to_host_async(*tensors: torch.Tensor):
  """Start copying ``tensors`` (on one device) into pinned host memory
  behind one event. Returns (host tensors, event): the host tensors are
  valid once ``event.synchronize()`` returns (event None: already valid)."""
  dev = tensors[0].device
  if dev.type != "cuda":
    return [t.clone() for t in tensors], None  # a program's next run overwrites its outputs
  hosts = []
  for t in tensors:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    hosts.append(host)
  event = torch.cuda.Event()
  event.record(torch.cuda.current_stream(dev))
  return hosts, event


class DecoderBatchOps:
  """Single-device batched serving ops over the page pool
  (models/decoder.py batched programs)."""

  def __init__(self, engine):
    self.engine = engine
    self._copy_stream = None  # the KV tier's device-to-host stream, made at the first spill
    self.programs = None  # the captured programs of the pool init_pool made last

  def round_slots(self, n: int) -> int:
    return n

  def lora_supported(self) -> bool:
    """The programs take per-row ``adapter_ids`` once the engine has built
    its adapter registry (``enable_multi_lora``)."""
    return getattr(self.engine, "adapter_registry", None) is not None

  def fused_sampling_supported(self) -> bool:
    """Prefill and first-token sampling run as one call
    (``prefill_into_pages_many_sampled``), which the scheduler always uses."""
    return True

  def _dev(self, x):
    return to_device(x, self.engine.device)

  def _generator(self, key: int) -> torch.Generator:
    return torch.Generator(device=self.engine.device).manual_seed(int(key))

  def _adapter_kw(self, **ids) -> dict:
    """The given adapter operands on the device, as keywords (none when
    None: the eager functions' ledger signatures stay as without)."""
    return {k: self._dev(v) for k, v in ids.items() if v is not None}

  def _new_programs(self, make, dense: bool):
    """``make()``'s store with its captured programs (``BatchedPrograms``),
    which replace the previous store's (their graphs go before the new
    store is allocated)."""
    from ..models.decoder import BatchedPrograms

    eng = self.engine
    if self.programs is not None:
      self.programs.close()
      self.programs = None
    store = make()
    self.programs = BatchedPrograms(eng.params, eng.cfg, eng._effective_shard, store, dense=dense)
    return store

  def init_pool(self, n_pages: int, page_size: int):
    """A page pool with its captured programs."""
    from ..ops.paged import init_paged_pool

    eng = self.engine
    return self._new_programs(lambda: init_paged_pool(eng.cfg, eng._effective_shard.n_shard_layers, n_pages, page_size, device=eng.device), dense=False)

  def init_cache(self, n_slots: int, max_seq: int):
    """The dense slot cache [L, n_slots, max_seq, ...] (KV quant as
    ``XOT_TPU_KV_QUANT`` says) with its captured programs."""
    from ..models.decoder import init_kv_cache

    eng = self.engine
    return self._new_programs(lambda: init_kv_cache(eng.cfg, eng._effective_shard.n_shard_layers, n_slots, max_seq, device=eng.device), dense=True)

  def drop_pool(self, pool) -> None:
    """Forget ``pool``'s programs (shutdown): their graphs hold its
    addresses and their own memory."""
    if self.programs is not None and self.programs.pool is pool:
      self.programs.close()
      self.programs = None

  def _programs_for(self, pool):
    progs = self.programs
    return progs if progs is not None and progs.pool is pool else None

  def prefill_into_slots(self, tokens, cache, rows, prompt_lens, adapter_ids=None):
    from ..models.decoder import prefill_into_slots

    eng = self.engine
    return prefill_into_slots(eng.params, eng.cfg, eng._effective_shard, self._dev(tokens), cache, self._dev(rows), self._dev(prompt_lens), **self._adapter_kw(adapter_ids=adapter_ids))

  def prefill_into_slots_sampled(self, tokens, cache, rows, prompt_lens, temps, top_ks, k_max: int, key, adapter_ids=None):
    """Prefill K admissions into K rows of the slot cache and sample their
    first tokens: (first_tokens [K], cache)."""
    from ..models.decoder import prefill_into_slots_sampled

    progs = self._programs_for(cache)
    if progs is not None:
      return progs.prefill_slots(tokens, rows, prompt_lens, temps, top_ks, k_max, key, adapter_ids), cache
    eng = self.engine
    return prefill_into_slots_sampled(
      eng.params, eng.cfg, eng._effective_shard, self._dev(tokens), cache, self._dev(rows), self._dev(prompt_lens),
      self._dev(temps), self._dev(top_ks), self._generator(key), int(k_max), **self._adapter_kw(adapter_ids=adapter_ids),
    )

  def batch_decode(self, token, cache, positions, active, temps, top_ks, n_steps: int, k_max: int, key, adapter_ids=None):
    """One decode chunk over the slot cache: (tokens, next_token,
    positions, cache), ``fused_batch_decode``'s contract."""
    from ..models.decoder import fused_batch_decode

    progs = self._programs_for(cache)
    if progs is not None:
      return (*progs.batch_decode(token, positions, active, temps, top_ks, n_steps, k_max, key, adapter_ids), cache)
    eng = self.engine
    return fused_batch_decode(
      eng.params, eng.cfg, eng._effective_shard, self._dev(token), cache, self._dev(positions), self._dev(active), self._dev(temps), n_steps,
      top_k=self._dev(top_ks), k_max=k_max, generator=self._generator(key), **self._adapter_kw(adapter_ids=adapter_ids),
    )

  def prefill_into_pages_many(self, tokens, pool, bt_rows, prefix_lens, prompt_lens, page_size: int, adapter_ids=None):
    from ..models.decoder import prefill_into_pages_many

    eng = self.engine
    return prefill_into_pages_many(
      eng.params, eng.cfg, eng._effective_shard, self._dev(tokens), pool, self._dev(bt_rows),
      self._dev(prefix_lens), self._dev(prompt_lens), int(page_size), **self._adapter_kw(adapter_ids=adapter_ids),
    )

  def prefill_into_pages_many_sampled(self, tokens, pool, bt_rows, prefix_lens, prompt_lens, page_size: int, temps, top_ks, k_max: int, key, adapter_ids=None):
    from ..models.decoder import prefill_into_pages_many_sampled

    progs = self._programs_for(pool)
    if progs is not None:
      return progs.prefill(tokens, bt_rows, prefix_lens, prompt_lens, page_size, temps, top_ks, k_max, key, adapter_ids), pool
    eng = self.engine
    return prefill_into_pages_many_sampled(
      eng.params, eng.cfg, eng._effective_shard, self._dev(tokens), pool, self._dev(bt_rows),
      self._dev(prefix_lens), self._dev(prompt_lens), int(page_size),
      self._dev(temps), self._dev(top_ks), self._generator(key), int(k_max), **self._adapter_kw(adapter_ids=adapter_ids),
    )

  def paged_batch_decode(self, token, pool, block_tables, positions, active, temps, top_ks, n_steps: int, k_max: int, page_size: int, key, adapter_ids=None):
    from ..models.decoder import fused_paged_batch_decode

    progs = self._programs_for(pool)
    if progs is not None:
      return (*progs.decode(token, block_tables, positions, active, temps, top_ks, n_steps, k_max, page_size, key, adapter_ids), pool)
    eng = self.engine
    return fused_paged_batch_decode(
      eng.params, eng.cfg, eng._effective_shard, self._dev(token), pool, self._dev(block_tables), self._dev(positions),
      self._dev(active), self._dev(temps), n_steps, top_k=self._dev(top_ks), k_max=k_max, page_size=page_size,
      generator=self._generator(key), **self._adapter_kw(adapter_ids=adapter_ids),
    )

  # ------------------------------------------------- batched speculation

  def spec_supported(self) -> bool:
    """The model proposer is available: the engine holds a draft (the int8
    self-draft or a draft checkpoint)."""
    return getattr(self.engine, "_draft_params", None) is not None

  def spec_ngram_supported(self) -> bool:
    """The draft-free spec program runs here: it needs a full-model
    single-device backend, which this class is."""
    return True

  def draft_geometry(self):
    """(cfg_d, shard_d) of the draft: the target's own for a self-draft."""
    eng = self.engine
    return (getattr(eng, "_draft_cfg", None) or eng.cfg), (getattr(eng, "_draft_shard", None) or eng._effective_shard)

  def init_draft_cache(self, n_slots: int, max_seq: int):
    """The draft's slot cache [L_d, n_slots, max_seq, ...], in the model
    dtype whatever ``XOT_TPU_KV_QUANT`` says (a small cache, and int8
    rounding between the draft's proposals and the verify would buy
    nothing), joined to the current store's programs."""
    from ..models.decoder import init_kv_cache

    cfg_d, shard_d = self.draft_geometry()
    cache_d = init_kv_cache(cfg_d, shard_d.n_shard_layers, n_slots, max_seq, quant="", device=self.engine.device)
    if self.programs is not None:
      self.programs.set_draft(self.engine._draft_params, cfg_d, shard_d, cache_d)
    return cache_d

  def _draft_programs(self, cache_d):
    progs = self.programs
    return progs if progs is not None and progs.draft is not None and progs.draft[3] is cache_d else None

  def prefill_draft_into_slots(self, tokens, cache_d, rows, prompt_lens):
    """The draft's prompt prefill into its slot cache (its own dispatch of
    ``prefill.slots``, queued behind the target's admission); returns
    ``cache_d``, written in place."""
    from ..models.decoder import prefill_into_slots

    progs = self._draft_programs(cache_d)
    if progs is not None:
      progs.draft_prefill(tokens, rows, prompt_lens)
      return cache_d
    cfg_d, shard_d = self.draft_geometry()
    _, cache_d = prefill_into_slots(self.engine._draft_params, cfg_d, shard_d, self._dev(tokens), cache_d, self._dev(rows), self._dev(prompt_lens))
    return cache_d

  def _spec(self, store, cache_d, block_tables, token, positions, active, gammas, temps, top_ks, n_rounds, gamma_max, k_max, page_size, key, props, prop_counts, adapter_ids):
    """Either speculative chunk. ``cache_d`` None is the draft-free chunk
    (no model-drafted row in it); otherwise the draft proposes on it."""
    from ..models.decoder import fused_spec_batch_decode, fused_spec_paged_batch_decode

    progs = self._programs_for(store)
    use_draft = cache_d is not None
    if progs is not None and (not use_draft or self._draft_programs(cache_d) is progs):
      res = progs.spec(token, block_tables, positions, active, gammas, temps, top_ks, n_rounds, gamma_max, k_max, page_size, key, props=props, prop_counts=prop_counts, use_draft=use_draft, adapter_ids=adapter_ids)
      return (*res, store, cache_d)
    eng = self.engine
    cfg_d, shard_d = self.draft_geometry()
    params_d = eng._draft_params if use_draft else None
    rows = (self._dev(positions), self._dev(active), self._dev(gammas), self._dev(temps), n_rounds, gamma_max)
    kw = dict(
      top_k=self._dev(top_ks), k_max=k_max, generator=self._generator(key), adapter_ids=None if adapter_ids is None else self._dev(adapter_ids),
      props=None if props is None else self._dev(props), prop_counts=None if prop_counts is None else self._dev(prop_counts),
    )
    if block_tables is None:
      return fused_spec_batch_decode(eng.params, eng.cfg, eng._effective_shard, params_d, cfg_d, shard_d, self._dev(token), store, cache_d, *rows, **kw)
    return fused_spec_paged_batch_decode(
      eng.params, eng.cfg, eng._effective_shard, params_d, cfg_d, shard_d, self._dev(token), store, cache_d, self._dev(block_tables), *rows, page_size=page_size, **kw,
    )

  def spec_paged_batch_decode(self, token, pool, cache_d, block_tables, positions, active, gammas, temps, top_ks, n_rounds: int, gamma_max: int, k_max: int, page_size: int, key, props=None, prop_counts=None, adapter_ids=None):
    """One speculative chunk over the page pool
    (``fused_spec_paged_batch_decode``), the reference's signature. Returns
    (tokens, counts, n_prop, next_token, positions, pool, cache_d) with
    every tensor on the device; the scheduler queues the host copies of
    tokens, counts and n_prop behind one event (``to_host_async``), as it
    does for a plain chunk's tokens."""
    return self._spec(pool, cache_d, block_tables, token, positions, active, gammas, temps, top_ks, n_rounds, gamma_max, k_max, page_size, key, props, prop_counts, adapter_ids)

  def spec_batch_decode(self, token, cache, cache_d, positions, active, gammas, temps, top_ks, n_rounds: int, gamma_max: int, k_max: int, key, props=None, prop_counts=None, adapter_ids=None):
    """One speculative chunk over the slot cache (``fused_spec_batch_decode``),
    as ``spec_paged_batch_decode``."""
    return self._spec(cache, cache_d, None, token, positions, active, gammas, temps, top_ks, n_rounds, gamma_max, k_max, 0, key, props, prop_counts, adapter_ids)

  def mixed_tick_supported(self) -> bool:
    """The mixed prefill+decode program runs on this backend, except for an
    MLA model, which stays on the alternating schedule as in the
    reference."""
    return not self.engine.cfg.is_mla

  def mixed_paged_batch_decode(self, token, pool, block_tables, positions, active, temps, top_ks, n_steps: int, k_max: int, page_size: int, key, pf_tokens, pf_bt, pf_prefix, pf_end, adapter_ids=None, pf_adapter=None):
    """``paged_batch_decode`` with one admission's prefill slice fused in
    (``pf_tokens`` [1, pad], ``pf_bt`` [1, mp], ``pf_prefix``/``pf_end`` [1]),
    its host operands on the same non-blocking pinned path; ``pf_adapter``
    [1] is the slice's own adapter slot."""
    from ..models.decoder import fused_mixed_paged_batch_decode

    progs = self._programs_for(pool)
    if progs is not None:
      return (*progs.mixed(token, block_tables, positions, active, temps, top_ks, n_steps, k_max, page_size, key, pf_tokens, pf_bt, pf_prefix, pf_end, adapter_ids, pf_adapter), pool)
    eng = self.engine
    return fused_mixed_paged_batch_decode(
      eng.params, eng.cfg, eng._effective_shard, self._dev(token), pool, self._dev(block_tables), self._dev(positions),
      self._dev(active), self._dev(temps), self._dev(pf_tokens), self._dev(pf_bt), self._dev(pf_prefix), self._dev(pf_end), n_steps,
      top_k=self._dev(top_ks), k_max=k_max, page_size=page_size, generator=self._generator(key), **self._adapter_kw(adapter_ids=adapter_ids, pf_adapter=pf_adapter),
    )

  # ------------------------------------------------- KV tier page copies

  def read_pages(self, pool, pages):
    """Start copying ``pages`` of every pool leaf to the host (a KV-tier
    spill). Returns ``(host, ready)``: ``host`` maps each leaf to a host
    tensor ``[L, len(pages), ...]``, valid once the CUDA event ``ready``
    has fired (None on the CPU, where the copy is done on return).

    The gather (one ``index_select`` per leaf, into fresh buffers) runs on
    the current compute stream, so it reads the pages before any later
    dispatch that reuses them. A copy stream waits for it and copies into
    pinned host memory without blocking the host; ``record_stream`` keeps
    the caching allocator from handing the gathered buffers out again
    before that copy ends."""
    idx = self._dev(np.asarray(pages, dtype=np.int64))
    gathered = {name: leaf.index_select(1, idx) for name, leaf in pool.items()}
    if idx.device.type != "cuda":
      return gathered, None
    if self._copy_stream is None:
      self._copy_stream = torch.cuda.Stream(idx.device)
    copy = self._copy_stream
    done_gather = torch.cuda.Event()
    done_gather.record(torch.cuda.current_stream(idx.device))
    copy.wait_event(done_gather)
    host = {}
    with torch.cuda.stream(copy):
      for name, g in gathered.items():
        h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
        h.copy_(g, non_blocking=True)
        g.record_stream(copy)
        host[name] = h
    ready = torch.cuda.Event()
    ready.record(copy)
    return host, ready

  def write_pages(self, pool, pages, data):
    """Write host pages into ``pages`` of every pool leaf, in place (a
    KV-tier restore); returns the pool. ``data`` maps each leaf to the
    ``len(pages)`` host page tensors ``[L, ...]`` in ``pages`` order. Each
    leaf's pages are stacked into one staging tensor (pinned on the card)
    and copied non-blocking on the compute stream, ahead of the prefill
    that reads them; ``index_copy_`` writes them along the page axis."""
    idx = self._dev(np.asarray(pages, dtype=np.int64))
    pinned = idx.device.type == "cuda"
    for name, leaf in pool.items():
      parts = data[name]
      stage = torch.empty((leaf.shape[0], len(parts), *leaf.shape[2:]), dtype=leaf.dtype, pin_memory=pinned)
      torch.stack(parts, dim=1, out=stage)
      leaf.index_copy_(1, idx, stage.to(leaf.device, non_blocking=True))
    return pool
