"""Device-program ledger and the CUDA-graph program cache.

Own copy of the reference's ``utils/programs.py``. The reference runs every
serving-path computation as a compiled program (``tracked_jit``): one per
prefill bucket, one ``lax.scan`` per decode chunk, one ``while_loop`` per
blocking generate. Its ledger counts, per program family, the compiles
(first dispatch at a new abstract signature), the dispatches, and the
compiles after warmup (``steady_compiles``), and serves them at
``GET /v1/programs``. The port keeps that ledger with the same snapshot
schema and the same signature rule:

- ``ledger.dispatch(family, named, static, fn)`` runs ``fn`` and records
  one dispatch of ``family``. Its key is the abstract signature of the
  arguments in ``named`` — tensors by dtype and shape, dicts of tensors
  leaf by leaf, the names in ``static`` by value, any other scalar by type,
  as a jit cache keys a call — so the first dispatch at a new key counts as a
  build ("compile"), and a new position, temperature or prompt length
  within a bucket builds nothing. ``tracked(family, static_argnames)`` is
  the decorator form (the counterpart of ``tracked_jit``).
- ``Graph`` is what a build makes on the card: a ``torch.cuda.CUDAGraph``
  of one unit of work, captured the first time it runs (that run itself is
  eager and is the dispatch's real work) and replayed at every later run.
  The captured solo programs (models/decoder.py ``SoloPrograms``) are made
  of them — each prefill bucket, decode step, speculative round and n-gram
  chunk is one replay, and so is each bucket of the prefill entered with
  embeddings (llava's merged image and text embeddings, family
  ``prefill.embeds``, the tower itself running eagerly as
  ``vision.encode``) — and
  so are the batched server's (``BatchedPrograms``): each admission
  prefill and each plain, mixed or speculative chunk, all its steps or
  rounds, is one replay. A run can reseed the graph's generators first
  (``seed``), so a replay draws what an eager run from a freshly seeded
  generator draws. On the CPU a Graph runs its body eagerly every time, so
  the bookkeeping is testable anywhere. A capture or replay that fails
  raises: there is no fallback to the eager loop; a capture runs with the
  garbage collector off (``_no_collection``). Captures and replays are
  counted per family next to the reference's keys (``captures``,
  ``replays``, ``capture_s``, ``graph_kernels``); ``pool_bytes`` reads what
  a graph memory pool holds.
- Launch accounting. A kernel wrapper launches nothing while its stream is
  being captured (ops/kernels.py ``count_launch`` counts that call in
  ``CAPTURED`` instead of its ``LAUNCHES``); each Graph keeps the kernels
  its capture recorded and adds them to ``REPLAYED`` at every replay —
  the count at capture times the replays — so host launches plus
  ``REPLAYED`` is every launch of a wrapper's kernel.
- **Warmup**: the batched server enumerates its expected families
  (inference/batch_scheduler.py ``warmup_manifest``); ``POST /v1/warmup``
  drives them and calls :meth:`ProgramLedger.mark_steady`. A build after
  that bumps ``steady_compiles`` and ``program_steady_compiles_total``.

Knobs:

- ``XOT_TPU_PROGRAMS`` (default on) — ``0`` stops the recording only; what
  runs, captured or not, is the same either way.
- ``XOT_TPU_PROGRAMS_BLOCK`` (default off) — ``1`` synchronizes the device
  at the end of every recorded dispatch, so ``device_s`` is device time and
  not enqueue time. Off the serving path only: it stops the host from
  running ahead of the card.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import inspect
import os
import threading
import time
from contextlib import contextmanager

from .metrics import metrics


def programs_enabled() -> bool:
  """Checked per call (not at import) so tests can toggle it."""
  return os.getenv("XOT_TPU_PROGRAMS", "1") not in ("0", "false")


def _blocking_enabled() -> bool:
  return os.getenv("XOT_TPU_PROGRAMS_BLOCK", "0") in ("1", "true")


def _is_tensor(x) -> bool:
  return hasattr(x, "shape") and hasattr(x, "dtype")


def _dtype_name(dtype) -> str:
  return str(dtype).removeprefix("torch.")


def _describe_one(x) -> str:
  """One argument → a compact signature token: tensors as ``dtype[shape]``,
  dicts of tensors as a leaf count, like the reference's."""
  if _is_tensor(x):
    return f"{_dtype_name(x.dtype)}[{','.join(str(d) for d in x.shape)}]"
  if isinstance(x, dict):
    return f"tree({sum(1 for _ in _leaves(x))} leaves)"
  if isinstance(x, (tuple, list)):
    if len(x) > 4:
      return f"{type(x).__name__}[{len(x)}]"
    return f"({','.join(_describe_one(e) for e in x)})"
  if isinstance(x, (bool, int, float, str, type(None))):
    return repr(x)
  return type(x).__name__


def describe_signature(args: tuple, kwargs: dict) -> str:
  parts = [_describe_one(a) for a in args]
  parts += [f"{k}={_describe_one(v)}" for k, v in sorted(kwargs.items())]
  sig = ", ".join(parts)
  return sig if len(sig) <= 512 else sig[:509] + "..."


def _leaves(tree):
  if isinstance(tree, dict):
    for k in sorted(tree):
      yield from _leaves(tree[k])
  else:
    yield tree


def _abstract(x, static: bool = False):
  """The part of an argument that keys a build: a tensor's dtype, shape and
  device type; a dict's keys and leaves; a static argument's value; any
  other scalar's type only (a traced value in the reference)."""
  if _is_tensor(x):
    return ("T", _dtype_name(x.dtype), tuple(x.shape), getattr(getattr(x, "device", None), "type", None))
  if isinstance(x, dict):
    return ("D", tuple((k, _abstract(x[k], static)) for k in sorted(x)))
  if isinstance(x, (tuple, list)) and not static:
    return ("L", tuple(_abstract(e) for e in x))
  if static or x is None:
    return ("S", x)
  return ("P", type(x).__name__)


def signature_key(named: dict, static: tuple = ()) -> tuple:
  return tuple((k, _abstract(v, k in static)) for k, v in sorted(named.items()))


class ProgramLedger:
  """Process-wide build / dispatch bookkeeping, keyed by program family."""

  MAX_SIGNATURES = 8  # per family — enough to see a storm's shapes, bounded

  def __init__(self) -> None:
    self._lock = threading.Lock()
    self._tls = threading.local()
    self._families: dict[str, dict] = {}
    self._seen: dict[str, set] = {}
    self._steady = False
    self._steady_ts: float | None = None
    self._manifest: list[dict] = []
    self._warmup: dict = {}

  # ------------------------------------------------------------- state

  def _family(self, family: str) -> dict:
    st = self._families.get(family)
    if st is None:
      st = {
        "compiles": 0,
        "steady_compiles": 0,
        "dispatches": 0,
        "compile_s": 0.0,
        "device_s": 0.0,
        "signatures": [],
        "last_compile_ts": None,
        "captures": 0,
        "replays": 0,
        "capture_s": 0.0,
        "graph_kernels": 0,
      }
      self._families[family] = st
    return st

  @property
  def steady(self) -> bool:
    return self._steady

  def mark_steady(self, manifest: list[dict] | None = None) -> None:
    """Warmup is done: from here on, every build is an anomaly."""
    with self._lock:
      self._steady = True
      self._steady_ts = time.time()
      if manifest is not None:
        self._manifest = list(manifest)
    metrics.set_gauge("programs_steady", 1.0)

  def reset(self) -> None:
    """Forget everything (the metrics registry keeps its series). Captured
    graphs stay with their owners; only their bookkeeping goes."""
    with self._lock:
      self._families.clear()
      self._seen.clear()
      self._steady = False
      self._steady_ts = None
      self._manifest = []
      self._warmup = {}
    metrics.set_gauge("programs_steady", 0.0)

  def note_warmup(self, manifest: list[dict], per_family_s: dict[str, float], total_s: float) -> None:
    with self._lock:
      self._warmup = {"ts": time.time(), "total_s": total_s, "families": dict(per_family_s)}
      self._manifest = list(manifest)
    metrics.set_gauge("warmup_programs", float(len(manifest)))
    metrics.observe_hist("warmup_compile_seconds", total_s)

  # ----------------------------------------------------------- queries

  def _total(self, key: str, family: str | None) -> int:
    with self._lock:
      if family is not None:
        return self._families.get(family, {}).get(key, 0)
      return sum(st[key] for st in self._families.values())

  def compile_count(self, family: str | None = None) -> int:
    return self._total("compiles", family)

  def steady_compile_count(self, family: str | None = None) -> int:
    return self._total("steady_compiles", family)

  def dispatch_count(self, family: str | None = None) -> int:
    return self._total("dispatches", family)

  def dispatch_counts(self) -> dict[str, int]:
    with self._lock:
      return {f: st["dispatches"] for f, st in self._families.items()}

  def snapshot(self) -> dict:
    """JSON-safe introspection payload (GET /v1/programs)."""
    with self._lock:
      fams = {
        f: {
          "compiles": st["compiles"],
          "steady_compiles": st["steady_compiles"],
          "dispatches": st["dispatches"],
          "compile_s": round(st["compile_s"], 6),
          "device_s": round(st["device_s"], 6),
          "signatures": list(st["signatures"]),
          "last_compile_ts": st["last_compile_ts"],
          "captures": st["captures"],
          "replays": st["replays"],
          "capture_s": round(st["capture_s"], 6),
          "graph_kernels": st["graph_kernels"],
        }
        for f, st in sorted(self._families.items())
      }
      return {
        "enabled": programs_enabled(),
        "steady": self._steady,
        "steady_ts": self._steady_ts,
        "families": fams,
        "manifest": list(self._manifest),
        "warmup": dict(self._warmup),
        "totals": _totals(fams),
      }

  @staticmethod
  def merge_snapshots(parts: list[dict]) -> dict:
    """Cluster scope: sum counts per family across node snapshots; the
    cluster is steady only if every reporting node is."""
    fams: dict[str, dict] = {}
    nodes = []
    for p in parts:
      nodes.append(p.get("node_id"))
      for f, st in (p.get("families") or {}).items():
        agg = fams.setdefault(f, {"compiles": 0, "steady_compiles": 0, "dispatches": 0, "compile_s": 0.0, "device_s": 0.0, "captures": 0, "replays": 0, "capture_s": 0.0, "signatures": []})
        for k in ("compiles", "steady_compiles", "dispatches", "captures", "replays"):
          agg[k] += int(st.get(k, 0))
        for k in ("compile_s", "device_s", "capture_s"):
          agg[k] = round(agg[k] + float(st.get(k, 0.0)), 6)
        for sig in st.get("signatures", []):
          if sig not in agg["signatures"] and len(agg["signatures"]) < ProgramLedger.MAX_SIGNATURES:
            agg["signatures"].append(sig)
    return {
      "scope": "cluster",
      "nodes": [n for n in nodes if n],
      "steady": all(bool(p.get("steady")) for p in parts) if parts else False,
      "families": {f: fams[f] for f in sorted(fams)},
      "totals": _totals(fams),
    }

  # ---------------------------------------------------------- dispatch

  def dispatch(self, family: str, named: dict, static: tuple, fn, call: tuple | None = None):
    """Run ``fn()`` as one dispatch of ``family`` at the signature of the
    arguments ``named`` (``call``: the (args, kwargs) as called, for the
    signature's text). A nested dispatch (inside another family's) counts
    its builds but not its dispatches, as a nested trace does in the
    reference."""
    if not programs_enabled():
      return fn()
    key = signature_key(named, static)
    depth = getattr(self._tls, "depth", 0)
    with self._lock:
      seen = self._seen.setdefault(family, set())
      new = key not in seen
      seen.add(key)
    if new:
      self._note_build(family, describe_signature(*(call or ((), named))))
    if depth:
      return fn()
    self._tls.depth = 1
    self._tls.built = built = [family] if new else []
    t0 = time.perf_counter()
    try:
      out = fn()
      if _blocking_enabled():
        _synchronize(out)
    finally:
      self._tls.depth = 0
      self._tls.built = None
    dt = time.perf_counter() - t0
    with self._lock:
      st = self._family(family)
      st["dispatches"] += 1
      if built:
        st["compile_s"] += dt
      else:
        st["device_s"] += dt
    metrics.inc("program_dispatch_total", labels={"family": family})
    if built:
      metrics.observe_hist("program_compile_seconds", dt, labels={"family": family})
      if self._steady:
        with self._lock:
          self._family(family)["steady_compiles"] += 1
        metrics.inc("program_steady_compiles_total", labels={"family": family})
    else:
      metrics.observe_hist("program_device_seconds", dt, labels={"family": family})
    return out

  def _note_build(self, family: str, sig: str) -> None:
    with self._lock:
      st = self._family(family)
      st["compiles"] += 1
      st["last_compile_ts"] = time.time()
      if sig not in st["signatures"]:
        st["signatures"].append(sig)
        del st["signatures"][: -self.MAX_SIGNATURES]
    metrics.inc("program_compiles_total", labels={"family": family})
    built = getattr(self._tls, "built", None)
    if built is not None and family not in built:
      built.append(family)

  def note_capture(self, family: str, seconds: float, kernel_nodes: int) -> None:
    if not programs_enabled():
      return
    with self._lock:
      st = self._family(family)
      st["captures"] += 1
      st["capture_s"] += seconds
      st["graph_kernels"] += kernel_nodes
    metrics.inc("program_captures_total", labels={"family": family})

  def note_replay(self, family: str) -> None:
    if not programs_enabled():
      return
    with self._lock:
      self._family(family)["replays"] += 1


def _totals(fams: dict) -> dict:
  return {k: sum(st[k] for st in fams.values()) for k in ("compiles", "steady_compiles", "dispatches", "captures", "replays")}


def _synchronize(out) -> None:
  for t in _leaves(out) if isinstance(out, dict) else (out if isinstance(out, (tuple, list)) else (out,)):
    if _is_tensor(t) and getattr(t.device, "type", None) == "cuda":
      import torch

      torch.cuda.synchronize(t.device)
      return


ledger = ProgramLedger()

_DISPATCH_TLS = threading.local()


@contextmanager
def dispatch_context(request_ids, node: str | None = None):
  """Set around a scheduler's device dispatches, so that a build they
  trigger can name the requests it stalled."""
  prev = getattr(_DISPATCH_TLS, "ctx", None)
  _DISPATCH_TLS.ctx = {"request_ids": [r for r in (request_ids or []) if r], "node": node}
  try:
    yield
  finally:
    _DISPATCH_TLS.ctx = prev


def current_dispatch_context() -> dict | None:
  return getattr(_DISPATCH_TLS, "ctx", None)


def tracked(family: str, static_argnames: tuple = ()):
  """Decorator: every call of the function is one ledger dispatch of
  ``family`` (the counterpart of ``tracked_jit``); ``static_argnames`` key
  builds by value, every other argument by its abstract signature."""

  def wrap(fn):
    params = inspect.signature(fn).parameters
    names = list(params)
    static = tuple(static_argnames)

    @functools.wraps(fn)
    def dispatching(*args, **kwargs):
      if not programs_enabled():
        return fn(*args, **kwargs)
      named = dict(zip(names, args))
      named.update(kwargs)
      return ledger.dispatch(family, named, static, lambda: fn(*args, **kwargs), (args, kwargs))

    dispatching.xot_family = family
    return dispatching

  return wrap


# ------------------------------------------------------------ CUDA graphs

# Kernel launches recorded into graphs while they were captured, and the
# launches their replays made (a graph's captured kernels at every replay).
CAPTURED: dict[str, int] = {}
REPLAYED: dict[str, int] = {}


def reset_replayed() -> None:
  REPLAYED.clear()


@contextmanager
def _no_collection():
  """No garbage collection while a stream captures: a collection there can
  free a graph that an unreachable cycle still held, and destroying a graph
  during a capture invalidates the capture."""
  enabled = gc.isenabled()
  gc.disable()
  try:
    yield
  finally:
    if enabled:
      gc.enable()


class Graph:
  """One step of device work, captured into a CUDA graph on its first run
  and replayed after; on the CPU ``body`` runs eagerly every time.

  ``body()`` reads its inputs from and writes its outputs to tensors that
  outlive the graph (static buffers filled in place before a run), so the
  replays find them at the addresses the capture saw. The first run is
  eager (it also does the lazy first-use work a capture must not see:
  kernel loads, cuBLAS handles), then the capture records ``body`` on a
  side stream without running it. Every generator in ``generators`` is
  registered with the graph, and its state is put back after the capture,
  so replays draw exactly what the eager path would draw. ``pool`` is a
  memory pool handle shared by the graphs of one owner (they replay on one
  stream, one at a time; their outputs are allocated outside)."""

  def __init__(self, family: str, body, generators=(), pool=None) -> None:
    self.family = family
    self.body = body
    self.generators = tuple(g for g in generators if g is not None)
    self.pool = pool
    self.graph = None
    self.kernels: dict[str, int] = {}  # wrapper launches per replay, by kernel
    self.kernel_nodes = 0  # every kernel node of the graph (cuGraphGetNodes)
    self.capture_s = 0.0  # the capture with its instantiation

  def run(self, device, family: str | None = None, seed: int | None = None) -> None:
    """One run of the body: eager on the CPU; on a CUDA device eager and
    captured the first time, replayed after (counted under ``family``,
    default the family that built the graph). ``seed`` reseeds every
    registered generator first (``manual_seed``): a replay reads the seed
    and offset the generator holds when it is launched, so each run draws
    what a fresh generator seeded with ``seed`` draws in the eager body."""
    if seed is not None:
      for g in self.generators:
        g.manual_seed(int(seed))
    if getattr(device, "type", device) != "cuda":
      self.body()
      return
    if self.graph is None:
      self.body()
      self._capture()
      return
    self.graph.replay()
    for name, n in self.kernels.items():
      REPLAYED[name] = REPLAYED.get(name, 0) + n
    ledger.note_replay(family or self.family)

  def _capture(self) -> None:
    import torch

    t0 = time.perf_counter()
    states = [g.get_state() for g in self.generators]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for g in self.generators:
      graph.register_generator_state(g)
    before = dict(CAPTURED)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), _no_collection():
      # thread_local: another thread's CUDA calls (the event loop's, a
      # copy stream's) are not an error while this thread captures.
      graph.capture_begin(*(() if self.pool is None else (self.pool,)), capture_error_mode="thread_local")
      try:
        self.body()
      finally:
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for g, s in zip(self.generators, states):
      g.set_state(s)
    self.kernels = {k: v - before.get(k, 0) for k, v in CAPTURED.items() if v - before.get(k, 0)}
    self.kernel_nodes = graph_kernel_nodes(graph.raw_cuda_graph())
    graph.instantiate()
    self.graph = graph
    self.capture_s = time.perf_counter() - t0
    ledger.note_capture(self.family, self.capture_s, self.kernel_nodes)


_CU_GRAPH_NODE_TYPE_KERNEL = 0


@functools.cache
def _libcuda():
  lib = ctypes.CDLL("libcuda.so.1")
  lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
  lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
  lib.cuGraphGetNodes.restype = lib.cuGraphNodeGetType.restype = ctypes.c_int  # CUresult
  return lib


def graph_kernel_nodes(raw_graph: int) -> int:
  """Kernel nodes of a captured ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``
  with ``keep_graph=True``), through the driver's ``cuGraphGetNodes`` /
  ``cuGraphNodeGetType`` (the runtime's cudaGraph* calls wrap the same
  handle)."""
  lib = _libcuda()
  n = ctypes.c_size_t(0)
  rc = lib.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None, ctypes.byref(n))
  if rc != 0:
    raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
  nodes = (ctypes.c_void_p * max(n.value, 1))()
  rc = lib.cuGraphGetNodes(ctypes.c_void_p(raw_graph), nodes, ctypes.byref(n))
  if rc != 0:
    raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
  kinds = ctypes.c_int(0)
  count = 0
  for i in range(n.value):
    rc = lib.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]), ctypes.byref(kinds))
    if rc != 0:
      raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {rc}")
    count += kinds.value == _CU_GRAPH_NODE_TYPE_KERNEL
  return count


def pool_bytes(pool) -> int | None:
  """Device bytes the caching allocator holds in the CUDA-graph memory pool
  ``pool`` (a ``torch.cuda.graph_pool_handle()``): the segments of the
  allocator's snapshot that belong to it. None where the snapshot does not
  name its segments' pools."""
  import torch

  total, named = 0, False
  for seg in torch.cuda.memory_snapshot():
    pid = seg.get("segment_pool_id")
    if pid is None:
      continue
    named = True
    if tuple(pid) == tuple(pool):
      total += int(seg["total_size"])
  return total if named else None


def kernels_in(fn) -> int:
  """Device kernels one call of ``fn`` launches on the card: the kernel
  nodes of a CUDA graph captured around a call (after a warm call). Every
  kernel the call enqueues on the capture stream is a node; the graph is
  never replayed."""
  import torch

  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph(keep_graph=True)
  stream = torch.cuda.Stream()
  stream.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(stream), _no_collection():
    graph.capture_begin(capture_error_mode="thread_local")
    try:
      fn()
    finally:
      graph.capture_end()
  torch.cuda.current_stream().wait_stream(stream)
  n = graph_kernel_nodes(graph.raw_cuda_graph())
  graph.reset()
  return n
