"""The port's program ledger and captured solo programs (utils/programs.py,
models/decoder.py ``SoloPrograms``) against the reference's ledger
(``xotorch_support_jetson_tpu/utils/programs.py``) and JAX engine, on the
CPU at a small size:

- the ledger's unit behaviour, each case run through the reference's
  ``tracked_jit`` and the port's ``tracked`` on the same inputs: builds,
  dispatches and signatures counted, static arguments by value, nested
  families, a build after ``mark_steady``, the snapshot, ``merge_snapshots``
  and ``XOT_TPU_PROGRAMS=0``;
- one request sequence through both engines gives the same build and
  dispatch counts for ``decode.fused`` and ``decode.fused_generate``, and
  for the solo prefill and one-token step (``decode.shard_forward`` in the
  port; the reference's engine runs them as the plain jits ``_prefill`` and
  ``_decode_step``, so their builds are its jit cache entries);
- a request served on a recycled pool cache equals the JAX engine's on a
  fresh one (greedy tokens identical, logits within rtol = atol = 2e-4);
- ``GET /v1/programs`` and ``POST /v1/warmup`` answer with the reference's
  keys, and the warmup manifest equals the reference's at the batched
  defaults;
- the speculation A/B keeps the draft when its timed run raises, in both
  engines.

The ``cuda``-marked cases hold the captured solo paths against the
uncaptured functions on a card (greedy and seeded sampled transcripts
identical, prefill logits within 2e-4 at f32), the batched programs too
(every family, bf16 / int8 / int4 pages and int4 weights, over a build
round and two replay rounds: tokens identical), and K3 inside a replay on
refilled inputs within its bound; they skip without a card. This
file imports JAX only inside the CPU cases, so the card cases run where
JAX is not installed (``-m cuda --noconftest``)."""

import asyncio
import json
import urllib.request

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu_torch.models import config as tconfig, decoder as tdec
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.utils.metrics import metrics as tm
from xotorch_support_jetson_tpu_torch.utils.programs import ProgramLedger, describe_signature, ledger, tracked

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _clean_ledgers():
  """Both ledgers are process-global: each case starts and ends forgotten."""
  ledger.reset()
  yield
  ledger.reset()


@pytest.fixture
def ref():
  """The reference's ledger module (imported here: the card cases run
  where JAX is absent), reset around the case."""
  import jax

  from xotorch_support_jetson_tpu.utils import programs as jprograms

  jprograms.ledger.reset()
  yield jprograms, jax
  jprograms.ledger.reset()


# --------------------------------------------------------------- the ledger


def _backends(ref):
  """(decorator, ledger, array maker) for the reference and the port."""
  jprograms, jax = ref
  import jax.numpy as jnp

  return [
    ("reference", lambda fam, st=(): jprograms.tracked_jit(fam, static_argnames=st), jprograms.ledger, lambda shape: jnp.ones(shape, jnp.float32), lambda y: np.asarray(y)),
    ("port", lambda fam, st=(): tracked(fam, st), ledger, lambda shape: torch.ones(shape, dtype=torch.float32), lambda y: y.numpy()),
  ]


def _counts(led, family):
  st = led.snapshot()["families"].get(family, {})
  return st.get("compiles", 0), st.get("dispatches", 0), st.get("steady_compiles", 0), list(st.get("signatures", []))


def _scenario(name, deco, led, arr, host):
  """One ledger scenario; returns what it observed."""
  if name == "counts":
    f = deco("test.unit")(lambda x: x * 2)
    for _ in range(3):
      host(f(arr((1, 3))))
    first = _counts(led, "test.unit")
    host(f(arr((2, 5))))
    return first, _counts(led, "test.unit"), led.snapshot()["families"]["test.unit"]["compile_s"] > 0.0
  if name == "static":

    def rep(x, n):
      return x * n

    f = deco("test.static", ("n",))(rep)
    for n in (3, 3, 4):
      host(f(arr((2,)), n))
    return _counts(led, "test.static")
  if name == "nested":
    inner = deco("test.inner")(lambda x: x + 1)
    outer = deco("test.outer")(lambda x: inner(x) * 3)
    host(outer(arr((4,))))
    host(outer(arr((4,))))
    return _counts(led, "test.outer"), _counts(led, "test.inner")
  if name == "steady":
    f = deco("test.sentinel")(lambda x: x * 2)
    host(f(arr((2, 2))))
    led.mark_steady(manifest=[{"family": "test.sentinel"}])
    host(f(arr((2, 2))))
    before = led.steady_compile_count()
    host(f(arr((3, 7))))  # a new shape after warmup
    return before, _counts(led, "test.sentinel"), led.snapshot()["steady"], led.snapshot()["manifest"]
  if name == "snapshot":
    f = deco("test.snap")(lambda x: x)
    host(f(arr((2,))))
    snap = led.snapshot()
    json.dumps(snap)
    return snap["totals"]["compiles"], snap["totals"]["dispatches"], snap["totals"]["steady_compiles"], snap["enabled"], snap["steady"], sorted(snap)
  raise AssertionError(name)


@pytest.mark.parametrize("name", ["counts", "static", "nested", "steady", "snapshot"])
def test_ledger_matches_the_reference(ref, name):
  (_, jdeco, jled, jarr, jhost), (_, tdeco, tled, tarr, thost) = _backends(ref)
  want = _scenario(name, jdeco, jled, jarr, jhost)
  got = _scenario(name, tdeco, tled, tarr, thost)
  assert got == want
  if name == "counts":
    assert got[1][:2] == (2, 4) and got[1][3] == ["float32[1,3]", "float32[2,5]"]
  if name == "nested":
    assert got == ((1, 2, 0, ["float32[4]"]), (1, 0, 0, ["float32[4]"]))
  if name == "steady":
    assert got[1][2] == 1 and tm.counter_value("program_steady_compiles_total", labels={"family": "test.sentinel"}) >= 1


def test_programs_off_records_nothing_and_changes_nothing(ref, monkeypatch):
  for _, deco, led, arr, host in _backends(ref):
    f = deco("test.poison")(lambda x: (x * 3 + 1).cumsum(0) if isinstance(x, torch.Tensor) else (x * 3 + 1).cumsum())
    on = host(f(arr((8,))))
    monkeypatch.setenv("XOT_TPU_PROGRAMS", "0")
    before = led.snapshot()["totals"]
    off = host(f(arr((8,))))
    assert np.array_equal(on, off)
    assert led.snapshot()["totals"] == before and led.snapshot()["enabled"] is False
    monkeypatch.delenv("XOT_TPU_PROGRAMS")


def test_describe_signature_and_merge_match_the_reference(ref):
  jprograms, _ = ref
  import jax.numpy as jnp

  assert describe_signature((torch.ones((2, 3), dtype=torch.int32), {"a": torch.ones(4)}, 7), {"flag": True}) == jprograms.describe_signature((jnp.ones((2, 3), jnp.int32), {"a": jnp.ones((4,))}, 7), {"flag": True})
  long = describe_signature(tuple(torch.ones(100 + i) for i in range(60)), {})
  assert len(long) <= 512 and long.endswith("...")
  a = {"node_id": "n0", "steady": True, "families": {"decode.batch": {"compiles": 2, "steady_compiles": 0, "dispatches": 10, "compile_s": 1.5, "device_s": 0.25, "signatures": ["int32[4,1]"]}}}
  b = {"node_id": "n1", "steady": False, "families": {
    "decode.batch": {"compiles": 1, "steady_compiles": 1, "dispatches": 4, "compile_s": 0.5, "device_s": 0.75, "signatures": ["int32[4,1]", "int32[8,1]"]},
    "prefill.slots": {"compiles": 1, "dispatches": 2},
  }}
  for parts in ([a, b], [a], []):
    want, got = jprograms.ProgramLedger.merge_snapshots(parts), ProgramLedger.merge_snapshots(parts)
    assert {k: v for k, v in got.items() if k not in ("families", "totals")} == {k: v for k, v in want.items() if k not in ("families", "totals")}
    for fam, st in want["families"].items():
      assert {k: got["families"][fam][k] for k in st if k != "xla_compile_s"} == {k: v for k, v in st.items() if k != "xla_compile_s"}
    assert {k: got["totals"][k] for k in want["totals"]} == want["totals"]


# ------------------------------------------------------------ the engines

SOLO = ("decode.fused", "decode.fused_generate")


def _tiny_dir(tmp_path_factory):
  from test_torch_engine import make_tiny_llama

  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_programs"))


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return _tiny_dir(tmp_path_factory)


def _engines(path):
  from test_torch_engine import DirDownloader
  from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
  from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
  from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine

  je = JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False)
  te = TorchShardedInferenceEngine(DirDownloader(path), device="cpu")
  return (je, JShard("llama-3.2-1b", 0, 15, 16)), (te, Shard("llama-3.2-1b", 0, 15, 16))


async def _traffic(engine, shard, prompts):
  """A request sequence: streaming chunks greedy and sampled at two
  temperatures, blocking greedy and sampled at two max_tokens within one
  bucket, one one-token step through infer_tensor; prompts of several
  lengths within the 128 bucket. Returns the greedy transcripts."""
  out = []
  for i, (prompt, mode) in enumerate(zip(prompts, ["chunks0", "chunks0.7", "chunks0.9", "oneshot0", "oneshot0.8", "oneshot0", "step"])):
    rid = f"r{i}"
    logits, _ = await engine.infer_prompt(rid, shard, prompt)
    first = int(np.argmax(logits[0]))
    if mode.startswith("chunks"):
      temp = float(mode[6:])
      toks = await engine.read_chunk(await engine.dispatch_chunk(rid, shard, 6, temp, 35, first_token=first))
      toks += await engine.read_chunk(await engine.dispatch_chunk(rid, shard, 6, temp, 35))
    elif mode.startswith("oneshot"):
      temp = float(mode[7:])
      toks = await engine.generate_oneshot(rid, shard, first, 12 if i < 5 else 10, eos_ids=(2,), temp=temp)
    else:
      step, _ = await engine.infer_tensor(rid, shard, np.asarray([[first]], dtype=np.int32))
      toks = [int(np.argmax(step[0]))]
    if mode in ("chunks0", "oneshot0", "step"):  # greedy: comparable across engines
      out.append([first] + toks)
    engine.end_request(rid)
  return out


def test_engine_program_counts_match_the_reference(tiny_dir, monkeypatch):
  import jax

  from xotorch_support_jetson_tpu.inference import jax_engine as jeng
  from xotorch_support_jetson_tpu.utils.programs import ledger as jledger

  (je, js), (te, ts) = _engines(tiny_dir)
  prompts = ["hello world", "hello world how are you today", "the quick brown fox", "the quick brown fox the quick brown fox", "hello", "you today", "brown fox"]
  calls = {"_prefill": 0, "_decode_step": 0}
  for name in calls:
    orig = getattr(jeng, name)

    def counted(*a, _orig=orig, _name=name, **k):
      calls[_name] += 1
      return _orig(*a, **k)

    monkeypatch.setattr(jeng, name, counted)

  async def run():
    await je.ensure_shard(js)
    await te.ensure_shard(ts)
    jax.clear_caches()  # the reference's builds are its jit cache entries: count from empty
    jledger.reset()
    ledger.reset()
    want = await _traffic(je, js, prompts)
    got = await _traffic(te, ts, prompts)
    return want, got

  want, got = asyncio.run(run())
  assert got == want
  jsnap, tsnap = jledger.snapshot()["families"], ledger.snapshot()["families"]
  for fam in SOLO:
    assert (tsnap[fam]["compiles"], tsnap[fam]["dispatches"]) == (jsnap[fam]["compiles"], jsnap[fam]["dispatches"]), fam
  assert tsnap["decode.fused"]["compiles"] == 2  # greedy, and sampled at any temperature
  assert tsnap["decode.fused_generate"]["compiles"] == 2  # one step-count bucket (16), greedy and sampled
  sf = tsnap["decode.shard_forward"]
  assert sf["dispatches"] == calls["_prefill"] + calls["_decode_step"] == len(prompts) + 1
  monkeypatch.undo()
  assert sf["compiles"] == jeng._prefill._cache_size() + jeng._decode_step._cache_size() == 2  # one prompt bucket, one step


def test_recycled_pool_cache_equals_the_reference_on_a_fresh_one(tiny_dir):
  from test_torch_engine import PROMPT

  (je, js), (te, ts) = _engines(tiny_dir)

  async def serve(engine, shard, rid):
    logits, _ = await engine.infer_prompt(rid, shard, PROMPT)
    first = int(np.argmax(logits[0]))
    step, _ = await engine.infer_tensor(rid, shard, np.asarray([[first]], dtype=np.int32))
    nxt = int(np.argmax(step[0]))
    toks = await engine.read_chunk(await engine.dispatch_chunk(rid, shard, 8, 0.0, 35, first_token=nxt))
    toks += await engine.read_chunk(await engine.dispatch_chunk(rid, shard, 8, 0.0, 35))
    out = logits, step, [first, nxt] + toks
    if engine is je:
      engine.end_request(rid)
    return out

  async def run():
    want = await serve(je, js, "a")
    # A longer request fills the port's cache well past the next prompt,
    # then hands it back to the pool.
    logits, _ = await te.infer_prompt("fill", ts, "the quick brown fox " * 10)
    await te.generate_oneshot("fill", ts, int(np.argmax(logits[0])), 40, eos_ids=(), temp=0.0)
    filled = te.sessions["fill"].programs
    assert int((filled.cache["k"][:, 0].abs().sum(dim=(0, 2, 3)) > 0).sum()) > 60
    te.end_request("fill")
    got = await _serve_recorded(te, ts, serve, filled)
    return want, got

  want, got = asyncio.run(run())
  np.testing.assert_allclose(got[0], want[0], **TOL)
  np.testing.assert_allclose(got[1], want[1], **TOL)
  assert got[2] == want[2]


async def _serve_recorded(te, ts, serve, filled):
  """``serve`` on the port engine; it must take the ``filled`` cache, and
  give it back at its end."""
  got = await serve(te, ts, "b")
  assert te.sessions["b"].programs is filled and not any(te._cache_pool.values())
  te.end_request("b")
  assert [p for free in te._cache_pool.values() for p in free] == [filled]
  return got


# -------------------------------------------------------------- endpoints


def _get(port, path):
  with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
    return json.loads(resp.read())


def _post(port, path, body):
  req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as resp:
    return json.loads(resp.read())


def test_warmup_manifest_matches_the_reference_at_the_batched_defaults(tiny_dir, monkeypatch):
  from xotorch_support_jetson_tpu.inference.batch_scheduler import BatchedServer as JaxBatchedServer
  from xotorch_support_jetson_tpu_torch.inference.batch_scheduler import BatchedServer

  monkeypatch.delenv("XOT_TPU_SPEC_NGRAM", raising=False)  # the batched defaults, both sides
  (je, js), (te, ts) = _engines(tiny_dir)

  async def run():
    await je.ensure_shard(js)
    await te.ensure_shard(ts)
    out = []
    for server in (JaxBatchedServer(je), BatchedServer(te)):
      before = server.warmup_manifest()
      res = await server.warmup()
      out.append((before, res["manifest"], sorted(res), res["steady"], res["errors"], server.warmup_manifest()))
      server.shutdown()
    return out

  want, got = asyncio.run(run())
  assert got == want
  assert [e["family"] for e in got[5]] == ["prefill.pages_many_sampled", "spec.paged_batch", "decode.paged_batch", "decode.mixed_paged_batch"]
  assert [e["warmed"] for e in got[1]] == [True, True, False]  # the mixed tick needs a prefill arriving mid-decode
  assert ledger.steady and ledger.snapshot()["manifest"] == got[1]


def test_programs_and_warmup_endpoints(tiny_dir, monkeypatch, ref):
  import jax.numpy as jnp

  from xotorch_support_jetson_tpu_torch import main as tmain
  from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

  jprograms, _ = ref
  np.asarray(jprograms.tracked_jit("test.keys")(lambda x: x)(jnp.ones((2,))))
  jsnap = jprograms.ledger.snapshot()
  monkeypatch.setenv("XOT_TPU_MODEL_DIR", str(tiny_dir))
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  port = find_available_port("127.0.0.1")
  args = tmain.build_parser().parse_args(["--discovery-module", "none", "--chatgpt-api-port", str(port), "--temp", "0.0", "--max-generate-tokens", "6", "--node-id", "test"])
  chat = {"model": "llama-3.2-1b", "messages": [{"role": "user", "content": "hello world"}], "temperature": 0, "stream": False}

  async def run():
    node, api, engine, _ = tmain.build_components(args)
    server = await api.run(host="127.0.0.1", port=port)
    try:
      first = await asyncio.to_thread(_post, port, "/v1/chat/completions", chat)
      cold = await asyncio.to_thread(_get, port, "/v1/programs")
      warm = await asyncio.to_thread(_post, port, "/v1/warmup", {})
      again = await asyncio.to_thread(_post, port, "/v1/chat/completions", chat)
      snap = await asyncio.to_thread(_get, port, "/v1/programs")
      cluster = await asyncio.to_thread(_get, port, "/v1/programs?scope=cluster")
    finally:
      server.close()
      await server.wait_closed()
      engine._drop_batched_server()
    return first, cold, warm, again, snap, cluster

  first, cold, warm, again, snap, cluster = asyncio.run(run())
  assert again["choices"][0]["message"]["content"] == first["choices"][0]["message"]["content"]
  assert sorted(cold) == sorted([*jsnap, "node_id"]) and cold["node_id"] == "test" and cold["steady"] is False
  ref_family_keys = set(jsnap["families"]["test.keys"]) - {"xla_compile_s"}  # the XLA backend's own compile seconds: no counterpart
  for fam in ("decode.shard_forward", "decode.fused_generate"):
    assert ref_family_keys <= set(cold["families"][fam]) and cold["families"][fam]["compiles"] == 1
  assert sorted(warm) == ["errors", "manifest", "steady", "warmup_s"] and warm["steady"] is True and warm["errors"] == []
  assert [e["family"] for e in warm["manifest"]] == ["prefill.pages_many_sampled", "decode.paged_batch", "decode.mixed_paged_batch"]
  assert snap["steady"] is True and snap["totals"]["steady_compiles"] == 0  # the repeat built nothing
  assert snap["families"]["decode.fused_generate"]["dispatches"] == 2
  assert cluster["scope"] == "cluster" and cluster["nodes"] == ["test"] and cluster["unreachable"] == []
  assert cluster["totals"]["dispatches"] == snap["totals"]["dispatches"]


# ------------------------------------------------------- the speculation A/B


def test_spec_calibration_failure_keeps_the_draft_in_both_engines(tiny_dir, monkeypatch, capsys):
  """The A/B is skipped on the CPU; both engines are forced past that check
  and their timed run raises: each keeps its draft and says why only
  under DEBUG."""
  from types import SimpleNamespace

  from xotorch_support_jetson_tpu.inference import jax_engine as jeng
  from xotorch_support_jetson_tpu.models import decoder as jdecoder
  from xotorch_support_jetson_tpu_torch.inference import torch_engine as teng

  (je, js), (te, ts) = _engines(tiny_dir)
  asyncio.run(je.ensure_shard(js))
  asyncio.run(te.ensure_shard(ts))

  def boom(*a, **k):
    raise RuntimeError("forced failure of the timed run")

  monkeypatch.setattr(jdecoder, "fused_decode", boom)
  monkeypatch.setattr(teng, "fused_decode", boom)
  monkeypatch.setattr(jeng.jax, "devices", lambda *a: [SimpleNamespace(platform="gpu")])
  monkeypatch.setattr(te, "device", torch.device("meta"))  # not the CPU: the A/B runs (on meta tensors) up to the raise
  for debug in (0, 1):
    monkeypatch.setattr(jeng, "DEBUG", debug)
    monkeypatch.setattr(teng, "DEBUG", debug)
    for engine in (je, te):
      engine._draft_params = engine.params  # a stand-in draft
      engine._maybe_calibrate_spec()
      assert engine._draft_params is engine.params
    out = capsys.readouterr().out
    assert ("[jax_engine] spec calibration failed" in out) == ("[torch_engine] spec calibration failed" in out) == bool(debug)
  assert te.spec_calibration is None


# ------------------------------------------------------------ on the card


def _card_model(quant: str = ""):
  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params

  cfg = tconfig.tiny_test_config(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512, max_seq_len=512, dtype=torch.bfloat16)
  shard = Shard("tiny", 0, 1, 2)
  params = tdec.init_shard_params(cfg, shard, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
  if quant == "int4":
    params = quantize_params(params, "int4")
  return cfg, shard, params


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8_kv", "int4", "k2"])
def test_captured_solo_paths_equal_uncaptured_on_the_card(card, mode, monkeypatch):
  from xotorch_support_jetson_tpu_torch.utils import programs

  if mode == "k2":
    monkeypatch.setenv("XOT_TPU_FLASH_DECODE", "1")
    monkeypatch.setenv("XOT_TPU_FLASH_DECODE_MIN", "256")
  cfg, shard, params = _card_model("int4" if mode == "int4" else "")
  kv = "int8" if mode == "int8_kv" else ""
  prompt = np.random.default_rng(0).integers(3, 512, (1, 128)).astype(np.int32)
  L = 77
  prog = tdec.SoloPrograms(params, cfg, shard, tdec.init_kv_cache(cfg, 2, 1, 512, quant=kv, device="cuda"), generator=torch.Generator(device="cuda"), pool=torch.cuda.graph_pool_handle())
  eager = tdec.init_kv_cache(cfg, 2, 1, 512, quant=kv, device="cuda")
  programs.reset_replayed()
  for rnd in range(2):  # the first round builds, the second replays
    want, _ = tdec.shard_forward(params, cfg, shard, torch.from_numpy(prompt).cuda(), torch.arange(128, dtype=torch.int32, device="cuda")[None], eager, head_pos=torch.tensor([L - 1], device="cuda"))
    got = prog.prefill(prompt, L)
    torch.testing.assert_close(got, want[:, 0, :], **TOL)
    first = int(torch.argmax(got[0]))
    for temp, seed in ((0.0, 0), (0.6, 11 + rnd)):
      prog.generator.manual_seed(seed)
      g_eager = torch.Generator(device="cuda").manual_seed(seed)
      start = L if temp == 0 else L + 40
      w1, _ = tdec.fused_decode(params, cfg, shard, torch.tensor([[first]], dtype=torch.int32, device="cuda"), eager, torch.tensor([start], dtype=torch.int32, device="cuda"), 20, temp=temp, top_k=35, generator=g_eager)
      g1, _ = tdec.fused_decode(params, cfg, shard, first, prog.cache, start, 20, temp=temp, top_k=35, programs=prog)
      w2, _, _ = tdec.fused_generate(params, cfg, shard, w1[:, -1:], eager, torch.tensor([start + 20], dtype=torch.int32, device="cuda"), 32, eos_ids=(int(w1[0, 3]),), temp=temp, top_k=35, generator=g_eager, n_limit=30)
      g2, n2, _ = tdec.fused_generate(params, cfg, shard, g1[:, -1:], prog.cache, start + 20, 32, eos_ids=(int(g1[0, 3]),), temp=temp, top_k=35, n_limit=30, programs=prog)
      assert torch.equal(g1, w1) and torch.equal(g2, w2), (mode, temp)
  assert len(prog.graphs()) == 3 and all(g.graph is not None for g in prog.graphs())  # the bucket, the greedy step, the sampled step
  # The second prefill was a replay: K1 once per layer inside it.
  assert programs.REPLAYED.get("flash_prefill", 0) == cfg.n_layers
  if mode == "k2":
    assert programs.REPLAYED.get("flash_decode", 0) > 0
  if mode == "int4":
    assert programs.REPLAYED.get("int4_matmul", 0) > 0


class OpsEngine:
  """What ``DecoderBatchOps`` reads of an engine."""

  def __init__(self, cfg, shard, params, device="cuda") -> None:
    self.cfg, self._effective_shard, self.params, self.device = cfg, shard, params, torch.device(device)


CARD_PS, CARD_MP, CARD_PAGES = 16, 8, 40  # 16-token pages, 8 a row (128 tokens), 4 rows and an admission


def _batched_traffic(ops, pool, seed: int) -> list:
  """``chip_smoke.batched_traffic`` at the card model's size: 3 prompts and
  the inactive padding row, plain chunks of 4 steps, spec chunks of 2
  rounds at depth 3 and 2, a mixed chunk with a 12-token slice."""
  import chip_smoke

  return chip_smoke.batched_traffic(ops, pool, seed, [37, 20 + seed % 5, 50], page=CARD_PS, mp=CARD_MP, steps=4, gamma=3, slice_tokens=12, slice_pad=16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8_kv", "int4_kv", "int4"])
def test_captured_batched_programs_equal_uncaptured_on_the_card(card, mode, monkeypatch):
  """The batched server's dispatches through ``BatchedPrograms`` (the pool
  ``init_pool`` made: one CUDA-graph replay each) against the eager
  functions on an identical pool, in a round that builds every graph and
  two that replay them on other rows, positions, tables, proposals and
  keys: every token identical (greedy and seeded sampled rows), one graph
  per family signature, each replaying its kernels (K1 in the prefill and
  mixed graphs' slices, K3 in every chunk, K4 on int4 weights) and
  holding kernel nodes; the pools agree on every page but the trash page."""
  from xotorch_support_jetson_tpu_torch.inference.batch_ops import DecoderBatchOps
  from xotorch_support_jetson_tpu_torch.utils import programs

  monkeypatch.setenv("XOT_TPU_KV_QUANT", {"int8_kv": "int8", "int4_kv": "int4"}.get(mode, ""))
  cfg, shard, params = _card_model("int4" if mode == "int4" else "")
  ops = DecoderBatchOps(OpsEngine(cfg, shard, params))
  captured = ops.init_pool(CARD_PAGES, CARD_PS)
  eager = {k: v.clone() for k, v in captured.items()}
  programs.reset_replayed()
  for rnd, seed in enumerate((5, 6, 7)):
    got = _batched_traffic(ops, captured, seed)
    want = _batched_traffic(ops, eager, seed)
    for i, ((kind, g), (_, w)) in enumerate(zip(got, want)):
      for a, b in zip(g, w):
        assert np.array_equal(a, b), (mode, rnd, i, kind)
  for key in captured:
    # Page 0 is the trash page: the padding row's and masked writes land
    # there in whatever order the kernels run, and nothing reads it.
    a, b = captured[key][:, 1:].float(), eager[key][:, 1:].float()
    close = torch.isclose(a, b, atol=1.0 if key in ("k", "v") and captured[key].dtype == torch.int8 else 2e-2, rtol=2e-2)
    assert bool(close.all()), (key, sorted({int(p) + 1 for p in (~close).nonzero()[:, 1].tolist()})[:8])
  graphs = {g.family: g for g in ops.programs.graphs()}
  fams = sorted(g.family for g in ops.programs.graphs())
  assert fams == ["decode.mixed_paged_batch", "decode.paged_batch", "prefill.pages_many_sampled", "spec.paged_batch", "spec.paged_batch"]
  assert all(g.graph is not None and g.kernel_nodes > 0 for g in ops.programs.graphs())
  L = cfg.n_layers
  assert graphs["decode.paged_batch"].kernels.get("paged_decode") == 4 * L  # K3 once per layer per step
  assert graphs["decode.mixed_paged_batch"].kernels.get("paged_decode") == 3 * L
  assert all(g.kernels.get("paged_decode") == 2 * L for g in ops.programs.graphs() if g.family == "spec.paged_batch")  # once per layer per round
  k1_in_slices = 0 if mode == "int4_kv" else L  # int4 pages prefill through the plain attention
  assert graphs["prefill.pages_many_sampled"].kernels.get("flash_prefill", 0) == k1_in_slices
  assert graphs["decode.mixed_paged_batch"].kernels.get("flash_prefill", 0) == k1_in_slices
  if mode == "int4":
    assert all(g.kernels.get("int4_matmul", 0) > 0 for g in ops.programs.graphs())
  # Round 1 replays its second plain chunk; rounds 2 and 3 replay every dispatch.
  assert programs.REPLAYED.get("paged_decode", 0) == 4 * L + 2 * (2 * 4 * L + 2 * 2 * L + 3 * L)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 9])
def test_k3_inside_a_replay_on_refilled_inputs(card, window):
  """K3 at the batched path's shapes (B=8 rows of a 64-page table,
  llama-3.2-1b's heads, bf16 pages; W=9: the flattened verify window)
  captured in a ``Graph``, its query, lengths and tables refilled after
  the capture: the replay's output is within K3's bound of its plain
  version on the new inputs, and the replay counts one launch."""
  from xotorch_support_jetson_tpu_torch.ops import paged
  from xotorch_support_jetson_tpu_torch.utils import programs

  gen = torch.Generator(device="cuda").manual_seed(4)
  B, W, P, ps, mp = 8, window, 8 * 64 + 1, 64, 64
  rows = B * W
  k = torch.randn((P, 8, ps, 64), generator=gen, device="cuda").to(torch.bfloat16)
  v = torch.randn((P, 8, ps, 64), generator=gen, device="cuda").to(torch.bfloat16)
  q = torch.randn((rows, 32, 64), generator=gen, device="cuda").to(torch.bfloat16)
  bt = torch.zeros((rows, mp), dtype=torch.int32, device="cuda")
  lengths = torch.zeros((rows,), dtype=torch.int32, device="cuda")

  def refill(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q.copy_(torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16))
    tables = (torch.randperm(P - 1, generator=g, device="cuda")[: B * mp].to(torch.int32) + 1).reshape(B, mp)
    bt.copy_(paged.window_block_tables(tables, W))
    lengths.copy_((torch.randint(1, mp * ps - W, (B, 1), generator=g, device="cuda") + torch.arange(W, device="cuda")[None, :]).reshape(rows).to(torch.int32))

  refill(0)
  out = paged.paged_decode_attention(q, k, v, bt, lengths, ps).clone()
  graph = programs.Graph("check.paged_decode", lambda: out.copy_(paged.paged_decode_attention(q, k, v, bt, lengths, ps)))
  graph.run(card)
  assert graph.kernels == {"paged_decode": 1} and programs.kernels_in(lambda: paged.paged_decode_attention(q, k, v, bt, lengths, ps)) == 1
  before = programs.REPLAYED.get("paged_decode", 0)
  refill(1)
  out.zero_()
  graph.run(card)
  torch.cuda.synchronize()
  want = paged.paged_decode_attention_ref(q, k, v, bt, lengths, ps).float()
  assert programs.REPLAYED.get("paged_decode", 0) - before == 1
  torch.testing.assert_close(out.float(), want, atol=2.5e-4, rtol=2.0**-7)


def _dense_traffic(ops, cache, cache_d, seed: int) -> list:
  """The dense layout's dispatches at the card model's size, as host
  arrays: three admissions into rows 2, 0 and 3 with the padding row on
  spare slot 1 (one sampled row), the draft's prefill of the greedy rows,
  two chained plain chunks of 4 steps, and a spec chunk of 2 rounds at
  depth cap 3 (the draft proposing when ``cache_d`` is given, else an
  n-gram stream on one row)."""
  rng = np.random.default_rng(seed)
  lens = np.array([37, 20 + seed % 5, 50, 1], np.int32)
  rows = np.array([2, 0, 3, 1], np.int32)
  tokens = np.zeros((4, 64), np.int32)
  for i in range(3):
    tokens[i, : lens[i]] = rng.integers(3, 512, lens[i])
  temps, top_ks = np.array([0.0, 0.7, 0.0, 0.0], np.float32), np.array([35, 20, 35, 1], np.int32)
  first, _ = ops.prefill_into_slots_sampled(tokens, cache, rows, lens, temps, top_ks, 64, seed)
  out = [first.cpu().numpy()]
  if cache_d is not None:
    greedy = [0, 2]
    ops.prefill_draft_into_slots(tokens[greedy], cache_d, rows[greedy], lens[greedy])
  by_row = np.zeros((4, 1), np.int32)
  by_row[rows[:3], 0] = out[0][:3]
  pos = np.zeros(4, np.int32)
  pos[rows[:3]] = lens[:3]
  r_temps, r_topk = np.zeros(4, np.float32), np.ones(4, np.int32)
  r_temps[rows[:3]], r_topk[rows[:3]] = temps[:3], top_ks[:3]
  active = np.zeros(4, bool)
  active[rows[:3]] = True
  token = by_row
  for step in range(2):
    toks, token, npos, _ = ops.batch_decode(token, cache, pos, active, r_temps, r_topk, 4, 64, seed + 1 + step)
    out += [toks.cpu().numpy(), npos.cpu().numpy()]
    pos = npos.cpu().numpy()
  gammas = np.zeros(4, np.int32)
  gammas[[2, 3]] = [3, 2]
  props = counts = None
  if cache_d is None:
    props = np.zeros((4, 2 * 4 + 3), np.int32)
    props[3, :6] = rng.integers(3, 512, 6)
    counts = np.array([0, 0, 0, 6], np.int32)
  res = ops.spec_batch_decode(token, cache, cache_d, pos, active, gammas, r_temps, r_topk, 2, 3, 64, seed + 3, props=props, prop_counts=counts)
  out += [t.cpu().numpy() for t in res[:5]]
  return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8_kv", "k2"])
@pytest.mark.parametrize("draft", ["none", "int8", "cross"])
def test_captured_dense_programs_equal_uncaptured_on_the_card(card, mode, draft, monkeypatch):
  """The dense layout's dispatches through ``BatchedPrograms`` (the slot
  cache ``init_cache`` made, the draft's cache joined to it) against the
  eager functions on identical caches, in a round that builds every graph
  and two that replay them: every token identical (greedy and seeded
  sampled rows); K1 in the admission prefill and in every verify window
  (and in the draft's catch-up and prefill), K2 in every plain step with
  ``XOT_TPU_FLASH_DECODE=1``."""
  from xotorch_support_jetson_tpu_torch.inference.batch_ops import DecoderBatchOps
  from xotorch_support_jetson_tpu_torch.utils import programs

  if mode == "k2":
    monkeypatch.setenv("XOT_TPU_FLASH_DECODE", "1")
    monkeypatch.setenv("XOT_TPU_FLASH_DECODE_MIN", "256")
  monkeypatch.setenv("XOT_TPU_KV_QUANT", "int8" if mode == "int8_kv" else "")
  cfg, shard, params = _card_model()
  eng = OpsEngine(cfg, shard, params)
  L_d = 0
  if draft != "none":
    eng._draft_cfg, eng._draft_shard, eng._draft_params = _card_draft(draft, cfg, shard, params)
    L_d = eng._draft_cfg.n_layers
  ops = DecoderBatchOps(eng)
  captured = ops.init_cache(4, 512)
  cd_captured = ops.init_draft_cache(4, 512) if draft != "none" else None
  eager = {k: v.clone() for k, v in captured.items()}
  cd_eager = None if cd_captured is None else {k: v.clone() for k, v in cd_captured.items()}
  programs.reset_replayed()
  for rnd, seed in enumerate((5, 6, 7)):
    got = _dense_traffic(ops, captured, cd_captured, seed)
    want = _dense_traffic(ops, eager, cd_eager, seed)
    for i, (a, b) in enumerate(zip(got, want)):
      assert np.array_equal(a, b), (mode, draft, rnd, i)
  graphs = {g.family: g for g in ops.programs.graphs()}
  want_fams = {"prefill.slots_sampled", "decode.batch", "spec.batch"} | ({"prefill.slots"} if draft != "none" else set())
  assert set(graphs) == want_fams and all(g.graph is not None and g.kernel_nodes > 0 for g in ops.programs.graphs())
  L = cfg.n_layers
  assert graphs["prefill.slots_sampled"].kernels.get("flash_prefill", 0) == L
  assert graphs["spec.batch"].kernels.get("flash_prefill", 0) == 2 * (L + L_d)  # the verify window, and the draft's catch-up, per round
  assert graphs["decode.batch"].kernels.get("flash_decode", 0) == (4 * L if mode == "k2" else 0)
  if draft != "none":
    assert graphs["prefill.slots"].kernels.get("flash_prefill", 0) == L_d
    assert graphs["spec.batch"].kernels.get("flash_decode", 0) == (2 * 3 * L_d if mode == "k2" else 0)  # the draft's proposal steps


def _card_draft(proposer: str, cfg, shard, params):
  """(cfg, shard, params) of the card model's draft: its int8 self-draft,
  or a 1-layer int8 model of another width on the same vocab."""
  from xotorch_support_jetson_tpu_torch.models.quantize import quantize_params

  if proposer == "int8":
    return cfg, shard, quantize_params(params, "int8")
  cfg_d = tconfig.tiny_test_config(vocab_size=512, dim=128, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=256, max_seq_len=512, dtype=torch.bfloat16)
  shard_d = Shard("draft", 0, 0, 1)
  return cfg_d, shard_d, quantize_params(tdec.init_shard_params(cfg_d, shard_d, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda"), "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8_kv"])
@pytest.mark.parametrize("proposer", ["ngram", "int8", "cross"])
def test_captured_spec_paths_equal_uncaptured_on_the_card(card, proposer, kv):
  """Solo speculation through ``SoloPrograms`` (a target cache paired with
  the draft's) against the eager functions on identical caches, in a round
  that builds every graph and two that replay them on refilled buffers:
  the prefills (target and draft), three draft-chain chunks chained on
  the device seed and position and a speculative oneshot with an EOS id,
  or three chained n-gram chunks with proposals and a tracking-only one:
  every token and count identical, one graph per depth or chunk shape,
  each round graph holding K1 once per target and draft layer."""
  from xotorch_support_jetson_tpu_torch.utils import programs

  quant = "int8" if kv == "int8_kv" else ""
  cfg, shard, params = _card_model()
  pool = torch.cuda.graph_pool_handle()
  draft = None
  if proposer != "ngram":
    cfg_d, shard_d, params_d = _card_draft(proposer, cfg, shard, params)
    draft = tdec.SoloPrograms(params_d, cfg_d, shard_d, tdec.init_kv_cache(cfg_d, cfg_d.n_layers, 1, 512, quant=quant, device="cuda"), pool=pool)
    cd = tdec.init_kv_cache(cfg_d, cfg_d.n_layers, 1, 512, quant=quant, device="cuda")
  prog = tdec.SoloPrograms(params, cfg, shard, tdec.init_kv_cache(cfg, 2, 1, 512, quant=quant, device="cuda"), generator=torch.Generator(device="cuda"), pool=pool, draft=draft)
  ct = tdec.init_kv_cache(cfg, 2, 1, 512, quant=quant, device="cuda")
  rng = np.random.default_rng(1)
  one = lambda v, dt=torch.int32: torch.full((1,), v, dtype=dt, device="cuda")  # noqa: E731
  programs.reset_replayed()
  for rnd in range(3):
    prompt = rng.integers(3, 512, (1, 128)).astype(np.int32)
    L = 60 + 7 * rnd
    x, pos128 = torch.from_numpy(prompt).cuda(), torch.arange(128, dtype=torch.int32, device="cuda")[None]
    want, _ = tdec.shard_forward(params, cfg, shard, x, pos128, ct, head_pos=torch.tensor([L - 1], device="cuda"))
    got = prog.prefill(prompt, L)
    torch.testing.assert_close(got, want[:, 0, :], **TOL)
    first = int(torch.argmax(want[0, 0]))
    if draft is None:
      g_in = e_in = (torch.tensor([[first]], dtype=torch.int32, device="cuda"), one(L))
      for c, G in enumerate((4, 4, 0)):  # the last chunk tracks only (no proposal)
        props = torch.from_numpy(rng.integers(3, 512, (1, 2 * (G + 1) + G)).astype(np.int32)).cuda() if G else None
        kw = dict(top_k=1, k_max=1, props=props, prop_counts=one(props.shape[1]) if G else None)
        args = (one(True, torch.bool), one(G), one(0.0, torch.float32), 2 if G else 8, G)
        g = tdec.fused_spec_batch_decode(params, cfg, shard, None, cfg, shard, g_in[0], prog.cache, None, g_in[1], *args, programs=prog, **kw)
        e = tdec.fused_spec_batch_decode(params, cfg, shard, None, cfg, shard, e_in[0], ct, None, e_in[1], *args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(g[:5], e[:5])), (proposer, kv, rnd, c)
        g_in, e_in = (g[3], g[4]), (e[3], e[4])
      continue
    want_d, _ = tdec.shard_forward(params_d, cfg_d, shard_d, x, pos128, cd, head_pos=torch.tensor([L - 1], device="cuda"))
    torch.testing.assert_close(draft.prefill(prompt, L), want_d[:, 0, :], **TOL)
    g_in = e_in = (torch.tensor([[first]], dtype=torch.int32, device="cuda"), L)
    for c in range(3):
      kw = dict(gamma=3, n_limit=6 + c, cfg_d=cfg_d, shard_d=shard_d, pos_hi=L + 12 * c)
      g = tdec.fused_speculative_chunk(params, cfg, shard, params_d, g_in[0], prog.cache, draft.cache, g_in[1], 8, programs=prog, **kw)
      e = tdec.fused_speculative_chunk(params, cfg, shard, params_d, e_in[0], ct, cd, e_in[1], 8, **kw)
      m = int(e[0][0])
      assert torch.equal(g[0][: 2 + m], e[0][: 2 + m]) and torch.equal(g[1], e[1]) and torch.equal(g[2], e[2]), (proposer, kv, rnd, c)
      g_in, e_in = (g[1], g[2]), (e[1], e[2])
    at = int(e_in[1])
    eg = tdec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, e_in[0], ct, cd, at, 32, gamma=3, n_limit=24)
    eos = (int(eg[0][5]),) if rnd == 1 else ()
    gg = tdec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, int(g_in[0]), prog.cache, draft.cache, at, 32, gamma=3, eos_ids=eos, n_limit=24, programs=prog)
    eg = tdec.fused_speculative_generate(params, cfg, shard, params_d, cfg_d, shard_d, e_in[0], ct, cd, at, 32, gamma=3, eos_ids=eos, n_limit=24)
    assert gg[1:3] == eg[1:3] and torch.equal(gg[0][: gg[1]], eg[0][: eg[1]]), (proposer, kv, rnd)
  graphs = prog.graphs() + (draft.graphs() if draft else [])
  assert all(g.graph is not None and g.kernel_nodes > 0 for g in graphs)
  spec = [g for g in graphs if g.family.startswith("spec.")]
  if draft is None:
    assert sorted(g.kernels.get("flash_prefill", 0) for g in spec) == [0, 2 * cfg.n_layers]  # the tracking-only chunk runs W=1
  else:
    assert len(spec) == 1 and spec[0].kernels.get("flash_prefill") == cfg.n_layers + cfg_d.n_layers  # one round: verify window and catch-up
  assert programs.REPLAYED.get("flash_prefill", 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [5, 9])
def test_k1_verify_window_inside_a_replay_on_refilled_inputs(card, Sq):
  """K1 at the solo verify windows (B=1, Sq = G+1, llama-3.2-1b's heads,
  a 4096-slot bf16 cache) captured in a ``Graph``, its query and offset
  refilled after the capture: the replay's output within K1's bounds of
  its plain version on the new inputs, one kernel node, one launch."""
  from xotorch_support_jetson_tpu_torch.ops import flash_attention as fa
  from xotorch_support_jetson_tpu_torch.utils import programs

  gen = torch.Generator(device="cuda").manual_seed(6)
  k, v = (torch.randn((1, 4096, 8, 64), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
  q = torch.randn((1, Sq, 32, 64), generator=gen, device="cuda").to(torch.bfloat16)
  off = torch.tensor([72], dtype=torch.int32, device="cuda")
  out = fa.flash_attention_prefill(q, k, v, q_offset=off).clone()
  graph = programs.Graph("check.flash_prefill", lambda: out.copy_(fa.flash_attention_prefill(q, k, v, q_offset=off)))
  graph.run(card)
  assert graph.kernels == {"flash_prefill": 1} and graph.kernel_nodes == 1
  q.copy_(torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16))
  off.fill_(4086)
  out.zero_()
  before = programs.REPLAYED.get("flash_prefill", 0)
  graph.run(card)
  torch.cuda.synchronize()
  want = fa.flash_attention_prefill_ref(q, k, v, q_offset=off).float()
  err = (out.float() - want).abs()
  assert programs.REPLAYED.get("flash_prefill", 0) - before == 1
  assert float(err.max()) <= 3e-2 and bool((err <= 1e-2 + 2.0**-7 * want.abs()).all())
