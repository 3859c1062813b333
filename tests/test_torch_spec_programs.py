"""Solo speculation through the captured programs (models/decoder.py
``SoloPrograms``: ``spec_rounds`` for the draft chain, ``spec_batch`` for
the n-gram chain, the draft's prefill on its own cache paired with the
target's) against the JAX engine, on the CPU at f32 on the tiny
checkpoint, where every program runs its body eagerly through its buffers:

- each proposer (``XOT_TPU_SPEC_DECODE=ngram``, ``int8`` and
  ``XOT_TPU_SPEC_DRAFT=<dir>``) serves chained streaming chunks under the
  node's dispatch-ahead loop and blocking requests, the later requests on
  the pooled target+draft pair the first one returned: tokens, dispatch
  kinds and per-read counts equal the reference's on fresh caches; the
  builds and dispatches of ``spec.chunk``, ``spec.generate``,
  ``spec.batch``, ``decode.fused`` and ``decode.fused_generate`` equal the
  reference's ledger's, and the solo and draft prefills
  (``decode.shard_forward``) equal the reference's ``_prefill`` calls and
  jit cache entries; every spec dispatch ran through a program, with no
  more graphs per family than builds;
- the draft chain crosses its hand-off to plain near the cache end on a
  recycled pair, as the reference does on fresh caches, and leaves the
  session's chain state consistent;
- the load-time A/B, forced past its CPU check, times the programs' entry
  points (``fused_decode`` and ``fused_speculative_generate`` with
  ``programs=``, on a pooled pair with the draft, 256 slots or the
  engine's cap) as often as the
  reference times its compiled programs, and prints both rates as
  captured.
"""

import asyncio

import numpy as np
import pytest
import torch

from test_torch_engine import DirDownloader, make_tiny_llama
from test_torch_spec_solo import PROMPT, REPETITIVE, SPEC_KNOBS, _drive_stream, _kind, _state, _write_draft_checkpoint
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine
from xotorch_support_jetson_tpu_torch.models import decoder as tdec
from xotorch_support_jetson_tpu_torch.utils.programs import ledger

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

FAMILIES = ("spec.chunk", "spec.generate", "spec.batch", "decode.fused", "decode.fused_generate")
SECOND = np.array([[7, 12, 29, 41, 3, 88, 7, 12, 29]], dtype=np.int32)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama_spec_programs"))


@pytest.fixture
def spec_env(monkeypatch):
  for knob in SPEC_KNOBS:
    monkeypatch.delenv(knob, raising=False)
  monkeypatch.setenv("XOT_TPU_SPEC_NGRAM", "1")
  return monkeypatch


def _engines(path, spec_decode: str, max_seq: int):
  from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
  from xotorch_support_jetson_tpu.inference.shard import Shard as JShard

  je = JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False, max_seq_len=max_seq, spec_decode=spec_decode)
  te = TorchShardedInferenceEngine(DirDownloader(path), device="cpu", max_seq_len=max_seq, spec_decode=spec_decode)
  return (je, JShard("llama-3.2-1b", 0, 15, 16)), (te, Shard("llama-3.2-1b", 0, 15, 16))


async def _oneshot(engine, shard, prompt, rid, max_tokens, eos_ids=()):
  logits, _ = await engine.infer_tensor(rid, shard, prompt)
  first = int(np.argmax(np.asarray(logits), -1)[0])
  toks = [first] + await engine.generate_oneshot(rid, shard, first, max_tokens, eos_ids=eos_ids, temp=0.0)
  engine.end_request(rid)
  return toks, _state(engine, rid)


async def _traffic(engine, shard, prompt):
  """A streaming request (8-token chunks), a blocking one with an EOS id
  taken from it, then streaming again (4-token chunks) and blocking again:
  each request after the first on the pooled pair the one before it
  returned."""
  out = [await _drive_stream(engine, shard, prompt, "s1", 8, 30)]
  out.append(await _oneshot(engine, shard, prompt, "b1", 20, eos_ids=(out[0][0][9],)))
  out.append(await _drive_stream(engine, shard, SECOND, "s2", 4, 18))
  out.append(await _oneshot(engine, shard, SECOND, "b2", 24))
  return out


def _programs(te):
  return [p for free in te._cache_pool.values() for p in free]


@pytest.mark.parametrize("proposer", ["ngram", "int8", "cross"])
def test_each_proposer_through_the_programs_matches_the_reference(spec_env, tiny_dir, tmp_path, monkeypatch, proposer):
  import jax

  from xotorch_support_jetson_tpu.inference import jax_engine as jeng
  from xotorch_support_jetson_tpu.utils.programs import ledger as jledger

  if proposer == "cross":
    spec_env.setenv("XOT_TPU_SPEC_DRAFT", str(_write_draft_checkpoint(tmp_path / "draft", vocab=512)))
  (je, js), (te, ts) = _engines(tiny_dir, "ngram" if proposer == "ngram" else "int8", 128)
  calls = {"_prefill": 0}
  orig = jeng._prefill

  def counted(*a, **k):
    calls["_prefill"] += 1
    return orig(*a, **k)

  monkeypatch.setattr(jeng, "_prefill", counted)
  prompt = REPETITIVE if proposer == "ngram" else PROMPT

  async def run():
    await je.ensure_shard(js)
    await te.ensure_shard(ts)
    assert (te._draft_params is not None) == (je._draft_params is not None) == (proposer != "ngram")
    jax.clear_caches()  # the reference's builds are its jit cache entries: count from empty
    jledger.reset()
    ledger.reset()
    return await _traffic(je, js, prompt), await _traffic(te, ts, prompt)

  want, got = asyncio.run(run())
  assert got == want
  kinds = [r[1] for _, rec in (got[0], got[2]) for r in rec if r[0] == "dispatch"]
  assert ("ngram" if proposer == "ngram" else "spec") in kinds
  jsnap, tsnap = jledger.snapshot()["families"], ledger.snapshot()["families"]
  for fam in FAMILIES:
    j, t = jsnap.get(fam, {}), tsnap.get(fam, {})
    assert (t.get("compiles", 0), t.get("dispatches", 0)) == (j.get("compiles", 0), j.get("dispatches", 0)), fam
  spec_fams = ("spec.batch",) if proposer == "ngram" else ("spec.chunk", "spec.generate")
  assert all(tsnap[f]["dispatches"] > 0 for f in spec_fams)
  sf = tsnap["decode.shard_forward"]
  monkeypatch.undo()
  assert sf["dispatches"] == calls["_prefill"] and sf["compiles"] == jeng._prefill._cache_size()
  # One pooled pair served every request; its programs ran every dispatch.
  (progs,) = _programs(te)
  assert (progs.draft is not None) == (proposer != "ngram")
  graphs = progs.graphs() + (progs.draft.graphs() if progs.draft else [])
  for fam in spec_fams:
    built = [g for g in graphs if g.family == fam]
    assert len(built) <= tsnap[fam]["compiles"], fam
  assert sum(g.family in spec_fams for g in graphs) > 0
  if progs.draft is not None:
    assert [g.family for g in progs.draft.graphs()] == ["decode.shard_forward"]  # the draft's prompt bucket


def test_draft_chain_hands_off_near_the_cache_end_on_a_recycled_pair(spec_env, tiny_dir):
  """A 64-slot engine: one request fills the pooled pair and returns it,
  the next streams to the cache's end on it. Tokens, kinds, counts and
  the policy state equal the reference's on fresh caches; after the
  hand-off the plain chain holds the last token at the cache's end."""
  (je, js), (te, ts) = _engines(tiny_dir, "int8", 64)
  seen = {}

  async def drive(e, s):
    fill = await _drive_stream(e, s, SECOND, "fill", 8, 40)
    logits, _ = await e.infer_tensor("end", s, PROMPT)
    first = int(np.argmax(np.asarray(logits), -1)[0])
    toks, records, pending = [first], [], await e.dispatch_chunk("end", s, 8, 0.0, 35, first_token=first)
    while pending is not None:
      nxt = await e.dispatch_chunk("end", s, 8, 0.0, 35)
      records.append(_kind(pending))
      toks += await e.read_chunk(pending)
      pending = nxt
    session = e.sessions["end"]
    if e is te:
      seen.update(
        programs=session.programs, next_token=int(session.next_token_dev.reshape(-1)[-1]), curr_pos=session.curr_pos,
        chain=(session.spec_seed_dev, session.spec_pos_dev, session.spec_inflight_slots),
      )
    e.end_request("end")
    return fill, toks, records, _state(e, "end")

  async def run():
    await je.ensure_shard(js)
    await te.ensure_shard(ts)
    return await drive(je, js), await drive(te, ts)

  want, got = asyncio.run(run())
  assert got == want
  _, toks, records, _ = got
  assert records[0] == "spec" and "plain" in records and len(toks) == 64 - PROMPT.shape[1] + 1
  (progs,) = _programs(te)
  assert seen["programs"] is progs and progs.draft is not None
  assert seen["curr_pos"] == 64 and seen["next_token"] == toks[-1] and seen["chain"] == (None, None, 0)


def test_spec_calibration_times_the_programs(tiny_dir, monkeypatch, capsys):
  """The A/B forced past its CPU check (the device set to ``meta``, the
  entry points recorded instead of run): plain through ``fused_decode``
  and speculation through ``fused_speculative_generate``, each with
  ``programs=`` a pooled cache paired with the draft's (256 slots, or the
  engine's cap), a warm-up
  and two timed runs each, as the reference's A/B dispatches its compiled
  ``decode.fused`` and ``spec.generate``; the verdict names both rates as
  captured."""
  from types import SimpleNamespace

  from xotorch_support_jetson_tpu.inference import jax_engine as jeng
  from xotorch_support_jetson_tpu.utils.programs import ledger as jledger
  from xotorch_support_jetson_tpu_torch.inference import torch_engine as teng

  (je, js), (te, ts) = _engines(tiny_dir, "int8", 128)
  asyncio.run(je.ensure_shard(js))
  asyncio.run(te.ensure_shard(ts))
  monkeypatch.setattr(jeng.jax, "devices", lambda *a: [SimpleNamespace(platform="gpu")])
  jledger.reset()
  je._maybe_calibrate_spec()
  jfams = jledger.snapshot()["families"]
  calls = []

  def plain(params, cfg, shard, token, cache, start, n, programs=None, **kw):
    calls.append(("plain", programs, cache, None))
    return torch.zeros((1, n), dtype=torch.int32), cache

  def spec(params_t, cfg_t, shard_t, params_d, cfg_d, shard_d, token, cache_t, cache_d, start, n, gamma=4, eos_ids=(), programs=None, **kw):
    calls.append(("spec", programs, cache_t, cache_d))
    return torch.zeros((n + gamma + 1,), dtype=torch.int32), n, n // (gamma + 1), cache_t, cache_d

  monkeypatch.setattr(teng, "fused_decode", plain)
  monkeypatch.setattr(tdec, "fused_speculative_generate", spec)
  monkeypatch.setattr(teng.torch.cuda, "synchronize", lambda *a: None)
  monkeypatch.setattr(te, "device", torch.device("meta"))
  draft = te._draft_params
  te._maybe_calibrate_spec()
  assert [c[0] for c in calls] == ["plain"] * jfams["decode.fused"]["dispatches"] + ["spec"] * jfams["spec.generate"]["dispatches"] == ["plain"] * 3 + ["spec"] * 3
  progs = calls[0][1]
  assert all(c[1] is progs for c in calls) and isinstance(progs, tdec.SoloPrograms) and progs.max_seq == min(256, te.max_seq_len)
  assert progs.draft is not None and progs.draft.params is draft
  assert all(c[2] is progs.cache for c in calls) and all(c[3] is progs.draft.cache for c in calls if c[0] == "spec")
  assert te.spec_calibration["verdict"] in ("kept", "DISABLED")
  assert "(captured rounds) vs plain" in capsys.readouterr().out
