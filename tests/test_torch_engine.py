"""The port's engine against the JAX engine on one tiny HF llama checkpoint
built locally with ``transformers`` (the recipe of tests/test_hf_golden.py
and the verify skill), loaded from disk by both: prefill logits within
rtol = atol = 2e-4, and greedy ``generate_oneshot`` and chunked
``dispatch_chunk``/``read_chunk`` tokens identical — in bf16-layout weights
and under ``XOT_TPU_QUANT=int8`` (w8a16 and w8a8) and ``int4``."""

import asyncio
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from xotorch_support_jetson_tpu.inference.jax_engine import JaxShardedInferenceEngine
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu_torch.inference.engine import PromptTooLongError
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.torch_engine import TorchShardedInferenceEngine

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

PROMPT = "hello world how are you today the quick brown fox "


def make_tiny_llama(path: Path) -> Path:
  """The verify skill's §1 checkpoint: a 2-layer llama (f32) with a BPE
  tokenizer and a plain chat template, written as safetensors."""
  import torch
  from tokenizers import Tokenizer, models, pre_tokenizers, trainers
  from transformers import AutoConfig, AutoModelForCausalLM, PreTrainedTokenizerFast

  torch.manual_seed(0)
  cfg = AutoConfig.for_model(
    "llama", vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=256, tie_word_embeddings=False,
    torch_dtype="float32", eos_token_id=2, bos_token_id=1,
  )
  AutoModelForCausalLM.from_config(cfg).to(torch.float32).eval().save_pretrained(path, safe_serialization=True)
  tm = Tokenizer(models.BPE(unk_token="<unk>"))
  tm.pre_tokenizer = pre_tokenizers.Whitespace()
  tm.train_from_iterator(["hello world how are you today", "the quick brown fox"] * 50, trainers.BpeTrainer(vocab_size=512, special_tokens=["<unk>", "<s>", "</s>"]))
  tok = PreTrainedTokenizerFast(tokenizer_object=tm, unk_token="<unk>", bos_token="<s>", eos_token="</s>")
  tok.chat_template = "{% for m in messages %}{{ m['content'] }} {% endfor %}"
  tok.save_pretrained(path)
  return path


class DirDownloader:
  """Resolves every shard to one local checkpoint directory."""

  def __init__(self, path) -> None:
    self.path = Path(path)

  async def ensure_shard(self, shard, engine_classname):
    return self.path


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
  return make_tiny_llama(tmp_path_factory.mktemp("tiny_llama"))


def jax_engine(path):
  return JaxShardedInferenceEngine(DirDownloader(path), use_local_mesh=False)


def torch_engine(path):
  return TorchShardedInferenceEngine(DirDownloader(path), device="cpu")


async def _prefill_and_generate(engine, shard, rid, n_oneshot, chunks):
  """Prefill, greedy first token, then either one oneshot or chained chunks."""
  logits, _ = await engine.infer_prompt(rid, shard, PROMPT)
  first = int(np.argmax(logits[0]))
  if chunks:
    toks = await engine.read_chunk(await engine.dispatch_chunk(rid, shard, chunks[0], 0.0, 35, first_token=first))
    for n in chunks[1:]:
      toks += await engine.read_chunk(await engine.dispatch_chunk(rid, shard, n, 0.0, 35))
  else:
    toks = await engine.generate_oneshot(rid, shard, first, n_oneshot, eos_ids=(), temp=0.0)
  engine.end_request(rid)
  return logits, [first] + toks


def test_engine_parity_with_jax(tiny_dir):
  async def run():
    je, te = jax_engine(tiny_dir), torch_engine(tiny_dir)
    js, ts = JShard("llama-3.2-1b", 0, 15, 16), Shard("llama-3.2-1b", 0, 15, 16)
    jl, jone = await _prefill_and_generate(je, js, "a", 16, None)
    tl, tone = await _prefill_and_generate(te, ts, "a", 16, None)
    np.testing.assert_allclose(tl, jl, rtol=2e-4, atol=2e-4)
    assert tone == jone
    _, jch = await _prefill_and_generate(je, js, "b", 0, [8, 8])
    _, tch = await _prefill_and_generate(te, ts, "b", 0, [8, 8])
    assert tch == jch
    assert tch == tone  # chunked greedy == oneshot greedy
    assert te.sessions == {}
    assert te.cfg.n_layers == 2 and te._effective_shard == Shard("llama-3.2-1b", 0, 1, 2)  # registry depth remapped to the checkpoint's

  asyncio.run(run())


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_engine_quantized_parity_with_jax(tiny_dir, monkeypatch, mode):
  quant, compute = {"int8": ("int8", "w8a16"), "w8a8": ("int8", "w8a8"), "int4": ("int4", "w8a16")}[mode]
  monkeypatch.setenv("XOT_TPU_QUANT", quant)
  monkeypatch.setenv("XOT_TPU_QUANT_COMPUTE", compute)

  async def run():
    je, te = jax_engine(tiny_dir), torch_engine(tiny_dir)
    js, ts = JShard("llama-3.2-1b", 0, 15, 16), Shard("llama-3.2-1b", 0, 15, 16)
    await je.ensure_shard(js)
    # The JAX package reads XOT_TPU_QUANT_COMPUTE once, at import; its config
    # selects the mode per trace.
    je.cfg = dataclasses.replace(je.cfg, quant_compute=compute)
    jl, jone = await _prefill_and_generate(je, js, "a", 16, None)
    tl, tone = await _prefill_and_generate(te, ts, "a", 16, None)
    assert je.quant == te.quant == quant and te.cfg.quant_compute == compute
    assert te.params["layers"]["wq"].dtype == torch.int8 and te.params["lm_head"].dtype == torch.int8
    if quant == "int4":
      assert te.params["layers"]["wq"].shape[-2] * 2 == te.cfg.dim  # packed along the in-axis
    np.testing.assert_allclose(tl, jl, rtol=2e-4, atol=2e-4)
    assert tone == jone
    _, tch = await _prefill_and_generate(te, ts, "b", 0, [8, 8])
    assert tch == tone

  asyncio.run(run())


def test_engine_validates_the_quantization_knobs(monkeypatch):
  monkeypatch.setenv("XOT_TPU_QUANT", "fp8")
  with pytest.raises(ValueError, match="unsupported quantization mode 'fp8'"):
    TorchShardedInferenceEngine(device="cpu")
  assert TorchShardedInferenceEngine(device="cpu", quant="").quant is None  # the argument wins over the environment
  monkeypatch.setenv("XOT_TPU_QUANT", "int8")
  monkeypatch.setenv("XOT_TPU_QUANT_COMPUTE", "w4a4")
  with pytest.raises(ValueError, match="XOT_TPU_QUANT_COMPUTE"):
    TorchShardedInferenceEngine(device="cpu")


def test_engine_refuses_speculative_decoding(monkeypatch):
  """The engine speculates under XOT_TPU_SPEC_DECODE as the reference does
  (tests/test_torch_spec_solo.py holds it against the JAX engine), and its
  batched server takes the loaded draft as its "model" proposer
  (tests/test_torch_draft_batched.py holds that against the reference)."""
  from xotorch_support_jetson_tpu_torch.models.config import tiny_test_config
  from xotorch_support_jetson_tpu_torch.models.decoder import init_shard_params

  for knob in ("XOT_TPU_QUANT", "XOT_TPU_SPEC_DRAFT"):
    monkeypatch.delenv(knob, raising=False)
  monkeypatch.setenv("XOT_TPU_SPEC_DECODE", "int8")
  engine = TorchShardedInferenceEngine(device="cpu")
  cfg, shard = tiny_test_config(n_layers=2), Shard("m", 0, 1, 2)
  engine.load_test_model(shard, cfg, init_shard_params(cfg, shard, torch.Generator().manual_seed(0)))
  assert engine.spec_decode == "int8" and engine._draft_params is not None  # the int8 self-draft
  server = engine.get_batched_server()
  server._ensure_cache()
  assert server.ops.spec_supported() and server.spec_proposers[0] == "model" and server.draft_cache is not None
  server.shutdown()
  monkeypatch.setenv("XOT_TPU_SPEC_DECODE", "")
  engine = TorchShardedInferenceEngine(device="cpu")
  assert engine.quant is None and engine.spec_decode is None


def test_engine_prompt_too_long(tiny_dir):
  async def run():
    te = TorchShardedInferenceEngine(DirDownloader(tiny_dir), device="cpu", max_seq_len=8)
    with pytest.raises(PromptTooLongError):
      await te.infer_prompt("x", Shard("llama-3.2-1b", 0, 15, 16), PROMPT)
    assert te.sessions == {}

  asyncio.run(run())


def test_safetensors_writer_round_trips_through_both_readers(tmp_path):
  """The port's writer (used for the card's random-weight checkpoint) and
  reader agree with the ``safetensors`` library, bf16 included."""
  import torch
  from safetensors.torch import load_file

  from xotorch_support_jetson_tpu_torch.models.loader import iter_safetensors, save_safetensors

  gen = torch.Generator().manual_seed(0)
  tensors = {
    "a.bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
    "b.f32": torch.randn(7, generator=gen),
    "c.i8": torch.randint(-128, 127, (2, 2, 3), generator=gen, dtype=torch.int8),
    "d.empty": torch.zeros(0, 4),
  }
  path = tmp_path / "model.safetensors"
  save_safetensors(path, tensors)
  for name, got in [*load_file(str(path)).items(), *iter_safetensors(path)]:
    assert got.dtype == tensors[name].dtype and torch.equal(got, tensors[name]), name
