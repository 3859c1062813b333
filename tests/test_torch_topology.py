"""The port's topology, partitioning, device capabilities and ring memory
budget against the JAX package's: partitions and shard ranges on
hypothesis-drawn topologies (1–6 nodes, 1–64 layers, the rounding cases),
capability round trips and chip tables, the topology's JSON, and the ring
budget's byte counts and problems for the same configs, shards and
memories."""

import asyncio
import importlib

import pytest
from hypothesis import given, settings, strategies as st

from xotorch_support_jetson_tpu.models.config import config_from_hf as jconfig
from xotorch_support_jetson_tpu.parallel import hbm_planner as jplanner
from xotorch_support_jetson_tpu.inference.shard import Shard as JShard
from xotorch_support_jetson_tpu.topology.partitioning import Partition as JPartition
from xotorch_support_jetson_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy as JStrategy
from xotorch_support_jetson_tpu.topology.partitioning import map_partitions_to_shards as jmap
from xotorch_support_jetson_tpu.topology.topology import Topology as JTopology
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.models.config import config_from_hf as tconfig
from xotorch_support_jetson_tpu_torch.parallel import hbm_planner as tplanner
from xotorch_support_jetson_tpu_torch.topology.partitioning import Partition, RingMemoryWeightedPartitioningStrategy, map_partitions_to_shards
from xotorch_support_jetson_tpu_torch.topology.topology import Topology

# The packages export a function of the module's name: import the modules.
jcaps = importlib.import_module("xotorch_support_jetson_tpu.topology.device_capabilities")
tcaps = importlib.import_module("xotorch_support_jetson_tpu_torch.topology.device_capabilities")

LLAMA_3_2_1B = {
  "model_type": "llama", "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 16,
  "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
  "max_position_embeddings": 131072, "tie_word_embeddings": True, "bos_token_id": 128000, "eos_token_id": [128001, 128008, 128009],
  "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
}
LLAMA_3_1_8B = {**LLAMA_3_2_1B, "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32, "head_dim": 128, "tie_word_embeddings": False}
QWEN_2_5_TINY = {
  "model_type": "qwen2", "vocab_size": 1000, "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 6, "num_attention_heads": 4,
  "num_key_value_heads": 2, "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "max_position_embeddings": 512, "tie_word_embeddings": True,
}
GEMMA2_TINY = {
  "model_type": "gemma2", "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 5, "num_attention_heads": 4,
  "num_key_value_heads": 2, "head_dim": 16, "query_pre_attn_scalar": 16, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
  "sliding_window": 8, "max_position_embeddings": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "hidden_activation": "gelu_pytorch_tanh",
  "tie_word_embeddings": True,
}
CONFIGS = {"llama-3.2-1b": LLAMA_3_2_1B, "llama-3.1-8b": LLAMA_3_1_8B, "qwen2-tiny": QWEN_2_5_TINY, "gemma2-tiny": GEMMA2_TINY}


# ------------------------------------------------------------ partitioning

node_ids = st.text(alphabet="abcdefgh0123456789-", min_size=1, max_size=8)


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(node_ids, st.one_of(st.just(0), st.integers(1, 200_000), st.sampled_from([1000, 2000, 3000, 4000])), min_size=1, max_size=6), st.integers(1, 64))
def test_partitions_and_shards_equal_the_reference(mems, n_layers):
  t, j = Topology(), JTopology()
  for nid, mem in mems.items():
    caps = tcaps.DeviceCapabilities("m", "c", mem, tcaps.DeviceFlops(1.0, 2.0, 4.0))
    t.update_node(nid, caps)
    j.update_node(nid, jcaps.DeviceCapabilities.from_dict(caps.to_dict()))
  parts, jparts = RingMemoryWeightedPartitioningStrategy().partition(t), JStrategy().partition(j)
  assert [p.to_dict() for p in parts] == [p.to_dict() for p in jparts]
  shards = map_partitions_to_shards(parts, n_layers, "m")
  assert [s.to_dict() for s in shards] == [s.to_dict() for s in jmap(jparts, n_layers, "m")]
  # Coverage: contiguous, exact.
  assert shards[0].start_layer == 0 and shards[-1].end_layer == n_layers - 1
  assert all(a.end_layer + 1 == b.start_layer for a, b in zip(shards, shards[1:]))


@pytest.mark.parametrize("ends, n_layers", [
  ([0.333333, 0.666667, 1.0], 16), ([0.5, 0.75, 1.0], 16), ([0.4, 0.8, 0.99999], 5),
  ([0.1, 0.1, 1.0], 8), ([0.0, 1.0], 3), ([0.3, 0.6], 10), ([1.0], 1),
])
def test_map_partitions_rounding_cases(ends, n_layers):
  starts = [0.0] + ends[:-1]
  parts = [Partition(f"n{i}", s, e) for i, (s, e) in enumerate(zip(starts, ends))]
  jparts = [JPartition(f"n{i}", s, e) for i, (s, e) in enumerate(zip(starts, ends))]
  assert [s.to_dict() for s in map_partitions_to_shards(parts, n_layers, "m")] == [s.to_dict() for s in jmap(jparts, n_layers, "m")]


def test_two_to_one_to_one_split_of_llama_3_2_1b():
  """The card's three-daemon ring: memories in a 2 : 1 : 1 ratio give 0-7,
  8-11 and 12-15."""
  t = Topology()
  for nid, mem in (("head", 4800), ("mid", 2400), ("tail", 2400)):
    t.update_node(nid, tcaps.DeviceCapabilities("m", "c", mem, tcaps.DeviceFlops(1, 1, 1)))
  parts = RingMemoryWeightedPartitioningStrategy().partition(t)
  assert [(s.start_layer, s.end_layer) for s in map_partitions_to_shards(parts, 16, "llama-3.2-1b")] == [(0, 7), (8, 11), (12, 15)]
  assert [p.node_id for p in parts] == ["head", "tail", "mid"]  # equal memories: node id descending


# ------------------------------------------------------------ capabilities


@settings(max_examples=100, deadline=None)
@given(st.text(max_size=20), st.text(max_size=20), st.integers(0, 10**7), st.floats(0, 1e4, allow_nan=False), st.floats(0, 1e4, allow_nan=False), st.floats(0, 1e4, allow_nan=False))
def test_device_capabilities_roundtrip_equal(model, chip, memory, fp32, fp16, int8):
  caps = tcaps.DeviceCapabilities(model, chip, memory, tcaps.DeviceFlops(fp32, fp16, int8))
  assert tcaps.DeviceCapabilities.from_dict(caps.to_dict()) == caps
  assert caps.to_dict() == jcaps.DeviceCapabilities.from_dict(caps.to_dict()).to_dict()
  assert str(caps) == str(jcaps.DeviceCapabilities.from_dict(caps.to_dict()))


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-40GB", "NVIDIA GeForce RTX 4090", "Tesla T4", "NVIDIA H100 PCIe"])
@pytest.mark.parametrize("n", [1, 4])
def test_cuda_caps_equal_the_reference(name, n):
  total = 85_045_477_376
  assert tcaps.cuda_caps_from(name, total, n).to_dict() == jcaps.cuda_caps_from(name, total, n).to_dict()


def test_jetson_table_and_the_unknown_caps_equal_the_reference():
  meminfo = "MemTotal:       65536000 kB\nMemFree: 1 kB\n"
  for model in ("NVIDIA Jetson AGX Orin", "Jetson Orin Nano", "Jetson Xavier"):
    assert tcaps.jetson_caps_from(model, meminfo).to_dict() == jcaps.jetson_caps_from(model, meminfo).to_dict()
  assert tcaps.GPU_CHIP_FLOPS == {k: tcaps.DeviceFlops(**v.to_dict()) for k, v in jcaps.GPU_CHIP_FLOPS.items()}
  assert tcaps.UNKNOWN_DEVICE_CAPABILITIES.to_dict() == jcaps.UNKNOWN_DEVICE_CAPABILITIES.to_dict()


def test_probe_on_a_host_without_a_card_and_the_memory_override(monkeypatch):
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  monkeypatch.delenv("XOT_TPU_MEMORY_MB", raising=False)
  caps = asyncio.run(tcaps.device_capabilities())
  assert caps.chip == "cpu" and caps.memory == tcaps._host_memory_mb() > 0
  monkeypatch.setenv("XOT_TPU_MEMORY_MB", "2400")
  assert asyncio.run(tcaps.device_capabilities()).memory == 2400


def test_cuda_probe_reads_the_card(monkeypatch):
  import torch

  class Props:
    name, total_memory = "NVIDIA H100 80GB HBM3", 85_045_477_376

  monkeypatch.delenv("XOT_TPU_PLATFORM", raising=False)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
  assert tcaps._cuda_device_capabilities().to_dict() == jcaps.cuda_caps_from(Props.name, Props.total_memory, 1).to_dict()
  monkeypatch.setenv("XOT_TPU_PLATFORM", "cpu")
  assert tcaps._cuda_device_capabilities() is None


def test_topology_json_and_merge_equal_the_reference():
  t, j = Topology(), JTopology()
  for topo, caps_mod in ((t, tcaps), (j, jcaps)):
    topo.update_node("a", caps_mod.DeviceCapabilities("m", "c", 10, caps_mod.DeviceFlops(1, 2, 3)))
    topo.add_edge("a", "b", "udp")
    other = type(topo)()
    other.update_node("b", caps_mod.DeviceCapabilities("n", "d", 20, caps_mod.DeviceFlops(4, 5, 6)))
    other.add_edge("b", "a")
    topo.merge("b", other)
    topo.active_node_id = "b"
  assert t.to_json() == j.to_json()
  assert Topology.from_json(t.to_json()).to_json() == t.to_json()
  assert t.get_neighbors("a") == j.get_neighbors("a") and str(t) != ""


# ------------------------------------------------------------ ring budget


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_model_bytes_equal_the_reference(model, quant):
  hf = CONFIGS[model]
  tc, jc = tconfig(hf), jconfig(hf)
  L = tc.n_layers
  for a, b in ((0, L - 1), (0, L // 2 - 1), (L // 2, L - 1), (1, L - 2)):
    if a > b:
      continue
    assert tplanner.model_bytes(tc, Shard(model, a, b, L), quant) == jplanner.model_bytes(jc, JShard(model, a, b, L), quant), (a, b)


@pytest.mark.parametrize("model", ["llama-3.2-1b", "llama-3.1-8b"])
def test_kv_cache_bytes_equal_the_reference(model):
  from xotorch_support_jetson_tpu.parallel.mesh import MeshPlan

  tc, jc = tconfig(CONFIGS[model]), jconfig(CONFIGS[model])
  for layers in (4, 8, tc.n_layers):
    assert tplanner.kv_cache_bytes(tc, 1, 4096, layers) == jplanner.kv_cache_bytes_per_chip(jc, MeshPlan(), 1, 4096, layers)


MEMORIES_MB = [[4800, 2400, 2400], [1600, 800, 800], [20000, 300, 300], [6000, 6000], [900, 900, 900, 900], [100]]


@pytest.mark.parametrize("quant", [None, "int4"])
@pytest.mark.parametrize("mems", range(len(MEMORIES_MB)))
@pytest.mark.parametrize("model", ["llama-3.2-1b", "llama-3.1-8b", "qwen2-tiny"])
def test_ring_partition_fits_reports_the_reference_problems(model, mems, quant):
  hf = CONFIGS[model]
  tc, jc = tconfig(hf), jconfig(hf)
  t = Topology()
  for i, mb in enumerate(MEMORIES_MB[mems]):
    t.update_node(f"n{i}", tcaps.DeviceCapabilities("m", "c", mb, tcaps.DeviceFlops(1, 1, 1)))
  parts = RingMemoryWeightedPartitioningStrategy().partition(t)
  shards = map_partitions_to_shards(parts, tc.n_layers, model)
  jshards = [JShard(s.model_id, s.start_layer, s.end_layer, s.n_layers) for s in shards]
  mems_b = [t.nodes[p.node_id].memory * 1024**2 for p in parts]
  assert tplanner.ring_partition_fits(tc, shards, mems_b, quant=quant) == jplanner.ring_partition_fits(jc, jshards, mems_b, quant=quant)


def test_the_card_ring_fits_llama_3_2_1b_and_refuses_llama_3_1_8b():
  """The chip smoke's daemons report 4800 / 2400 / 2400 MB: llama-3.2-1b's
  three spans fit, llama-3.1-8b's do not (the 507 request)."""
  t = Topology()
  for nid, mem in (("h", 4800), ("m", 2400), ("t", 2400)):
    t.update_node(nid, tcaps.DeviceCapabilities("m", "c", mem, tcaps.DeviceFlops(1, 1, 1)))
  parts = RingMemoryWeightedPartitioningStrategy().partition(t)
  mems = [t.nodes[p.node_id].memory * 1024**2 for p in parts]
  for model, fits in (("llama-3.2-1b", True), ("llama-3.1-8b", False)):
    cfg = tconfig(CONFIGS[model])
    assert (tplanner.ring_partition_fits(cfg, map_partitions_to_shards(parts, cfg.n_layers, model), mems) == []) is fits
