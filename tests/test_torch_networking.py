"""The port's peer networking against the JAX package's: the wire frames
(byte-exact bf16 / f32 / int32 round trips, refusals), the manual topology
config (the same files accepted and refused), manual discovery's hot
reload, UDP discovery on loopback (the three cases of
tests/test_udp_discovery.py), the retry policy's timeouts, breakers and
flap damping, and the TCP transport's calls, errors and refusals."""

import asyncio
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from xotorch_support_jetson_tpu.networking import retry as jretry
from xotorch_support_jetson_tpu.networking.manual.network_topology_config import NetworkTopology as JNetworkTopology
from xotorch_support_jetson_tpu_torch.inference.dummy_engine import DummyInferenceEngine
from xotorch_support_jetson_tpu_torch.inference.shard import Shard
from xotorch_support_jetson_tpu_torch.inference.state import InferenceState
from xotorch_support_jetson_tpu_torch.networking import retry as tretry
from xotorch_support_jetson_tpu_torch.networking.manual.manual_discovery import ManualDiscovery
from xotorch_support_jetson_tpu_torch.networking.manual.network_topology_config import NetworkTopology
from xotorch_support_jetson_tpu_torch.networking.tcp import serialization as wire
from xotorch_support_jetson_tpu_torch.networking.tcp import tcp_peer_handle as tph
from xotorch_support_jetson_tpu_torch.networking.tcp.tcp_peer_handle import PeerRemoteError, TCPPeerHandle
from xotorch_support_jetson_tpu_torch.networking.tcp.tcp_server import TCPServer
from xotorch_support_jetson_tpu_torch.networking.udp import udp_discovery as tudp
from xotorch_support_jetson_tpu_torch.networking.udp.udp_discovery import UDPDiscovery
from xotorch_support_jetson_tpu_torch.orchestration.node import Node
from xotorch_support_jetson_tpu_torch.topology.device_capabilities import DeviceCapabilities, DeviceFlops
from xotorch_support_jetson_tpu_torch.topology.topology import Topology
from xotorch_support_jetson_tpu_torch.utils.helpers import find_available_port

# The suite runs in several worker processes on the CPU: one intra-op
# thread each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CAPS = DeviceCapabilities(model="test", chip="cpu", memory=2048, flops=DeviceFlops(1, 2, 4))


# ------------------------------------------------------------ frames


def _roundtrip(tensors: dict, header: dict | None = None):
  frame = wire.encode_frame(header or {"method": "X"}, tensors)
  head_n, payload_n = wire.frame_lengths(frame[: wire.PREFIX_BYTES])
  head = frame[wire.PREFIX_BYTES : wire.PREFIX_BYTES + head_n]
  payload = frame[wire.PREFIX_BYTES + head_n :]
  assert len(payload) == payload_n
  return wire.decode_frame(head, payload)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int32])
def test_torch_tensors_roundtrip_byte_exact(dtype):
  g = torch.Generator().manual_seed(0)
  t = (torch.randn((2, 128, 64), generator=g) * 100).to(dtype)
  _, out = _roundtrip({"tensor": t})
  got = out["tensor"]
  assert isinstance(got, torch.Tensor) and got.dtype == dtype and got.shape == t.shape
  assert bytes(got.contiguous().view(torch.uint8).reshape(-1).numpy()) == bytes(t.contiguous().view(torch.uint8).reshape(-1).numpy())
  # A bf16 hidden state travels at 2 bytes per element: 512 KiB for a
  # 128-bucket prefill of a 2048-wide model, 4 KiB for one step.
  frame = wire.encode_frame({}, {"tensor": torch.zeros((1, 128, 2048), dtype=torch.bfloat16)})
  assert len(frame) - wire.PREFIX_BYTES < 512 * 1024 + 512


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
def test_numpy_arrays_roundtrip_byte_exact(dtype):
  a = (np.arange(24).reshape(2, 3, 4) * 7 - 30).astype(dtype)
  _, out = _roundtrip({"a": a, "skipped": None})
  assert set(out) == {"a"}
  assert isinstance(out["a"], np.ndarray) and out["a"].dtype == a.dtype and out["a"].tobytes() == a.tobytes()
  assert out["a"].flags.writeable


def test_non_contiguous_and_empty_tensors_roundtrip():
  t = torch.arange(24, dtype=torch.float32).reshape(4, 6).T
  e = torch.zeros((0, 3), dtype=torch.bfloat16)
  _, out = _roundtrip({"t": t, "e": e})
  assert torch.equal(out["t"], t) and out["e"].shape == (0, 3) and out["e"].dtype == torch.bfloat16


def test_state_and_shard_roundtrip():
  state = InferenceState(tokens=np.array([[1, 2, 3]], np.int32), curr_pos=3, prompt_len=3, extras={"replay_epoch": 2, "request_options": {"max_tokens": 5, "temperature": 0.0}})
  fields, tokens = wire.state_fields(state)
  header, out = _roundtrip({"state_tokens": tokens}, {"state": fields, "shard": Shard("m", 2, 5, 8).to_dict()})
  rt = wire.state_from(header["state"], out["state_tokens"])
  np.testing.assert_array_equal(rt.tokens, state.tokens)
  assert (rt.curr_pos, rt.prompt_len, rt.extras) == (3, 3, state.extras)
  assert wire.shard_from_dict(header["shard"]) == Shard("m", 2, 5, 8)
  assert wire.state_fields(None) == (None, None) and wire.state_from(None, None) is None


def test_topology_travels_as_the_reference_proto_carries_it():
  from xotorch_support_jetson_tpu.networking.grpc.serialization import proto_to_topology, topology_to_proto
  from xotorch_support_jetson_tpu.topology.device_capabilities import DeviceCapabilities as JCaps
  from xotorch_support_jetson_tpu.topology.topology import Topology as JTopology

  t, j = Topology(), JTopology()
  for nid, mem in (("a", 1024), ("b", 512)):
    t.update_node(nid, DeviceCapabilities("m", "c", mem, DeviceFlops(1.0, 2.0, 4.0)))
    j.update_node(nid, JCaps.from_dict(t.nodes[nid].to_dict()))
  for topo in (t, j):
    topo.add_edge("a", "b", "manual")
    topo.active_node_id = "a"
  got = wire.topology_from_dict(json.loads(json.dumps(wire.topology_to_dict(t))))
  assert got.to_json() == proto_to_topology(topology_to_proto(j)).to_json()


@pytest.mark.parametrize("bad", ["float8_e4m3fn", "complex64", "object"])
def test_refused_dtypes_and_frames(bad):
  good = wire.encode_frame({"m": 1}, {"t": torch.ones(2)})
  head_n, _ = wire.frame_lengths(good[:8])
  header = json.loads(good[8 : 8 + head_n])
  header["tensors"]["t"]["dtype"] = bad
  with pytest.raises(wire.WireError):
    wire.decode_frame(json.dumps(header).encode(), good[8 + head_n :])
  with pytest.raises(wire.WireError):
    wire.decode_frame(b"\x80not json", b"")
  with pytest.raises(wire.WireError):
    wire.frame_lengths((wire.MAX_HEADER_BYTES + 1).to_bytes(4, "big") + (0).to_bytes(4, "big"))
  with pytest.raises(wire.WireError):
    wire.encode_frame({}, {"x": np.array([object()])})


def test_tensor_bytes_out_of_the_frame_are_refused():
  good = wire.encode_frame({}, {"t": torch.ones(4)})
  head_n, _ = wire.frame_lengths(good[:8])
  with pytest.raises(wire.WireError):
    wire.decode_frame(good[8 : 8 + head_n], good[8 + head_n : -4])


# ------------------------------------------------------------ manual config

CONFIG_CASES = {
  "empty": {"peers": {}},
  "one": {"peers": {"a": {"address": "127.0.0.1", "port": 5000, "device_capabilities": CAPS.to_dict()}}},
  "port_text": {"peers": {"a": {"address": "x", "port": " 12 ", "device_capabilities": {}}}},
  "port_text_fraction": {"peers": {"a": {"address": "x", "port": "7.0", "device_capabilities": {}}}},
  "port_underscores": {"peers": {"a": {"address": "x", "port": "1_000", "device_capabilities": {}}}},
  "port_float": {"peers": {"a": {"address": "x", "port": 1.0, "device_capabilities": {}}}},
  "port_bool": {"peers": {"a": {"address": "x", "port": True, "device_capabilities": {}}}},
  "port_negative": {"peers": {"a": {"address": "x", "port": -3, "device_capabilities": {}}}},
  "extra_fields": {"peers": {"a": {"address": "x", "port": 1, "device_capabilities": {}, "note": 1}}, "other": []},
  "port_fraction": {"peers": {"a": {"address": "x", "port": 1.5, "device_capabilities": {}}}},
  "port_hex": {"peers": {"a": {"address": "x", "port": "0x10", "device_capabilities": {}}}},
  "port_exponent": {"peers": {"a": {"address": "x", "port": "1e3", "device_capabilities": {}}}},
  "port_null": {"peers": {"a": {"address": "x", "port": None, "device_capabilities": {}}}},
  "address_int": {"peers": {"a": {"address": 1, "port": 1, "device_capabilities": {}}}},
  "caps_list": {"peers": {"a": {"address": "x", "port": 1, "device_capabilities": []}}},
  "missing_port": {"peers": {"a": {"address": "1.2.3.4"}}},
  "peer_null": {"peers": {"a": None}},
  "peers_list": {"peers": []},
  "no_peers": {},
  "top_list": [],
}


def _verdict(cls, path):
  try:
    cfg = cls.from_path(str(path))
  except (ValueError, FileNotFoundError) as e:
    return type(e).__name__
  return {pid: (p.address, p.port, p.device_capabilities) for pid, p in cfg.peers.items()}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_manual_config_accepts_and_refuses_what_the_reference_does(case, tmp_path):
  path = tmp_path / "topology.json"
  path.write_text(json.dumps(CONFIG_CASES[case]))
  assert _verdict(NetworkTopology, path) == _verdict(JNetworkTopology, path)


def test_network_topology_config_validation(tmp_path):
  """The reference's own cases (tests/test_networking.py)."""
  bad = tmp_path / "bad.json"
  bad.write_text("{not json")
  with pytest.raises(ValueError):
    NetworkTopology.from_path(str(bad))
  missing_field = tmp_path / "missing.json"
  missing_field.write_text(json.dumps({"peers": {"a": {"address": "1.2.3.4"}}}))
  with pytest.raises(ValueError):
    NetworkTopology.from_path(str(missing_field))
  with pytest.raises(FileNotFoundError):
    NetworkTopology.from_path(str(tmp_path / "nope.json"))


async def _served_node(node_id="peer1", host="127.0.0.1"):
  port = find_available_port(host)
  node = Node(node_id, DummyInferenceEngine())
  node.server = TCPServer(node, host, port)
  await node.start()
  return node, port


@pytest.mark.asyncio
async def test_manual_discovery_hot_reload(tmp_path):
  node, port = await _served_node()
  config_path = tmp_path / "topology.json"
  config_path.write_text(json.dumps({"peers": {}}))
  discovery = ManualDiscovery(str(config_path), "me", create_peer_handle=TCPPeerHandle, poll_interval=0.2)
  await discovery.start()
  try:
    assert await discovery.discover_peers() == []
    config_path.write_text(json.dumps({"peers": {"peer1": {"address": "127.0.0.1", "port": port, "device_capabilities": CAPS.to_dict()}}}))
    for _ in range(50):
      peers = await discovery.discover_peers()
      if peers:
        break
      await asyncio.sleep(0.1)
    assert len(peers) == 1 and peers[0].id() == "peer1" and peers[0].device_capabilities() == CAPS
    config_path.write_text(json.dumps({"peers": {}}))
    for _ in range(50):
      peers = await discovery.discover_peers()
      if not peers:
        break
      await asyncio.sleep(0.1)
    assert peers == []
  finally:
    await discovery.stop()
    await node.stop()


# ------------------------------------------------------------ UDP discovery


@pytest.fixture
def loopback_only(monkeypatch):
  """Beacons from loopback only: they go to 127.255.255.255 and stay on the
  host."""
  monkeypatch.setattr(tudp, "get_all_ip_addresses_and_interfaces", lambda: [("127.0.0.1", "lo")])


@pytest.mark.asyncio
async def test_udp_discovery_two_instances_discover_each_other(loopback_only):
  port_a, port_b = find_available_port(), find_available_port()
  grpc_a = find_available_port("127.0.0.1")
  node_b, grpc_b = await _served_node("udp-target")
  seen = {}

  def make_handle(pid, addr, desc, caps):
    seen[pid] = addr
    return TCPPeerHandle(pid, addr, desc, caps)

  disc_a = UDPDiscovery("node-a", grpc_a, listen_port=port_a, broadcast_port=port_b, create_peer_handle=make_handle, broadcast_interval=0.2, device_capabilities=CAPS)
  disc_b = UDPDiscovery("udp-target", grpc_b, listen_port=port_b, broadcast_port=port_a, create_peer_handle=TCPPeerHandle, broadcast_interval=0.2, device_capabilities=CAPS)
  await disc_b.start()
  await disc_a.start()
  try:
    peers = []
    for _ in range(100):
      peers = await disc_a.discover_peers()
      if peers:
        break
      await asyncio.sleep(0.1)
    assert peers and peers[0].id() == "udp-target" and seen["udp-target"] == f"127.0.0.1:{grpc_b}"
    assert peers[0].device_capabilities().memory == 2048
  finally:
    await disc_a.stop()
    await disc_b.stop()
    await node_b.stop()


@pytest.mark.asyncio
async def test_udp_discovery_evicts_dead_peer(loopback_only, monkeypatch):
  monkeypatch.setattr(tph, "CONNECT_TIMEOUT", 1.0)
  monkeypatch.setattr(tph, "HEALTH_TIMEOUT", 1.0)
  port_a, port_b = find_available_port(), find_available_port()
  node_b, grpc_b = await _served_node("node-b")
  disc_a = UDPDiscovery("node-a", 1, listen_port=port_a, broadcast_port=port_b, create_peer_handle=TCPPeerHandle, broadcast_interval=0.2, discovery_timeout=600, device_capabilities=CAPS)
  disc_b = UDPDiscovery("node-b", grpc_b, listen_port=port_b, broadcast_port=port_a, create_peer_handle=TCPPeerHandle, broadcast_interval=0.2, device_capabilities=CAPS)
  await disc_b.start()
  await disc_a.start()
  try:
    for _ in range(100):
      if await disc_a.discover_peers():
        break
      await asyncio.sleep(0.1)
    assert await disc_a.discover_peers()
    # node-b's server and beacons stop: failed health checks evict it.
    await disc_b.stop()
    await node_b.stop()
    node_b = None
    for _ in range(100):
      if not await disc_a.discover_peers():
        break
      await asyncio.sleep(0.1)
    assert await disc_a.discover_peers() == []
  finally:
    await disc_a.stop()
    if node_b is not None:
      await node_b.stop()


@pytest.mark.asyncio
async def test_udp_discovery_filters_disallowed_node_ids(loopback_only):
  port_a, port_b = find_available_port(), find_available_port()
  disc_a = UDPDiscovery("node-a", 1, listen_port=port_a, broadcast_port=port_b, create_peer_handle=TCPPeerHandle, broadcast_interval=0.2, device_capabilities=CAPS, allowed_node_ids=["only-this-one"])
  disc_b = UDPDiscovery("node-b", 2, listen_port=port_b, broadcast_port=port_a, create_peer_handle=TCPPeerHandle, broadcast_interval=0.2, device_capabilities=CAPS)
  await disc_b.start()
  await disc_a.start()
  try:
    await asyncio.sleep(1.0)
    assert await disc_a.discover_peers() == []
  finally:
    await disc_a.stop()
    await disc_b.stop()


@pytest.mark.asyncio
async def test_udp_interface_type_filter(loopback_only):
  """``--interface-type-filter``: a loopback beacon is not adopted by a node
  that takes ethernet peers only."""
  port_a, port_b = find_available_port(), find_available_port()
  node_b, grpc_b = await _served_node("node-b")
  disc_a = UDPDiscovery("node-a", 1, listen_port=port_a, broadcast_port=port_b, create_peer_handle=TCPPeerHandle, broadcast_interval=0.2, device_capabilities=CAPS, allowed_interface_types=["ethernet"])
  disc_b = UDPDiscovery("node-b", grpc_b, listen_port=port_b, broadcast_port=port_a, create_peer_handle=TCPPeerHandle, broadcast_interval=0.2, device_capabilities=CAPS)
  await disc_b.start()
  await disc_a.start()
  try:
    await asyncio.sleep(1.0)
    assert await disc_a.discover_peers() == []
  finally:
    await disc_a.stop()
    await disc_b.stop()
    await node_b.stop()


def test_interfaces_come_from_the_kernel():
  from xotorch_support_jetson_tpu_torch.utils.helpers import get_all_ip_addresses_and_interfaces, get_interface_priority_and_type
  from xotorch_support_jetson_tpu.utils.helpers import get_interface_priority_and_type as jrank

  found = get_all_ip_addresses_and_interfaces()
  assert ("127.0.0.1", "lo") in found and all(len(ip.split(".")) == 4 for ip, _ in found)
  for name in ("lo", "eth0", "enp3s0", "wlan0", "tb1", "docker0", "thunderbolt0"):
    assert get_interface_priority_and_type(name) == jrank(name)


# ------------------------------------------------------------ retry policy

TIMEOUT_ENVS = [
  {},
  {"XOT_TPU_RPC_TIMEOUT_S": "2"},
  {"XOT_TPU_RPC_TIMEOUT_S": "30"},
  {"XOT_TPU_RPC_TIMEOUT_SENDTENSOR_S": "7"},
  {"XOT_TPU_RPC_TIMEOUT_HEALTHCHECK_S": "0"},
  {"XOT_TPU_RPC_TIMEOUT_SENDRESULT_S": "bad", "XOT_TPU_RPC_TIMEOUT_S": "oops"},
]


@pytest.mark.parametrize("env", range(len(TIMEOUT_ENVS)))
def test_rpc_timeouts_and_retries_equal_the_reference(env, monkeypatch):
  for k, v in TIMEOUT_ENVS[env].items():
    monkeypatch.setenv(k, v)
  for method in jretry.METHOD_TIMEOUT_DEFAULTS:
    assert tretry.rpc_timeout(method) == jretry.rpc_timeout(method), method
    assert tretry.rpc_retries(method) == jretry.rpc_retries(method), method
  assert tretry.METHOD_TIMEOUT_DEFAULTS == jretry.METHOD_TIMEOUT_DEFAULTS and tretry.RETRYABLE_METHODS == jretry.RETRYABLE_METHODS


@settings(max_examples=40, deadline=None)
@given(st.lists(st.sampled_from(["fail", "ok", "allow"]), max_size=30), st.integers(1, 6))
def test_breaker_and_health_walk_as_the_reference(ops, fails):
  import os

  os.environ["XOT_TPU_CB_FAILS"] = os.environ["XOT_TPU_HEALTH_FAILS"] = str(fails)
  try:
    tb, jb = tretry.CircuitBreaker("p"), jretry.CircuitBreaker("p")
    th, jh = tretry.PeerHealth(), jretry.PeerHealth()
    for op in ops:
      if op == "allow":
        assert tb.allow() == jb.allow()
      else:
        for b in (tb, jb):
          b.record_success() if op == "ok" else b.record_failure()
        for h in (th, jh):
          h.record("p", op == "ok")
      assert (tb.state, tb.failures, tb.is_open) == (jb.state, jb.failures, jb.is_open)
      assert th.consecutive_failures("p") == jh.consecutive_failures("p") and th.is_dead("p") == jh.is_dead("p")
  finally:
    del os.environ["XOT_TPU_CB_FAILS"], os.environ["XOT_TPU_HEALTH_FAILS"]


def test_retry_budget_and_backoff_equal_the_reference(monkeypatch):
  import random

  monkeypatch.setenv("XOT_TPU_RPC_RETRY_BUDGET", "3")
  tb, jb = tretry.RetryBudget(), jretry.RetryBudget()
  assert [tb.take("r") for _ in range(5)] == [jb.take("r") for _ in range(5)] == [True, True, True, False, False]
  assert tb.take("") and jb.take("")
  for attempt in range(1, 8):
    assert tretry.backoff_s(attempt, random.Random(attempt)) == jretry.backoff_s(attempt, random.Random(attempt))
  reg = tretry.BreakerRegistry()
  b = reg.get("p", "a:1")
  b.record_failure()
  assert reg.get("p", "a:1") is b and b.failures == 1 and reg.get("p", "b:2") is not b
  reg.forget("p")
  assert reg.get("p", "a:1") is not b


# ------------------------------------------------------------ the transport


@pytest.mark.asyncio
async def test_peer_calls_errors_and_refusals():
  """Health checks, topology collection, results through the dedup, opaque
  statuses; a handler's error is the peer's answer (the breaker is not
  charged); the unported methods and the cluster pulls answer errors; a
  dead peer's calls fail with a connection error."""
  node, port = await _served_node("srv")
  handle = TCPPeerHandle("srv", f"127.0.0.1:{port}", "test", CAPS)
  got, statuses = [], []
  node.on_token.register("t").on_next(lambda rid, toks, fin: got.append((rid, list(toks), fin)))
  node.on_opaque_status.register("t").on_next(lambda rid, s: statuses.append(s))
  try:
    assert await handle.health_check()
    topo = await handle.collect_topology(set(), 2)
    assert set(topo.nodes) == {"srv"}
    await handle.send_result("r1", [7, 8], False, start_pos=0)
    await handle.send_result("r1", [8, 9], True, start_pos=1)  # 8 is a duplicate: dropped
    assert got == [("r1", [7, 8], False), ("r1", [9], True)]
    await handle.send_opaque_status("r1", json.dumps({"type": "download_progress", "node_id": "x", "progress": {"status": "complete"}}))
    assert node.node_download_progress == {"x": {"status": "complete"}} and len(statuses) == 1
    for method in ("SendExample", "SendLoss", "SendKvPages"):
      with pytest.raises(PeerRemoteError, match="not ported"):
        await handle._invoke(method, {})
    with pytest.raises(NotImplementedError):
      await handle.send_example(Shard("dummy", 0, 7, 8), None, None, None, True, "r")
    for kind in ("metrics_pull", "programs_pull", "slo_pull", "timeline_pull"):
      with pytest.raises(PeerRemoteError, match="not ported"):
        await handle.send_opaque_status("", json.dumps({"type": kind, "nonce": "n"}))
    with pytest.raises(PeerRemoteError, match="KeyError"):
      await handle._invoke("SendPrompt", {"shard": {}, "prompt": "x", "request_id": "bad"})  # a malformed call
    assert not tretry.breakers.get("srv", f"127.0.0.1:{port}").is_open and tretry.breakers.get("srv", f"127.0.0.1:{port}").failures == 0
  finally:
    await node.stop()
  with pytest.raises(ConnectionError):
    await handle.send_result("r2", [1], True)
  assert not await handle.health_check()
  await handle.disconnect()
  tretry.breakers.forget("srv")
  tretry.peer_health.forget("srv")


@pytest.mark.asyncio
async def test_many_calls_share_one_connection():
  """Concurrent calls on one connection each get their own answer, and a
  12 MiB hidden state (a 3,000-token prefill of a 2048-wide bf16 model)
  crosses in one frame."""
  node, port = await _served_node("srv2")
  handle = TCPPeerHandle("srv2", f"127.0.0.1:{port}", "test", CAPS)
  seen = []
  node.on_token.register("t").on_next(lambda rid, toks, fin: seen.append(rid))
  try:
    await asyncio.gather(*(handle.send_result(f"r{i}", [i], True, start_pos=0) for i in range(50)))
    assert sorted(seen) == sorted(f"r{i}" for i in range(50))
    big = torch.zeros((1, 3072, 2048), dtype=torch.bfloat16)
    await handle.send_result("big", big, True)
  finally:
    await handle.disconnect()
    await node.stop()
