"""Daemon entry point of the PyTorch port: engine → node → OpenAI API.

    python -m xotorch_support_jetson_tpu_torch.main --discovery-module none \\
      --chatgpt-api-port 52415 --default-model llama-3.2-1b

serves the checkpoint in ``XOT_TPU_MODEL_DIR`` (or the model's directory
under ``XOT_TPU_HOME/downloads``) on the CUDA card (on the CPU with
``XOT_TPU_PLATFORM=cpu``);

    python -m xotorch_support_jetson_tpu_torch.main run llama-3.2-1b --prompt "hi"

(or ``--run-model llama-3.2-1b``) generates one answer, prints it and
exits. ``--models-seed-dir`` moves pre-fetched model directories into the
downloads home first. SIGINT or SIGTERM (also ``POST /quit``) stops the
daemon: the API stops taking requests and the node waits for outstanding
ones (``XOT_TPU_DRAIN_S``); a second signal stops it at once. Counterpart
of the reference's ``main.py`` daemon wiring.

Nodes form a ring that splits the model's layers by their memory
(``XOT_TPU_MEMORY_MB`` overrides the probed figure). Each node runs a peer
server on ``--node-host``:``--node-port`` (a free port by default) and
finds its peers with ``--discovery-module``: ``udp`` (the default, as in
the reference: beacons to ``--broadcast-port``, listening on
``--listen-port``, ``--allowed-node-ids``, ``--interface-type-filter``,
peers dropped after ``--discovery-timeout`` s of silence), ``manual`` (the
JSON file ``--discovery-config-path`` names, re-read when it changes) or
``none`` (a node alone). ``--wait-for-peers N`` holds the start until N
peers are found. ``--inference-engine dummy`` serves the ``dummy`` model
without weights.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import time
import uuid

from . import registry
from .inference.engine import get_inference_engine, inference_engine_classes
from .inference.shard import Shard
from .utils.helpers import find_available_port, get_or_create_node_id


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(prog="xot-torch", description="PyTorch/CUDA LLM serving daemon")
  parser.add_argument("command", nargs="?", choices=["run"], help="command to run (default: the daemon with its API server)")
  parser.add_argument("model_name", nargs="?", help="model id (see the registry)")
  parser.add_argument("--default-model", type=str, default="llama-3.2-1b")
  parser.add_argument("--node-id", type=str, default=None)
  parser.add_argument("--node-host", type=str, default="0.0.0.0")
  parser.add_argument("--node-port", type=int, default=None)
  parser.add_argument("--listen-port", type=int, default=5678)
  parser.add_argument("--broadcast-port", type=int, default=5678)
  parser.add_argument("--discovery-module", type=str, choices=["udp", "manual", "none"], default="udp")
  parser.add_argument("--discovery-timeout", type=int, default=30)
  parser.add_argument("--discovery-config-path", type=str, default=None)
  parser.add_argument("--wait-for-peers", type=int, default=0)
  parser.add_argument("--allowed-node-ids", type=str, default=None, help="comma-separated")
  parser.add_argument("--interface-type-filter", type=str, default=None, help="comma-separated interface types UDP discovery may adopt peers from (e.g. ethernet,wifi)")
  parser.add_argument("--chatgpt-api-host", type=str, default="0.0.0.0")
  parser.add_argument("--chatgpt-api-port", type=int, default=52415)
  parser.add_argument("--chatgpt-api-response-timeout", type=int, default=None)
  parser.add_argument("--max-generate-tokens", type=int, default=10000)
  parser.add_argument("--inference-engine", type=str, default="torch", choices=list(inference_engine_classes))
  parser.add_argument("--temp", "--default-temp", dest="temp", type=float, default=0.6)
  parser.add_argument("--top-k", type=int, default=35)
  parser.add_argument("--prompt", type=str, default="Who are you?")
  parser.add_argument("--system-prompt", type=str, default=None)
  parser.add_argument("--disable-tui", action="store_true", help="accepted for command-line compatibility (the port has no TUI)")
  parser.add_argument("--run-model", type=str, default=None, help="alias for the `run MODEL` command")
  parser.add_argument("--models-seed-dir", type=str, default=None, help="move pre-fetched model dirs from here into the downloads home at startup")
  return parser


def build_discovery(args, node_id: str, node_port: int):
  """The ``--discovery-module`` the arguments name, creating TCP peer
  handles."""
  from .networking.discovery import NoDiscovery
  from .networking.tcp.tcp_peer_handle import TCPPeerHandle

  if args.discovery_module == "udp":
    from .networking.udp.udp_discovery import UDPDiscovery

    return UDPDiscovery(
      node_id, node_port, args.listen_port, args.broadcast_port, TCPPeerHandle,
      discovery_timeout=args.discovery_timeout,
      allowed_node_ids=args.allowed_node_ids.split(",") if args.allowed_node_ids else None,
      allowed_interface_types=args.interface_type_filter.split(",") if args.interface_type_filter else None,
    )
  if args.discovery_module == "manual":
    from .networking.manual.manual_discovery import ManualDiscovery

    if not args.discovery_config_path:
      raise ValueError("--discovery-config-path is required with --discovery-module manual")
    return ManualDiscovery(args.discovery_config_path, node_id, TCPPeerHandle)
  return NoDiscovery()


def build_components(args, tokenizer=None, device=None):
  """Wire downloader → engine → discovery → node → peer server → API.
  ``tokenizer`` (optional) is handed to the torch engine instead of one
  resolved from the checkpoint."""
  from .api.chatgpt_api import ChatGPTAPI
  from .download.downloader import new_shard_downloader
  from .networking.tcp.tcp_server import TCPServer
  from .orchestration.node import Node, refuse_unported_ring_knobs

  refuse_unported_ring_knobs()
  node_id = args.node_id or get_or_create_node_id()
  node_port = args.node_port or find_available_port(args.node_host)
  downloader = new_shard_downloader()
  engine_kwargs = {"device": device, "tokenizer": tokenizer} if args.inference_engine == "torch" else {}
  engine = get_inference_engine(args.inference_engine, downloader, **engine_kwargs)
  engine_classname = type(engine).__name__
  node = Node(
    node_id,
    engine,
    max_generate_tokens=args.max_generate_tokens,
    default_sample_temp=args.temp,
    default_sample_top_k=args.top_k,
    shard_downloader=downloader,
    discovery=build_discovery(args, node_id, node_port),
  )
  node.server = TCPServer(node, args.node_host, node_port)

  def on_opaque_status(request_id: str, status: str) -> None:
    # When any node starts a prompt, every node loads its own shard of that
    # model (the reference's preload).
    try:
      data = json.loads(status)
      if data.get("type") == "node_status" and data.get("status") == "start_process_prompt":
        base = data.get("base_shard", {})
        base_shard = Shard(base["model_id"], int(base["start_layer"]), int(base["end_layer"]), int(base["n_layers"]))
        node.spawn(engine.ensure_shard(node.get_current_shard(base_shard)))
    except Exception:  # noqa: BLE001 — a preload is best-effort
      pass

  node.on_opaque_status.register("preload").on_next(on_opaque_status)
  last_broadcast: dict = {}

  def on_progress(shard, event) -> None:
    # Every node keeps each node's latest progress; peers hear it by a
    # broadcast at most every 0.2 s (and at the end).
    node.node_download_progress[node.id] = event.to_dict()
    if not node.peers:
      return
    now = time.time()
    if now - last_broadcast.get(shard, 0) < 0.2 and event.status != "complete":
      return
    last_broadcast[shard] = now
    node.spawn(node.broadcast_opaque_status("", json.dumps({"type": "download_progress", "node_id": node.id, "progress": event.to_dict()})))

  downloader.on_progress.register("node").on_next(on_progress)
  api = ChatGPTAPI(node, engine_classname, response_timeout=args.chatgpt_api_response_timeout, default_model=args.default_model, system_prompt=args.system_prompt)
  return node, api, engine, engine_classname


async def run_model_cli(node, engine_classname: str, model_name: str, prompt: str) -> None:
  """The ``run`` command: one chat-templated prompt, its tokens printed as
  they arrive, then the count and the rate."""
  shard = registry.build_base_shard(model_name, engine_classname)
  if shard is None:
    print(f"Error: unsupported model '{model_name}' for engine {engine_classname}")
    return
  engine = node.inference_engine
  await engine.ensure_shard(node.get_current_shard(shard))
  tokenizer = engine.tokenizer
  templated = tokenizer.apply_chat_template([{"role": "user", "content": prompt}], tokenize=False, add_generation_prompt=True)

  request_id = str(uuid.uuid4())
  done = asyncio.Event()
  tokens_out: list[int] = []
  t_start = time.perf_counter()

  def on_token(rid, tokens, is_finished):
    if rid != request_id:
      return
    tokens_out.extend(tokens)
    print(tokenizer.decode(tokens), end="", flush=True)
    if is_finished:
      done.set()

  node.on_token.register("cli").on_next(on_token)
  await node.process_prompt(shard, templated, request_id)
  try:
    await asyncio.wait_for(done.wait(), timeout=300)
  except asyncio.TimeoutError:
    print("\n[timeout]")
  elapsed = time.perf_counter() - t_start
  print(f"\n[{len(tokens_out)} tokens in {elapsed:.1f}s — {len(tokens_out) / max(elapsed, 1e-9):.1f} tok/s]")


async def _until(aw, event: asyncio.Event):
  """Await ``aw`` unless ``event`` is set first (then ``aw`` is cancelled)."""
  task = asyncio.ensure_future(aw)
  stopper = asyncio.ensure_future(event.wait())
  try:
    await asyncio.wait({task, stopper}, return_when=asyncio.FIRST_COMPLETED)
  finally:
    for t in (task, stopper):
      if not t.done():
        t.cancel()
  if task.done() and not task.cancelled():
    return task.result()
  return None


async def async_main(args) -> None:
  if args.models_seed_dir:
    from .download.downloader import seed_models

    try:
      await seed_models(args.models_seed_dir)
    except OSError as e:  # seeding is best-effort, as in the reference
      print(f"error seeding models from {args.models_seed_dir}: {e}")
  node, api, _engine, engine_classname = build_components(args)
  await (node.start(args.wait_for_peers) if args.wait_for_peers else node.start())
  stop_event = asyncio.Event()
  force_event = asyncio.Event()  # a second signal: skip the drain
  loop = asyncio.get_running_loop()

  def shutdown() -> None:
    if stop_event.is_set():
      force_event.set()
    stop_event.set()

  for sig in (signal.SIGINT, signal.SIGTERM):
    try:
      loop.add_signal_handler(sig, shutdown)
    except NotImplementedError:
      pass
  try:
    if args.command == "run" or (args.command is None and args.run_model):
      model = args.model_name or args.run_model or args.default_model
      await _until(run_model_cli(node, engine_classname, model, args.prompt), stop_event)
      return
    server = await api.run(host=args.chatgpt_api_host, port=args.chatgpt_api_port)
    await stop_event.wait()
    server.close()  # no new connections
    await node.graceful_drain(force=force_event)
    await _until(server.wait_closed(), force_event)
  finally:
    await node.stop()


def run() -> None:
  args = build_parser().parse_args()
  try:
    asyncio.run(async_main(args))
  except KeyboardInterrupt:
    print("\nshutting down")


if __name__ == "__main__":
  run()
