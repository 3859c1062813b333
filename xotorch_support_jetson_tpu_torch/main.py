"""Daemon entry point of the PyTorch port: engine → node → OpenAI API.

    python -m xotorch_support_jetson_tpu_torch.main --discovery-module none \\
      --chatgpt-api-port 52415 --default-model llama-3.2-1b

serves the checkpoint in ``XOT_TPU_MODEL_DIR`` on the CUDA card (on the CPU
with ``XOT_TPU_PLATFORM=cpu``). Counterpart of the reference's ``main.py``
daemon wiring without the ring: one node serves the whole model.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from .inference.engine import get_inference_engine, inference_engine_classes
from .utils.helpers import get_or_create_node_id


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(prog="xot-torch", description="PyTorch/CUDA LLM serving daemon (solo node)")
  parser.add_argument("--default-model", type=str, default="llama-3.2-1b")
  parser.add_argument("--node-id", type=str, default=None)
  # The port has no peer discovery yet; "none" is accepted so the
  # reference's command line runs unchanged.
  parser.add_argument("--discovery-module", type=str, choices=["none"], default="none")
  parser.add_argument("--chatgpt-api-host", type=str, default="0.0.0.0")
  parser.add_argument("--chatgpt-api-port", type=int, default=52415)
  parser.add_argument("--chatgpt-api-response-timeout", type=int, default=None)
  parser.add_argument("--max-generate-tokens", type=int, default=10000)
  parser.add_argument("--inference-engine", type=str, default="torch", choices=list(inference_engine_classes))
  parser.add_argument("--temp", "--default-temp", dest="temp", type=float, default=0.6)
  parser.add_argument("--top-k", type=int, default=35)
  parser.add_argument("--system-prompt", type=str, default=None)
  parser.add_argument("--disable-tui", action="store_true", help="accepted for command-line compatibility (the port has no TUI)")
  return parser


def build_components(args, tokenizer=None, device=None):
  """Wire downloader → engine → node → API. ``tokenizer`` (optional) is
  handed to the engine instead of one resolved from the checkpoint."""
  from .api.chatgpt_api import ChatGPTAPI
  from .download.downloader import new_shard_downloader
  from .orchestration.node import Node

  engine = get_inference_engine(args.inference_engine, new_shard_downloader(), device=device, tokenizer=tokenizer)
  engine_classname = type(engine).__name__
  node = Node(
    args.node_id or get_or_create_node_id(),
    engine,
    max_generate_tokens=args.max_generate_tokens,
    default_sample_temp=args.temp,
    default_sample_top_k=args.top_k,
  )
  api = ChatGPTAPI(node, engine_classname, response_timeout=args.chatgpt_api_response_timeout, default_model=args.default_model, system_prompt=args.system_prompt)
  return node, api, engine, engine_classname


async def async_main(args) -> None:
  node, api, _engine, _ = build_components(args)
  await node.start()
  server = await api.run(host=args.chatgpt_api_host, port=args.chatgpt_api_port)
  stop_event = asyncio.Event()
  loop = asyncio.get_running_loop()
  for sig in (signal.SIGINT, signal.SIGTERM):
    try:
      loop.add_signal_handler(sig, stop_event.set)
    except NotImplementedError:
      pass
  try:
    await stop_event.wait()
  finally:
    server.close()
    await server.wait_closed()
    await node.stop()


def run() -> None:
  args = build_parser().parse_args()
  try:
    asyncio.run(async_main(args))
  except KeyboardInterrupt:
    print("\nshutting down")


if __name__ == "__main__":
  run()
