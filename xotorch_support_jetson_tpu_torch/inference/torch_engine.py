"""The PyTorch/CUDA inference engine.

Counterpart of the reference's ``inference/jax_engine.py``:
encode/decode/sample, prompt prefill into a dense slot-indexed KV cache
(padded to a 128 bucket, per-request ``_Session``), chunked decode
(``dispatch_chunk``/``read_chunk``) for streaming, one-shot decode (``generate_oneshot``) for blocking requests, and ``end_request``.
As in the reference, each of these is one device program per dispatch:
sessions take their cache from an engine-owned pool, and each pooled cache
carries its captured programs (models/decoder.py ``SoloPrograms``), so a
prefill bucket is one CUDA-graph replay and a decode step is one replay;
the program ledger (utils/programs.py) counts them under the reference's
families (``decode.shard_forward``, ``decode.fused``,
``decode.fused_generate``). Speculation runs captured too: a speculative
round is one replay (``spec.chunk``, ``spec.generate``), an n-gram chunk
one replay with every round in it (``spec.batch``), and the draft's prompt
prefill one replay of its bucket on the draft's own pooled cache, which
comes paired with the target's. Also the continuous-batching server over
the paged pool
(``get_batched_server``, inference/batch_scheduler.py). All device work
runs on one executor thread off the asyncio loop. Caches and pools are
updated in place by the decoder. ``score_tokens`` (OpenAI ``logprobs``)
runs one cache-less scoring forward per request, eagerly (uncaptured),
recorded in the ledger as ``prefill.score_last``.

A ring node loads a partial shard (its layer range; the tied embedding on
both the head and the tail). Its sessions take ``ShardPrograms``
(``ring.prefill``, ``ring.step``: one replay per hop) and hand the next
node a hidden state in the model's dtype; only the tail returns logits.
Speculation, batching and scoring need the whole model on one node.

llava (a checkpoint with a vision tower, models/vision.py): a prompt whose
state carries images (``extras["images"]``, base64, set by the API) runs
the host front end (``_image_inputs``: Pillow decode, the checkpoint's
processor, which expands each ``<image>`` into its feature placeholders)
and then the device half on the executor thread
(``_infer_multimodal_sync``, also callable with ids and pixels through
``infer_image_tokens``): the tower and projector eagerly (family
``vision.encode``), llava-next's any-res packing, the merge into the
prompt's embeddings, and the captured embeddings prefill
(``prefill.embeds``; K1 in every layer on the card). The tower rides with
the first shard and is kept apart from the decoder's parameters
(``_vision_params``), so every text path, the batched server included,
runs the decoder alone. An image session decodes like a text one, but
never speculates: it has no prompt ids for a draft or an n-gram index, as
in the reference.

Stable diffusion: a diffusers checkpoint (``model_index.json`` at its root)
loads as a DiffusionPipeline (inference/diffusion_pipeline.py) in bf16, the
whole model on this node, after every piece of a text model's device state
is freed; ``generate_image`` runs it on the executor thread with progress
marshalled back to the loop and a cancel event polled between chunks. Text
inference on it is refused (``encode``), as in the reference.

It runs on ``cuda`` unless the caller asks for the CPU (``device="cpu"`` or
``XOT_TPU_PLATFORM=cpu``); with no card visible it raises.

``XOT_TPU_QUANT=int8|int4`` (or ``quant=``) loads any model weight-quantized,
on the device, right after its weights (models/quantize.py); int8 products
run as ``XOT_TPU_QUANT_COMPUTE`` says (``w8a16``, the default, or ``w8a8``).

Solo speculative decoding (``XOT_TPU_SPEC_DECODE``, or ``spec_decode=``),
greedy and exact, as the reference reads it:

- ``int8`` loads a draft: the int8 self-draft (none when ``XOT_TPU_QUANT``
  is set), or the checkpoint ``XOT_TPU_SPEC_DRAFT`` names (a directory, or
  a registry id already under ``XOT_TPU_HOME/downloads``; refused on a
  missing checkpoint, another vocab size or differing tokenizer files).
  Streaming greedy chunks chain ``fused_speculative_chunk`` on the device
  and blocking greedy requests run ``fused_speculative_generate``; the depth
  walks an engine-level acceptance EWMA (``XOT_TPU_SPEC_GAMMA``, default 4,
  down to 0 = plain, a depth-1 probe after ``XOT_TPU_SPEC_REPROBE`` plain
  dispatches). On the card a load-time A/B drops the draft when speculation
  is slower than plain, both timed as served: the captured rounds against
  the captured plain step (``XOT_TPU_SPEC_AUTOCAL=0`` skips it).
- Any other value, or a draft that did not load: streaming greedy chunks
  draft from the session's own prompt+generated history (n-grams,
  ``XOT_TPU_SPEC_NGRAM``, ``_NGRAM_N``, ``_NGRAM_MAX``) through
  ``fused_spec_batch_decode`` at B=1, one synchronous chunk at a time, the
  depth walking a per-session EWMA.

Multi-LoRA serving (``enable_multi_lora``, or ``XOT_TPU_LORA_DIR`` at load):
stacked adapter slots among the params, written in place by the registry
(inference/adapters.py), so every captured graph reads the adapters
installed when it runs. A solo request selects its adapter by name
(``set_request_adapter``); its session pins the slot and every dispatch
of it (prefill, step, plain chunk, oneshot) runs the adapter hook. Adapter
sessions never speculate: speculation verifies the base target, as in the
reference. The batched server takes the name at ``submit``.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..models.decoder import ShardPrograms, SoloPrograms, fused_decode, fused_generate, init_kv_cache, kv_quant_mode
from ..utils.helpers import DEBUG, resolve_device
from ..utils.metrics import FRACTION_BUCKETS, metrics
from .engine import ImageInputError, InferenceEngine, PromptTooLongError
from .ngram import NgramIndex, ngram_enabled, ngram_knobs
from .paging import ewma_update, spec_adapt_gamma
from .shard import Shard
from .state import InferenceState

DEFAULT_MAX_SEQ = int(os.getenv("XOT_TPU_MAX_SEQ", "4096"))
PREFILL_BUCKET = 128


def _round_up(n: int, multiple: int) -> int:
  return ((n + multiple - 1) // multiple) * multiple


def _split_vision(params):
  """(decoder params, llava's ``vision`` / ``projector`` groups or None)."""
  vision = {k: params[k] for k in ("vision", "projector") if k in params}
  return {k: v for k, v in params.items() if k not in vision}, vision or None


def _tokenizer_fingerprint(d: Path) -> dict[str, str] | None:
  """Per-artifact digests of a checkpoint's vocabulary files
  (tokenizer.json, tokenizer.model, vocab.json, merges.txt), so two
  directories compare only on the files both ship; tokenizer_config.json is
  left out (chat templates differ within one tokenizer family). None when
  the directory has none."""
  digests = {}
  for name in ("tokenizer.json", "tokenizer.model", "vocab.json", "merges.txt"):
    f = d / name
    if f.is_file():
      digests[name] = hashlib.blake2b(f.read_bytes(), digest_size=16).hexdigest()
  return digests or None


def _tokenizers_differ(fp_a: dict[str, str] | None, fp_b: dict[str, str] | None) -> bool:
  """True only when some artifact present in both checkpoints differs."""
  if not fp_a or not fp_b:
    return False
  common = fp_a.keys() & fp_b.keys()
  return bool(common) and any(fp_a[n] != fp_b[n] for n in common)


class _Session:
  __slots__ = (
    "kv_cache", "programs", "pool_key", "epoch", "curr_pos", "prompt_len", "max_seq", "next_token_dev", "prompt_np", "draft_cache",
    "spec_seed_dev", "spec_pos_dev", "spec_known_pos", "spec_inflight_slots",
    "ngram_index", "ngram_unread", "ngram_ewma", "ngram_gamma", "adapter_slot",
  )

  def __init__(self, programs: SoloPrograms | ShardPrograms, pool_key: tuple, max_seq: int, epoch: int = 0) -> None:
    self.programs = programs  # the pooled cache's captured programs (returned to the pool at the end)
    self.pool_key = pool_key
    self.epoch = epoch  # the request's replay_epoch when this session began
    self.kv_cache = programs.cache
    self.curr_pos = 0
    self.prompt_len = 0
    self.max_seq = max_seq
    self.next_token_dev = None  # [B,1] device tensor chaining decode chunks
    self.prompt_np = None  # prompt token ids (the draft's prefill, the n-gram index)
    self.draft_cache = None  # the draft's dense slot cache (programs.draft's), once the prompt is prefilled into it
    # Draft spec chain: seed token and position stay on the device, so chunk
    # N+1 dispatches from chunk N's outputs before the host reads chunk N.
    # The host keeps the confirmed position plus the summed worst-case slots
    # (steps + gamma + 1) of dispatched, unread chunks for its room checks.
    self.spec_seed_dev = None
    self.spec_pos_dev = None
    self.spec_known_pos = 0
    self.spec_inflight_slots = 0
    # Draft-free n-gram chain: the suffix index over prompt+generated
    # history and whether a chunk is dispatched but unread. The chain is
    # strictly sequential (the next proposal keys on this chunk's tokens).
    # Acceptance EWMA and depth are per session: they follow the text, not
    # the model. -1 depth: not started (the engine cap at chain start).
    self.ngram_index = None
    self.ngram_unread = False
    self.ngram_ewma = None
    self.ngram_gamma = -1
    # The pinned adapter slot of this session (0: the base model): every
    # dispatch of the session passes it as adapter_ids, and the spec and
    # n-gram chunks step aside (they verify the base target).
    self.adapter_slot = 0


class TorchShardedInferenceEngine(InferenceEngine):
  can_generate_images = True

  def __init__(self, shard_downloader=None, max_seq_len: int | None = None, seed: int = 0, device=None, tokenizer=None, quant: str | None = None, spec_decode: str | None = None):
    self.quant = (quant if quant is not None else os.getenv("XOT_TPU_QUANT", "")) or None
    if self.quant not in (None, "int8", "int4"):
      raise ValueError(f"unsupported quantization mode {self.quant!r}")
    self.quant_compute = os.getenv("XOT_TPU_QUANT_COMPUTE", "w8a16")
    if self.quant and self.quant_compute not in ("w8a16", "w8a8"):
      raise ValueError(f"XOT_TPU_QUANT_COMPUTE supports 'w8a16' or 'w8a8'; got {self.quant_compute!r}")
    self.shard_downloader = shard_downloader
    self.device = resolve_device(device)
    self.shard: Shard | None = None
    self._effective_shard: Shard | None = None
    self.params = None
    self.cfg = None
    # A tokenizer handed in by the caller is kept across loads; otherwise
    # one is resolved from the checkpoint directory (inference/tokenizers.py).
    self._fixed_tokenizer = tokenizer
    self.tokenizer = tokenizer
    self.max_seq_len = max_seq_len or DEFAULT_MAX_SEQ
    self._max_seq_explicit = max_seq_len is not None or os.getenv("XOT_TPU_MAX_SEQ") is not None
    self.sessions: dict[str, _Session] = {}
    self.executor = ThreadPoolExecutor(max_workers=1)
    self._seed = seed
    self.generator = torch.Generator(device=self.device).manual_seed(seed)
    # Seeds for the batched server's dispatches, drawn on the event-loop
    # thread (split_key): a host generator, so a draw never waits on the card.
    self._key_gen = torch.Generator().manual_seed(seed)
    self._key_lock = threading.Lock()
    self._shard_lock = asyncio.Lock()
    self._batched_server = None
    self._batch_ops = None
    # Dense slot caches recycled across solo requests, by (rows, max_seq, KV
    # quant mode, draft), each with its captured programs (models/decoder.py
    # SoloPrograms) and, with a draft loaded, the draft's cache and programs:
    # graphs need fixed addresses. The pool grows when more sessions are
    # live than it holds; a new model or draft empties it.
    self._cache_pool: dict[tuple, list[SoloPrograms]] = {}
    self._graph_pool = None  # the CUDA graphs' shared memory pool, made at the first cache
    # Solo speculation (module docstring). The draft chain's acceptance
    # EWMA and live depth are engine-level (a property of the draft); the
    # n-gram chain keeps its pair on each session (a property of the text).
    self.spec_decode = spec_decode if spec_decode is not None else (os.getenv("XOT_TPU_SPEC_DECODE") or None)
    self.spec_gamma = int(os.getenv("XOT_TPU_SPEC_GAMMA", "4"))
    self._spec_ewma = None
    self._spec_gamma_live = self.spec_gamma
    self._spec_plain_streak = 0
    self._spec_reprobe = int(os.getenv("XOT_TPU_SPEC_REPROBE", "64"))
    self._spec_ngram_on = ngram_enabled()
    self.spec_ngram_n, self.spec_ngram_max = ngram_knobs()
    self._draft_params = None
    self._draft_cfg = None  # None: the self-draft runs the target's config and shard
    self._draft_shard = None
    self.spec_calibration = None  # the last load-time A/B: tok/s of both and the verdict
    # The loaded checkpoint's directory, recorded after its draft is built
    # (as the reference records it): the cross draft's tokenizer check
    # compares against the previous load's files.
    self._model_dir = None
    # Multi-LoRA serving: the adapter registry enable_multi_lora builds
    # (None: base-only serving), and the solo requests' adapter names. A
    # model load resets both.
    self.adapter_registry = None
    self._session_adapters: dict[str, str] = {}
    # llava: the tower and projector of the loaded first shard, apart from
    # the decoder's params (None: a text model, or not the first shard).
    self._vision_params = None
    # The DiffusionPipeline of a loaded stable-diffusion checkpoint (None: a
    # text model is loaded, or nothing).
    self.diffusion = None

  def split_key(self) -> int:
    """A fresh seed for one batched dispatch's sampling generator
    (thread-safe: the counterpart of the reference's locked key split)."""
    with self._key_lock:
      return int(torch.randint(0, 2**62, (1,), generator=self._key_gen)[0])

  # ---------------------------------------------------------------- loading

  async def ensure_shard(self, shard: Shard) -> None:
    async with self._shard_lock:
      if self.shard == shard:
        return
      if self.shard_downloader is None:
        raise RuntimeError("no shard downloader configured and shard not preloaded; use load_test_model() for tests")
      model_dir = await self.shard_downloader.ensure_shard(shard, type(self).__name__)
      await asyncio.get_running_loop().run_in_executor(self.executor, self._load_shard_sync, shard, model_dir)
      await self._load_tokenizer(shard, model_dir)

  def _serving_cap(self, cfg) -> int:
    """Effective max_seq_len: the engine cap, and for longrope (phi-3/4)
    the pre-scaling original context unless the operator chose a cap."""
    from ..models.config import LongRopeScaling

    cap = min(self.max_seq_len, cfg.max_seq_len)
    if not self._max_seq_explicit and isinstance(cfg.rope_scaling, LongRopeScaling):
      cap = min(cap, cfg.rope_scaling.original_max_position_embeddings)
    return cap

  def _load_shard_sync(self, shard: Shard, model_dir) -> None:
    from dataclasses import replace

    from ..models.config import load_model_config
    from ..models.loader import load_shard_weights

    # A diffusers checkpoint (model_index.json at its root) takes the
    # image-generation path.
    if (Path(model_dir) / "model_index.json").exists():
      self._load_diffusion_sync(shard, model_dir)
      return
    self.diffusion = None
    cfg = load_model_config(model_dir)
    cfg = replace(cfg, max_seq_len=self._serving_cap(cfg))
    eff = shard
    if cfg.n_layers != shard.n_layers:
      # A local checkpoint can disagree with the registry's layer count:
      # remap the shard's layer fractions onto the checkpoint's depth.
      start = round(shard.start_layer * cfg.n_layers / shard.n_layers)
      end = round((shard.end_layer + 1) * cfg.n_layers / shard.n_layers) - 1
      eff = Shard(shard.model_id, start, max(start, end), cfg.n_layers)
    self._refuse_partial_spec(eff)
    self._drop_batched_server()  # its page pool belongs to the old model
    self.adapter_registry = None  # its geometry and slots belong to the old model
    self.params = self._draft_params = None  # free the old model's device memory before loading
    params = load_shard_weights(model_dir, cfg, eff, device=self.device)
    if self.quant:
      from ..models.quantize import quantize_params

      params = quantize_params(params, self.quant)
      cfg = replace(cfg, quant_compute=self.quant_compute)
    self.params, self._vision_params = _split_vision(params)
    self.cfg = cfg
    self.shard = shard
    self._effective_shard = eff
    self._maybe_build_draft()
    self._clear_sessions()
    self.generator.manual_seed(self._seed)
    self._key_gen.manual_seed(self._seed)
    self._model_dir = Path(model_dir)
    self._maybe_load_adapter_dir()
    if DEBUG >= 1:
      print(f"[torch_engine] loaded {shard} from {model_dir} on {self.device}")

  def _maybe_load_adapter_dir(self) -> None:
    """``XOT_TPU_LORA_DIR``: enable multi-LoRA at model load and register
    every ``*.npz`` adapter checkpoint in the directory (the name is the
    file stem; inference/adapters.py formats). Best-effort, as in the
    reference: a bad adapter file is skipped with a message, never a failed
    load, and a model that refuses multi-LoRA (MLA) only prints why. A ring
    node's partial shard skips it (it serves hidden states: no hook)."""
    lora_dir = os.getenv("XOT_TPU_LORA_DIR")
    if not lora_dir or self.adapter_registry is not None:
      return
    eff = self._effective_shard
    if not (eff.is_first_layer and eff.is_last_layer):
      return
    try:
      reg = self.enable_multi_lora()
    except (RuntimeError, ValueError) as e:
      print(f"[torch_engine] XOT_TPU_LORA_DIR set but multi-LoRA unavailable: {e}")
      return
    if reg is None:
      return  # XOT_TPU_LORA=0
    for path in sorted(Path(lora_dir).glob("*.npz")):
      try:
        reg.register(path.stem, path=str(path))
      except Exception as e:  # noqa: BLE001 — one bad adapter must not sink the load
        print(f"[torch_engine] skipping adapter {path.name}: {e}")

  async def _load_tokenizer(self, shard: Shard, model_dir) -> None:
    if self.diffusion is not None:  # its CLIP tokenizer came with the checkpoint
      return
    if self._fixed_tokenizer is not None:
      self.tokenizer = self._fixed_tokenizer
      return
    from .. import registry
    from .tokenizers import resolve_tokenizer

    repo = registry.get_repo(shard.model_id, type(self).__name__) or shard.model_id
    # A vision model resolves its processor (the image front end needs it).
    self.tokenizer = await resolve_tokenizer(repo, model_dir, prefer_processor=self.cfg is not None and self.cfg.vision is not None)

  def load_test_model(self, shard: Shard, cfg, params, tokenizer=None) -> None:
    """Directly inject a model (tests)."""
    self._refuse_partial_spec(shard)
    self.diffusion = None
    self._drop_batched_server()
    self.adapter_registry = None
    self.shard = shard
    self._effective_shard = shard
    self.cfg = cfg
    self.params, self._vision_params = _split_vision(params)
    self.tokenizer = tokenizer
    self._maybe_build_draft(calibrate=False)  # tests exercise the spec path deterministically
    self._clear_sessions()
    self.generator.manual_seed(self._seed)
    self._key_gen.manual_seed(self._seed)

  # ------------------------------------------------------- image generation

  def _drop_text_model(self) -> None:
    """Free every piece of a text model's device state: its params, draft
    and vision tower, the pooled caches and sessions, the batched server,
    the adapter registry."""
    self._drop_batched_server()
    self.adapter_registry = None
    self._session_adapters.clear()
    self.params = self._draft_params = self._vision_params = None
    self._draft_cfg = self._draft_shard = None
    self.cfg = None
    self._clear_sessions()

  def _load_diffusion_sync(self, shard: Shard, model_dir) -> None:
    """Load a diffusers checkpoint as a DiffusionPipeline in bf16 on the
    engine's device, the whole model on this node (a ring node serves it
    alone, as in the reference). ``XOT_TPU_QUANT`` leaves it unquantized."""
    from ..models.diffusion_loader import diffusion_config_from_dir, load_diffusion_params
    from .diffusion_pipeline import DiffusionPipeline

    model_dir = Path(model_dir)
    self._drop_text_model()
    self.diffusion = None
    cfg = diffusion_config_from_dir(model_dir)
    params = load_diffusion_params(model_dir, cfg, dtype=torch.bfloat16, device=self.device)
    tokenizer = None
    if (model_dir / "tokenizer").exists():
      from transformers import AutoTokenizer

      tokenizer = AutoTokenizer.from_pretrained(str(model_dir / "tokenizer"))
    self.diffusion = DiffusionPipeline(cfg, params, tokenizer, dtype=torch.bfloat16, device=self.device)
    self.tokenizer = tokenizer
    self.shard = shard
    self._effective_shard = shard
    self._model_dir = model_dir
    if DEBUG >= 1:
      print(f"[torch_engine] loaded diffusion pipeline {shard.model_id} from {model_dir} on {self.device}")

  def load_test_diffusion(self, shard: Shard, cfg, params, tokenizer=None) -> None:
    """Directly inject a diffusion model (tests), in f32."""
    from .diffusion_pipeline import DiffusionPipeline

    self._drop_text_model()
    self.diffusion = DiffusionPipeline(cfg, params, tokenizer, dtype=torch.float32, device=self.device)
    self.tokenizer = tokenizer
    self.shard = shard
    self._effective_shard = shard

  async def generate_image(
    self,
    shard: Shard,
    prompt: str,
    negative: str = "",
    steps: int = 30,
    guidance: float = 7.5,
    seed: int = 0,
    size: tuple[int, int] | None = None,
    init_image: np.ndarray | None = None,
    strength: float = 0.8,
    progress_cb=None,
    cancel_event=None,
    n: int = 1,
  ) -> np.ndarray:
    """Text-to-image (or img2img) on the loaded pipeline, on the executor
    thread like all device work; ``progress_cb`` is called on the event
    loop. ``cancel_event`` (a threading.Event) stops the denoise between
    chunks: cancelling the awaiting task cannot stop the worker thread."""
    await self.ensure_shard(shard)
    # A snapshot: a text model loading on the worker thread may drop
    # self.diffusion before this request's turn comes.
    pipeline = self.diffusion
    if pipeline is None:
      raise NotImplementedError(f"{shard.model_id} is not an image-generation model")
    loop = asyncio.get_running_loop()
    cb = None
    if progress_cb is not None:
      def cb(done, total):  # noqa: E306 — the worker thread's report, marshalled to the loop
        loop.call_soon_threadsafe(progress_cb, done, total)
    return await loop.run_in_executor(
      self.executor,
      lambda: pipeline.generate(
        prompt, negative=negative, steps=steps, guidance=guidance, seed=seed, size=size, init_image=init_image,
        strength=strength, progress_cb=cb, should_cancel=cancel_event.is_set if cancel_event is not None else None, n=n,
      ),
    )

  def _refuse_partial_spec(self, shard: Shard) -> None:
    """Solo speculation (``XOT_TPU_SPEC_DECODE``) needs the whole model on
    one node; a ring node's partial shard refuses it rather than serve
    without it (speculation over a ring is not ported)."""
    if self.spec_decode and not (shard.is_first_layer and shard.is_last_layer):
      raise ValueError(f"XOT_TPU_SPEC_DECODE={self.spec_decode!r} needs the whole model on one node; this node holds layers {shard.start_layer}-{shard.end_layer} of {shard.n_layers}")

  # ---------------------------------------------------------------- draft

  def _maybe_build_draft(self, calibrate: bool = True) -> None:
    """The speculative draft, with ``XOT_TPU_SPEC_DECODE=int8`` and a
    full-model shard: the checkpoint ``XOT_TPU_SPEC_DRAFT`` names, int8 at
    load, or else the int8 self-draft (none when the target is quantized:
    it would equal the target). Resets the draft's acceptance state.
    ``calibrate=False`` (test models) skips the load-time A/B."""
    self._draft_params = None
    self._draft_cfg = None
    self._draft_shard = None
    self._spec_ewma = None
    self._spec_gamma_live = self.spec_gamma
    self._spec_plain_streak = 0
    eff = self._effective_shard
    if self.spec_decode != "int8" or eff is None or not (eff.is_first_layer and eff.is_last_layer) or self.params is None:
      return
    draft_spec = os.getenv("XOT_TPU_SPEC_DRAFT")
    if draft_spec:
      self._build_cross_draft(draft_spec)
    else:
      if self.quant:
        return
      from ..models.quantize import quantize_params

      self._draft_params = quantize_params(self.params, "int8")
    if self._draft_params is not None and calibrate:
      self._maybe_calibrate_spec()

  def _build_cross_draft(self, spec: str) -> None:
    """Load the draft ``XOT_TPU_SPEC_DRAFT`` names: a local checkpoint
    directory, or a registry id whose checkpoint is already under
    ``XOT_TPU_HOME/downloads``. Refused (speculation stays draft-free) when
    none is found, when its vocab size differs from the target's, or when
    a tokenizer file both checkpoints ship differs."""
    from ..download.downloader import get_models_dir, repo_to_dirname
    from ..models.config import load_model_config
    from ..models.loader import load_shard_weights
    from ..models.quantize import quantize_params
    from ..registry import get_repo

    d = Path(spec)
    if not (d / "config.json").exists():
      repo = get_repo(spec, type(self).__name__)
      if repo:
        cand = get_models_dir() / repo_to_dirname(repo)
        if (cand / "config.json").exists():
          d = cand
    if not (d / "config.json").exists():
      print(f"[torch_engine] XOT_TPU_SPEC_DRAFT={spec!r}: no local checkpoint found; speculative draft disabled")
      return
    cfg_d = load_model_config(d, dtype=self.cfg.dtype)
    if cfg_d.vocab_size != self.cfg.vocab_size:
      print(f"[torch_engine] XOT_TPU_SPEC_DRAFT={spec!r}: draft vocab {cfg_d.vocab_size} != target {self.cfg.vocab_size}; draft disabled")
      return
    fp_t = _tokenizer_fingerprint(self._model_dir) if self._model_dir else None
    if _tokenizers_differ(fp_t, _tokenizer_fingerprint(d)):
      print(f"[torch_engine] XOT_TPU_SPEC_DRAFT={spec!r}: the draft's tokenizer files differ from the target's; draft disabled")
      return
    shard_d = Shard(spec, 0, cfg_d.n_layers - 1, cfg_d.n_layers)
    self._draft_params = quantize_params(load_shard_weights(d, cfg_d, shard_d, device=self.device), "int8")
    self._draft_cfg = cfg_d
    self._draft_shard = shard_d
    if DEBUG >= 1:
      print(f"[torch_engine] cross-model speculative draft: {spec} ({cfg_d.n_layers}L dim={cfg_d.dim}, int8) drafting for {self.shard.model_id}")

  def _maybe_calibrate_spec(self) -> None:
    """Keep the draft only if speculation measures at least 0.95× plain
    decode's tok/s, each timed as it is served: 64 greedy tokens through
    the captured plain step (``fused_decode`` with ``programs=``) and
    through the captured speculative rounds (``fused_speculative_generate``
    with ``programs=``) on a 256-slot cache pair taken as a session takes
    one, on the host with the card synchronised, best of two after a
    warm-up run that takes the captures (the timed runs are replays).
    Skipped on the CPU and with ``XOT_TPU_SPEC_AUTOCAL=0``. As in the
    reference, any failure of the timed runs keeps speculation on (printed
    under ``DEBUG``): calibration must never block serving."""
    if self.device.type == "cpu" or os.getenv("XOT_TPU_SPEC_AUTOCAL", "1") in ("0", "false"):
      return
    from ..models import decoder

    eff, cfg = self._effective_shard, self.cfg
    cfg_d, shard_d = self._draft_cfg or cfg, self._draft_shard or eff
    n = 64
    max_seq = min(256, self.max_seq_len, cfg.max_seq_len)

    def timed(fn) -> tuple[int, float]:
      torch.cuda.synchronize(self.device)
      t0 = time.perf_counter()
      emitted = fn()
      torch.cuda.synchronize(self.device)
      return emitted, time.perf_counter() - t0

    try:
      progs, _ = self._take_programs(1, max_seq)

      def plain(start) -> int:
        toks, _ = fused_decode(self.params, cfg, eff, 1, progs.cache, start, n, programs=progs)
        toks.cpu()
        return n

      def spec() -> int:
        buf, m, _, _, _ = decoder.fused_speculative_generate(
          self.params, cfg, eff, self._draft_params, cfg_d, shard_d, 1, progs.cache, progs.draft.cache, 0, n, gamma=self.spec_gamma, eos_ids=(-1,), programs=progs,
        )
        buf.cpu()
        return min(m, n)

      plain(0)  # warm-up: the captures
      plain_tok_s = max(k / dt for k, dt in (timed(lambda s=s: plain(s)) for s in (n, 2 * n)))
      spec()
      spec_tok_s = max(k / dt for k, dt in (timed(spec), timed(spec)))
    except Exception as e:  # noqa: BLE001 — calibration must never block serving
      if DEBUG >= 1:
        print(f"[torch_engine] spec calibration failed ({e!r}); keeping speculative mode")
      return
    kept = spec_tok_s >= 0.95 * plain_tok_s
    self.spec_calibration = dict(plain_tok_s=plain_tok_s, spec_tok_s=spec_tok_s, verdict="kept" if kept else "DISABLED")
    if kept:
      print(f"[torch_engine] speculative decode kept: {spec_tok_s:.1f} tok/s (captured rounds) vs plain {plain_tok_s:.1f} (captured steps)")
    else:
      print(
        f"[torch_engine] speculative decode DISABLED for this model: measured {spec_tok_s:.1f} tok/s (captured rounds) vs plain "
        f"{plain_tok_s:.1f} (captured steps; low draft acceptance); set XOT_TPU_SPEC_AUTOCAL=0 to force it"
      )
      self._draft_params = None

  # ---------------------------------------------------------------- contract

  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    await self.ensure_shard(shard)
    if self.diffusion is not None:
      raise NotImplementedError(f"{shard.model_id} is an image-generation model; use /v1/image/generations")
    return np.asarray(self.tokenizer.encode(prompt), dtype=np.int32)

  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    await self.ensure_shard(shard)
    return self.tokenizer.decode(np.asarray(tokens).reshape(-1).tolist())

  async def sample(self, x: np.ndarray, temp: float = 0.6, top_k: int = 35) -> np.ndarray:
    return await asyncio.get_running_loop().run_in_executor(self.executor, self._sample_sync, x, temp, top_k)

  def _sample_sync(self, x: np.ndarray, temp: float, top_k: int) -> np.ndarray:
    from ..ops.sampling import greedy, sample_logits

    logits = torch.from_numpy(np.asarray(x, dtype=np.float32))
    if logits.dim() == 3:  # tolerate [B,S,V] callers: sample the last row
      logits = logits[:, -1, :]
    if temp <= 0:
      return greedy(logits).numpy()
    return sample_logits(logits.to(self.device), self.generator, temp=temp, top_k=top_k).cpu().numpy()

  async def infer_tensor(
    self,
    request_id: str,
    shard: Shard,
    input_data: np.ndarray,
    inference_state: InferenceState | None = None,
  ) -> tuple[np.ndarray, InferenceState]:
    await self.ensure_shard(shard)
    return await asyncio.get_running_loop().run_in_executor(self.executor, self._infer_tensor_sync, request_id, input_data, inference_state)

  # ---------------------------------------------------------------- images

  async def infer_prompt(
    self,
    request_id: str,
    shard: Shard,
    prompt: str,
    inference_state: InferenceState | None = None,
  ) -> tuple[np.ndarray, InferenceState]:
    """The base encode → ``infer_tensor``, or, when the state carries
    images and this node holds a vision model's first shard, the image
    path: the host front end off the executor, then the device half on it.
    The images leave the state here (the hops after the head carry hidden
    states only)."""
    images = inference_state.extras.pop("images", None) if inference_state is not None else None
    await self.ensure_shard(shard)
    if images and self.cfg.vision is not None and self._effective_shard.is_first_layer:
      tokens, pixel_values, image_sizes = await asyncio.to_thread(self._image_inputs, prompt, images)
      return await asyncio.get_running_loop().run_in_executor(
        self.executor, self._infer_multimodal_sync, request_id, tokens, pixel_values, image_sizes, inference_state
      )
    return await super().infer_prompt(request_id, shard, prompt, inference_state)

  async def infer_image_tokens(self, request_id: str, shard: Shard, input_ids, pixel_values, image_sizes=None, inference_state: InferenceState | None = None):
    """The image path's device half from the processor's outputs:
    ``input_ids`` [B, S] (each image's placeholders already expanded),
    ``pixel_values`` [n, 3, H, W] (llava) or [n, tiles, 3, H, W] with
    ``image_sizes`` [n, 2] (llava-next any-res). Returns what
    ``infer_prompt`` returns."""
    await self.ensure_shard(shard)
    if self.cfg.vision is None or not self._effective_shard.is_first_layer:
      raise ValueError("image inputs need a vision model's first shard")
    return await asyncio.get_running_loop().run_in_executor(
      self.executor, self._infer_multimodal_sync, request_id, np.asarray(input_ids, dtype=np.int32), np.asarray(pixel_values, dtype=np.float32),
      None if image_sizes is None else np.asarray(image_sizes, dtype=np.int64), inference_state,
    )

  def _image_inputs(self, prompt: str, images_b64: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """The host front end: decode the base64 images with Pillow and run the
    checkpoint's processor (``self.tokenizer``, an ``AutoProcessor`` for a
    vision model: it expands each ``<image>`` into the image's feature
    placeholders and normalizes the pixels to the tower's layout). Returns
    (input_ids [1, S] int32, pixel_values f32, image_sizes [n, 2] or None).
    Raises ``ImageInputError`` (the API's 400) without Pillow, on an image
    that does not decode, and when the processor finds the placeholders
    outnumber the images (the device half checks the counts again)."""
    import base64
    import binascii
    import io

    try:
      from PIL import Image, UnidentifiedImageError
    except ImportError:
      raise ImageInputError("image input needs Pillow (the PIL package), which is not installed on this server; install Pillow or send text only") from None
    try:
      pil_images = [Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB") for b in images_b64]
    except (binascii.Error, ValueError, UnidentifiedImageError) as e:
      raise ImageInputError(f"an image_url could not be decoded as a base64 image: {e}") from None
    try:
      out = self.tokenizer(text=prompt, images=pil_images, return_tensors="np")
    except StopIteration:
      # HF processors raise a bare StopIteration when the placeholders
      # outnumber the images: an actionable client error instead.
      raise ImageInputError(
        f"prompt has more <image> placeholders than attached images ({len(pil_images)}); "
        "the API inserts one per image_url part: don't also write <image> in the text"
      ) from None
    sizes = out.get("image_sizes")
    return (np.asarray(out["input_ids"], dtype=np.int32), np.asarray(out["pixel_values"], dtype=np.float32), None if sizes is None else np.asarray(sizes, dtype=np.int64))

  def image_features(self, pixel_values: np.ndarray, image_sizes: np.ndarray | None = None) -> torch.Tensor:
    """The images' features [1, n, D] in the model's dtype, in prompt
    order: the tower and projector over each image (one batch of all
    images; for llava-next one batch of each image's own tiles, packed with
    its grid, unpadding and newlines). Eager, one ``vision.encode``
    dispatch in the program ledger."""
    from ..models.vision import anyres_grid_shape, encode_images, pack_anyres_features
    from ..utils.programs import ledger

    vcfg, vp = self.cfg.vision, self._vision_params
    if vp is None:
      raise RuntimeError("the loaded shard holds no vision tower")
    dev = self.device

    def run():
      if pixel_values.ndim == 5:
        packed = []
        for i in range(pixel_values.shape[0]):
          osize = (int(image_sizes[i][0]), int(image_sizes[i][1]))
          gh, gw = anyres_grid_shape(osize, vcfg.grid_pinpoints, vcfg.image_size)
          tiles = torch.from_numpy(np.ascontiguousarray(pixel_values[i, : 1 + gh * gw])).to(dev)
          packed.append(pack_anyres_features(encode_images(vp["vision"], vp["projector"], vcfg, tiles), osize, vcfg, vp["projector"]["image_newline"]))
        return torch.cat(packed, dim=0)[None]
      return encode_images(vp["vision"], vp["projector"], vcfg, torch.from_numpy(np.ascontiguousarray(pixel_values)).to(dev))

    sig = {"vision": vp, "pixel_values": pixel_values, "image_sizes": None if image_sizes is None else tuple(tuple(int(v) for v in s) for s in image_sizes)}
    return ledger.dispatch("vision.encode", sig, ("image_sizes",), run)

  def _infer_multimodal_sync(self, request_id, tokens: np.ndarray, pixel_values: np.ndarray, image_sizes, state):
    """The device half: the images' features merged into the embeddings of
    ``tokens`` (padded to the prompt's bucket) at the image placeholder
    positions, then the captured embeddings prefill. The session records
    the prompt's ids afterwards (``state.tokens``), as the reference does.
    Placeholders that do not match the features one for one are refused
    (``ImageInputError``) before any session exists."""
    from ..models.vision import merge_image_embeddings

    state = state or InferenceState()
    B, S = tokens.shape
    feats = self.image_features(pixel_values, image_sizes)
    n_slots, n_feats = int((tokens == self.cfg.image_token_id).sum()), feats.shape[0] * feats.shape[1]
    if n_slots != n_feats:
      # The reference merges whatever it gets (placeholders past the last
      # feature repeat it; features past the last placeholder are dropped):
      # the port refuses instead of serving a prompt that lost its images.
      n_img = pixel_values.shape[0]
      raise ImageInputError(
        f"prompt has {'more' if n_slots > n_feats else 'fewer'} <image> placeholders than attached images ({n_img}): "
        f"{n_slots} placeholder tokens for {n_feats} image features; the API inserts one per image_url part: don't also write <image> in the text"
      )
    pad_to = min(_round_up(S, PREFILL_BUCKET), min(self.max_seq_len, self.cfg.max_seq_len))
    tok_pad = np.zeros((B, pad_to), dtype=np.int32)
    tok_pad[:, :S] = tokens[:, :pad_to]
    tok_dev = torch.from_numpy(tok_pad).to(self.device)
    embeds = self.params["embed"][tok_dev].to(self.cfg.dtype)
    merged = merge_image_embeddings(embeds, tok_dev, feats, self.cfg.image_token_id)
    state.prompt_len = S
    out, state = self._infer_tensor_sync(request_id, merged, state, embeds=True)
    state.tokens = tokens
    return out, state

  def _take_programs(self, B: int, max_seq: int) -> tuple[SoloPrograms | ShardPrograms, tuple]:
    """A dense cache with its captured programs from the pool (a fresh one
    when the pool has none free under this key), and the key it returns
    under: ``SoloPrograms`` for a full-model shard, ``ShardPrograms`` for a
    ring node's partial one. With a draft loaded, a single-row cache comes paired with the
    draft's own cache and programs (``SoloPrograms.draft``): the
    speculative rounds' graphs hold both addresses. The key names the draft
    (its config, shard, KV mode and parameters)."""
    kv = kv_quant_mode(self.cfg)
    eff = self._effective_shard
    if not (eff.is_first_layer and eff.is_last_layer):
      # A ring node's partial shard: its own programs, no draft.
      key = (B, max_seq, kv, None)
      free = self._cache_pool.get(key)
      if free:
        return free.pop(), key
      if self._graph_pool is None and self.device.type == "cuda":
        self._graph_pool = torch.cuda.graph_pool_handle()
      cache = init_kv_cache(self.cfg, eff.n_shard_layers, B, max_seq, device=self.device)
      return ShardPrograms(self.params, self.cfg, eff, cache, pool=self._graph_pool), key
    draft = None
    if B == 1 and self._draft_params is not None:
      draft = (self._draft_cfg or self.cfg, self._draft_shard or self._effective_shard, kv, id(self._draft_params))
    key = (B, max_seq, kv, draft)
    free = self._cache_pool.get(key)
    if free:
      return free.pop(), key
    if self._graph_pool is None and self.device.type == "cuda":
      self._graph_pool = torch.cuda.graph_pool_handle()
    programs_d = None
    if draft is not None:
      cfg_d, shard_d = draft[:2]
      cache_d = init_kv_cache(cfg_d, shard_d.n_shard_layers, B, max_seq, device=self.device)
      programs_d = SoloPrograms(self._draft_params, cfg_d, shard_d, cache_d, pool=self._graph_pool)
    cache = init_kv_cache(self.cfg, self._effective_shard.n_shard_layers, B, max_seq, device=self.device)
    return SoloPrograms(self.params, self.cfg, self._effective_shard, cache, generator=self.generator, pool=self._graph_pool, draft=programs_d), key

  def _new_session(self, request_id: str, B: int, epoch: int = 0) -> _Session:
    """A session on a pooled cache (and, with a draft, its paired draft
    cache), with its adapter slot pinned when the request named one."""
    max_seq = min(self.max_seq_len, self.cfg.max_seq_len)
    slot = self._acquire_session_slot(request_id)
    programs, key = self._take_programs(B, max_seq)
    session = self.sessions[request_id] = _Session(programs, key, max_seq, epoch)
    session.adapter_slot = slot
    return session

  def _drop_session(self, request_id: str) -> None:
    """End a session and return its cache, with its programs and its draft
    pair, to the pool; its adapter pin goes with it."""
    session = self.sessions.pop(request_id, None)
    if session is not None:
      self._cache_pool.setdefault(session.pool_key, []).append(session.programs)
      if session.adapter_slot and self.adapter_registry is not None:
        self.adapter_registry.unpin(("solo", request_id))

  def _clear_sessions(self) -> None:
    """Forget every session and the pool (its graphs hold the old model and
    draft)."""
    self.sessions.clear()
    self._cache_pool.clear()
    self._graph_pool = None

  def _infer_tensor_sync(self, request_id, input_data, state, embeds: bool = False):
    """One hop of this shard: a prompt's prefill when the session is new,
    else one position. The input is token ids [B, S] (numpy, on the head)
    or the hidden state the shard before sent (a torch tensor in the
    model's dtype, padded to the head's bucket in the prefill); with
    ``embeds``, the head's prompt embeddings [B, S_pad, D] (llava's merged
    image and text embeddings, a prefill only). The tail
    returns f32 logits [B, V] (numpy), any other shard its hidden state as a
    torch tensor on the host in the model's dtype. A ``replay_epoch`` in the
    state other than the session's drops the session first (the request is
    replayed after a peer's loss, as the reference's engine does)."""
    shard = self._effective_shard
    state = state or InferenceState()
    epoch = int(state.extras.get("replay_epoch", 0))
    is_tokens = not isinstance(input_data, torch.Tensor)
    x = np.asarray(input_data) if is_tokens else input_data
    if is_tokens and not (x.ndim == 2 and np.issubdtype(x.dtype, np.integer)):
      raise ValueError(f"a shard's input is token ids [B, S] or a hidden-state tensor; got an array of {x.dtype} {x.shape}")
    if (is_tokens or embeds) != shard.is_first_layer or (embeds and is_tokens):
      raise ValueError(f"shard {shard.start_layer}-{shard.end_layer} takes {'token ids' if shard.is_first_layer else 'a hidden state'}")
    B = x.shape[0]
    session = self.sessions.get(request_id)
    if session is not None and session.epoch != epoch:
      self._drop_session(request_id)
      session = None
    if session is None:
      session = self._new_session(request_id, B, epoch)
    if session.curr_pos == 0:
      prompt_len = state.prompt_len or x.shape[1]
      if prompt_len + 1 > session.max_seq:
        self._drop_session(request_id)
        raise PromptTooLongError(f"prompt of {prompt_len} tokens exceeds the {session.max_seq}-token context window")
      state.extras.setdefault("orig_prompt_len", int(prompt_len))
      if is_tokens:
        state.tokens = x.astype(np.int32)
        state.prompt_len = prompt_len
        session.prompt_np = x.astype(np.int32)  # the draft's prefill, the n-gram index
        pad_to = min(_round_up(x.shape[1], PREFILL_BUCKET), session.max_seq)
        x_in = np.zeros((B, pad_to), dtype=np.int32)
        x_in[:, : x.shape[1]] = x
      else:
        x_in = x  # hidden states arrive already padded
      if embeds:
        out = session.programs.prefill_embeds(x_in, prompt_len, **self._session_adapter_kw(session))
      else:
        out = session.programs.prefill(x_in, prompt_len, **self._session_adapter_kw(session))  # one captured program per bucket
      session.curr_pos = session.prompt_len = prompt_len
    else:
      if embeds:
        raise RuntimeError(f"request {request_id} already has a session: embeddings enter a prefill only")
      if session.curr_pos >= session.max_seq:
        raise RuntimeError(f"KV cache exhausted at {session.max_seq} positions for request {request_id}")
      if is_tokens:
        x_step = x[:, -1:].astype(np.int32)  # the freshly sampled token
        if state.tokens is not None:
          state.tokens = np.concatenate([state.tokens, x_step], axis=1)
      else:
        x_step = x
      out = session.programs.forward(x_step, session.curr_pos, **self._session_adapter_kw(session))
      session.curr_pos += 1
    state.curr_pos = session.curr_pos
    if shard.is_last_layer:
      return out.float().cpu().numpy(), state
    return out.cpu(), state

  def _to_device(self, x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(self.device) if np.issubdtype(x.dtype, np.integer) else t.to(self.device, self.cfg.dtype)

  # ---------------------------------------------------------------- decoding

  async def generate_chunk(self, request_id: str, shard: Shard, last_token: int, n_steps: int, temp: float = 0.6, top_k: int = 35) -> list[int]:
    handle = await self.dispatch_chunk(request_id, shard, n_steps, temp, top_k, first_token=last_token)
    return await self.read_chunk(handle)

  async def dispatch_chunk(self, request_id: str, shard: Shard, n_steps: int, temp: float = 0.6, top_k: int = 35, first_token: int | None = None):
    """Enqueue one decode chunk; returns its device tensor of tokens.

    The chunk's input token is ``first_token`` (first chunk after prefill)
    or the previous chunk's last token, which stays on the device — so the
    node can dispatch chunk N+1 before reading chunk N. None when the KV
    cache is exhausted."""
    await self.ensure_shard(shard)
    return await asyncio.get_running_loop().run_in_executor(self.executor, self._dispatch_chunk_sync, request_id, n_steps, temp, top_k, first_token)

  # Draft chain policy: the engine-level depth and its EWMA.

  def _spec_chunk_eligible(self, session, temp, first_token) -> bool:
    """The draft spec chain: greedy single-stream requests with a draft
    loaded, entered right after prefill and continued on the device."""
    if self._draft_params is None or (temp is not None and float(temp) > 0.0) or session.adapter_slot:
      return False  # an adapter session decodes plain: the chain verifies the base target
    if session.spec_seed_dev is not None:
      return True  # chain active
    return self._fresh_single_stream(session, first_token)

  @staticmethod
  def _fresh_single_stream(session, first_token) -> bool:
    """A chain starts right after a one-row prompt's prefill."""
    return first_token is not None and session.prompt_np is not None and session.prompt_np.shape[0] == 1 and session.curr_pos == session.prompt_len

  def _spec_gamma_for_dispatch(self) -> int:
    """The next spec dispatch's depth: the live depth, or a depth-1 probe
    once the plain streak reaches ``XOT_TPU_SPEC_REPROBE``, else 0 (plain)."""
    g = self._spec_gamma_live
    if g > 0:
      return g
    if self._spec_reprobe > 0 and self._spec_plain_streak >= self._spec_reprobe:
      return 1
    return 0

  def _note_spec_acceptance(self, emitted: int, rounds: int, gamma: int) -> None:
    """Fold one spec call's acceptance, (emitted / rounds - 1) / gamma, into
    the engine EWMA and re-run the depth policy (inference/paging.py)."""
    if rounds <= 0 or gamma <= 0:
      return
    self._spec_ewma = ewma_update(self._spec_ewma, (emitted / rounds - 1.0) / gamma)
    self._spec_gamma_live = spec_adapt_gamma(self._spec_ewma, gamma, self.spec_gamma)
    self._spec_plain_streak = 0
    metrics.observe_hist("spec_acceptance_ewma", self._spec_ewma, buckets=FRACTION_BUCKETS)

  # N-gram chain policy: per-session depth and EWMA.

  def _ngram_chunk_eligible(self, session, temp, first_token) -> bool:
    """The draft-free n-gram chain: greedy single-stream requests with
    ``XOT_TPU_SPEC_DECODE`` set and no draft loaded, entered right after
    prefill, continued while the session's index lives."""
    if self._draft_params is not None or not self.spec_decode or not self._spec_ngram_on:
      return False
    if (temp is not None and float(temp) > 0.0) or session.adapter_slot:
      return False  # an adapter session decodes plain: the chunks verify the base target
    if session.ngram_index is not None or session.ngram_unread:
      return True  # chain active
    return self._fresh_single_stream(session, first_token)

  def _ngram_gamma_for_dispatch(self, session) -> int:
    """The session's depth for its next chunk; a fresh session opens at the
    cap (``XOT_TPU_SPEC_NGRAM_MAX``)."""
    if session.ngram_gamma < 0:
      session.ngram_gamma = self.spec_ngram_max
    return session.ngram_gamma

  def _note_ngram_acceptance(self, session, accepted: int, proposed: int) -> None:
    """Count one n-gram chunk's proposed and accepted tokens (also for a
    session ended since its dispatch) and fold the acceptance into the
    session's EWMA and depth."""
    if proposed <= 0:
      return
    metrics.inc("spec_proposed_tokens_total", proposed, labels={"proposer": "ngram"})
    metrics.inc("spec_accepted_tokens_total", accepted, labels={"proposer": "ngram"})
    if session is None:
      return
    session.ngram_ewma = ewma_update(session.ngram_ewma, accepted / proposed)
    session.ngram_gamma = spec_adapt_gamma(session.ngram_ewma, max(session.ngram_gamma, 1), self.spec_ngram_max)
    metrics.observe_hist("spec_acceptance_ewma", session.ngram_ewma, buckets=FRACTION_BUCKETS)

  def _note_ngram_miss(self, session) -> None:
    """A suffix lookup found nothing: a zero-acceptance observation, so a
    session over text that never repeats walks back to plain chunks."""
    session.ngram_ewma = ewma_update(session.ngram_ewma, 0.0)
    session.ngram_gamma = spec_adapt_gamma(session.ngram_ewma, session.ngram_gamma, self.spec_ngram_max)

  def _dispatch_ngram_chunk_sync(self, request_id, first_token, steps: int, gamma: int):
    """One draft-free speculative chunk (``fused_spec_batch_decode`` at B=1
    on the session's dense cache, one captured program): the host proposes what followed the
    current suffix earlier in the history, the target verifies each window.
    Returns the handle, or None to hand this dispatch to the plain path (no
    proposal at the depth floor, or too close to the cache end)."""
    from ..models.decoder import fused_spec_batch_decode

    session = self.sessions[request_id]
    dev = self.device
    if session.ngram_index is None:
      idx = NgramIndex(self.spec_ngram_n)
      idx.extend(session.prompt_np[0])
      idx.extend([int(first_token)])
      session.ngram_index = idx
      token = torch.full((1, 1), int(first_token), dtype=torch.int32, device=dev)
    else:
      token = session.next_token_dev
      if token is None:
        session.ngram_index = None  # chain broken: plain re-seeds exactly
        return None
    G = self.spec_ngram_max
    rounds = max(steps // (G + 1), 1)
    stream = session.ngram_index.propose(rounds * (G + 1) + G)
    if len(stream) == 0:
      self._note_ngram_miss(session)
      if session.ngram_gamma <= 0:
        session.ngram_index = None  # depth floor: plain serves the rest
        return None
      # A tracking-only chunk (depth 0, one token a round): the history
      # stays live so the next repeating stretch can propose again.
      rounds, G, g_eff = steps, 0, 0
      props = prop_counts = None
    else:
      g_eff = min(gamma, len(stream))
      props = torch.from_numpy(np.asarray(stream, dtype=np.int32)[None, :]).to(dev)
      prop_counts = torch.full((1,), len(stream), dtype=torch.int32, device=dev)
    worst = rounds * (G + 1)
    if session.curr_pos + worst + 1 > session.max_seq:
      session.ngram_index = None  # near the cache end: plain trims exactly
      return None
    pos = torch.full((1,), session.curr_pos, dtype=torch.int32, device=dev)
    buf, counts, n_prop, seed, _pos, session.kv_cache, _ = fused_spec_batch_decode(
      self.params, self.cfg, self._effective_shard, None, self.cfg, self._effective_shard,
      token, session.kv_cache, None, pos, torch.ones((1,), dtype=torch.bool, device=dev), torch.full((1,), g_eff, dtype=torch.int32, device=dev),
      torch.zeros((1,), dtype=torch.float32, device=dev), rounds, G, top_k=1, k_max=1,
      props=props, prop_counts=prop_counts, programs=session.programs,
    )
    session.next_token_dev = seed
    session.ngram_unread = True
    return ("ngram", request_id, rounds, torch.cat([counts, n_prop, buf[0]]))

  def _ensure_draft_cache(self, session) -> None:
    """The draft's prefill over the prompt, padded like the target's, into
    the session's paired draft cache (one captured program per bucket)."""
    if session.draft_cache is not None:
      return
    draft = session.programs.draft
    B, S = session.prompt_np.shape
    pad_to = min(_round_up(S, PREFILL_BUCKET), session.max_seq)
    x_in = np.zeros((B, pad_to), dtype=np.int32)
    x_in[:, :S] = session.prompt_np
    draft.prefill(x_in, S)
    session.draft_cache = draft.cache

  def _dispatch_spec_chunk_sync(self, request_id, n_steps, first_token, steps: int, gamma: int):
    """One streaming chunk of the draft chain (``fused_speculative_chunk``,
    its rounds captured): seed token and position ride the device, so the
    node's dispatch-ahead works without a host read. The node trims at EOS
    as for plain chunks."""
    from ..models.decoder import fused_speculative_chunk

    session = self.sessions[request_id]
    if session.spec_seed_dev is None:
      self._ensure_draft_cache(session)
      session.spec_known_pos = session.curr_pos
      token = torch.full((1, 1), int(first_token), dtype=torch.int32, device=self.device)
      pos = session.curr_pos
    else:
      token, pos = session.spec_seed_dev, session.spec_pos_dev
    pos_hi = session.spec_known_pos + session.spec_inflight_slots  # the chain's position is at most this
    worst = steps + gamma + 1
    packed, seed, new_pos, session.kv_cache, session.draft_cache = fused_speculative_chunk(
      self.params, self.cfg, self._effective_shard, self._draft_params, token, session.kv_cache, session.draft_cache,
      pos, steps, gamma=gamma, n_limit=min(n_steps, steps), cfg_d=self._draft_cfg, shard_d=self._draft_shard, pos_hi=pos_hi, programs=session.programs,
    )
    session.spec_seed_dev = seed
    session.spec_pos_dev = new_pos
    session.spec_inflight_slots += worst
    session.next_token_dev = None  # the plain chain is broken while spec runs
    return ("spec", request_id, worst, gamma, packed)

  def _dispatch_chunk_sync(self, request_id, n_steps, temp, top_k, first_token):
    session = self.sessions[request_id]
    if self._spec_chunk_eligible(session, temp, first_token):
      G = self._spec_gamma_for_dispatch()
      steps = min(1 << (max(n_steps, 1) - 1).bit_length(), 256)  # power-of-two chunk sizes
      # Room: the confirmed position, every unread chunk's worst case and
      # this chunk's worst case must fit.
      base = session.spec_known_pos if session.spec_seed_dev is not None else session.curr_pos
      if G > 0 and base + session.spec_inflight_slots + (steps + G + 1) + 1 <= session.max_seq:
        return self._dispatch_spec_chunk_sync(request_id, n_steps, first_token, steps, G)
      if G == 0:
        self._spec_plain_streak += 1  # the depth floor: plain, counting toward a probe
      if session.spec_seed_dev is not None:
        # Near the cache end: read the chain's exact position once and hand
        # the stream to the plain path, which trims at max_seq. Unread spec
        # handles no longer touch the bookkeeping (read_chunk checks
        # spec_seed_dev): the position read here includes them.
        session.curr_pos = int(session.spec_pos_dev)
        session.spec_known_pos = session.curr_pos
        session.next_token_dev = session.spec_seed_dev
        session.spec_seed_dev = None
        session.spec_pos_dev = None
        session.spec_inflight_slots = 0
    elif self._ngram_chunk_eligible(session, temp, first_token):
      # An unread n-gram chunk answers the node's dispatch-ahead with None:
      # the node re-dispatches after reading it, the synchronous cadence
      # host proposals need.
      if session.ngram_unread:
        return None
      G = self._ngram_gamma_for_dispatch(session)
      if G > 0:
        steps = min(1 << (max(n_steps, 1) - 1).bit_length(), 256)
        handle = self._dispatch_ngram_chunk_sync(request_id, first_token, steps, G)
        if handle is not None:
          return handle
      else:
        session.ngram_index = None  # the session is at the depth floor: plain takes over
    return self._dispatch_plain_chunk_sync(request_id, n_steps, temp, top_k, first_token)

  def _dispatch_plain_chunk_sync(self, request_id, n_steps, temp, top_k, first_token):
    session = self.sessions[request_id]
    n_steps = min(n_steps, session.max_seq - session.curr_pos)
    if n_steps <= 0:
      return None
    if first_token is not None:
      token = int(first_token)
    else:
      token = session.next_token_dev
      if token is None:
        raise RuntimeError(f"no chained token for request {request_id}; pass first_token after prefill")
    toks, _ = fused_decode(
      self.params, self.cfg, self._effective_shard, token, session.kv_cache, session.curr_pos, n_steps,
      temp=float(temp), top_k=int(top_k), generator=self.generator, programs=session.programs, **self._session_adapter_kw(session),
    )
    session.next_token_dev = toks[:, -1:]
    session.curr_pos += n_steps
    return toks

  async def read_chunk(self, handle) -> list[int]:
    if handle is None:
      return []
    return await asyncio.get_running_loop().run_in_executor(self.executor, self._read_chunk_sync, handle)

  def _read_chunk_sync(self, handle) -> list[int]:
    if isinstance(handle, tuple) and handle[0] == "ngram":
      # [m, n_prop, tokens...] in one read: confirm the position, extend
      # the index with the emitted tokens, feed the session's EWMA.
      _, request_id, rounds, packed = handle
      row = packed.cpu().numpy()
      m, n_prop = int(row[0]), int(row[1])
      session = self.sessions.get(request_id)
      self._note_ngram_acceptance(session, max(m - rounds, 0), n_prop)
      toks = [int(t) for t in row[2 : 2 + m]]
      if session is not None:
        session.ngram_unread = False
        session.curr_pos += m
        if session.ngram_index is not None:
          session.ngram_index.extend(toks)
      return toks
    if isinstance(handle, tuple) and handle[0] == "spec":
      # [m, rounds, tokens...] in one read. The position is confirmed only
      # while the chain is active: after the hand-off near the cache end
      # curr_pos already includes this chunk.
      _, request_id, worst, gamma, packed = handle
      row = packed.cpu().numpy()
      m = int(row[0])
      self._note_spec_acceptance(m, int(row[1]), gamma)
      session = self.sessions.get(request_id)
      if session is not None and session.spec_seed_dev is not None:
        session.spec_known_pos += m
        session.spec_inflight_slots = max(session.spec_inflight_slots - worst, 0)
        session.curr_pos = session.spec_known_pos
      return [int(t) for t in row[2 : 2 + m]]
    return [int(t) for t in handle[0].cpu().tolist()]

  async def generate_oneshot(
    self,
    request_id: str,
    shard: Shard,
    first_token: int,
    max_steps: int,
    eos_ids=(),
    temp: float = 0.6,
    top_k: int = 35,
  ) -> list[int]:
    """Generate a whole response (until EOS) in one device loop; returns
    the tokens trimmed at the first EOS. Greedy requests speculate when a
    draft is loaded."""
    await self.ensure_shard(shard)
    return await asyncio.get_running_loop().run_in_executor(
      self.executor, self._generate_oneshot_sync, request_id, first_token, max_steps, eos_ids, temp, top_k
    )

  def _generate_oneshot_sync(self, request_id, first_token, max_steps, eos_ids, temp, top_k):
    session = self.sessions[request_id]
    room = session.max_seq - session.curr_pos
    if room <= 0:
      return []
    spec_gamma = self._spec_gamma_for_dispatch() if self._draft_params is not None else 0
    if (
      self._draft_params is not None
      and (temp is None or float(temp) <= 0.0)
      and not session.adapter_slot  # speculation verifies the base target: adapter sessions stay plain
      and session.prompt_np is not None
      and session.curr_pos == session.prompt_len  # fresh after prefill: the draft sees the prompt only
      and session.prompt_np.shape[0] == 1
      # Rounds need gamma+1 slots of headroom; near the cache end plain
      # decode emits the last tokens.
      and max_steps <= room - spec_gamma - 1
    ):
      if spec_gamma > 0:
        return self._generate_speculative_sync(request_id, first_token, max_steps, eos_ids, spec_gamma)
      self._spec_plain_streak += 1  # the depth floor: plain, counting toward a probe
    # The program's step count is bucketed (a power of two, capped by the
    # cache room) so varying max_tokens reuse a few programs; ``n_limit``
    # caps the steps that run, as in the reference.
    limit = max(1, min(max_steps, room))
    steps = min(1 << (limit - 1).bit_length(), room)
    eos = tuple(sorted(int(e) for e in eos_ids))
    buf, _n, _ = fused_generate(
      self.params, self.cfg, self._effective_shard, int(first_token), session.kv_cache, session.curr_pos, steps,
      eos_ids=eos, temp=float(temp), top_k=int(top_k), generator=self.generator, n_limit=limit, programs=session.programs,
      **self._session_adapter_kw(session),
    )
    row = buf[0].cpu().numpy()
    n = limit
    if eos:
      hits = np.nonzero(np.isin(row[:limit], eos))[0]
      if hits.size:
        n = int(hits[0]) + 1
    session.curr_pos += n
    session.next_token_dev = None  # chain broken: the next chunk must re-seed
    return [int(t) for t in row[:n]]

  def _generate_speculative_sync(self, request_id, first_token, max_steps, eos_ids, gamma: int):
    """Greedy speculative oneshot (``fused_speculative_generate``, its
    rounds captured): the plain greedy tokens, at the draft's pace."""
    from ..models.decoder import fused_speculative_generate

    session = self.sessions[request_id]
    room = session.max_seq - session.curr_pos
    limit = min(max_steps, room - gamma - 1)  # the caller guarantees > 0
    steps = min(1 << (limit - 1).bit_length(), room - gamma - 1)
    self._ensure_draft_cache(session)
    token = torch.full((1, 1), int(first_token), dtype=torch.int32, device=self.device)
    eos = tuple(sorted(int(e) for e in eos_ids))
    buf, n, rounds, session.kv_cache, session.draft_cache = fused_speculative_generate(
      self.params, self.cfg, self._effective_shard, self._draft_params, self._draft_cfg or self.cfg, self._draft_shard or self._effective_shard,
      token, session.kv_cache, session.draft_cache, session.curr_pos, steps, gamma=gamma, eos_ids=eos, n_limit=limit, programs=session.programs,
    )
    row = buf.cpu().numpy()
    self._note_spec_acceptance(n, rounds, gamma)
    n = min(n, limit)
    if eos:
      hits = np.nonzero(np.isin(row[:n], eos))[0]
      if hits.size:
        n = int(hits[0]) + 1
    session.curr_pos += n
    session.next_token_dev = None
    return [int(t) for t in row[:n]]

  def end_request(self, request_id: str) -> None:
    self._drop_session(request_id)
    self._session_adapters.pop(request_id, None)

  # ---------------------------------------------------------------- multi-LoRA

  def enable_multi_lora(self, capacity: int | None = None, rank: int | None = None, host_budget_bytes: int | None = None):
    """Turn on multi-LoRA serving: all-zero STACKED adapter leaves
    ``{wq,wv}_alora_{a,b} [L, n_slots, ...]`` on the ``layers`` and
    ``moe_layers`` stacks, in the model dtype on the device (slot 0 stays
    zero = the base model), and the ``inference/adapters.py`` registry over
    them. Returns the registry, or None with ``XOT_TPU_LORA=0`` (base
    serving byte for byte: the hook never runs). The capacity rounds up to
    a power of two and is allocated here, once: every captured graph holds
    the leaves' addresses, so an install is an in-place copy into a slot
    (``_install_adapter_slot``) and never a new tensor.

    The sessions, the solo pool and the batched server are dropped, as in
    the reference: their graphs hold the params without the leaves. Whole
    models on one device only (a ring node's partial shard is refused);
    MLA models are refused with the reference's message (their targets map
    onto the latent projections the per-row hook does not cover)."""
    from .adapters import ADAPTER_TARGETS, AdapterRegistry, lora_capacity, lora_enabled, lora_rank, round_pow2

    if not lora_enabled():
      return None
    if self.adapter_registry is not None:
      return self.adapter_registry
    if self.cfg is None or self.params is None:
      raise RuntimeError("load a model before enabling multi-LoRA")
    if self.cfg.is_mla:
      raise ValueError("multi-LoRA serving does not support MLA models (wq/wv targets map onto latent projections)")
    eff = self._effective_shard
    if not (eff.is_first_layer and eff.is_last_layer):
      raise ValueError("multi-LoRA serving needs the whole model on one node")
    cap = round_pow2(capacity) if capacity else lora_capacity()
    rank = int(rank or lora_rank())
    params = dict(self.params)
    geometry: dict = {}
    for stack in ("layers", "moe_layers"):
      if stack not in params:
        continue
      layers = dict(params[stack])
      geo: dict = {}
      for t in ADAPTER_TARGETS:
        w = layers.get(t)
        if w is None:
          continue
        # The model's width, not w's in-axis: packed int4 codes halve it.
        L, d_in, d_out = int(w.shape[0]), int(self.cfg.dim), int(w.shape[2])
        geo[t] = (L, d_in, d_out)
        layers[f"{t}_alora_a"] = torch.zeros((L, cap, d_in, rank), dtype=self.cfg.dtype, device=self.device)
        layers[f"{t}_alora_b"] = torch.zeros((L, cap, rank, d_out), dtype=self.cfg.dtype, device=self.device)
      if geo:
        params[stack] = layers
        geometry[stack] = geo
    if not geometry:
      raise ValueError("the loaded model has no LoRA target projections (wq/wv)")
    self.params = params
    self.adapter_registry = AdapterRegistry(geometry=geometry, rank=rank, capacity=cap, install=self._install_adapter_slot, host_budget_bytes=host_budget_bytes)
    self._session_adapters = {}
    self._clear_sessions()
    self._drop_batched_server()
    return self.adapter_registry

  def _install_adapter_slot(self, slot: int, arrays: dict | None):
    """The registry's install hook: write one adapter's (rank-padded)
    factors into slot ``slot`` of the stacked leaves, IN PLACE (``None``
    zeroes the slot). The leaves keep their addresses, so captured graphs
    read the new factors at their next replay. All device work runs on the
    executor thread: called from a running event loop (the batched
    server's admission), the write is queued there instead, ahead of every
    dispatch submitted after it (one worker runs them in order), and its
    Future is returned (its result: the write's seconds); called on the
    executor (a solo session) or with no loop (tests, the loader), it runs
    here and returns None."""
    try:
      asyncio.get_running_loop()
    except RuntimeError:
      self._write_adapter_slot(slot, arrays)
      return None
    return self.executor.submit(self._timed_adapter_write, slot, arrays)

  def _timed_adapter_write(self, slot: int, arrays: dict | None) -> float:
    t0 = time.perf_counter()
    self._write_adapter_slot(slot, arrays)
    return time.perf_counter() - t0

  def _write_adapter_slot(self, slot: int, arrays: dict | None) -> None:
    for stack, layers in self.params.items():
      per = (arrays or {}).get(stack, {})
      for name, leaf in layers.items() if stack in ("layers", "moe_layers") else ():
        if "_alora_" not in name:
          continue
        t, f = name.split("_alora_")
        if t not in per:
          leaf[:, slot].zero_()  # a target this adapter leaves alone
          continue
        host = np.array(per[t][0 if f == "a" else 1], copy=True, order="C")  # npz arrays are read-only
        leaf[:, slot].copy_(torch.from_numpy(host).to(leaf.dtype))

  def set_request_adapter(self, request_id: str, name: str | None) -> None:
    """Select a named adapter for a request served on the SOLO path (the
    batched server takes the name at ``submit``). Checked against the
    registry now: an unknown name answers 400 at the API, before any device
    work."""
    if not name:
      return
    from .adapters import check_known

    check_known(self.adapter_registry, name)
    self._session_adapters[request_id] = name
    while len(self._session_adapters) > 1024:  # a client-driven keyspace stays bounded
      self._session_adapters.pop(next(iter(self._session_adapters)))

  def _acquire_session_slot(self, request_id: str) -> int:
    """The solo session's adapter slot, pinned for the session (0: the base
    model). Dead solo pins (sessions dropped by a model change or a replay
    epoch without an unpin) are swept here, so a leaked pin never shrinks
    the evictable slot set for good."""
    reg = self.adapter_registry
    name = self._session_adapters.get(request_id)
    if reg is None or name is None:
      return 0
    for holder in reg.pinned_holders():
      if isinstance(holder, tuple) and holder[0] == "solo" and holder[1] != request_id and holder[1] not in self.sessions:
        reg.unpin(holder)
    return reg.acquire(name, holder=("solo", request_id))

  @staticmethod
  def _session_adapter_kw(session) -> dict:
    """``adapter_ids=`` of a session's dispatches: its slot for every row,
    or nothing for a base session (the hook never runs)."""
    return {"adapter_ids": int(session.adapter_slot)} if session.adapter_slot else {}

  # ---------------------------------------------------------------- scoring

  async def score_tokens(self, shard: Shard, tokens, n_scored: int, top_n: int):
    """Logprobs of the last ``n_scored`` of ``tokens`` (OpenAI ``logprobs``):
    one cache-less forward over prompt and completion
    (models/decoder.py ``score_last_tokens``), on the executor thread like
    every other dispatch. Returns numpy (chosen_logprobs [n], top_ids
    [n, top_n], top_logprobs [n, top_n]), or None when there is nothing to
    score or the loaded shard lacks the head. As in the reference, the
    sequence is padded to the 128 bucket, ``n_scored`` to a multiple of 32
    (within the bucket) and the top list is 20 wide, so one program serves
    every length in a bucket; the extra rows and columns are sliced off
    here."""
    eff = self._effective_shard
    if self.cfg is None or self.params is None or eff is None or not (eff.is_first_layer and eff.is_last_layer):
      return None
    from ..models.decoder import score_last_tokens

    toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
    S = int(toks.shape[0])
    if n_scored <= 0 or n_scored >= S:
      return None
    pad_to = _round_up(S, PREFILL_BUCKET)
    buf = np.zeros((1, pad_to), dtype=np.int32)
    buf[0, :S] = toks
    n_bucket = min(_round_up(int(n_scored), 32), pad_to - 1)

    def run():
      # The real length rides as a device scalar (a traced int32 in the
      # reference): it keys no build, and filling it syncs nothing.
      seq_len = torch.full((), S, dtype=torch.int32, device=self.device)
      out = score_last_tokens(self.params, self.cfg, eff, self._to_device(buf), seq_len, n_bucket, 20)
      chosen_lp, top_ids, top_lp = (x.cpu().numpy() for x in out)
      n, t = int(n_scored), max(int(top_n), 1)
      return chosen_lp[-n:], top_ids[-n:, :t], top_lp[-n:, :t]

    return await asyncio.get_running_loop().run_in_executor(self.executor, run)

  # ---------------------------------------------------------------- batching

  def supports_batched(self) -> bool:
    """Whether the batched server can serve the loaded shard: every batched
    program embeds tokens and runs the head, so only a full-model shard."""
    eff = self._effective_shard
    return eff is None or (eff.is_first_layer and eff.is_last_layer)

  @property
  def batch_ops(self):
    """Device-op backend of the batched server (inference/batch_ops.py)."""
    if self._batch_ops is None:
      from .batch_ops import DecoderBatchOps

      self._batch_ops = DecoderBatchOps(self)
    return self._batch_ops

  def get_batched_server(self):
    """The continuous-batching server (inference/batch_scheduler.py), built
    at first use; one per loaded model, since its page pool is
    model-specific."""
    if self._batched_server is None:
      from .batch_scheduler import BatchedServer

      self._batched_server = BatchedServer(self)
    return self._batched_server

  def _drop_batched_server(self) -> None:
    """Stop the old server's loop so its page pool frees (model swap). Its
    KV tier's host store clears with it (``shutdown``) and the local prefix
    advertisement is withdrawn: after a swap the same token chains hold
    another model's KV."""
    if self._batched_server is not None:
      self._batched_server.shutdown()
      from .kv_tier import prefix_registry

      prefix_registry.clear_local()
    self._batched_server = None
    self._batch_ops = None
