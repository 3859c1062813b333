"""Text-to-image and img2img over the stable-diffusion stack.

Counterpart of the reference's ``inference/diffusion_pipeline.py``: the
prompt pair through CLIP (unconditional row, then conditional), the
schedule cut into ``progress_chunk``-step chunks (models/diffusion.py
``sample_chunk``, an eager loop on the device), progress reported and the
cancel check polled between chunks, then the VAE decode to uint8 pixels.
Requested sizes and init images snap to the model's pixel grid
(``px_multiple``: the VAE's stride times the UNet's), so an off-grid size
never shape-mismatches the UNet's skip concats.

Every random draw (the initial latents, the VAE sample of an init image,
img2img's noise) goes through ``_normal``, on a ``torch.Generator`` seeded
by the request.
"""

from __future__ import annotations

import zlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..models.diffusion import (
  DiffusionConfig,
  Params,
  add_noise,
  alphas_cumprod,
  clip_text_encode,
  ddim_timesteps,
  sample_chunk,
  vae_decode,
  vae_encode,
  vae_sample_latents,
)

ProgressCb = Callable[[int, int], None]


class GenerationCancelled(Exception):
  """Raised between denoise chunks when the caller's cancel check fires (a
  client gone): the engine's one worker must not finish a dead request."""


def _cast(tree, dtype, device):
  if isinstance(tree, dict):
    return {k: _cast(v, dtype, device) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_cast(v, dtype, device) for v in tree]
  return tree.to(device=device, dtype=dtype)


class DiffusionPipeline:
  """One loaded diffusion model: its params on ``device`` in ``dtype``."""

  def __init__(self, cfg: DiffusionConfig, params: Params, tokenizer=None, dtype=torch.bfloat16, device=None, progress_chunk: int = 5):
    self.cfg = cfg
    self.tokenizer = tokenizer
    self.dtype = dtype
    self.device = torch.device(device) if device is not None else params["unet"]["conv_in_w"].device
    self.progress_chunk = max(1, progress_chunk)
    self.params = _cast(params, dtype, self.device)
    self.alphas = alphas_cumprod(cfg).numpy()
    # the pixel grid: the VAE's stride times the UNet's, so the latents
    # divide by the UNet's downsample depth
    self.vae_stride = 2 ** (len(cfg.vae.block_out_channels) - 1)
    self.px_multiple = self.vae_stride * 2 ** (len(cfg.unet.block_out_channels) - 1)

  # ------------------------------------------------------------- prompts

  def _tokenize(self, text: str) -> np.ndarray:
    m = self.cfg.clip.max_positions
    if self.tokenizer is not None:
      enc = self.tokenizer(text, padding="max_length", max_length=m, truncation=True, return_tensors="np")
      return np.asarray(enc["input_ids"], np.int32)
    # A checkpoint without a tokenizer: a stable crc32 word hash (Python's
    # hash() is salted per process), the reference's ids bit for bit.
    ids = [(zlib.crc32(w.encode()) % (self.cfg.clip.vocab_size - 2)) + 2 for w in text.split()][: m - 2]
    row = [0] + ids + [1] + [1] * (m - 2 - len(ids))
    return np.asarray([row], np.int32)

  def encode_prompt(self, prompt: str, negative: str = "") -> torch.Tensor:
    """→ ctx_pair [2, S, D]: row 0 unconditional, row 1 conditional."""
    tokens = np.concatenate([self._tokenize(negative), self._tokenize(prompt)], axis=0)
    ids = torch.from_numpy(tokens).long().to(self.device)
    return clip_text_encode(self.params["clip"], self.cfg.clip, ids).to(self.dtype)

  # ------------------------------------------------------------ sampling

  def _normal(self, gen: torch.Generator, shape) -> torch.Tensor:
    """One f32 standard-normal draw of ``shape`` (NCHW) on the device."""
    return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

  def _snap(self, px: int) -> int:
    """The nearest (half-up) multiple of the pixel grid, at least one unit."""
    return max(int(px / self.px_multiple + 0.5), 1) * self.px_multiple

  def _schedule(self, steps: int):
    ts = ddim_timesteps(self.cfg, steps).numpy().astype(np.int32)
    a_ts = self.alphas[ts]
    prev = ts - (self.cfg.num_train_timesteps // steps)
    # SD's DDIMScheduler ships set_alpha_to_one=False: the step past t = 0
    # uses alphas_cumprod[0], not 1.0
    final_alpha = 1.0 if self.cfg.set_alpha_to_one else float(self.alphas[0])
    a_prevs = np.where(prev >= 0, self.alphas[np.clip(prev, 0, None)], final_alpha).astype(np.float32)
    return ts, a_ts, a_prevs

  def _init_latents(self, gen: torch.Generator, init_image: np.ndarray, n: int, a_t0) -> torch.Tensor:
    """img2img's start: the init image (uint8 [H, W, 3]) resized onto the
    grid (bilinear, antialiased when it shrinks), VAE-encoded, sampled, and
    noised to ``a_t0``; the n candidates share the encoded image."""
    img = torch.from_numpy(np.array(init_image, dtype=np.float32)).to(self.device).permute(2, 0, 1)[None] / 127.5 - 1.0
    ih, iw = img.shape[2], img.shape[3]
    gh, gw = self._snap(ih), self._snap(iw)
    if (gh, gw) != (ih, iw):
      img = F.interpolate(img, size=(gh, gw), mode="bilinear", align_corners=False, antialias=True)
    moments = vae_encode(self.params["vae"], self.cfg.vae, img.to(self.dtype)).float()
    x0 = vae_sample_latents(moments, self._normal(gen, (1, moments.shape[1] // 2, *moments.shape[2:])), self.cfg.vae.scaling_factor)
    x0 = x0.repeat(n, 1, 1, 1)
    return add_noise(x0, self._normal(gen, tuple(x0.shape)), a_t0).to(self.dtype)

  def generate(
    self,
    prompt: str,
    negative: str = "",
    steps: int = 50,
    guidance: float = 7.5,
    seed: int = 0,
    size: tuple[int, int] | None = None,
    init_image: np.ndarray | None = None,
    strength: float = 0.8,
    method: str = "ddim",
    progress_cb: ProgressCb | None = None,
    should_cancel: Callable[[], bool] | None = None,
    n: int = 1,
  ) -> np.ndarray:
    """A uint8 [H, W, 3] image ([n, H, W, 3] when n > 1).

    The n candidates denoise as one batch (2n rows with guidance).
    ``init_image`` (uint8 [H, W, 3]) switches to img2img: the last
    ``strength`` of the schedule denoises the noised, encoded image.
    ``should_cancel`` is polled before each chunk; a true answer raises
    GenerationCancelled."""
    cfg = self.cfg
    gen = torch.Generator(device=self.device).manual_seed(int(seed))
    ts, a_ts, a_prevs = self._schedule(steps)
    if init_image is not None:
      start = max(1, min(steps, int(round(steps * strength))))
      ts, a_ts, a_prevs = ts[steps - start :], a_ts[steps - start :], a_prevs[steps - start :]
      latents = self._init_latents(gen, init_image, n, torch.as_tensor(a_ts[0], device=self.device))
    else:
      h = w = cfg.sample_size
      if size is not None:
        h, w = self._snap(size[0]) // self.vae_stride, self._snap(size[1]) // self.vae_stride
      latents = self._normal(gen, (n, cfg.unet.in_channels, h, w)).to(self.dtype)

    ctx = self.encode_prompt(prompt, negative)
    # the guidance batch: n unconditional rows, then n conditional ones
    ctx_pair = torch.cat([ctx[:1].expand(n, -1, -1), ctx[1:].expand(n, -1, -1)], dim=0)
    total = len(ts)
    if progress_cb:
      progress_cb(0, total)
    a_ts_d = torch.from_numpy(np.ascontiguousarray(a_ts, np.float32)).to(self.device)
    a_prevs_d = torch.from_numpy(np.ascontiguousarray(a_prevs, np.float32)).to(self.device)
    done = 0
    while done < total:
      if should_cancel is not None and should_cancel():
        raise GenerationCancelled(f"cancelled at step {done}/{total}")
      span = min(self.progress_chunk, total - done)
      sl = slice(done, done + span)
      latents = sample_chunk(self.params["unet"], cfg, latents, ctx_pair, ts[sl], a_ts_d[sl], a_prevs_d[sl], float(guidance), method)
      done += span
      if progress_cb:
        progress_cb(done, total)

    img = vae_decode(self.params["vae"], cfg.vae, latents.to(self.dtype))
    img = ((img.float() + 1.0) * 127.5).clamp(0, 255).permute(0, 2, 3, 1).cpu().numpy().astype(np.uint8)
    return img[0] if n == 1 else img
