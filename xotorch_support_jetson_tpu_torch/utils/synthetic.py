"""Synthetic model variants for offline measurement: the port's own copy of
the reference's ``utils/synthetic.py``.

``peaked_echo_params`` manufactures the speculative-decoding acceptance
ceiling. On random weights the logits are near-uniform, so a draft
disagrees with the target often and speculation loses: an acceptance floor
no offline run can escape. The echo variant scales the residual-stream
write projections (``wo`` / ``w_down``) toward zero, so each layer adds
almost nothing and the hidden state stays close to the token embedding;
with a tied (or self-similar) head the logits then peak sharply at the
current token, greedy generation echoes it, and a quantized or truncated
draft agrees with the target almost always. Measuring speculation against
plain decoding on both variants brackets a real checkpoint's behaviour
without downloading one.

``spec_agreement_bitmap`` measures, on the running build's numerics, the
one event speculative acceptance counts (does the draft's greedy token at
a position equal the target's next trajectory token), and
``simulate_spec_acceptance`` replays the greedy loop's accept rule on such
a bitmap, so an expected acceptance is derived from a measurement rather
than asserted as a constant.
"""

from __future__ import annotations

import torch


def spec_agreement_bitmap(params_t, cfg_t, shard_t, params_d, cfg_d, shard_d, prompt, trajectory) -> list[bool]:
  """Per-step draft/target argmax agreement along a greedy ``trajectory``.

  The draft runs teacher-forced along the target's own greedy output, one
  single-token step at a time (the shape of the speculative proposal
  loop), on a dense cache of ``cfg_d.max_seq_len`` slots on the draft's
  device. ``trajectory[i]`` is the target's greedy token at position
  ``len(prompt) + i``; bit i says whether the draft, fed the prompt and
  ``trajectory[:i]``, proposes ``trajectory[i]``. ``params_t`` /
  ``cfg_t`` / ``shard_t`` name the target the trajectory came from."""
  import numpy as np

  from ..models.decoder import init_kv_cache, shard_forward

  dev = params_d["embed"].device
  prompt = np.asarray(prompt, dtype=np.int32).reshape(1, -1)
  S = prompt.shape[1]
  cache_d = init_kv_cache(cfg_d, shard_d.n_shard_layers, 1, cfg_d.max_seq_len, device=dev)
  positions = torch.arange(S, dtype=torch.int32, device=dev)[None]
  logits, _ = shard_forward(params_d, cfg_d, shard_d, torch.from_numpy(prompt).to(dev), positions, cache_d)
  proposal = int(torch.argmax(logits[0, S - 1]))
  bits: list[bool] = []
  for i, tok in enumerate(trajectory):
    bits.append(proposal == int(tok))
    # Teacher-force the true trajectory token, not the proposal: after a
    # disagreement the loop's correction re-syncs the draft to the target.
    step = torch.full((1, 1), int(tok), dtype=torch.int32, device=dev)
    logits, _ = shard_forward(params_d, cfg_d, shard_d, step, torch.full((1, 1), S + i, dtype=torch.int32, device=dev), cache_d)
    proposal = int(torch.argmax(logits[0, 0]))
  return bits


def simulate_spec_acceptance(bits: list[bool], gamma: int, max_steps: int) -> float:
  """The acceptance the greedy speculative loop achieves on an agreement
  bitmap: each round takes the run of consecutive agreements from the
  current position (capped at ``gamma``) plus the correction token. The
  round's run is capped by gamma and by the bitmap, not by ``max_steps``
  (the loop's last round emits its full run past the limit too), so probe
  with a bitmap at least ``max_steps + gamma`` long for an exact replay."""
  if gamma <= 0:
    return 0.0  # plain decoding proposes nothing
  n = rounds = 0
  while n < max_steps:
    run = 0
    while run < gamma and n + run < len(bits) and bits[n + run]:
      run += 1
    n += run + 1
    rounds += 1
  return (n / rounds - 1.0) / gamma if rounds else 0.0


def peaked_echo_params(params: dict, damp: float = 0.05) -> dict:
  """A peaked-logit variant of ``params`` (the port's tree: the stacked
  ``layers`` and ``moe_layers`` leaves): the residual-stream writes ``wo``
  and the down projections scaled by ``damp``. Returns a shallow copy (untouched leaves shared).
  On a weight-quantized tree a leaf with a ``<name>_scale`` sibling keeps
  its codes (damping int8 or int4 codes would round them to nothing) and
  its scale is damped instead: the same model. ``damp`` is taken in each
  leaf's dtype (in bf16 it rounds to 0.0500488…), as the reference's
  weakly typed scalar is."""
  out = dict(params)
  for group in ("layers", "moe_layers"):
    if group not in params:
      continue
    stack = dict(params[group])
    for k in list(stack):
      # The residual-stream writes: wo and every down projection (dense
      # w_down, the experts' and the shared expert's).
      if (k == "wo" or k.endswith("_down")) and not k.endswith("_scale"):
        name = f"{k}_scale" if f"{k}_scale" in stack else k
        leaf = stack[name]
        stack[name] = leaf * torch.tensor(damp, dtype=leaf.dtype, device=leaf.device)
    out[group] = stack
  return out
