"""The JAX package's parameter tree → the port's parameters.

``params_from_jax`` takes the reference decoder's params as numpy arrays
(stacked ``[L, ...]`` layer leaves, ``x @ w`` orientation — the two layouts
already agree) and returns torch tensors in ``cfg.dtype`` on ``device``, so
the tests run both packages on identical weights. The input is plain numpy
(bf16 arrives as an ``ml_dtypes`` array and is reinterpreted bit for bit),
so this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inference.shard import Shard
from .config import ModelConfig
from .decoder import Params
from .loader import check_shard_params

_LAYER_KEYS = {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down", "bq", "bk", "bv", "q_norm", "k_norm"}
_TOP_KEYS = {"embed", "final_norm", "lm_head"}


def _tensor(arr, dtype, device) -> torch.Tensor:
  arr = np.array(arr, copy=True, order="C")  # writable and contiguous
  if arr.dtype.name == "bfloat16":
    t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
  else:
    t = torch.from_numpy(arr)
  return t.to(device=device, dtype=dtype)


def params_from_jax(np_params: dict, cfg: ModelConfig, shard: Shard, device=None) -> Params:
  unknown = (set(np_params) - _TOP_KEYS - {"layers"}) | (set(np_params.get("layers", {})) - _LAYER_KEYS)
  if unknown:
    raise NotImplementedError(f"the PyTorch port has no counterpart for these parameter leaves yet: {sorted(unknown)}")
  params: Params = {"layers": {k: _tensor(v, cfg.dtype, device) for k, v in np_params["layers"].items()}}
  for key in _TOP_KEYS & set(np_params):
    params[key] = _tensor(np_params[key], cfg.dtype, device)
  check_shard_params(params, cfg, shard)
  return params
