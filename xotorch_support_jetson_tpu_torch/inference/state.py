"""Per-request inference state handed between engine and node.

Own copy of the reference's ``inference/state.py``: only tokens and scalar
positions travel; causal masks are recomputed from positions inside the
attention ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class InferenceState:
  tokens: np.ndarray | None = None  # [B, S] int32: all tokens so far (prompt + generated)
  curr_pos: int = 0  # positions already absorbed into the KV cache
  prompt_len: int = 0
  extras: dict = field(default_factory=dict)
