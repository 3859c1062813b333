"""Prompt-lookup (n-gram) draft proposer for batched speculative decoding.
Own copy of the reference's ``inference/ngram.py``.

On workloads that quote their context (RAG answers, code edits, multi-turn
chats restating earlier turns) the continuation being generated has often
already appeared in the row's prompt+generated history. Matching the current
suffix against that history yields a draft that costs no device work, no
device memory and no KV pages; the target then verifies it in one batched
window (models/decoder.py ``fused_spec_paged_batch_decode``), and the
scheduler's per-row policy (inference/paging.py ``spec_adapt_gamma``,
``spec_select_proposer``) walks rows whose text never repeats back to plain
decode.

``NgramIndex`` is ONE row's incremental suffix index over its own history:

- ``extend(tokens)`` appends emitted tokens, O(N) dict writes per token
  (N = ``XOT_TPU_SPEC_NGRAM_N``, the longest suffix matched). The scheduler
  calls it once at admission with the prompt and first token, and once per
  settle with that chunk's emitted tokens.
- ``propose(max_tokens)`` keys on the last-N-token suffix, longest match
  first (N down to 1), and returns the run of ``max_tokens`` tokens that
  followed the most recent earlier occurrence of that suffix, continued
  cyclically past the end of the history. Empty on a miss.

For each gram length k the index keeps the end position of the latest and
the previous occurrence; the latest occurrence of the current suffix is the
suffix itself, so the previous one is the match. Memory is O(history · N)
dict entries per row, bounded by the context window.

Knobs:

- ``XOT_TPU_SPEC_NGRAM`` (default on; only ``0`` and ``false`` turn it
  off): with it on, ``XOT_TPU_SPEC_BATCH=auto`` speculates draft-free.
- ``XOT_TPU_SPEC_NGRAM_N`` (default 3): longest suffix length to match.
- ``XOT_TPU_SPEC_NGRAM_MAX`` (default 8): the proposer's per-round depth
  cap (``gamma_max``; the verify window is this plus one tokens wide).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["NgramIndex", "ngram_enabled", "ngram_knobs"]


def ngram_enabled() -> bool:
  """Whether the n-gram proposer family is on (``XOT_TPU_SPEC_NGRAM``,
  default on). ``XOT_TPU_SPEC_BATCH=0`` still turns speculation off."""
  return os.getenv("XOT_TPU_SPEC_NGRAM", "1") not in ("0", "false")


def ngram_knobs() -> tuple[int, int]:
  """(suffix length N, depth cap) from the env, floored at 1."""
  n = max(int(os.getenv("XOT_TPU_SPEC_NGRAM_N", "3")), 1)
  gmax = max(int(os.getenv("XOT_TPU_SPEC_NGRAM_MAX", "8")), 1)
  return n, gmax


class NgramIndex:
  """Incremental suffix-match index over one row's token history."""

  def __init__(self, n: int | None = None):
    self.n = max(int(n), 1) if n is not None else ngram_knobs()[0]
    self.history: list[int] = []
    # Per gram length k (1..n): k-gram -> end position of its latest
    # occurrence, and -> end position of the occurrence before that.
    self._last: list[dict[tuple, int]] = [dict() for _ in range(self.n)]
    self._prev: list[dict[tuple, int]] = [dict() for _ in range(self.n)]

  def __len__(self) -> int:
    return len(self.history)

  def extend(self, tokens) -> None:
    """Append emitted tokens, updating every gram length's maps."""
    h = self.history
    for t in tokens:
      h.append(int(t))
      p = len(h) - 1
      for k in range(1, self.n + 1):
        if p + 1 < k:
          break
        gram = tuple(h[p + 1 - k : p + 1])
        old = self._last[k - 1].get(gram)
        if old is not None:
          self._prev[k - 1][gram] = old
        self._last[k - 1][gram] = p

  def propose(self, max_tokens: int) -> np.ndarray:
    """``max_tokens`` predicted tokens after the most recent earlier
    occurrence of the longest matching suffix; an empty int32 array on a
    miss.

    A match ``period = P - e`` positions back predicts position P+1+j as
    the value at P+1+j-period, recursively past the end of the history, so
    a period shorter than the requested depth (a repeated token, a short
    templated run) still proposes at full depth."""
    h = self.history
    P = len(h) - 1
    if P < 0 or max_tokens <= 0:
      return np.empty((0,), np.int32)
    for k in range(min(self.n, P + 1), 0, -1):
      gram = tuple(h[P + 1 - k : P + 1])
      e = self._last[k - 1].get(gram)
      if e == P:  # the suffix itself: the real match is the one before it
        e = self._prev[k - 1].get(gram)
      if e is None or e >= P:
        continue
      period = P - e
      out: list[int] = []
      for j in range(max_tokens):
        src = P + 1 + j - period
        out.append(h[src] if src <= P else out[src - P - 1])
      return np.asarray(out, np.int32)
    return np.empty((0,), np.int32)
