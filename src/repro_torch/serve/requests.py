"""Serving requests and the one throughput definition (mirrors
``repro/serve/requests.py`` for the token-only architectures the port runs).

A ``Request`` is a prompt, a stop condition (``max_new_tokens``, optional
``eos_id``), a sampling policy (``temperature``, 0 = greedy, and a per-request
``seed``) and an open-loop ``arrival_s``.  ``synthetic_requests`` draws from a
numpy generator exactly as the reference does, so the same seed gives the
same requests on both sides.  Throughput counts every generated token, the
one sampled from the prefill logits included.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    arrival_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def replace(self, **kw) -> "Request":
        return dataclasses.replace(self, **kw)


def synthetic_requests(cfg, n: int, prompt_len: int, rng: np.random.Generator,
                       *, max_new_tokens: int = 16, min_new_tokens: int = 0,
                       eos_id: Optional[int] = None, temperature: float = 0.0,
                       seed: int = 0) -> List[Request]:
    """n seeded requests of ``prompt_len`` tokens (ids from 5, clear of
    special ids); per-request ``max_new_tokens`` uniform in
    [min_new_tokens or max, max_new_tokens]."""
    reqs = []
    for i in range(n):
        toks = rng.integers(5, cfg.vocab_size, (prompt_len,)).astype(np.int32)
        lo = min_new_tokens or max_new_tokens
        mx = int(rng.integers(lo, max_new_tokens + 1))
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=mx,
                            eos_id=eos_id, temperature=temperature,
                            seed=seed + i))
    return reqs


def tokens_per_s(n_tokens: int, seconds: float) -> float:
    """Throughput over the interval that produced ``n_tokens`` (prefill
    included: the prefill-produced token is in the numerator)."""
    return n_tokens / max(seconds, 1e-9)
