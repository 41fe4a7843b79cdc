"""Serving metrics: per-request records, per-step occupancy, the
``BENCH_serve.json`` schema and the accumulated finiteness trace.

The quantile rule is the reference's (``repro/obs/metrics.py``): exact
linear interpolation between closest ranks, in pure Python, so p50/p99
cannot drift with numpy's defaults.  The port keeps its own copy.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.serve.requests import tokens_per_s

# The keys the serve benchmark schema holds to (the reference's).
BENCH_MODE_KEYS = ("n_requests", "generated_tokens", "wall_s",
                   "n_decode_steps", "tokens_per_s", "ttft_s", "latency_s",
                   "slot_occupancy", "cache_occupancy")


def quantile(xs: Iterable[float], q: float) -> float:
    """Exact q-quantile: ``h = (n-1) q`` over the sorted values, linear
    between ``s[floor(h)]`` and ``s[ceil(h)]``.  Empty input -> 0.0."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q {q} not in [0, 1]")
    s = sorted(float(x) for x in xs)
    if not s:
        return 0.0
    h = (len(s) - 1) * q
    lo, hi = math.floor(h), math.ceil(h)
    if lo == hi:
        return s[lo]
    return s[lo] + (s[hi] - s[lo]) * (h - lo)


def summary_stats(xs: Iterable[float]) -> Dict[str, float]:
    """mean / p50 / p99."""
    vals = [float(x) for x in xs]
    if not vals:
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0}
    return {"mean": math.fsum(vals) / len(vals),
            "p50": quantile(vals, 0.50),
            "p99": quantile(vals, 0.99)}


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps (seconds on the run's clock) of one request."""

    rid: int
    arrival_s: float
    admit_s: float
    first_token_s: float
    finish_s: float
    prompt_len: int
    n_generated: int
    evictions: int = 0

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


class ServeMetrics:
    def __init__(self, n_slots: int, slot_tokens: int):
        self.n_slots = int(n_slots)
        self.slot_tokens = int(slot_tokens)
        self.records: List[RequestRecord] = []
        self.n_decode_steps = 0
        self._slot_occ: List[float] = []
        self._cache_occ: List[float] = []

    def on_step(self, n_active: int, cache_tokens_used: int) -> None:
        """One decode step: ``n_active`` slots held live requests, whose
        positions consumed come to ``cache_tokens_used``."""
        self.n_decode_steps += 1
        self._slot_occ.append(n_active / max(self.n_slots, 1))
        self._cache_occ.append(cache_tokens_used
                               / (self.n_slots * max(self.slot_tokens, 1)))

    def finish(self, record: RequestRecord) -> None:
        self.records.append(record)

    def summary(self) -> Dict[str, Any]:
        recs = sorted(self.records, key=lambda r: r.rid)
        total = sum(r.n_generated for r in recs)
        span = (max(r.finish_s for r in recs) - min(r.arrival_s for r in recs)
                if recs else 0.0)
        return {
            "n_requests": len(recs),
            "generated_tokens": total,
            "wall_s": span,
            "n_decode_steps": self.n_decode_steps,
            "tokens_per_s": tokens_per_s(total, span),
            "ttft_s": summary_stats(r.ttft_s for r in recs),
            "latency_s": summary_stats(r.latency_s for r in recs),
            "slot_occupancy": summary_stats(self._slot_occ)["mean"],
            "cache_occupancy": summary_stats(self._cache_occ)["mean"],
        }


def write_bench(path: str, payload: Dict[str, Any]) -> str:
    """Write a BENCH_*.json payload (sorted keys, trailing newline)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


class FiniteTrace:
    """One device-side all-finite flag per step, read once at the end: a
    non-finite step is named where it happened."""

    def __init__(self):
        self._flags: List[torch.Tensor] = []

    def update(self, logits: torch.Tensor) -> None:
        self._flags.append(torch.isfinite(logits).all())

    def first_failure(self) -> Optional[int]:
        if not self._flags:
            return None
        bad = torch.nonzero(~torch.stack(self._flags).cpu()).flatten()
        return int(bad[0]) if bad.numel() else None

    def assert_finite(self, what: str = "decode") -> None:
        bad = self.first_failure()
        if bad is not None:
            raise FloatingPointError(
                f"non-finite logits first appeared at {what} step {bad} "
                f"of {len(self._flags)}")
