"""Open-loop Poisson traffic, FIFO admission and the serving clocks
(mirrors ``repro/serve/scheduler.py``).

``PoissonArrivals`` stamps requests with seeded exponential inter-arrivals;
the same seed gives the reference's arrival times.  ``WallClock`` is real
time (``advance_to`` sleeps until the next arrival); ``VirtualClock``
advances only when told, which makes engine runs exactly reproducible.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.serve.requests import Request


class PoissonArrivals:
    def __init__(self, rate_rps: float, seed: int = 0):
        if rate_rps < 0:
            raise ValueError(f"rate_rps must be >= 0, got {rate_rps}")
        self.rate_rps = float(rate_rps)
        self.seed = int(seed)

    def times(self, n: int) -> np.ndarray:
        if self.rate_rps == 0:
            return np.zeros(n)
        rng = np.random.default_rng(self.seed)
        return np.cumsum(rng.exponential(1.0 / self.rate_rps, size=n))

    def assign(self, requests: List[Request]) -> List[Request]:
        ts = self.times(len(requests))
        return [r.replace(arrival_s=float(t)) for r, t in zip(requests, ts)]


class FIFOScheduler:
    """Arrived requests in arrival order; the engine drains them into free
    slots before every decode step."""

    def __init__(self, requests: List[Request]):
        self._pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        self._ready: deque = deque()

    def next_ready(self, now: float) -> Optional[Request]:
        while self._pending and self._pending[0].arrival_s <= now:
            self._ready.append(self._pending.popleft())
        return self._ready.popleft() if self._ready else None

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival_s if self._pending else None

    @property
    def waiting(self) -> int:
        return len(self._pending) + len(self._ready)


class WallClock:
    def __init__(self):
        self._t0 = time.perf_counter()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance_to(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)

    def tick(self) -> None:
        pass


class VirtualClock:
    """``tick()`` (one decode step) advances ``step_s``; ``advance_to``
    jumps."""

    def __init__(self, step_s: float = 1.0):
        self.step_s = float(step_s)
        self._now = 0.0

    def start(self) -> None:
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        self._now = max(self._now, t)

    def tick(self) -> None:
        self._now += self.step_s
