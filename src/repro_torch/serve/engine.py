"""Continuous-batching decode engine (mirrors ``repro/serve/engine.py``).

``DecodeEngine`` owns a ``SlotCachePool`` of ``n_slots`` per-request states
and runs two steps: the batch-1 prefill (admission: prefill, sample the
first token, copy the state into a free slot) and the pool-wide decode step
(one new token for every slot; inactive slots are parked on token 5).
Admission is prefill-prioritised: before every decode step the engine
drains arrived requests into free slots.  Each request stops on its own
``max_new_tokens`` or ``eos_id`` and frees its slot at once.

Sampling is greedy (temperature 0, argmax) or Gumbel-max at
``logits / temperature`` with noise from a generator seeded by (request
seed, absolute position): the draw depends on the request and the position
only, never on the slot or the step, so the engine and ``run_static`` (the
static-batch baseline) sample alike, across evict/readmit too.

``passes`` counts forward passes by kind (warmup, admit, decode); every pass
runs each layer's WKV scan once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import generator
from repro_torch.models.model import init_cache
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.serve.cache import SlotCachePool
from repro_torch.serve.metrics import FiniteTrace, RequestRecord, ServeMetrics
from repro_torch.serve.requests import Request
from repro_torch.serve.scheduler import FIFOScheduler, WallClock

_PAD_ID = 5          # benign token id parked in inactive slots


def sample(logits: torch.Tensor, seeds: Sequence[int], positions: Sequence[int],
           temps: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """One token per row of ``logits`` (N,V), and whether the row was all
    finite.  Row i: argmax if ``temps[i] == 0``, else the Gumbel-max draw at
    ``logits / temps[i]`` with noise seeded by (seeds[i], positions[i]).
    One device-to-host copy."""
    lf = logits.float()
    toks = lf.argmax(dim=-1)
    for i, temp in enumerate(temps):
        if temp > 0:
            gen = generator(lf.device, "sample", int(seeds[i]), int(positions[i]))
            u = torch.rand(lf.shape[-1], generator=gen, device=lf.device)
            gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
            toks[i] = torch.argmax(lf[i] / float(temp) + gumbel)
    out = torch.stack([toks, torch.isfinite(lf).all(dim=-1).long()]).cpu()
    return out[0].numpy(), out[1].numpy().astype(bool)


@dataclasses.dataclass
class EngineConfig:
    """``n_slots`` concurrent requests, ``cache_len`` positions per slot
    (>= prompt_len + max_new_tokens of any admitted request)."""

    n_slots: int = 4
    cache_len: int = 128


@dataclasses.dataclass
class _Slot:
    request: Request
    out: List[int]
    n_generated: int
    admit_s: float
    first_token_s: float
    evictions: int = 0


class _ZeroClock:
    """Clock for bare admit/decode_step calls: time stands still."""

    def now(self) -> float:
        return 0.0

    def tick(self) -> None:
        pass


def _stopped(request: Request, tok: int, n_generated: int) -> bool:
    return (n_generated >= request.max_new_tokens
            or (request.eos_id is not None and tok == request.eos_id))


def _tokens(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(array, np.int64)).to(device)


class DecodeEngine:
    def __init__(self, cfg, model, engine: Optional[EngineConfig] = None):
        self.cfg = cfg
        self.model = model
        self.engine = engine or EngineConfig()
        ec = self.engine
        self.device = model.device
        self.pool = SlotCachePool(cfg, ec.n_slots, ec.cache_len, self.device)
        self._prefill = make_prefill_step(cfg)
        self._serve = make_serve_step(cfg)
        self.slots: List[Optional[_Slot]] = [None] * ec.n_slots
        self._next = np.full((ec.n_slots, 1), _PAD_ID, np.int64)
        self._finite = np.ones(ec.n_slots, bool)
        self._seeds = np.zeros(ec.n_slots, np.int64)
        self._temps = np.zeros(ec.n_slots, np.float64)
        self.outputs: Dict[int, np.ndarray] = {}
        self.metrics = ServeMetrics(ec.n_slots, self.pool.slot_tokens)
        self.passes = {"warmup": 0, "admit": 0, "decode": 0}

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _check_capacity(self, request: Request) -> None:
        need = request.prompt_len + request.max_new_tokens
        if need > self.engine.cache_len:
            raise ValueError(
                f"request {request.rid}: prompt {request.prompt_len} + "
                f"max_new {request.max_new_tokens} exceeds cache_len "
                f"{self.engine.cache_len}")

    def admit(self, request: Request, clock=None) -> int:
        """Prefill ``request`` (batch 1) into a free slot and sample its
        first token."""
        clock = clock or _ZeroClock()
        free = self.free_slots()
        if not free:
            raise RuntimeError("admit with no free slot")
        self._check_capacity(request)
        slot = free[0]
        t_admit = clock.now()
        logits, cache1 = self._prefill(
            self.model, {"tokens": _tokens(request.tokens[None], self.device)})
        self.passes["admit"] += 1
        toks, fin = sample(logits, [request.seed], [request.prompt_len],
                           [request.temperature])
        tok = int(toks[0])
        self._finite[slot] = bool(fin[0])
        self._seeds[slot] = request.seed
        self._temps[slot] = request.temperature
        self.pool.write(slot, cache1)
        t_first = clock.now()
        self.slots[slot] = _Slot(request=request, out=[tok], n_generated=1,
                                 admit_s=t_admit, first_token_s=t_first)
        self._next[slot, 0] = tok
        if _stopped(request, tok, 1):
            self._complete(slot, t_first)
        return slot

    def decode_step(self, clock=None) -> None:
        """One decode step over the whole pool (no-op when idle)."""
        clock = clock or _ZeroClock()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        logits, _ = self._serve(self.model,
                                {"tokens": _tokens(self._next, self.device)},
                                self.pool.pool)
        self.passes["decode"] += 1
        live = np.zeros(self.engine.n_slots, bool)
        live[active] = True
        pos = [s.request.prompt_len + s.n_generated if s else 0
               for s in self.slots]
        toks, fin = sample(logits, self._seeds, pos,
                           np.where(live, self._temps, 0.0))
        self._finite &= fin | ~live
        clock.tick()
        now = clock.now()
        used = sum(min(self.slots[i].request.prompt_len
                       + self.slots[i].n_generated, self.pool.slot_tokens)
                   for i in active)
        for i in active:
            s = self.slots[i]
            tok = int(toks[i])
            s.out.append(tok)
            s.n_generated += 1
            self._next[i, 0] = tok
            if _stopped(s.request, tok, s.n_generated):
                self._complete(i, now)
        self.metrics.on_step(len(active), used)

    def _release(self, slot: int) -> None:
        self.slots[slot] = None
        self._next[slot, 0] = _PAD_ID
        self._finite[slot] = True

    def _complete(self, slot: int, now: float) -> None:
        s = self.slots[slot]
        if not self._finite[slot]:
            raise FloatingPointError(
                f"request {s.request.rid}: non-finite logits during decode "
                f"(caught at completion; slot {slot})")
        self.outputs[s.request.rid] = np.asarray(s.out, np.int32)
        self.metrics.finish(RequestRecord(
            rid=s.request.rid, arrival_s=s.request.arrival_s,
            admit_s=s.admit_s, first_token_s=s.first_token_s, finish_s=now,
            prompt_len=s.request.prompt_len, n_generated=s.n_generated,
            evictions=s.evictions))
        self._release(slot)

    def evict(self, slot: int) -> Dict[str, Any]:
        """Preempt a live request: a host snapshot of all it needs to
        resume exactly."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is empty")
        snap = {
            "cache": self.pool.extract(slot),
            "request": s.request,
            "out": list(s.out),
            "n_generated": s.n_generated,
            "next_token": int(self._next[slot, 0]),
            "finite": bool(self._finite[slot]),
            "admit_s": s.admit_s,
            "first_token_s": s.first_token_s,
            "evictions": s.evictions + 1,
        }
        self._release(slot)
        return snap

    def readmit(self, snap: Dict[str, Any]) -> int:
        """Resume an evicted request in any free slot."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("readmit with no free slot")
        slot = free[0]
        self.pool.write(slot, snap["cache"])
        req = snap["request"]
        self.slots[slot] = _Slot(
            request=req, out=list(snap["out"]), n_generated=snap["n_generated"],
            admit_s=snap["admit_s"], first_token_s=snap["first_token_s"],
            evictions=snap["evictions"])
        self._next[slot, 0] = snap["next_token"]
        self._finite[slot] = snap["finite"]
        self._seeds[slot] = req.seed
        self._temps[slot] = req.temperature
        return slot

    def warmup(self, prompt_lens) -> None:
        """One prefill per distinct prompt length and one decode step on a
        scratch pool, before the clock starts (first-call costs such as
        library handles and lazy module loads stay off the metrics).  The
        engine's state is untouched."""
        rng = np.random.default_rng(0)
        for L in sorted(set(int(x) for x in prompt_lens)):
            toks = rng.integers(5, self.cfg.vocab_size, (1, L))
            logits, _ = self._prefill(self.model,
                                      {"tokens": _tokens(toks, self.device)})
            self.passes["warmup"] += 1
            sample(logits, [0], [L], [0.0])
        scratch = init_cache(self.cfg, self.engine.n_slots, self.device)
        logits, _ = self._serve(self.model,
                                {"tokens": _tokens(self._next, self.device)},
                                scratch)
        self.passes["warmup"] += 1
        sample(logits, self._seeds, [0] * len(self._seeds), self._temps)

    def run(self, requests: List[Request], *, clock=None
            ) -> Tuple[Dict[int, np.ndarray], Dict[str, Any]]:
        """Serve ``requests`` to completion under their arrival times.
        -> ({rid: generated token ids}, metrics summary)."""
        clock = clock if clock is not None else WallClock()
        sched = FIFOScheduler(requests)
        self.warmup([r.prompt_len for r in requests])
        clock.start()
        while sched.waiting or self.n_active():
            now = clock.now()
            while self.free_slots():
                r = sched.next_ready(now)
                if r is None:
                    break
                self.admit(r, clock)
                now = clock.now()
            if not self.n_active():
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                clock.advance_to(nxt)
                continue
            self.decode_step(clock)
        return dict(self.outputs), self.metrics.summary()


def run_static(cfg, model, requests: List[Request], *, n_slots: int,
               cache_len: int, clock=None
               ) -> Tuple[Dict[int, np.ndarray], Dict[str, Any]]:
    """The static-batch baseline: requests in arrival order, in batches of
    ``n_slots`` through the batched prefill and serve steps.  A batch starts
    once its last member has arrived and the previous batch finished, and
    decodes until its longest request stops (finished rows ride along,
    their outputs truncated)."""
    clock = clock if clock is not None else WallClock()
    device = model.device
    metrics = ServeMetrics(n_slots, cache_len)
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    order = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    groups = [order[i:i + n_slots] for i in range(0, len(order), n_slots)]
    for r in order:
        if r.prompt_len + r.max_new_tokens > cache_len:
            raise ValueError(f"request {r.rid} exceeds cache_len {cache_len}")
    rng = np.random.default_rng(0)
    for G in sorted(set(len(g) for g in groups)):       # warmup, results dropped
        toks = rng.integers(5, cfg.vocab_size, (G, groups[0][0].prompt_len))
        logits, cache = prefill(model, {"tokens": _tokens(toks, device)})
        logits, _ = serve(model, {"tokens": _tokens(
            np.full((G, 1), _PAD_ID), device)}, cache)
        sample(logits, [0] * G, [0] * G, [0.0] * G)

    outputs: Dict[int, np.ndarray] = {}
    ftrace = FiniteTrace()
    clock.start()
    for g in groups:
        clock.advance_to(max(r.arrival_s for r in g))
        t_admit = clock.now()
        G = len(g)
        seeds = [r.seed for r in g]
        temps = [r.temperature for r in g]
        n_gen = np.zeros(G, np.int64)
        prompt = np.stack([r.tokens for r in g])
        logits, cache = prefill(model, {"tokens": _tokens(prompt, device)})
        ftrace.update(logits)
        toks, _ = sample(logits, seeds, [r.prompt_len for r in g], temps)
        t_first = clock.now()
        outs = [[int(t)] for t in toks]
        n_gen += 1
        done = np.array([_stopped(r, int(t), 1) for r, t in zip(g, toks)])
        recs = [RequestRecord(
            rid=r.rid, arrival_s=r.arrival_s, admit_s=t_admit,
            first_token_s=t_first, finish_s=t_first, prompt_len=r.prompt_len,
            n_generated=1) for r in g]
        cur = toks.reshape(G, 1).astype(np.int64)
        while not done.all():
            logits, cache = serve(model, {"tokens": _tokens(cur, device)}, cache)
            ftrace.update(logits)
            pos = [r.prompt_len + int(n) for r, n in zip(g, n_gen)]
            toks, _ = sample(logits, seeds, pos, temps)
            clock.tick()
            now = clock.now()
            n_active = int((~done).sum())
            used = sum(min(g[i].prompt_len + int(n_gen[i]), cache_len)
                       for i in range(G) if not done[i])
            for i in range(G):
                if done[i]:
                    continue
                tok = int(toks[i])
                outs[i].append(tok)
                n_gen[i] += 1
                cur[i, 0] = tok
                if _stopped(g[i], tok, int(n_gen[i])):
                    done[i] = True
                    recs[i].finish_s = now
                    recs[i].n_generated = int(n_gen[i])
            metrics.on_step(n_active, used)
        for i, r in enumerate(g):
            outputs[r.rid] = np.asarray(outs[i], np.int32)
            metrics.finish(recs[i])
    ftrace.assert_finite("static decode")
    return outputs, metrics.summary()
