"""Slot-addressed state pool for continuous batching (mirrors
``repro/serve/cache.py``).

The pool is one cache of batch ``n_slots`` (``init_cache``): every leaf has
the slot as its batch dim, ``index`` holds each slot's position.  The
decode step serves the pool as one batch and advances it in place; admit
copies a freshly prefilled batch-1 cache into a slot, evict copies a slot
to host memory, and readmit copies it back into ANY free slot.  Nothing in
a slot's values names the slot, which is why evict-and-readmit continues a
request exactly.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.models.model import init_cache


class SlotCachePool:
    def __init__(self, cfg, n_slots: int, cache_len: int, device="cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        # RWKV state is O(1) in sequence length; occupancy is still counted
        # against the slot's decode budget, as in the reference.
        self.slot_tokens = int(cache_len)
        self.pool = init_cache(cfg, self.n_slots, device)

    def write(self, slot: int, slot_cache: Dict[str, Any]) -> None:
        """Copy a batch-1 cache into ``slot``: a fresh prefill (admit) or a
        host snapshot from ``extract`` (readmit, into any slot)."""
        self.pool["index"][slot] = slot_cache["index"][0]
        for name, leaf in self.pool["layers"].items():
            leaf[:, slot].copy_(slot_cache["layers"][name][:, 0])

    def extract(self, slot: int) -> Dict[str, Any]:
        """Host copy of the slot as a batch-1 cache (evict)."""
        return {
            "index": self.pool["index"][slot:slot + 1].clone(),
            "layers": {name: leaf[:, slot:slot + 1].to("cpu", copy=True)
                       for name, leaf in self.pool["layers"].items()},
        }

