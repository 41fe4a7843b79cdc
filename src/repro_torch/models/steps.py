"""Serve step factories (mirror ``repro/models/steps.py``).

The reference vmaps its batch=1 serve step over the slots of a pool; here
the pool is simply a cache whose batch dim is the slot dim, so
``make_serve_step`` serves a pool as it serves any batch.  Both steps
advance the cache in place.
"""

from __future__ import annotations

from repro_torch.models.model import apply_model, init_cache


def make_prefill_step(cfg):
    """-> prefill_step(model, batch) -> (last-token logits (B,V), filled
    cache).  The LM head runs on the last position only."""
    def prefill_step(model, batch):
        cache = init_cache(cfg, batch["tokens"].shape[0], device=model.device)
        logits, cache = apply_model(model, batch, mode="prefill", cache=cache,
                                    last_only=True)
        return logits[:, -1, :], cache
    return prefill_step


def make_serve_step(cfg):
    """-> serve_step(model, batch{tokens (B,1)}, cache) -> (logits (B,V),
    cache): one new token per row against the cache."""
    def serve_step(model, batch, cache):
        logits, cache = apply_model(model, batch, mode="decode", cache=cache)
        return logits[:, -1, :], cache
    return serve_step
