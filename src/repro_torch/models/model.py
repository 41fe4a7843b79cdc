"""Model assembly for the port's architectures: today the RWKV6 (``ssm``)
stack of ``repro/models/model.py``.

    model = init_model(cfg, seed=0, device="cuda")
    cache = init_cache(cfg, batch, device="cuda")
    logits, cache = apply_model(model, batch, mode="prefill", cache=cache)

The layers are an ``nn.ModuleList``; the cache keeps the reference's
stacked layout (a leading layer dim on every leaf) plus a per-row
``index`` on the host.  ``apply_model`` advances the cache IN PLACE and
returns it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.blocks import RWKVBlock
from repro_torch.nn import param as P
from repro_torch.nn.layers import Embedding, LayerNorm, LMHead
from repro_torch.nn.rwkv import rwkv_heads


class RWKV6LM(nn.Module):
    """Embedding -> ln_in -> RWKV6 blocks -> final_norm -> untied LM head.
    Constructed, every parameter is declared on ``meta``; ``init_model``
    or ``bridge.from_reference`` fills them."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.arch_type != "ssm" or cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: the port runs untied RWKV6 (ssm) "
                             f"models only, got arch_type={cfg.arch_type!r}, "
                             f"tie_embeddings={cfg.tie_embeddings}")
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.pdtype
        self.embed = Embedding(cfg.vocab_size, d, dt)
        self.ln_in = LayerNorm(d, dt, cfg.norm_eps)
        self.layers = nn.ModuleList(RWKVBlock(cfg) for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(d, dt, cfg.norm_eps)
        self.lm_head = LMHead(d, cfg.vocab_size, dt)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_model(cfg, seed: int = 0, device="cuda") -> RWKV6LM:
    """Parameters drawn from per-name generators seeded by ``seed``."""
    dev = resolve_device(device)
    return P.materialize(RWKV6LM(cfg), seed, dev).eval()


def init_cache(cfg, batch: int, device="cuda") -> Dict[str, Any]:
    """Zero cache for ``batch`` rows: {index (batch,) int64 on the host,
    layers: {tm_x (L,batch,d), cm_x (L,batch,d) in the compute dtype,
    wkv (L,batch,H,hd,hd) fp32}}."""
    dev = resolve_device(device)
    dt = cfg.cdtype
    L, d = cfg.n_layers, cfg.d_model
    H = rwkv_heads(d, cfg.ssm_heads)
    hd = d // H
    return {
        "index": torch.zeros(batch, dtype=torch.int64),
        "layers": {
            "tm_x": torch.zeros((L, batch, d), dtype=dt, device=dev),
            "cm_x": torch.zeros((L, batch, d), dtype=dt, device=dev),
            "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                               device=dev),
        },
    }


@torch.no_grad()
def apply_model(model: RWKV6LM, batch: Dict[str, torch.Tensor], *, mode: str,
                cache: Dict[str, Any], last_only: bool = False):
    """batch: {"tokens": (B,S) int}.  mode: "prefill" (fills a fresh cache)
    or "decode" (S == 1 against the cache).  Returns (logits (B,S,V), or
    (B,1,V) with ``last_only``; the same cache, advanced in place)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if mode == "decode" and S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    cfg = model.cfg
    x = model.embed(tokens, cfg.cdtype)
    x = model.ln_in(x)
    layers = cache["layers"]
    for i, block in enumerate(model.layers):
        x = block(x, {name: leaf[i] for name, leaf in layers.items()})
    if last_only:
        x = x[:, -1:, :]
    logits = model.lm_head(model.final_norm(x))
    cache["index"] += S
    return logits, cache
