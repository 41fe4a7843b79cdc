"""The RWKV6 block (mirrors ``repro/models/blocks.py::apply_rwkv_block``).

A layer's cache is ``{tm_x (B,d), cm_x (B,d), wkv (B,H,hd,hd) fp32}``.  The
token-shift carries ``tm_x``/``cm_x`` hold the last position of the NORMED
inputs of the two mixes, not of the residual stream.  The block advances its
cache in place.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.nn.layers import LayerNorm
from repro_torch.nn.rwkv import ChannelMix, TimeMix, rwkv_heads


class RWKVBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, dt = cfg.d_model, cfg.pdtype
        self.ln1 = LayerNorm(d, dt, cfg.norm_eps)
        self.tm = TimeMix(d, rwkv_heads(d, cfg.ssm_heads), dt)
        self.ln2 = LayerNorm(d, dt, cfg.norm_eps)
        self.cm = ChannelMix(d, cfg.d_ff, dt)

    def forward(self, x: torch.Tensor, lc: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = self.ln1(x)
        a = self.tm(h, lc["tm_x"].to(x.dtype), lc["wkv"])
        lc["tm_x"].copy_(h[:, -1, :])
        x = x + a
        h = self.ln2(x)
        m = self.cm(h, lc["cm_x"].to(x.dtype))
        lc["cm_x"].copy_(h[:, -1, :])
        return x + m
