"""Core layers of the RWKV6 path: layernorm, embedding, untied LM head.

Mirrors ``repro/nn/layers.py``: a layernorm computes in fp32 with the
population variance and casts back to its input dtype; parameters are cast
to the activation dtype at use.
"""

from __future__ import annotations

import torch

from repro_torch.nn import param as P


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm over the last dim, in fp32, cast back to ``x.dtype``."""
    xf = x.float()
    var, mu = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class LayerNorm(P.ParamModule):
    def __init__(self, d: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.param("scale", (d,), P.ones(), dtype)
        self.param("bias", (d,), P.zeros(), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, self.eps)


class Embedding(P.ParamModule):
    def __init__(self, vocab: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.param("table", (vocab, d_model), P.normal(0.02), dtype)

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.table.to(dtype)[tokens]


class LMHead(P.ParamModule):
    """Untied output projection ``x @ w``, w: (d_model, vocab)."""

    def __init__(self, d_model: int, vocab: int, dtype: torch.dtype):
        super().__init__()
        self.param("w", (d_model, vocab), P.fan_in(), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.to(x.dtype)
