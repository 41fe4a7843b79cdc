"""RWKV6 "Finch" time mixing and channel mixing (mirrors ``repro/nn/rwkv.py``).

Token shift with data-dependent low-rank interpolation (ddlerp) over the five
mix targets (w,k,v,r,g), low-rank data-dependent decay
``w = exp(-exp(w0 + tanh(x_w A1) A2))``, the WKV recurrence with bonus ``u``
through :mod:`repro_torch.kernels.rwkv6_scan`, per-head GroupNorm, and the
squared-ReLU channel mix.

Two roundings of the reference are kept on purpose: the decay is computed in
fp32 and cast to the compute dtype before the scan, and ``u`` reaches the
scan uncast (the kernel reads it as fp32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.nn import param as P

LORA = 32          # ddlerp low-rank dim
LORA_W = 64        # decay low-rank dim
HEAD_DIM = 64      # rwkv6 head size


def rwkv_heads(d_model: int, ssm_heads: int = 0) -> int:
    return ssm_heads or max(1, d_model // HEAD_DIM)


def shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Token shift: x_prev[t] = x[t-1]; position 0 takes ``last`` (the
    decode carry-in, zeros at sequence start).  x: (B,T,d); last: (B,d)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               n_heads: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm (RWKV's GroupNorm with groups = heads), in fp32."""
    B, T, d = y.shape
    yh = y.reshape(B, T, n_heads, d // n_heads).float()
    var, mu = torch.var_mean(yh, dim=-1, keepdim=True, correction=0)
    yh = ((yh - mu) * torch.rsqrt(var + eps)).reshape(B, T, d)
    return (yh * scale.float() + bias.float()).to(y.dtype)


class GroupNorm(P.ParamModule):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.param("scale", (d,), P.ones(), dtype)
        self.param("bias", (d,), P.zeros(), dtype)


class TimeMix(P.ParamModule):
    def __init__(self, d: int, n_heads: int, dtype: torch.dtype):
        super().__init__()
        self.n_heads = n_heads
        hd = d // n_heads
        lw, la = min(LORA_W, d), min(LORA, d)
        self.param("mu_x", (d,), P.uniform(0.5), dtype)
        self.param("mu_5", (5, d), P.uniform(0.5), dtype)
        self.param("ddlerp_a", (d, 5, la), P.normal(0.01), dtype)
        self.param("ddlerp_b", (5, la, d), P.normal(0.01), dtype)
        self.param("w0", (d,), P.normal(0.5), dtype)
        self.param("w_a", (d, lw), P.normal(0.01), dtype)
        self.param("w_b", (lw, d), P.normal(0.01), dtype)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            self.param(name, (d, d), P.fan_in(), dtype)
        self.param("u", (n_heads, hd), P.normal(0.5), dtype)
        self.ln_x = GroupNorm(d, dtype)

    def forward(self, x, last_x, state):
        """x: (B,T,d) normed input; last_x: (B,d); state: (B,H,hd,hd) fp32,
        advanced IN PLACE by the scan.  Returns the mix output (B,T,d)."""
        B, T, d = x.shape
        H = self.n_heads
        dt = x.dtype

        dx = shift(x, last_x) - x
        xxx = x + dx * self.mu_x.to(dt)
        a = torch.tanh(torch.einsum("btd,dfa->btfa", xxx, self.ddlerp_a.to(dt)))
        deltas = torch.einsum("btfa,fad->btfd", a, self.ddlerp_b.to(dt))
        mixed = x[:, :, None, :] + dx[:, :, None, :] * (self.mu_5.to(dt) + deltas)
        x_w, x_k, x_v, x_r, x_g = mixed.unbind(2)

        r = x_r @ self.wr.to(dt)
        k = x_k @ self.wk.to(dt)
        v = x_v @ self.wv.to(dt)
        g = x_g @ self.wg.to(dt)
        wlog = self.w0.float() + (x_w.float() @ self.w_a.float()) @ self.w_b.float()
        w = torch.exp(-torch.exp(wlog))

        def heads(z):
            return z.reshape(B, T, H, d // H)

        y, _ = rwkv6_scan(heads(r), heads(k), heads(v), heads(w.to(dt)),
                          self.u, state, state_out=state)
        y = group_norm(y.reshape(B, T, d), self.ln_x.scale, self.ln_x.bias, H)
        return (y * F.silu(g)) @ self.wo.to(dt)


class ChannelMix(P.ParamModule):
    def __init__(self, d: int, d_ff: int, dtype: torch.dtype):
        super().__init__()
        self.param("mu_k", (d,), P.uniform(0.5), dtype)
        self.param("mu_r", (d,), P.uniform(0.5), dtype)
        self.param("wk", (d, d_ff), P.fan_in(), dtype)
        self.param("wr", (d, d), P.fan_in(), dtype)
        self.param("wv", (d_ff, d), P.fan_in(), dtype)

    def forward(self, x, last_x):
        """x: (B,T,d) normed input; last_x: (B,d)."""
        dt = x.dtype
        dx = shift(x, last_x) - x
        x_k = x + dx * self.mu_k.to(dt)
        x_r = x + dx * self.mu_r.to(dt)
        k = torch.square(torch.relu(x_k @ self.wk.to(dt)))
        return torch.sigmoid(x_r @ self.wr.to(dt)) * (k @ self.wv.to(dt))
