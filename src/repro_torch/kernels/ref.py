"""Plain PyTorch versions of the port's kernels.

These are what the CPU runs and what each kernel is held against on the
card: slow, sequential, obviously right.  They mirror ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch


def rwkv6_scan(r, k, v, w, u, s0):
    """RWKV6 "Finch" WKV recurrence, sequential over T, all math in fp32.

    r,k,v,w: (B,T,H,D); u: (H,D) bonus; s0: (B,H,D,D) initial state (layout
    [key_dim, value_dim]).

      y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
      S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]

    Returns (y (B,T,H,D) in r's dtype, s_T (B,H,D,D) fp32).  ``s0`` is read,
    never written.
    """
    dtype = r.dtype
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]      # (B,H,D)
        kv = kt[..., :, None] * vt[..., None, :]                  # (B,H,D,D)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, s + u[..., :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1).to(dtype), s
