"""``rwkv6_scan``: the WKV6 recurrence, a CUDA kernel on the card and the
plain PyTorch version (``kernels/ref.py``) on the CPU.

The kernel is ``csrc/rwkv6_scan.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/rwkv6_scan.py::rwkv6_scan``).  The wrapper picks the route
from where the tensors lie and from nothing else: CPU tensors run the plain
version, CUDA tensors launch the kernel or raise.

``launches`` counts kernel launches, one per call on the card; the plain
version does not count.  Reset it to 0 before a run to read that run's count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

D = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("rwkv6_scan")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rwkv6_scan_fwd.argtypes = [vp] * 8 + [i32] * 3 + [i64] * 3 + [i32, vp]
        lib.rwkv6_scan_fwd.restype = ctypes.c_int
        lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _span(t: torch.Tensor):
    lo = t.data_ptr()
    return lo, lo + t.numel() * t.element_size()


def _check(r, k, v, w, u, s0, state_out):
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be (B,T,H,D), got {tuple(r.shape)}")
    B, T, H, d = r.shape
    if d != D:
        raise ValueError(f"rwkv6_scan: head dim must be {D}, got {d}")
    if T < 1:
        raise ValueError("rwkv6_scan: empty sequence")
    if r.dtype not in _DTYPES or u.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan: r/k/v/w and u must all be float32 or "
                        f"all bfloat16, got {r.dtype} and {u.dtype}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape or x.dtype != r.dtype or x.stride() != r.stride():
            raise ValueError(f"rwkv6_scan: {name} must match r in shape, dtype "
                             f"and strides; got {tuple(x.shape)} {x.dtype} "
                             f"{x.stride()} vs {tuple(r.shape)} {r.dtype} "
                             f"{r.stride()}")
    if r.stride(-1) != 1:
        raise ValueError("rwkv6_scan: r/k/v/w need a unit stride on the head dim")
    if tuple(u.shape) != (H, D) or not u.is_contiguous():
        raise ValueError(f"rwkv6_scan: u must be contiguous ({H},{D}), got "
                         f"{tuple(u.shape)}")
    states = [("s0", s0)] + ([("state_out", state_out)] if state_out is not None else [])
    for name, s in states:
        if (tuple(s.shape) != (B, H, D, D) or s.dtype != torch.float32
                or not s.is_contiguous()):
            raise ValueError(f"rwkv6_scan: {name} must be contiguous float32 "
                             f"({B},{H},{D},{D}), got {tuple(s.shape)} {s.dtype}")
    devs = {x.device for x in (r, k, v, w, u, s0)}
    if state_out is not None:
        devs.add(state_out.device)
    if len(devs) != 1:
        raise ValueError(f"rwkv6_scan: inputs on several devices {devs}")
    if state_out is not None and state_out.data_ptr() != s0.data_ptr():
        (a0, a1), (b0, b1) = _span(s0), _span(state_out)
        if a0 < b1 and b0 < a1:
            raise ValueError("rwkv6_scan: state_out must be s0 itself or "
                             "not overlap it")


def rwkv6_scan(r, k, v, w, u, s0, *, state_out=None):
    """r,k,v,w: (B,T,H,64); u: (H,64) in r's dtype; s0: (B,H,64,64) fp32.
    -> (y (B,T,H,64) in r's dtype, s_T (B,H,64,64) fp32).

    ``state_out``, if given, receives s_T and is returned; it may be ``s0``
    itself (the state then advances in place)."""
    global launches
    _check(r, k, v, w, u, s0, state_out)
    if r.device.type == "cpu":
        y, sT = ref.rwkv6_scan(r, k, v, w, u, s0)
        if state_out is not None:
            sT = state_out.copy_(sT)
        return y, sT
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: no route for device {r.device}")

    B, T, H, _ = r.shape
    y = torch.empty((B, T, H, D), dtype=r.dtype, device=r.device)
    sT = state_out if state_out is not None else torch.empty_like(s0)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            B, T, H, r.stride(0), r.stride(1), r.stride(2),
            _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error {err} "
                           f"({lib.rwkv6_scan_error_string(err).decode()})")
    launches += 1
    return y, sT
