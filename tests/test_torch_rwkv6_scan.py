"""repro_torch's rwkv6_scan on the CPU (its plain version) against the
reference: the Pallas kernel in interpret mode and the jnp oracle.

Tolerance 1e-4 (rtol and atol): the fp32 scan rung of the reference's ladder
(``repro/conformance/tolerances.py``): a T-step decay product compounds
rounding, and the Pallas kernel regroups the bonus term."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro_torch.kernels import build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as K

TOL = dict(rtol=1e-4, atol=1e-4)
B, H, D = 2, 2, 64


def _inputs(T, decay, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, T, H, D)).astype(np.float32) for _ in range(3))
    if decay == "harsh":          # w ~ e^-8
        w = np.exp(-8.0 + rng.normal(0, 0.1, (B, T, H, D)))
    elif decay == "near1":        # w ~ 1 - 1e-3
        w = np.exp(-np.exp(rng.normal(-7.0, 0.3, (B, T, H, D))))
    else:
        w = np.exp(-np.exp(rng.normal(-0.5, 1.0, (B, T, H, D))))
    u = rng.normal(0, 0.5, (H, D)).astype(np.float32)
    s0 = rng.normal(0, 0.5, (B, H, D, D)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


def _torch(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("decay", ["normal", "harsh", "near1"])
@pytest.mark.parametrize("T", [1, 5, 37, 130])
def test_scan_matches_pallas_and_oracle(T, decay):
    xs = _inputs(T, decay)
    y, sT = K.rwkv6_scan(*_torch(xs))
    jx = [jnp.asarray(x) for x in xs]
    for name, (yr, sr) in {
            "pallas": pallas_rwkv6(*jx, interpret=True),
            "oracle": jref.rwkv6_scan(*jx)}.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), err_msg=name, **TOL)
        np.testing.assert_allclose(sT.numpy(), np.asarray(sr), err_msg=name, **TOL)


def test_scan_state_in_place_and_launch_count():
    """state_out=s0 advances the state in its own buffer; the plain version
    counts no launch."""
    xs = _torch(_inputs(5, "normal", seed=1))
    y, sT = K.rwkv6_scan(*xs)
    s = xs[5].clone()
    before = K.launches
    y2, s2 = K.rwkv6_scan(*xs[:5], s, state_out=s)
    assert s2 is s and K.launches == before
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(s, sT, rtol=0, atol=0)


def test_scan_bf16_inputs_keep_fp32_state():
    """bf16 r/k/v/w/u: y comes back bf16, the state fp32, and both equal the
    oracle run on the same bf16 values (all math is fp32 on both sides)."""
    xs = _inputs(9, "normal", seed=2)
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in xs[:5]] + [torch.from_numpy(xs[5])]
    y, sT = K.rwkv6_scan(*tx)
    assert y.dtype == torch.bfloat16 and sT.dtype == torch.float32
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs[:5]] + [jnp.asarray(xs[5])]
    yr, sr = jref.rwkv6_scan(*jx)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sr), **TOL)


def test_scan_strided_views():
    """r/k/v/w as views into one (B,T,4,H,D) buffer give the contiguous result."""
    xs = _torch(_inputs(6, "normal", seed=3))
    big = torch.stack(xs[:4], dim=2)
    y, sT = K.rwkv6_scan(*big.unbind(2), *xs[4:])
    y0, s0 = tref.rwkv6_scan(*xs)
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    torch.testing.assert_close(sT, s0, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "state_dtype", "u_shape",
                                 "u_dtype", "mismatch", "overlap", "empty"])
def test_scan_rejects_what_the_kernel_does_not_take(bad):
    r, k, v, w, u, s0 = _torch(_inputs(3, "normal"))
    kw = {}
    if bad == "head_dim":
        r, k, v, w = (x[..., :32] for x in (r, k, v, w))
        u, s0 = u[:, :32].contiguous(), s0[..., :32, :32].contiguous()
    elif bad == "dtype":
        r, k, v, w = (x.double() for x in (r, k, v, w))
    elif bad == "state_dtype":
        s0 = s0.to(torch.bfloat16)
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "u_dtype":
        u = u.to(torch.bfloat16)
    elif bad == "mismatch":
        k = k.to(torch.bfloat16)
    elif bad == "overlap":
        flat = torch.zeros(2 * s0.numel() + 64)
        s0 = flat[:s0.numel()].view_as(s0)
        kw["state_out"] = flat[64:64 + s0.numel()].view_as(s0)
    elif bad == "empty":
        r, k, v, w = (x[:, :0] for x in (r, k, v, w))
    with pytest.raises((ValueError, TypeError)):
        K.rwkv6_scan(r, k, v, w, u, s0, **kw)


def test_build_targets_sm90a_from_the_checkout():
    """The build compiles csrc/rwkv6_scan.cu for sm_90a into the ignored
    build/ directory; without nvcc it raises instead of falling back."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert (build.CSRC / "rwkv6_scan.cu").exists()
    assert build.BUILD_DIR.parent.name == "build"
    try:
        cmd = build.nvcc_command("rwkv6_scan", build.BUILD_DIR / "x.so")
    except RuntimeError as e:
        assert "nvcc" in str(e)
    else:
        assert cmd[-1].endswith("rwkv6_scan.cu")
