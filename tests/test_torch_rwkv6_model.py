"""repro_torch's RWKV6 model against the reference at the reduced
rwkv6-1.6b config in fp32, with the reference's own parameters bridged in.

Tolerance 1e-4 (rtol and atol), the fp32 scan rung of the reference's
ladder: each layer runs the WKV recurrence, whose decay products compound
rounding, and both sides sum their matmuls in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import get_config as ref_config
from repro.models.model import init_model as ref_init
from repro.models.steps import make_prefill_step as ref_prefill
from repro.models.steps import make_serve_step as ref_serve
from repro.nn import layers as ref_layers
from repro.nn import param as ref_P
from repro.nn import rwkv as ref_rwkv
from repro_torch.bridge import from_reference, to_reference
from repro_torch.configs import get_config
from repro_torch.models.model import RWKV6LM, init_model
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.nn import layers, rwkv

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_config("rwkv6-1.6b").reduced()
    return cfg, ref_P.unbox(ref_init(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def bridged(ref_params):
    rcfg, params = ref_params
    cfg = get_config("rwkv6-1.6b").reduced()
    return cfg, from_reference(_flatten(params), cfg, device="cpu")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what, **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference(ref_params, bridged, impl):
    """Prefill (B=2, 8 tokens): last-token logits and every cache leaf; then
    4 decode steps' logits and the final cache."""
    rcfg, params = ref_params
    cfg, model = bridged
    rng = np.random.default_rng(11)
    toks = rng.integers(5, cfg.vocab_size, (2, 12)).astype(np.int32)
    rpre = jax.jit(ref_prefill(rcfg, 16, impl=impl))
    rsrv = jax.jit(ref_serve(rcfg, impl=impl))
    pre, srv = make_prefill_step(cfg), make_serve_step(cfg)

    lr, cr = rpre(params, {"tokens": jnp.asarray(toks[:, :8])})
    lp, cp = pre(model, {"tokens": torch.from_numpy(toks[:, :8])})
    _close(lp, lr, "prefill logits")
    for k in ("tm_x", "cm_x", "wkv"):
        _close(cp["layers"][k], cr["layers"][k], f"prefill cache {k}")
    assert cp["index"].tolist() == [8, 8] and int(cr["index"]) == 8
    for t in range(8, 12):
        lr, cr = rsrv(params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, cr)
        lp, cp = srv(model, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, cp)
        _close(lp, lr, f"decode logits t={t}")
    for k in ("tm_x", "cm_x", "wkv"):
        _close(cp["layers"][k], cr["layers"][k], f"decode cache {k}")


def test_time_mix_matches_reference(ref_params, bridged):
    """Layer 0's time mix alone, with nonzero carry-in and state."""
    rcfg, params = ref_params
    cfg, model = bridged
    rng = np.random.default_rng(1)
    d, H = cfg.d_model, rwkv.rwkv_heads(cfg.d_model, cfg.ssm_heads)
    x = rng.normal(0, 1, (2, 5, d)).astype(np.float32)
    last = rng.normal(0, 1, (2, d)).astype(np.float32)
    state = rng.normal(0, 0.3, (2, H, d // H, d // H)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], params["layers"]["tm"])
    out_r, last_r, state_r = ref_rwkv.apply_rwkv_time_mix(
        p0, jnp.asarray(x), H, last_x=jnp.asarray(last), state=jnp.asarray(state))
    s = torch.from_numpy(state.copy())
    out_p = model.layers[0].tm(torch.from_numpy(x), torch.from_numpy(last), s)
    _close(out_p, out_r, "time mix out")
    _close(s, state_r, "time mix state")
    _close(x[:, -1], last_r, "time mix carry")


def test_channel_mix_and_norms_match_reference(ref_params, bridged):
    rcfg, params = ref_params
    cfg, model = bridged
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    last = rng.normal(0, 1, (2, cfg.d_model)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], params["layers"])
    out_r, _ = ref_rwkv.apply_rwkv_channel_mix(p0["cm"], jnp.asarray(x),
                                               last_x=jnp.asarray(last))
    out_p = model.layers[0].cm(torch.from_numpy(x), torch.from_numpy(last))
    _close(out_p, out_r, "channel mix")
    ln_r = ref_layers.apply_layernorm(p0["ln1"], jnp.asarray(x), cfg.norm_eps)
    ln1 = model.layers[0].ln1
    _close(layers.layernorm(torch.from_numpy(x), ln1.scale, ln1.bias, cfg.norm_eps),
           ln_r, "layernorm")
    H = rwkv.rwkv_heads(cfg.d_model, cfg.ssm_heads)
    gn_r = ref_rwkv._group_norm(p0["tm"]["ln_x"], jnp.asarray(x), H)
    ln_x = model.layers[0].tm.ln_x
    _close(rwkv.group_norm(torch.from_numpy(x), ln_x.scale, ln_x.bias, H),
           gn_r, "group norm")


def test_bridge_round_trip_is_exact(ref_params):
    _, params = ref_params
    flat = _flatten(params)
    back = to_reference(from_reference(flat, get_config("rwkv6-1.6b").reduced(),
                                       device="cpu"))
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype and back[k].shape == flat[k].shape
        np.testing.assert_array_equal(back[k], flat[k])


def test_bridge_bf16_round_trip_is_exact():
    """bf16 leaves travel as ``::bf16`` uint16 views, bit for bit."""
    cfg = get_config("rwkv6-1.6b").reduced().replace(param_dtype="bfloat16",
                                                     compute_dtype="bfloat16")
    flat = to_reference(init_model(cfg, seed=4, device="cpu"))
    assert all(k.endswith("::bf16") and v.dtype == np.uint16 for k, v in flat.items())
    back = to_reference(from_reference(flat, cfg, device="cpu"))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_bridge_rejects_missing_and_extra_keys(ref_params):
    _, params = ref_params
    flat = _flatten(params)
    cfg = get_config("rwkv6-1.6b").reduced()
    with pytest.raises(KeyError):
        from_reference({k: v for k, v in flat.items() if k != "lm_head|w"}, cfg,
                       device="cpu")
    with pytest.raises(KeyError):
        from_reference({**flat, "layers|tm|extra": flat["layers|tm|w0"]}, cfg,
                       device="cpu")


def test_init_matches_reference_layout_and_distributions(ref_params):
    """Same keys, shapes and dtypes as the reference's init; each leaf drawn
    from the reference's distribution (not its bits)."""
    _, params = ref_params
    flat = _flatten(params)
    cfg = get_config("rwkv6-1.6b").reduced()
    mine = to_reference(init_model(cfg, seed=0, device="cpu"))
    assert set(mine) == set(flat)
    for k, want in flat.items():
        got = mine[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert abs(got.std() / want.std() - 1) < 0.15, k
            assert abs(got.mean() - want.mean()) < 0.2 * want.std() + 1e-3, k
            assert abs(np.abs(got).max() / np.abs(want).max() - 1) < 0.5, k
    # a seed draws anew; the same seed draws the same
    again = to_reference(init_model(cfg, seed=0, device="cpu"))
    other = to_reference(init_model(cfg, seed=1, device="cpu"))
    np.testing.assert_array_equal(again["layers|tm|wr"], mine["layers|tm|wr"])
    assert not np.array_equal(other["layers|tm|wr"], mine["layers|tm|wr"])


def test_config_matches_reference():
    """The port's rwkv6-1.6b config and its reduced() carry the reference's
    values field for field; unknown archs point at the plan."""
    import dataclasses
    for mine, ref in ((get_config("rwkv6-1.6b"), ref_config("rwkv6-1.6b")),
                      (get_config("rwkv6-1.6b").reduced(),
                       ref_config("rwkv6-1.6b").reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.pdtype == getattr(torch, str(ref.pdtype))
        assert mine.cdtype == getattr(torch, str(ref.cdtype))
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("qwen2-7b")


def test_full_width_model_declares_published_shapes():
    """At full width (built on meta, nothing allocated): 24 layers, d 2048,
    32 heads of 64, d_ff 7168, vocab 65536, bf16, ~1.6 B parameters."""
    cfg = get_config("rwkv6-1.6b")
    model = RWKV6LM(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert 1.5e9 < n < 1.7e9
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert len(model.layers) == 24
    assert tuple(model.layers[0].tm.u.shape) == (32, 64)
    assert tuple(model.layers[0].cm.wk.shape) == (2048, 7168)
    assert tuple(model.lm_head.w.shape) == (2048, 65536)
