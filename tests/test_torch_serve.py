"""repro_torch.serve against the reference's serving stack, on the CPU.

Both sides serve the same bridged parameters and the same seeded requests.
Greedy tokens must be identical: the logits agree to ~1e-5 (the model
tests hold them to 1e-4), far inside any argmax margin on these inputs."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import get_config as ref_config
from repro.models.model import init_model as ref_init
from repro.nn import param as ref_P
from repro.obs import metrics as ref_obs_metrics
from repro.serve import BENCH_MODE_KEYS as REF_BENCH_KEYS
from repro.serve import DecodeEngine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import PoissonArrivals as RefArrivals
from repro.serve import VirtualClock as RefClock
from repro.serve import synthetic_requests as ref_requests
from repro_torch.bridge import from_reference
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import DecodeEngine, EngineConfig, run_static
from repro_torch.serve.metrics import (BENCH_MODE_KEYS, quantile,
                                       summary_stats)
from repro_torch.serve.requests import synthetic_requests
from repro_torch.serve.scheduler import PoissonArrivals, VirtualClock


def _shrunk(cfg):
    """Narrower than reduced(), as the reference's serve tests run it:
    the engine tests take many decode steps."""
    return cfg.replace(d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
                       d_ff=256, vocab_size=512)


@pytest.fixture(scope="module")
def pair():
    rcfg = _shrunk(ref_config("rwkv6-1.6b").reduced())
    params = ref_P.unbox(ref_init(jax.random.PRNGKey(0), rcfg))
    cfg = _shrunk(get_config("rwkv6-1.6b").reduced())
    model = from_reference(_flatten(params), cfg, device="cpu")
    return rcfg, params, cfg, model


def _reqs(make, cfg, arrivals, n=7, temp=0.0):
    rng = np.random.default_rng(7)
    reqs = make(cfg, n, prompt_len=8, rng=rng, max_new_tokens=10,
                min_new_tokens=3, temperature=temp, seed=123)
    return arrivals(2.0, seed=1).assign(reqs)


def test_engine_greedy_tokens_match_reference_engine(pair):
    """7 requests through 3 slots (slots are reused, stop lengths differ):
    the port's engine emits the reference engine's greedy tokens."""
    rcfg, params, cfg, model = pair
    ref_eng = RefEngine(rcfg, params, RefEngineConfig(n_slots=3, cache_len=32))
    out_r, _ = ref_eng.run(_reqs(ref_requests, rcfg, RefArrivals),
                           clock=RefClock(step_s=0.05))
    eng = DecodeEngine(cfg, model, EngineConfig(n_slots=3, cache_len=32))
    out_p, summary = eng.run(_reqs(synthetic_requests, cfg, PoissonArrivals),
                             clock=VirtualClock(step_s=0.05))
    assert set(out_p) == set(out_r) == set(range(7))
    for rid in out_r:
        np.testing.assert_array_equal(out_p[rid], out_r[rid], err_msg=f"rid {rid}")
    assert eng.passes["admit"] == 7
    assert eng.passes["decode"] == summary["n_decode_steps"]


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_engine_matches_static(pair, temp):
    """Continuous batching returns the static-batch path's token streams,
    greedy and sampled (the draw depends on request seed and position only)."""
    _, _, cfg, model = pair
    reqs = _reqs(synthetic_requests, cfg, PoissonArrivals, temp=temp)
    eng = DecodeEngine(cfg, model, EngineConfig(n_slots=3, cache_len=32))
    out_c, sum_c = eng.run([r.replace() for r in reqs],
                           clock=VirtualClock(step_s=0.05))
    out_s, sum_s = run_static(cfg, model, [r.replace() for r in reqs],
                              n_slots=3, cache_len=32,
                              clock=VirtualClock(step_s=0.05))
    assert set(out_c) == set(out_s) == {r.rid for r in reqs}
    for r in reqs:
        np.testing.assert_array_equal(out_c[r.rid], out_s[r.rid])
        assert len(out_c[r.rid]) == r.max_new_tokens
    assert sum_c["generated_tokens"] == sum_s["generated_tokens"]


def test_sampling_depends_on_request_seed(pair):
    _, _, cfg, model = pair
    reqs = _reqs(synthetic_requests, cfg, PoissonArrivals, n=4, temp=1.1)
    outs = []
    for shift in (0, 0, 777):
        eng = DecodeEngine(cfg, model, EngineConfig(n_slots=2, cache_len=32))
        out, _ = eng.run([r.replace(seed=r.seed + shift) for r in reqs],
                         clock=VirtualClock())
        outs.append(out)
    for r in reqs:
        np.testing.assert_array_equal(outs[0][r.rid], outs[1][r.rid])
    assert any(not np.array_equal(outs[0][r.rid], outs[2][r.rid]) for r in reqs)


def test_evict_readmit_continues_exactly(pair):
    """A request evicted mid-decode and readmitted into another slot ends
    with the tokens of the uninterrupted run."""
    _, _, cfg, model = pair
    rng = np.random.default_rng(3)
    reqs = synthetic_requests(cfg, 3, prompt_len=8, rng=rng, max_new_tokens=12,
                              min_new_tokens=12, temperature=0.9, seed=9)

    ref_eng = DecodeEngine(cfg, model, EngineConfig(n_slots=3, cache_len=32))
    for r in reqs:
        ref_eng.admit(r.replace())
    while ref_eng.n_active():
        ref_eng.decode_step()

    eng = DecodeEngine(cfg, model, EngineConfig(n_slots=4, cache_len=32))
    for r in reqs:
        eng.admit(r.replace())
    for _ in range(4):
        eng.decode_step()
    snap = eng.evict(0)
    for _ in range(3):
        eng.decode_step()
    assert eng.admit(reqs[0].replace(rid=99, max_new_tokens=2)) == 0
    new_slot = eng.readmit(snap)
    assert new_slot == 3 and eng.slots[new_slot].evictions == 1
    while eng.n_active():
        eng.decode_step()
    for r in reqs:
        np.testing.assert_array_equal(eng.outputs[r.rid], ref_eng.outputs[r.rid])
    assert [rec.rid for rec in eng.metrics.records if rec.evictions] == [reqs[0].rid]


def test_engine_stop_and_capacity(pair):
    _, _, cfg, model = pair
    rng = np.random.default_rng(0)
    reqs = synthetic_requests(cfg, 2, prompt_len=8, rng=rng, max_new_tokens=6)
    eng = DecodeEngine(cfg, model, EngineConfig(n_slots=1, cache_len=16))
    out, _ = eng.run(reqs, clock=VirtualClock())
    assert [len(out[r.rid]) for r in reqs] == [6, 6]
    # eos stops early: ask for the token the greedy run produced third
    eos = int(out[0][2])
    eng = DecodeEngine(cfg, model, EngineConfig(n_slots=1, cache_len=16))
    out2, _ = eng.run([reqs[0].replace(eos_id=eos)], clock=VirtualClock())
    np.testing.assert_array_equal(out2[0], out[0][:list(out[0]).index(eos) + 1])
    with pytest.raises(ValueError, match="cache_len"):
        eng.admit(reqs[0].replace(max_new_tokens=9))


def test_requests_and_arrivals_match_reference():
    rcfg, cfg = ref_config("rwkv6-1.6b"), get_config("rwkv6-1.6b")
    mine = synthetic_requests(cfg, 5, 16, np.random.default_rng(4),
                              max_new_tokens=9, min_new_tokens=2, seed=3)
    ref = ref_requests(rcfg, 5, 16, np.random.default_rng(4),
                       max_new_tokens=9, min_new_tokens=2, seed=3)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.rid, a.max_new_tokens, a.seed) == (b.rid, b.max_new_tokens, b.seed)
    for rate, seed in ((0.0, 0), (2.5, 1), (40.0, 9)):
        np.testing.assert_array_equal(PoissonArrivals(rate, seed).times(11),
                                      RefArrivals(rate, seed).times(11))


def test_quantiles_match_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100):
        xs = rng.exponential(1.0, n).tolist()
        assert summary_stats(xs) == ref_obs_metrics.summary_stats(xs)
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert quantile(xs, q) == ref_obs_metrics.quantile(xs, q)


def test_cli_writes_the_reference_bench_schema(tmp_path, capsys):
    out = tmp_path / "bench.json"
    res = serve_cli.run(["--device", "cpu", "--requests", "3", "--prompt-len",
                         "4", "--tokens", "3", "--slots", "2", "--rate", "50",
                         "--bench-out", str(out)])
    payload = json.loads(out.read_text())
    assert BENCH_MODE_KEYS == REF_BENCH_KEYS
    assert set(payload["metrics"]) == set(BENCH_MODE_KEYS)
    assert {"benchmark", "arch", "mode", "workload", "engine"} <= set(payload)
    assert payload["metrics"]["generated_tokens"] == 9
    assert res["engine"].passes["admit"] == 3
    assert res["engine"].device == torch.device("cpu")
    assert "rwkv6-1.6b (ssm) continuous on cpu" in capsys.readouterr().out
