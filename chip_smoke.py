#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel of the serving path from ``src/repro_torch/kernels/csrc``
     and print the compiler's resource report (``-Xptxas -v``);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, in bf16 and fp32;
  4. time each kernel and its plain version with CUDA events (L2 flushed
     before every launch), beside the least time the card could take;
  5. run the port's model with the kernels on the card and with the plain
     versions on the CPU, at the reduced config in fp32, and compare;
  6. serve seeded requests at the full published width of rwkv6-1.6b through
     the serving CLI's entry point, with every launch counter reset just
     before, and check the outputs and that every layer of every forward
     pass went through the kernel.
  7. profile a few decode steps of a full pool (after the counted run):
     host wall time per step, device time by kernel.
Then it prints the kernel table as one JSON line, the card line, and, last,
``{"ok": true, "device": {...}}``.

It imports nothing of JAX: the machine with the card need not have it.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch sees no CUDA device; this script runs on a GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as K  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.models.steps import make_prefill_step, make_serve_step  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor flop/s.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# Tolerances (|got - want| <= atol + rtol |want|): fp32 1e-4, the scan rung of
# the reference's ladder (a T-step decay product compounds rounding, and the
# kernel sums in another order); bf16 outputs 2e-2, the bf16 rung (both sides
# compute in fp32 and round once to bf16, so they differ by an ulp at most).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STATE_TOL = 1e-4            # the fp32 state, whatever the input dtype

SERVE_ARGS = ["--arch", "rwkv6-1.6b", "--full-config", "--requests", "16",
              "--prompt-len", "128", "--tokens", "64", "--slots", "8",
              "--rate", "8", "--seed", "0", "--device", "cuda"]
# The kernel's shapes on that path: batch-1 prefill of the prompt, and the
# decode step over the 8 slots; 32 heads of 64.
SHAPES = {"prefill": (1, 128, 32), "decode": (8, 1, 32)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def scan_inputs(B, T, H, dtype, seed, strided=False):
    """r,k,v,w (B,T,H,64) in ``dtype``, u (H,64), nonzero s0 (B,H,64,64) fp32.
    ``strided``: r/k/v/w are views into one (B,T,4,H,64) buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = K.D

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    r, k, v, wl = (randn(B, T, H, D) for _ in range(4))
    w = torch.exp(-torch.exp(wl))          # data-dependent decay in (0, 1)
    if strided:
        r, k, v, w = torch.stack([r, k, v, w], dim=2).to(dtype).unbind(2)
    else:
        r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
    return r, k, v, w, randn(H, D, scale=0.5).to(dtype), randn(B, H, D, D, scale=0.1)


def max_err(got, want, tol):
    """max |got - want| and whether every element is within tol."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= tol + tol * w.abs()).all())


def phase_compare():
    """Kernel vs plain version on the card; returns the per-case records."""
    checks = []
    for shape_name, (B, T, H) in SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            for strided in (False, True):
                inp = scan_inputs(B, T, H, dtype, seed=1, strided=strided)
                y, sT = K.rwkv6_scan(*inp)
                torch.cuda.synchronize()
                y0, sT0 = ref.rwkv6_scan(*inp)
                ey, oky = max_err(y, y0, TOL[dtype])
                es, oks = max_err(sT, sT0, STATE_TOL)
                # in place: the state advances in its own buffer, same result
                s_inplace = inp[5].clone()
                y2, _ = K.rwkv6_scan(*inp[:5], s_inplace, state_out=s_inplace)
                same = bool(torch.equal(y2, y) and torch.equal(s_inplace, sT))
                rec = {"shape": shape_name, "B": B, "T": T, "H": H,
                       "dtype": str(dtype).replace("torch.", ""),
                       "strided": strided, "err_y": ey, "err_state": es,
                       "tol_y": TOL[dtype], "tol_state": STATE_TOL,
                       "in_place_equal": same}
                print("compare", json.dumps(rec))
                if not (oky and oks and same):
                    raise SystemExit(f"rwkv6_scan disagrees with its plain "
                                     f"version: {rec}")
                checks.append(rec)
    return checks


def time_ms(fn, iters, flush):
    """Mean device ms of ``fn`` over ``iters`` launches, L2 flushed before
    each (the serving path reaches each layer's scan with a cold L2)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def scan_bound(B, T, H, dtype):
    """Least time for one call: each input read once, each output written
    once, over HBM bandwidth; or 5*D*D + 5*D fp32 flops per (b,t,h) over
    the fp32 peak; whichever is larger."""
    D = K.D
    e = torch.tensor([], dtype=dtype).element_size()
    nbytes = 5 * B * T * H * D * e + H * D * e + 2 * B * H * D * D * 4
    flops = B * T * H * (5 * D * D + 5 * D)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def phase_time():
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for shape_name, (B, T, H) in SHAPES.items():
        dtype = torch.bfloat16                     # the serving path's dtype
        inp = scan_inputs(B, T, H, dtype, seed=2)
        ms = time_ms(lambda: K.rwkv6_scan(*inp), 200, flush)
        plain_ms = time_ms(lambda: ref.rwkv6_scan(*inp), 20, flush)
        bound_ms, bound_by, nbytes, flops = scan_bound(B, T, H, dtype)
        out[shape_name] = {"B": B, "T": T, "H": H, "dtype": "bfloat16",
                           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        print("time", shape_name, json.dumps(out[shape_name]))
    return out


def phase_model_check():
    """The port's model with kernels on the card vs plain on the CPU, same
    params, reduced config in fp32: prefill then 4 decode steps."""
    cfg = get_config("rwkv6-1.6b").reduced()
    cpu = init_model(cfg, seed=3, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(5, cfg.vocab_size, (2, 37 + 4), generator=g)
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)
    worst = 0.0
    lc, cc = prefill(cpu, {"tokens": toks[:, :37]})
    lg, cg = prefill(gpu, {"tokens": toks[:, :37].cuda()})
    pairs = [(lg, lc)] + [(cg["layers"][k], cc["layers"][k]) for k in cc["layers"]]
    for t in range(37, 41):
        lc, cc = step(cpu, {"tokens": toks[:, t:t + 1]}, cc)
        lg, cg = step(gpu, {"tokens": toks[:, t:t + 1].cuda()}, cg)
        pairs.append((lg, lc))
    pairs += [(cg["layers"][k], cc["layers"][k]) for k in cc["layers"]]
    for got, want in pairs:
        err, ok = max_err(got.cpu(), want, 1e-4)
        if not ok or not bool(torch.isfinite(got).all()):
            raise SystemExit(f"model on the card disagrees with the CPU: "
                             f"max abs err {err}")
        worst = max(worst, err)
    print(f"model check (reduced, fp32, prefill 37 + 4 decode): max abs err "
          f"{worst:.3e} within 1e-4")
    return worst


def phase_serve(card):
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    t0 = time.perf_counter()
    res = serve.run(SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches
    cfg, eng = res["cfg"], res["engine"]
    summary, outputs = res["summary"], res["outputs"]
    for r in res["requests"]:
        got = len(outputs.get(r.rid, ()))
        if got != r.max_new_tokens:
            raise SystemExit(f"request {r.rid} stopped after {got} tokens, "
                             f"expected {r.max_new_tokens}")
    # The engine raises FloatingPointError when a request completes after
    # any non-finite logit, so every request completing means all were finite.
    print(f"all {len(outputs)} requests completed at their max_new_tokens "
          f"with finite logits at every step")
    passes = eng.passes
    if passes["admit"] != len(res["requests"]):
        raise SystemExit(f"admits {passes['admit']} != requests")
    if passes["decode"] != summary["n_decode_steps"]:
        raise SystemExit(f"decode passes {passes['decode']} != steps "
                         f"{summary['n_decode_steps']}")
    want = cfg.n_layers * sum(passes.values())
    print(f"serve launches: rwkv6_scan {launches}; {cfg.n_layers} layers x "
          f"(admits {passes['admit']} + decode steps {passes['decode']} + "
          f"warmup passes {passes['warmup']}) = {want}")
    if launches != want or launches == 0:
        raise SystemExit("the serving path did not run every layer's scan "
                         "through the kernel")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve ({card}): {summary['n_requests']} requests, "
          f"{summary['generated_tokens']} tokens, "
          f"{summary['tokens_per_s']:.2f} tok/s, TTFT p50 "
          f"{summary['ttft_s']['p50'] * 1e3:.2f} ms, latency p99 "
          f"{summary['latency_s']['p99'] * 1e3:.2f} ms, decode steps "
          f"{summary['n_decode_steps']}, peak memory {peak:.2f} GiB, "
          f"phase wall {wall:.1f} s (init included)")
    print("serve_summary", json.dumps(summary, sort_keys=True))
    return launches, res


def phase_profile(res, card, steps=5):
    """Host wall time and device time of decode steps over a full pool."""
    eng = res["engine"]
    for r in res["requests"][:eng.engine.n_slots]:
        eng.admit(r.replace(rid=10_000 + r.rid))
    eng.decode_step()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            eng.decode_step()          # ends in a device-to-host copy (sync)
            walls.append(time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == cuda),
                  reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3 / steps
    wall_ms = sum(walls) / steps * 1e3
    print(f"profile ({card}): decode step over {eng.engine.n_slots} slots: "
          f"host wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f} %), kernels per step "
          f"{sum(r[1] for r in rows) / steps:.0f}")
    for us, n, key in rows[:8]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step  {n // steps:5d} calls/step  {key[:90]}")


def main() -> None:
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build("rwkv6_scan")
    print(f"built rwkv6_scan in {time.perf_counter() - t0:.1f} s; compiler report:")
    print(build.build_log("rwkv6_scan").strip())

    checks = phase_compare()
    times = phase_time()
    phase_model_check()
    launches, res = phase_serve(card)
    phase_profile(res, card)

    dec = times["decode"]
    kernels = [{
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:56",
        "launches": launches,
        "max_abs_err": max(max(c["err_y"], c["err_state"]) for c in checks
                           if c["dtype"] == "bfloat16"),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "shapes": times,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
