"""Serving CLI of the port: continuous batching by default, the static-batch
baseline behind ``--static``.  Parameters are drawn fresh from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --full-config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --device cpu --requests 4 --tokens 8          # the reduced config on the CPU

Traffic is an open-loop Poisson process (``--rate`` requests/s, seeded);
each request stops after ``--tokens`` new tokens.  ``--bench-out`` writes the
reference's serve benchmark schema.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import init_model
from repro_torch.serve.engine import DecodeEngine, EngineConfig, run_static
from repro_torch.serve.metrics import write_bench
from repro_torch.serve.requests import synthetic_requests
from repro_torch.serve.scheduler import PoissonArrivals


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots (static mode: batch size)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32,
                    help="max new tokens per request (incl. the "
                         "prefill-produced token)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, requests/s (0 = all at t=0)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static", action="store_true",
                    help="static-batch baseline instead of the engine")
    ap.add_argument("--bench-out", default=None,
                    help="write the metrics summary as JSON")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Serve as the CLI does and return what it printed from:
    {cfg, requests, outputs, summary, engine (None with --static)}."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    model = init_model(cfg, args.seed, args.device)

    cache_len = args.prompt_len + args.tokens
    rng = np.random.default_rng(args.seed)
    requests = synthetic_requests(
        cfg, args.requests, prompt_len=args.prompt_len, rng=rng,
        max_new_tokens=args.tokens, temperature=args.temperature,
        seed=args.seed)
    requests = PoissonArrivals(args.rate, seed=args.seed).assign(requests)

    engine = None
    if args.static:
        outputs, summary = run_static(cfg, model, requests, n_slots=args.slots,
                                      cache_len=cache_len)
    else:
        engine = DecodeEngine(cfg, model, EngineConfig(n_slots=args.slots,
                                                       cache_len=cache_len))
        outputs, summary = engine.run(requests)

    mode = "static" if args.static else "continuous"
    dev = model.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name} ({cfg.arch_type}) {mode} on {kind}: "
          f"{summary['n_requests']} requests, "
          f"{summary['generated_tokens']} tokens, "
          f"{summary['tokens_per_s']:.1f} tok/s, "
          f"TTFT p50 {summary['ttft_s']['p50'] * 1e3:.1f} ms, "
          f"latency p99 {summary['latency_s']['p99'] * 1e3:.1f} ms, "
          f"slot occupancy {summary['slot_occupancy']:.2f}")
    rid0 = min(outputs)
    print(f"request {rid0} tokens: {outputs[rid0][:16]}")
    if args.bench_out:
        write_bench(args.bench_out, {
            "benchmark": "serve", "arch": cfg.name, "mode": mode,
            "device": kind,
            "workload": {"requests": args.requests,
                         "prompt_len": args.prompt_len,
                         "max_new_tokens": args.tokens,
                         "rate_rps": args.rate, "seed": args.seed},
            "engine": {"n_slots": args.slots, "cache_len": cache_len},
            "metrics": summary,
        })
        print(f"wrote {args.bench_out}")
    else:
        print(json.dumps(summary, indent=2, sort_keys=True))
    return {"cfg": cfg, "requests": requests, "outputs": outputs,
            "summary": summary, "engine": engine}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
