"""Continuous-batching serving over the port's prefill and serve steps.

  * ``DecodeEngine`` / ``EngineConfig`` and ``run_static`` (``engine``);
  * ``SlotCachePool`` (``cache``);
  * ``Request`` / ``synthetic_requests`` (``requests``);
  * ``FIFOScheduler`` / ``PoissonArrivals`` / clocks (``scheduler``);
  * ``ServeMetrics`` / ``BENCH_MODE_KEYS`` / ``write_bench`` (``metrics``).
"""
