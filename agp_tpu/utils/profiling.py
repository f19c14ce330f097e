"""Tracing / profiling helpers.

The reference has no tracing beyond BenchmarkTools timers (SURVEY.md
section 5).  JAX equivalent: `jax.profiler` traces viewable in
TensorBoard/Perfetto, plus a tiny phase timer used by the benchmark suite.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: with trace('/tmp/trace'): step(...)"""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Named phase timing with block_until_ready barriers."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result_fn=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            jax.block_until_ready(out["result"])
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self):
        return dict(sorted(self.times.items(), key=lambda kv: -kv[1]))
