"""Where the one-pass Triton statistics kernel beats the XLA statistics
pass: SVGP + logistic + RBF training steps/s through `_vi_steps` (the
scan-fused trainer) at a grid of (M, B), each shape timed in the order
XLA, Triton, Triton, XLA.  The shape gate in inference/analytic_vi.py
(`FUSED_M`, `FUSED_B`) is the region of this table where the kernel won.

  python benchmarks/fused_gate.py            needs a GPU
  python benchmarks/fused_gate.py --tiny     toy sizes on any device

Prints one JSON line per arm, then one summary line per shape.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import require_gpu, smi_line, use_compile_cache  # noqa: E402

if __name__ == "__main__":
    use_compile_cache()

import numpy as np  # noqa: E402

GRID = [(16, 4096), (32, 4096), (64, 4096), (128, 4096),
        (64, 512), (64, 1024), (64, 16_384), (64, 65_536),
        (32, 65_536), (16, 512)]
TINY_GRID = [(8, 64), (16, 128)]


def arm(fused, M, B, X, y, reps=3):
    """Median steps/s of `reps` timed chunks, with the statistics pass
    forced to the kernel (`fused`) or to XLA."""
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.inference import analytic_vi
    from agp_tpu.training.train import _vi_steps, init_state

    analytic_vi._fused_logistic_applies = lambda model, x: fused
    jax.clear_caches()
    model = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0, jnp.float32),
                                variance=jnp.asarray(1.0, jnp.float32)),
        agp.LogisticLikelihood.create(),
        agp.AnalyticSVI(B, minibatch_sampling="block"), X[:M], optimiser=None)
    state = init_state(model, X, y)
    chunk = int(min(2000, max(200, 4_000_000 // B)))
    kernel = "cavi_logistic_stats" in _vi_steps.lower(
        model, state, X, y, chunk).as_text()
    t0 = time.perf_counter()
    for _ in range(2):  # compile, then the weak-type recompile
        model, state = _vi_steps(model, state, X, y, chunk)
    jax.block_until_ready(state.mu)
    warm = time.perf_counter() - t0
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model, state = _vi_steps(model, state, X, y, chunk)
        jax.block_until_ready(state.mu)
        rates.append(chunk / (time.perf_counter() - t0))
    finite = bool(jnp.all(jnp.isfinite(state.mu)))
    return dict(M=M, B=B, fused=fused, kernel_in_program=kernel,
                warmup_s=warm, chunk=chunk, steps_per_s=rates,
                median=float(np.median(rates)), finite=finite)


def main(argv):
    import jax
    import jax.numpy as jnp

    tiny = "--tiny" in argv
    devs = jax.devices()
    require_gpu(devs, rehearse=tiny)
    print(f"device {devs[0].device_kind}; nvidia-smi: {smi_line()}", flush=True)
    N = 4_000 if tiny else 200_000
    rng = np.random.default_rng(0)
    Xh = rng.standard_normal((N, 20), dtype=np.float32)
    yh = np.where(Xh @ rng.standard_normal(20, dtype=np.float32) > 0, 1.0, -1.0)
    X, y = jnp.asarray(Xh), jnp.asarray(yh, jnp.float32)
    summary = []
    for M, B in TINY_GRID if tiny else GRID:
        rows = []
        for fused in (False, True, True, False):
            try:
                r = arm(fused, M, B, X, y)
            except Exception as e:  # a shape the GPU compiler refuses
                r = dict(M=M, B=B, fused=fused, error=f"{type(e).__name__}: "
                         f"{str(e).splitlines()[0][:300]}")
            print(json.dumps(r), flush=True)
            rows.append(r)
        med = {f: [r["median"] for r in rows if r["fused"] is f and "median" in r]
               for f in (False, True)}
        summary.append(dict(M=M, B=B, xla=med[False], triton=med[True]))
    for s in summary:
        print("summary " + json.dumps(s), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
