"""Benchmark: natural-gradient CAVI iterations/s on one GPU (SVGP M=64).

Prints the device and the secondary rows on earlier lines, then ONE JSON
line {"metric", "value", "unit", "vs_baseline", "device"}.  Times end in
`block_until_ready`.  Fails without a GPU.

`vs_baseline` is the speedup over the plain float64 numpy implementation
of the same CAVI iteration (agp_tpu/reference.py) on this machine's CPU --
the closest stand-in for the reference's Julia/OpenBLAS execution model.
"""
from __future__ import annotations

import json
import os
import time

from chip_smoke import require_gpu, smi_line, use_compile_cache

if __name__ == "__main__":
    use_compile_cache()

import numpy as np


def build_workload(dtype, sampling="block"):
    """Flagship workload.  Default sampling is "block" (64-row block
    bootstrap: tiles of pre-shuffled rows are iid 64-row samples); the
    "slice" mode (correlated contiguous windows) is a secondary row."""
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.training.train import init_state

    N, D, M, B = 200_000, 20, 64, 4096
    key = jax.random.PRNGKey(0)
    kx, kw = jax.random.split(key)
    X = jax.random.normal(kx, (N, D), dtype=dtype)
    w = jax.random.normal(kw, (D,), dtype=dtype)
    y = jnp.where(X @ w > 0, 1.0, -1.0).astype(dtype)

    kern = agp.SqExponentialKernel(
        lengthscale=jnp.asarray(2.0, dtype), variance=jnp.asarray(1.0, dtype)
    )
    lik = agp.LogisticLikelihood.create()
    model = agp.SVGP.create(
        kern, lik, agp.AnalyticSVI(B, minibatch_sampling=sampling), X[:M],
        optimiser=None,
    )
    y2, tl = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=tl)
    state = init_state(model, X, y2)
    return model, state, X, y2


def _timed_steps(model, state, X, y, iters, chunk):
    """Steady-state iterations/s of the scan-fused training loop: two warm-up
    calls (compile, then the weak->strong dtype recompile that models with
    updating scalar leaves trigger), then `iters` iterations timed to
    `block_until_ready`."""
    import jax

    from agp_tpu.training.train import _vi_steps

    for _ in range(2):
        model, state = _vi_steps(model, state, X, y, chunk)
    jax.block_until_ready(state.mu)
    n = max(iters // chunk, 1)
    t0 = time.perf_counter()
    for _ in range(n):
        model, state = _vi_steps(model, state, X, y, chunk)
    jax.block_until_ready(state.mu)
    dt = time.perf_counter() - t0
    assert bool(jax.numpy.all(jax.numpy.isfinite(state.mu))), "non-finite posterior"
    return n * chunk / dt


def bench_jax(iters=8000, chunk=2000):
    import jax

    return _timed_steps(*build_workload(jax.numpy.float32), iters, chunk)


def bench_numpy_baseline(iters=20):
    """The same CAVI iteration in float64 numpy (agp_tpu/reference.py) at
    the flagship shape: the stand-in for the reference's per-iteration cost
    model (kernel matrices recomputed per minibatch, closed-form logistic
    E-step, natural-gradient update)."""
    from agp_tpu.reference import svgp_cavi

    rng = np.random.RandomState(0)
    N, D, M, B = 200_000, 20, 64, 4096
    X = rng.randn(N, D)
    y = np.where(X @ rng.randn(D) > 0, 1.0, -1.0)
    batches = [(X[i], y[i]) for i in (rng.randint(0, N, B) for _ in range(iters))]
    t0 = time.perf_counter()
    svgp_cavi(batches, X[:M], 2.0, 1.0, rho=N / B)
    return iters / (time.perf_counter() - t0)


def _bench_config(model, X, y, iters, chunk):
    from agp_tpu.training.train import init_state

    return _timed_steps(model, init_state(model, X, y), X, y, iters, chunk)


def bench_extra():
    """Secondary configs (multiclass K=10, heteroscedastic 2-GP,
    large-M/large-B, Gibbs, streaming): {row name: value}."""
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp

    dtype = jnp.float32
    key = jax.random.PRNGKey(0)
    rows = {}

    # flagship shape with "slice" sampling.  CAVEAT: slice draws correlated
    # contiguous windows -- an upper bound, not an honest iid estimator.
    model_sl, _, X_f, y_f = build_workload(dtype, sampling="slice")
    rows["flagship_slice_iters_per_s"] = _bench_config(model_sl, X_f, y_f, 8000, 2000)

    # multiclass logistic-softmax, K = 10 latents
    N, D, M, B, K = 50_000, 10, 64, 2048, 10
    X = jax.random.normal(key, (N, D), dtype)
    logits = X @ jax.random.normal(jax.random.fold_in(key, 1), (D, K), dtype)
    y = jnp.argmax(logits, axis=1)
    m = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0, dtype)),
        agp.LogisticSoftMaxLikelihood.create(K),
        agp.AnalyticSVI(B, minibatch_sampling="slice"),
        X[:M],
        optimiser=None,
    )
    y2, tl = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=tl)
    rows["multiclass_k10_m64_b2048"] = _bench_config(m, X, y2.astype(dtype), 4000, 2000)

    # heteroscedastic two-GP regression
    N, D, M, B = 50_000, 10, 64, 2048
    X = jax.random.normal(jax.random.fold_in(key, 2), (N, D), dtype)
    yr = jnp.sin(X[:, 0]) + 0.1 * jax.random.normal(jax.random.fold_in(key, 3), (N,), dtype)
    m = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0, dtype)),
        agp.HeteroscedasticLikelihood.create(),
        agp.AnalyticSVI(B, minibatch_sampling="slice"),
        X[:M],
        optimiser=None,
    )
    y2, tl = m.likelihood.treat_labels(yr)
    m = m.replace(likelihood=tl)
    rows["heteroscedastic_m64_b2048"] = _bench_config(m, X, y2.astype(dtype), 4000, 2000)

    # large-M / large-B logistic (the matmul-bound regime)
    N, D, M, B = 500_000, 20, 512, 65_536
    X = jax.random.normal(jax.random.fold_in(key, 4), (N, D), dtype)
    w = jax.random.normal(jax.random.fold_in(key, 5), (D,), dtype)
    y = jnp.where(X @ w > 0, 1.0, -1.0).astype(dtype)
    m = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0, dtype)),
        agp.LogisticLikelihood.create(),
        agp.AnalyticSVI(B, minibatch_sampling="slice"),
        X[:M],
        optimiser=None,
    )
    y2, tl = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=tl)
    v = _bench_config(m, X, y2.astype(dtype), 300, 50)
    rows["logistic_m512_b65536"] = v
    # data throughput in the large regime
    rows["logistic_m512_b65536_pts_per_s"] = v * B

    # exact augmented Gibbs (PSW Polya-Gamma draws + CG perturb-and-solve
    # global resample), MCGP + Logistic, N=2048, 4 chains
    import time as _time

    from agp_tpu.models.mcgp import sample as mc_sample

    N = 2048
    Xg = jax.random.normal(jax.random.fold_in(key, 6), (N, 8), dtype)
    yg = jnp.sign(Xg[:, 0] + 0.5 * Xg[:, 1])
    mg = agp.MCGP.create(
        Xg,
        yg,
        agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0, dtype)),
        agp.LogisticLikelihood.create(),
        agp.GibbsSampling(n_burnin=50),
    )
    S, C = 400, 4
    for _ in range(2):  # compile + weak->strong warmups
        s = mc_sample(mg, S, key=jax.random.PRNGKey(1), n_chains=C)
    jax.block_until_ready(s)
    t0 = _time.perf_counter()
    s = jax.block_until_ready(mc_sample(mg, S, key=jax.random.PRNGKey(2), n_chains=C))
    dt = _time.perf_counter() - t0
    rows["gibbs_logistic_n2048_4chains_steps_per_s"] = (S + 50) * C / dt

    # streaming OnlineSVGP (fused one-dispatch batch: save-old -> OIPS
    # update_Z -> masked kmat -> 20 CAVI iters), Gaussian, B=256, cap=128
    Bo, ITERS = 256, 20
    Xo = jax.random.uniform(jax.random.fold_in(key, 7), (4096, 2), dtype) * 4 - 2
    fo = jnp.sin(2 * Xo[:, 0]) + 0.5 * Xo[:, 1]
    yo = fo + 0.05 * jax.random.normal(jax.random.fold_in(key, 8), fo.shape, dtype)

    def stream_once(m, s):
        for i in range(8):
            m, s = agp.online_train(
                m, Xo[i * Bo : (i + 1) * Bo], yo[i * Bo : (i + 1) * Bo],
                state=s, iterations=ITERS,
            )
        return m, s

    mo = agp.OnlineSVGP.create(
        agp.SqExponentialKernel(), agp.GaussianLikelihood.create(0.05, opt_noise=False),
        agp.AnalyticVI(), n_dim=2, capacity=128, optimiser=None,
    )
    mo, so = agp.online_train(mo, Xo[:Bo], yo[:Bo], iterations=ITERS)
    for _ in range(2):  # compile + cache warmups
        stream_once(mo, so)
    t0 = _time.perf_counter()
    m2, s2 = stream_once(mo, so)
    jax.block_until_ready(s2.mu)
    dt = _time.perf_counter() - t0
    # per-batch-dispatch path: one host dispatch per batch
    rows["online_stream_b256_cap128_pts_per_s"] = 8 * Bo / dt

    # scan-fused stream (one lax.scan device program over all batches)
    Xs_st = Xo[: 8 * Bo].reshape(8, Bo, 2)
    ys_st = yo[: 8 * Bo].reshape(8, Bo)
    for _ in range(2):
        m3, s3 = agp.online_train_stream(mo, Xs_st[1:], ys_st[1:], state=so,
                                         iterations=ITERS)
    jax.block_until_ready(s3.mu)
    t0 = _time.perf_counter()
    m3, s3 = agp.online_train_stream(mo, Xs_st[1:], ys_st[1:], state=so,
                                     iterations=ITERS)
    jax.block_until_ready(s3.mu)
    dt = _time.perf_counter() - t0
    rows["online_stream_fused_b256_cap128_pts_per_s"] = 7 * Bo / dt
    return rows


def main():
    import jax

    dev = jax.devices()[0]
    require_gpu(jax.devices())
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {json.dumps(device)}; nvidia-smi: {smi_line()}", flush=True)
    value = bench_jax()
    base = bench_numpy_baseline()
    if os.environ.get("AGP_BENCH_EXTRA", "1") != "0":
        for name, v in bench_extra().items():
            print(json.dumps({"row": name, "value": round(v, 2)}), flush=True)
    print(
        json.dumps(
            {
                "metric": "cavi_iters_per_sec_svgp_m64_logistic_b4096",
                "value": round(value, 2),
                "unit": "iters/s/chip",
                "vs_baseline": round(value / base, 2),
                "device": device,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
