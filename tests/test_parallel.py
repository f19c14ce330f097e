"""Sharding tests on the 8-virtual-device CPU mesh: data-parallel CAVI must
be bit-compatible (up to float assoc.) with single-device execution, and the
multi-chip dryrun must compile + run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import agp_tpu as agp
from tests.testingtools import generate_f


def test_data_parallel_matches_single_device():
    from agp_tpu.parallel.mesh import make_mesh, sharded_train

    kern = agp.SqExponentialKernel()
    X, f = generate_f(64, 2, kern)
    y = np.sign(np.asarray(f))
    lik = agp.LogisticLikelihood.create()

    model1 = agp.SVGP.create(kern, lik, agp.AnalyticVI(), X[:8], optimiser=None)
    m1, s1 = agp.train(model1, X, y, iterations=10)

    model2 = agp.SVGP.create(kern, lik, agp.AnalyticVI(), X[:8], optimiser=None)
    mesh = make_mesh(8)
    m2, s2 = sharded_train(model2, X, y, iterations=10, mesh=mesh)

    np.testing.assert_allclose(np.asarray(s1.mu), np.asarray(s2.mu), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(s1.Sigma), np.asarray(s2.Sigma), rtol=1e-8, atol=1e-9
    )


def test_statistics_psum_in_sharded_step():
    """The sharded step's statistic contraction must produce identical
    [M]/[M,M] results to a local einsum (GSPMD inserts the reduction)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from agp_tpu.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(8)
    B, M = 64, 8
    kappa = jax.random.normal(jax.random.PRNGKey(0), (B, M))
    theta = jax.random.uniform(jax.random.PRNGKey(1), (B,))
    kappa_s = shard_batch(mesh, kappa)
    theta_s = shard_batch(mesh, theta)

    @jax.jit
    def stats(k, t):
        return jnp.einsum("bm,b,bn->mn", k, t, k)

    out_s = stats(kappa_s, theta_s)
    out = stats(kappa, theta)
    np.testing.assert_allclose(np.asarray(out_s), np.asarray(out), rtol=1e-10)


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_gibbs_chains_shard_over_devices():
    """Chains are vmapped; with a device axis they shard for free."""
    kern = agp.SqExponentialKernel()
    X, f = generate_f(20, 2, kern)
    y = np.sign(np.asarray(f))
    mg = agp.MCGP.create(X, y, kern, agp.LogisticLikelihood.create(),
                         agp.GibbsSampling(n_burnin=10))
    samples = agp.sample(mg, 20, key=jax.random.PRNGKey(0), n_chains=8)
    assert samples.shape == (8, 20, 1, 20)
    assert bool(jnp.all(jnp.isfinite(samples)))


def test_two_process_distributed(tmp_path):
    """Real multi-process rendezvous: two OS processes, 2 virtual CPU
    devices each, one GLOBAL 4-device data mesh through
    `initialize_distributed` + `data_parallel_step`.  Catches
    rendezvous/global-mesh/global-array bugs before hardware.  Both
    processes must agree with each other AND with a single-process run."""
    import os
    import socket
    import subprocess
    import sys

    # free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu via jax.config
    env["JAX_COMPILATION_CACHE_DIR"] = ""  # avoid cache cross-talk
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", coord, str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    import json

    meta = json.load(open(tmp_path / "proc0.json"))
    assert meta["process_count"] == 2
    assert meta["global_devices"] == 4

    r0 = np.load(tmp_path / "proc0.npz")
    r1 = np.load(tmp_path / "proc1.npz")
    np.testing.assert_allclose(r0["mu"], r1["mu"], rtol=1e-12)
    np.testing.assert_allclose(r0["Sigma"], r1["Sigma"], rtol=1e-12)

    # single-process reference on the identical data/model
    rng = np.random.RandomState
    import numpy as _np

    gen = _np.random.default_rng(0)
    X = gen.uniform(-2.0, 2.0, (64, 2))
    f = _np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
    y = _np.where(f > 0, 1.0, -1.0)
    model = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
        agp.AnalyticVI(), Z=X[:8], optimiser=None,
    )
    model, state = agp.train(model, X, y, iterations=10)
    np.testing.assert_allclose(r0["mu"], np.asarray(state.mu), rtol=1e-8, atol=1e-9)


def test_sharded_svi_minibatch_step():
    """shard_map per-device minibatch draw + GSPMD statistic psum."""
    from agp_tpu.parallel.mesh import make_mesh, sharded_svi_train

    X = np.random.RandomState(0).randn(1024, 4)
    y = np.sign(X @ np.ones(4))
    m = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
        agp.AnalyticSVI(128), jnp.asarray(X[:16]), optimiser=None,
    )
    mesh = make_mesh(8)
    m, s = sharded_svi_train(m, X, y, iterations=30, mesh=mesh)
    from agp_tpu.training.predictions import predict_y

    acc = float(jnp.mean(predict_y(m, s, jnp.asarray(X)) == jnp.asarray(y)))
    assert acc > 0.8


def test_mo_data_parallel_matches_single_device():
    """Multi-output data-parallel step == single-device mo_train to float
    associativity (statistics + A-gradient contractions psum under GSPMD)."""
    from agp_tpu.parallel.mesh import make_mesh, mo_sharded_train

    kern = agp.SqExponentialKernel()
    X, f1 = generate_f(64, 2, kern, key=jax.random.PRNGKey(11))
    _, f2 = generate_f(64, 2, kern, key=jax.random.PRNGKey(12), X=X)
    y_reg = np.asarray(f1)
    y_cls = np.sign(np.asarray(f2))

    def build():
        return agp.MOSVGP.create(
            agp.SqExponentialKernel(),
            [agp.GaussianLikelihood.create(0.1, opt_noise=False), agp.LogisticLikelihood.create()],
            agp.AnalyticVI(), X[:8], n_latent=2, optimiser=None,
            Aoptimiser=None, key=jax.random.PRNGKey(3),
        )

    m1, s1 = agp.mo_train(build(), X, [y_reg, y_cls], iterations=10)

    mesh = make_mesh(8)
    m2, s2 = mo_sharded_train(build(), X, [y_reg, y_cls], iterations=10, mesh=mesh)

    np.testing.assert_allclose(np.asarray(s1.mu), np.asarray(s2.mu), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(s1.Sigma), np.asarray(s2.Sigma), rtol=1e-8, atol=1e-9)


def test_mo_data_parallel_with_A_updates():
    """The mixing-matrix gradient step also reduces over the sharded data
    axis; with Aoptimiser on, sharded == single-device still holds."""
    from agp_tpu.parallel.mesh import make_mesh, mo_sharded_train

    kern = agp.SqExponentialKernel()
    X, f1 = generate_f(64, 2, kern, key=jax.random.PRNGKey(13))
    _, f2 = generate_f(64, 2, kern, key=jax.random.PRNGKey(14), X=X)
    ys = [np.asarray(f1), np.asarray(f2)]

    def build():
        return agp.MOSVGP.create(
            agp.SqExponentialKernel(),
            [agp.GaussianLikelihood.create(0.1, opt_noise=False),
             agp.GaussianLikelihood.create(0.1, opt_noise=False)],
            agp.AnalyticVI(), X[:8], n_latent=2, optimiser=None,
            key=jax.random.PRNGKey(4),
        )

    m1, s1 = agp.mo_train(build(), X, ys, iterations=8)
    m2, s2 = mo_sharded_train(build(), X, ys, iterations=8, mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(m1.A), np.asarray(m2.A), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(s1.mu), np.asarray(s2.mu), rtol=1e-8, atol=1e-9)


# ----------------------------------------------------- padding-mask contract
@pytest.mark.parametrize("lik_name", ["logistic", "gaussian_noise", "poisson"])
def test_sharded_train_nondivisible_matches_single_device(lik_name):
    """N % n_devices != 0: shard_batch pads the trailing shard and the
    driver masks the pad rows out of every statistic (incl. the
    likelihood-parameter batch sums: noise learning, rate MLE) -- the
    trajectory must match single-device training on the unpadded data."""
    from agp_tpu.parallel.mesh import make_mesh, sharded_train

    kern = agp.SqExponentialKernel()
    N = 61  # 61 % 8 == 5 -> 3 pad rows
    X, f = generate_f(N, 2, kern)
    if lik_name == "logistic":
        y = np.sign(np.asarray(f))
        lik = lambda: agp.LogisticLikelihood.create()
    elif lik_name == "gaussian_noise":
        y = np.asarray(f) + 0.1 * np.random.RandomState(0).randn(N)
        lik = lambda: agp.GaussianLikelihood.create(0.5, opt_noise=True)
    else:
        y = np.random.RandomState(1).poisson(2.0, size=N).astype(float)
        lik = lambda: agp.PoissonLikelihood.create()

    def build():
        return agp.SVGP.create(kern, lik(), agp.AnalyticVI(), X[:8], optimiser=None)

    m1, s1 = agp.train(build(), X, y, iterations=10)
    m2, s2 = sharded_train(build(), X, y, iterations=10, mesh=make_mesh(8))

    np.testing.assert_allclose(np.asarray(s1.mu), np.asarray(s2.mu), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(s1.Sigma), np.asarray(s2.Sigma), rtol=1e-8, atol=1e-10
    )
    if lik_name == "gaussian_noise":
        np.testing.assert_allclose(
            float(m1.likelihood.sigma2), float(m2.likelihood.sigma2), rtol=1e-10
        )
    if lik_name == "poisson":
        np.testing.assert_allclose(
            float(m1.likelihood.lam), float(m2.likelihood.lam), rtol=1e-10
        )


def test_mo_sharded_train_nondivisible_matches_single_device():
    """Non-divisible N for the multi-output driver: pad rows must stay out
    of the natural-gradient statistics AND the A-gradient contractions."""
    from agp_tpu.parallel.mesh import make_mesh, mo_sharded_train

    kern = agp.SqExponentialKernel()
    N = 61
    X, f1 = generate_f(N, 2, kern, key=jax.random.PRNGKey(21))
    _, f2 = generate_f(N, 2, kern, key=jax.random.PRNGKey(22), X=X)
    ys = [np.asarray(f1), np.asarray(f2)]

    def build():
        return agp.MOSVGP.create(
            agp.SqExponentialKernel(),
            [agp.GaussianLikelihood.create(0.1, opt_noise=False),
             agp.GaussianLikelihood.create(0.1, opt_noise=False)],
            agp.AnalyticVI(), X[:8], n_latent=2, optimiser=None,
            key=jax.random.PRNGKey(5),
        )

    m1, s1 = agp.mo_train(build(), X, ys, iterations=8)
    m2, s2 = mo_sharded_train(build(), X, ys, iterations=8, mesh=make_mesh(8))
    np.testing.assert_allclose(np.asarray(s1.mu), np.asarray(s2.mu), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(m1.A), np.asarray(m2.A), rtol=1e-8, atol=1e-10)


def test_sharded_svi_draw_never_samples_pad_rows():
    """The per-device minibatch draw bounds its indices by the shard's
    valid count: rows padded onto the last shard are never sampled."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from agp_tpu.parallel.mesh import _make_draw, make_mesh

    mesh = make_mesh(8)
    N, n_pad, D = 61, 3, 2
    Xp = np.ones((N + n_pad, D))
    Xp[N:] = np.nan  # poison the pad rows
    yp = np.ones(N + n_pad)
    yp[N:] = np.nan
    Xs = jax.device_put(jnp.asarray(Xp), NamedSharding(mesh, P("data", None)))
    ys = jax.device_put(jnp.asarray(yp), NamedSharding(mesh, P("data")))
    draw = jax.jit(_make_draw(mesh, 16, n_pad, "data"))
    for i in range(20):
        xb, yb = draw(Xs, ys, jax.random.PRNGKey(i))
        assert bool(jnp.all(jnp.isfinite(xb))), f"pad row drawn at key {i}"
        assert bool(jnp.all(jnp.isfinite(yb)))


def test_sharded_svi_scan_chunks_match_per_step():
    """The chunked lax.scan driver must reproduce the per-step dispatch
    trajectory exactly (same keys -> same draws -> same updates)."""
    import dataclasses

    from agp_tpu.parallel.mesh import (
        _make_svi_steps,
        make_mesh,
        replicate,
        shard_batch,
        sharded_svi_step,
    )
    from agp_tpu.training.train import init_state

    X = np.random.RandomState(0).randn(512, 3)
    y = np.sign(X @ np.ones(3))
    m = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
        agp.AnalyticSVI(64), jnp.asarray(X[:8]), optimiser=None,
    )
    y2, lik = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=lik, inference=dataclasses.replace(m.inference, batchsize=64))
    mesh = make_mesh(8)
    Xs, ys = shard_batch(mesh, jnp.asarray(X), jnp.asarray(y2, jnp.asarray(X).dtype))
    state = init_state(m, Xs, ys)
    state = state.replace(rho=jnp.asarray(X.shape[0] / 64.0, Xs.dtype))
    m_r, state_r = replicate(mesh, (m, state))

    step = sharded_svi_step(mesh, 8)
    ms, ss = m_r, state_r
    for _ in range(7):
        ms, ss = step(ms, ss, Xs, ys)

    # legacy in-body-RNG scan driver
    steps = _make_svi_steps(step.body)
    mc, sc = steps(m_r, state_r, Xs, ys, 3)
    mc, sc = steps(mc, sc, Xs, ys, 4)

    np.testing.assert_allclose(np.asarray(ss.mu), np.asarray(sc.mu), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ss.Sigma), np.asarray(sc.Sigma), rtol=1e-12)
    assert int(ss.step) == int(sc.step) == 7

    # hoisted-RNG scan driver (precomputed per-device index rows): must
    # draw bit-identical indices (same fold_in(fold_in(key, step), dev))
    steps_h = _make_svi_steps(step)
    mh, sh = steps_h(m_r, state_r, Xs, ys, 3)
    mh, sh = steps_h(mh, sh, Xs, ys, 4)
    np.testing.assert_allclose(np.asarray(ss.mu), np.asarray(sh.mu), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ss.Sigma), np.asarray(sh.Sigma), rtol=1e-12)
    assert int(sh.step) == 7


@pytest.mark.parametrize("sampling", ["slice", "block:16"])
def test_sharded_svi_slice_sampling_trains(sampling):
    """Per-device contiguous-window (slice) and aligned-tile (block)
    minibatch draws: the sharded analogs of the single-chip modes
    (training/train.py::_draw_batch).  The padded last shard must exclude
    pad rows (slice: dynamic upper bound; block: whole-tile bound)."""
    from agp_tpu.parallel.mesh import make_mesh, sharded_svi_train

    X = np.random.RandomState(0).randn(1000, 4)  # 1000 % 8 != 0 -> padded
    y = np.sign(X @ np.ones(4))
    m = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
        agp.AnalyticSVI(128, minibatch_sampling=sampling),
        jnp.asarray(X[:16]), optimiser=None,
    )
    mesh = make_mesh(8)
    m, s = sharded_svi_train(m, X, y, iterations=40, mesh=mesh)
    from agp_tpu.training.predictions import predict_y

    acc = float(jnp.mean(predict_y(m, s, jnp.asarray(X)) == jnp.asarray(y)))
    assert acc > 0.8


def _flagship_like(inference):
    X = np.random.RandomState(0).randn(2048, 4).astype(np.float32)
    y = np.sign(X @ np.ones(4, np.float32))
    m = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.float32(1.0), variance=jnp.float32(1.0)),
        agp.LogisticLikelihood.create(), inference, jnp.asarray(X[:16]), optimiser=None,
    )
    return m, X, y


@pytest.mark.parametrize("driver,want", [
    ("sharded_svi", False), ("sharded_full_batch", False), ("one_device", True),
])
def test_triton_kernel_only_outside_gspmd(driver, want):
    """Lowered for CUDA, the one-device step of an SVGP + logistic model
    carries the Triton statistics kernel and the GSPMD steps do not: the
    partitioner cannot split its custom call."""
    from agp_tpu.parallel.mesh import (
        _dp_steps, build_svi_trainer, make_mesh, replicate, shard_batch)
    from agp_tpu.training.train import _vi_steps, init_state

    full = driver == "sharded_full_batch"
    m, X, y = _flagship_like(agp.AnalyticVI() if full else agp.AnalyticSVI(512))
    mesh = make_mesh(8)
    if driver == "sharded_svi":
        steps, m, s, Xs, ys = build_svi_trainer(m, X, y, mesh)
        traced = steps.trace(m, s, Xs, ys, 2)
    elif full:
        Xs, ys = shard_batch(mesh, X, y)
        m, s = replicate(mesh, (m, init_state(m, Xs, ys)))
        traced = _dp_steps.trace(m, s, Xs, ys, None, 2)
    else:
        Xd, yd = jnp.asarray(X), jnp.asarray(y)
        traced = _vi_steps.trace(m, init_state(m, Xd, yd), Xd, yd, 2)
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert ("cavi_logistic_stats" in text) is want


@pytest.mark.parametrize("program", ["sharded_svi_step", "statistics_psum", "gathered_batch"])
def test_stray_collectives(program):
    """chip_smoke's check that a sharded step moves only the [M] + [M, M]
    statistics between devices: the compiled sharded SVI step and a bare
    statistics contraction pass it; a program that gathers its sharded
    batch onto every device fails it."""
    import chip_smoke
    from jax.sharding import NamedSharding, PartitionSpec as P

    from agp_tpu.parallel.mesh import build_svi_trainer, make_mesh, shard_batch

    mesh = make_mesh(8)
    M = 16
    if program == "sharded_svi_step":
        m, X, y = _flagship_like(agp.AnalyticSVI(128))
        steps, m, s, Xs, ys = build_svi_trainer(m, X, y, mesh)
        hlo = steps.lower(m, s, Xs, ys, 2).compile().as_text()
    else:
        kappa = shard_batch(mesh, jax.random.normal(jax.random.PRNGKey(0), (512, M)))
        theta = shard_batch(mesh, jax.random.uniform(jax.random.PRNGKey(1), (512,)))

        def stats(k, t):
            if program == "gathered_batch":
                k = jax.lax.with_sharding_constraint(k, NamedSharding(mesh, P()))
            return jnp.einsum("bm,b,bn->mn", k, t, k)

        hlo = jax.jit(stats).lower(kappa, theta).compile().as_text()
    assert chip_smoke.collectives(hlo), "no collective found: the mesh did not shard"
    stray = chip_smoke.stray_collectives(hlo, M)
    assert bool(stray) is (program == "gathered_batch"), stray


@pytest.mark.parametrize("other,passes", [
    ("the same samples", True), ("an independent run", True), ("shifted by 0.5", False),
])
def test_posterior_mean_z(other, passes):
    """chip_smoke's Gibbs comparison: two runs of one posterior pass, a
    run whose mean is off by a constant fails."""
    import chip_smoke

    rng = np.random.default_rng(0)

    def run():  # 8 chains x 1000 AR(1) samples at 256 points
        e = rng.standard_normal((8, 1000, 256))
        f = np.empty_like(e)
        f[:, 0] = e[:, 0]
        for t in range(1, 1000):
            f[:, t] = 0.9 * f[:, t - 1] + np.sqrt(1 - 0.81) * e[:, t]
        return f

    a = run()
    b = {"the same samples": a, "an independent run": run(),
         "shifted by 0.5": a + 0.5}[other]
    z, _ = chip_smoke.posterior_mean_z(a, b, 100)
    assert (z <= chip_smoke.MC_Z_LIMIT) is passes, z
