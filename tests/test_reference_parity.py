"""The XLA CAVI path against the plain float64 numpy CAVI
(agp_tpu/reference.py) and against itself in float64, plus the device
policy and the helpers of chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import agp_tpu as agp
from agp_tpu import config
from agp_tpu.inference import analytic_vi
from agp_tpu.inference.analytic_vi import variational_update
from agp_tpu.reference import max_rel_err, rbf, svgp_cavi
from agp_tpu.training.train import init_state

N, D, M, B, STEPS = 1000, 3, 24, 200, 8


def _f32(tree):
    """Cast every floating leaf to float32 (the tests run with x64 on)."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree,
    )


def _data(seed=0, d=D):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (N, d))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    idx = [rng.integers(0, N, B) for _ in range(STEPS)]
    return X, f, idx


def _likelihood(name, f):
    binary = np.where(f > 0, 1.0, -1.0)
    counts = np.floor(3 * np.exp(f))
    return {
        "logistic": (agp.LogisticLikelihood.create(), binary, {}),
        "gaussian": (agp.GaussianLikelihood.create(0.05, opt_noise=False), f,
                     {"sigma2": 0.05}),
        "studentt": (agp.StudentTLikelihood.create(4.0), f, {"nu": 4.0, "sigma": 1.0}),
        "laplace": (agp.LaplaceLikelihood.create(0.5), f, {"beta": 0.5}),
        "bayesiansvm": (agp.BayesianSVM.create(), binary, {}),
        "matern32": (agp.Matern32Likelihood.create(0.7), f, {"rho": 0.7}),
        "negbinomial": (agp.NegBinomialLikelihood.create(5.0), counts, {"r": 5.0}),
        "poisson": (agp.PoissonLikelihood.create(2.0), counts, {"lam": 2.0}),
    }[name]


def _jax_steps(model, X, y, idx, dtype, rho=N / B):
    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    if dtype == jnp.float32:
        model = _f32(model)
    Xj, yj = jnp.asarray(X, dtype), jnp.asarray(y2, dtype)
    state = init_state(model, Xj, yj)
    state = state.replace(rho=jnp.asarray(rho, dtype))
    step = jax.jit(variational_update)
    for i in idx:
        model, state = step(model, state, Xj[i], yj[i])
    return model, state, np.asarray(y2)


LIKS = ["logistic", "gaussian", "studentt", "laplace", "bayesiansvm",
        "matern32", "negbinomial", "poisson"]


@pytest.mark.parametrize("name", LIKS)
def test_f32_step_matches_float64_reference(name):
    """Eight CAVI steps in float32 through the XLA path against the float64
    numpy iteration: f32 rounding of the cond(Kmm)-amplified kappa product
    leaves ~1e-5 relative error here; 5e-4 bounds it 10x over."""
    X, f, idx = _data()
    lik, y, params = _likelihood(name, f)
    m = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(1.3)), lik,
                        agp.AnalyticSVI(B), Z=X[:M], optimiser=None)
    m, s, y2 = _jax_steps(m, X, y, idx, jnp.float32)
    ref = svgp_cavi([(X[i], y2[i]) for i in idx], X[:M], 1.3, 1.0, name, params,
                    rho=N / B, jitter=config.jitter(jnp.float32))
    assert max_rel_err(s.mu[0], ref["mu"]) < 5e-4
    assert max_rel_err(s.Sigma[0], ref["Sigma"]) < 5e-4
    np.testing.assert_allclose(np.asarray(s.local_vars["theta"]),
                               ref["local"]["theta"], rtol=2e-3, atol=1e-5)
    if name == "poisson":
        np.testing.assert_allclose(float(m.likelihood.lam), ref["params"]["lam"],
                                   rtol=1e-4)


@pytest.mark.parametrize("case", ["stochastic", "exact", "ard"])
def test_reference_matches_jax_float64(case):
    """In float64 the numpy iteration and the XLA path are the same
    arithmetic up to roundoff."""
    X, f, idx = _data(seed=1)
    ls = np.array([1.3, 0.8, 2.0]) if case == "ard" else 1.3
    inf = agp.AnalyticVI() if case == "exact" else agp.AnalyticSVI(B)
    batches = [np.arange(N)] * 3 if case == "exact" else idx
    m = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(ls)),
                        agp.LogisticLikelihood.create(), inf, Z=X[:M], optimiser=None)
    y = np.where(f > 0, 1.0, -1.0)
    rho = 1.0 if case == "exact" else N / B
    _, s, _ = _jax_steps(m, X, y, batches, jnp.float64, rho)
    ref = svgp_cavi([(X[i], y[i]) for i in batches], X[:M], ls, 1.0, rho=rho,
                    jitter=config.jitter(jnp.float64), stochastic=case != "exact")
    assert max_rel_err(s.mu[0], ref["mu"]) < 1e-7
    assert max_rel_err(s.Sigma[0], ref["Sigma"]) < 1e-7


def test_ard_f32_step_matches_reference():
    X, f, idx = _data(seed=2)
    ls = np.array([0.9, 1.7, 3.0])
    m = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(ls)),
                        agp.LogisticLikelihood.create(), agp.AnalyticSVI(B),
                        Z=X[:M], optimiser=None)
    y = np.where(f > 0, 1.0, -1.0)
    _, s, _ = _jax_steps(m, X, y, idx, jnp.float32)
    ref = svgp_cavi([(X[i], y[i]) for i in idx], X[:M], ls, 1.0, rho=N / B,
                    jitter=config.jitter(jnp.float32))
    assert max_rel_err(s.mu[0], ref["mu"]) < 5e-4
    assert max_rel_err(s.Sigma[0], ref["Sigma"]) < 5e-4


@pytest.fixture
def f32_jitter_in_f64(monkeypatch):
    """float64 runs with float32's jitter, so that the two differ only in
    rounding."""
    monkeypatch.setitem(config._JITTER, jnp.dtype(jnp.float64),
                        config.jitter(jnp.float32))


@pytest.mark.parametrize("family", ["multiclass", "heteroscedastic"])
def test_multilatent_f32_step_matches_float64(family, f32_jitter_in_f64):
    X, f, idx = _data(seed=3)
    if family == "multiclass":
        lik = agp.LogisticSoftMaxLikelihood.create(3)
        y = np.digitize(f, [-0.5, 0.5])
    else:
        lik = agp.HeteroscedasticLikelihood.create()
        y = f + 0.1 * np.random.default_rng(4).standard_normal(N)

    def run(dtype):
        m = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(1.3)),
                            lik, agp.AnalyticSVI(B), Z=X[:M], optimiser=None)
        return _jax_steps(m, X, y, idx, dtype)[1]

    s32, s64 = run(jnp.float32), run(jnp.float64)
    assert s32.mu.dtype == jnp.float32
    assert max_rel_err(s32.mu, s64.mu) < 5e-3
    assert max_rel_err(s32.Sigma, s64.Sigma) < 5e-3


def test_numerical_vi_moments_match_reference():
    """QuadratureVI reads the latent moments through the same kappa path."""
    from agp_tpu.inference.analytic_vi import latent_moments

    X, f, _ = _data(seed=5)
    m = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(1.3)),
                        agp.LogisticLikelihood.create(), agp.QuadratureSVI(B),
                        Z=X[:M], optimiser=None)
    s = init_state(m, jnp.asarray(X), jnp.asarray(np.sign(f)))
    rng = np.random.default_rng(6)
    mu = rng.standard_normal(M)
    A = rng.standard_normal((M, M))
    Sigma = A @ A.T / M + np.eye(M)
    s = s.replace(mu=jnp.asarray(mu)[None], Sigma=jnp.asarray(Sigma)[None])
    mf, vf, _ = latent_moments(m, s, jnp.asarray(X[:B]), s.kmat)
    jitt = config.jitter(jnp.float64)
    Kinv = np.linalg.inv(rbf(X[:M], X[:M], 1.3, 1.0) + jitt * np.eye(M))
    Knm = rbf(X[:B], X[:M], 1.3, 1.0)
    kappa = Knm @ Kinv
    vf_ref = (1.0 + jitt - (kappa * Knm).sum(1)) + ((kappa @ Sigma) * kappa).sum(1)
    np.testing.assert_allclose(np.asarray(mf[0]), kappa @ mu, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(vf[0]), vf_ref, rtol=1e-7, atol=1e-9)


def test_hyper_gradient_through_kappa_matches_finite_differences():
    from agp_tpu.inference.objective import objective

    X, f, _ = _data(seed=7)
    m = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(1.3)),
                        agp.LogisticLikelihood.create(), agp.AnalyticVI(),
                        Z=X[:M], optimiser=None)
    y = jnp.asarray(np.where(f > 0, 1.0, -1.0))
    Xj = jnp.asarray(X)
    m, s = agp.train(m, Xj, y, iterations=3)

    def elbo(log_ls):
        k = m.kernel.replace(lengthscale=jnp.exp(log_ls) * jnp.ones_like(m.kernel.lengthscale))
        m2 = m.replace(kernel=k)
        return objective(m2, s, Xj, y, kmat=analytic_vi.compute_kmat(m2, Xj))

    x0, h = np.log(1.3), 1e-5
    g = float(jax.grad(elbo)(jnp.asarray(x0)))
    fd = (float(elbo(jnp.asarray(x0 + h))) - float(elbo(jnp.asarray(x0 - h)))) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=1e-4)


@pytest.mark.parametrize("platform", ["cpu", "gpu", "tpu"])
def test_solver_defaults_do_not_depend_on_the_device(platform, monkeypatch):
    """Newton-Schulz moments and the CG Gibbs resample are chosen by matrix
    size alone, whatever the backend."""
    from agp_tpu.inference.gibbs import CG_MIN_N, _use_cg_solver

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.delenv("AGP_TPU_FAST_MOMENTS", raising=False)
    for dim in (64, 512, 2048):
        want = dim <= analytic_vi.FAST_MOMENTS_MAX_DIM
        assert analytic_vi._fast_moments_enabled(dim) is want
    for n in (40, 1024, 2048):
        X = jnp.zeros((n, 2))
        mg = agp.MCGP.create(X, np.ones(n), agp.SqExponentialKernel(),
                             agp.LogisticLikelihood.create(), agp.GibbsSampling())
        assert _use_cg_solver(mg) is (n >= CG_MIN_N)


def test_kappa_precision_names_an_explicit_algorithm(monkeypatch):
    monkeypatch.delenv("AGP_TPU_KAPPA_PRECISION", raising=False)
    alg = analytic_vi._kappa_precision(jnp.float32)
    assert isinstance(alg, jax.lax.DotAlgorithmPreset)
    assert alg is analytic_vi.KAPPA_ALGORITHM
    assert analytic_vi._kappa_precision(jnp.float64) is None
    monkeypatch.setenv("AGP_TPU_KAPPA_PRECISION", "tf32_tf32_f32")
    assert analytic_vi._kappa_precision(jnp.float32) is jax.lax.DotAlgorithmPreset.TF32_TF32_F32


def _tf32_dot(a, b):
    """a @ b with both operands rounded to TF32's 10 mantissa bits."""
    def rnd(x):
        m, e = np.frexp(x)
        return np.ldexp(np.round(m * 2.0**11) / 2.0**11, e)

    return rnd(a) @ rnd(b)


@pytest.mark.parametrize("b,m", [(1, 16), (32, 1)])
def test_f32_step_with_one_row_or_one_inducing_point(b, m):
    """A one-row batch or a single inducing point makes kappa a
    matrix-vector product, which runs in exact float32 on every backend."""
    X = np.random.default_rng(0).standard_normal((200, 5)).astype(np.float32)
    model = agp.SVGP.create(agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
                            agp.AnalyticSVI(b), X[:m], optimiser=None)
    assert (analytic_vi._kappa_precision(jnp.float32, b, m)
            is jax.lax.DotAlgorithmPreset.F32_F32_F32)
    _, state = agp.train(model, X, np.sign(X[:, 0]), iterations=3)
    assert state.mu.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(state.mu)))


def test_parity_check_catches_a_tf32_kappa():
    """At the flagship's shape and conditioning (D=20, M=64, lengthscale 2)
    the smoke's step-parity check passes float32-rounded kappa operands and
    fails TF32-rounded ones."""
    import chip_smoke

    rng = np.random.default_rng(8)
    X = rng.standard_normal((20_000, 20))
    y = np.where(X @ rng.standard_normal(20) > 0, 1.0, -1.0)
    idx = [rng.integers(0, 20_000, 4096) for _ in range(20)]
    batches = [(X[i], y[i]) for i in idx]
    kw = dict(Z=X[:64], lengthscale=2.0, variance=1.0, rho=20_000 / 4096)
    ref = svgp_cavi(batches, **kw)

    def f32_dot(a, b):
        return a.astype(np.float32).astype(np.float64) @ b.astype(np.float32).astype(np.float64)

    for dot, ok in ((f32_dot, True), (_tf32_dot, False)):
        out = svgp_cavi(batches, kappa_dot=dot, **kw)
        errs = chip_smoke.parity_errors(out["mu"], out["Sigma"], ref["mu"], ref["Sigma"])
        assert chip_smoke.parity_ok(errs) is ok, (dot.__name__, errs)


def test_chip_smoke_refuses_a_cpu():
    import chip_smoke

    devs = jax.devices("cpu")
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.require_gpu(devs)
    assert chip_smoke.require_gpu(devs, rehearse=True) == "cpu"


@pytest.mark.parametrize("preset", [None, "/data/jax-cache"])
def test_compile_cache_directory_rule(preset, tmp_path):
    import chip_smoke

    env = {} if preset is None else {"JAX_COMPILATION_CACHE_DIR": preset}
    got = chip_smoke.use_compile_cache(env, root=str(tmp_path))
    want = preset if preset is not None else str(tmp_path / ".jax_cache")
    assert got == want
    assert env["JAX_COMPILATION_CACHE_DIR"] == want
