"""End-to-end smoke + math-parity tests for the core spine:
kernels, linalg, GP exact, SVGP/VGP + AnalyticVI + Gaussian/Logistic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import agp_tpu as agp
from agp_tpu.ops import linalg
from tests.testingtools import generate_f


def test_kernel_gram_psd():
    k = agp.SqExponentialKernel(lengthscale=jnp.asarray(0.5), variance=jnp.asarray(2.0))
    X = jax.random.normal(jax.random.PRNGKey(0), (20, 3), dtype=jnp.float64)
    K = k.gram(X, X)
    assert K.shape == (20, 20)
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    evals = np.linalg.eigvalsh(np.asarray(K))
    assert evals.min() > -1e-8
    np.testing.assert_allclose(np.diag(K), np.asarray(k.diag(X)), atol=1e-12)


def test_kernel_matches_manual_rbf():
    k = agp.SqExponentialKernel(lengthscale=jnp.asarray(0.7))
    X = np.random.RandomState(0).randn(5, 2)
    K = np.asarray(k.gram(jnp.asarray(X), jnp.asarray(X)))
    for i in range(5):
        for j in range(5):
            d2 = np.sum((X[i] - X[j]) ** 2) / 0.7**2
            assert abs(K[i, j] - np.exp(-0.5 * d2)) < 1e-10


def test_nat_moment_roundtrip():
    key = jax.random.PRNGKey(1)
    A = jax.random.normal(key, (6, 6), dtype=jnp.float64)
    Sigma = A @ A.T + 6 * jnp.eye(6)
    mu = jnp.arange(6.0)
    eta1, eta2 = linalg.moments_to_nat(mu, Sigma)
    mu2, Sigma2 = linalg.nat_to_moments(eta1, eta2)
    np.testing.assert_allclose(mu, mu2, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(Sigma, Sigma2, rtol=1e-8, atol=1e-10)


def test_gp_exact_regression():
    kern = agp.SqExponentialKernel()
    X, f = generate_f(40, 2, kern)
    y = f + 0.01 * jax.random.normal(jax.random.PRNGKey(3), f.shape, dtype=jnp.float64)
    model = agp.GP.create(X, y, kern, noise=1e-2, opt_noise=False, optimiser=None)
    model, state = agp.train(model, iterations=2)
    mu = agp.predict_f(model, state, X)
    assert jnp.mean(jnp.abs(mu - f)) < 0.1
    mu_p, var_p = agp.proba_y(model, state, X)
    assert jnp.all(var_p > 0)


def test_gp_marginal_lik_increases_with_hyperopt():
    # reference oracle: marginal likelihood improves over training
    # (/root/reference/test/likelihood/gaussian.jl:29-31)
    from agp_tpu.models.gp import log_py

    kern = agp.SqExponentialKernel(lengthscale=jnp.asarray(3.0))
    X, f = generate_f(30, 2, agp.SqExponentialKernel())
    y = f + 0.05 * jax.random.normal(jax.random.PRNGKey(4), f.shape, dtype=jnp.float64)
    model = agp.GP.create(X, y, kern, noise=1e-1)
    model, state = agp.train(model, iterations=2)
    l0 = float(log_py(model, state))
    model, state = agp.train(model, state=state, iterations=20)
    l1 = float(log_py(model, state))
    assert l1 > l0


def test_svgp_gaussian_analyticvi():
    kern = agp.SqExponentialKernel()
    X, f = generate_f(60, 2, kern)
    y = f + 0.05 * jax.random.normal(jax.random.PRNGKey(5), f.shape, dtype=jnp.float64)
    Z = X[:15]
    lik = agp.GaussianLikelihood.create(0.05, opt_noise=False)
    model = agp.SVGP.create(kern, lik, agp.AnalyticVI(), Z, optimiser=None)
    state = None
    elbos = []
    model, state = agp.train(model, X, y, iterations=1, state=state)
    elbos.append(float(agp.elbo(model, state, X, y)))
    model, state = agp.train(model, X, y, iterations=10, state=state)
    elbos.append(float(agp.elbo(model, state, X, y)))
    assert elbos[1] >= elbos[0] - 1e-6
    mu = agp.predict_f(model, state, X)
    assert float(jnp.mean(jnp.abs(mu - f))) < 0.3
    m, v = agp.proba_y(model, state, X)
    assert jnp.all(v > 0)


def test_svgp_cavi_one_step_closed_form():
    """Golden parity: one non-stochastic CAVI step must match the closed-form
    update equations (reference: analyticVI.jl:160-180) computed by hand."""
    kern = agp.SqExponentialKernel()
    X, f = generate_f(20, 2, kern)
    y = f
    Z = X[:7]
    lik = agp.GaussianLikelihood.create(0.1, opt_noise=False)
    model = agp.SVGP.create(kern, lik, agp.AnalyticVI(), Z, optimiser=None)
    state = agp.init_state(model, X, y)
    model2, state2 = agp.train(model, X, y, iterations=1, state=state)

    # manual computation
    from agp_tpu.config import jitter

    jitt = jitter(X.dtype)
    Kmm = kern.gram(Z, Z) + jitt * jnp.eye(7)
    Kinv = jnp.linalg.inv(Kmm)
    Knm = kern.gram(X, Z)
    kappa = Knm @ Kinv
    theta = jnp.full((20,), 1.0 / 0.1)
    eta1_expected = kappa.T @ (y / 0.1)
    eta2_expected = -(kappa.T @ jnp.diag(theta / 2.0) @ kappa + Kinv / 2.0)
    np.testing.assert_allclose(state2.eta1[0], eta1_expected, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(state2.eta2[0], eta2_expected, rtol=1e-6, atol=1e-8)
    Sigma_expected = jnp.linalg.inv(-2.0 * eta2_expected)
    mu_expected = Sigma_expected @ eta1_expected
    np.testing.assert_allclose(state2.mu[0], mu_expected, rtol=1e-6, atol=1e-8)


def test_vgp_logistic_classification():
    kern = agp.SqExponentialKernel()
    X, f = generate_f(50, 2, kern)
    y = np.asarray(f > 0, dtype=float) * 2 - 1
    lik = agp.LogisticLikelihood.create()
    model = agp.VGP.create(X, y, kern, lik, agp.AnalyticVI(), optimiser=None)
    model, state = agp.train(model, iterations=20)
    pred = agp.predict_y(model, state, X)
    err = float(jnp.mean(pred != jnp.asarray(y)))
    assert err < 0.3
    p = agp.proba_y(model, state, X)
    assert jnp.all((p >= 0) & (p <= 1))


def test_svgp_logistic_svi():
    kern = agp.SqExponentialKernel()
    X, f = generate_f(200, 2, kern)
    y = np.asarray(f > 0, dtype=float) * 2 - 1
    Z = X[:20]
    lik = agp.LogisticLikelihood.create()
    model = agp.SVGP.create(kern, lik, agp.AnalyticSVI(32), Z, optimiser=None)
    model, state = agp.train(model, X, y, iterations=100)
    pred = agp.predict_y(model, state, X)
    err = float(jnp.mean(pred != jnp.asarray(y)))
    assert err < 0.35


def test_hyperopt_improves_elbo():
    kern = agp.SqExponentialKernel(lengthscale=jnp.asarray(5.0))
    X, f = generate_f(40, 2, agp.SqExponentialKernel())
    y = f + 0.05 * jax.random.normal(jax.random.PRNGKey(7), f.shape, dtype=jnp.float64)
    lik = agp.GaussianLikelihood.create(0.05, opt_noise=False)
    import optax

    model_no = agp.SVGP.create(kern, lik, agp.AnalyticVI(), X[:10], optimiser=None)
    m1, s1 = agp.train(model_no, X, y, iterations=30)
    model_opt = agp.SVGP.create(
        kern, lik, agp.AnalyticVI(), X[:10], optimiser=optax.adam(0.05)
    )
    m2, s2 = agp.train(model_opt, X, y, iterations=30)
    e1 = float(agp.elbo(m1, s1, X, y))
    e2 = float(agp.elbo(m2, s2, X, y))
    assert e2 > e1


def test_svgp_stochastic_step_golden():
    """One AnalyticSVI step from init must equal the hand-computed
    Robbins-Monro-scaled stochastic natural gradient
    (reference: analyticVI.jl:160-180, optimisers.jl:1-19)."""
    from agp_tpu.config import jitter
    from agp_tpu.training.train import _vi_step, init_state

    kern = agp.SqExponentialKernel()
    X, f = generate_f(40, 2, kern)
    y = f
    Z = X[:6]
    b = 8
    lik = agp.GaussianLikelihood.create(0.2, opt_noise=False)
    model = agp.SVGP.create(kern, lik, agp.AnalyticSVI(b), Z, optimiser=None)
    key = jax.random.PRNGKey(123)
    state = agp.init_state(model, X, y, key=key)
    model2, state2 = _vi_step(model, state, X, y)

    # reproduce the device-side batch draw (fold_in(key, step=0); int32
    # indices in every precision mode)
    sub = jax.random.fold_in(key, 0)
    idx = jax.random.randint(sub, (b,), 0, X.shape[0], jnp.int32)
    xb, yb = X[idx], y[idx]
    jitt = jitter(X.dtype)
    Kmm = kern.gram(Z, Z) + jitt * jnp.eye(6)
    Kinv = jnp.linalg.inv(Kmm)
    kappa = kern.gram(xb, Z) @ Kinv
    rho = 40.0 / b
    gmu = yb / 0.2
    theta = jnp.full((b,), 1.0 / 0.2)
    d1 = kappa.T @ (rho * gmu) - 0.0  # eta1_0 = 0, mu0 = 0
    d2 = -(kappa.T @ jnp.diag(rho * theta / 2.0) @ kappa + Kinv / 2.0) - (
        -0.5 * jnp.eye(6)
    )
    lr = 1.0  # RobbinsMonro (tau + 0)^-kappa = 1
    eta1_expected = lr * d1
    eta2_expected = -0.5 * jnp.eye(6) + lr * d2
    np.testing.assert_allclose(state2.eta1[0], eta1_expected, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(state2.eta2[0], eta2_expected, rtol=1e-6, atol=1e-9)


def test_svgp_slice_sampling_converges():
    """slice minibatching (contiguous windows over pre-shuffled data) reaches
    the same quality as iid gather sampling."""
    kern = agp.SqExponentialKernel()
    X, f = generate_f(200, 2, kern)
    y = np.asarray(f > 0, dtype=float) * 2 - 1
    lik = agp.LogisticLikelihood.create()
    model = agp.SVGP.create(
        kern, lik, agp.AnalyticSVI(32, minibatch_sampling="slice"), X[:20],
        optimiser=None,
    )
    model, state = agp.train(model, X, y, iterations=100)
    err = float(jnp.mean(agp.predict_y(model, state, X) != jnp.asarray(y)))
    assert err < 0.35


@pytest.mark.parametrize("mode", ["gather", "slice", "block", "block:8"])
def test_scan_precomputed_draws_match_per_step(mode):
    """The fused-scan driver precomputes all minibatch indices in one
    vectorized RNG pass before the scan (train.py::_precomputed_draws);
    indices must be BIT-identical to the per-step fold_in draws, so the
    two drivers produce the same trajectory to compilation roundoff."""
    from agp_tpu.training.train import _vi_step, _vi_steps, init_state

    kern = agp.SqExponentialKernel()
    X = jax.random.normal(jax.random.PRNGKey(0), (512, 3), jnp.float64)
    y = np.asarray(jnp.sign(X[:, 0]))
    m = agp.SVGP.create(
        kern, agp.LogisticLikelihood.create(),
        agp.AnalyticSVI(64, minibatch_sampling=mode), X[:16], optimiser=None,
    )
    y2, tl = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=tl)
    y2 = jnp.asarray(y2, jnp.float64)
    s0 = init_state(m, X, y2)
    m1, s1 = m, s0
    for _ in range(7):
        m1, s1 = _vi_step(m1, s1, X, y2)
    m2, s2 = _vi_steps(m, s0, X, y2, 7)
    assert int(s2.step) == 7
    np.testing.assert_allclose(
        np.asarray(s1.mu), np.asarray(s2.mu), rtol=0, atol=1e-12
    )


def test_block_sampling_multiclass_one_hot_labels():
    """Block mode must handle labels with trailing dims (multiclass one-hot
    [N, K]) -- round-5 regression: the tile view reshaped y assuming 1-D."""
    from agp_tpu.training.train import _vi_steps, init_state

    X = jax.random.normal(jax.random.PRNGKey(0), (256, 3), jnp.float64)
    y = np.asarray(
        jnp.argmin(
            jnp.sum((X[:, None, :2] - jnp.eye(2)[None] * 1.5) ** 2, -1), axis=1
        )
    )
    m = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticSoftMaxLikelihood.create(2),
        agp.AnalyticSVI(64, minibatch_sampling="block"), X[:12], optimiser=None,
    )
    y2, tl = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=tl)
    y2 = jnp.asarray(y2, jnp.float64)
    s0 = init_state(m, X, y2)
    m2, s2 = _vi_steps(m, s0, X, y2, 10)
    assert bool(jnp.all(jnp.isfinite(s2.mu)))


def test_block_tile_parsing():
    """Malformed or non-positive "block:<n>" suffixes yield None (iid-gather
    fallback) instead of raising at trace time (round-4 advisor finding)."""
    from agp_tpu.training.train import block_tile

    assert block_tile("block") == 64
    assert block_tile("block", 4096) == 64  # default tile divides b
    assert block_tile("block", 32) == 32  # halved until it divides b
    assert block_tile("block", 48) == 16
    assert block_tile("block:16") == 16
    assert block_tile("block:x") is None
    assert block_tile("block:0") is None
    assert block_tile("block:-4") is None


@pytest.mark.parametrize("mode", ["block", "block:8", "block:48", "block:x"])
def test_svgp_block_sampling_converges(mode):
    """block minibatching (random aligned n-row tiles -- larger HBM
    transactions than iid gather, same estimator class) reaches the same
    quality as gather/slice sampling.  "block" defaults to 32-row tiles
    (b=32 -> one tile per batch); "block:8" picks the height explicitly;
    "block:48" does not divide b=32 and "block:x" is malformed -- both must
    fall back to the iid gather rather than crash."""
    kern = agp.SqExponentialKernel()
    X, f = generate_f(200, 2, kern)
    y = np.asarray(f > 0, dtype=float) * 2 - 1
    lik = agp.LogisticLikelihood.create()
    model = agp.SVGP.create(
        kern, lik, agp.AnalyticSVI(32, minibatch_sampling=mode), X[:20],
        optimiser=None,
    )
    model, state = agp.train(model, X, y, iterations=100)
    err = float(jnp.mean(agp.predict_y(model, state, X) != jnp.asarray(y)))
    assert err < 0.35


def test_sample_f_joint_predictive():
    kern = agp.SqExponentialKernel()
    X, f = generate_f(30, 2, kern)
    m = agp.SVGP.create(kern, agp.GaussianLikelihood.create(1e-3, opt_noise=False),
                        agp.AnalyticVI(), X[:10], optimiser=None)
    m, s = agp.train(m, X, np.asarray(f), iterations=10)
    fs = agp.sample_f(m, s, X[:12], n_samples=200, key=jax.random.PRNGKey(0))
    assert fs.shape == (200, 12)
    mu, var = agp.predict_f(m, s, X[:12], cov=True)
    # empirical moments match the predictive
    np.testing.assert_allclose(np.asarray(fs.mean(0)), np.asarray(mu), atol=0.2)


def test_nonzero_prior_mean_paths():
    """ConstantMean flows through the natural-gradient K^-1 mu0 terms and
    hyperopt (exercises code paths that ZeroMean short-circuits)."""
    import optax

    kern = agp.SqExponentialKernel()
    X, f = generate_f(40, 2, kern)
    y = np.asarray(f) + 3.0  # shifted data: a constant mean should help
    m0 = agp.SVGP.create(kern, agp.GaussianLikelihood.create(0.05, opt_noise=False),
                         agp.AnalyticVI(), X[:10],
                         mean=agp.ConstantMean(c=jnp.asarray(3.0)), optimiser=None)
    m0, s0 = agp.train(m0, X, y, iterations=20)
    mae = float(jnp.mean(jnp.abs(agp.predict_f(m0, s0, X) - jnp.asarray(y))))
    assert mae < 0.5
    # trainable mean from wrong init moves toward 3
    m1 = agp.SVGP.create(kern, agp.GaussianLikelihood.create(0.05, opt_noise=False),
                         agp.AnalyticVI(), X[:10],
                         mean=agp.ConstantMean(c=jnp.asarray(0.0)),
                         optimiser=optax.adam(0.2))
    m1, s1 = agp.train(m1, X, y, iterations=60)
    assert float(m1.mean.c[0]) > 1.0


def test_affine_mean_vgp():
    kern = agp.SqExponentialKernel()
    X, f = generate_f(30, 2, kern)
    y = np.asarray(f) + np.asarray(X @ jnp.asarray([2.0, -1.0]))
    mean = agp.AffineMean(w=jnp.asarray([2.0, -1.0]), b=jnp.asarray(0.0))
    m = agp.VGP.create(X, y, kern, agp.GaussianLikelihood.create(0.05, opt_noise=False),
                       agp.AnalyticVI(), mean=mean, optimiser=None)
    m, s = agp.train(m, iterations=15)
    mae = float(jnp.mean(jnp.abs(agp.predict_f(m, s, X) - jnp.asarray(y))))
    assert mae < 0.5
