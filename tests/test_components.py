"""Component-level tests mirroring the reference's test dirs
(test/data, test/prior, test/functions, test/inference constructors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import agp_tpu as agp
from agp_tpu import kernels as K
from agp_tpu import means as Mn


ALL_KERNELS = [
    agp.SqExponentialKernel(),
    agp.Matern12Kernel(),
    agp.Matern32Kernel(),
    agp.Matern52Kernel(),
    agp.RationalQuadraticKernel(),
    agp.PeriodicKernel(),
    agp.LinearKernel(),
    agp.PolynomialKernel(),
    agp.ConstantKernel(),
    agp.WhiteKernel(),
    agp.CosineKernel(),
    agp.ExponentiatedKernel(lengthscale=jnp.asarray(3.0)),
    agp.PiecewisePolynomialKernel(lengthscale=jnp.asarray(2.0), degree=0),
    agp.PiecewisePolynomialKernel(lengthscale=jnp.asarray(2.0), degree=1),
    agp.PiecewisePolynomialKernel(lengthscale=jnp.asarray(2.0), degree=2),
    agp.PiecewisePolynomialKernel(lengthscale=jnp.asarray(2.0), degree=3),
    agp.FBMKernel(hurst=jnp.asarray(0.4)),
    agp.GaborKernel(lengthscale=jnp.asarray(1.5), period=jnp.asarray(2.0)),
    agp.NeuralNetworkKernel(),
    agp.SqExponentialKernel() + agp.Matern32Kernel(),
    agp.SqExponentialKernel() * agp.LinearKernel(),
    2.5 * agp.SqExponentialKernel(),
    agp.with_transform(agp.SqExponentialKernel(), agp.ScaleTransform(s=jnp.asarray(0.7))),
    agp.with_transform(
        agp.Matern32Kernel(),
        agp.ChainTransform(
            transforms=(
                agp.SelectTransform(dims=(0, 2)),
                agp.ARDTransform(v=jnp.asarray([0.5, 2.0])),
            )
        ),
    ),
]


@pytest.mark.parametrize("kern", ALL_KERNELS, ids=lambda k: type(k).__name__)
def test_kernel_psd_and_diag(kern):
    X = jax.random.normal(jax.random.PRNGKey(0), (15, 3), dtype=jnp.float64)
    G = np.asarray(kern.gram(X, X))
    np.testing.assert_allclose(G, G.T, atol=1e-10)
    evals = np.linalg.eigvalsh(G)
    assert evals.min() > -1e-7
    np.testing.assert_allclose(np.diag(G), np.asarray(kern.diag(X)), atol=1e-10)


def test_fbm_hurst_unit_constrained():
    """FBM's Hurst index lives in (0,1): the unconstrained mapping is
    logit/sigmoid (UNIT_PARAMS), so arbitrarily large optimizer steps can
    never push h past 1 (which would make the kernel non-PSD)."""
    from agp_tpu.kernels import from_unconstrained, to_unconstrained

    k = agp.FBMKernel(hurst=jnp.asarray(0.4))
    u = to_unconstrained(k)
    # round trip
    k2 = from_unconstrained(u)
    np.testing.assert_allclose(float(k2.hurst), 0.4, rtol=1e-12)
    np.testing.assert_allclose(float(k2.variance), 1.0, rtol=1e-12)
    # a huge positive step in unconstrained space saturates at h = 1 (the
    # PSD boundary: FBM at h=1 degenerates to the linear kernel) instead of
    # shooting past it as the old log-space mapping did
    u_big = u.replace(hurst=u.hurst + 50.0)
    k3 = from_unconstrained(u_big)
    assert 0.0 < float(k3.hurst) <= 1.0
    # gram is still PSD at the saturated value
    X = jax.random.normal(jax.random.PRNGKey(0), (12, 2), dtype=jnp.float64)
    evals = np.linalg.eigvalsh(np.asarray(k3.gram(X, X)))
    assert np.isfinite(evals).all() and evals.min() > -1e-7


def test_kernel_ard_lengthscale():
    k = agp.SqExponentialKernel(lengthscale=jnp.asarray([0.5, 2.0]))
    X = jax.random.normal(jax.random.PRNGKey(1), (10, 2), dtype=jnp.float64)
    G = np.asarray(k.gram(X, X))
    Xs = np.asarray(X) / np.array([0.5, 2.0])
    d2 = ((Xs[:, None] - Xs[None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(G, np.exp(-0.5 * d2), atol=1e-10)


def test_input_transforms():
    X = jax.random.normal(jax.random.PRNGKey(3), (12, 3), dtype=jnp.float64)
    base = agp.SqExponentialKernel()
    # ScaleTransform(s) == lengthscale 1/s
    ks = agp.with_transform(base, agp.ScaleTransform(s=jnp.asarray(0.5)))
    keq = agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0))
    np.testing.assert_allclose(
        np.asarray(ks.gram(X, X)), np.asarray(keq.gram(X, X)), atol=1e-12
    )
    # ARDTransform(v) == ARD lengthscale 1/v
    v = jnp.asarray([0.5, 1.0, 4.0])
    ka = agp.with_transform(base, agp.ARDTransform(v=v))
    keq = agp.SqExponentialKernel(lengthscale=1.0 / v)
    np.testing.assert_allclose(
        np.asarray(ka.gram(X, X)), np.asarray(keq.gram(X, X)), atol=1e-12
    )
    # LinearTransform == gram over projected inputs
    A = jnp.asarray(np.random.RandomState(0).randn(2, 3))
    kl = agp.with_transform(base, agp.LinearTransform(A=A))
    np.testing.assert_allclose(
        np.asarray(kl.gram(X, X)), np.asarray(base.gram(X @ A.T, X @ A.T)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(kl.diag(X)), np.diag(np.asarray(kl.gram(X, X))), atol=1e-12
    )
    # SelectTransform == slicing; FunctionTransform == applying fn
    ksel = agp.with_transform(base, agp.SelectTransform(dims=(1,)))
    np.testing.assert_allclose(
        np.asarray(ksel.gram(X, X)), np.asarray(base.gram(X[:, 1:2], X[:, 1:2])), atol=1e-12
    )
    kf = agp.with_transform(base, agp.FunctionTransform(fn=lambda x: jnp.sin(x)))
    np.testing.assert_allclose(
        np.asarray(kf.gram(X, X)), np.asarray(base.gram(jnp.sin(X), jnp.sin(X))), atol=1e-12
    )


def test_unconstrained_mapping_free_params():
    """to/from_unconstrained: log on positive leaves, identity on
    FREE_PARAMS (LinearTransform.A is sign-indefinite)."""
    from agp_tpu.kernels import from_unconstrained, to_unconstrained

    A = jnp.asarray([[1.0, -2.0], [0.5, 3.0]])
    k = agp.with_transform(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0)),
        agp.LinearTransform(A=A),
    )
    u = to_unconstrained(k)
    np.testing.assert_allclose(np.asarray(u.transform.A), np.asarray(A))  # untouched
    np.testing.assert_allclose(np.asarray(u.inner.lengthscale), np.log(2.0))
    k2 = from_unconstrained(u)
    assert not np.isnan(np.asarray(k2.transform.A)).any()
    np.testing.assert_allclose(np.asarray(k2.transform.A), np.asarray(A))
    np.testing.assert_allclose(np.asarray(k2.inner.lengthscale), 2.0, rtol=1e-12)


def test_transformed_kernel_hyperopt():
    """Hyper step trains a TransformedKernel: the projection matrix A moves
    unconstrained (no NaNs from log of a negative entry) and the ELBO
    improves."""
    key = jax.random.PRNGKey(7)
    X = jax.random.normal(key, (64, 3))
    f = jnp.sin(2.0 * X[:, 0]) + 0.3 * X[:, 2]
    y = f + 0.05 * jax.random.normal(jax.random.PRNGKey(8), (64,))
    A0 = jnp.asarray([[1.0, 0.2, -0.3], [0.0, 1.0, 0.5]])
    kern = agp.with_transform(
        agp.SqExponentialKernel(), agp.LinearTransform(A=A0)
    )
    m = agp.SVGP.create(
        kernel=kern,
        likelihood=agp.GaussianLikelihood.create(),
        inference=agp.AnalyticVI(),
        Z=np.asarray(X[:16]),
        atfrequency=2,
    )
    m, state = agp.train(m, X, y, iterations=30)
    A_after = np.asarray(m.kernel.transform.A)
    assert not np.isnan(A_after).any()
    assert np.abs(A_after - np.asarray(A0)).max() > 1e-6  # it actually moved
    # positive leaves stayed positive
    assert float(np.ravel(np.asarray(m.kernel.inner.lengthscale))[0]) > 0
    pred = agp.predict_y(m, state, X)
    assert np.isfinite(np.asarray(pred)).all()


def test_prior_means():
    X = jax.random.normal(jax.random.PRNGKey(2), (7, 3), dtype=jnp.float64)
    assert np.allclose(Mn.ZeroMean()(X), 0)
    assert np.allclose(Mn.ConstantMean(c=jnp.asarray(1.5))(X), 1.5)
    v = jnp.arange(7.0)
    assert np.allclose(Mn.EmpiricalMean(v=v)(X), np.arange(7.0))
    w = jnp.asarray([1.0, 0.0, -1.0])
    am = Mn.AffineMean(w=w, b=jnp.asarray(0.5))
    np.testing.assert_allclose(np.asarray(am(X)), np.asarray(X @ w + 0.5))
    # coercion (reference: convert(PriorMean, x))
    assert isinstance(Mn.as_mean(2.0), Mn.ConstantMean)
    assert isinstance(Mn.as_mean(np.zeros(4)), Mn.EmpiricalMean)


def test_mean_replicate_batch_call():
    m = Mn.replicate(Mn.ConstantMean(c=jnp.asarray(2.0)), 3)
    X = jnp.zeros((5, 2))
    out = Mn.batch_call(m, X, 3)
    assert out.shape == (3, 5)
    out0 = Mn.batch_call(Mn.ZeroMean(), X, 3)
    assert out0.shape == (3, 5) and np.allclose(out0, 0)


def test_robbins_monro_schedule():
    """Delta * (tau + n)^-kappa (reference: inference/optimisers.jl:1-19)."""
    from agp_tpu.utils.opt import ascent_update, robbins_monro

    opt = agp.robbins_monro()
    s = opt.init(jnp.zeros(2))
    g = jnp.asarray([1.0, -1.0])
    for n in range(3):
        s, u = ascent_update(opt, s, jnp.zeros(2), g)
        expected = (1.0 + n) ** (-0.51)
        np.testing.assert_allclose(np.asarray(u), np.asarray(g) * expected, rtol=1e-6)


def test_jitter_policy():
    from agp_tpu.config import jitter

    assert jitter(jnp.float64) == 1e-4
    assert jitter(jnp.float32) == 1e-3
    assert jitter(jnp.float16) == 1e-2


def test_label_treatment():
    lik = agp.LogisticLikelihood.create()
    y, _ = lik.treat_labels(np.array([0, 1, 1, 0]))
    np.testing.assert_array_equal(np.asarray(y), [-1, 1, 1, -1])
    y, _ = lik.treat_labels(np.array([-1, 1]))
    np.testing.assert_array_equal(np.asarray(y), [-1, 1])
    mc = agp.LogisticSoftMaxLikelihood.create(3)
    yh, mc2 = mc.treat_labels(np.array(["a", "b", "c", "a"]))
    assert yh.shape == (4, 3)
    assert mc2.class_mapping == ("a", "b", "c")
    np.testing.assert_array_equal(
        mc2.labels_from_indices([0, 2]), np.array(["a", "c"])
    )


def test_inducing_point_algorithms():
    from agp_tpu.inducing import KmeansAlg, OIPS, RandomSubset, UniGrid, inducingpoints

    X = np.random.RandomState(0).randn(200, 2)
    Z = inducingpoints(KmeansAlg(16), X)
    assert Z.shape == (16, 2)
    Z = inducingpoints(RandomSubset(10), X)
    assert Z.shape == (10, 2)
    Z = inducingpoints(UniGrid(5), X)
    assert Z.shape == (25, 2)
    Z = inducingpoints(OIPS(rho=0.8, capacity=64), X)
    assert 1 <= Z.shape[0] <= 64


def test_native_matches_python_kmeans():
    from agp_tpu.utils import native

    if not native.available():
        pytest.skip("no native lib")
    X = np.random.RandomState(0).randn(500, 3)
    C = native.kmeans(X, 8, n_iters=5)
    assert C.shape == (8, 3)
    # centers lie within the data bounding box
    assert C.min() >= X.min() - 1e-9 and C.max() <= X.max() + 1e-9


def test_special_functions():
    from agp_tpu.ops.special import besselk_half, logcosh, safe_expcosh
    from scipy.special import kv

    x = np.linspace(0.1, 5, 20)
    for nh, p in [(0, 0.5), (1, 1.5), (2, 2.5)]:
        np.testing.assert_allclose(
            np.asarray(besselk_half(nh, jnp.asarray(x))), kv(p, x), rtol=1e-10
        )
    c = jnp.asarray([0.0, 1.0, 50.0, 500.0])
    np.testing.assert_allclose(
        np.asarray(logcosh(c)), np.log(np.cosh(np.asarray(c[:3]).tolist() + [0])) [:3].tolist() + [500.0 - np.log(2.0)], rtol=1e-6
    )
    assert np.isfinite(float(safe_expcosh(jnp.asarray(300.0), jnp.asarray(400.0))))


def test_gauss_hermite_expectation():
    from agp_tpu.ops.quadrature import expectation

    # E[f^2] for f ~ N(mu, var) = mu^2 + var
    mu = jnp.asarray([0.5, -1.0])
    var = jnp.asarray([2.0, 0.3])
    e = expectation(lambda f: f**2, mu, var)
    np.testing.assert_allclose(np.asarray(e), [0.25 + 2.0, 1.0 + 0.3], rtol=1e-8)


def test_float32_end_to_end():
    """f32 inputs must train f32 throughout (the accelerator dtype),
    even with x64 globally enabled."""
    X = jax.random.uniform(jax.random.PRNGKey(0), (60, 2), dtype=jnp.float32) * 4
    f = jnp.sin(X[:, 0])
    y = np.sign(np.asarray(f)).astype(np.float32)
    kern = agp.SqExponentialKernel(
        lengthscale=jnp.asarray(1.0, jnp.float32), variance=jnp.asarray(1.0, jnp.float32)
    )
    m = agp.SVGP.create(kern, agp.LogisticLikelihood.create(),
                        agp.AnalyticSVI(16), X[:10], optimiser=None)
    m, s = agp.train(m, X, y, iterations=80)
    assert s.mu.dtype == jnp.float32
    acc = float(jnp.mean((agp.predict_f(m, s, X) > 0) == (jnp.asarray(y) > 0)))
    assert acc > 0.8


def test_plotting_ribbon(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from agp_tpu.utils.plotting import plot_gp

    X = jnp.linspace(0, 5, 40)[:, None]
    f = jnp.sin(X[:, 0])
    m = agp.SVGP.create(agp.SqExponentialKernel(),
                        agp.GaussianLikelihood.create(1e-2, opt_noise=False),
                        agp.AnalyticVI(), X[:8], optimiser=None)
    m, s = agp.train(m, X, np.asarray(f), iterations=10)
    ax = plot_gp(m, s, X, X_train=X, y_train=np.asarray(f))
    assert ax is not None
    import matplotlib.pyplot as plt

    plt.savefig(tmp_path / "ribbon.png")
    assert (tmp_path / "ribbon.png").stat().st_size > 0


def test_plotting_multioutput_and_multilatent(tmp_path):
    """MO recipe: one subplot per task with per-row ribbons
    (reference: functions/plotting.jl:44-73); plus the multi-latent branch."""
    import matplotlib

    matplotlib.use("Agg")
    from agp_tpu.utils.plotting import plot_mo_gp, plot_multilatent

    X = np.linspace(0, 5, 40)[:, None]
    f = np.sin(X[:, 0])
    y_cls = np.where(f > 0, 1.0, -1.0)
    mo = agp.MOSVGP.create(
        agp.SqExponentialKernel(),
        [agp.LogisticLikelihood.create(), agp.GaussianLikelihood.create(1e-2)],
        agp.AnalyticVI(), Z=X[:8], n_latent=2, optimiser=None,
    )
    mo, s = agp.mo_train(mo, X, (y_cls, f), iterations=10)
    axes = plot_mo_gp(mo, s, X, X_train=X, ys_train=(y_cls, f))
    assert len(axes) == 2
    import matplotlib.pyplot as plt

    plt.savefig(tmp_path / "mo.png")
    assert (tmp_path / "mo.png").stat().st_size > 0

    # multi-latent branch on a multiclass model
    y3 = np.digitize(f, [-0.5, 0.5])
    mc = agp.VGP.create(
        X, y3, agp.SqExponentialKernel(),
        agp.LogisticSoftMaxLikelihood.create(3), agp.AnalyticVI(), optimiser=None,
    )
    mc, sc = agp.train(mc, iterations=5)
    ax = plot_multilatent(mc, sc, X)
    plt.savefig(tmp_path / "ml.png")
    assert (tmp_path / "ml.png").stat().st_size > 0


def test_greedy_variance_inducing():
    from agp_tpu.inducing import GreedyVariance, inducingpoints

    X = np.random.RandomState(0).randn(300, 2)
    Z = inducingpoints(GreedyVariance(16), X, kernel=agp.SqExponentialKernel())
    assert Z.shape == (16, 2)
    # greedy selection spreads points: min pairwise distance much larger
    # than the first-16 subset
    def minpd(A):
        d = ((A[:, None] - A[None]) ** 2).sum(-1) + np.eye(len(A)) * 1e9
        return float(np.sqrt(d.min()))

    assert minpd(np.asarray(Z)) > 2.0 * minpd(X[:16])


def test_nat_to_moments_warm_matches_exact():
    """Newton-Schulz warm conversion: close warm start -> Schulz branch
    agrees with Cholesky to roundoff; far warm start -> falls back to the
    exact path inside the lax.cond. Batched variant ditto (shared
    predicate)."""
    from agp_tpu.ops import linalg

    M, L = 48, 3
    key = jax.random.PRNGKey(0)
    A = jax.random.normal(key, (L, M, M), dtype=jnp.float64)
    P = jnp.einsum("lmn,lkn->lmk", A, A) / M + jnp.eye(M)
    eta2 = -0.5 * P
    eta1 = jax.random.normal(jax.random.PRNGKey(1), (L, M), dtype=jnp.float64)

    mu_e, S_e = jax.vmap(linalg.nat_to_moments)(eta1, eta2)

    # single-latent: close and far warm starts
    mu_w, S_w = linalg.nat_to_moments_warm(eta1[0], eta2[0], S_e[0] * (1 + 1e-3))
    np.testing.assert_allclose(np.asarray(S_w), np.asarray(S_e[0]), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(mu_w), np.asarray(mu_e[0]), rtol=1e-9)
    mu_f, S_f = linalg.nat_to_moments_warm(eta1[0], eta2[0], 50.0 * jnp.eye(M))
    np.testing.assert_allclose(np.asarray(S_f), np.asarray(S_e[0]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(mu_f), np.asarray(mu_e[0]), rtol=1e-12)

    # batched: close and far (far on ONE latent must send all down Cholesky)
    mu_b, S_b = linalg.nat_to_moments_warm_batched(eta1, eta2, S_e * (1 + 1e-3))
    np.testing.assert_allclose(np.asarray(S_b), np.asarray(S_e), rtol=1e-9)
    far = S_e.at[1].set(50.0 * jnp.eye(M))
    mu_c, S_c = linalg.nat_to_moments_warm_batched(eta1, eta2, far)
    np.testing.assert_allclose(np.asarray(S_c), np.asarray(S_e), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(mu_c), np.asarray(mu_e), rtol=1e-12)


def test_fast_moments_step_parity(monkeypatch):
    """AGP_TPU_FAST_MOMENTS=1 CAVI steps match the exact path.  The gate is
    read at trace time, so compare EAGER variational_update calls (each
    eager call re-evaluates the Python gate; a cached jit would not)."""
    import agp_tpu as agp
    from agp_tpu.inference.analytic_vi import variational_update
    from agp_tpu.training.train import init_state

    X = jax.random.uniform(jax.random.PRNGKey(2), (400, 2), dtype=jnp.float64) * 4 - 2
    y = np.asarray(jnp.where(jnp.sin(2 * X[:, 0]) > 0, 1.0, -1.0))
    m = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
        agp.AnalyticVI(), Z=X[:32], optimiser=None,
    )
    y2, lik = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=lik)
    y2 = jnp.asarray(y2, X.dtype)
    state0 = init_state(m, X, y2)

    def steps(n):
        mm, ss = m, state0
        for _ in range(n):
            mm, ss = variational_update(mm, ss, X, y2)
        return ss

    monkeypatch.setenv("AGP_TPU_FAST_MOMENTS", "0")
    s_exact = steps(8)
    monkeypatch.setenv("AGP_TPU_FAST_MOMENTS", "1")
    s_fast = steps(8)
    np.testing.assert_allclose(np.asarray(s_fast.mu), np.asarray(s_exact.mu), atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(s_fast.Sigma), np.asarray(s_exact.Sigma), atol=1e-8
    )


def test_chunked_predictions_match_unchunked():
    """chunk_size slicing (serving-scale memory bound) must reproduce the
    one-shot outputs exactly, including the edge-padded last chunk, for
    binary, multiclass ([n, K] leading-n layout) and exact-GP paths."""
    import agp_tpu as agp
    from agp_tpu.training.train import init_state

    key = jax.random.PRNGKey(0)
    X = jax.random.uniform(key, (97, 3), dtype=jnp.float64) * 4 - 2
    y = np.asarray(jnp.where(jnp.sin(2 * X[:, 0]) > 0, 1.0, -1.0))

    m = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
        agp.AnalyticVI(), Z=X[:16], optimiser=None,
    )
    y2, lik = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=lik)
    s = init_state(m, X, jnp.asarray(y2, X.dtype))

    mu = agp.predict_f(m, s, X)
    mu_c = agp.predict_f(m, s, X, chunk_size=30)  # 97 = 3*30 + 7 (padded tail)
    np.testing.assert_allclose(np.asarray(mu_c), np.asarray(mu), rtol=1e-12)
    mu2, var2 = agp.predict_f(m, s, X, cov=True)
    mu2c, var2c = agp.predict_f(m, s, X, cov=True, chunk_size=30)
    np.testing.assert_allclose(np.asarray(var2c), np.asarray(var2), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(agp.predict_y(m, s, X, chunk_size=30)),
        np.asarray(agp.predict_y(m, s, X)),
    )
    np.testing.assert_allclose(
        np.asarray(agp.proba_y(m, s, X, chunk_size=30)),
        np.asarray(agp.proba_y(m, s, X)),
        rtol=1e-12,
    )
    import pytest

    with pytest.raises(ValueError):
        agp.predict_f(m, s, X, cov=True, diag=False, chunk_size=30)

    # multiclass: [n, K] probabilities chunk along axis 0 (same key per chunk
    # -> deterministic MC draws, still slice-invariant with n_samples=0)
    ym = np.asarray((X[:, 0] > 0).astype(int) + (X[:, 1] > 0).astype(int))
    mm = agp.SVGP.create(
        agp.SqExponentialKernel(), agp.LogisticSoftMaxLikelihood.create(3),
        agp.AnalyticVI(), Z=X[:16], optimiser=None,
    )
    ym2, likm = mm.likelihood.treat_labels(ym)
    mm = mm.replace(likelihood=likm)
    sm = init_state(mm, X, jnp.asarray(ym2, X.dtype))
    p = agp.proba_y(mm, sm, X, n_samples=0)
    p_c = agp.proba_y(mm, sm, X, n_samples=0, chunk_size=40)
    assert p.shape == (97, 3)
    np.testing.assert_allclose(np.asarray(p_c), np.asarray(p), rtol=1e-12)

    # exact GP
    g = agp.GP.create(X, np.asarray(jnp.sin(X[:, 0])), agp.SqExponentialKernel())
    gm, gs = agp.train(g, X, np.asarray(jnp.sin(X[:, 0])), iterations=1)
    np.testing.assert_allclose(
        np.asarray(agp.predict_f(gm, gs, X, chunk_size=25)),
        np.asarray(agp.predict_f(gm, gs, X)),
        rtol=1e-10,
    )


def test_chunked_mo_predictions_match_unchunked():
    import agp_tpu as agp
    from agp_tpu.models.multioutput import mo_init_state

    X = jax.random.normal(jax.random.PRNGKey(0), (53, 2), dtype=jnp.float64)
    mo = agp.MOSVGP.create(
        agp.SqExponentialKernel(),
        [agp.LogisticLikelihood.create(), agp.GaussianLikelihood.create(0.1)],
        agp.AnalyticVI(), X[:8], n_latent=2, optimiser=None,
    )
    ys = [np.sign(np.asarray(X[:, 0])), np.asarray(X[:, 1])]
    ys2, liks = [], []
    for lik, yv in zip(mo.likelihoods, ys):
        y2, tl = lik.treat_labels(jnp.asarray(yv))
        ys2.append(jnp.asarray(y2, X.dtype))
        liks.append(tl)
    mo = mo.replace(likelihoods=tuple(liks))
    s = mo_init_state(mo, X, ys2)

    from agp_tpu.models.multioutput import mo_predict_f, mo_predict_y, mo_proba_y

    mu, var = mo_predict_f(mo, s, X)
    mu_c, var_c = mo_predict_f(mo, s, X, chunk_size=20)  # 53 = 2*20 + 13
    np.testing.assert_allclose(np.asarray(mu_c), np.asarray(mu), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(var_c), np.asarray(var), rtol=1e-12)
    for a, b in zip(mo_proba_y(mo, s, X, chunk_size=20), mo_proba_y(mo, s, X)):
        np.testing.assert_allclose(
            np.asarray(jnp.stack(a) if isinstance(a, tuple) else a),
            np.asarray(jnp.stack(b) if isinstance(b, tuple) else b), rtol=1e-12,
        )
    for a, b in zip(mo_predict_y(mo, s, X, chunk_size=20), mo_predict_y(mo, s, X)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


# ------------------------------------------------ online inducing algorithms
def test_unigrid_online_update_covers_bounds():
    """Online UniGrid regenerates the regular grid over the expanded
    bounding box (reference: InducingPoints.UniGrid used online)."""
    from agp_tpu.inducing import UniGridOnline, inducingpoints
    from agp_tpu.inducing.algorithms import unigrid_update

    P = 4
    X1 = jax.random.uniform(jax.random.PRNGKey(0), (20, 2), dtype=jnp.float64)
    Z0 = inducingpoints(UniGridOnline(P), X1)
    assert Z0.shape == (P * P, 2)
    cap = 20
    Z = jnp.zeros((cap, 2), dtype=jnp.float64).at[: P * P].set(Z0)
    mask = jnp.zeros((cap,), bool).at[: P * P].set(True)
    # second batch extends the range to [2, 3]^2
    X2 = 2.0 + jax.random.uniform(jax.random.PRNGKey(1), (20, 2), dtype=jnp.float64)
    Z2, mask2 = jax.jit(lambda Z, m, x: unigrid_update(Z, m, x, P))(Z, mask, X2)
    assert int(mask2.sum()) == P * P
    act = np.asarray(Z2[: P * P])
    lo_expect = np.minimum(np.asarray(X1).min(0), np.asarray(X2).min(0))
    hi_expect = np.maximum(np.asarray(X1).max(0), np.asarray(X2).max(0))
    np.testing.assert_allclose(act.min(0), lo_expect, rtol=1e-12)
    np.testing.assert_allclose(act.max(0), hi_expect, rtol=1e-12)
    # still a regular grid: per-dim sorted unique values are evenly spaced
    for d in range(2):
        vals = np.unique(np.round(act[:, d], 12))
        assert len(vals) == P
        np.testing.assert_allclose(np.diff(vals), np.diff(vals)[0], rtol=1e-9)


def test_webscale_update_moves_centers_to_cluster_means():
    """Minibatch k-means: with two far clusters and two active centers, a
    few batches put each center near one cluster mean (Sculley '10)."""
    from agp_tpu.inducing.algorithms import webscale_update

    key = jax.random.PRNGKey(2)
    c0 = jnp.asarray([0.0, 0.0])
    c1 = jnp.asarray([10.0, 10.0])
    Z = jnp.stack([c0 + 1.5, c1 - 1.5])  # offset starting centers
    cap = 2
    mask = jnp.ones((cap,), bool)
    counts = jnp.ones((cap,))
    up = jax.jit(webscale_update)
    for i in range(20):
        key, k1, k2 = jax.random.split(key, 3)
        pts = jnp.concatenate(
            [c0 + 0.1 * jax.random.normal(k1, (16, 2)), c1 + 0.1 * jax.random.normal(k2, (16, 2))]
        )
        Z, mask, counts = up(Z, mask, counts, pts)
    d0 = float(jnp.linalg.norm(Z[0] - c0))
    d1 = float(jnp.linalg.norm(Z[1] - c1))
    assert d0 < 0.3 and d1 < 0.3
    assert float(counts.min()) > 100  # both centers absorbed points


def test_streamkmeans_update_opens_and_absorbs():
    from agp_tpu.inducing.algorithms import streamkmeans_update

    cap = 8
    Z = jnp.zeros((cap, 2)).at[0].set(jnp.asarray([0.0, 0.0]))
    mask = jnp.zeros((cap,), bool).at[0].set(True)
    counts = jnp.zeros((cap,)).at[0].set(1.0)
    # near point absorbs (running mean), far point opens a new center
    batch = jnp.asarray([[0.2, 0.0], [5.0, 5.0]])
    Z2, mask2, counts2 = jax.jit(
        lambda Z, m, c, x: streamkmeans_update(Z, m, c, x, radius2=1.0)
    )(Z, mask, counts, batch)
    assert int(mask2.sum()) == 2
    np.testing.assert_allclose(np.asarray(Z2[0]), [0.1, 0.0], atol=1e-12)  # (0+0.2)/2
    np.testing.assert_allclose(np.asarray(Z2[1]), [5.0, 5.0], atol=1e-12)
    assert float(counts2[0]) == 2.0 and float(counts2[1]) == 1.0
