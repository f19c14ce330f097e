"""Numerical-robustness battery: the training/prediction spine must stay
finite under extreme-but-legal inputs (the regimes that break naive GP
code): near-duplicate inducing points (rank-deficient Kmm), tiny/huge
lengthscales and variances, huge |f| in the E-steps, f32 end to end.

Guards the adaptive-jitter Cholesky ladder (ops/linalg.py::safe_cholesky),
the Ktilde clamp, safe_expcosh/logcosh overflow guards, and the PG/GIG
samplers' masked-rejection bounds -- the JAX equivalents of the
reference's numerical guards (functions/utils.jl:8-13, latentgp.jl:213,
utils.jl:84-86).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import agp_tpu as agp
from agp_tpu.training.train import init_state


def _finite(tree):
    leaves = [x for x in jax.tree_util.tree_leaves(tree) if hasattr(x, "dtype")]
    return all(bool(jnp.all(jnp.isfinite(x))) for x in leaves)


def _train_probe(kernel, dtype=jnp.float32, n_iter=25, dup_z=False):
    key = jax.random.PRNGKey(0)
    X = (jax.random.uniform(key, (120, 2), dtype=jnp.float64) * 4 - 2).astype(dtype)
    y = np.asarray(jnp.where(jnp.sin(2 * X[:, 0]) > 0, 1.0, -1.0))
    Z = X[:16]
    if dup_z:
        # rank-deficient Kmm: half the inducing points are exact duplicates
        Z = jnp.concatenate([X[:8], X[:8]], axis=0)
    m = agp.SVGP.create(
        kernel, agp.LogisticLikelihood.create(), agp.AnalyticVI(), Z=Z,
        optimiser=None,
    )
    y2, lik = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=lik)
    m, s = agp.train(m, X, jnp.asarray(y2, dtype), iterations=n_iter)
    assert _finite((s.mu, s.Sigma, s.eta1, s.eta2)), "non-finite posterior"
    assert _finite(agp.proba_y(m, s, X[:20]))
    return m, s


def test_duplicate_inducing_points_stay_finite():
    """Exactly duplicated rows of Z make Kmm singular; the adaptive jitter
    ladder must still produce a finite, usable posterior in f32."""
    _train_probe(agp.SqExponentialKernel(), dup_z=True)


@pytest.mark.parametrize("ls,var", [(1e-3, 1.0), (1e3, 1.0), (1.0, 1e-6), (1.0, 1e4)])
def test_extreme_kernel_hyperparameters(ls, var):
    """Tiny/huge lengthscale (K -> I or K -> var*ones, both near-degenerate)
    and tiny/huge signal variance must not NaN the f32 spine."""
    k = agp.SqExponentialKernel(
        lengthscale=jnp.asarray(ls, jnp.float32),
        variance=jnp.asarray(var, jnp.float32),
    )
    _train_probe(k)


def test_safe_expcosh_huge_arguments():
    from agp_tpu.ops.special import logcosh, safe_expcosh

    c = jnp.asarray([0.0, 1.0, 50.0, 700.0, 1e4], jnp.float32)
    out = safe_expcosh(-c / 2.0, c)  # e^{-c/2}/cosh(c) pattern territory
    assert bool(jnp.all(jnp.isfinite(out)))
    # logcosh(c) ~ |c| - log 2 for large c
    np.testing.assert_allclose(
        float(logcosh(jnp.asarray(700.0))), 700.0 - np.log(2.0), rtol=1e-6
    )


def test_pg_sampler_extreme_tilts():
    """PG(1, c) draws at c in {0, 1e-6, 5, 50, 500}: finite, positive, and
    mean within MC error of tanh(c/2)/(2c) (huge tilts push the PSW
    proposal machinery into its tail branch)."""
    from agp_tpu.distributions.polyagamma import pg_mean, sample_pg1

    c = jnp.asarray([0.0, 1e-6, 5.0, 50.0, 500.0], jnp.float32)
    cs = jnp.broadcast_to(c, (4000, 5))
    w = sample_pg1(jax.random.PRNGKey(3), cs)
    assert bool(jnp.all(jnp.isfinite(w))) and bool(jnp.all(w > 0))
    m_emp = jnp.mean(w, axis=0)
    m_true = pg_mean(1.0, c)
    np.testing.assert_allclose(np.asarray(m_emp), np.asarray(m_true), rtol=0.08)


def test_gig_sampler_extreme_parameters():
    """GIG draws with a/b spanning 12 orders of magnitude stay finite and
    positive for p in {-1.5, 0.3, 1.5} (regime-selection stress)."""
    from agp_tpu.distributions.gig import sample_gig

    a = jnp.asarray([1e-6, 1.0, 1e6, 1e-6, 1e6], jnp.float32)
    b = jnp.asarray([1e6, 1.0, 1e-6, 1e-6, 1e6], jnp.float32)
    for p in (-1.5, 0.3, 1.5):
        x = sample_gig(
            jax.random.PRNGKey(4), jnp.tile(a, 200), jnp.tile(b, 200), p
        )
        assert bool(jnp.all(jnp.isfinite(x))) and bool(jnp.all(x > 0)), p


def test_huge_latents_in_estep():
    """Likelihood E-steps at |f| ~ 1e3 (exp/cosh overflow territory in
    naive implementations) must return finite local vars and ELBO terms."""
    big = jnp.asarray([-1e3, -50.0, 0.0, 50.0, 1e3], jnp.float32)
    var = jnp.ones_like(big)
    y_bin = jnp.asarray([1.0, -1.0, 1.0, -1.0, 1.0], jnp.float32)
    for lik in (
        agp.LogisticLikelihood.create(),
        agp.BayesianSVM.create(),
        agp.StudentTLikelihood.create(3.0),
        agp.LaplaceLikelihood.create(),
        agp.Matern32Likelihood.create(),
    ):
        local = lik.init_local_vars(5, jnp.float32)
        lik2, local = lik.local_updates(y_bin, big[None], var[None], local)
        assert _finite(local), type(lik).__name__
        ell = lik2.expec_loglik(y_bin, big[None], var[None], local)
        akl = lik2.aug_kl(local, y_bin)
        assert bool(jnp.isfinite(ell)) and bool(jnp.isfinite(akl)), type(lik).__name__


def test_composite_kernel_hyperopt():
    """Log-space hyperparameter steps must flow through composite kernel
    pytrees (Sum/Product/scaled) without NaNs and leave a finite ELBO."""
    import optax

    X = jax.random.uniform(jax.random.PRNGKey(0), (150, 2), dtype=jnp.float64) * 4 - 2
    y = np.asarray(
        jnp.sin(2 * X[:, 0])
        + 0.1 * jax.random.normal(jax.random.PRNGKey(1), (150,), jnp.float64)
    )
    for kern in (
        agp.SqExponentialKernel() + agp.Matern32Kernel(),
        agp.SqExponentialKernel() * agp.LinearKernel(),
        2.5 * agp.SqExponentialKernel(),
    ):
        m = agp.SVGP.create(
            kern, agp.GaussianLikelihood.create(0.1), agp.AnalyticVI(),
            Z=X[:16], optimiser=optax.adam(0.02), atfrequency=2,
        )
        y2, lik = m.likelihood.treat_labels(jnp.asarray(y))
        m = m.replace(likelihood=lik)
        m, s = agp.train(m, X, jnp.asarray(y2, X.dtype), iterations=30)
        assert bool(jnp.isfinite(agp.ELBO(m, s, X, jnp.asarray(y2, X.dtype))))
        assert _finite(agp.predict_f(m, s, X[:10]))


def test_online_capacity_saturation():
    """Streaming more distinct inputs than the fixed inducing capacity must
    saturate the mask at capacity (never overflow the static buffers) and
    keep the posterior finite (models/online_svgp.py masked design)."""
    from agp_tpu.models.online_svgp import OnlineSVGP, online_train

    om = OnlineSVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(0.5)),
        agp.GaussianLikelihood.create(0.1),
        agp.AnalyticVI(), n_dim=1, capacity=16, optimiser=None,
    )
    st = None
    for i in range(10):
        Xb = jnp.linspace(i, i + 1, 25, dtype=jnp.float64)[:, None]
        yb = np.asarray(jnp.sin(2 * Xb[:, 0]))
        om, st = online_train(om, Xb, yb, state=st, iterations=5)
    assert int(jnp.sum(om.z_mask[0])) == 16
    assert _finite((st.mu, st.Sigma))
    assert _finite(agp.predict_f(om, st, jnp.linspace(9.0, 10.0, 20)[:, None]))


def test_psd_safe_cholesky_zero_first_ladder():
    """The online-path eta->moments ladder: exact at rung 0 for a clean PD
    matrix; recovers (instead of NaN) on a slightly-indefinite one, which
    f32 matmul rounding can produce in the streaming kappa_a^T invDa
    kappa_a correction."""
    from agp_tpu.ops import linalg

    key = jax.random.PRNGKey(0)
    W = jax.random.normal(key, (16, 16), dtype=jnp.float32)
    A = W @ W.T + 0.5 * jnp.eye(16, dtype=jnp.float32)
    L0 = jax.jit(linalg.psd_safe_cholesky)(A)
    # rung 0 (zero jitter): identical to the plain factorization
    np.testing.assert_allclose(
        np.asarray(L0), np.asarray(jnp.linalg.cholesky(A)), rtol=0, atol=0
    )
    # slightly indefinite: plain NaNs, ladder recovers finite + consistent
    evals, evecs = np.linalg.eigh(np.asarray(A, np.float64))
    evals[0] = -1e-6
    B = jnp.asarray(evecs @ np.diag(evals) @ evecs.T, jnp.float32)
    assert bool(jnp.any(jnp.isnan(jnp.linalg.cholesky(B))))
    LB = jax.jit(linalg.psd_safe_cholesky)(B)
    assert bool(jnp.isfinite(LB).all())
    rec = np.asarray(LB @ LB.T)
    np.testing.assert_allclose(rec, np.asarray(B), atol=1e-2)  # small-jitter recovery

    # nat_to_moments_safe: same recovery on the eta2 side
    eta2 = -0.5 * B
    eta1 = jnp.ones((16,), jnp.float32)
    mu, Sigma = jax.jit(linalg.nat_to_moments_safe)(eta1, eta2)
    assert bool(jnp.isfinite(mu).all() and jnp.isfinite(Sigma).all())

    # warm_batched(safe=True) with a far warm start must take the ladder,
    # not propagate NaN through the Schulz branch
    mu_b, Sigma_b = jax.jit(
        lambda e1, e2, S: linalg.nat_to_moments_warm_batched(e1, e2, S, safe=True)
    )(eta1[None], eta2[None], jnp.eye(16, dtype=jnp.float32)[None] * 100.0)
    assert bool(jnp.isfinite(mu_b).all() and jnp.isfinite(Sigma_b).all())
