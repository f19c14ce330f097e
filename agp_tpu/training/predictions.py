"""Prediction functions: latent predictive, label prediction, predictive
probabilities.

Equivalent of /root/reference/src/training/predictions.jl:
  mu*    = k*^T K^-1 mu
  A      = K^-1 (I - Sigma K^-1)
  var*   = k** + jitt - diag(k* A k*^T)
(predictions.jl:25-50), pushed through the likelihood with 100-node
Gauss-Hermite quadrature in `proba_y` (predictions.jl:4, compute_proba).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import jitter
from ..kernels import batch_diag, batch_gram
from ..models.gp import GP
from ..ops import linalg


@partial(jax.jit, static_argnames=("diag", "full_cov"))
def _predict_f_var(model, state, X_test, diag: bool = True, full_cov: bool = False):
    """Latent predictive mean/variance for variational models, [L, n].

    Runs at HIGHEST matmul precision: the chain k* K^-1 (I - Sigma K^-1) k*^T
    cancels internally (K_inv entries are O(cond(K)) while the predictive
    moments are O(1)); at a reduced f32 matmul precision (TF32, one bf16
    pass) the error reaches O(1) for ill-conditioned kernel matrices, as on
    the dense N=512 heteroscedastic oracle.  These are per-test-point
    matmuls off the training hot loop."""
    with jax.default_matmul_precision("highest"):
        return _predict_f_var_hp(model, state, X_test, diag, full_cov)


def _predict_f_var_hp(model, state, X_test, diag, full_cov):
    Z = model.Z  # [L, M, D] (train inputs for full models)
    k_star = batch_gram(model.kernel, X_test, Z)  # [L, n, M]
    K_inv = state.kmat["K_inv"]
    mu = state.mu
    alpha = jnp.einsum("lmn,ln->lm", K_inv, mu)
    mu_f = jnp.einsum("lnm,lm->ln", k_star, alpha)
    if not diag and not full_cov:
        return mu_f, None
    # A = K^-1 (I - Sigma K^-1)
    M = K_inv.shape[-1]
    eye = jnp.eye(M, dtype=K_inv.dtype)
    A = jnp.einsum(
        "lmn,lnk->lmk",
        K_inv,
        eye - jnp.einsum("lmn,lnk->lmk", state.Sigma, K_inv),
    )
    if full_cov:
        k_ss = batch_gram(model.kernel, X_test, X_test)
        n = X_test.shape[0]
        cov = (
            k_ss
            + jitter(mu_f.dtype) * jnp.eye(n, dtype=mu_f.dtype)
            - jnp.einsum("lnm,lmk,lpk->lnp", k_star, A, k_star)
        )
        return mu_f, cov
    k_ss = batch_diag(model.kernel, X_test) + jitter(mu_f.dtype)
    var_f = k_ss - linalg.diag_ABt(jnp.einsum("lnm,lmk->lnk", k_star, A), k_star)
    return mu_f, jnp.maximum(var_f, 0.0)


@partial(jax.jit, static_argnames=("diag",))
def _predict_f_gp(model: GP, state, X_test, diag=True):
    return _predict_f_gp_hp(model, state, X_test, diag)


@linalg._highest_precision
def _predict_f_gp_hp(model: GP, state, X_test, diag=True):
    k_star = batch_gram(model.kernel, X_test, model.train_x)[0]  # [n, N]
    mu_f = k_star @ state.alpha
    L = state.chol_Sigma
    v = jax.scipy.linalg.solve_triangular(L, k_star.T, lower=True)
    if diag:
        k_ss = batch_diag(model.kernel, X_test)[0] + jitter(mu_f.dtype)
        var_f = k_ss - jnp.sum(v * v, axis=0)
        return mu_f[None, :], jnp.maximum(var_f, 0.0)[None, :]
    k_ss = batch_gram(model.kernel, X_test, X_test)[0]
    cov = k_ss - v.T @ v
    return mu_f[None, :], cov[None, :]


def _chunk_map(call, X_test, chunk_size: int, axis: int):
    """Apply `call` over [chunk_size]-row slices of X_test (last chunk
    edge-padded so every call shares ONE compiled program) and concatenate
    the output pytree leaves along `axis` (the test-point axis).  Bounds
    device memory for serving-scale test sets: peak k* footprint is
    O(chunk_size * M) instead of O(n * M)."""
    n = X_test.shape[0]
    outs = []
    for s in range(0, n, chunk_size):
        xc = X_test[s : s + chunk_size]
        c = xc.shape[0]
        if c < chunk_size:
            xc = jnp.pad(xc, ((0, chunk_size - c), (0, 0)), mode="edge")
        out = call(xc)
        if c < chunk_size:
            out = jax.tree_util.tree_map(
                lambda a: jnp.take(a, jnp.arange(c), axis=axis), out
            )
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=axis), *outs)


def predict_f(
    model, state, X_test, cov: bool = False, diag: bool = True, chunk_size=None
):
    """Latent GP predictive (reference: predictions.jl predict_f).

    Returns mu (and var if cov=True); leading latent axis squeezed away for
    single-latent models.  `chunk_size` evaluates the test set in fixed-size
    slices (diag predictions only) so huge test sets never materialize the
    full [n, M] cross-gram at once.
    """
    from ..models.base import as_2d

    X_test = as_2d(jnp.asarray(X_test))

    def call(xc):
        if isinstance(model, GP):
            mu_f, var_f = _predict_f_gp(model, state, xc, diag=diag)
        else:
            mu_f, var_f = _predict_f_var(
                model, state, xc, diag=diag or cov, full_cov=cov and not diag
            )
        if model.n_latent == 1:
            mu_f = mu_f[0]
            var_f = None if var_f is None else var_f[0]
        return (mu_f, var_f) if cov else mu_f

    if chunk_size is not None and X_test.shape[0] > chunk_size:
        if cov and not diag:
            raise ValueError(
                "chunk_size is incompatible with full-covariance prediction "
                "(the [n, n] output couples chunks); use diag=True"
            )
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


@jax.jit
def _predict_y_core(model, state, X_test):
    if isinstance(model, GP):
        mu_f, _ = _predict_f_gp(model, state, X_test)
        return model.likelihood.predict_y(mu_f[0])
    mu_f, _ = _predict_f_var(model, state, X_test, diag=False)
    if model.n_latent == 1 and model.likelihood.n_latent == 1:
        return model.likelihood.predict_y(mu_f[0])
    return model.likelihood.predict_y(mu_f)


def predict_y(model, state, X_test, chunk_size=None):
    """Label-space point prediction (reference: predictions.jl predict_y).

    The whole path (k*, posterior push-through, likelihood link) runs as one
    jitted program, so the host dispatches once per chunk.
    `chunk_size` bounds device memory on huge test sets.
    """
    from ..models.base import as_2d

    X_test = as_2d(jnp.asarray(X_test))
    call = lambda xc: _predict_y_core(model, state, xc)
    if chunk_size is not None and X_test.shape[0] > chunk_size:
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


@partial(jax.jit, static_argnames=("n_samples",))
def _proba_y_core(model, state, X_test, key, n_samples):
    if isinstance(model, GP):
        mu_f, var_f = _predict_f_gp(model, state, X_test)
        return model.likelihood.compute_proba(mu_f[0], var_f[0])
    mu_f, var_f = _predict_f_var(model, state, X_test, diag=True)
    lik = model.likelihood
    if lik.n_latent == 1:
        return lik.compute_proba(mu_f[0], var_f[0])
    from ..likelihoods.multiclass import MultiClassLikelihood

    if isinstance(lik, MultiClassLikelihood):
        return lik.compute_proba(mu_f, var_f, n_samples=n_samples, key=key)
    return lik.compute_proba(mu_f, var_f)


def proba_y(model, state, X_test, key=None, n_samples: int = 200, chunk_size=None):
    """Predictive distribution of y (reference: predictions.jl proba_y).

    One jitted program end-to-end; `n_samples` only affects multiclass
    likelihoods (MC latent integration; 0 = plug-in means).  `chunk_size`
    bounds device memory on huge test sets.
    """
    from ..likelihoods.multiclass import MultiClassLikelihood
    from ..models.base import as_2d

    multiclass = isinstance(
        getattr(model, "likelihood", None), MultiClassLikelihood
    )
    if key is None and multiclass:
        key = jax.random.PRNGKey(42)
    X_test = as_2d(jnp.asarray(X_test))
    call = lambda xc: _proba_y_core(model, state, xc, key, n_samples=n_samples)
    if chunk_size is not None and X_test.shape[0] > chunk_size:
        # multiclass probabilities are [n, K] (n leads); everything else
        # carries the test-point axis last
        return _chunk_map(call, X_test, int(chunk_size), axis=0 if multiclass else -1)
    return call(X_test)


def sample_f(model, state, X_test, n_samples: int = 1, key=None):
    """Draw joint samples from the latent predictive
    f* ~ N(mu*, Sigma*) (full covariance).  Returns [S, L, n] (latent axis
    squeezed for single-latent models).  The reference exposes this
    indirectly through `rand` on the posterior (models/AbstractGP.jl)."""
    from ..models.base import as_2d

    key = jax.random.PRNGKey(0) if key is None else key
    return _sample_f_core(
        model, state, as_2d(jnp.asarray(X_test)), key, n_samples=n_samples
    )


@partial(jax.jit, static_argnames=("n_samples",))
def _sample_f_core(model, state, X_test, key, n_samples):
    if isinstance(model, GP):
        mu_f, cov = _predict_f_gp(model, state, X_test, diag=False)
    else:
        mu_f, cov = _predict_f_var(model, state, X_test, diag=False, full_cov=True)
    n = X_test.shape[0]
    L_c = jnp.linalg.cholesky(
        cov + jitter(mu_f.dtype) * jnp.eye(n, dtype=mu_f.dtype)[None]
    )
    eps = jax.random.normal(key, (n_samples,) + mu_f.shape, dtype=mu_f.dtype)
    samples = mu_f[None] + jnp.einsum("lnm,slm->sln", L_c, eps)
    if model.n_latent == 1:
        return samples[:, 0]
    return samples
