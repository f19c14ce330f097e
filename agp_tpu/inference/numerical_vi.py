"""Numerical VI: Opper-Archambeau gradients of E[log p(y|f)] via
Gauss-Hermite quadrature or Monte-Carlo integration.

JAX re-design of the reference's src/inference/numericalVI.jl,
quadratureVI.jl and MCVI.jl:
  * the per-point expectations are [B, nodes] / [S, L, B] broadcasts fused
    by XLA, with `jax.grad` supplying d log p / d f where the
    reference used hand-derived or ForwardDiff fallbacks;
  * the PSD-safeguarded covariance update (numericalVI.jl:158-179) becomes
    a bounded `lax.while_loop` halving alpha until Cholesky succeeds.

Gradient equations (numericalVI.jl:121-156):
  full:   d_eta1 = E[dlogp] - K^-1 (mu - mu0)
          d_eta2 = Diag(E[d2logp]/2) - (K^-1 - Sigma^-1)/2
  sparse: d_eta1 = rho kappa^T E[dlogp] - K^-1 (mu - mu0)
          d_eta2 = rho kappa^T Diag(E[d2logp]/2) kappa - (K^-1 - Sigma^-1)/2
  natural preconditioning: d_eta1 <- K d_eta1; d_eta2 <- 2 Sigma d_eta2 Sigma
  update: mu += opt(d_eta1); Sigma += alpha opt(d_eta2), alpha backtracked.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import linalg
from ..ops.kl import gaussian_kl
from ..ops.quadrature import gauss_hermite
from ..training.state import TrainState
from ..utils.opt import ascent_update
from .analytic_vi import latent_moments, prior_mean_stack


# ------------------------------------------------------- expectation grads
def quad_grads(lik, y, mu, var, n_points: int, clipping: float):
    """E[dlogp], E[d2logp] per point via GH quadrature; mu/var: [L, B]
    (single-latent likelihoods only, as in the reference)."""
    x, w = gauss_hermite(n_points)
    x = jnp.asarray(x, mu.dtype)
    w = jnp.asarray(w, mu.dtype)
    sd = jnp.sqrt(jnp.maximum(var, 0.0))
    nodes = mu[..., None] + sd[..., None] * x  # [L, B, n]
    yb = jnp.broadcast_to(y, mu[0].shape)[None, :, None]
    yb = jnp.broadcast_to(yb, nodes.shape)
    g = lik.grad_log_prob(yb, nodes)
    h = lik.hess_log_prob(yb, nodes)
    Ed = jnp.sum(w * g, axis=-1)
    Ed2 = jnp.sum(w * h, axis=-1)
    if clipping:
        Ed = jnp.clip(Ed, -clipping, clipping)
        Ed2 = jnp.clip(Ed2, -clipping, clipping)
    return Ed, Ed2


def mc_grads(lik, key, y, mu, var, n_mc: int, clipping: float):
    """MC estimate of E[dlogp], E[diag d2logp]; supports multi-latent
    likelihoods (softmax/logistic-softmax), mu/var: [L, B]."""
    L = mu.shape[0]
    eps = jax.random.normal(key, (n_mc,) + mu.shape, dtype=mu.dtype)
    sd = jnp.sqrt(jnp.maximum(var, 0.0))
    f = mu[None] + sd[None] * eps  # [S, L, B]

    if lik.n_latent == 1:
        yb = jnp.broadcast_to(y, f.shape)
        g = lik.grad_log_prob(yb, f)
        h = lik.hess_log_prob(yb, f)
    else:
        # y one-hot [B, K]; log_prob expects f [K, B]
        def glp(fs):  # fs: [L, B]
            return jax.grad(lambda t: jnp.sum(lik.log_prob(y.T, t)))(fs)

        g = jax.vmap(glp)(f)  # [S, L, B]
        # diagonal Hessian: one jvp per latent axis
        basis = jnp.eye(L, dtype=mu.dtype)

        def hdiag(fs):
            def col(e):
                _, hv = jax.jvp(glp, (fs,), (e[:, None] * jnp.ones_like(fs),))
                return hv  # [L, B]

            hv = jax.vmap(col)(basis)  # [L, L, B]
            return jnp.einsum("llb->lb", hv)

        h = jax.vmap(hdiag)(f)
    Ed = jnp.mean(g, axis=0)
    Ed2 = jnp.mean(h, axis=0)
    if clipping:
        Ed = jnp.clip(Ed, -clipping, clipping)
        Ed2 = jnp.clip(Ed2, -clipping, clipping)
    return Ed, Ed2


# ------------------------------------------------------------------- update
def variational_update(model, state: TrainState, x, y):
    inf = model.inference
    kmat = state.kmat
    mu_f, var_f, kappa = latent_moments(model, state, x, kmat)
    lik = model.likelihood

    if inf.name == "QuadratureVI":
        Ed, Ed2 = quad_grads(lik, y, mu_f, var_f, inf.n_points, inf.clipping)
    else:
        key, sub = jax.random.split(state.key)
        state = state.replace(key=key)
        Ed, Ed2 = mc_grads(lik, sub, y, mu_f, var_f, inf.n_mc, inf.clipping)

    K_inv = kmat["K_inv"]
    mu0 = prior_mean_stack(model, x)
    Sigma_inv = jax.vmap(lambda S: linalg.chol_inv(jnp.linalg.cholesky(linalg.symmetrize(S))))(
        state.Sigma
    )
    rho = state.rho

    if model.is_sparse:
        d1 = jnp.einsum("lbm,lb->lm", kappa, rho * Ed) - jnp.einsum(
            "lmn,ln->lm", K_inv, state.mu - mu0
        )
        d2 = jnp.einsum(
            "lbm,lb,lbn->lmn", kappa, rho * Ed2 / 2.0, kappa
        ) - (K_inv - Sigma_inv) / 2.0
    else:
        d1 = Ed - jnp.einsum("lmn,ln->lm", K_inv, state.mu - mu0)
        d2 = jax.vmap(jnp.diag)(Ed2 / 2.0) - (K_inv - Sigma_inv) / 2.0

    if inf.natural:
        # precondition into the natural geometry (numericalVI.jl:152-156)
        L_K = kmat["L_K"]
        K = jnp.einsum("lmn,lkn->lmk", L_K, L_K)
        d1 = jnp.einsum("lmn,ln->lm", K, d1)
        d2 = 2.0 * jnp.einsum("lmn,lnk,lkp->lmp", state.Sigma, d2, state.Sigma)

    opt_state, (u1, u2) = ascent_update(
        inf.optimiser, state.opt_state, (state.mu, state.Sigma), (d1, d2)
    )
    new_mu = state.mu + u1

    def psd_apply(S, dS):
        dS = linalg.symmetrize(dS)

        def not_psd(alpha):
            C = jnp.linalg.cholesky(S + alpha * dS)
            return jnp.logical_and(jnp.any(jnp.isnan(C)), alpha > 1e-8)

        alpha = jax.lax.while_loop(not_psd, lambda a: a * 0.5, jnp.asarray(1.0, S.dtype))
        return jnp.where(alpha > 1e-8, S + alpha * dS, S)

    new_Sigma = jax.vmap(psd_apply)(state.Sigma, u2)
    eta1, eta2 = jax.vmap(linalg.moments_to_nat)(new_mu, new_Sigma)
    return model, state.replace(
        mu=new_mu, Sigma=new_Sigma, eta1=eta1, eta2=eta2, opt_state=opt_state
    )


# --------------------------------------------------------------------- ELBO
def expec_loglik(model, state, x, y, kmat=None, key=None):
    inf = model.inference
    kmat = state.kmat if kmat is None else kmat
    mu_f, var_f, _ = latent_moments(model, state, x, kmat)
    lik = model.likelihood
    if inf.name == "QuadratureVI":
        x_n, w = gauss_hermite(inf.n_points)
        x_n = jnp.asarray(x_n, mu_f.dtype)
        w = jnp.asarray(w, mu_f.dtype)
        sd = jnp.sqrt(jnp.maximum(var_f, 0.0))
        nodes = mu_f[..., None] + sd[..., None] * x_n
        yb = jnp.broadcast_to(y, mu_f[0].shape)[None, :, None]
        lp = lik.log_prob(jnp.broadcast_to(yb, nodes.shape), nodes)
        return jnp.sum(w * lp)
    key = jax.random.PRNGKey(7) if key is None else key
    eps = jax.random.normal(key, (inf.n_mc,) + mu_f.shape, dtype=mu_f.dtype)
    f = mu_f[None] + jnp.sqrt(jnp.maximum(var_f, 0.0))[None] * eps
    if lik.n_latent == 1:
        lp = lik.log_prob(jnp.broadcast_to(y, f.shape), f)
        return jnp.sum(jnp.mean(lp, axis=0))
    lp = jax.vmap(lambda fs: lik.log_prob(y.T, fs))(f)  # [S, B]
    return jnp.sum(jnp.mean(lp, axis=0))


def elbo(model, state, x, y, kmat=None, key=None):
    kmat = state.kmat if kmat is None else kmat
    rho = state.rho
    tot = rho * expec_loglik(model, state, x, y, kmat, key)
    mu0 = prior_mean_stack(model, x)
    kl = jax.vmap(gaussian_kl)(state.mu, mu0, state.Sigma, kmat["L_K"])
    return tot - jnp.sum(kl)
