"""Blocked Gibbs sampling with augmented variables.

JAX equivalent of the reference's src/inference/gibbssampling.jl +
training/sampling.jl: the whole chain runs inside one `lax.scan` -- no
host round-trips between steps -- with vectorized Polya-Gamma / GIG /
Poisson draws replacing the reference's scalar rejection samplers.

One step (reference gibbssampling.jl:50-60):
  omega ~ p(omega | f)                    (likelihood sample_local)
  Sigma  = (2 Diag(grad_e_sigma) + K^-1)^-1
  f | omega ~ N(Sigma (grad_e_mu + K^-1 mu0), Sigma)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..means import batch_call
from ..ops import linalg


# Smallest N for which "auto" takes the CG resample; on an H100 it ran
# several times as many sweeps/s as the Cholesky resample (PERF.md).
CG_MIN_N = 1024


def _use_cg_solver(model) -> bool:
    """Global-resample solver policy.  "chol": exact O(N^3) Cholesky per
    sweep (the reference's algorithm).  "cg": matmul-only whitened
    perturb-and-solve (Papandreou-Yuille / Parker-Fox style) -- an exact
    sampler up to CG tolerance whose per-sweep cost is O(#iters * N^2)
    matvecs instead of a sequential N^3 factorization.  "auto": cg for
    N >= CG_MIN_N, on every device."""
    solver = getattr(model.inference, "solver", "auto")
    if solver == "cg":
        return True
    if solver == "chol":
        return False
    return model.train_x.shape[0] >= CG_MIN_N


def gibbs_step(model, kmat, mu0, key, f, local_vars):
    """One blocked Gibbs sweep. f: [L, N] current latent sample."""
    k_local, k_glob = jax.random.split(key)
    lik = model.likelihood
    local_vars = lik.sample_local(k_local, model.train_y, f, local_vars)
    gmu = lik.grad_e_mu(model.train_y, local_vars)  # [L, N]
    gs = lik.grad_e_sigma(model.train_y, local_vars)  # [L, N]
    K_inv = kmat["K_inv"]

    def one_chol(gmu_l, gs_l, Kinv_l, LK_l, mu0_l, key_l):
        A = 2.0 * jnp.diag(gs_l) + Kinv_l
        L_A = jnp.linalg.cholesky(linalg.symmetrize(A))
        rhs = gmu_l + Kinv_l @ mu0_l
        m = linalg.chol_solve(L_A, rhs)
        eps = jax.random.normal(key_l, m.shape, dtype=m.dtype)
        # f = m + L_A^-T eps  has covariance A^-1
        delta = jax.scipy.linalg.solve_triangular(L_A.T, eps, lower=False)
        return m + delta

    def one_cg(gmu_l, gs_l, Kinv_l, LK_l, mu0_l, key_l):
        # Whitened perturb-and-solve: with Q = D + K^-1 (D = 2 diag(gs)),
        # the target draw is f ~ N(Q^-1 b, Q^-1), b = gmu + K^-1 mu0.
        # Substituting f = L_K h (K = L_K L_K^T) gives
        #   A h = L_K^T b + n,  A = L_K^T D L_K + I,  n ~ N(0, A),
        # and n is EXACTLY samplable by construction:
        #   n = L_K^T sqrt(D) xi1 + xi2,  xi1, xi2 ~ N(0, I).
        # Then h ~ N(A^-1 L_K^T b, A^-1) and f = L_K h has the target law
        # (L_K A^-1 L_K^T = Q^-1).  Every operation is a dense matvec;
        # CG tolerance 1e-6 relative puts the solver bias far
        # below Monte-Carlo error.
        D = 2.0 * gs_l
        b = gmu_l + Kinv_l @ mu0_l
        k1, k2 = jax.random.split(key_l)
        xi1 = jax.random.normal(k1, b.shape, dtype=b.dtype)
        xi2 = jax.random.normal(k2, b.shape, dtype=b.dtype)
        r = LK_l.T @ (b + jnp.sqrt(jnp.maximum(D, 0.0)) * xi1) + xi2

        def Aop(h):
            return LK_l.T @ (D * (LK_l @ h)) + h

        # tol 1e-5 is reachable in f32 (1e-6 stagnates and burns the full
        # iteration budget); the solver bias at 1e-5 relative residual is
        # orders of magnitude below Monte-Carlo error.
        maxiter = min(b.shape[0], 128)
        h, _ = jax.scipy.sparse.linalg.cg(Aop, r, tol=1e-5, maxiter=maxiter)
        return LK_l @ h

    one = one_cg if _use_cg_solver(model) else one_chol
    keys = jax.random.split(k_glob, f.shape[0])
    f_new = jax.vmap(one)(gmu, gs, K_inv, kmat["L_K"], mu0, keys)
    return f_new, local_vars


def run_chain(model, kmat, key, n_samples: int, n_burnin: int, thinning: int, local_vars, f0=None):
    """Scan the chain; returns samples [n_kept, L, N] and final state."""
    L_lat, N = model.n_latent, model.train_x.shape[0]
    dtype = model.train_x.dtype
    mu0 = batch_call(model.mean, model.train_x, model.n_latent)
    f = jnp.zeros((L_lat, N), dtype=dtype) if f0 is None else f0
    total = n_burnin + n_samples * thinning

    def body(carry, key_t):
        f, local_vars = carry
        f, local_vars = gibbs_step(model, kmat, mu0, key_t, f, local_vars)
        return (f, local_vars), f

    keys = jax.random.split(key, total)
    (f, local_vars), all_f = jax.lax.scan(body, (f, local_vars), keys)
    kept = all_f[n_burnin + thinning - 1 :: thinning]
    return kept, f, local_vars
