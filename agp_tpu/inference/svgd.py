"""Stein variational gradient descent over GP latents (bonus engine).

Not in the reference; a natural extra in this family (cf. Liu & Wang '16;
matrix-valued-kernel SVGD is PAPERS.md material).  Particles live in the
whitened space v (f = mu0 + L_K v), so the target is
log p(v) = sum log p(y | f(v)) - |v|^2/2 and the SVGD kernel acts in a
well-conditioned geometry.  The update is pure batched matmuls + one
[P, P] RBF kernel -- dense matmul and elementwise work; the particle axis shards.

  phi(v_i) = (1/P) sum_j [ k(v_j, v_i) grad log p(v_j) + grad_{v_j} k(v_j, v_i) ]
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .hmc import make_log_joint


def svgd_sample(
    model,
    n_particles: int = 128,
    n_steps: int = 500,
    step_size: float = 0.05,
    key=None,
):
    """Returns latent particles f [P, L, N] approximating the posterior."""
    from ..config import jitter
    from ..kernels import batch_gram
    from ..means import batch_call
    from ..ops import linalg

    key = jax.random.PRNGKey(0) if key is None else key
    K = batch_gram(model.kernel, model.train_x)
    L_K = jax.vmap(lambda k: linalg.safe_cholesky(k, jitter(K.dtype)))(K)
    mu0 = batch_call(model.mean, model.train_x, model.n_latent)
    log_joint = make_log_joint(model, L_K, mu0)
    grad_lp = jax.vmap(jax.grad(log_joint))

    L_lat, N = mu0.shape
    v = jax.random.normal(key, (n_particles, L_lat, N), dtype=mu0.dtype)

    def step(v, _):
        g = grad_lp(v)  # [P, L, N]
        flat = v.reshape(n_particles, -1)
        gflat = g.reshape(n_particles, -1)
        d2 = (
            jnp.sum(flat**2, 1)[:, None]
            + jnp.sum(flat**2, 1)[None, :]
            - 2.0 * flat @ flat.T
        )
        # median heuristic bandwidth
        h = jnp.median(d2) / jnp.log(n_particles + 1.0)
        h = jnp.maximum(h, 1e-6)
        Kp = jnp.exp(-d2 / h)  # [P, P]
        # phi = (Kp @ grad + sum_j grad_vj Kp) / P
        attract = Kp @ gflat
        repulse = (jnp.sum(Kp, axis=1, keepdims=True) * flat - Kp @ flat) * (2.0 / h)
        phi = (attract + repulse) / n_particles
        v = v + step_size * phi.reshape(v.shape)
        return v, None

    v, _ = jax.lax.scan(step, v, None, length=n_steps)
    f = mu0[None] + jnp.einsum("lmn,pln->plm", L_K, v)
    return f
