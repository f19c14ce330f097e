"""Sampling a distribution known only through its Laplace transform.

Backs the generic-likelihood (`make_augmented_likelihood`) Gibbs path: the
auxiliary posterior is the exponentially tilted q(omega) proportional to
exp(-s0 omega) p(omega), where only the Laplace transform phi(s) =
E[exp(-s omega)] of p is available (the reference uses Ridout '09 +
Bromwich inversion, /root/reference/src/ComplementaryDistributions/
lap_transf_dist.jl:5-189).

Design: instead of scalar rejection with contour integrals, we
(1) invert the transform on a fixed log-grid with the **Gaver-Stehfest**
algorithm -- real-valued, so any jnp-traceable phi works, no complex
arithmetic; (2) tilt + normalize the grid density; (3) draw by inverse-CDF
(searchsorted) -- one gather per sample, fully vectorized.  Needs float64
(Stehfest is catastrophically ill-conditioned in f32), so the generic
Gibbs path runs with x64 enabled.
"""
from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

LN2 = math.log(2.0)


@lru_cache(maxsize=None)
def stehfest_coeffs(N: int = 14):
    """Gaver-Stehfest weights (N even)."""
    assert N % 2 == 0
    V = np.zeros(N)
    for k in range(1, N + 1):
        s = 0.0
        for j in range((k + 1) // 2, min(k, N // 2) + 1):
            num = j ** (N // 2) * math.factorial(2 * j)
            den = (
                math.factorial(N // 2 - j)
                * math.factorial(j)
                * math.factorial(j - 1)
                * math.factorial(k - j)
                * math.factorial(2 * j - k)
            )
            s += num / den
        V[k - 1] = (-1) ** (k + N // 2) * s
    return V


def invert_laplace(phi, t, N: int = 14):
    """Density p(t) from its Laplace transform phi via Gaver-Stehfest."""
    V = jnp.asarray(stehfest_coeffs(N), dtype=t.dtype)
    k = jnp.arange(1, N + 1, dtype=t.dtype)
    s = k[None, :] * LN2 / t[:, None]  # [T, N]
    vals = phi(s)
    return jnp.maximum((LN2 / t) * jnp.sum(V[None, :] * vals, axis=1), 0.0)


class LaplaceTransformDistribution:
    """Distribution defined by phi(s) = E[e^{-s omega}]."""

    def __init__(self, phi, t_max: float = 50.0, grid_size: int = 2048):
        self.phi = phi
        self.t_max = t_max
        self.grid_size = grid_size

    def grid(self, dtype=jnp.float64):
        # log-spaced grid resolves both the near-zero spike and the tail
        return jnp.logspace(-6, jnp.log10(self.t_max), self.grid_size, dtype=dtype)

    def tilted_mean(self, s0):
        """E_q[omega] for q prop. e^{-s0 omega} p(omega) =
        -(d/ds) log phi at s0 (the augmodel theta)."""
        dphi = jax.grad(lambda s: jnp.sum(self.phi(s)))
        return -dphi(s0) / self.phi(s0)

    def sample(self, key, s0, shape=None):
        """Draw omega ~ q prop. e^{-s0 omega} p(omega) elementwise over s0."""
        s0 = jnp.asarray(s0)
        shape = s0.shape if shape is None else shape
        t = self.grid(s0.dtype if s0.dtype in (jnp.float64,) else jnp.float64)
        p = invert_laplace(self.phi, t)  # base density on the grid
        # cell masses: density x cell width (the grid is log-spaced)
        dt = jnp.gradient(t)
        # tilt per element: w_ij = p(t_j) dt_j e^{-s0_i t_j}
        logw = (
            jnp.log(jnp.maximum(p * dt, 1e-300))[None, :]
            - s0.reshape(-1)[:, None] * t[None, :]
        )
        logw = logw - jax.nn.logsumexp(logw, axis=1, keepdims=True)
        cdf = jnp.cumsum(jnp.exp(logw), axis=1)
        u = jax.random.uniform(key, (s0.size,), dtype=t.dtype)
        idx = jnp.sum(cdf < u[:, None], axis=1)
        idx = jnp.clip(idx, 0, t.shape[0] - 1)
        return t[idx].reshape(shape).astype(s0.dtype)
