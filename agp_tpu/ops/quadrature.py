"""Gauss-Hermite quadrature for Gaussian expectations.

The reference relies on FastGaussQuadrature.gausshermite with 100 nodes for
predictions (reference: /root/reference/src/training/predictions.jl:4) and a
configurable node count for QuadratureVI
(reference: /root/reference/src/inference/quadratureVI.jl:36-52).

Design: node/weight tables are computed once on the host with
numpy (Golub-Welsch eigendecomposition) and baked into the jitted program as
constants; the expectation itself is a [batch, nodes] broadcast + one
reduction -- elementwise work that XLA fuses with the integrand.
"""
from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def gauss_hermite(n: int):
    """Physicists' Gauss-Hermite nodes/weights rescaled so that
    ``sum(w * g(x))`` approximates ``E[g(X)]`` for X ~ N(0, 1).

    Same rescaling as the reference (nodes * sqrt(2), weights / sqrt(pi),
    reference: training/predictions.jl:4, inference/quadratureVI.jl:47-48).
    """
    x, w = np.polynomial.hermite.hermgauss(n)
    return np.sqrt(2.0) * x, w / np.sqrt(np.pi)


def expectation(fn, mu: jnp.ndarray, var: jnp.ndarray, n: int = 100) -> jnp.ndarray:
    """E_{f ~ N(mu, var)}[fn(f)] elementwise over mu/var of any shape."""
    x, w = gauss_hermite(n)
    x = jnp.asarray(x, dtype=mu.dtype)
    w = jnp.asarray(w, dtype=mu.dtype)
    sd = jnp.sqrt(jnp.maximum(var, 0.0))
    nodes = mu[..., None] + sd[..., None] * x  # [..., n]
    return jnp.sum(w * fn(nodes), axis=-1)


def mean_and_var(fn, mu: jnp.ndarray, var: jnp.ndarray, n: int = 100):
    """Return (E[fn(f)], V[fn(f)]) under f ~ N(mu, var) via shared nodes."""
    x, w = gauss_hermite(n)
    x = jnp.asarray(x, dtype=mu.dtype)
    w = jnp.asarray(w, dtype=mu.dtype)
    sd = jnp.sqrt(jnp.maximum(var, 0.0))
    vals = fn(mu[..., None] + sd[..., None] * x)
    m = jnp.sum(w * vals, axis=-1)
    m2 = jnp.sum(w * vals**2, axis=-1)
    return m, m2 - m**2
