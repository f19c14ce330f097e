"""Special functions used by the augmentation math.

Vectorized JAX re-implementations of the numerical guards and Bessel-type
functions the reference gets from Julia's SpecialFunctions
(reference: /root/reference/src/functions/utils.jl:84-92,
 /root/reference/src/functions/KLdivergences.jl:101-113).
Everything here is elementwise and overflow-safe in float32.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln  # noqa: F401  (re-exported)

LOG2 = 0.6931471805599453


def logcosh(c: jnp.ndarray) -> jnp.ndarray:
    """Numerically safe log(cosh(c)) (reference: functions/utils.jl:89-92)."""
    c = jnp.abs(c)
    return c + jnp.log1p(jnp.exp(-2.0 * c)) - LOG2


def safe_expcosh(mu: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """exp(mu)/cosh(c) computed in log space so it never overflows
    (reference: functions/utils.jl:84-86 falls back to a logistic bound on
    overflow; the log-space form is exact and branch-free)."""
    return jnp.exp(mu - logcosh(c))


def sqrt_expec_square(mu: jnp.ndarray, var: jnp.ndarray) -> jnp.ndarray:
    """sqrt(E[f^2]) = sqrt(mu^2 + var) (reference: functions/utils.jl:25-28)."""
    return jnp.sqrt(mu**2 + var)


def sqrt_expec_square_diff(mu, var, y):
    """sqrt(E[(f-y)^2]) (reference: functions/utils.jl:30-33)."""
    return jnp.sqrt((mu - y) ** 2 + var)


def xlogx(x: jnp.ndarray) -> jnp.ndarray:
    """x*log(x) with 0*log(0) = 0."""
    return jnp.where(x > 0, x * jnp.log(jnp.where(x > 0, x, 1.0)), 0.0)


def log_besselk_half(n_half: int, x: jnp.ndarray) -> jnp.ndarray:
    """log K_{p}(x) for half-integer order p = n_half + 1/2 (n_half >= 0).

    Half-integer modified Bessel functions of the second kind have the closed
    form  K_{n+1/2}(x) = sqrt(pi/(2x)) e^{-x} sum_{k=0}^{n} (n+k)!/(k!(n-k)!(2x)^k).
    The augmentation paths only ever need p in {-1/2, 1/2, 3/2, 5/2} (GIG
    variational posteriors with p = 1/2 for Laplace/Bayesian-SVM,
    reference: likelihood/laplace.jl:111-122, likelihood/bayesiansvm.jl:86-89),
    so this closed form replaces a general besselk.
    K_{-p} = K_{p}, so use abs for negative half orders.
    """
    if n_half < 0:
        raise ValueError("use abs(order) - K_{-p} = K_p")
    base = 0.5 * (jnp.log(jnp.pi) - LOG2 - jnp.log(x)) - x
    if n_half == 0:
        return base
    # polynomial sum_{k<=n} (n+k)!/(k!(n-k)!) (2x)^{-k}
    import math

    coeffs = [
        math.factorial(n_half + k) / (math.factorial(k) * math.factorial(n_half - k))
        for k in range(n_half + 1)
    ]
    inv2x = 1.0 / (2.0 * x)
    poly = coeffs[0]
    p = jnp.ones_like(x)
    for k in range(1, n_half + 1):
        p = p * inv2x
        poly = poly + coeffs[k] * p
    return base + jnp.log(poly)


def besselk_half(n_half: int, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.exp(log_besselk_half(n_half, x))
