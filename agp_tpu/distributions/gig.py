"""Generalized-inverse-Gaussian sampling, vectorized, general p.

The reference implements three scalar rejection regimes (Hormann-Leydold:
concave-envelope, ratio-of-uniforms, shifted RoU with a Cardano cubic;
/root/reference/src/ComplementaryDistributions/generalizedinversegaussian.jl:58-164).

Design -- everything elementwise, one masked `lax.while_loop`
over the whole batch:

* |p| = 1/2 keeps the exact rejection-FREE route via the inverse-Gaussian
  (Michael-Schucany-Haas): two uniforms + one normal per lane.
* general p: standardize to Y ~ GIG(lam=|p|, omega, omega) with
  omega = sqrt(ab) (X = sqrt(b/a) * Y, and 1/Y for p < 0), then per-lane
  regime selection mirroring Hormann-Leydold 2014:
    R1 shifted ratio-of-uniforms (lam >= 1 or omega > 1): bounding box from
       the two positive roots of a cubic, solved in closed form
       (trigonometric Cardano) -- no iteration;
    R2 plain ratio-of-uniforms (moderate omega, lam < 1);
    R3 two-piece concave envelope (x^{lam-1} body + exponential tail) for
       small omega, lam < 1.
  Regime constants are computed once before the loop; each trip costs a few
  transcendentals per lane.  Envelope bounds get a 1e-4 relative safety
  margin so float rounding can never produce an invalid (biasing) envelope;
  rejection absorbs the slack.

Density convention (matching the reference):
  f(x) prop. x^{p-1} exp(-(a x + b / x) / 2)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_inverse_gaussian(key, mu, lam):
    """Michael-Schucany-Haas: exact, rejection-free."""
    k1, k2 = jax.random.split(key)
    nu = jax.random.normal(k1, jnp.shape(mu), dtype=jnp.result_type(mu))
    y = nu**2
    x = mu + mu**2 * y / (2.0 * lam) - mu / (2.0 * lam) * jnp.sqrt(
        4.0 * mu * lam * y + (mu * y) ** 2
    )
    u = jax.random.uniform(k2, jnp.shape(mu), dtype=jnp.result_type(mu))
    return jnp.where(u <= mu / (mu + x), x, mu**2 / jnp.maximum(x, 1e-30))


# ------------------------------------------------- standardized general-p
def _log_g(y, lam, omega):
    """log of the unnormalized standardized density
    g(y) = y^(lam-1) exp(-(omega/2)(y + 1/y))."""
    y = jnp.maximum(y, 1e-30)
    return (lam - 1.0) * jnp.log(y) - 0.5 * omega * (y + 1.0 / y)


def _gig_mode(lam, omega):
    """argmax of g: ((lam-1) + sqrt((lam-1)^2 + omega^2)) / omega.

    For lam < 1 the numerator is a difference of nearly-equal numbers and
    cancels catastrophically in f32 when omega << 1 - lam (it rounded to a
    0 mode, which poisoned the envelope normalization and made the sampler
    return 0); the algebraically-equal conjugate form
    omega / (sqrt((lam-1)^2 + omega^2) + (1 - lam)) is a sum of positives
    there and exact to roundoff."""
    lm1 = lam - 1.0
    root = jnp.sqrt(lm1**2 + omega**2)
    return jnp.where(
        lm1 >= 0.0, (lm1 + root) / omega, omega / (root - lm1)
    )


def _cubic_roots(p2, p1, p0):
    """All three real roots of x^3 + p2 x^2 + p1 x + p0 (trigonometric
    Cardano; the shifted-RoU cubic always has three real roots).  Returns
    (r0, r1, r2) unordered."""
    q = p1 - p2**2 / 3.0
    r = p0 + (2.0 * p2**3 - 9.0 * p2 * p1) / 27.0
    # t^3 + q t + r = 0 with discriminant < 0 -> three real roots
    mq3 = jnp.sqrt(jnp.maximum(-q / 3.0, 1e-30))
    arg = jnp.clip(3.0 * r / (2.0 * q * mq3 + 1e-30), -1.0, 1.0)
    # note: 3r/(2q) * sqrt(-3/q) = 3r / (2 q mq3) with mq3 = sqrt(-q/3)
    theta = jnp.arccos(arg)
    shift = -p2 / 3.0

    def root(k):
        return 2.0 * mq3 * jnp.cos((theta - 2.0 * jnp.pi * k) / 3.0) + shift

    return root(0.0), root(1.0), root(2.0)


def _sample_gig_std(key, lam, omega, max_trips: int = 256):
    """Y ~ GIG(lam, omega, omega) elementwise, lam >= 0, omega > 0."""
    dtype = jnp.result_type(lam, omega, jnp.float32)
    lam = jnp.asarray(lam, dtype)
    omega = jnp.asarray(omega, dtype)
    shape = jnp.broadcast_shapes(lam.shape, omega.shape)
    lam = jnp.broadcast_to(lam, shape)
    omega = jnp.broadcast_to(jnp.maximum(omega, 1e-12), shape)
    margin = jnp.asarray(1.0 + 1e-4, dtype)

    m = _gig_mode(lam, omega)
    log_gm = _log_g(m, lam, omega)  # normalize by g(m) so v+ = 1

    # regime flags (Hormann-Leydold 2014 selection)
    r1 = (lam >= 1.0) | (omega > 1.0)
    small = omega < jnp.minimum(0.5, (2.0 / 3.0) * jnp.sqrt(jnp.maximum(1.0 - lam, 0.0)))
    r3 = (~r1) & small & (lam > 1e-3)
    r2 = (~r1) & (~r3)

    # --- R1 constants: u-extrema from the cubic
    # d/dx log[(x-m)^2 g(x)] = 0  <=>
    # x^3 - (m + 2(lam+1)/omega) x^2 + (2(lam-1)m/omega - 1) x + m = 0
    p2 = -(m + 2.0 * (lam + 1.0) / omega)
    p1 = 2.0 * (lam - 1.0) * m / omega - 1.0
    p0 = m
    ra, rb, rc = _cubic_roots(p2, p1, p0)
    roots = jnp.stack([ra, rb, rc])
    # x- : largest root strictly below m (in (0, m)); x+ : smallest above m
    below = jnp.where((roots < m) & (roots > 0.0), roots, -jnp.inf)
    above = jnp.where(roots > m, roots, jnp.inf)
    xm = jnp.max(below, axis=0)
    xp = jnp.min(above, axis=0)
    xm = jnp.clip(xm, 1e-12, m)  # guard degenerate cubics
    xp = jnp.maximum(xp, m)
    u_lo = (xm - m) * jnp.exp(0.5 * (_log_g(xm, lam, omega) - log_gm)) * margin
    u_hi = (xp - m) * jnp.exp(0.5 * (_log_g(xp, lam, omega) - log_gm)) * margin

    # --- R2 constants: sup x sqrt(g) at xr = ((lam+1)+sqrt((lam+1)^2+omega^2))/omega
    lp1 = lam + 1.0
    xr = (lp1 + jnp.sqrt(lp1**2 + omega**2)) / omega
    u2_hi = xr * jnp.exp(0.5 * (_log_g(xr, lam, omega) - log_gm)) * margin

    # --- R3 constants: Gamma(lam, omega/2) proposal for the small-omega,
    # lam < 1 regime.  In standardized units T = (omega/2) X ~ Gamma(lam, 1),
    # sampled by the Ahrens-Dieter two-piece envelope split at t = 1
    # (t^(lam-1) body / e^-t tail), with the remaining GIG factor
    # e^(-omega/(2X)) = e^(-omega^2/(4T)) folded into the same accept test.
    # Unlike a split at x0 = omega/(1-lam) (whose tail envelope is loose by
    # ~omega^(2(lam-1)) and collapses acceptance at small omega), this
    # acceptance stays O(1) uniformly as omega -> 0.
    lam3 = jnp.maximum(lam, 1e-3)
    A1 = 1.0 / lam3
    p_piece1 = A1 / (A1 + jnp.exp(-1.0))

    def trip(state):
        key, y, done, trips = state
        key, k1, k2, k3 = jax.random.split(key, 4)
        u1 = jax.random.uniform(k1, shape, dtype)
        u2 = jax.random.uniform(k2, shape, dtype)
        u3 = jax.random.uniform(k3, shape, dtype)

        # R1: shifted RoU
        U1 = u_lo + u1 * (u_hi - u_lo)
        V1 = u2  # v+ = 1 after normalization (with margin folded into u)
        X1 = U1 / jnp.maximum(V1, 1e-30) + m
        acc1 = (X1 > 0.0) & (
            2.0 * jnp.log(jnp.maximum(V1, 1e-30)) <= _log_g(X1, lam, omega) - log_gm
        )

        # R2: plain RoU
        U2 = u1 * u2_hi
        V2 = u2
        X2 = U2 / jnp.maximum(V2, 1e-30)
        acc2 = 2.0 * jnp.log(jnp.maximum(V2, 1e-30)) <= _log_g(X2, lam, omega) - log_gm

        # R3: Gamma proposal (Ahrens-Dieter pieces) + GIG small-x thinning
        use1 = u1 < p_piece1
        log_u3 = jnp.log(jnp.maximum(u3, 1e-30))
        Ta = jnp.maximum(u2 ** (1.0 / lam3), 1e-30)  # t^(lam-1) body, (0, 1]
        acc_a = log_u3 <= -Ta - omega**2 / (4.0 * Ta)
        Tb = 1.0 - jnp.log(jnp.maximum(u2, 1e-30))  # e^-t tail, (1, inf)
        acc_b = log_u3 <= (lam3 - 1.0) * jnp.log(Tb) - omega**2 / (4.0 * Tb)
        T = jnp.where(use1, Ta, Tb)
        X3 = 2.0 * T / omega
        acc3 = jnp.where(use1, acc_a, acc_b)

        X = jnp.where(r1, X1, jnp.where(r2, X2, X3))
        acc = jnp.where(r1, acc1, jnp.where(r2, acc2, acc3))
        newly = (~done) & acc
        y = jnp.where(newly, X, y)
        return key, y, done | newly, trips + 1

    def cond(state):
        _, _, done, trips = state
        return jnp.logical_and(~jnp.all(done), trips < max_trips)

    init = (key, m, jnp.zeros(shape, bool), jnp.zeros([], jnp.int32))
    _, y, _, _ = jax.lax.while_loop(cond, trip, init)
    return y


def sample_gig(key, a, b, p, max_trips: int = 256):
    """Draw X ~ GIG(a, b, p) elementwise.

    a, b: same-shape (or broadcastable) arrays; p: python float or array.
    |p| = 1/2 with scalar p takes the exact rejection-free inverse-Gaussian
    route; everything else uses the standardized three-regime rejection
    sampler (general p, including the |p| = 3/2 draws of the Matern-3/2
    Gibbs path and arbitrary user @augmodel augmentations)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    shape = jnp.broadcast_shapes(jnp.shape(a), jnp.shape(b), jnp.shape(jnp.asarray(p)))
    a = jnp.broadcast_to(jnp.maximum(a, 1e-12), shape)
    b = jnp.broadcast_to(jnp.maximum(b, 1e-12), shape)
    if isinstance(p, (int, float)):
        if p == -0.5:
            return sample_inverse_gaussian(key, jnp.sqrt(b / a), b)
        if p == 0.5:
            # 1/X ~ GIG(b, a, -1/2) = InverseGaussian(sqrt(a/b), a)
            inv = sample_inverse_gaussian(key, jnp.sqrt(a / b), a)
            return 1.0 / inv
    p_arr = jnp.broadcast_to(jnp.asarray(p, a.dtype), shape)
    lam = jnp.abs(p_arr)
    omega = jnp.sqrt(a * b)
    y = _sample_gig_std(key, lam, omega, max_trips=max_trips)
    scale = jnp.sqrt(b / a)
    return jnp.where(p_arr >= 0.0, scale * y, scale / y)


def gig_mean(a, b, p):
    """E[X] for GIG(a, b, p) = sqrt(b/a) K_{p+1}(omega)/K_p(omega),
    closed-form Bessel ratios for half-integer p."""
    sab = jnp.sqrt(a * b)
    scale = jnp.sqrt(b / a)
    if isinstance(p, (int, float)) and abs(abs(p) - 0.5) < 1e-12:
        if p == 0.5:
            # K_{3/2}/K_{1/2} = 1 + 1/z
            return scale * (1.0 + 1.0 / sab)
        # p = -1/2: K_{1/2}/K_{-1/2} = 1
        return scale
    if isinstance(p, (int, float)) and abs(abs(p) - 1.5) < 1e-12:
        # K_{3/2}(z) = K_{1/2}(z)(1 + 1/z); K_{5/2}(z) = K_{1/2}(z)(1 + 3/z + 3/z^2)
        r_52_32 = (1.0 + 3.0 / sab + 3.0 / sab**2) / (1.0 + 1.0 / sab)
        if p == 1.5:
            return scale * r_52_32
        # p = -3/2: K_{-1/2}/K_{-3/2} = K_{1/2}/K_{3/2}
        return scale / (1.0 + 1.0 / sab)
    raise NotImplementedError(
        "closed-form gig_mean covers half-integer |p| in {1/2, 3/2}; use "
        "scipy.special.kv for general p"
    )


def gig_mean_inv(a, b, p):
    """E[1/X] = sqrt(a/b) K_{p-1}(omega)/K_p(omega), half-integer p."""
    sab = jnp.sqrt(a * b)
    scale = jnp.sqrt(a / b)
    if isinstance(p, (int, float)) and abs(abs(p) - 0.5) < 1e-12:
        if p == -0.5:
            return scale * (1.0 + 1.0 / sab)
        return scale
    if isinstance(p, (int, float)) and abs(abs(p) - 1.5) < 1e-12:
        if p == 1.5:
            # K_{1/2}/K_{3/2} = z/(1+z) expressed via ratio
            return scale / (1.0 + 1.0 / sab)
        # p = -3/2: K_{-5/2}/K_{-3/2} = K_{5/2}/K_{3/2}
        return scale * (1.0 + 3.0 / sab + 3.0 / sab**2) / (1.0 + 1.0 / sab)
    raise NotImplementedError
