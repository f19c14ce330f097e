"""Dense linear-algebra primitives for the augmented-GP compute path.

Design notes
------------
The hot shapes here are small-to-medium (M = 32..512 inducing points) but are
executed every CAVI iteration, batched over the latent-GP axis ``L`` via
``vmap``.  All ops are jit-compatible, static-shaped, and keep data in
float32 (or float64 on CPU parity runs); the triangular solves use the XLA
`TriangularSolve` HLO.

Functional equivalents of the reference's Cholesky-centric helpers
(/root/reference/src/functions/utils.jl:104-108,
 /root/reference/src/gpblocks/latentgp.jl:201-237), re-derived for batched
array-of-latents layout instead of per-latent Julia structs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import jitter


def _highest_precision(fn):
    """Run fn's trace at HIGHEST matmul precision.

    Everything in this module is [M, M]-scale setup/conversion work
    (factorizations, triangular solves, inverses, eta <-> moments), NOT the
    per-datapoint B-axis matmuls -- so the full-f32 cost is negligible.
    It is also where low precision is catastrophic: a TF32 or one-pass
    bf16 matmul (what an f32 DEFAULT dot may run as on an accelerator)
    inside XLA's blocked TriangularSolve/inverse gives O(1) errors on
    ill-conditioned 64x64 kernel matrices, since the error is amplified by
    cond(K).  Dot/solve transpose rules inherit the primal precision, so
    gradients through these ops are covered too."""
    import functools

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with jax.default_matmul_precision("highest"):
            return fn(*a, **kw)

    return wrapped


@_highest_precision
def safe_cholesky(K: jnp.ndarray, jitt: float | None = None) -> jnp.ndarray:
    """Lower Cholesky factor of ``K + jitt*I`` with an adaptive jitter
    ladder: if the factorization fails (NaNs -- common for large-N RBF
    Grams in float32), the jitter is multiplied by 10, up to 4 times.
    The ladder is a bounded lax.while_loop, so the Cholesky is traced once
    (the reference's fixed dtype-scaled jitter, functions/utils.jl:8-13,
    is the first rung)."""
    if jitt is None:
        jitt = jitter(K.dtype)
    M = K.shape[-1]
    eye = jnp.eye(M, dtype=K.dtype)

    # pick the jitter level on a stop_gradient'd copy (the discrete choice is
    # non-differentiable; keeping the ladder out of the AD graph also keeps
    # reverse-mode through lax.while_loop legal)
    Ksg = jax.lax.stop_gradient(K)

    def ok(j):
        return jnp.logical_not(
            jnp.any(jnp.isnan(jnp.linalg.cholesky(Ksg + j * eye)))
        )

    def cond(carry):
        j, tries = carry
        return jnp.logical_and(jnp.logical_not(ok(j)), tries < 4)

    def body(carry):
        j, tries = carry
        return j * 10.0, tries + 1

    j_star, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(jitt, K.dtype), jnp.zeros([], jnp.int32))
    )
    return jnp.linalg.cholesky(K + j_star * eye)


@_highest_precision
def psd_safe_cholesky(A: jnp.ndarray, base: float | None = None) -> jnp.ndarray:
    """Cholesky of a matrix that is PD by construction (e.g. -2 eta2, a sum
    of PSD statistics and a PD prior precision) but can be pushed slightly
    indefinite by f32 matmul rounding.  Unlike :func:`safe_cholesky`
    (whose first rung already adds the base jitter -- the convention for
    kernel grams), this ladder STARTS AT ZERO: exact whenever the plain
    factorization succeeds, escalating base*10^k only on NaN.

    The default base is NORM-RELATIVE: max(jitter(dtype), 3e-7 * mean
    diagonal).  A = 2 S2 + K^-1 can reach ||A|| ~ 1e7 in f32 (theta up to
    sqrt(a)/sqrt(Ktilde) for the heavy-tailed likelihoods), where the true
    bottom eigenvalues O(1/lambda_max(K)) sit below the f32 rounding of the
    top -- an absolute ladder capped at 10x jitter cannot restore
    positive-definiteness there (laplace with beta=0.1 NaN'd the chain at
    step 1; the relative ladder recovers with O(norm * eps) distortion of
    the least-informed directions only)."""
    M = A.shape[-1]
    if base is None:
        mean_diag = jnp.mean(jnp.abs(jnp.diagonal(
            jax.lax.stop_gradient(A), axis1=-2, axis2=-1)))
        base = jnp.maximum(
            jnp.asarray(jitter(A.dtype), A.dtype),
            (3e-7 * mean_diag).astype(A.dtype),
        )
    eye = jnp.eye(M, dtype=A.dtype)
    Asg = jax.lax.stop_gradient(A)

    def jit_at(i):
        return jnp.where(
            i == 0, jnp.asarray(0.0, A.dtype), base * 10.0 ** (i - 1)
        ).astype(A.dtype)

    def ok(i):
        return jnp.logical_not(
            jnp.any(jnp.isnan(jnp.linalg.cholesky(Asg + jit_at(i) * eye)))
        )

    def cond(i):
        return jnp.logical_and(jnp.logical_not(ok(i)), i < 5)

    i_star = jax.lax.while_loop(cond, lambda i: i + 1, jnp.zeros([], jnp.int32))
    return jnp.linalg.cholesky(A + jit_at(i_star) * eye)


@_highest_precision
def chol_solve(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve ``A x = B`` given the lower Cholesky factor ``L`` of ``A``."""
    y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


@_highest_precision
def chol_inv(L: jnp.ndarray) -> jnp.ndarray:
    """Inverse of ``A`` from its lower Cholesky factor, symmetrized."""
    A_inv = chol_solve(L, jnp.eye(L.shape[-1], dtype=L.dtype))
    return symmetrize(A_inv)


def chol_logdet(L: jnp.ndarray) -> jnp.ndarray:
    """log|A| from the lower Cholesky factor of A."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


@_highest_precision
def invquad(L: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """x^T A^-1 x given the lower Cholesky factor of A
    (reference: functions/utils.jl `invquad`)."""
    v = jax.scipy.linalg.solve_triangular(L, x, lower=True)
    return jnp.sum(v * v, axis=0) if v.ndim == 1 else jnp.sum(v * v)


def symmetrize(A: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))


def diag_ABt(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """diag(A @ B^T) without forming the product
    (reference: functions/utils.jl:66-69)."""
    return jnp.sum(A * B, axis=-1)


def trace_ABt(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """tr(A @ B^T) = <A, B> (reference: functions/utils.jl:60-63)."""
    return jnp.sum(A * B)


def kappa_diag_theta_kappa(kappa: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    """kappa^T diag(theta) kappa -- the [B,M]x[B]->[M,M] contraction that is
    the single cross-data reduction of a sparse CAVI step
    (reference: functions/utils.jl:76-84).  On a sharded data axis this is the
    op whose result gets `psum`-ed."""
    return jnp.einsum(
        "bm,b,bn->mn", kappa, theta, kappa, preferred_element_type=kappa.dtype
    )


@_highest_precision
def nat_to_moments(eta1: jnp.ndarray, eta2: jnp.ndarray):
    """Convert natural parameters to (mu, Sigma):
    Sigma = -1/2 eta2^-1, mu = Sigma eta1
    (reference: inference/inference.jl:25-28).

    eta2 is symmetric negative-definite mathematically; in f32 the bottom of
    its spectrum can round indefinite when the statistics are large (see
    psd_safe_cholesky), so the zero-first jitter ladder is the DEFAULT --
    exact whenever the plain factorization succeeds, NaN-free otherwise.
    """
    M = eta1.shape[-1]
    L = psd_safe_cholesky(-(symmetrize(eta2)))
    Sigma = 0.5 * chol_solve(L, jnp.eye(M, dtype=eta1.dtype))
    Sigma = symmetrize(Sigma)
    mu = Sigma @ eta1
    return mu, Sigma


@_highest_precision
def nat_to_moments_warm(
    eta1: jnp.ndarray,
    eta2: jnp.ndarray,
    Sigma_prev: jnp.ndarray,
    schulz_iters: int = 4,
    rho_max: float = 0.35,
):
    """Matmul-only variant of :func:`nat_to_moments` for the
    inner CAVI loop.

    Sigma = A^-1 with A = -2 eta2 is computed by Newton-Schulz iteration
    X <- X (2I - A X), warm-started at the previous iteration's Sigma.  The
    natural parameters move by O(learning-rate) per CAVI step, so the warm
    start is close and the quadratic iteration converges in a few steps:
    residual after k steps is rho0^(2^k) with rho0 = ||I - A Sigma_prev||_F.
    When the warm start is too far (rho0 > rho_max -- early iterations,
    post-hyperparameter jumps), fall back to the exact Cholesky path inside
    a lax.cond.  With rho_max = 0.35 and 4 iterations the Schulz branch is
    exact to ~5e-8 relative (0.35^16), below f32 roundoff of the product;
    the tight gate falls back to Cholesky slightly more often right after
    hyperparameter jumps.

    Rationale: the small-M Cholesky + two triangular solves are a chain of
    small sequential kernels, while 2 matmuls/iteration of [M, M] are two
    dense products.  Which is faster is measured per device class (PERF.md;
    analytic_vi.FAST_MOMENTS_MAX_DIM).
    """
    M = eta1.shape[-1]
    I = jnp.eye(M, dtype=eta1.dtype)
    A = -2.0 * symmetrize(eta2)
    R0 = I - A @ Sigma_prev
    rho0 = jnp.sqrt(jnp.sum(R0 * R0))

    def schulz(_):
        def body(X, _):
            return X @ (2.0 * I - A @ X), None

        X, _ = jax.lax.scan(body, Sigma_prev, None, length=schulz_iters)
        return symmetrize(X)

    def chol(_):
        L = psd_safe_cholesky(0.5 * A)
        return symmetrize(0.5 * chol_solve(L, I))

    # NaN rho0 must take the exact/ladder branch (>= on the complement)
    Sigma = jax.lax.cond(~(rho0 >= rho_max) & jnp.isfinite(rho0), schulz, chol, None)
    return Sigma @ eta1, Sigma


@_highest_precision
def nat_to_moments_warm_batched(
    eta1: jnp.ndarray,
    eta2: jnp.ndarray,
    Sigma_prev: jnp.ndarray,
    schulz_iters: int = 4,
    rho_max: float = 0.35,
    safe: bool = True,
):
    """[L, ...] batched :func:`nat_to_moments_warm`.

    The Schulz-vs-Cholesky decision is one SHARED predicate (worst residual
    over the latent axis): a vmapped `lax.cond` would lower to a select that
    executes BOTH branches for every latent, costing more than the Cholesky
    alone.  One early latent falling back sends the whole stack down the
    exact path -- correct either way, and the warm start is good for all
    latents within a few iterations.

    safe=True routes the Cholesky fallback through the adaptive jitter
    ladder (:func:`safe_cholesky`).  The streaming/online natural
    parameters include the kappa_a^T invDa kappa_a old-posterior
    correction, which f32 matmul rounding can push slightly indefinite
    right after an inducing-set update -- the plain factorization then NaNs
    the whole chain, while the ladder recovers with the smallest jitter
    that restores positive-definiteness (exact whenever no rung fires)."""
    M = eta1.shape[-1]
    I = jnp.eye(M, dtype=eta1.dtype)
    A = -2.0 * symmetrize(eta2)
    R0 = I - jnp.einsum("lmn,lnk->lmk", A, Sigma_prev, preferred_element_type=A.dtype)
    rho0 = jnp.max(jnp.sqrt(jnp.sum(R0 * R0, axis=(-2, -1))))

    def schulz(_):
        def body(X, _):
            AX = jnp.einsum("lmn,lnk->lmk", A, X, preferred_element_type=A.dtype)
            return jnp.einsum(
                "lmn,lnk->lmk", X, 2.0 * I - AX, preferred_element_type=A.dtype
            ), None

        X, _ = jax.lax.scan(body, Sigma_prev, None, length=schulz_iters)
        return symmetrize(X)

    def chol(_):
        def one(a):
            L = psd_safe_cholesky(0.5 * a) if safe else jnp.linalg.cholesky(0.5 * a)
            return symmetrize(0.5 * chol_solve(L, I))

        return jax.vmap(one)(A)

    # a NaN anywhere in the residual must take the exact/ladder branch, not
    # the (NaN-propagating) Schulz iteration: use >= on the complement
    Sigma = jax.lax.cond(~(rho0 >= rho_max) & jnp.isfinite(rho0), schulz, chol, None)
    mu = jnp.einsum("lmn,ln->lm", Sigma, eta1)
    return mu, Sigma


@_highest_precision
def nat_to_moments_safe(eta1: jnp.ndarray, eta2: jnp.ndarray):
    """:func:`nat_to_moments` with the zero-first jitter ladder on the
    -eta2 factorization (see `nat_to_moments_warm_batched(safe=True)`):
    exact whenever the plain Cholesky succeeds."""
    M = eta1.shape[-1]
    L = psd_safe_cholesky(-(symmetrize(eta2)))
    Sigma = 0.5 * chol_solve(L, jnp.eye(M, dtype=eta1.dtype))
    Sigma = symmetrize(Sigma)
    mu = Sigma @ eta1
    return mu, Sigma


@_highest_precision
def moments_to_nat(mu: jnp.ndarray, Sigma: jnp.ndarray):
    """Inverse of :func:`nat_to_moments`: eta1 = Sigma^-1 mu, eta2 = -1/2 Sigma^-1."""
    L = jnp.linalg.cholesky(symmetrize(Sigma))
    Sigma_inv = chol_inv(L)
    return Sigma_inv @ mu, -0.5 * Sigma_inv
