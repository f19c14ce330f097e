"""Kernel (covariance-function) library.

The reference delegates kernels to KernelFunctions.jl and re-exports it as
part of its API (/root/reference/src/AugmentedGaussianProcesses.jl:30-33).
This package internalizes an equivalent library:

* every Gram matrix is computed through one batched matmul
  (``|x|^2 + |z|^2 - 2 x z^T``) followed by a fused elementwise map;
* kernels are immutable pytree dataclasses; their float leaves *are* the
  trainable hyperparameters (all positive, optimized in log space, matching
  the reference's positive-parameter update rule,
  /root/reference/src/hyperparameter/autotuning_utils.jl:47-83);
* a model holds one kernel pytree whose leaves carry a leading latent axis
  [L, ...]; per-latent Grams are obtained with ``jax.vmap`` over the pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple, Union

import jax
import jax.numpy as jnp
from .utils import struct


def _scale(X: jnp.ndarray, lengthscale) -> jnp.ndarray:
    return X / lengthscale


def _use_bf16_gram() -> bool:
    import os

    return bool(os.environ.get("AGP_TPU_BF16_GRAM"))


def sq_dist(X: jnp.ndarray, Z: jnp.ndarray) -> jnp.ndarray:
    """Pairwise squared Euclidean distance via the matmul identity.

    The cross-term dot runs at HIGHEST matmul precision: xx + zz - 2 xz is
    a catastrophic cancellation, and an f32 DEFAULT matmul (TF32 on an
    NVIDIA GPU, ~1e-3 relative) perturbs the Gram enough to wreck
    ill-conditioned cases (the dense N=512 heteroscedastic oracle, SVGP
    hyperopt from a long-lengthscale init with near-singular Kmm).  The
    D-axis contraction is tiny (D = 2..20) next to the M-axis matmuls, so
    the full-f32 cost is noise.

    With AGP_TPU_BF16_GRAM=1 the cross-term matmul instead runs in
    bfloat16 with float32 accumulation; the norm terms stay
    f32 so the diagonal is exact.  Off by default: ~1e-2 relative error in
    the Gram is usually harmless for well-conditioned sparse CAVI (a
    fixed-point iteration) but unsafe for dense/ill-conditioned grams."""
    xx = jnp.sum(X * X, axis=-1)
    zz = jnp.sum(Z * Z, axis=-1)
    if _use_bf16_gram() and X.dtype == jnp.float32:
        xz = jnp.dot(
            X.astype(jnp.bfloat16),
            Z.astype(jnp.bfloat16).T,
            preferred_element_type=jnp.float32,
        )
    else:
        xz = jnp.dot(X, Z.T, precision=jax.lax.Precision.HIGHEST)
    d2 = xx[:, None] + zz[None, :] - 2.0 * xz
    return jnp.maximum(d2, 0.0)


def dist(X: jnp.ndarray, Z: jnp.ndarray) -> jnp.ndarray:
    # sqrt has infinite gradient at 0; clamp like standard GP libraries do.
    return jnp.sqrt(jnp.maximum(sq_dist(X, Z), 1e-36))


class Kernel(struct.PyTreeNode):
    """Base kernel. Subclasses implement `gram` and `diag`.

    Trainable float leaves are positive by default and are optimized in log
    space by the hyperparameter step (the reference's
    ``x .= exp.(log.(x) .+ Delta)`` rule, autotuning_utils.jl:47-83).
    A subclass whose parameters are sign-indefinite (e.g. a linear input
    transform's matrix) lists those field names in ``FREE_PARAMS``; the
    hyper step then updates them unconstrained (see `to_unconstrained`).
    Parameters constrained to (0, 1) (e.g. the FBM Hurst index) go in
    ``UNIT_PARAMS`` and are optimized through a logit/sigmoid
    reparameterization.
    """

    FREE_PARAMS = frozenset()  # no annotation: class attr, not a dataclass field
    UNIT_PARAMS = frozenset()

    def gram(self, X: jnp.ndarray, Z: jnp.ndarray | None = None) -> jnp.ndarray:
        raise NotImplementedError

    def diag(self, X: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def __add__(self, other: "Kernel") -> "Kernel":
        return SumKernel(left=self, right=other)

    def __mul__(self, other: Union["Kernel", float]) -> "Kernel":
        if isinstance(other, Kernel):
            return ProductKernel(left=self, right=other)
        return self.replace(variance=self.variance * other)

    __rmul__ = __mul__


class StationaryKernel(Kernel):
    """Stationary kernel with ARD lengthscale and output variance."""

    lengthscale: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def _from_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        r2 = sq_dist(_scale(X, self.lengthscale), _scale(Z, self.lengthscale))
        return self.variance * self._from_r2(r2)

    def diag(self, X):
        return jnp.broadcast_to(self.variance, (X.shape[0],)).astype(X.dtype)


class SqExponentialKernel(StationaryKernel):
    """k(x,z) = v * exp(-|x-z|^2 / (2 l^2)) (a.k.a. RBF)."""

    def _from_r2(self, r2):
        return jnp.exp(-0.5 * r2)


RBFKernel = SqExponentialKernel


class Matern12Kernel(StationaryKernel):
    """k = v * exp(-r) (exponential / Ornstein-Uhlenbeck)."""

    def _from_r2(self, r2):
        return jnp.exp(-jnp.sqrt(jnp.maximum(r2, 1e-36)))


class Matern32Kernel(StationaryKernel):
    def _from_r2(self, r2):
        r = jnp.sqrt(jnp.maximum(3.0 * r2, 1e-36))
        return (1.0 + r) * jnp.exp(-r)


class Matern52Kernel(StationaryKernel):
    def _from_r2(self, r2):
        r = jnp.sqrt(jnp.maximum(5.0 * r2, 1e-36))
        return (1.0 + r + r**2 / 3.0) * jnp.exp(-r)


class RationalQuadraticKernel(StationaryKernel):
    alpha: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(2.0))

    def _from_r2(self, r2):
        return (1.0 + r2 / (2.0 * self.alpha)) ** (-self.alpha)


class CosineKernel(StationaryKernel):
    """k = v * prod_d cos(2 pi (x_d - z_d) / l_d) -- the per-dimension
    product form is PSD (cos of a difference factorizes into cos/sin
    features); a cos of the Euclidean norm would not be."""

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        diff = X[:, None, :] - Z[None, :, :]
        return self.variance * jnp.prod(
            jnp.cos(2.0 * jnp.pi * diff / self.lengthscale), axis=-1
        )


class PeriodicKernel(StationaryKernel):
    period: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        # sum_d sin^2(pi (x_d - z_d) / p) / l_d^2
        diff = X[:, None, :] - Z[None, :, :]  # [N, M, D]
        s = jnp.sin(jnp.pi * diff / self.period) / self.lengthscale
        return self.variance * jnp.exp(-2.0 * jnp.sum(s * s, axis=-1))


class LinearKernel(Kernel):
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))
    bias: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1e-12))

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        xz = jnp.dot(X, Z.T, precision=jax.lax.Precision.HIGHEST)
        return self.variance * xz + self.bias

    def diag(self, X):
        return self.variance * jnp.sum(X * X, axis=-1) + self.bias


class PolynomialKernel(Kernel):
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))
    bias: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))
    degree: int = struct.field(pytree_node=False, default=2)

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        xz = jnp.dot(X, Z.T, precision=jax.lax.Precision.HIGHEST)
        return self.variance * (xz + self.bias) ** self.degree

    def diag(self, X):
        return self.variance * (jnp.sum(X * X, axis=-1) + self.bias) ** self.degree


class ConstantKernel(Kernel):
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        return jnp.broadcast_to(self.variance, (X.shape[0], Z.shape[0])).astype(X.dtype)

    def diag(self, X):
        return jnp.broadcast_to(self.variance, (X.shape[0],)).astype(X.dtype)


class WhiteKernel(Kernel):
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def gram(self, X, Z=None):
        if Z is None or Z is X:
            return self.variance * jnp.eye(X.shape[0], dtype=X.dtype)
        return jnp.zeros((X.shape[0], Z.shape[0]), dtype=X.dtype)

    def diag(self, X):
        return jnp.broadcast_to(self.variance, (X.shape[0],)).astype(X.dtype)


class ExponentiatedKernel(Kernel):
    """k(x,z) = v * exp(x.z / l^2) -- the exponentiated dot-product kernel
    (KernelFunctions.jl ExponentiatedKernel, re-exported by the reference
    at src/AugmentedGaussianProcesses.jl:30-33)."""

    lengthscale: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        Xs, Zs = _scale(X, self.lengthscale), _scale(Z, self.lengthscale)
        return self.variance * jnp.exp(
            jnp.dot(Xs, Zs.T, precision=jax.lax.Precision.HIGHEST)
        )

    def diag(self, X):
        Xs = _scale(X, self.lengthscale)
        return self.variance * jnp.exp(jnp.sum(Xs * Xs, axis=-1))


class PiecewisePolynomialKernel(StationaryKernel):
    """Compactly-supported (Wendland) piecewise-polynomial kernel of degree
    q in {0,1,2,3}: PSD in dimension D with j = floor(D/2) + q + 1 and
    k = v * (1-r)_+^(j+o) * P_q(r) (GPML Table 4.1; KernelFunctions.jl
    PiecewisePolynomialKernel).  Compact support (k = 0 for r >= 1) makes
    the Gram sparse in the lengthscale-local sense -- it is computed dense
    like every other stationary kernel (dense matmuls beat sparse formats at
    these sizes)."""

    degree: int = struct.field(pytree_node=False, default=0)

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        r = jnp.sqrt(
            jnp.maximum(
                sq_dist(_scale(X, self.lengthscale), _scale(Z, self.lengthscale)),
                1e-36,
            )
        )
        D = X.shape[-1]
        j = D // 2 + self.degree + 1
        base = jnp.maximum(1.0 - r, 0.0)
        if self.degree == 0:
            poly, o = jnp.ones_like(r), 0
        elif self.degree == 1:
            poly, o = (j + 1.0) * r + 1.0, 1
        elif self.degree == 2:
            poly = ((j**2 + 4.0 * j + 3.0) * r * r + (3.0 * j + 6.0) * r + 3.0) / 3.0
            o = 2
        elif self.degree == 3:
            poly = (
                (j**3 + 9.0 * j**2 + 23.0 * j + 15.0) * r**3
                + (6.0 * j**2 + 36.0 * j + 45.0) * r * r
                + (15.0 * j + 45.0) * r
                + 15.0
            ) / 15.0
            o = 3
        else:
            raise ValueError("degree must be in {0,1,2,3}")
        return self.variance * base ** (j + o) * poly


class FBMKernel(Kernel):
    """Fractional-Brownian-motion kernel
    k(x,z) = v/2 * (|x|^(2h) + |z|^(2h) - |x-z|^(2h)), Hurst index
    h in (0,1) (KernelFunctions.jl FBMKernel).  h is stored directly; the
    hyper step optimizes it through a logit/sigmoid reparameterization
    (UNIT_PARAMS), so gradient updates can never push h past 1 (which
    would make the kernel non-PSD and NaN the Cholesky)."""

    UNIT_PARAMS = frozenset({"hurst"})

    hurst: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(0.5))
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def _pow2h(self, sq):
        return jnp.maximum(sq, 1e-36) ** self.hurst

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        xx = jnp.sum(X * X, axis=-1)
        zz = jnp.sum(Z * Z, axis=-1)
        return (
            0.5
            * self.variance
            * (
                self._pow2h(xx)[:, None]
                + self._pow2h(zz)[None, :]
                - self._pow2h(sq_dist(X, Z))
            )
        )

    def diag(self, X):
        return self.variance * self._pow2h(jnp.sum(X * X, axis=-1))


class GaborKernel(Kernel):
    """Gabor kernel: squared-exponential envelope times a per-dimension
    cosine carrier, k = v * exp(-r^2/(2 l^2)) * prod_d cos(2 pi (x_d-z_d)/p_d)
    (KernelFunctions.jl GaborKernel = SqExp(l) * Cosine(p))."""

    lengthscale: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))
    period: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))
    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        r2 = sq_dist(_scale(X, self.lengthscale), _scale(Z, self.lengthscale))
        diff = X[:, None, :] - Z[None, :, :]
        carrier = jnp.prod(jnp.cos(2.0 * jnp.pi * diff / self.period), axis=-1)
        return self.variance * jnp.exp(-0.5 * r2) * carrier

    def diag(self, X):
        return jnp.broadcast_to(self.variance, (X.shape[0],)).astype(X.dtype)


class NeuralNetworkKernel(Kernel):
    """Neal/Williams infinite-width erf-network kernel
    k(x,z) = v * (2/pi) asin(2 xt.zt / sqrt((1+2 xt.xt)(1+2 zt.zt))) with
    xt = (1, x) (KernelFunctions.jl NeuralNetworkKernel convention without
    the leading 1; we include the bias feature as GPML eq. 4.29 does)."""

    variance: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def _aug(self, X):
        # 1 + 2 xt.xt with xt = (1, x)
        return 3.0 + 2.0 * jnp.sum(X * X, axis=-1)

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        xz = 1.0 + jnp.dot(X, Z.T, precision=jax.lax.Precision.HIGHEST)
        denom = jnp.sqrt(jnp.outer(self._aug(X), self._aug(Z)))
        arg = jnp.clip(2.0 * xz / denom, -1.0 + 1e-12, 1.0 - 1e-12)
        return self.variance * (2.0 / jnp.pi) * jnp.arcsin(arg)

    def diag(self, X):
        a = 1.0 + jnp.sum(X * X, axis=-1)
        arg = jnp.clip(2.0 * a / self._aug(X), -1.0, 1.0)
        return self.variance * (2.0 / jnp.pi) * jnp.arcsin(arg)


# ------------------------------------------------------------ input transforms
class Transform(struct.PyTreeNode):
    """Input transform t: R^D -> R^Q applied before a kernel
    (KernelFunctions.jl Transform protocol: ScaleTransform, ARDTransform,
    LinearTransform, SelectTransform, FunctionTransform, ChainTransform).
    Trainable leaves follow the same positivity/log-space convention as
    kernels; sign-indefinite leaves go in FREE_PARAMS."""

    FREE_PARAMS = frozenset()

    def __call__(self, X: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError


class ScaleTransform(Transform):
    """x -> s * x with a positive scalar s."""

    s: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    def __call__(self, X):
        return X * self.s


class ARDTransform(Transform):
    """x -> v .* x with a positive per-dimension vector v."""

    v: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray([1.0]))

    def __call__(self, X):
        return X * self.v


class LinearTransform(Transform):
    """x -> A x (rows of X right-multiplied by A^T).  A is sign-indefinite:
    updated unconstrained by the hyper step (FREE_PARAMS)."""

    A: jnp.ndarray = struct.field(default_factory=lambda: jnp.eye(1))
    FREE_PARAMS = frozenset({"A"})

    def __call__(self, X):
        return jnp.dot(X, self.A.T, precision=jax.lax.Precision.HIGHEST)


class SelectTransform(Transform):
    """x -> x[dims]: static feature subset (active-dimensions pattern)."""

    dims: Tuple[int, ...] = struct.field(pytree_node=False, default=(0,))

    def __call__(self, X):
        return X[..., jnp.asarray(self.dims)]


class FunctionTransform(Transform):
    """x -> f(x) for a static (non-trainable) row-wise callable."""

    fn: Callable = struct.field(pytree_node=False, default=None)

    def __call__(self, X):
        return self.fn(X)


class ChainTransform(Transform):
    """Composition t_n(... t_1(x)); applied left-to-right."""

    transforms: Tuple[Transform, ...] = struct.field(default_factory=tuple)

    def __call__(self, X):
        for t in self.transforms:
            X = t(X)
        return X


class TransformedKernel(Kernel):
    """k(t(x), t(z)): any kernel over transformed inputs
    (KernelFunctions.jl `kernel ∘ transform`)."""

    inner: Kernel = None
    transform: Transform = None

    def gram(self, X, Z=None):
        tX = self.transform(X)
        tZ = tX if Z is None else self.transform(Z)
        return self.inner.gram(tX, tZ)

    def diag(self, X):
        return self.inner.diag(self.transform(X))


def with_transform(kernel: Kernel, transform: Transform) -> TransformedKernel:
    """KernelFunctions' `k ∘ t` composition."""
    return TransformedKernel(inner=kernel, transform=transform)


# ------------------------------------------- positive/free parameter mapping
def _map_params(node: Any, f_pos, f_unit, mode: str = "pos"):
    if isinstance(node, (Kernel, Transform)):
        free = getattr(type(node), "FREE_PARAMS", frozenset())
        unit = getattr(type(node), "UNIT_PARAMS", frozenset())
        kw = {}
        for fld in dataclasses.fields(node):
            if not fld.metadata.get("pytree_node", True):
                continue  # static field: not a leaf, untouched
            v = getattr(node, fld.name)
            m = "free" if fld.name in free else ("unit" if fld.name in unit else "pos")
            kw[fld.name] = _map_params(v, f_pos, f_unit, m)
        return node.replace(**kw)
    if isinstance(node, tuple):
        return tuple(_map_params(v, f_pos, f_unit, mode) for v in node)
    if node is None:
        return None
    if mode == "free":
        return node
    if mode == "unit":
        return f_unit(node)
    return f_pos(node)


def to_unconstrained(kernel: Kernel) -> Kernel:
    """Map a kernel pytree to the space the hyperparameter optimizer works
    in: log on positive-constrained leaves, logit on UNIT_PARAMS leaves
    ((0,1)-constrained, e.g. the FBM Hurst index), identity on FREE_PARAMS
    leaves.  Inverse of `from_unconstrained`.  Backwards compatible with
    plain `tree_map(log, kernel)` for kernels without free/unit params."""
    return _map_params(kernel, jnp.log, lambda h: jnp.log(h) - jnp.log1p(-h))


def from_unconstrained(kernel: Kernel) -> Kernel:
    return _map_params(kernel, jnp.exp, jax.nn.sigmoid)


class SumKernel(Kernel):
    left: Kernel
    right: Kernel

    def gram(self, X, Z=None):
        return self.left.gram(X, Z) + self.right.gram(X, Z)

    def diag(self, X):
        return self.left.diag(X) + self.right.diag(X)


class ProductKernel(Kernel):
    left: Kernel
    right: Kernel

    def gram(self, X, Z=None):
        return self.left.gram(X, Z) * self.right.gram(X, Z)

    def diag(self, X):
        return self.left.diag(X) * self.right.diag(X)


def replicate(kernel: Kernel, n_latent: int) -> Kernel:
    """Stack a kernel's leaves with a leading latent axis [L, ...].

    The analog of the reference's per-latent ``deepcopy(kernel)``
    (/root/reference/src/models/VGP.jl etc.): one pytree, vmapped Grams.
    """
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_latent,) + jnp.shape(x)), kernel
    )


def batch_gram(kernel: Kernel, X, Z=None) -> jnp.ndarray:
    """[L, N, M] Gram stack from a replicated kernel ([L]-leading leaves)."""
    if Z is None:
        return jax.vmap(lambda k: k.gram(X, X))(kernel)
    if Z.ndim == 3:  # per-latent inducing sets
        return jax.vmap(lambda k, z: k.gram(X, z))(kernel, Z)
    return jax.vmap(lambda k: k.gram(X, Z))(kernel)


def batch_gram_zz(kernel: Kernel, Z) -> jnp.ndarray:
    """[L, M, M] Gram of per-latent inducing sets Z [L, M, D]."""
    return jax.vmap(lambda k, z: k.gram(z, z))(kernel, Z)


def batch_diag(kernel: Kernel, X) -> jnp.ndarray:
    return jax.vmap(lambda k: k.diag(X))(kernel)
