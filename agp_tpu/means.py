"""Prior mean functions.

Functional equivalents of the reference's PriorMean family
(/root/reference/src/mean/priormean.jl, constantmean.jl, zeromean.jl,
empiricalmean.jl, affinemean.jl).  Means are pytree dataclasses; their float
leaves are trainable (unconstrained -- plain gradient updates, unlike the
log-space kernel parameters), updated by `jax.grad` of the ELBO.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .utils import struct


class PriorMean(struct.PyTreeNode):
    def __call__(self, X: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError


class ZeroMean(PriorMean):
    def __call__(self, X):
        return jnp.zeros((X.shape[0],), dtype=X.dtype)


class ConstantMean(PriorMean):
    c: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(0.0))

    def __call__(self, X):
        return jnp.broadcast_to(self.c, (X.shape[0],)).astype(X.dtype)


class EmpiricalMean(PriorMean):
    """One free mean value per (inducing) point."""

    v: jnp.ndarray = struct.field(default_factory=lambda: jnp.zeros((1,)))

    def __call__(self, X):
        return jnp.broadcast_to(self.v, (X.shape[0],)).astype(X.dtype)


class AffineMean(PriorMean):
    w: jnp.ndarray = struct.field(default_factory=lambda: jnp.zeros((1,)))
    b: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(0.0))

    def __call__(self, X):
        return X @ self.w + self.b


def as_mean(mean, n_dim: int | None = None) -> PriorMean:
    """Coerce a scalar / vector / PriorMean into a PriorMean
    (reference behavior: models/VGP.jl mean kwarg handling)."""
    if isinstance(mean, PriorMean):
        return mean
    arr = jnp.asarray(mean)
    if arr.ndim == 0:
        return ConstantMean(c=arr)
    return EmpiricalMean(v=arr)


def replicate(mean: PriorMean, n_latent: int) -> PriorMean:
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_latent,) + jnp.shape(x)), mean
    )


def batch_call(mean: PriorMean, X, n_latent: int | None = None) -> jnp.ndarray:
    """[L, N] prior mean stack from a replicated mean.

    ZeroMean has no pytree leaves, so vmap cannot infer the latent axis from
    it; `n_latent` (or a per-latent X [L, N, D]) supplies it in that case.
    """
    has_leaves = len(jax.tree_util.tree_leaves(mean)) > 0
    if X.ndim == 3:
        if has_leaves:
            return jax.vmap(lambda m, x: m(x))(mean, X)
        return jax.vmap(lambda x: mean(x))(X)
    if has_leaves:
        return jax.vmap(lambda m: m(X))(mean)
    out = mean(X)
    L = 1 if n_latent is None else n_latent
    return jnp.broadcast_to(out, (L,) + out.shape)
