"""Inducing-point selection algorithms.

The reference outsources these to InducingPoints.jl (KmeansAlg, OIPS,
UniGrid, online updateZ; re-exported API, SURVEY.md section 1).  This
package internalizes equivalents:

* offline selection (`inducingpoints`) runs host-side (numpy) once, before
  training -- it is setup code, not hot-path;
* the *online* OIPS update (`oips_update`) runs on-device as a `lax.scan`
  over the batch with a fixed-capacity masked inducing set, because it
  executes every streaming batch inside the training step.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class KmeansAlg:
    """Lloyd's k-means on the inputs (reference: InducingPoints.KmeansAlg)."""

    k: int
    n_iters: int = 20

    def __call__(self, X, key=None):
        X = np.asarray(X)
        seed = 0 if key is None else int(np.asarray(key)[-1])
        from ..utils import native

        if native.available():  # OpenMP C++ Lloyd (native/agp_native.cpp)
            return jnp.asarray(native.kmeans(X, self.k, self.n_iters, seed))
        rng = np.random.RandomState(seed)
        idx = rng.choice(X.shape[0], size=min(self.k, X.shape[0]), replace=False)
        C = X[idx].copy()
        for _ in range(self.n_iters):
            d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(1)
            for j in range(C.shape[0]):
                pts = X[assign == j]
                if len(pts):
                    C[j] = pts.mean(0)
        return jnp.asarray(C)


@dataclasses.dataclass(frozen=True)
class RandomSubset:
    k: int

    def __call__(self, X, key=None):
        X = np.asarray(X)
        rng = np.random.RandomState(0 if key is None else int(key[-1]))
        idx = rng.choice(X.shape[0], size=min(self.k, X.shape[0]), replace=False)
        return jnp.asarray(X[idx])


@dataclasses.dataclass(frozen=True)
class UniGrid:
    """Uniform grid over the bounding box (1D/2D; reference: UniGrid)."""

    points_per_dim: int

    def __call__(self, X, key=None):
        X = np.asarray(X)
        D = X.shape[1]
        axes = [
            np.linspace(X[:, d].min(), X[:, d].max(), self.points_per_dim)
            for d in range(D)
        ]
        mesh = np.meshgrid(*axes, indexing="ij")
        return jnp.asarray(np.stack([m.ravel() for m in mesh], axis=1))


@dataclasses.dataclass(frozen=True)
class OIPS:
    """Online inducing-point selection (Galy-Fajou & Opper):
    accept a point when its maximum kernel correlation to the current set is
    below rho; fixed capacity cap for static shapes."""

    rho: float = 0.8
    capacity: int = 128

    def __call__(self, X, key=None, kernel=None):
        """Offline/batched init: sequential pass (C++ when the kernel is a
        scalar-lengthscale RBF or unspecified, numpy otherwise)."""
        X = np.asarray(X)
        from ..utils import native

        ls = 1.0
        simple = kernel is None
        if kernel is not None and type(kernel).__name__ in (
            "SqExponentialKernel",
            "RBFKernel",
        ):
            arr = np.asarray(kernel.lengthscale)
            if arr.ndim == 0:
                ls, simple = float(arr), True
        if simple and native.available():
            return jnp.asarray(native.oips(X, self.rho, ls, self.capacity))
        Z = [X[0]]
        for x in X[1:]:
            if kernel is None:
                corr = max(
                    float(np.exp(-0.5 * ((x - z) ** 2).sum())) for z in Z
                )
            else:
                kz = kernel.gram(jnp.asarray(x)[None, :], jnp.asarray(np.stack(Z)))
                corr = float(jnp.max(kz)) / float(kernel.diag(jnp.asarray(x)[None, :])[0])
            if corr < self.rho and len(Z) < self.capacity:
                Z.append(x)
        return jnp.asarray(np.stack(Z))


def inducingpoints(alg, X, key=None, kernel=None):
    """Select an initial inducing set (reference: InducingPoints.inducingpoints)."""
    if isinstance(alg, (OIPS, GreedyVariance)):
        return alg(X, key=key, kernel=kernel)
    return alg(X, key=key)


def oips_update(kernel, Z, mask, X_batch, rho: float):
    """On-device streaming OIPS update with a fixed-capacity masked set.

    Z: [M_cap, D] slots, mask: [M_cap] active flags.  A lax.scan over the
    batch preserves the sequential accept rule (each accepted point changes
    later correlations) while staying static-shaped.
    """
    cap = Z.shape[0]
    kdiag = kernel.diag(Z)  # [M_cap] prior variances at slots

    def body(carry, x):
        Z, mask = carry
        kv = kernel.gram(x[None, :], Z)[0]  # [M_cap]
        kx = kernel.diag(x[None, :])[0]
        corr = kv / jnp.sqrt(jnp.maximum(kx * kdiag, 1e-30))
        max_corr = jnp.max(jnp.where(mask, corr, -jnp.inf))
        n_active = jnp.sum(mask)
        accept = jnp.logical_and(max_corr < rho, n_active < cap)
        slot = jnp.argmin(mask)  # first inactive slot
        Z = jnp.where(
            accept,
            jax.lax.dynamic_update_slice(Z, x[None, :], (slot, 0)),
            Z,
        )
        mask = jnp.where(accept, mask.at[slot].set(True), mask)
        return (Z, mask), accept

    (Z, mask), _ = jax.lax.scan(body, (Z, mask), X_batch)
    return Z, mask


@dataclasses.dataclass(frozen=True)
class UniGridOnline:
    """Streaming uniform grid (reference: InducingPoints.UniGrid used as an
    online algorithm with `updateZ`): the inducing set is a regular grid
    over the running bounding box of the stream; each batch can only expand
    the box, and the grid is regenerated over the new bounds.  All
    ``points_per_dim ** D`` slots are active from the first batch; the
    static capacity never changes, only positions move (the streaming
    correction projects the old posterior through kappa_a, so moving Z is
    handled exactly like the reference's updateZs!)."""

    points_per_dim: int

    def __call__(self, X, key=None):
        return UniGrid(self.points_per_dim)(X, key=key)


def unigrid_update(Z, mask, X_batch, points_per_dim: int):
    """On-device online UniGrid step: expand per-dim bounds to cover the
    batch, regenerate the regular grid.  Z: [M_cap, D]; the first
    points_per_dim**D slots hold the grid (all active)."""
    D = X_batch.shape[1]
    P = points_per_dim
    k0 = P**D
    big = jnp.asarray(jnp.inf, Z.dtype)
    lo_z = jnp.min(jnp.where(mask[:, None], Z, big), axis=0)
    hi_z = jnp.max(jnp.where(mask[:, None], Z, -big), axis=0)
    lo = jnp.minimum(lo_z, jnp.min(X_batch, axis=0))
    hi = jnp.maximum(hi_z, jnp.max(X_batch, axis=0))
    t = jnp.linspace(0.0, 1.0, P).astype(Z.dtype)  # [P]
    axes = lo[None, :] + t[:, None] * (hi - lo)[None, :]  # [P, D]
    mesh = jnp.meshgrid(*[axes[:, d] for d in range(D)], indexing="ij")
    grid = jnp.stack([m.ravel() for m in mesh], axis=1)  # [k0, D]
    Z = jax.lax.dynamic_update_slice(Z, grid, (0, 0))
    mask = mask.at[:k0].set(True)
    return Z, mask


@dataclasses.dataclass(frozen=True)
class Webscale:
    """Web-scale (minibatch) k-means (Sculley '10; reference:
    InducingPoints.Webscale): a fixed set of k centers, each moved toward
    the mean of the batch points assigned to it with a per-center learning
    rate 1/count.  The active set is k slots from the first batch onward;
    only positions move."""

    k: int

    def __call__(self, X, key=None):
        X = np.asarray(X)
        rng = np.random.RandomState(0 if key is None else int(np.asarray(key)[-1]))
        idx = rng.choice(X.shape[0], size=min(self.k, X.shape[0]), replace=False)
        return jnp.asarray(X[idx])


def webscale_update(Z, mask, counts, X_batch, k=None):
    """On-device minibatch k-means step over the active centers.  Matches
    Sculley's per-center 1/count rate with within-batch updates folded into
    one count-weighted mean (vectorized; order-free).  `k` caps the number
    of active centers (defaults to the buffer capacity)."""
    k = Z.shape[0] if k is None else k
    d2 = jnp.sum((X_batch[:, None, :] - Z[None, :, :]) ** 2, axis=-1)  # [B, Mc]
    d2 = jnp.where(mask[None, :], d2, jnp.inf)
    assign = jnp.argmin(d2, axis=1)  # [B]
    onehot = (assign[:, None] == jnp.arange(Z.shape[0])[None, :]).astype(Z.dtype)
    nb = jnp.sum(onehot, axis=0)  # [Mc]
    bsum = onehot.T @ X_batch  # [Mc, D]
    bmean = bsum / jnp.maximum(nb, 1.0)[:, None]
    new_counts = counts + nb
    eta = nb / jnp.maximum(new_counts, 1.0)
    move = (mask & (nb > 0))[:, None]
    Z = jnp.where(move, Z + eta[:, None] * (bmean - Z), Z)
    # Activate free slots from this batch (a first batch smaller than k
    # would otherwise cap the center count forever): fill inactive slots
    # farthest-first with batch points, k-means-seeding style.
    dmin = jnp.min(jnp.where(mask[None, :], d2, jnp.inf), axis=1)  # [B]
    dmin = jnp.where(jnp.isfinite(dmin), dmin, jnp.float32(1e30).astype(Z.dtype))
    order = jnp.argsort(-dmin)  # farthest batch points first
    inact_rank = jnp.cumsum(~mask) - 1  # slot's index among inactive slots
    free = k - jnp.sum(mask)  # activations still allowed under the k cap
    newly = (~mask) & (inact_rank < jnp.minimum(X_batch.shape[0], free))
    cand = X_batch[order[jnp.clip(inact_rank, 0, X_batch.shape[0] - 1)]]
    Z = jnp.where(newly[:, None], cand, Z)
    new_counts = jnp.where(newly, 1.0, new_counts)
    mask = mask | newly
    return Z, mask, new_counts


@dataclasses.dataclass(frozen=True)
class StreamKmeans:
    """Streaming k-means with a data-driven opening radius (reference:
    InducingPoints.StreamKmeans): a batch point opens a new center when its
    squared distance to the nearest active center exceeds ``radius2``
    (capacity permitting); otherwise the nearest center absorbs it with a
    running-mean step.  DP-means-style growth + online Lloyd refinement."""

    capacity: int = 128
    radius2: float = 1.0

    def __call__(self, X, key=None):
        X = np.asarray(X)
        Z = [X[0]]
        counts = [1]
        for x in X[1:]:
            d2 = ((np.stack(Z) - x) ** 2).sum(-1)
            j = int(d2.argmin())
            if d2[j] > self.radius2 and len(Z) < self.capacity:
                Z.append(x)
                counts.append(1)
            else:
                counts[j] += 1
                Z[j] = Z[j] + (x - Z[j]) / counts[j]
        return jnp.asarray(np.stack(Z))


def streamkmeans_update(Z, mask, counts, X_batch, radius2: float, cap=None):
    """On-device streaming k-means update (sequential accept rule preserved
    by a lax.scan over the batch, like `oips_update`).  `cap` bounds the
    number of active centers (defaults to the buffer capacity; the model
    passes the algorithm's own capacity when the buffer is larger)."""
    cap = Z.shape[0] if cap is None else cap

    def body(carry, x):
        Z, mask, counts = carry
        d2 = jnp.sum((Z - x[None, :]) ** 2, axis=-1)
        d2 = jnp.where(mask, d2, jnp.inf)
        j = jnp.argmin(d2)
        n_active = jnp.sum(mask)
        open_new = jnp.logical_and(d2[j] > radius2, n_active < cap)
        slot = jnp.argmin(mask)  # first inactive slot
        # open: write x into the free slot with count 1
        Z_open = jax.lax.dynamic_update_slice(Z, x[None, :], (slot, 0))
        # absorb: running mean on center j
        cj = counts[j] + 1.0
        Z_abs = Z.at[j].add((x - Z[j]) / cj)
        Z = jnp.where(open_new, Z_open, Z_abs)
        mask = jnp.where(open_new, mask.at[slot].set(True), mask)
        counts = jnp.where(
            open_new, counts.at[slot].set(1.0), counts.at[j].set(cj)
        )
        return (Z, mask, counts), open_new

    (Z, mask, counts), _ = jax.lax.scan(body, (Z, mask, counts), X_batch)
    return Z, mask, counts


@dataclasses.dataclass(frozen=True)
class GreedyVariance:
    """Greedy conditional-variance selection (Burt et al. '20): repeatedly
    add the point with the largest posterior conditional variance given the
    already-selected set.  Vectorized over candidates; O(k N) per step."""

    k: int

    def __call__(self, X, key=None, kernel=None):
        X = np.asarray(X)
        N = X.shape[0]
        if kernel is None:
            kfn = lambda A, B: np.exp(
                -0.5 * ((A[:, None] - B[None]) ** 2).sum(-1)
            )
            kdiag = np.ones(N)
        else:
            kfn = lambda A, B: np.asarray(kernel.gram(jnp.asarray(A), jnp.asarray(B)))
            kdiag = np.asarray(kernel.diag(jnp.asarray(X)))
        k = min(self.k, N)
        chosen = [int(np.argmax(kdiag))]
        # running Cholesky-style residual variance
        V = np.zeros((k, N))  # rows: (K_zx - partial) / sqrt(cond var)
        cond_var = kdiag.copy().astype(np.float64)
        for i in range(k - 1):
            z = chosen[-1]
            kzx = kfn(X[z : z + 1], X)[0]
            resid = kzx - V[:i].T @ V[:i, z]
            denom = np.sqrt(max(cond_var[z], 1e-12))
            V[i] = resid / denom
            cond_var = np.maximum(cond_var - V[i] ** 2, 0.0)
            cond_var[chosen] = -np.inf
            chosen.append(int(np.argmax(cond_var)))
        return jnp.asarray(X[chosen])
