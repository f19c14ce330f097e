"""SVGP: sparse variational Gaussian process over an inducing set Z.

JAX equivalent of the reference's src/models/SVGP.jl: the N latent
GPs of the likelihood live on a stacked axis ([L, M, D] inducing points,
[L, M] / [L, M, M] natural parameters) instead of an NTuple of structs, so
every per-latent op is a batched matmul under vmap.
"""
from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp
import optax
from ..utils import struct

from ..inference.config import AnalyticVI, InferenceConfig
from ..likelihoods.base import Likelihood
from ..means import PriorMean, ZeroMean
from .base import as_2d, check_implemented, prepare_components


class SVGP(struct.PyTreeNode):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    Z: jnp.ndarray  # [L, M, D]
    inference: InferenceConfig = struct.field(pytree_node=False)
    n_latent: int = struct.field(pytree_node=False)
    atfrequency: int = struct.field(pytree_node=False, default=1)
    optimiser: Optional[Any] = struct.field(pytree_node=False, default=None)
    Zoptimiser: Optional[Any] = struct.field(pytree_node=False, default=None)

    is_sparse = True
    is_multioutput = False
    is_online = False

    @classmethod
    def create(
        cls,
        kernel,
        likelihood,
        inference,
        Z,
        mean=None,
        optimiser="default",
        Zoptimiser=None,
        atfrequency: int = 1,
    ):
        """Mirror of the reference constructor (models/SVGP.jl:33-80):
        data-free; data is supplied to `train`."""
        check_implemented(likelihood, inference)
        n_latent = likelihood.n_latent
        mean = ZeroMean() if mean is None else mean
        kernel, mean = prepare_components(kernel, likelihood, mean, n_latent)
        Z = as_2d(Z)
        if Z.ndim == 2:
            Z = jnp.broadcast_to(Z, (n_latent,) + Z.shape)
        if optimiser == "default":
            optimiser = optax.adam(0.01)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            Z=Z,
            inference=inference,
            n_latent=n_latent,
            atfrequency=atfrequency,
            optimiser=optimiser,
            Zoptimiser=Zoptimiser,
        )

    @property
    def n_inducing(self):
        return self.Z.shape[1]


class VGP(struct.PyTreeNode):
    """Full variational GP: same math with Z = X (the dense natural-gradient
    branch, reference models/VGP.jl + analyticVI.jl:126-140)."""

    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    train_x: Optional[jnp.ndarray]
    train_y: Optional[jnp.ndarray]
    inference: InferenceConfig = struct.field(pytree_node=False)
    n_latent: int = struct.field(pytree_node=False)
    atfrequency: int = struct.field(pytree_node=False, default=1)
    optimiser: Optional[Any] = struct.field(pytree_node=False, default=None)

    is_sparse = False
    is_multioutput = False
    is_online = False

    @classmethod
    def create(
        cls,
        X,
        y,
        kernel,
        likelihood,
        inference,
        mean=None,
        optimiser="default",
        atfrequency: int = 1,
    ):
        check_implemented(likelihood, inference)
        if inference.stochastic:
            raise ValueError("VGP does not support stochastic inference; use SVGP")
        X = as_2d(X)
        y, likelihood = likelihood.treat_labels(y)
        from .base import match_dtype

        y = match_dtype(y, X)
        n_latent = likelihood.n_latent
        mean = ZeroMean() if mean is None else mean
        kernel, mean = prepare_components(kernel, likelihood, mean, n_latent)
        if optimiser == "default":
            optimiser = optax.adam(0.01)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            train_x=X,
            train_y=y,
            inference=inference,
            n_latent=n_latent,
            atfrequency=atfrequency,
            optimiser=optimiser,
        )

    @property
    def Z(self):
        # for the shared prediction path: the "inducing set" of a full model
        # is its training inputs
        return jnp.broadcast_to(
            self.train_x, (self.n_latent,) + self.train_x.shape
        )

    @property
    def n_inducing(self):
        return self.train_x.shape[0]


def _svgp_repr(self):
    from .base import model_repr

    return model_repr(self)


SVGP.__repr__ = _svgp_repr
def _vgp_repr(self):
    from .base import model_repr

    return model_repr(self)


VGP.__repr__ = _vgp_repr
