"""Model base utilities.

The reference's models are mutable structs with trait-based dispatch
(IsFull/IsSparse/IsMultiOutput, /root/reference/src/models/AbstractGP.jl).
Design: each model is an immutable pytree dataclass; the traits
become plain class attributes (`is_sparse`, `is_multioutput`) read at trace
time, and the per-latent structure is an array axis, not a tuple of structs.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import kernels as K
from .. import means as Mn
from ..likelihoods.base import Likelihood


def check_implemented(likelihood: Likelihood, inference) -> None:
    """Compatibility gate (reference: `implemented(likelihood, inference)`
    default-false dispatch, likelihood/likelihood.jl:29)."""
    ok = inference.name in type(likelihood).implemented()
    if not ok:
        raise ValueError(
            f"{type(likelihood).__name__} is not implemented/compatible with "
            f"{inference.name}"
        )


def prepare_components(kernel, likelihood, mean, n_latent):
    """Replicate kernel/mean pytrees over the latent axis [L, ...]."""
    kernel = K.replicate(kernel, n_latent)
    mean = Mn.replicate(Mn.as_mean(mean), n_latent)
    return kernel, mean


def as_2d(X, obsdim: int = 1) -> jnp.ndarray:
    """Coerce inputs to [N, D].  obsdim=1: rows are observations (default);
    obsdim=2: columns are observations (the reference's KernelFunctions
    convention switch, e.g. models/SVGP.jl obsdim kwarg)."""
    X = jnp.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    elif obsdim == 2:
        X = X.T
    return X


def match_dtype(y, X) -> jnp.ndarray:
    """Cast float labels to the input dtype: treat_labels works host-side in
    float64; mixing it with f32 inputs would silently promote the whole
    training state under x64."""
    y = jnp.asarray(y)
    if jnp.issubdtype(y.dtype, jnp.floating) and y.dtype != X.dtype:
        y = y.astype(X.dtype)
    return y


def model_repr(model) -> str:
    """Compact summary (the reference's Base.show equivalents)."""
    name = type(model).__name__
    parts = []
    lik = getattr(model, "likelihood", None)
    if lik is not None:
        parts.append(f"likelihood={type(lik).__name__}")
    liks = getattr(model, "likelihoods", None)
    if liks is not None:
        parts.append(f"likelihoods=({', '.join(type(l).__name__ for l in liks)})")
    inf = getattr(model, "inference", None)
    if inf is not None:
        parts.append(f"inference={inf.name}")
    parts.append(f"n_latent={model.n_latent}")
    if getattr(model, "is_sparse", False):
        parts.append(f"n_inducing={model.n_inducing}")
    return f"{name}({', '.join(parts)})"
