"""VStP: Variational Student-t Process.

Prior is a Student-t process, augmented by an inverse-Gamma scale mixture:
f | s ~ N(mu0, s K), s ~ IG(nu/2, nu/2), giving closed-form per-iteration
prior-scale updates.  The CAVI-optimal q(s) is

  q(s) = IG(alpha, beta),  alpha = (nu + N)/2,
                           beta  = (nu + (mu-mu0)^T K^-1 (mu-mu0)
                                       + tr(K^-1 Sigma)) / 2
  chi  = E_q[1/s] = alpha / beta

(q(s) prop. IG(s; nu/2, nu/2) * s^{-N/2} exp(-(quad+tr)/(2s))).  We store
l2 = beta.

Parity note vs /root/reference/src/models/VStP.jl:91-108: the reference
computes l2 = (nu + N + quad + tr)/2 and chi = (nu+N)/(nu+l2) -- which is
NOT E[1/s] (it double-counts nu+N inside l2) -- and then never applies chi
in its Zygote-era CAVI path anyway (chi only survives in the legacy
ForwardDiff hyper-gradient, autotuning.jl:295), i.e. its VStP trains like
a VGP.  We use the correct IG posterior moments and apply the scale where
the derivation requires it: the effective prior precision is chi K^-1 in
the natural-gradient update and the Gaussian KL.  At the prior optimum
(mu = mu0, Sigma = K) this gives chi = 1 exactly (tested).
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax
from ..utils import struct

from ..inference.config import InferenceConfig
from ..likelihoods.base import Likelihood
from ..means import PriorMean, ZeroMean
from .base import as_2d, check_implemented, prepare_components


class VStP(struct.PyTreeNode):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    nu: jnp.ndarray
    train_x: Optional[jnp.ndarray]
    train_y: Optional[jnp.ndarray]
    inference: InferenceConfig = struct.field(pytree_node=False)
    n_latent: int = struct.field(pytree_node=False)
    atfrequency: int = struct.field(pytree_node=False, default=1)
    optimiser: Optional[Any] = struct.field(pytree_node=False, default=None)

    is_sparse = False
    is_multioutput = False
    is_online = False
    is_tprior = True

    @classmethod
    def create(
        cls,
        X,
        y,
        kernel,
        likelihood,
        inference,
        nu: float,
        mean=None,
        optimiser="default",
        atfrequency: int = 1,
    ):
        check_implemented(likelihood, inference)
        if nu <= 1:
            raise ValueError("nu should be bigger than 1")
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
            nu=jnp.asarray(float(nu)),
            train_x=X,
            train_y=y,
            inference=inference,
            n_latent=n_latent,
            atfrequency=atfrequency,
            optimiser=optimiser,
        )

    @property
    def Z(self):
        return jnp.broadcast_to(self.train_x, (self.n_latent,) + self.train_x.shape)

    @property
    def n_inducing(self):
        return self.train_x.shape[0]


def local_prior_updates(model: VStP, state, x):
    """Closed-form IG scale update per latent GP
    (reference: models/VStP.jl:91-108)."""
    from ..means import batch_call
    from ..ops import linalg

    N = x.shape[0]
    mu0 = batch_call(model.mean, x, model.n_latent)
    L_K = state.kmat["L_K"]
    K_inv = state.kmat["K_inv"]

    def one(mu_l, mu0_l, L_l, Kinv_l, Sigma_l):
        quad = linalg.invquad(L_l, mu_l - mu0_l)
        tr = jnp.sum(Kinv_l * Sigma_l)
        l2 = (model.nu + quad + tr) / 2.0  # IG scale beta
        chi = (model.nu + N) / (2.0 * l2)  # E[1/s] = alpha/beta
        return l2, chi

    l2, chi = jax.vmap(one)(state.mu, mu0, L_K, K_inv, state.Sigma)
    return state.replace(prior_state={"l2": l2, "chi": chi})


def _vstp_repr(self):
    from .base import model_repr

    return model_repr(self)


VStP.__repr__ = _vstp_repr
