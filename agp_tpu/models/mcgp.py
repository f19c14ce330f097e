"""MCGP: Monte-Carlo GP -- posterior represented by samples.

Equivalent of /root/reference/src/models/MCGP.jl + training/sampling.jl.
`sample()` runs the whole chain (burn-in + thinning) as one jitted
`lax.scan`; chains can be vmapped and sharded across devices.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from ..config import jitter
from ..inference.config import GibbsSampling, InferenceConfig
from ..kernels import batch_gram
from ..likelihoods.base import Likelihood
from ..means import PriorMean, ZeroMean
from ..ops import linalg
from .base import as_2d, check_implemented, prepare_components


class MCGP(struct.PyTreeNode):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    train_x: jnp.ndarray
    train_y: jnp.ndarray
    inference: InferenceConfig = struct.field(pytree_node=False)
    n_latent: int = struct.field(pytree_node=False, default=1)

    is_sparse = False
    is_multioutput = False
    is_online = False

    @classmethod
    def create(cls, X, y, kernel, likelihood, inference=None, mean=None):
        inference = GibbsSampling() if inference is None else inference
        check_implemented(likelihood, inference)
        X = as_2d(X)
        y, likelihood = likelihood.treat_labels(y)
        from .base import match_dtype

        y = match_dtype(y, X)
        n_latent = likelihood.n_latent
        mean = ZeroMean() if mean is None else mean
        kernel, mean = prepare_components(kernel, likelihood, mean, n_latent)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            train_x=X,
            train_y=y,
            inference=inference,
            n_latent=n_latent,
        )

    @property
    def Z(self):
        return jnp.broadcast_to(self.train_x, (self.n_latent,) + self.train_x.shape)


def sample(model: MCGP, n_samples: int, key=None, n_chains: int = 1):
    """Draw posterior samples of f via blocked Gibbs
    (reference: training/sampling.jl:11-29).

    Returns samples [n_chains, n_samples, L, N] (chain axis squeezed away
    when n_chains == 1).  Chains are vmapped -- on a mesh they shard across
    devices for free.
    """
    key = jax.random.PRNGKey(0) if key is None else key
    inf = model.inference
    if inf.name == "HMCSampling":
        if getattr(inf, "algorithm", "nuts") == "nuts":
            from ..inference.hmc import sample_nuts

            return sample_nuts(
                model,
                n_samples,
                key=key,
                n_chains=n_chains,
                max_depth=getattr(inf, "max_depth", 8),
            )
        from ..inference.hmc import sample_hmc

        return sample_hmc(model, n_samples, key=key, n_chains=n_chains)
    keys = jax.random.split(key, n_chains)
    kept = _gibbs_chains(model, keys, n_samples, inf.n_burnin, inf.thinning)
    return kept[0] if n_chains == 1 else kept


@partial(jax.jit, static_argnames=("n_samples", "n_burnin", "thinning"))
def _gibbs_chains(model, keys, n_samples, n_burnin, thinning):
    """All Gibbs chains as one cached jitted program (module-level so repeat
    `sample()` calls with the same shapes don't re-trace)."""
    from ..inference.gibbs import run_chain

    K = batch_gram(model.kernel, model.train_x)
    jitt = jitter(K.dtype)
    L_K = jax.vmap(lambda k: linalg.safe_cholesky(k, jitt))(K)
    K_inv = jax.vmap(linalg.chol_inv)(L_K)
    kmat = {"L_K": L_K, "K_inv": K_inv}
    N = model.train_x.shape[0]
    local0 = model.likelihood.init_local_vars(N, model.train_x.dtype)

    def chain(k):
        kept, _, _ = run_chain(
            model, kmat, k, n_samples, n_burnin, thinning, local0
        )
        return kept

    return jax.vmap(chain)(keys)


@jax.jit
def predict_f_samples(model: MCGP, samples, X_test):
    """Push posterior samples through the predictive mean map
    k* K^-1 f (reference: predictions.jl:120-130).

    samples: [S, L, N] -> returns [S, L, n*]."""
    K = batch_gram(model.kernel, model.train_x)
    jitt = jitter(K.dtype)
    L_K = jax.vmap(lambda k: linalg.safe_cholesky(k, jitt))(K)
    k_star = batch_gram(model.kernel, as_2d(X_test), model.train_x)  # [L, n, N]
    proj = jax.vmap(lambda Lk, ks: linalg.chol_solve(Lk, ks.T).T)(L_K, k_star)
    return jnp.einsum("lnm,slm->sln", proj, samples)


@jax.jit
def proba_y_mc(model: MCGP, samples, X_test):
    """Monte-Carlo predictive: mean/var of the link pushed through the
    posterior samples themselves -- deterministic given `samples`
    (reference: predictions.jl proba_y for MCGP)."""
    f_pred = predict_f_samples(model, samples, X_test)  # [S, L, n]
    lik = model.likelihood
    from ..likelihoods.multiclass import MultiClassLikelihood

    if isinstance(lik, MultiClassLikelihood):
        probs = jax.vmap(lambda f: lik.link(f))(f_pred)  # [S, K, n]
        return jnp.mean(probs, axis=0).T
    if lik.n_latent == 1:
        from ..ops.quadrature import expectation

        vals = jax.vmap(lambda f: lik.compute_proba(f[0], jnp.zeros_like(f[0])))(f_pred)
        if isinstance(vals, tuple):
            return jnp.mean(vals[0], axis=0), jnp.mean(vals[1], axis=0)
        return jnp.mean(vals, axis=0)
    raise NotImplementedError


def _mcgp_repr(self):
    from .base import model_repr

    return model_repr(self)


MCGP.__repr__ = _mcgp_repr
