"""Likelihood protocol.

The reference defines a per-likelihood method contract -- `local_updates!`,
`sample_local!`, gradient expectations, `expec_loglikelihood`, `AugmentedKL`,
`compute_proba`, `predict_y`, `treat_labels!`, `implemented`
(/root/reference/src/likelihood/likelihood.jl, e.g. logistic.jl:39-100).

Design: a likelihood is an immutable pytree dataclass whose
float leaves are its parameters.  All methods are pure: `local_updates`
returns a *new* (likelihood, local_vars) pair instead of mutating, so the
whole CAVI step jits as one functional program.  Latent values arrive as
stacked arrays mu/var of shape [L, B] (L = number of latent GPs); local
variables are a dict of [B]- or [L, B]-shaped arrays, which makes every
local update embarrassingly parallel along the (shardable) data axis.

Numerical-VI fallbacks (`grad_log_prob` / `hess_log_prob`) use `jax.grad`
elementwise, replacing the reference's ForwardDiff fallback
(likelihood/likelihood.jl:13-27).
"""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from ..utils import struct

Array = jnp.ndarray
LocalVars = Dict[str, Array]


class Likelihood(struct.PyTreeNode):
    # ------------------------------------------------------------------ meta
    @property
    def n_latent(self) -> int:
        return 1

    @classmethod
    def implemented(cls) -> frozenset:
        """Names of compatible inference engines
        (reference: `implemented(likelihood, inference)` gates)."""
        return frozenset()

    # ---------------------------------------------------------------- labels
    def treat_labels(self, y) -> Tuple[Array, "Likelihood"]:
        """Validate/transform raw labels (host-side, before jit)."""
        return jnp.asarray(y), self

    # ------------------------------------------------------- CAVI (Analytic)
    def init_local_vars(self, batchsize: int, dtype=jnp.float32) -> LocalVars:
        raise NotImplementedError

    def local_updates(
        self, y: Array, mu: Array, var: Array, local: LocalVars, w: Array | None = None
    ) -> Tuple["Likelihood", LocalVars]:
        """Closed-form E-step q(omega) update. mu/var: [L, B].

        `w` (optional, [B] of 0/1) marks padded rows in sharded full-batch
        training (parallel/mesh.py::shard_batch): likelihoods whose E-step
        updates a likelihood parameter from cross-batch sums (Gaussian
        noise, Poisson/heteroscedastic rates) must exclude w==0 rows from
        those sums; per-row local variables need no masking (the inference
        engine zero-weights their gmu/gs contributions downstream)."""
        raise NotImplementedError

    def grad_e_mu(self, y: Array, local: LocalVars) -> Array:
        """[L, B] coefficient of mu in dE[log p]/dmu (natural-gradient input)."""
        raise NotImplementedError

    def grad_e_sigma(self, y: Array, local: LocalVars) -> Array:
        """[L, B] theta/2-style coefficient (natural-gradient input)."""
        raise NotImplementedError

    def expec_loglik(self, y: Array, mu: Array, var: Array, local: LocalVars) -> Array:
        """E_q [log p(y | f, omega)] summed over the batch."""
        raise NotImplementedError

    def aug_kl(self, local: LocalVars, y: Array) -> Array:
        """KL(q(omega) || p(omega)) summed over the batch."""
        raise NotImplementedError

    # ------------------------------------------------------------- sampling
    def sample_local(self, key, y: Array, f: Array, local: LocalVars) -> LocalVars:
        """Gibbs draw of omega | f. f: [L, B]."""
        raise NotImplementedError

    # ----------------------------------------------------------- prediction
    def compute_proba(self, mu: Array, var: Array):
        """Push the latent predictive N(mu, var) through the likelihood."""
        raise NotImplementedError

    def predict_y(self, mu: Array):
        raise NotImplementedError

    # ------------------------------------------- pointwise density (f: [L])
    def log_prob(self, y, f):
        """log p(y | f) elementwise; f has shape [...] for single-latent
        likelihoods, [L, ...] for multi-latent ones."""
        raise NotImplementedError

    def grad_log_prob(self, y, f):
        """d log p / d f, elementwise (AD fallback)."""
        g = jax.grad(lambda ff: jnp.sum(self.log_prob(y, ff)))
        return g(f)

    def hess_log_prob(self, y, f):
        """d^2 log p / d f^2 elementwise (diagonal; AD fallback)."""

        def point(yy, ff):
            return jax.grad(jax.grad(lambda t: self.log_prob(yy, t)))(ff)

        yb = jnp.broadcast_to(y, jnp.shape(f))
        return jax.vmap(point)(yb.ravel(), f.ravel()).reshape(jnp.shape(f))


class SingleLatentLikelihood(Likelihood):
    """Adapter: subclasses implement the single-latent contract on [B]
    vectors (methods prefixed with ``_``); this class lifts them to the
    stacked [1, B] layout the inference engines use."""

    # Subclasses whose _local_updates computes cross-batch sums that update
    # likelihood parameters set this True and accept a `w` keyword; for all
    # others the row mask is irrelevant inside the E-step (per-row ops).
    _weighted_params = False

    # subclass hooks ------------------------------------------------------
    def _local_updates(self, y, mu, var, local):
        raise NotImplementedError

    def _grad_e_mu(self, y, local):
        raise NotImplementedError

    def _grad_e_sigma(self, y, local):
        raise NotImplementedError

    def _expec_loglik(self, y, mu, var, local):
        raise NotImplementedError

    def _sample_local(self, key, y, f, local):
        raise NotImplementedError

    # lifted interface ----------------------------------------------------
    def local_updates(self, y, mu, var, local, w=None):
        if w is not None and self._weighted_params:
            return self._local_updates(y, mu[0], var[0], local, w=w)
        return self._local_updates(y, mu[0], var[0], local)

    def grad_e_mu(self, y, local):
        return self._grad_e_mu(y, local)[None, :]

    def grad_e_sigma(self, y, local):
        return self._grad_e_sigma(y, local)[None, :]

    def expec_loglik(self, y, mu, var, local):
        return self._expec_loglik(y, mu[0], var[0], local)

    def sample_local(self, key, y, f, local):
        return self._sample_local(key, y, f[0], local)
