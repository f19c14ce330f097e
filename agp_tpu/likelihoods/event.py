"""Event (count) likelihoods: Poisson and Negative Binomial.

Re-derivations of /root/reference/src/likelihood/poisson.jl and
negativebinomial.jl.

Parity notes (documented deviations):
* The reference stores theta = (y+gamma) tanh(c/2) / c for Poisson/NegBinomial
  (poisson.jl:74-76, negativebinomial.jl:77-79), which is 2 E[omega] for
  omega ~ PG(y+gamma, c) -- inconsistent with its own Logistic /
  Logistic-SoftMax convention (theta = E[omega]) and with the PG mean
  E[omega] = b tanh(c/2)/(2c).  We use the correct E[omega] so that the CAVI
  fixed point agrees with the exact Gibbs sampler.
* NegBinomial `expec_loglik` uses -theta mu^2/2 (the reference drops the
  square, negativebinomial.jl:155).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..ops.kl import poisson_kl, polya_gamma_kl
from ..ops.quadrature import expectation, mean_and_var
from ..ops.special import gammaln, safe_expcosh, sqrt_expec_square
from .base import SingleLatentLikelihood

LOG2 = 0.6931471805599453


class PoissonLikelihood(SingleLatentLikelihood):
    """p(y|f) = Poisson(y | lambda sigma(f)): scaled-logistic Poisson with
    double augmentation (latent Poisson count n, then omega ~ PG(y+n, f)),
    reference: likelihood/poisson.jl:16-26, 61-92.

    Local updates:
      c     = sqrt(E[f^2])
      gamma = E[n] = lambda exp(-mu/2) / (2 cosh(c/2))
      theta = E[omega] = (y + gamma) tanh(c/2) / (2c)
      lambda <- sum(y) / sum(E[sigma(f)])   (closed-form rate update)
    """

    lam: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(1.0, jnp.result_type(float))
    )

    @classmethod
    def create(cls, lam: float = 1.0):
        # strong-typed: lam has a closed-form MLE update every local step
        return cls(lam=jnp.asarray(float(lam), jnp.result_type(float)))

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "GibbsSampling", "HMCSampling"})

    def treat_labels(self, y):
        import numpy as np

        y = np.asarray(y)
        if np.any(y < 0) or np.any(y != np.round(y)):
            raise ValueError("Poisson labels must be non-negative integers")
        return jnp.asarray(y, dtype=jnp.result_type(float)), self

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        return {
            "c": jnp.ones((batchsize,), dtype=dtype),
            "theta": jnp.zeros((batchsize,), dtype=dtype),
            "gamma": jnp.ones((batchsize,), dtype=dtype),
        }

    _weighted_params = True  # the rate MLE sums over the batch

    def _local_updates(self, y, mu, var, local, w=None):
        c = sqrt_expec_square(mu, var)
        gamma = self.lam * safe_expcosh(-mu / 2.0, c / 2.0) / 2.0
        theta = (y + gamma) * jnp.tanh(c / 2.0) / (2.0 * c)
        es = expectation(jax.nn.sigmoid, mu, var)
        if w is None:
            new_lam = jnp.sum(y) / jnp.sum(es)
        else:  # exclude padded rows (see Likelihood.local_updates)
            new_lam = jnp.sum(w * y) / jnp.sum(w * es)
        lik = self.replace(lam=new_lam)
        return lik, {**local, "c": c, "gamma": gamma, "theta": theta}

    def _grad_e_mu(self, y, local):
        return (y - local["gamma"]) / 2.0

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        theta, gamma = local["theta"], local["gamma"]
        tot = 0.5 * (
            jnp.sum(mu * (y - gamma)) - jnp.sum(theta * mu**2) - jnp.sum(theta * var)
        )
        tot += jax.lax.stop_gradient(
            jnp.sum(y) * jnp.log(self.lam)
            - jnp.sum(gammaln(y + 1.0))
            - LOG2 * jnp.sum(y + gamma)
        )
        return tot

    def aug_kl(self, local, y):
        return poisson_kl(local["gamma"], self.lam) + polya_gamma_kl(
            y + local["gamma"], local["c"], local["theta"]
        )

    def _sample_local(self, key, y, f, local):
        from ..distributions.polyagamma import sample_pg

        k1, k2 = jax.random.split(key)
        rate = self.lam * jax.nn.sigmoid(f)
        gamma = jax.random.poisson(k1, rate).astype(f.dtype)
        omega = sample_pg(k2, y + gamma, jnp.abs(f))
        return {**local, "gamma": gamma, "theta": omega}

    def compute_proba(self, mu, var):
        link = lambda f: self.lam * jax.nn.sigmoid(f)
        return mean_and_var(link, mu, var)

    def predict_y(self, mu):
        return self.lam * jax.nn.sigmoid(mu)

    def log_prob(self, y, f):
        rate = self.lam * jax.nn.sigmoid(f)
        return y * jnp.log(rate) - rate - gammaln(y + 1.0)


class NegBinomialLikelihood(SingleLatentLikelihood):
    """Negative binomial with logistic link and fixed failure count r:
    p(y|f) = C(y+r-1, y) sigma(f)^y (1-sigma(f))^r, augmented by
    omega ~ PG(y + r, f) (reference: likelihood/negativebinomial.jl).

    Local updates: c = sqrt(E[f^2]); theta = E[omega] = (r+y) tanh(c/2)/(2c).
    """

    r: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(10.0))

    @classmethod
    def create(cls, r: float):
        return cls(r=jnp.asarray(float(r)))

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "GibbsSampling", "HMCSampling"})

    def treat_labels(self, y):
        import numpy as np

        y = np.asarray(y)
        if np.any(y < 0) or np.any(y != np.round(y)):
            raise ValueError("NegBinomial labels must be non-negative integers")
        return jnp.asarray(y, dtype=jnp.result_type(float)), self

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        return {
            "c": jnp.ones((batchsize,), dtype=dtype),
            "theta": jnp.zeros((batchsize,), dtype=dtype),
        }

    def _local_updates(self, y, mu, var, local):
        c = sqrt_expec_square(mu, var)
        theta = (self.r + y) * jnp.tanh(c / 2.0) / (2.0 * c)
        return self, {**local, "c": c, "theta": theta}

    def _grad_e_mu(self, y, local):
        return (y - self.r) / 2.0

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        theta = local["theta"]
        logconst = gammaln(y + self.r) - gammaln(y + 1.0) - gammaln(self.r)
        tot = jax.lax.stop_gradient(jnp.sum(logconst)) - LOG2 * jnp.sum(y + self.r)
        tot += 0.5 * (
            jnp.sum(mu * (y - self.r)) - jnp.sum(theta * mu**2) - jnp.sum(theta * var)
        )
        return tot

    def aug_kl(self, local, y):
        return polya_gamma_kl(y + self.r, local["c"], local["theta"])

    def _sample_local(self, key, y, f, local):
        from ..distributions.polyagamma import sample_pg

        omega = sample_pg(key, y + self.r, jnp.abs(f))
        return {**local, "theta": omega}

    def compute_proba(self, mu, var):
        # E[y|f] = r p/(1-p) with p = sigma(f) => r e^f
        link = lambda f: self.r * jnp.exp(f)
        return mean_and_var(link, mu, var)

    def predict_y(self, mu):
        return self.r * jnp.exp(mu)

    def log_prob(self, y, f):
        logconst = gammaln(y + self.r) - gammaln(y + 1.0) - gammaln(self.r)
        return logconst + y * jax.nn.log_sigmoid(f) + self.r * jax.nn.log_sigmoid(-f)
