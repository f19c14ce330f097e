"""Heteroscedastic Gaussian likelihood driven by a second latent GP.

p(y | f, g) = N(y | f, (lambda sigma(g))^-1): the noise precision is a
scaled-logistic transform of a second GP g, augmented by a latent Poisson
count n and omega ~ PG(n + 1/2, g)
(reference: /root/reference/src/likelihood/heteroscedastic.jl).

This is the first multi-latent likelihood: mu/var arrive stacked [2, B]
(index 0 = f, index 1 = g) and the gradient expectations return [2, B].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..ops.kl import poisson_kl_expected, polya_gamma_kl
from ..ops.special import safe_expcosh, sqrt_expec_square
from .base import Likelihood

LOG2PI = 1.8378770664093453


class HeteroscedasticLikelihood(Likelihood):
    """lambda = maximum precision; updated in closed form every local step
    (heteroscedastic.jl:50-96)."""

    lam: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(1.0, jnp.result_type(float))
    )

    @classmethod
    def create(cls, lam: float = 1.0):
        # strong-typed: lam updates every local step (see likelihood docstring
        # in regression.py::GaussianLikelihood.create for why)
        return cls(lam=jnp.asarray(float(lam), jnp.result_type(float)))

    @property
    def n_latent(self):
        return 2

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        ones = jnp.ones((batchsize,), dtype=dtype)
        return {"c": ones, "phi": ones, "gamma": ones, "theta": ones, "sigg": ones}

    def local_updates(self, y, mu, var, local, w=None):
        mu_f, mu_g = mu[0], mu[1]
        var_f, var_g = var[0], var[1]
        phi = ((mu_f - y) ** 2 + var_f) / 2.0  # E[(f - y)^2] / 2
        c = sqrt_expec_square(mu_g, var_g)  # sqrt(E[g^2])
        sigg = safe_expcosh(-mu_g / 2.0, c / 2.0) / 2.0  # ~ E[sigma(-g)]
        gamma = self.lam * phi * sigg  # E[n]
        theta = (0.5 + gamma) * jnp.tanh(c / 2.0) / (2.0 * c)  # E[omega]
        if w is None:
            n = y.shape[0]
            s = jnp.sum(phi * (1.0 - sigg))
        else:  # exclude padded rows (see Likelihood.local_updates)
            n = jnp.sum(w)
            s = jnp.sum(w * phi * (1.0 - sigg))
        new_lam = jnp.maximum(n / (2.0 * s), self.lam)
        lik = self.replace(lam=new_lam)
        return lik, {"c": c, "phi": phi, "gamma": gamma, "theta": theta, "sigg": sigg}

    def grad_e_mu(self, y, local):
        g_f = y * self.lam * local["sigg"] / 2.0
        g_g = (0.5 - local["gamma"]) / 2.0
        return jnp.stack([g_f, g_g])

    def grad_e_sigma(self, y, local):
        s_f = self.lam * local["sigg"] / 2.0
        s_g = local["theta"] / 2.0
        return jnp.stack([s_f, s_g])

    def expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        mu_f, mu_g = mu[0], mu[1]
        var_f, var_g = var[0], var[1]
        gamma, theta = local["gamma"], local["theta"]
        # constant: n (log(lambda)/2 - log(2 sqrt(2 pi)))
        tot = n * (jnp.log(self.lam) / 2.0) - n * (jnp.log(2.0) + LOG2PI / 2.0)
        tot += 0.5 * (
            jnp.sum(mu_g * (0.5 - gamma))
            - jnp.sum(theta * mu_g**2)
            - jnp.sum(theta * var_g)
        )
        # Poisson KL folded into the expected log-likelihood
        # (heteroscedastic.jl:143-151)
        rate0 = self.lam * ((y - mu_f) ** 2 + var_f) / 2.0
        tot -= poisson_kl_expected(gamma, rate0, jnp.log(rate0))
        return tot

    def aug_kl(self, local, y):
        return polya_gamma_kl(0.5 + local["gamma"], local["c"], local["theta"])

    def sample_local(self, key, y, f, local):
        from ..distributions.polyagamma import sample_pg

        ff, gg = f[0], f[1]
        k1, k2 = jax.random.split(key)
        rate = self.lam * jax.nn.sigmoid(gg) * (ff - y) ** 2 / 2.0
        gamma = jax.random.poisson(k1, rate).astype(ff.dtype)
        omega = sample_pg(k2, gamma + 0.5, jnp.abs(gg))
        return {**local, "gamma": gamma, "theta": omega}

    def compute_proba(self, mu, var):
        # predictive mean = mu_f, variance = var_f + E[noise]
        noise = 1.0 / (self.lam * jax.nn.sigmoid(mu[1]))
        return mu[0], var[0] + noise

    def predict_y(self, mu):
        return mu[0]

    def log_prob(self, y, f):
        # f: [2, ...]
        prec = self.lam * jax.nn.sigmoid(f[1])
        return 0.5 * (jnp.log(prec) - LOG2PI - prec * (y - f[0]) ** 2)
