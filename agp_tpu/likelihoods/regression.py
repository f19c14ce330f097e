"""Regression likelihoods: Gaussian, Student-t, Laplace.

Re-derivations of the reference's augmented regression likelihoods
(/root/reference/src/likelihood/gaussian.jl, studentt.jl, laplace.jl) as
pure-functional JAX, vectorized over the data axis.

Parity notes (documented deviations from the reference):
* Student-t `log_prob` mirrors the reference's (nonstandard) density
  `Gamma(a)/(sqrt(nu pi) Gamma(nu/2)) (1 + ((y-f)/sigma)^2)^-a`
  (studentt.jl:103-106) so QuadratureVI paths match.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax
from ..utils import struct

from ..ops.kl import gig_entropy, inverse_gamma_kl
from ..ops.special import digamma, gammaln
from ..utils.opt import ascent_update
from .base import SingleLatentLikelihood

LOG2PI = 1.8378770664093453
LOG2 = 0.6931471805599453


class GaussianLikelihood(SingleLatentLikelihood):
    """Conjugate Gaussian noise likelihood
    (reference: likelihood/gaussian.jl:10-23).  theta = 1/sigma^2; optional
    closed-form-gradient noise learning in log space (gaussian.jl:56-72)."""

    sigma2: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray(1e-3, jnp.result_type(float))
    )
    opt_noise: Optional[Any] = struct.field(pytree_node=False, default=None)

    @classmethod
    def create(cls, sigma2: float = 1e-3, opt_noise=False):
        if isinstance(opt_noise, bool):
            opt_noise = optax.adam(0.05) if opt_noise else None
        # strong-typed: sigma2 updates during training (noise learning); a
        # weak-typed leaf would flip weak->strong on the first update and
        # force a jit recompile mid-training
        return cls(sigma2=jnp.asarray(sigma2, jnp.result_type(float)), opt_noise=opt_noise)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "Analytic", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        local = {"theta": jnp.full((batchsize,), 1.0 / self.sigma2, dtype=dtype)}
        if self.opt_noise is not None:
            local["state_sigma2"] = self.opt_noise.init(jnp.zeros_like(self.sigma2))
        return local

    _weighted_params = True  # noise learning sums over the batch

    def _local_updates(self, y, mu, var, local, w=None):
        lik = self
        if self.opt_noise is not None:
            if w is None:
                n = y.shape[0]
                ssq, svar = jnp.sum((y - mu) ** 2), jnp.sum(var)
            else:  # exclude padded rows (see Likelihood.local_updates)
                n = jnp.sum(w)
                ssq, svar = jnp.sum(w * (y - mu) ** 2), jnp.sum(w * var)
            grad = ((ssq + svar) / self.sigma2 - n) / 2.0
            # The reference applies this gradient directly in log space
            # (gaussian.jl:62-68): sigma2 <- exp(log sigma2 + opt(grad)).
            new_opt_state, delta = ascent_update(
                self.opt_noise, local["state_sigma2"], jnp.log(self.sigma2), grad
            )
            new_sigma2 = jnp.exp(jnp.log(self.sigma2) + delta)
            lik = self.replace(sigma2=new_sigma2)
            local = {**local, "state_sigma2": new_opt_state}
        local = {**local, "theta": jnp.full_like(local["theta"], 1.0 / lik.sigma2)}
        return lik, local

    def _grad_e_mu(self, y, local):
        return y / self.sigma2

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        return -0.5 * (
            n * (LOG2PI + jnp.log(self.sigma2))
            + (jnp.sum((y - mu) ** 2) + jnp.sum(var)) / self.sigma2
        )

    def aug_kl(self, local, y):
        return jnp.asarray(0.0, dtype=self.sigma2.dtype)

    def _sample_local(self, key, y, f, local):
        return local  # no auxiliary variable

    def compute_proba(self, mu, var):
        return mu, var + self.sigma2

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        return -0.5 * (LOG2PI + jnp.log(self.sigma2) + (y - f) ** 2 / self.sigma2)


class StudentTLikelihood(SingleLatentLikelihood):
    """Student-t likelihood, augmented by omega ~ InverseGamma(nu/2, nu/2)
    so p(y|f, omega) = N(y | f, sigma^2 omega)
    (reference: likelihood/studentt.jl:23-35).

    Local updates (studentt.jl:64-92):
      c     = (E[(y - f)^2] + sigma^2 nu) / 2      (IG posterior rate)
      theta = alpha / c,  alpha = (nu + 1)/2       (E[1/omega] / sigma^2-ish)
    """

    nu: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(3.0))
    sigma: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    @classmethod
    def create(cls, nu: float, sigma: float = 1.0):
        if nu <= 0.5:
            raise ValueError("nu should be greater than 0.5")
        return cls(nu=jnp.asarray(float(nu)), sigma=jnp.asarray(float(sigma)))

    @property
    def alpha(self):
        return (self.nu + 1.0) / 2.0

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        return {
            "c": jnp.ones((batchsize,), dtype=dtype),
            "theta": jnp.zeros((batchsize,), dtype=dtype),
        }

    def _local_updates(self, y, mu, var, local):
        c = ((mu - y) ** 2 + var + self.sigma**2 * self.nu) / 2.0
        theta = self.alpha / c
        return self, {**local, "c": c, "theta": theta}

    def _grad_e_mu(self, y, local):
        return local["theta"] * y

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        theta, c = local["theta"], local["c"]
        tot = -n * jnp.log(2.0 * jnp.pi * self.sigma**2) / 2.0
        tot -= jnp.sum(jnp.log(c) - digamma(self.alpha))
        tot -= 0.5 * jnp.sum(theta * ((mu - y) ** 2 + var))
        return tot

    def aug_kl(self, local, y):
        alpha_p = self.nu / 2.0
        beta_p = alpha_p * self.sigma**2
        return inverse_gamma_kl(self.alpha, local["c"], alpha_p, beta_p)

    def _sample_local(self, key, y, f, local):
        # omega ~ InverseGamma(alpha, ((f-y)^2 + sigma^2 nu)/2); theta = 1/omega
        b = ((f - y) ** 2 + self.sigma**2 * self.nu) / 2.0
        g = jax.random.gamma(key, self.alpha, shape=f.shape, dtype=f.dtype)
        omega = b / g
        return {**local, "c": omega, "theta": 1.0 / omega}

    def compute_proba(self, mu, var):
        return mu, jnp.maximum(var, 0.0) + self.nu * self.sigma**2 / (self.nu - 2.0)

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        # Mirrors the reference's density (studentt.jl:103-106).
        return (
            gammaln(self.alpha)
            - 0.5 * jnp.log(self.nu * jnp.pi)
            - gammaln(self.nu / 2.0)
            - self.alpha * jnp.log1p(((y - f) / self.sigma) ** 2)
        )


class LaplaceLikelihood(SingleLatentLikelihood):
    """Laplace likelihood, augmented by omega ~ Exp(1/(2 beta^2)) so
    p(y|f, omega) = N(y | f, omega^{-1})... with variational q(omega) =
    GIG(a, b^2, 1/2) (reference: likelihood/laplace.jl:17-28, 57-92)."""

    beta: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    @classmethod
    def create(cls, beta: float = 1.0):
        return cls(beta=jnp.asarray(float(beta)))

    @property
    def a(self):
        return self.beta ** (-2.0)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        return {
            "b": jnp.ones((batchsize,), dtype=dtype),
            "theta": jnp.zeros((batchsize,), dtype=dtype),
        }

    def _local_updates(self, y, mu, var, local):
        b = jnp.sqrt((mu - y) ** 2 + var)
        theta = jnp.sqrt(self.a) / b
        return self, {**local, "b": b, "theta": theta}

    def _grad_e_mu(self, y, local):
        return local["theta"] * y

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        theta = local["theta"]
        tot = -n * LOG2PI / 2.0
        tot += jax.lax.stop_gradient(jnp.sum(jnp.log(theta))) / 2.0
        tot -= 0.5 * jnp.sum(theta * ((mu - y) ** 2 + var))
        return tot

    def aug_kl(self, local, y):
        b2 = local["b"] ** 2
        ent = gig_entropy(self.a, b2, 0.5)
        # E_q[log p(omega)] for p = Exp(1/(2 beta^2))
        # (reference: laplace.jl:115-119)
        b = local["b"]
        expec_exp = jnp.sum(
            -jnp.log(2.0 * self.beta**2)
            - (self.a * b + b2 * jnp.sqrt(self.a)) / (self.a * b2 * self.beta**2) / 2.0
        )
        return ent - expec_exp

    def _sample_local(self, key, y, f, local):
        # omega ~ GIG(1/beta^2, (f-y)^2, 1/2); store omega in b, theta = 1/omega
        from ..distributions.gig import sample_gig

        omega = sample_gig(key, self.a, (f - y) ** 2, 0.5)
        return {**local, "b": omega, "theta": 1.0 / omega}

    def compute_proba(self, mu, var):
        return mu, jnp.maximum(var, 0.0) + 2.0 * self.beta**2

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        return -jnp.abs(y - f) / self.beta - jnp.log(2.0 * self.beta)

    def grad_log_prob(self, y, f):
        return jnp.sign(y - f) / self.beta

    def hess_log_prob(self, y, f):
        return jnp.zeros_like(f)


class Matern32Likelihood(SingleLatentLikelihood):
    """Matern-3/2 noise likelihood p(y|f) = sqrt(3)/(4 rho) (1 + u) e^-u,
    u = sqrt(3)|y-f|/rho, as a Gaussian variance mixture:

      p(y|f) = Int N(y | f, v) Gamma(v; shape 2, rate beta) dv,
      beta = 3 / (2 rho^2)

    (closed via Int v^(nu-1) e^(-A/v - B v) dv = 2 (A/B)^(nu/2) K_nu(2
    sqrt(AB)) with nu = 3/2; K_{3/2} gives exactly the (1+u)e^-u kernel).
    The CAVI-optimal q(v_i) is GIG(a = 2 beta = 3/rho^2, b = c_i^2, p=3/2),
    and theta := E[1/v]/2 = 3 / (2 sqrt(3) c rho + 2 rho^2) via the
    K_{1/2}/K_{3/2} ratio -- the same working local update as the reference
    (matern.jl:58-69):
      c     = sqrt(E[(y-f)^2])
      grad_e_mu = 2 theta y, grad_e_sigma = theta

    The reference's version is unfinished: its ELBO throws and its Gibbs
    draw is inconsistent with its own E-step (likelihood/matern.jl:86-100;
    SURVEY.md flags it "partially broken").  Completed here:
    * `aug_kl` in closed form, so the reported ELBO is a true bound.  The
      -1/2 E[log v] of E[log N(y|f,v)] cancels the +1/2 E[log v] inside
      KL(q(v)||p(v)) exactly, so neither appears (both omitted
      consistently; no Bessel nu-derivatives needed).
    * exact Gibbs sampling: v | f ~ GIG(3/rho^2, (y-f)^2, 3/2) via the
      general-p sampler, theta = 1/(2v).
    """

    rho: jnp.ndarray = struct.field(default_factory=lambda: jnp.asarray(1.0))

    @classmethod
    def create(cls, rho: float = 1.0):
        return cls(rho=jnp.asarray(float(rho)))

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling"})

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        return {
            "c": jnp.ones((batchsize,), dtype=dtype),
            "theta": jnp.zeros((batchsize,), dtype=dtype),
        }

    def _local_updates(self, y, mu, var, local):
        c = jnp.sqrt((mu - y) ** 2 + var)
        theta = 3.0 / (2.0 * jnp.sqrt(3.0) * c * self.rho + 2.0 * self.rho**2)
        return self, {**local, "c": c, "theta": theta}

    def _grad_e_mu(self, y, local):
        return 2.0 * local["theta"] * y

    def _grad_e_sigma(self, y, local):
        return local["theta"]

    def _expec_loglik(self, y, mu, var, local):
        # E[log N(y | f, v)] with E[1/v] = 2 theta, OMITTING -1/2 E[log v]
        # which cancels exactly against the +1/2 E[log v] omitted from
        # aug_kl below (see class docstring).
        n = y.shape[0]
        theta = local["theta"]
        return -n * LOG2PI / 2.0 - jnp.sum(theta * ((mu - y) ** 2 + var))

    def aug_kl(self, local, y):
        # KL(q(v) || p(v)) - 1/2 E[log v], closed form, with
        #   q(v) = GIG(a, c^2, 3/2), a = 3/rho^2;  p(v) = Gamma(2, beta),
        #   beta = a/2.  The Gamma-rate and GIG x-coefficient terms cancel
        #   (a = 2 beta), leaving
        #   (3/4) log(a/c^2) - log(2 K_{3/2}(z)) - c^2 E[1/v]/2 - 2 log beta
        # with z = sqrt(a) c and E[1/v]/2 = theta.  The c -> 0 limit is
        # finite (the log c terms cancel analytically).
        c = jnp.maximum(local["c"], 1e-10)
        theta = local["theta"]
        a = 3.0 / self.rho**2
        beta = a / 2.0
        z = jnp.sqrt(a) * c
        # log(2 K_{3/2}(z)) = log 2 + 0.5 log(pi/(2z)) - z + log1p(1/z)
        log_2k32 = (
            LOG2
            + 0.5 * (jnp.log(jnp.pi) - LOG2 - jnp.log(z))
            - z
            + jnp.log1p(1.0 / z)
        )
        per_point = (
            0.75 * (jnp.log(a) - 2.0 * jnp.log(c))
            - log_2k32
            - c**2 * theta
            - 2.0 * jnp.log(beta)
        )
        return jnp.sum(per_point)

    def _sample_local(self, key, y, f, local):
        # exact blocked Gibbs: v | f ~ GIG(3/rho^2, (y-f)^2, 3/2)
        # (general-p masked-rejection sampler); omega = 1/v, theta = omega/2
        from ..distributions.gig import sample_gig

        a = jnp.full_like(f, 3.0) / self.rho**2
        v = sample_gig(key, a, (f - y) ** 2, 1.5)
        return {**local, "c": jnp.abs(f - y), "theta": 1.0 / (2.0 * v)}

    def compute_proba(self, mu, var):
        return mu, jnp.maximum(var, 0.0) + 4.0 * self.rho**2 / 3.0

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        u = jnp.sqrt(3.0) * jnp.abs(y - f) / self.rho
        # normalized matern-3/2 density: (sqrt(3)/(4 rho)) (1+u) e^{-u}
        # (normalization: 2 (rho/sqrt(3)) int_0^inf (1+u) e^-u du = 4 rho/sqrt(3))
        return jnp.log(jnp.sqrt(3.0) / (4.0 * self.rho)) + jnp.log1p(u) - u

    def grad_log_prob(self, y, f):
        return 3.0 * (y - f) / (self.rho * (jnp.abs(f - y) * jnp.sqrt(3.0) + self.rho))

    def hess_log_prob(self, y, f):
        return -3.0 / (self.rho + jnp.sqrt(3.0) * jnp.abs(f - y)) ** 2
