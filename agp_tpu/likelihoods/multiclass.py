"""Multiclass likelihoods: Logistic-SoftMax (triple augmentation) and SoftMax.

Re-derivations of /root/reference/src/likelihood/multiclass.jl,
logisticsoftmax.jl and softmax.jl.  K classes = K latent GPs; labels are
one-hot encoded host-side by `treat_labels` (multiclass.jl:80-94) and the
per-class arrays are laid out [K, B] so the whole local update is one fused
elementwise block over a [K, B] tile (shardable along B).

Parity notes: the Gamma-entropy term uses sum(log beta) where the reference
evaluates `sum(log, first(beta))` -- a single element
(logisticsoftmax.jl:146-150).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..ops.kl import gamma_entropy_improper, poisson_kl_expected, polya_gamma_kl
from ..ops.special import digamma, safe_expcosh, sqrt_expec_square
from .base import Likelihood

LOG2 = 0.6931471805599453


class MultiClassLikelihood(Likelihood):
    """Shared shell: label <-> index mapping and one-hot encoding."""

    n_class: int = struct.field(pytree_node=False, default=2)
    class_mapping: Optional[Tuple] = struct.field(pytree_node=False, default=None)

    @property
    def n_latent(self):
        return self.n_class

    def treat_labels(self, y):
        y = np.asarray(y)
        if y.ndim != 1:
            raise ValueError("multiclass targets should be a vector of labels")
        lik = self
        if self.class_mapping is None:
            uniq = sorted(np.unique(y).tolist())
            if len(uniq) > self.n_class:
                raise ValueError(
                    f"{len(uniq)} unique labels found but n_class={self.n_class}"
                )
            if set(uniq) <= set(range(self.n_class)):
                mapping = tuple(range(self.n_class))
            elif set(uniq) <= set(range(1, self.n_class + 1)):
                mapping = tuple(range(1, self.n_class + 1))
            else:
                mapping = tuple(uniq)
            lik = self.replace(class_mapping=mapping)
        idx = {v: i for i, v in enumerate(lik.class_mapping)}
        onehot = np.zeros((y.shape[0], lik.n_class))
        for i, val in enumerate(y):
            onehot[i, idx[val]] = 1.0
        return jnp.asarray(onehot), lik

    def labels_from_indices(self, indices):
        mapping = self.class_mapping or tuple(range(self.n_class))
        return np.asarray([mapping[i] for i in np.asarray(indices)])

    def predict_y(self, mu):
        # mu: [K, N] -> index of the largest latent mean (predictions.jl:196-198)
        return jnp.argmax(mu, axis=0)


class LogisticSoftMaxLikelihood(MultiClassLikelihood):
    """p(y=k | f) = sigma(f_k) / sum_j sigma(f_j), made conjugate by a triple
    (Gamma, Poisson, Polya-Gamma) augmentation
    (reference: likelihood/logisticsoftmax.jl:43-94; Galy-Fajou et al. UAI'19).

    Local updates (logisticsoftmax.jl:55-79), with y one-hot [B, K]:
      c_k   = sqrt(E[f_k^2])
      repeat 2x (inner fixed point):
        gamma_k = exp(psi(alpha)) exp(-mu_k/2) / (2 beta cosh(c_k/2))
        alpha   = 1 + sum_k gamma_k
      theta_k = (y_k + gamma_k) tanh(c_k/2) / (2 c_k)
    """

    @classmethod
    def create(cls, num_class_or_labels):
        if isinstance(num_class_or_labels, int):
            return cls(n_class=num_class_or_labels)
        labels = tuple(np.unique(np.asarray(num_class_or_labels)).tolist())
        return cls(n_class=len(labels), class_mapping=labels)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "MCIntegrationVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=jnp.float32):
        K = self.n_class
        return {
            "c": jnp.ones((K, batchsize), dtype=dtype),
            "alpha": jnp.full((batchsize,), float(K), dtype=dtype),
            "beta": jnp.full((batchsize,), float(K), dtype=dtype),
            "theta": jnp.full((K, batchsize), 0.5, dtype=dtype),
            "gamma": jnp.full((K, batchsize), 0.5, dtype=dtype),
        }

    def local_updates(self, y, mu, var, local, w=None):
        # w unused: all E-step quantities are per-datapoint (the gamma/alpha
        # fixed point couples classes, not batch rows)
        yT = y.T  # [K, B]
        c = sqrt_expec_square(mu, var)  # [K, B]
        alpha, beta = local["alpha"], local["beta"]
        expcosh = safe_expcosh(-mu / 2.0, c / 2.0)  # [K, B]
        for _ in range(2):  # inner fixed-point (logisticsoftmax.jl:55-63)
            gamma = jnp.exp(digamma(alpha))[None, :] * expcosh / (2.0 * beta[None, :])
            alpha = 1.0 + jnp.sum(gamma, axis=0)
        theta = (yT + gamma) * jnp.tanh(c / 2.0) / (2.0 * c)
        return self, {**local, "c": c, "alpha": alpha, "gamma": gamma, "theta": theta}

    def grad_e_mu(self, y, local):
        return (y.T - local["gamma"]) / 2.0

    def grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        yT = y.T
        theta, gamma = local["theta"], local["gamma"]
        tot = -n * LOG2
        tot += -jnp.sum(gamma + yT) * LOG2
        tot += 0.5 * jnp.sum(mu * (yT - gamma) - theta * mu**2 - theta * var)
        return tot

    def aug_kl(self, local, y):
        yT = y.T
        alpha, beta = local["alpha"], local["beta"]
        pg = polya_gamma_kl(yT + local["gamma"], local["c"], local["theta"])
        po = poisson_kl_expected(
            local["gamma"],
            (alpha / beta)[None, :],
            (digamma(alpha) - jnp.log(beta))[None, :],
        )
        ga = gamma_entropy_improper(alpha, beta)
        return pg + po + ga

    def sample_local(self, key, y, f, local):
        from ..distributions.polyagamma import sample_pg

        yT = y.T
        k1, k2, k3 = jax.random.split(key, 3)
        # gamma_k ~ Po(alpha sigma(-f_k)), alpha ~ Ga(1 + sum gamma, 1/beta)
        rate = local["alpha"][None, :] * jax.nn.sigmoid(-f)
        gamma = jax.random.poisson(k1, rate).astype(f.dtype)
        alpha = (
            jax.random.gamma(k2, 1.0 + jnp.sum(gamma, axis=0), dtype=f.dtype)
            / local["beta"]
        )
        omega = sample_pg(k3, yT + gamma, jnp.abs(f))
        return {**local, "gamma": gamma, "alpha": alpha, "theta": omega}

    def link(self, f):
        """[K, ...] latent values -> class probabilities (normalized logistic)."""
        s = jax.nn.sigmoid(f)
        return s / jnp.sum(s, axis=0, keepdims=True)

    def compute_proba(self, mu, var, n_samples: int = 200, key=None):
        """MC estimate of E[p(y=k | f)] under the latent predictive.

        The reference plugs the mean in directly (multiclass.jl:176-190);
        we integrate over the latent Gaussian with quasi-random normals for a
        proper predictive (set n_samples=0 for the plug-in behavior)."""
        if n_samples == 0 or key is None:
            return self.link(mu).T
        eps = jax.random.normal(key, (n_samples,) + mu.shape, dtype=mu.dtype)
        f = mu[None] + jnp.sqrt(jnp.maximum(var, 0.0))[None] * eps
        return jnp.mean(jax.vmap(self.link)(f), axis=0).T  # [N, K]

    def log_prob(self, y, f):
        # y one-hot [K] or [K, B]; f [K] or [K, B]
        logp = jax.nn.log_sigmoid(f) - jnp.log(
            jnp.sum(jax.nn.sigmoid(f), axis=0, keepdims=True)
        )
        return jnp.sum(y * logp, axis=0)


class SoftMaxLikelihood(MultiClassLikelihood):
    """Plain softmax multiclass -- no augmentation exists; MC-integration VI
    only (reference: likelihood/softmax.jl)."""

    @classmethod
    def create(cls, num_class_or_labels):
        if isinstance(num_class_or_labels, int):
            return cls(n_class=num_class_or_labels)
        labels = tuple(np.unique(np.asarray(num_class_or_labels)).tolist())
        return cls(n_class=len(labels), class_mapping=labels)

    @classmethod
    def implemented(cls):
        return frozenset({"MCIntegrationVI", "HMCSampling"})

    def link(self, f):
        return jax.nn.softmax(f, axis=0)

    def compute_proba(self, mu, var, n_samples: int = 200, key=None):
        if n_samples == 0 or key is None:
            return self.link(mu).T
        eps = jax.random.normal(key, (n_samples,) + mu.shape, dtype=mu.dtype)
        f = mu[None] + jnp.sqrt(jnp.maximum(var, 0.0))[None] * eps
        return jnp.mean(jax.vmap(self.link)(f), axis=0).T

    def log_prob(self, y, f):
        return jnp.sum(y * jax.nn.log_softmax(f, axis=0), axis=0)
