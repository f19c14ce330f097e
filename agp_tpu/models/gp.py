"""GP: exact Gaussian-process regression (Gaussian likelihood only).

JAX equivalent of the reference's src/models/GP.jl: posterior kept as
alpha = (K + sigma^2 I)^-1 (y - mu0) plus the Cholesky factor of
Sigma = K + sigma^2 I (models/GP.jl:22-35); one `analytic_update` refresh
per iteration with optional closed-form-gradient noise learning
(inference/analytic.jl:36-52).
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import optax
from ..utils import struct

from ..config import jitter
from ..inference.config import Analytic
from ..kernels import to_unconstrained as _to_unc, batch_gram
from ..likelihoods.regression import GaussianLikelihood
from ..means import PriorMean, ZeroMean, batch_call
from ..ops import linalg
from ..training.state import TrainState
from ..utils.opt import ascent_update
from .base import as_2d, prepare_components


class GP(struct.PyTreeNode):
    kernel: Any
    likelihood: GaussianLikelihood
    mean: PriorMean
    train_x: jnp.ndarray
    train_y: jnp.ndarray
    inference: Analytic = struct.field(pytree_node=False)
    n_latent: int = struct.field(pytree_node=False, default=1)
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
        noise: float = 1e-1,
        opt_noise=True,
        mean=None,
        optimiser="default",
        atfrequency: int = 1,
    ):
        X = as_2d(X)
        y = jnp.asarray(y, dtype=X.dtype)
        likelihood = GaussianLikelihood.create(noise, opt_noise=opt_noise)
        mean = ZeroMean() if mean is None else mean
        kernel, mean = prepare_components(kernel, likelihood, mean, 1)
        if optimiser == "default":
            optimiser = optax.adam(0.01)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            train_x=X,
            train_y=y,
            inference=Analytic(),
            optimiser=optimiser,
            atfrequency=atfrequency,
        )

    def init_state(self, key=None) -> TrainState:
        N = self.train_x.shape[0]
        dtype = self.train_x.dtype
        local = {}
        if self.likelihood.opt_noise is not None:
            local["state_sigma2"] = self.likelihood.opt_noise.init(
                jnp.zeros([], dtype)
            )
        hyper_state = None
        if self.optimiser is not None:
            hyper_state = {
                "kernel": self.optimiser.init(_to_unc(self.kernel)),
                "mean": self.optimiser.init(self.mean),
            }
        return TrainState(
            alpha=jnp.zeros((N,), dtype),
            chol_Sigma=jnp.eye(N, dtype=dtype),
            local_vars=local,
            hyper_state=hyper_state,
            step=jnp.zeros([], jnp.int32),
            key=key if key is not None else jax.random.PRNGKey(0),
            rho=jnp.ones([], dtype),
        )


def analytic_update(model: GP, state: TrainState) -> tuple[GP, TrainState]:
    """Sigma = K + sigma^2 I; alpha = Sigma^-1 (y - mu0); optional noise
    gradient step on log sigma^2 (reference: inference/analytic.jl:36-52)."""
    X, y = model.train_x, model.train_y
    K = batch_gram(model.kernel, X)[0]
    lik = model.likelihood
    Sigma = K + lik.sigma2 * jnp.eye(K.shape[0], dtype=K.dtype)
    L = jnp.linalg.cholesky(Sigma)  # sigma^2 already regularizes the diagonal
    mu0 = batch_call(model.mean, X, 1)[0]
    alpha = linalg.chol_solve(L, y - mu0)
    local = dict(state.local_vars)
    if lik.opt_noise is not None:
        # reference gradient: (|alpha|_2 - tr(Sigma^-1)) / 2, applied in
        # log space through the noise optimizer (analytic.jl:44-50);
        # the reference multiplies by sigma2 before the optimiser.
        g = (jnp.sum(alpha**2) - jnp.trace(linalg.chol_inv(L))) / 2.0
        opt_state, delta = ascent_update(
            lik.opt_noise, local["state_sigma2"], jnp.log(lik.sigma2), g * lik.sigma2
        )
        local["state_sigma2"] = opt_state
        lik = lik.replace(sigma2=jnp.exp(jnp.log(lik.sigma2) + delta))
        model = model.replace(likelihood=lik)
    return model, state.replace(alpha=alpha, chol_Sigma=L, local_vars=local)


def log_py(model: GP, state: TrainState) -> jnp.ndarray:
    """Marginal log-likelihood -1/2 (y-mu0)^T Sigma^-1 (y-mu0)
    - 1/2 logdet Sigma - N/2 log 2pi (reference: models/GP.jl:89-92)."""
    y = model.train_y
    mu0 = batch_call(model.mean, model.train_x, 1)[0]
    N = y.shape[0]
    quad = jnp.sum((y - mu0) * state.alpha)
    return -0.5 * (quad + linalg.chol_logdet(state.chol_Sigma) + N * jnp.log(2 * jnp.pi))


def _gp_repr(self):
    from .base import model_repr

    return model_repr(self)


GP.__repr__ = _gp_repr
