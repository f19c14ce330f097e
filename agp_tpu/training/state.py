"""The functional training state.

The reference threads a NamedTuple `state = (; local_vars, opt_state,
hyperopt_state, kernel_matrices)` through its training loop
(/root/reference/src/training/states.jl:1-9).  That idiom maps 1:1 onto a
JAX pytree carried through a jitted step function -- this module defines it.

All per-latent quantities are stacked on a leading latent axis L:
  eta1 [L, M]      first natural parameter  Sigma^-1 mu
  eta2 [L, M, M]   second natural parameter -1/2 Sigma^-1 (init -1/2 I)
  mu   [L, M], Sigma [L, M, M]   moment parameters
(reference: gpblocks/posterior.jl:21-37).
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp
from ..utils import struct


class TrainState(struct.PyTreeNode):
    # variational posterior (natural + moment parameterizations)
    eta1: Any = None
    eta2: Any = None
    mu: Any = None
    Sigma: Any = None
    # likelihood local variables (augmentation E-step state)
    local_vars: Any = None
    # optimizer state for stochastic natural-gradient steps
    opt_state: Any = None
    # optimizer states for hyperparameters {kernel, mean, Z}
    hyper_state: Any = None
    # cached kernel matrices {"L_K": [L,M,M], "K_inv": [L,M,M]}
    kmat: Any = None
    # minibatch scaling rho = N / batchsize
    rho: Any = None
    # iteration counter
    step: Any = None
    # PRNG key threaded through stochastic steps
    key: Any = None
    # exact-GP posterior: alpha = (K + sigma^2 I)^-1 (y - mu0), chol factor
    alpha: Any = None
    chol_Sigma: Any = None
    # sampling state (MCGP): current latent sample f [L, N]
    f: Any = None
    # multi-output mixing state (MOVGP/MOSVGP)
    A_state: Any = None
    # online (streaming) previous-model quantities
    previous: Any = None
    # Student-t process prior scale state {l2, chi} [L]
    prior_state: Any = None


def init_var_posterior(n_latent: int, M: int, dtype=jnp.float32):
    """eta2 = -1/2 I, Sigma = I, mu = eta1 = 0
    (reference: gpblocks/posterior.jl:29-37)."""
    eye = jnp.broadcast_to(jnp.eye(M, dtype=dtype), (n_latent, M, M))
    return dict(
        eta1=jnp.zeros((n_latent, M), dtype=dtype),
        eta2=-0.5 * eye,
        mu=jnp.zeros((n_latent, M), dtype=dtype),
        Sigma=eye,
    )
