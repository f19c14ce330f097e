"""Inference-engine configurations.

The reference's inference objects mix static configuration with mutable
iteration state (reference: src/inference/inference.jl).  Here the
split is: everything here is *static* (hashable Python dataclasses used as jit
constants); the dynamic parts (rho, iteration counter, optimizer states,
local variables) live in the TrainState pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import optax

from ..utils.opt import robbins_monro


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    @property
    def name(self) -> str:
        return type(self).__name__

    stochastic: bool = False
    batchsize: int = 0


@dataclasses.dataclass(frozen=True)
class Analytic(InferenceConfig):
    """Exact conjugate solve for `GP` (reference: inference/analytic.jl)."""

    stochastic: bool = False
    batchsize: int = 0


@dataclasses.dataclass(frozen=True)
class AnalyticVI(InferenceConfig):
    """Blockwise CAVI with closed-form natural-gradient updates
    (reference: inference/analyticVI.jl).  Non-stochastic: the natural
    parameters jump straight to the coordinate-ascent optimum each step.

    minibatch_sampling: "gather" draws b iid indices (a random-access HBM
    gather); "slice" takes a contiguous window at a random offset -- a
    dynamic-slice; statistically equivalent when the data rows are
    pre-shuffled.  "block" (or "block:<n>") gathers b/n random aligned
    n-row tiles (default n=64, halved until it divides b) -- the same
    bytes as "gather" in n-times fewer, larger transactions (a block
    bootstrap: tiles are iid samples of n exchangeable rows; requires
    batchsize % n == 0, else falls back to "gather")."""

    stochastic: bool = False
    batchsize: int = 0
    optimiser: Optional[Any] = None  # optax transform for stochastic nat-grads
    minibatch_sampling: str = "gather"

    @property
    def name(self):
        return "AnalyticVI"


def AnalyticSVI(batchsize: int, optimiser=None, minibatch_sampling: str = "gather") -> AnalyticVI:
    """Stochastic AnalyticVI on minibatches with Robbins-Monro steps
    (reference: inference/analyticVI.jl:44-48)."""
    if optimiser is None:
        optimiser = robbins_monro()
    return AnalyticVI(
        stochastic=True,
        batchsize=batchsize,
        optimiser=optimiser,
        minibatch_sampling=minibatch_sampling,
    )


@dataclasses.dataclass(frozen=True)
class QuadratureVI(InferenceConfig):
    """Numerical VI with Gauss-Hermite expectations of the log-likelihood
    (reference: inference/quadratureVI.jl)."""

    stochastic: bool = False
    batchsize: int = 0
    n_points: int = 100
    clipping: float = 0.0
    natural: bool = True
    optimiser: Optional[Any] = None

    def __post_init__(self):
        if self.optimiser is None:
            object.__setattr__(self, "optimiser", optax.sgd(1e-5, momentum=0.9))

    @property
    def name(self):
        return "QuadratureVI"


def QuadratureSVI(batchsize: int, n_points: int = 100, optimiser=None, **kw) -> QuadratureVI:
    return QuadratureVI(
        stochastic=True, batchsize=batchsize, n_points=n_points, optimiser=optimiser, **kw
    )


@dataclasses.dataclass(frozen=True)
class MCIntegrationVI(InferenceConfig):
    """Numerical VI with Monte-Carlo expectations
    (reference: inference/MCVI.jl)."""

    stochastic: bool = False
    batchsize: int = 0
    n_mc: int = 1000
    clipping: float = 0.0
    natural: bool = True
    optimiser: Optional[Any] = None

    def __post_init__(self):
        if self.optimiser is None:
            object.__setattr__(self, "optimiser", optax.sgd(1e-3, momentum=0.9))

    @property
    def name(self):
        return "MCIntegrationVI"


def MCIntegrationSVI(batchsize: int, n_mc: int = 200, optimiser=None, **kw) -> MCIntegrationVI:
    return MCIntegrationVI(
        stochastic=True, batchsize=batchsize, n_mc=n_mc, optimiser=optimiser, **kw
    )


@dataclasses.dataclass(frozen=True)
class GibbsSampling(InferenceConfig):
    """Blocked Gibbs sampling over (omega, f)
    (reference: inference/gibbssampling.jl).

    solver: global-resample algorithm -- "chol" (exact O(N^3) Cholesky,
    the reference's), "cg" (matmul-only whitened perturb-and-solve CG;
    exact up to 1e-5 solver tolerance), "auto" (cg for N >= 1024, on every
    device; see inference/gibbs.py::CG_MIN_N)."""

    stochastic: bool = False
    batchsize: int = 0
    n_burnin: int = 100
    thinning: int = 1
    solver: str = "auto"

    @property
    def name(self):
        return "GibbsSampling"


@dataclasses.dataclass(frozen=True)
class HMCSampling(InferenceConfig):
    """Hamiltonian sampling of f on the whitened latents.

    algorithm="nuts" (default): bounded-depth iterative multinomial NUTS
    with the generalized no-U-turn criterion (matches the reference's spec,
    hmcsampling.jl:68-106, whose own implementation is bitrotted);
    algorithm="hmc": fixed-length leapfrog.  Both with dual-averaging
    step-size adaptation during burn-in."""

    stochastic: bool = False
    batchsize: int = 0
    n_burnin: int = 100
    thinning: int = 1
    step_size: float = 0.1
    n_leapfrog: int = 16  # hmc only
    max_depth: int = 8  # nuts only
    algorithm: str = "nuts"

    @property
    def name(self):
        return "HMCSampling"


def NumericalVI(integration_technique: str = "quad", **kw):
    """General numerical-VI constructor (reference: numericalVI.jl:36-56)."""
    if integration_technique == "quad":
        return QuadratureVI(**kw)
    if integration_technique == "mc":
        return MCIntegrationVI(**kw)
    raise ValueError("integration_technique must be 'quad' or 'mc'")


def NumericalSVI(batchsize: int, integration_technique: str = "quad", **kw):
    """Stochastic numerical VI (reference: numericalVI.jl:59-96)."""
    if integration_technique == "quad":
        return QuadratureSVI(batchsize, **kw)
    if integration_technique == "mc":
        return MCIntegrationSVI(batchsize, **kw)
    raise ValueError("integration_technique must be 'quad' or 'mc'")
