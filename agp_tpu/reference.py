"""Plain float64 numpy CAVI for single-latent sparse models.

An implementation of the blockwise natural-gradient CAVI iteration
(reference: inference/analyticVI.jl:62-180) that shares no code with the
JAX path: numpy in float64, explicit inverses, one loop over minibatches.
The CPU tests and `chip_smoke.py` compare `agp_tpu`'s step against it.

Scope: SVGP with a zero prior mean, an RBF kernel (isotropic or ARD
lengthscale) and one of the eight single-latent augmented likelihoods
of `e_step`, trained by `AnalyticVI` (exact CAVI) or `AnalyticSVI` with the
default Robbins-Monro schedule on caller-supplied minibatches.
"""
from __future__ import annotations

import numpy as np

def rbf(A, C, lengthscale, variance):
    """RBF gram variance * exp(-|a - c|^2 / 2) on lengthscale-scaled inputs."""
    A = np.asarray(A, np.float64) / lengthscale
    C = np.asarray(C, np.float64) / lengthscale
    d2 = (A * A).sum(1)[:, None] + (C * C).sum(1)[None, :] - 2.0 * A @ C.T
    return variance * np.exp(-0.5 * np.maximum(d2, 0.0))


def _expected_sigmoid(mf, vf, n=100):
    x, w = np.polynomial.hermite.hermgauss(n)
    nodes = mf[:, None] + np.sqrt(np.maximum(vf, 0.0))[:, None] * np.sqrt(2.0) * x
    return (w / np.sqrt(np.pi) * (1.0 / (1.0 + np.exp(-nodes)))).sum(1)


def e_step(name, params, y, mf, vf):
    """Closed-form q(omega) update.  Returns (grad_e_mu, grad_e_sigma,
    local variables, likelihood parameters for the next step)."""
    params = dict(params)
    if name == "logistic":
        c = np.sqrt(mf**2 + vf)
        theta = np.tanh(c / 2) / (2 * c)
        return y / 2, theta / 2, {"c": c, "theta": theta}, params
    if name == "gaussian":
        theta = np.full_like(mf, 1.0 / params["sigma2"])
        return y / params["sigma2"], theta / 2, {"theta": theta}, params
    if name == "studentt":
        nu, sigma = params["nu"], params["sigma"]
        c = ((mf - y) ** 2 + vf + sigma**2 * nu) / 2
        theta = (nu + 1) / 2 / c
        return theta * y, theta / 2, {"c": c, "theta": theta}, params
    if name == "laplace":
        b = np.sqrt((mf - y) ** 2 + vf)
        theta = params["beta"] ** -1.0 / b
        return theta * y, theta / 2, {"b": b, "theta": theta}, params
    if name == "bayesiansvm":
        c = (1 - y * mf) ** 2 + vf
        theta = 1 / np.sqrt(c)
        return y * (theta + 1), theta / 2, {"c": c, "theta": theta}, params
    if name == "matern32":
        rho = params["rho"]
        c = np.sqrt((mf - y) ** 2 + vf)
        theta = 3 / (2 * np.sqrt(3) * c * rho + 2 * rho**2)
        return 2 * theta * y, theta, {"c": c, "theta": theta}, params
    if name == "negbinomial":
        r = params["r"]
        c = np.sqrt(mf**2 + vf)
        theta = (r + y) * np.tanh(c / 2) / (2 * c)
        return (y - r) / 2, theta / 2, {"c": c, "theta": theta}, params
    if name == "poisson":
        c = np.sqrt(mf**2 + vf)
        gamma = params["lam"] * np.exp(-mf / 2) / np.cosh(c / 2) / 2
        theta = (y + gamma) * np.tanh(c / 2) / (2 * c)
        params["lam"] = y.sum() / _expected_sigmoid(mf, vf).sum()
        local = {"c": c, "gamma": gamma, "theta": theta}
        return (y - gamma) / 2, theta / 2, local, params
    raise ValueError(f"unknown likelihood {name!r}")


def _sym(A):
    return 0.5 * (A + A.T)


def svgp_cavi(batches, Z, lengthscale, variance, likelihood="logistic",
              params=None, rho=1.0, jitter=1e-3, stochastic=True,
              rm_kappa=0.51, rm_tau=1.0, kappa_dot=np.matmul):
    """Run one CAVI step per (x, y) minibatch in `batches` from the
    standard initial posterior (mu = 0, Sigma = I).

    `jitter` is added to the diagonal of Kmm and of Ktilde, as the JAX path
    does for its dtype (`agp_tpu.config.jitter`).  `rho` scales the batch
    statistics (N / batchsize).  stochastic=True applies the Robbins-Monro
    step (rm_tau + n)^-rm_kappa to the natural-parameter update of step n
    (0-based); False jumps to the coordinate-ascent target.  `kappa_dot`
    forms kappa = Knm K^-1 (a stand-in for a lower-precision product).

    Returns a dict with mu [M], Sigma [M, M], eta1, eta2, the last step's
    local variables and the likelihood parameters."""
    params = dict(params or {})
    Z = np.asarray(Z, np.float64)
    M = Z.shape[0]
    Kmm = rbf(Z, Z, lengthscale, variance) + jitter * np.eye(M)
    Kinv = _sym(np.linalg.inv(Kmm))
    eta1, eta2 = np.zeros(M), -0.5 * np.eye(M)
    mu, Sigma = np.zeros(M), np.eye(M)
    local = {}
    for n, (x, y) in enumerate(batches):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        Knm = rbf(x, Z, lengthscale, variance)
        kappa = kappa_dot(Knm, Kinv)
        Ktilde = np.maximum(variance + jitter - (kappa * Knm).sum(1), 1e-12)
        mf = kappa @ mu
        vf = Ktilde + ((kappa @ Sigma) * kappa).sum(1)
        gmu, gs, local, params = e_step(likelihood, params, y, mf, vf)
        s1 = kappa.T @ (rho * gmu)
        S2 = (kappa * (rho * gs)[:, None]).T @ kappa
        t1, t2 = s1, -(S2 + 0.5 * Kinv)
        if stochastic:
            step = (rm_tau + n) ** -rm_kappa
            eta1 = eta1 + step * (t1 - eta1)
            eta2 = _sym(eta2 + step * (t2 - eta2))
        else:
            eta1, eta2 = t1, _sym(t2)
        Sigma = _sym(0.5 * np.linalg.inv(-eta2))
        mu = Sigma @ eta1
    return {"mu": mu, "Sigma": Sigma, "eta1": eta1, "eta2": eta2,
            "local": local, "params": params}


def max_rel_err(a, ref):
    """max |a - ref| / max |ref|: the error measure of the parity checks."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300))
