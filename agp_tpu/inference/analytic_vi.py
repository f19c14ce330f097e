"""AnalyticVI / AnalyticSVI: blockwise CAVI with natural-gradient updates.

A JAX re-design of the reference's src/inference/analyticVI.jl.
One CAVI iteration is a single jitted program:

  kernel matrices -> (kappa, Ktilde) -> mean_f/var_f -> likelihood E-step ->
  natural gradient -> eta -> (mu, Sigma)

Hot ops:
  * Knm gram + kappa = Knm Kmm^-1       -> batched [L,B,M]x[L,M,M] matmuls
  * kappa^T diag(theta) kappa           -> one einsum contraction; this
    [M,M]-sized statistic (plus kappa^T grad_e_mu, an [M] vector) is the ONLY
    cross-data reduction of the step -- under a sharded data axis these are
    psum-ed (see parallel/mesh.py), everything else is local.
  * local updates                       -> fused elementwise [L,B] block
  * eta -> moments                      -> [L,M,M] Cholesky, vmapped

Update equations (re-derived; reference analyticVI.jl:126-180):
  dense:  eta1 = gmu + K^-1 mu0;  eta2 = -(Diag(gs) + K^-1/2)
  sparse: d_eta1 = kappa^T (rho gmu) + K^-1 mu0 - eta1
          d_eta2 = -(rho kappa^T Diag(gs) kappa + K^-1/2) - eta2
  stochastic: eta += RobbinsMonro-scaled d_eta; else eta += d_eta (exact CAVI).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import jitter
from ..kernels import batch_diag, batch_gram, batch_gram_zz
from ..means import batch_call
from ..ops import linalg
from ..ops.kl import gaussian_kl
from ..training.state import TrainState
from ..utils.opt import ascent_update


# --------------------------------------------------------------- kernel mats
def compute_kmat(model, X) -> Dict[str, jnp.ndarray]:
    """Cholesky + inverse of the prior covariance over the inducing inputs
    (sparse: Z [L,M,D]; full: the training inputs X)
    (reference: gpblocks/latentgp.jl:201-207)."""
    if model.is_sparse:
        K = batch_gram_zz(model.kernel, model.Z)
    else:
        K = batch_gram(model.kernel, X)
    jitt = jitter(K.dtype)
    L_K = jax.vmap(lambda k: linalg.safe_cholesky(k, jitt))(K)
    K_inv = jax.vmap(linalg.chol_inv)(L_K)
    return {"L_K": L_K, "K_inv": K_inv}


# The cheapest algorithm whose kappa passed the step-parity and accuracy
# checks of chip_smoke.py on an H100 (PERF.md, Findings): three bf16
# passes, about 16 mantissa bits of each operand.
KAPPA_ALGORITHM = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def _kappa_precision(dtype, rows: int = 2, m: int = 2):
    """Dot algorithm for the kappa = Knm K^-1 product in `dtype`, for a
    batch of `rows` rows and `m` inducing points.

    The product cancels internally: K_inv entries are O(cond(Kmm)) while
    kappa is O(1), so the relative error of the operands' rounding is
    amplified by cond(Kmm).  One bf16 pass (8 mantissa bits) or TF32 (10
    bits, what an f32 DEFAULT or HIGH dot runs as on an H100) leaves
    O(1) errors on moderately ill-conditioned Kmm, which wrecks SVGP
    classification.  float32 operands therefore name an explicit algorithm,
    `KAPPA_ALGORITHM`, so that the product is the same arithmetic on every
    backend; AGP_TPU_KAPPA_PRECISION=<DotAlgorithmPreset name> (e.g.
    tf32_tf32_f32_x3) overrides it.  A product with one row or one
    inducing point is a matrix-vector product: memory-bound, so it runs in
    exact float32 (XLA's CPU emitter has no multi-pass algorithm for it).
    Wider dtypes keep their native product."""
    import os

    if jnp.dtype(dtype) != jnp.float32:
        return None
    name = os.environ.get("AGP_TPU_KAPPA_PRECISION")
    if name:
        return jax.lax.DotAlgorithmPreset[name.upper()]
    if min(rows, m) == 1:
        return jax.lax.DotAlgorithmPreset.F32_F32_F32
    return KAPPA_ALGORITHM


def compute_kappa(model, x, kmat):
    """(Knm, kappa = Knm Kmm^-1, Ktilde) for a data batch
    (reference: gpblocks/latentgp.jl:209-215).

    The reference asserts Ktilde > 0; on accelerators we clamp at a tiny
    positive floor instead of aborting the jitted program."""
    Knm = batch_gram(model.kernel, x, model.Z)  # [L, B, M]
    # kappa cancels by cond(Kmm): see _kappa_precision.  The downstream
    # additive statistics keep the default precision.
    kappa = jnp.einsum(
        "lbm,lmn->lbn",
        Knm,
        kmat["K_inv"],
        preferred_element_type=Knm.dtype,
        precision=_kappa_precision(Knm.dtype, *Knm.shape[-2:]),
    )
    kdiag = batch_diag(model.kernel, x)  # [L, B]
    Ktilde = kdiag + jitter(Knm.dtype) - linalg.diag_ABt(kappa, Knm)
    Ktilde = jnp.maximum(Ktilde, 1e-12)
    return Knm, kappa, Ktilde


def latent_moments(model, state: TrainState, x, kmat):
    """mean_f/var_f of the latent function at the batch
    (reference: gpblocks/latentgp.jl:171-189).

    The n_latent == 1 sparse path uses unbatched [B, M] matmuls instead
    of batch-1 einsums.  The third return value is kappa [L, B, M]."""
    if model.is_sparse:
        if getattr(model, "is_online", False):
            from ..models.online_svgp import masked_kappa

            _, kappa, Ktilde = masked_kappa(model, x, kmat)
        elif model.n_latent == 1:
            kernel1 = jax.tree_util.tree_map(lambda l: l[0], model.kernel)
            Knm = kernel1.gram(x, model.Z[0])  # [B, M]
            kappa1 = jnp.dot(
                Knm, kmat["K_inv"][0], precision=_kappa_precision(Knm.dtype, *Knm.shape)
            )
            Ktilde1 = (
                kernel1.diag(x) + jitter(Knm.dtype) - jnp.sum(kappa1 * Knm, axis=1)
            )
            Ktilde1 = jnp.maximum(Ktilde1, 1e-12)
            mu_f = (kappa1 @ state.mu[0])[None]
            vf = Ktilde1 + jnp.sum((kappa1 @ state.Sigma[0]) * kappa1, axis=1)
            return mu_f, vf[None], kappa1[None]
        else:
            _, kappa, Ktilde = compute_kappa(model, x, kmat)
        mu_f = jnp.einsum("lbm,lm->lb", kappa, state.mu)
        kS = jnp.einsum(
            "lbm,lmn->lbn", kappa, state.Sigma, preferred_element_type=kappa.dtype
        )
        var_f = Ktilde + linalg.diag_ABt(kS, kappa)
        return mu_f, var_f, kappa
    mu_f = state.mu
    var_f = jnp.diagonal(state.Sigma, axis1=-2, axis2=-1)
    return mu_f, var_f, None


# ----------------------------------------------------------------- CAVI step
def variational_update(
    model, state: TrainState, x, y, w=None, fused: bool = True
) -> Tuple[Any, TrainState]:
    """One blockwise coordinate-ascent update (E-step + natural gradient +
    global update), reference analyticVI.jl:62-85.

    `w` ([B] of 0/1, optional) zero-weights padded rows out of every
    cross-batch statistic -- used by the sharded full-batch drivers
    (parallel/mesh.py) when N is not divisible by the mesh size.  The
    statistics s1/stat2 are linear in the per-row gmu/gs, so masking those
    (plus the likelihood-parameter sums, see Likelihood.local_updates)
    makes the padded trajectory bit-equivalent to the unpadded one.

    `fused=False` keeps the statistics pass in XLA on every platform.  The
    GSPMD drivers of parallel/mesh.py pass it: the partitioner cannot split
    the Triton kernel's custom call, so it would gather the sharded batch
    onto every device and run the whole pass on each."""
    if getattr(model, "is_tprior", False):
        from ..models.vstp import local_prior_updates

        state = local_prior_updates(model, state, x)

    if w is None and fused and _fused_logistic_applies(model, x):
        # the platform the program is compiled for picks the branch
        s1, stat2, c, theta = jax.lax.platform_dependent(
            model, state, x, y,
            cuda=_fused_logistic_stats, default=_logistic_stats,
        )
        local = {**state.local_vars, "c": c, "theta": theta}
        return model, _nat_update_from_stats(
            model, state.replace(local_vars=local), s1, stat2, x
        )

    lik, local, kappa, gmu, gs = _e_step(model, state, x, y, w)
    model = model.replace(likelihood=lik)
    state = apply_natural_gradient(model, state.replace(local_vars=local), kappa, gmu, gs, x)
    return model, state


def _e_step(model, state: TrainState, x, y, w=None):
    """Latent moments and the likelihood's closed-form q(omega) update on a
    batch: (likelihood, local vars, kappa, gmu, gs), with gmu/gs [L, B]
    zero-weighted by `w`."""
    mu_f, var_f, kappa = latent_moments(model, state, x, state.kmat)
    lik, local = model.likelihood.local_updates(y, mu_f, var_f, state.local_vars, w=w)
    gmu = lik.grad_e_mu(y, local)
    gs = lik.grad_e_sigma(y, local)
    if w is not None:
        gmu = gmu * w
        gs = gs * w
    return lik, local, kappa, gmu, gs


# Shapes at which the one-pass Triton statistics kernel replaces the XLA
# statistics pass on a CUDA GPU: the (M, B) region timed on an H100, where
# it won or tied at every point (PERF.md).  At M=128 it only tied; at M=512
# its operands exceed a block's shared memory.
FUSED_M = (16, 64)
FUSED_B = (512, 65_536)


def _fused_logistic_applies(model, x) -> bool:
    """Shape gate of ops/triton_stats.py: SVGP + RBF + logistic, one
    latent, float32, M in FUSED_M and a batch of B rows in FUSED_B.  Where
    it holds, the platform the step is compiled for decides
    (`lax.platform_dependent`): CUDA runs the kernel, every other platform
    the XLA pass."""
    return (
        x.dtype == jnp.float32
        and model.is_sparse
        and model.n_latent == 1
        and not getattr(model, "is_online", False)
        and not getattr(model, "is_tprior", False)
        and type(model.kernel).__name__ == "SqExponentialKernel"
        and type(model.likelihood).__name__ == "LogisticLikelihood"
        and FUSED_M[0] <= model.n_inducing <= FUSED_M[1]
        and FUSED_B[0] <= x.shape[0] <= FUSED_B[1]
    )


def _logistic_stats(model, state: TrainState, x, y):
    """The XLA statistics pass of the fused gate's models:
    (s1 [1, M], stat2 [1, M, M], c [B], theta [B])."""
    _, local, kappa, gmu, gs = _e_step(model, state, x, y)
    s1, stat2 = sparse_statistics(model, kappa, state.rho, gmu, gs)
    return s1, stat2, local["c"], local["theta"]


@jax.custom_vjp
def _fused_logistic_stats(model, state: TrainState, x, y):
    """`_logistic_stats` as one Triton kernel (ops/triton_stats.py).  Its
    gradient is that of the XLA pass."""
    from ..ops import triton_stats

    ls = jnp.reshape(model.kernel.lengthscale, (model.n_latent, -1))[0]
    s1, S2, c, theta = triton_stats.fused_logistic_stats(
        x / ls,
        y.astype(x.dtype),
        model.Z[0] / ls,
        state.kmat["K_inv"][0],
        state.mu[0],
        state.Sigma[0],
        jnp.ravel(model.kernel.variance)[0].astype(x.dtype),
        jitter(x.dtype),
        state.rho.astype(x.dtype),
        _kappa_precision(x.dtype, x.shape[0], model.n_inducing),
    )
    return s1[None], S2[None], c, theta


def _fused_fwd(model, state, x, y):
    return _fused_logistic_stats(model, state, x, y), (model, state, x, y)


def _fused_bwd(res, cot):
    return jax.vjp(_logistic_stats, *res)[1](cot)


_fused_logistic_stats.defvjp(_fused_fwd, _fused_bwd)


def sparse_statistics(model, kappa, rho, gmu, gs):
    """The two cross-data statistics of a sparse step:
    s1 = kappa^T (rho gmu) [L, M] and stat2 = kappa^T diag(rho gs) kappa
    [L, M, M]."""
    if model.n_latent == 1 and not getattr(model, "is_online", False):
        k1 = kappa[0]
        s1 = (k1.T @ (rho * gmu[0]))[None]
        stat2 = ((k1 * (rho * gs[0])[:, None]).T @ k1)[None]
        return s1, stat2
    s1 = jnp.einsum("lbm,lb->lm", kappa, rho * gmu)
    stat2 = jnp.einsum(
        "lbm,lb,lbn->lmn", kappa, rho * gs, kappa, preferred_element_type=kappa.dtype
    )
    return s1, stat2


def apply_natural_gradient(model, state: TrainState, kappa, gmu, gs, x) -> TrainState:
    """Shared natural-gradient + global update given the latent-axis
    gradient expectations gmu/gs [L, B] (used by both single-likelihood and
    multi-output paths)."""
    if model.is_sparse:
        s1, stat2 = sparse_statistics(model, kappa, state.rho, gmu, gs)
        return _nat_update_from_stats(model, state, s1, stat2, x)

    mu0 = prior_mean_stack(model, x)  # [L, M]
    K_inv = state.kmat["K_inv"]
    if getattr(model, "is_tprior", False):
        # Student-t prior: effective precision chi K^-1 (see models/vstp.py)
        K_inv = state.prior_state["chi"][:, None, None] * K_inv
    Kinv_mu0 = jnp.einsum("lmn,ln->lm", K_inv, mu0)
    eta1 = gmu + Kinv_mu0
    eta2 = linalg.symmetrize(-(jax.vmap(jnp.diag)(gs) + 0.5 * K_inv))
    return state.replace(
        eta1=eta1, eta2=eta2, **_moments_kw(model, eta1, eta2, state.Sigma)
    )


def _nat_update_from_stats(model, state: TrainState, s1, stat2, x) -> TrainState:
    """Sparse natural-gradient global update given the two cross-data
    statistics s1 = kappa^T (rho gmu) [L, M] and
    stat2 = kappa^T diag(rho gs) kappa [L, M, M]."""
    kmat = state.kmat
    mu0 = prior_mean_stack(model, x)
    K_inv = kmat["K_inv"]
    if getattr(model, "is_tprior", False):
        K_inv = state.prior_state["chi"][:, None, None] * K_inv
    Kinv_mu0 = jnp.einsum("lmn,ln->lm", K_inv, mu0)

    nat1_target = s1 + Kinv_mu0
    nat2_target = -(stat2 + 0.5 * K_inv)
    if model.inference.stochastic:
        d_eta1 = nat1_target - state.eta1
        d_eta2 = nat2_target - state.eta2
        opt_state, (u1, u2) = ascent_update(
            model.inference.optimiser,
            state.opt_state,
            (state.eta1, state.eta2),
            (d_eta1, d_eta2),
        )
        eta1 = state.eta1 + u1
        eta2 = linalg.symmetrize(state.eta2 + u2)
        state = state.replace(opt_state=opt_state)
    else:
        eta1 = nat1_target
        eta2 = linalg.symmetrize(nat2_target)
    return state.replace(
        eta1=eta1, eta2=eta2, **_moments_kw(model, eta1, eta2, state.Sigma)
    )


# Largest matrix dim for which the warm-started Newton-Schulz conversion is
# the default: it beat Cholesky end to end on an H100 at M=64, M=512 and
# batched [10, 64, 64] (PERF.md).
FAST_MOMENTS_MAX_DIM = 512


def _fast_moments_enabled(dim: int | None = None) -> bool:
    """Warm-started Newton-Schulz eta->moments conversion
    (ops/linalg.py::nat_to_moments_warm): matmuls only, in place of the
    sequential Cholesky + triangular solves.  Exact to f32 roundoff, with a
    Cholesky fallback when the warm start is far.  The default depends on
    the matrix dim alone (`FAST_MOMENTS_MAX_DIM`), so every device runs the
    same algorithm.  AGP_TPU_FAST_MOMENTS=0 forces the exact path, =1
    forces fast."""
    import os

    flag = os.environ.get("AGP_TPU_FAST_MOMENTS")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return dim is not None and dim <= FAST_MOMENTS_MAX_DIM


def _moments_kw(model, eta1, eta2, Sigma_prev=None):
    fast = Sigma_prev is not None and _fast_moments_enabled(eta1.shape[-1])
    if model.n_latent == 1:
        # unbatched [M, M] Cholesky/solves rather than a batch-1 vmap
        if fast:
            mu1, Sigma1 = linalg.nat_to_moments_warm(eta1[0], eta2[0], Sigma_prev[0])
        else:
            mu1, Sigma1 = linalg.nat_to_moments(eta1[0], eta2[0])
        return dict(mu=mu1[None], Sigma=Sigma1[None])
    if fast:
        mu, Sigma = linalg.nat_to_moments_warm_batched(eta1, eta2, Sigma_prev)
    else:
        mu, Sigma = jax.vmap(linalg.nat_to_moments)(eta1, eta2)
    return dict(mu=mu, Sigma=Sigma)


def prior_mean_stack(model, x):
    """[L, M] prior mean over the inducing inputs (Z for sparse, x for full)."""
    if model.is_sparse:
        mu0 = batch_call(model.mean, model.Z, model.n_latent)
        if getattr(model, "is_online", False):
            mu0 = mu0 * model.z_mask
        return mu0
    return batch_call(model.mean, x, model.n_latent)


# ---------------------------------------------------------------------- ELBO
def elbo(model, state: TrainState, x, y, kmat=None) -> jnp.ndarray:
    """ELBO = rho E[log p(y|f,omega)] - GaussianKL - rho AugmentedKL
    (reference: analyticVI.jl:255-297).  The augmented KL is excluded from
    hyperparameter gradients exactly as the reference does with
    `ChainRulesCore.ignore_derivatives` (analyticVI.jl:269-271)."""
    kmat = state.kmat if kmat is None else kmat
    mu_f, var_f, _ = latent_moments(model, state, x, kmat)
    rho = state.rho if model.is_sparse else jnp.asarray(1.0, mu_f.dtype)
    tot = rho * model.likelihood.expec_loglik(y, mu_f, var_f, state.local_vars)
    mu0 = prior_mean_stack(model, x)
    L_K = kmat["L_K"]
    if getattr(model, "is_tprior", False) and state.prior_state is not None:
        # prior covariance K / chi: scale the Cholesky factor
        L_K = L_K / jnp.sqrt(state.prior_state["chi"])[:, None, None]
    kl = jax.vmap(gaussian_kl)(state.mu, mu0, state.Sigma, L_K)
    tot -= jnp.sum(kl)
    tot -= jax.lax.stop_gradient(
        rho * model.likelihood.aug_kl(state.local_vars, y)
    )
    tot -= extra_kl(model, state, kmat)
    return tot


def extra_kl(model, state, kmat=None):
    """Online-model extra KL (zero otherwise); see models/online_svgp.py.

    `kmat` must be the same kernel matrices the rest of the ELBO uses so
    that hyperparameter gradients through the streaming extraKL term are
    consistent (the hyper step recomputes kmat with the candidate kernel;
    reading state.kmat here would mix the new gram with stale factors)."""
    if getattr(model, "is_online", False) and state.previous is not None:
        from ..models.online_svgp import online_extra_kl

        return online_extra_kl(model, state, kmat)
    return jnp.asarray(0.0, state.mu.dtype)
