"""Multi-output models: MOVGP / MOSVGP (linear model of coregionalization).

Equivalent of /root/reference/src/models/MOVGP.jl, MOSVGP.jl and
single_and_multi_output_utils.jl: T tasks share Q latent GPs through
per-output mixing vectors A, learned by gradient steps + unit-norm
projection (single_and_multi_output_utils.jl:87-118).

Layout: the per-task/per-f structure A[t][j][q] is flattened to
one mixing matrix A [R, Q] over "output rows" r = (t, j); the mixing of
means/variances/gradients is then a pair of [R, Q] x [Q, B] matmuls
instead of nested loops.  Tasks may have heterogeneous likelihoods (a
Python tuple -- static structure, separate local-vars pytrees).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from ..utils import struct

from ..inference.config import AnalyticVI, InferenceConfig
from ..means import PriorMean, ZeroMean
from .base import as_2d, check_implemented, prepare_components


class MOSVGP(struct.PyTreeNode):
    kernel: Any  # [Q]-stacked
    likelihoods: Tuple  # length T, pytree leaves trainable
    mean: PriorMean  # [Q]-stacked
    Z: jnp.ndarray  # [Q, M, D]
    A: jnp.ndarray  # [R, Q] mixing matrix, unit-norm rows
    inference: InferenceConfig = struct.field(pytree_node=False)
    n_latent: int = struct.field(pytree_node=False)  # Q
    n_tasks: int = struct.field(pytree_node=False, default=1)
    rows_per_task: Tuple[int, ...] = struct.field(pytree_node=False, default=(1,))
    atfrequency: int = struct.field(pytree_node=False, default=1)
    optimiser: Optional[Any] = struct.field(pytree_node=False, default=None)
    Zoptimiser: Optional[Any] = struct.field(pytree_node=False, default=None)
    Aoptimiser: Optional[Any] = struct.field(pytree_node=False, default=None)

    is_sparse = True
    is_multioutput = True
    is_online = False

    @classmethod
    def create(
        cls,
        kernel,
        likelihoods,
        inference,
        Z,
        n_latent: int,
        mean=None,
        optimiser="default",
        Zoptimiser=None,
        Aoptimiser="default",
        atfrequency: int = 1,
        key=None,
    ):
        if not isinstance(inference, AnalyticVI):
            raise ValueError("multi-output models support AnalyticVI only")
        likelihoods = tuple(likelihoods)
        for lik in likelihoods:
            check_implemented(lik, inference)
        rows_per_task = tuple(l.n_latent for l in likelihoods)
        R = sum(rows_per_task)
        Q = n_latent
        mean = ZeroMean() if mean is None else mean
        kernel, mean = prepare_components(kernel, likelihoods[0], mean, Q)
        Z = as_2d(Z)
        if Z.ndim == 2:
            Z = jnp.broadcast_to(Z, (Q,) + Z.shape)
        key = jax.random.PRNGKey(0) if key is None else key
        A = jax.random.normal(key, (R, Q))
        A = A / jnp.linalg.norm(A, axis=1, keepdims=True)
        if optimiser == "default":
            optimiser = optax.adam(0.01)
        if Aoptimiser == "default":
            Aoptimiser = optax.adam(0.01)
        return cls(
            kernel=kernel,
            likelihoods=likelihoods,
            mean=mean,
            Z=Z,
            A=A,
            inference=inference,
            n_latent=Q,
            n_tasks=len(likelihoods),
            rows_per_task=rows_per_task,
            atfrequency=atfrequency,
            optimiser=optimiser,
            Zoptimiser=Zoptimiser,
            Aoptimiser=Aoptimiser,
        )

    @property
    def n_inducing(self):
        return self.Z.shape[1]

    def row_slices(self):
        out, start = [], 0
        for r in self.rows_per_task:
            out.append((start, start + r))
            start += r
        return out


def mo_mean_var_f(model, mu_q, var_q):
    """Mix latent moments into output rows: mu_r = sum_q A_rq mu_q,
    var_r = sum_q A_rq^2 var_q (single_and_multi_output_utils.jl:24-44)."""
    mu_f = jnp.einsum("rq,qb->rb", model.A, mu_q)
    var_f = jnp.einsum("rq,qb->rb", model.A**2, var_q)
    return mu_f, var_f


def mo_local_updates(model, ys, mu_f, var_f, local_list, w=None):
    """Per-task E-steps over the flattened row axis."""
    new_liks, new_locals = [], []
    for (lik, y_t, lv), (s, e) in zip(
        zip(model.likelihoods, ys, local_list), model.row_slices()
    ):
        lik2, lv2 = lik.local_updates(y_t, mu_f[s:e], var_f[s:e], lv, w=w)
        new_liks.append(lik2)
        new_locals.append(lv2)
    return tuple(new_liks), list(new_locals)


def mo_grad_rows(model, ys, local_list):
    """Stack per-row grad_e_mu / grad_e_sigma: [R, B] each."""
    gmu, gs = [], []
    for lik, y_t, lv in zip(model.likelihoods, ys, local_list):
        gmu.append(lik.grad_e_mu(y_t, lv))
        gs.append(lik.grad_e_sigma(y_t, lv))
    return jnp.concatenate(gmu, axis=0), jnp.concatenate(gs, axis=0)


def mo_grad_latents(model, gmu_r, gs_r, mu_q):
    """Mix row gradients back onto the Q latent GPs
    (single_and_multi_output_utils.jl:48-84):
      grad_mu_q  = sum_r A_rq (gmu_r - 2 gs_r * sum_{q'!=q} A_rq' mu_q')
      grad_sig_q = sum_r A_rq^2 gs_r
    """
    A = model.A  # [R, Q]
    mix = jnp.einsum("rq,qb->rb", A, mu_q)  # [R, B] total mixed mean
    # sum_{q'!=q} A_rq' mu_q' = mix_r - A_rq mu_q
    cross = mix[:, None, :] - A[:, :, None] * mu_q[None, :, :]  # [R, Q, B]
    g1 = jnp.einsum("rq,rqb->qb", A, gmu_r[:, None, :] - 2.0 * gs_r[:, None, :] * cross)
    g2 = jnp.einsum("rq,rb->qb", A**2, gs_r)
    return g1, g2


def mo_update_A(model, state, ys, mu_q, var_q, local_list, grads=None):
    """Gradient step on the mixing matrix + unit-norm row projection
    (single_and_multi_output_utils.jl:87-118).  `grads` passes precomputed
    (possibly pad-row-masked) (gmu_r, gs_r); the A gradient is linear in
    both, so masked rows drop out of the x1/x2 contractions too."""
    if model.Aoptimiser is None:
        return model, state
    gmu_r, gs_r = mo_grad_rows(model, ys, local_list) if grads is None else grads
    A = model.A
    mix = jnp.einsum("rq,qb->rb", A, mu_q)
    cross = mix[:, None, :] - A[:, :, None] * mu_q[None, :, :]  # [R, Q, B]
    x1 = jnp.einsum("rb,qb->rq", gmu_r, mu_q) - 2.0 * jnp.einsum(
        "rb,qb,rqb->rq", gs_r, mu_q, cross
    )
    x2 = jnp.einsum("rb,qb->rq", gs_r, mu_q**2 + var_q)
    gA = x1 - 2.0 * A * x2
    from ..utils.opt import ascent_update

    A_state, dA = ascent_update(model.Aoptimiser, state.A_state, A, gA)
    A = A + dA
    A = A / jnp.linalg.norm(A, axis=1, keepdims=True)
    return model.replace(A=A), state.replace(A_state=A_state)


def mo_variational_update(model, state, x, ys, w=None):
    """Multi-output CAVI step (reference: analyticVI.jl:88-111 multioutput
    branch): per-task E-steps, mixing of gradient expectations onto the Q
    shared latents, shared natural-gradient update, then the A step.

    `w` ([B] of 0/1, optional) zero-weights padded rows out of every
    cross-batch contraction (natural-gradient statistics AND the A
    gradient) -- see analytic_vi.variational_update."""
    from ..inference.analytic_vi import apply_natural_gradient, latent_moments

    mu_q, var_q, kappa = latent_moments(model, state, x, state.kmat)
    mu_f, var_f = mo_mean_var_f(model, mu_q, var_q)
    liks, local_list = mo_local_updates(model, ys, mu_f, var_f, state.local_vars, w=w)
    model = model.replace(likelihoods=liks)
    state = state.replace(local_vars=list(local_list))
    gmu_r, gs_r = mo_grad_rows(model, ys, local_list)
    if w is not None:
        gmu_r = gmu_r * w
        gs_r = gs_r * w
    g1, g2 = mo_grad_latents(model, gmu_r, gs_r, mu_q)
    state = apply_natural_gradient(model, state, kappa, g1, g2, x)
    model, state = mo_update_A(
        model, state, ys, mu_q, var_q, local_list, grads=(gmu_r, gs_r)
    )
    return model, state


def mo_elbo(model, state, x, ys, kmat=None):
    """ELBO for multi-output models (reference: analyticVI.jl:299-324)."""
    from ..inference.analytic_vi import latent_moments, prior_mean_stack
    from ..ops.kl import gaussian_kl

    kmat = state.kmat if kmat is None else kmat
    if kmat is not state.kmat:
        state = state.replace(kmat=kmat)
    mu_q, var_q, _ = latent_moments(model, state, x, kmat)
    mu_f, var_f = mo_mean_var_f(model, mu_q, var_q)
    rho = state.rho
    tot = 0.0
    for (lik, y_t, lv), (s, e) in zip(
        zip(model.likelihoods, ys, state.local_vars), model.row_slices()
    ):
        tot += rho * lik.expec_loglik(y_t, mu_f[s:e], var_f[s:e], lv)
        tot -= jax.lax.stop_gradient(rho * lik.aug_kl(lv, y_t))
    mu0 = prior_mean_stack(model, x)
    kl = jax.vmap(gaussian_kl)(state.mu, mu0, state.Sigma, state.kmat["L_K"])
    return tot - jnp.sum(kl)


@partial(jax.jit, static_argnames=("diag",))
def _mo_predict_f_core(model, state, X_test, diag=True):
    from ..training.predictions import _predict_f_var

    if diag:
        mu_q, var_q = _predict_f_var(model, state, as_2d(X_test), diag=True)
        return mo_mean_var_f(model, mu_q, var_q)
    mu_q, cov_q = _predict_f_var(
        model, state, as_2d(X_test), diag=False, full_cov=True
    )
    mu_f = jnp.einsum("rq,qb->rb", model.A, mu_q)
    cov_f = jnp.einsum("rq,qnp->rnp", model.A**2, cov_q)
    return mu_f, cov_f


def mo_predict_f(model, state, X_test, diag=True, chunk_size=None):
    """Task-space predictive moments: mix the latent predictive through A
    (reference: predictions.jl:52-92).

    diag=True: ([R, n] mu, [R, n] var).  diag=False: ([R, n, n] task
    covariances; under the LMC with independent latents
    cov_r = sum_q A_rq^2 cov_q).  `chunk_size` bounds device memory on huge
    test sets (diag only)."""
    from ..training.predictions import _chunk_map

    X_test = as_2d(jnp.asarray(X_test))
    call = lambda xc: _mo_predict_f_core(model, state, xc, diag=diag)
    if chunk_size is not None and X_test.shape[0] > chunk_size:
        if not diag:
            raise ValueError("chunk_size is incompatible with diag=False")
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


def mo_init_state(model, X, ys, key=None):
    """Initial TrainState for a multi-output model (labels must already be
    treated; reference: training/states.jl for the MO branch)."""
    from ..training.autotuning import init_hyper_state
    from ..training.state import TrainState, init_var_posterior
    from ..inference.analytic_vi import compute_kmat

    key = jax.random.PRNGKey(0) if key is None else key
    dtype = X.dtype
    N = X.shape[0]
    inf = model.inference
    batch = inf.batchsize if inf.stochastic else N
    post = init_var_posterior(model.n_latent, model.n_inducing, dtype)
    local_vars = [lik.init_local_vars(batch, dtype) for lik in model.likelihoods]
    opt_state = None
    if inf.stochastic and inf.optimiser is not None:
        opt_state = inf.optimiser.init((post["eta1"], post["eta2"]))
    A_state = model.Aoptimiser.init(model.A) if model.Aoptimiser is not None else None
    return TrainState(
        **post,
        local_vars=local_vars,
        opt_state=opt_state,
        hyper_state=init_hyper_state(model),
        kmat=compute_kmat(model, X),
        rho=jnp.asarray(N / batch if inf.stochastic else 1.0, dtype),
        step=jnp.zeros([], jnp.int32),
        key=key,
        A_state=A_state,
    )


def mo_train(
    model,
    Xs,
    ys,
    iterations=100,
    state=None,
    key=None,
    callback=None,
    verbose: int = 0,
    conv_eps: float = 0.0,
    conv_check_every: int = 10,
):
    """Training driver for multi-output models; all tasks share inputs X
    (reference MOVGP uses one X with multiple ys).

    Full `train()` feature set: hyperparameter autotuning every
    `atfrequency` iterations when `model.optimiser` is set (kernel + prior
    mean + Z via `hyper_step`; the mixing matrix A updates inside the
    variational step as in the reference, autotuning.jl:48-84 +
    single_and_multi_output_utils.jl:87-118), `callback(model, state, i)`,
    verbose ELBO printing, opt-in `conv_eps` convergence check, and a
    chunked `lax.scan` fast path when no per-iteration Python work is
    needed."""
    X = as_2d(Xs)
    from .base import match_dtype

    new_ys, liks = [], []
    for lik, y_t in zip(model.likelihoods, ys):
        y2, lik2 = lik.treat_labels(y_t)
        y2 = match_dtype(y2, X)
        new_ys.append(y2)
        liks.append(lik2)
    ys = tuple(new_ys)
    model = model.replace(likelihoods=tuple(liks))
    inf = model.inference
    if inf.stochastic and not (0 < inf.batchsize <= X.shape[0]):
        raise ValueError(f"batchsize {inf.batchsize} is not in (0, {X.shape[0]}]")

    if state is None:
        state = mo_init_state(model, X, ys, key)

    do_hyper = model.optimiser is not None
    fast_path = callback is None and verbose < 2 and not do_hyper and iterations > 1
    try:
        if fast_path:
            done = 0
            prev_elbo = None
            chunk = conv_check_every if conv_eps > 0 else 200
            while done < iterations:
                n = min(chunk, iterations - done)
                model, state = _mo_steps(model, state, X, ys, n)
                done += n
                if conv_eps > 0:
                    if inf.stochastic:
                        xb, ysb = _mo_draw_batch(model, state, X, ys, state.step)
                    else:
                        xb, ysb = X, ys
                    e = float(_mo_elbo_jit(model, state, xb, ysb))
                    if prev_elbo is not None and abs(e - prev_elbo) / n < conv_eps:
                        break
                    prev_elbo = e
        else:
            for i in range(1, iterations + 1):
                model, state = _mo_step(model, state, X, ys)
                if callback is not None:
                    callback(model, state, int(i))
                # reference: hyper-update every atfrequency iters, from
                # iter 3, never on the last (training/training.jl:66-70)
                if (
                    do_hyper
                    and i % model.atfrequency == 0
                    and i >= 3
                    and i != iterations
                ):
                    model, state = _mo_hyper_step(model, state, X, ys)
                if verbose >= 2:
                    if inf.stochastic:
                        xb, ysb = _mo_draw_batch(model, state, X, ys, state.step - 1)
                    else:
                        xb, ysb = X, ys
                    e = _mo_elbo_jit(model, state, xb, ysb)
                    print(f"iter {i}: ELBO = {float(e):.6f}")
    except KeyboardInterrupt:
        import warnings

        warnings.warn("training interrupted by user; returning current state")
    from ..inference.analytic_vi import compute_kmat

    state = state.replace(kmat=compute_kmat(model, X))
    return model, state


def _mo_draw_batch(model, state, X, ys, step):
    """Minibatch keyed on (state.key, step) so the hyper step can reproduce
    the exact batch of the preceding CAVI step (cf. training/train.py)."""
    sub = jax.random.fold_in(state.key, step)
    b = model.inference.batchsize
    idx = jax.random.randint(sub, (b,), 0, X.shape[0])
    return jnp.take(X, idx, axis=0), tuple(jnp.take(y, idx, axis=0) for y in ys)


def _mo_step_body(model, state, X, ys):
    if model.inference.stochastic:
        x_b, ys_b = _mo_draw_batch(model, state, X, ys, state.step)
    else:
        x_b, ys_b = X, ys
    model, state = mo_variational_update(model, state, x_b, ys_b)
    return model, state.replace(step=state.step + 1)


_mo_step = jax.jit(_mo_step_body)


from functools import partial as _partial


@_partial(jax.jit, static_argnums=(4,))
def _mo_steps(model, state, X, ys, n: int):
    def body(carry, _):
        m, s = carry
        m, s = _mo_step_body(m, s, X, ys)
        return (m, s), None

    (model, state), _ = jax.lax.scan(body, (model, state), None, length=n)
    return model, state


@jax.jit
def _mo_hyper_step(model, state, X, ys):
    from ..training import autotuning

    if model.inference.stochastic:
        x_b, ys_b = _mo_draw_batch(model, state, X, ys, state.step - 1)
    else:
        x_b, ys_b = X, ys
    return autotuning.hyper_step(model, state, x_b, ys_b)


@jax.jit
def _mo_elbo_jit(model, state, X, ys):
    return mo_elbo(model, state, X, ys)


class MOVGP(MOSVGP):
    """Full multi-output VGP: MOSVGP with Z fixed to the training inputs.

    The reference keeps a separate dense implementation (models/MOVGP.jl);
    sharing the sparse code path with Z = X reproduces it (kappa = I up to
    jitter) without a second branch.
    """

    @classmethod
    def create(cls, X, likelihoods, kernel, inference, n_latent, **kw):
        X = as_2d(X)
        return super().create(
            kernel, likelihoods, inference, X, n_latent, **kw
        )


@jax.jit
def _mo_proba_y_core(model, state, X_test):
    mu_r, var_r = _mo_predict_f_core(model, state, X_test)
    out = []
    for (lik, (s, e)) in zip(model.likelihoods, model.row_slices()):
        if lik.n_latent == 1:
            out.append(lik.compute_proba(mu_r[s], var_r[s]))
        else:
            out.append(lik.compute_proba(mu_r[s:e], var_r[s:e]))
    return tuple(out)


def mo_proba_y(model, state, X_test, chunk_size=None):
    """Per-task predictive distributions (reference: proba_multi_y,
    predictions.jl:231-253)."""
    from ..training.predictions import _chunk_map

    X_test = as_2d(jnp.asarray(X_test))
    call = lambda xc: _mo_proba_y_core(model, state, xc)
    if chunk_size is not None and X_test.shape[0] > chunk_size:
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


@jax.jit
def _mo_predict_y_core(model, state, X_test):
    mu_r, _ = _mo_predict_f_core(model, state, X_test)
    out = []
    for (lik, (s, e)) in zip(model.likelihoods, model.row_slices()):
        if lik.n_latent == 1:
            out.append(lik.predict_y(mu_r[s]))
        else:
            out.append(lik.predict_y(mu_r[s:e]))
    return tuple(out)


def mo_predict_y(model, state, X_test, chunk_size=None):
    """Per-task label predictions."""
    from ..training.predictions import _chunk_map

    X_test = as_2d(jnp.asarray(X_test))
    call = lambda xc: _mo_predict_y_core(model, state, xc)
    if chunk_size is not None and X_test.shape[0] > chunk_size:
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


def _mosvgp_repr(self):
    from .base import model_repr

    return model_repr(self)


MOSVGP.__repr__ = _mosvgp_repr
