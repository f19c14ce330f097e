"""OnlineSVGP: streaming sparse variational GP (Bui et al. '17 style).

Equivalent of /root/reference/src/models/OnlineSVGP.jl +
training/onlinetraining.jl.  The reference *resizes* the inducing set and
variational parameters as points stream in (onlinetraining.jl:155-197) --
impossible under XLA's static shapes.  Design: a fixed-capacity
inducing buffer Z [L, M_cap, D] with an active mask; inactive slots carry
identity prior/posterior blocks so every Cholesky/solve stays well-posed,
and all statistics are masked.  Growth = flipping mask bits inside the
jitted OIPS scan -- no reallocation, no recompilation.

Streaming update equations (reference analyticVI.jl:183-203,
onlinetraining.jl:164-180):
  save-old:  invDa  = -2 eta2 - K^-1         (Sigma_a^-1 - K_a^-1)
             prev_eta1 = eta1
             prev_L_a  = (-logdet Sigma + logdet K - mu . eta1)/2
  update:    eta1 = K^-1 mu0 + kappa^T gmu + kappa_a^T prev_eta1
             eta2 = -(kappa^T Diag(gs) kappa + kappa_a^T invDa kappa_a / 2
                      + K^-1/2)
  extraKL (KLdivergences.jl:37-54):
     prev_L_a - 1/2 tr(invDa (Ktilde_a + kappa_a Sigma kappa_a^T))
     + prev_eta1 . (kappa_a mu) - 1/2 (kappa_a mu)^T invDa (kappa_a mu)
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from ..utils import struct

from ..config import jitter
from ..inducing.algorithms import (
    OIPS,
    StreamKmeans,
    UniGridOnline,
    Webscale,
    inducingpoints,
    oips_update,
    streamkmeans_update,
    unigrid_update,
    webscale_update,
)
from ..inference.config import AnalyticVI, InferenceConfig
from ..kernels import batch_diag, batch_gram
from ..likelihoods.base import Likelihood
from ..means import PriorMean, ZeroMean, batch_call
from ..ops import linalg
from .base import as_2d, check_implemented, match_dtype, prepare_components


class OnlineSVGP(struct.PyTreeNode):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    Z: jnp.ndarray  # [L, Mc, D] slot buffer
    z_mask: jnp.ndarray  # [L, Mc] active flags
    Za: jnp.ndarray  # [L, Mc, D] previous inducing set
    za_mask: jnp.ndarray  # [L, Mc]
    z_counts: jnp.ndarray  # [L, Mc] per-center absorb counts (kmeans algs)
    inference: InferenceConfig = struct.field(pytree_node=False)
    n_latent: int = struct.field(pytree_node=False)
    capacity: int = struct.field(pytree_node=False, default=128)
    rho_accept: float = struct.field(pytree_node=False, default=0.8)
    atfrequency: int = struct.field(pytree_node=False, default=1)
    optimiser: Optional[Any] = struct.field(pytree_node=False, default=None)
    # the online selection algorithm (frozen dataclass -> hashable static
    # metadata); None falls back to OIPS(rho_accept, capacity)
    Zalg: Optional[Any] = struct.field(pytree_node=False, default=None)

    is_sparse = True
    is_multioutput = False
    is_online = True

    @classmethod
    def create(
        cls,
        kernel,
        likelihood,
        inference=None,
        Zalg: Optional[OIPS] = None,
        n_dim: int = 1,
        capacity: int = 128,
        mean=None,
        optimiser="default",
        atfrequency: int = 1,
    ):
        inference = AnalyticVI() if inference is None else inference
        if not isinstance(inference, AnalyticVI):
            raise ValueError("OnlineSVGP supports AnalyticVI only")
        check_implemented(likelihood, inference)
        Zalg = OIPS(capacity=capacity) if Zalg is None else Zalg
        # shape the static capacity to the algorithm (grid / fixed-k
        # algorithms know their active-set size up front)
        if isinstance(Zalg, UniGridOnline):
            capacity = max(capacity, Zalg.points_per_dim**n_dim)
        elif isinstance(Zalg, Webscale):
            capacity = max(capacity, Zalg.k)
        elif isinstance(Zalg, StreamKmeans):
            # buffer >= the algorithm cap; growth itself stays bounded by
            # Zalg.capacity (passed into streamkmeans_update)
            capacity = max(capacity, Zalg.capacity)
        L = likelihood.n_latent
        mean = ZeroMean() if mean is None else mean
        kernel, mean = prepare_components(kernel, likelihood, mean, L)
        Mc = capacity
        Z = jnp.zeros((L, Mc, n_dim))
        z_mask = jnp.zeros((L, Mc), dtype=bool)
        if optimiser == "default":
            optimiser = optax.adam(0.01)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            Z=Z,
            z_mask=z_mask,
            Za=Z,
            za_mask=z_mask,
            z_counts=jnp.zeros((L, Mc), Z.dtype),
            inference=inference,
            n_latent=L,
            capacity=Mc,
            rho_accept=getattr(Zalg, "rho", 0.8),
            atfrequency=atfrequency,
            optimiser=optimiser,
            Zalg=Zalg,
        )

    @property
    def n_inducing(self):
        return self.capacity


# ----------------------------------------------------------- masked kernels
def masked_kmat(model: OnlineSVGP):
    """Cholesky/inverse of the masked prior covariance: identity blocks on
    inactive slots keep the factorization well-posed."""

    def one(k, Z, m):
        K = k.gram(Z, Z)
        mm = jnp.outer(m, m)
        K = jnp.where(mm, K, 0.0) + jnp.diag(jnp.where(m, 0.0, 1.0))
        # adaptive jitter ladder like compute_kmat (the base jitter is the
        # first rung; escalates on f32 factorization failure)
        L_K = linalg.safe_cholesky(K, jitter(K.dtype))
        K_inv = linalg.chol_inv(L_K)
        return L_K, K_inv

    # HIGHEST: K_inv feeds the invDa = Sigma^-1 - K^-1 cancellation chain
    # (see masked_kappa_a); [Mc, Mc]-sized, off the per-datapoint hot path
    with jax.default_matmul_precision("highest"):
        L_K, K_inv = jax.vmap(one)(model.kernel, model.Z, model.z_mask)
    return {"L_K": L_K, "K_inv": K_inv}


def masked_kappa(model: OnlineSVGP, x, kmat):
    Knm = batch_gram(model.kernel, x, model.Z)  # [L, B, Mc]
    Knm = Knm * model.z_mask[:, None, :]
    kappa = jnp.einsum("lbm,lmn->lbn", Knm, kmat["K_inv"])
    kdiag = batch_diag(model.kernel, x)
    Ktilde = kdiag + jitter(Knm.dtype) - linalg.diag_ABt(kappa, Knm)
    return Knm, kappa, jnp.maximum(Ktilde, 1e-12)


def masked_kappa_a(model: OnlineSVGP, kmat):
    """kappa_a = K(Za, Z) K^-1 and Ktilde_a = K_a - kappa_a Kab^T, masked.

    Runs at HIGHEST matmul precision: the streaming-correction chain
    (kappa_a, then kappa_a^T invDa kappa_a, then invDa = Sigma^-1 - K^-1 at
    the next save-old) subtracts near-equal matrices, and a reduced-precision
    f32 matmul (TF32 or one bf16 pass, ~1e-3 relative) compounds across
    batches until -2 eta2 loses positive-definiteness.  HIGHEST here (the
    [Mc, Mc]-sized ops only, not the [B, Mc] data-batch work) keeps
    CPU-grade accuracy."""
    with jax.default_matmul_precision("highest"):
        Kab = jax.vmap(lambda k, Za, Z: k.gram(Za, Z))(model.kernel, model.Za, model.Z)
        mm = model.za_mask[:, :, None] * model.z_mask[:, None, :]
        Kab = jnp.where(mm, Kab, 0.0)
        kappa_a = jnp.einsum("lam,lmn->lan", Kab, kmat["K_inv"])
        Ka = jax.vmap(lambda k, Za: k.gram(Za, Za))(model.kernel, model.Za)
        mma = model.za_mask[:, :, None] * model.za_mask[:, None, :]
        Ka = jnp.where(mma, Ka, 0.0) + jax.vmap(jnp.diag)(
            jnp.where(model.za_mask, jitter(Ka.dtype), 0.0)
        )
        Ktilde_a = Ka - jnp.einsum("lan,lbn->lab", kappa_a, Kab)
    return kappa_a, Ktilde_a


def masked_mu0(model: OnlineSVGP):
    mu0 = batch_call(model.mean, model.Z, model.n_latent)
    return mu0 * model.z_mask


# ------------------------------------------------------------ streaming ops
def save_old_parameters(model: OnlineSVGP, state):
    """Zₐ <- Z, invDa = -2 eta2 - K^-1, prev_eta1, prev_L_a
    (reference: onlinetraining.jl:164-180).  With the identity convention on
    inactive slots, invDa is exactly zero there."""
    kmat = state.kmat
    invDa = -2.0 * state.eta2 - kmat["K_inv"]
    invDa = linalg.symmetrize(invDa)
    prev_eta1 = state.eta1

    def logdets(Sigma_l, L_l):
        L_S = linalg.psd_safe_cholesky(linalg.symmetrize(Sigma_l))
        return -linalg.chol_logdet(L_S) + linalg.chol_logdet(L_l)

    ld = jax.vmap(logdets)(state.Sigma, kmat["L_K"])
    prev_L_a = (ld - jnp.sum(state.mu * state.eta1, axis=-1)) / 2.0
    model = model.replace(Za=model.Z, za_mask=model.z_mask)
    state = state.replace(
        previous={"invDa": invDa, "prev_eta1": prev_eta1, "prev_L_a": prev_L_a}
    )
    return model, state


def update_Z(model: OnlineSVGP, x):
    """Per-batch inducing-set update, dispatched on the (static) online
    algorithm (reference: onlinetraining.jl updateZs! over the
    InducingPoints.jl OnIPSA algorithms).  OIPS/StreamKmeans grow the masked
    buffer; UniGrid/Webscale move a fixed active set (the streaming
    correction projects the old posterior through kappa_a either way)."""
    alg = model.Zalg
    if isinstance(alg, UniGridOnline):
        Z, z_mask = jax.vmap(
            lambda Z, m: unigrid_update(Z, m, x, alg.points_per_dim)
        )(model.Z, model.z_mask)
        return model.replace(Z=Z, z_mask=z_mask)
    if isinstance(alg, Webscale):
        Z, z_mask, counts = jax.vmap(
            lambda Z, m, c: webscale_update(Z, m, c, x, alg.k)
        )(model.Z, model.z_mask, model.z_counts)
        return model.replace(Z=Z, z_mask=z_mask, z_counts=counts)
    if isinstance(alg, StreamKmeans):
        Z, z_mask, counts = jax.vmap(
            lambda Z, m, c: streamkmeans_update(Z, m, c, x, alg.radius2, alg.capacity)
        )(model.Z, model.z_mask, model.z_counts)
        return model.replace(Z=Z, z_mask=z_mask, z_counts=counts)

    def one(k, Z, m):
        return oips_update(k, Z, m, x, model.rho_accept)

    Z, z_mask = jax.vmap(one)(model.kernel, model.Z, model.z_mask)
    return model.replace(Z=Z, z_mask=z_mask)


def online_variational_update(model: OnlineSVGP, state, x, y):
    """Streaming natural-gradient update with previous-model correction.

    The whole update runs at HIGHEST matmul precision: the streaming
    correction chain subtracts near-equal matrices (invDa = Sigma^-1 -
    K^-1; eta2 = -(stats + corr + K^-1/2)) and a reduced-precision f32
    matmul (TF32 or one bf16 pass, ~1e-3 relative) compounds the error
    across batches.  Streaming batches are small ([B, Mc]-sized work), so
    the full-f32 cost is noise next to the per-batch dispatch; the big-B
    SVGP path keeps the default."""
    with jax.default_matmul_precision("highest"):
        return _online_variational_update_hp(model, state, x, y)


def _online_variational_update_hp(model: OnlineSVGP, state, x, y):
    kmat = state.kmat
    _, kappa, Ktilde = masked_kappa(model, x, kmat)
    mu_f = jnp.einsum("lbm,lm->lb", kappa, state.mu)
    kS = jnp.einsum("lbm,lmn->lbn", kappa, state.Sigma)
    var_f = Ktilde + linalg.diag_ABt(kS, kappa)

    lik, local = model.likelihood.local_updates(y, mu_f, var_f, state.local_vars)
    model = model.replace(likelihood=lik)
    gmu = lik.grad_e_mu(y, local)
    gs = lik.grad_e_sigma(y, local)

    K_inv = kmat["K_inv"]
    mu0 = masked_mu0(model)
    Kinv_mu0 = jnp.einsum("lmn,ln->lm", K_inv, mu0)
    kappa_a, _ = masked_kappa_a(model, kmat)
    prev = state.previous

    eta1 = (
        Kinv_mu0
        + jnp.einsum("lbm,lb->lm", kappa, gmu)
        + jnp.einsum("lam,la->lm", kappa_a, prev["prev_eta1"])
    )
    stat2 = jnp.einsum("lbm,lb,lbn->lmn", kappa, gs, kappa)
    # HIGHEST: corr2 must stay PSD against the invDa cancellation (see
    # masked_kappa_a); stat2 indefiniteness at default precision is
    # absorbed by the K^-1/2 term and the safe conversion below
    corr2 = (
        jnp.einsum(
            "lam,lab,lbn->lmn",
            kappa_a,
            prev["invDa"],
            kappa_a,
            precision=jax.lax.Precision.HIGHEST,
        )
        / 2.0
    )
    eta2 = -(stat2 + corr2 + 0.5 * K_inv)
    eta2 = linalg.symmetrize(eta2)
    # keep inactive slots at their init convention so nat_to_moments is
    # well-posed: eta2 diag -1/2, eta1 0
    inact = ~model.z_mask
    eta1 = jnp.where(inact, 0.0, eta1)
    eta2 = jnp.where(
        inact[:, :, None] | inact[:, None, :],
        jnp.broadcast_to(-0.5 * jnp.eye(model.capacity, dtype=eta2.dtype), eta2.shape),
        eta2,
    )
    from ..inference.analytic_vi import _fast_moments_enabled

    # safe=True / nat_to_moments_safe: the -2 eta2 here includes the
    # kappa_a^T invDa kappa_a streaming correction, which f32 matmul
    # rounding can push slightly indefinite right after a Z update; the
    # zero-first jitter ladder recovers instead of NaN-ing the chain
    # (exact whenever the plain factorization succeeds).
    if _fast_moments_enabled(eta1.shape[-1]):
        # warm-started Newton-Schulz (see ops/linalg.py); after a Z update
        # the natural params jump and the residual guard falls back to the
        # exact Cholesky path automatically.
        mu, Sigma = linalg.nat_to_moments_warm_batched(
            eta1, eta2, state.Sigma, safe=True
        )
    else:
        mu, Sigma = jax.vmap(linalg.nat_to_moments_safe)(eta1, eta2)
    return model, state.replace(
        eta1=eta1, eta2=eta2, mu=mu, Sigma=Sigma, local_vars=local
    )


def online_extra_kl(model: OnlineSVGP, state, kmat=None):
    """KL between the time-t and time-t+1 posteriors
    (reference: functions/KLdivergences.jl:37-54)."""
    prev = state.previous
    kmat = state.kmat if kmat is None else kmat
    kappa_a, Ktilde_a = masked_kappa_a(model, kmat)
    ka_mu = jnp.einsum("lam,lm->la", kappa_a, state.mu)
    kSk = jnp.einsum("lam,lmn,lbn->lab", kappa_a, state.Sigma, kappa_a)
    kl = prev["prev_L_a"]
    kl = kl - 0.5 * (
        jnp.einsum("lab,lab->l", prev["invDa"], Ktilde_a)
        + jnp.einsum("lab,lab->l", prev["invDa"], kSk)
    )
    kl = kl + jnp.einsum("la,la->l", prev["prev_eta1"], ka_mu)
    kl = kl - 0.5 * jnp.einsum("la,lab,lb->l", ka_mu, prev["invDa"], ka_mu)
    return jnp.sum(kl)


# -------------------------------------------------------------- driver
def online_train(model: OnlineSVGP, X, y, state=None, iterations: int = 20, key=None):
    """Train on one streaming batch; thread (model, state) across batches
    (reference: onlinetraining.jl:36-145).  First batch initializes Z."""
    from ..training.autotuning import init_hyper_state
    from ..training.state import TrainState, init_var_posterior

    X = as_2d(X)
    y, lik = model.likelihood.treat_labels(y)
    from .base import match_dtype

    y = match_dtype(y, X)
    model = model.replace(likelihood=lik)
    key = jax.random.PRNGKey(0) if key is None else key
    dtype = X.dtype
    B = X.shape[0]

    first = state is None
    if first:
        # initialize inducing set from the first batch (host-side pass of
        # the model's selection algorithm; reference onlinetraining.jl:59-61)
        alg = (
            model.Zalg
            if model.Zalg is not None
            else OIPS(rho=model.rho_accept, capacity=model.capacity)
        )
        Z0 = inducingpoints(
            alg, X, kernel=jax.tree_util.tree_map(lambda l: l[0], model.kernel)
        )
        k0 = min(Z0.shape[0], model.capacity)
        Z0 = Z0[:k0]
        Z = model.Z.at[:, :k0, :].set(jnp.broadcast_to(Z0, (model.n_latent,) + Z0.shape).astype(dtype))
        z_mask = model.z_mask.at[:, :k0].set(True)
        counts = model.z_counts.at[:, :k0].set(1.0)
        model = model.replace(Z=Z, z_mask=z_mask, z_counts=counts)
        post = init_var_posterior(model.n_latent, model.capacity, dtype)
        Mc = model.capacity
        state = TrainState(
            **post,
            local_vars=model.likelihood.init_local_vars(B, dtype),
            opt_state=None,
            hyper_state=init_hyper_state(model),
            kmat=masked_kmat(model),
            rho=jnp.asarray(1.0, dtype),
            step=jnp.zeros([], jnp.int32),
            key=key,
            previous={
                "invDa": jnp.zeros((model.n_latent, Mc, Mc), dtype),
                "prev_eta1": jnp.zeros((model.n_latent, Mc), dtype),
                "prev_L_a": jnp.zeros((model.n_latent,), dtype),
            },
        )
    do_hyper = model.optimiser is not None
    if not do_hyper:
        # fuse the WHOLE streaming batch -- save-old, inducing-set update,
        # kernel-matrix refresh, local-var re-init and all CAVI iterations
        # -- into one jitted program: ONE host dispatch per batch (dispatch
        # latency otherwise dominates the small per-batch device work)
        if first:
            model, state = _online_steps(model, state, X, y, iterations)
        else:
            model, state = _online_batch(model, state, X, y, iterations)
        return model, state

    if not first:
        # one fused prologue dispatch (save-old -> update_Z -> kernel
        # matrices -> fresh local vars); the module-level jits below are
        # created ONCE -- a fresh jax.jit(...) wrapper per driver call would
        # retrace every batch
        model, state = _online_prologue(model, state, X)
    for i in range(1, iterations + 1):
        model, state = _online_step_jit(model, state, X, y)
        if i % model.atfrequency == 0 and i >= 3 and i != iterations:
            model, state = _online_hyper_jit(model, state, X, y)
    state = state.replace(kmat=_masked_kmat_jit(model))
    return model, state


def _online_step(model, state, X, y):
    model, state = online_variational_update(model, state, X, y)
    return model, state.replace(step=state.step + 1)


from functools import partial as _partial


@_partial(jax.jit, static_argnums=(4,))
def _online_steps(model, state, X, y, n: int):
    def body(carry, _):
        m, s = carry
        return _online_step(m, s, X, y), None

    (model, state), _ = jax.lax.scan(body, (model, state), None, length=n)
    return model, state


@jax.jit
def _online_prologue(model, state, X):
    """Between-batch bookkeeping as one program: save-old -> update_Z ->
    masked kernel matrices -> fresh local vars."""
    model, state = save_old_parameters(model, state)
    model = update_Z(model, X)
    return model, state.replace(
        kmat=masked_kmat(model),
        local_vars=model.likelihood.init_local_vars(X.shape[0], X.dtype),
    )


def _online_hyper_step(model, state, X, y):
    from ..training.autotuning import hyper_step

    return hyper_step(model, state, X, y)


_online_step_jit = jax.jit(_online_step)
_online_hyper_jit = jax.jit(_online_hyper_step)
_masked_kmat_jit = jax.jit(masked_kmat)


def _online_batch_body(model, state, X, y, n: int):
    """One fused streaming batch (non-first, no hyperopt): save-old ->
    update_Z -> masked kernel matrices -> fresh local vars -> n CAVI
    iterations, all in one program."""
    model, state = save_old_parameters(model, state)
    model = update_Z(model, X)
    state = state.replace(
        kmat=masked_kmat(model),
        local_vars=model.likelihood.init_local_vars(X.shape[0], X.dtype),
    )

    def body(carry, _):
        m, s = carry
        return _online_step(m, s, X, y), None

    (model, state), _ = jax.lax.scan(body, (model, state), None, length=n)
    return model, state


_online_batch = _partial(jax.jit, static_argnums=(4,))(_online_batch_body)


@_partial(jax.jit, static_argnums=(4,))
def _online_stream_scan(model, state, X_stream, y_stream, n: int):
    """lax.scan over pre-buffered streaming batches: the whole stream is ONE
    device program, so per-batch host dispatch (which dominates wall-clock
    for small batches) is paid once per stream chunk instead of once per
    batch.  Possible only because the online state is
    fixed-capacity masked (static shapes across batches)."""

    def batch_body(carry, xy):
        m, s = carry
        Xb, yb = xy
        return _online_batch_body(m, s, Xb, yb, n), None

    (model, state), _ = jax.lax.scan(batch_body, (model, state), (X_stream, y_stream))
    return model, state


def online_train_stream(
    model: OnlineSVGP, X_stream, y_stream, state=None, iterations: int = 20, key=None
):
    """Train on a PRE-BUFFERED stream of equally-sized batches in one (or
    two) device dispatches: X_stream [n_batches, B, D], y_stream
    [n_batches, B].

    Semantically identical to calling `online_train` per batch (the
    per-batch path is the reference's streaming protocol,
    onlinetraining.jl:36-145) -- this driver exists because a lax.scan over
    batches amortizes host->device dispatch across the stream, which is the
    dominant cost of small streaming batches.  Requires
    optimiser=None (interleaved hyperopt needs the per-batch driver).  The
    first batch still runs separately when `state` is None: inducing-point
    init is a host-side pass."""
    if model.optimiser is not None:
        raise ValueError(
            "online_train_stream requires optimiser=None; interleaved "
            "hyperopt streams with per-batch online_train calls"
        )
    X_stream = jnp.asarray(X_stream)
    if X_stream.ndim == 2:
        X_stream = X_stream[:, :, None]
    y_in = jnp.asarray(y_stream)
    y_flat, lik = model.likelihood.treat_labels(jnp.ravel(y_in))
    model = model.replace(likelihood=lik)
    # treat_labels may append trailing label dims (multiclass one-hot
    # [N] -> [N, K]); restore the (n_batches, B) leading layout around them
    y_stream = match_dtype(
        jnp.reshape(y_flat, y_in.shape[:2] + y_flat.shape[1:]), X_stream
    )
    if state is None:
        model, state = online_train(
            model, X_stream[0], y_stream[0], iterations=iterations, key=key
        )
        X_stream, y_stream = X_stream[1:], y_stream[1:]
    if X_stream.shape[0] == 0:
        return model, state
    return _online_stream_scan(model, state, X_stream, y_stream, iterations)


def online_elbo(model: OnlineSVGP, state, x, y):
    """ELBO with the streaming extraKL term."""
    from ..inference.analytic_vi import elbo

    return elbo(model, state, x, y)


def _onlinesvgp_repr(self):
    from .base import model_repr

    return model_repr(self)


OnlineSVGP.__repr__ = _onlinesvgp_repr
