"""Training drivers.

Equivalent of /root/reference/src/training/training.jl, re-structured for
XLA: the per-iteration work (minibatch gather, kernel matrices, local
updates, natural-gradient update) is ONE jitted program; the Python loop
only counts iterations and runs user callbacks.  Minibatch indices are
drawn on-device (threaded PRNG key in the state) so steady-state training
does zero host->device transfers -- the reference samples indices host-side
(training/training.jl:51-55), which would serialize the device pipeline.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..inference import analytic_vi
from ..models.gp import GP, analytic_update
from ..training import autotuning
from ..training.state import TrainState, init_var_posterior
from .state import TrainState


def init_state(model, X=None, y=None, key=None) -> TrainState:
    """Build the initial TrainState pytree
    (reference: training/states.jl:1-9)."""
    key = jax.random.PRNGKey(0) if key is None else key
    if isinstance(model, GP):
        return model.init_state(key)

    X = model.train_x if X is None else X
    dtype = X.dtype
    N = X.shape[0]
    inf = model.inference
    batch = inf.batchsize if inf.stochastic else N
    M = model.n_inducing if model.is_sparse else N
    L = model.n_latent

    post = init_var_posterior(L, M, dtype)
    numerical = inf.name in ("QuadratureVI", "MCIntegrationVI")
    if numerical:
        local_vars = {}
        opt_state = inf.optimiser.init((post["mu"], post["Sigma"]))
    else:
        local_vars = model.likelihood.init_local_vars(batch, dtype)
        opt_state = None
        if getattr(inf, "stochastic", False) and getattr(inf, "optimiser", None) is not None:
            opt_state = inf.optimiser.init((post["eta1"], post["eta2"]))
    hyper_state = autotuning.init_hyper_state(model)
    kmat = analytic_vi.compute_kmat(model, X)
    rho = jnp.asarray(N / batch if inf.stochastic else 1.0, dtype)
    prior_state = None
    if getattr(model, "is_tprior", False):
        prior_state = {
            "l2": jnp.ones((L,), dtype),
            "chi": jnp.ones((L,), dtype),
        }
    return TrainState(
        **post,
        prior_state=prior_state,
        local_vars=local_vars,
        opt_state=opt_state,
        hyper_state=hyper_state,
        kmat=kmat,
        rho=rho,
        step=jnp.zeros([], jnp.int32),
        key=key,
    )


def block_tile(mode: str, b: int | None = None):
    """Tile height for "block"/"block:<n>" minibatch sampling.  Bare
    "block" defaults to 64, halved until it divides the batchsize `b` when
    given so the default never silently falls back to the iid gather on
    small batches.
    Returns None for a malformed or non-positive suffix ("block:x",
    "block:0") so callers fall back to the iid gather -- the same graceful
    fallback every other malformed/inapplicable mode gets -- instead of
    raising at trace time."""
    if ":" not in mode:
        tile = 64
        if b is not None:
            while tile > 1 and b % tile:
                tile //= 2
        return tile
    try:
        tile = int(mode.split(":", 1)[1])
    except ValueError:
        return None
    return tile if tile >= 1 else None


def _tile_views(X, y, tile):
    """[T, tile, D]/[T, tile] aligned-tile views for block sampling.

    Built OUTSIDE any lax.scan over steps: the reshape of a [N, D]
    argument to [T, tile, D] can be a real relayout in the device's memory
    layout, and XLA does not hoist a loop-invariant relayout out of a scan
    body.  Hoisted, it runs once per dispatch and 2000-step scans amortize
    it to noise."""
    n_tiles = X.shape[0] // tile
    return (
        X[: n_tiles * tile].reshape(n_tiles, tile, X.shape[1]),
        # y keeps its trailing dims (multiclass one-hot [N, K],
        # heteroscedastic [N] -- any per-row label layout)
        y[: n_tiles * tile].reshape((n_tiles, tile) + y.shape[1:]),
    )


def _block_mode_tile(model, b, n_rows):
    """Static tile height when block sampling applies, else None."""
    mode = getattr(model.inference, "minibatch_sampling", "gather")
    if not mode.startswith("block"):
        return None
    tile = block_tile(mode, b)
    if tile is not None and b % tile == 0 and n_rows >= tile:
        return tile
    return None


def _draw_batch(model, state, X, y, step, tiled=None):
    """Minibatch for iteration `step`: key folded with the counter, so the
    hyperparameter step can reproduce the exact batch whose local variables
    are in the state (the reference reuses the iteration's minibatch for
    its hyper update, training/training.jl:60-70).  Indices are drawn as
    int32 whether or not x64 is enabled, so a float64 run draws the same
    minibatches as a float32 run."""
    sub = jax.random.fold_in(state.key, step)
    b = model.inference.batchsize
    mode = getattr(model.inference, "minibatch_sampling", "gather")
    if mode == "slice":
        start = jax.random.randint(sub, (), 0, X.shape[0] - b + 1, jnp.int32)
        x_b = jax.lax.dynamic_slice_in_dim(X, start, b, axis=0)
        y_b = jax.lax.dynamic_slice_in_dim(y, start, b, axis=0)
        return x_b, y_b
    tile = _block_mode_tile(model, b, X.shape[0])
    if tile is not None:
        # gather of b/tile random ALIGNED tile-row blocks: the same bytes
        # as the iid gather in tile-times fewer, tile-times larger memory
        # transactions.  Statistically a block bootstrap: with pre-shuffled
        # rows the tiles are iid draws of `tile` exchangeable rows; B/tile
        # independent blocks per batch (64 at the default) keeps the
        # gradient-estimator variance near the iid gather's.  "block" ->
        # tile=64 (halved to divide b); "block:<n>" picks the height.
        Xt, yt = _tile_views(X, y, tile) if tiled is None else tiled
        tidx = jax.random.randint(sub, (b // tile,), 0, Xt.shape[0], jnp.int32)
        x_b = jnp.take(Xt, tidx, axis=0).reshape(b, X.shape[1])
        y_b = jnp.take(yt, tidx, axis=0).reshape((b,) + y.shape[1:])
        return x_b, y_b
    idx = jax.random.randint(sub, (b,), 0, X.shape[0], jnp.int32)
    return jnp.take(X, idx, axis=0), jnp.take(y, idx, axis=0)


def _vi_update(model, state: TrainState, x_b, y_b):
    """Inference dispatch on an already-drawn batch."""
    if model.inference.name in ("QuadratureVI", "MCIntegrationVI"):
        from ..inference import numerical_vi

        return numerical_vi.variational_update(model, state, x_b, y_b)
    return analytic_vi.variational_update(model, state, x_b, y_b)


def _vi_step_body(model, state: TrainState, X, y, tiled=None):
    """One CAVI iteration, including the on-device minibatch draw."""
    if model.inference.stochastic:
        x_b, y_b = _draw_batch(model, state, X, y, state.step, tiled=tiled)
    else:
        x_b, y_b = X, y
    model, state = _vi_update(model, state, x_b, y_b)
    return model, state.replace(step=state.step + 1)


_vi_step = jax.jit(_vi_step_body)


def _precomputed_draws(model, state, X, n: int):
    """All n minibatch draws of a scan chunk, computed in ONE vectorized
    RNG pass before the scan.

    The per-step body RNG (fold_in + randint) is a SERIAL dependency chain
    of small threefry ops inside every step.  vmapping the same
    fold_in(key, step)+randint over the chunk's step indices produces
    BIT-IDENTICAL indices (same ops, same counters) as one large parallel
    RNG op amortized to noise, and the scan then consumes its row per step
    as a scanned input.  Returns (mode,
    index array [n, ...]) or (None, None) when the draw is not
    precomputable (non-stochastic)."""
    if not model.inference.stochastic:
        return None, None
    b = model.inference.batchsize
    mode = getattr(model.inference, "minibatch_sampling", "gather")
    steps_i = state.step + jnp.arange(n, dtype=state.step.dtype)
    subs = jax.vmap(lambda i: jax.random.fold_in(state.key, i))(steps_i)
    if mode == "slice":
        starts = jax.vmap(
            lambda k: jax.random.randint(k, (), 0, X.shape[0] - b + 1, jnp.int32)
        )(subs)
        return "slice", starts
    tile = _block_mode_tile(model, b, X.shape[0])
    if tile is not None:
        T = X.shape[0] // tile
        tidx = jax.vmap(
            lambda k: jax.random.randint(k, (b // tile,), 0, T, jnp.int32)
        )(subs)
        return "block", tidx
    idx = jax.vmap(
        lambda k: jax.random.randint(k, (b,), 0, X.shape[0], jnp.int32)
    )(subs)
    return "gather", idx


def _draw_from_idx(model, X, y, tiled, mode, idx):
    """Materialize one precomputed draw (see _precomputed_draws)."""
    b = model.inference.batchsize
    if mode == "slice":
        return (
            jax.lax.dynamic_slice_in_dim(X, idx, b, axis=0),
            jax.lax.dynamic_slice_in_dim(y, idx, b, axis=0),
        )
    if mode == "block":
        Xt, yt = tiled
        return (
            jnp.take(Xt, idx, axis=0).reshape(b, X.shape[1]),
            jnp.take(yt, idx, axis=0).reshape((b,) + y.shape[1:]),
        )
    return jnp.take(X, idx, axis=0), jnp.take(y, idx, axis=0)


@partial(jax.jit, static_argnums=(4,))
def _vi_steps(model, state: TrainState, X, y, n: int):
    """n CAVI iterations fused into one on-device lax.scan -- removes the
    per-step host dispatch that dominates wall-clock for small M (the
    reference's Julia loop pays this cost every iteration).  The minibatch
    RNG is hoisted out of the scan (_precomputed_draws), as are the
    block-mode tile views (_tile_views)."""
    tiled = None
    if model.inference.stochastic:
        tile = _block_mode_tile(model, model.inference.batchsize, X.shape[0])
        if tile is not None:
            # block-mode tile views hoisted OUT of the scan (see _tile_views:
            # the in-body relayout would otherwise run every step)
            tiled = _tile_views(X, y, tile)
    mode, idx_all = _precomputed_draws(model, state, X, n)

    def body(carry, idx):
        m, s = carry
        if mode is None:
            m, s = _vi_step_body(m, s, X, y, tiled=tiled)
        else:
            x_b, y_b = _draw_from_idx(m, X, y, tiled, mode, idx)
            m, s = _vi_update(m, s, x_b, y_b)
            s = s.replace(step=s.step + 1)
        return (m, s), None

    (model, state), _ = jax.lax.scan(body, (model, state), idx_all, length=n)
    return model, state


@jax.jit
def _hyper_step(model, state: TrainState, X, y):
    if model.inference.stochastic:
        # same batch as the preceding CAVI step (state.step was already
        # incremented, so fold with step - 1)
        x_b, y_b = _draw_batch(model, state, X, y, state.step - 1)
    else:
        x_b, y_b = X, y
    return autotuning.hyper_step(model, state, x_b, y_b)


@jax.jit
def _elbo_full(model, state, X, y):
    from ..inference.objective import objective

    return objective(model, state, X, y)


def train(
    model,
    X=None,
    y=None,
    iterations: int = 100,
    state: Optional[TrainState] = None,
    key=None,
    callback: Optional[Callable] = None,
    verbose: int = 0,
    conv_eps: float = 0.0,
    conv_check_every: int = 10,
):
    """Train a model for `iterations` CAVI steps
    (reference: training/training.jl:13-111).

    Returns (model, state): models are immutable, so hyperparameter and
    likelihood-parameter updates produce a new model pytree.

    `conv_eps > 0` enables an actual convergence check (|delta ELBO| per
    iteration < eps over `conv_check_every`-step windows).  The reference
    carries an epsilon on every inference object but never evaluates it
    (training/training.jl:93-94); here it works, opt-in because the check
    costs one ELBO evaluation per window.
    """
    if isinstance(model, GP):
        return _train_gp(model, iterations, state, key, callback, verbose)
    if getattr(model, "is_multioutput", False):
        raise TypeError(
            "multi-output models train with agp_tpu.mo_train(model, X, ys, ...)"
        )
    if getattr(model, "is_online", False):
        raise TypeError(
            "OnlineSVGP trains with agp_tpu.online_train(model, X_batch, "
            "y_batch, state=state) -- thread the state across batches"
        )

    # resolve data: VGP carries it; SVGP receives it here
    if X is None:
        X, y = model.train_x, model.train_y
        if X is None:
            raise ValueError("this model needs X, y passed to train()")
    else:
        from ..models.base import as_2d

        X = as_2d(X)
        y, lik = model.likelihood.treat_labels(y)
        from ..models.base import match_dtype

        y = match_dtype(y, X)
        model = model.replace(likelihood=lik)
        if hasattr(model, "train_x"):
            model = model.replace(train_x=X, train_y=y)

    inf = model.inference
    if inf.stochastic:
        if not (0 < inf.batchsize <= X.shape[0]):
            raise ValueError(
                f"batchsize {inf.batchsize} is not in (0, {X.shape[0]}]"
            )

    if state is None:
        state = init_state(model, X, y, key)

    do_hyper = model.optimiser is not None
    fast_path = callback is None and verbose < 2 and not do_hyper and iterations > 1
    # Ctrl-C preserves the partially-trained (model, state), mirroring the
    # reference's InterruptException handling (training/training.jl:95-102)
    try:
        if fast_path:
            # fuse the whole run into on-device scans, chunked so that a
            # single dispatch never grows unboundedly long while the
            # per-call host round-trip stays amortized
            done = 0
            prev_elbo = None
            chunk = conv_check_every if conv_eps > 0 else 2000
            while done < iterations:
                n = min(chunk, iterations - done)
                model, state = _vi_steps(model, state, X, y, n)
                done += n
                if conv_eps > 0:
                    if inf.stochastic:
                        # fresh random batch each check: a fixed subset can
                        # stall or trigger convergence early
                        xb, yb = _draw_batch(model, state, X, y, state.step)
                    else:
                        xb, yb = X, y
                    e = float(_elbo_full(model, state, xb, yb))
                    if prev_elbo is not None and abs(e - prev_elbo) / n < conv_eps:
                        break
                    prev_elbo = e
        else:
            for i in range(1, iterations + 1):
                model, state = _vi_step(model, state, X, y)
                if callback is not None:
                    callback(model, state, int(i))
                # reference: hyper-update every `atfrequency` iters, from
                # iter 3, never on the last (training/training.jl:66-70)
                if (
                    do_hyper
                    and i % model.atfrequency == 0
                    and i >= 3
                    and i != iterations
                ):
                    model, state = _hyper_step(model, state, X, y)
                if verbose >= 2:
                    if inf.stochastic:
                        # fresh random batch: a fixed prefix is a biased,
                        # constant trace slice (same convention as the
                        # conv_eps check above)
                        xb, yb = _draw_batch(model, state, X, y, state.step)
                        e = _elbo_full(model, state, xb, yb)
                    else:
                        e = _elbo_full(model, state, X, y)
                    print(f"iter {i}: ELBO = {float(e):.6f}")
    except KeyboardInterrupt:
        import warnings

        warnings.warn("training interrupted by user; returning current state")
    # refresh kernel matrices for prediction (training/training.jl:107-109)
    state = state.replace(kmat=analytic_vi.compute_kmat(model, X))
    return model, state


def _train_gp(model, iterations, state, key, callback, verbose):
    """Exact-GP loop: analytic refresh + optional noise/hyper steps
    (reference: models/GP.jl:80-86, training/training.jl:127-131)."""
    if state is None:
        state = model.init_state(key)
    step = _gp_analytic_step
    for i in range(1, iterations + 1):
        model, state = step(model, state)
        if (
            model.optimiser is not None
            and i % model.atfrequency == 0
            and i >= 3
            and i != iterations
        ):
            model, state = _gp_hyper_step(model, state)
        if callback is not None:
            callback(model, state, int(i))
        if verbose >= 2:
            from ..models.gp import log_py

            print(f"iter {i}: log p(y) = {float(log_py(model, state)):.6f}")
    model, state = step(model, state)
    return model, state


_gp_analytic_step = jax.jit(analytic_update)


@jax.jit
def _gp_hyper_step(model, state):
    """Gradient ascent on the marginal likelihood wrt kernel/mean params."""
    from ..kernels import batch_gram, from_unconstrained, to_unconstrained
    from ..means import batch_call
    from ..ops import linalg

    log_kernel = to_unconstrained(model.kernel)

    def neg_logpy(log_k, mean):
        kernel = from_unconstrained(log_k)
        K = batch_gram(kernel, model.train_x)[0]
        Sigma = K + model.likelihood.sigma2 * jnp.eye(K.shape[0], dtype=K.dtype)
        L = jnp.linalg.cholesky(Sigma)
        mu0 = batch_call(mean, model.train_x, 1)[0]
        r = model.train_y - mu0
        quad = linalg.invquad(L, r)
        return 0.5 * (quad + linalg.chol_logdet(L))

    g_k, g_m = jax.grad(neg_logpy, argnums=(0, 1))(log_kernel, model.mean)
    hyper = dict(state.hyper_state)
    k_up, hyper["kernel"] = model.optimiser.update(g_k, hyper["kernel"], log_kernel)
    new_kernel = from_unconstrained(
        jax.tree_util.tree_map(lambda p, u: p + u, log_kernel, k_up)
    )
    m_up, hyper["mean"] = model.optimiser.update(g_m, hyper["mean"], model.mean)
    new_mean = jax.tree_util.tree_map(lambda p, u: p + u, model.mean, m_up)
    return (
        model.replace(kernel=new_kernel, mean=new_mean),
        state.replace(hyper_state=hyper),
    )


def elbo(model, state, X=None, y=None):
    """Public ELBO evaluation (reference: functions/ELBO.jl)."""
    if isinstance(model, GP):
        from ..models.gp import log_py

        return log_py(model, state)
    if X is None:
        X, y = model.train_x, model.train_y
    return _elbo_full(model, state, X, y)
