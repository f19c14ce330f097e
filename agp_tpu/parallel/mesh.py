"""Device mesh + sharding layout for data-parallel CAVI.

The reference is single-process with no distribution of any kind
(SURVEY.md section 2.8).  The scaling design:

* the N (data) axis is sharded across the mesh: X, y, and every local
  variable (theta, gamma, c, ...) are embarrassingly per-datapoint;
* the ONLY cross-device reductions of a CAVI step are the M-dimensional
  statistics kappa^T (rho grad_e_mu) ([M]) and kappa^T diag(theta) kappa
  ([M, M]) -- under jit+GSPMD these einsum contractions over the sharded
  batch axis lower to `psum`s;
* eta1/eta2/mu/Sigma/kernel params are tiny ([M], [M,M]) and replicated;
* iterations are chunked into on-device `lax.scan`s (one dispatch per
  chunk, not per step) -- the same fusion the single-chip trainer uses
  (training/train.py::_vi_steps).

Padding contract: when N is not divisible by the mesh size, `shard_batch`
pads the trailing shard and the drivers thread a 0/1 row mask through the
update (analytic_vi.variational_update(w=...)), so every data point is
counted exactly once -- trajectories are bit-equivalent (up to float
reduction order) to single-device training on the unpadded data.  The
reference counts every point once trivially (single process,
inference/analyticVI.jl:160-180).

Multi-host: the same program runs under `jax.distributed.initialize` with a
global device mesh.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(mesh: Mesh, *arrays, axis_name: str = "data", with_mask: bool = False):
    """Place arrays sharded along their leading (data) axis, padding the
    tail to a multiple of the mesh size.

    with_mask=True additionally returns a [N_padded] 0/1 row mask (1 =
    real data, 0 = pad), sharded the same way -- the drivers thread it
    into the update so padded rows never enter any cross-batch statistic
    (see the module docstring's padding contract)."""
    n = mesh.devices.size
    lead = {jnp.shape(a)[0] for a in arrays}
    if len(lead) != 1:
        raise ValueError(f"arrays disagree on the leading (data) dim: {lead}")
    n0 = lead.pop()
    rem = (-n0) % n
    out = []
    for a in arrays:
        a = jnp.asarray(a)
        if rem:
            pad = jnp.repeat(a[:1], rem, axis=0)
            a = jnp.concatenate([a, pad], axis=0)
        spec = P(axis_name, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    if with_mask:
        dtype = jnp.asarray(arrays[0]).dtype
        dtype = dtype if jnp.issubdtype(dtype, jnp.floating) else jnp.result_type(float)
        mask = jnp.concatenate(
            [jnp.ones((n0,), dtype), jnp.zeros((rem,), dtype)]
        )
        out.append(jax.device_put(mask, NamedSharding(mesh, P(axis_name))))
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh: Mesh, tree):
    """Fully-replicated placement of a pytree (model, state)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def _n_pad(mesh: Mesh, N: int) -> int:
    return (-N) % mesh.devices.size


# --------------------------------------------------------- full-batch CAVI
def _dp_body(model, state, x, y, w=None):
    """One data-parallel CAVI step body (GSPMD: the statistic einsums over
    the sharded batch axis lower to psums; the statistics stay in XLA,
    which the partitioner can split)."""
    from ..inference.analytic_vi import variational_update

    model, state = variational_update(model, state, x, y, w=w, fused=False)
    return model, state.replace(step=state.step + 1)


def data_parallel_step(mesh: Mesh, axis_name: str = "data"):
    """Build a jitted data-parallel CAVI step: X/y/mask sharded along the
    data axis, model/state replicated.  GSPMD turns the [M]/[M,M] statistic
    contractions into psums over `axis_name` -- no manual collectives.

    The step takes (model, state, x, y, w) with w an optional 0/1 row mask
    (None when N divides the mesh size)."""
    return jax.jit(_dp_body)


@partial(jax.jit, static_argnums=(5,))
def _dp_steps(model, state, x, y, w, n: int):
    """n data-parallel CAVI steps fused into one on-device lax.scan --
    one host dispatch per chunk (the single-chip trainer's _vi_steps
    pattern applied to the sharded program)."""

    def body(carry, _):
        m, s = carry
        return _dp_body(m, s, x, y, w), None

    (model, state), _ = jax.lax.scan(body, (model, state), None, length=n)
    return model, state


def sharded_train(
    model, X, y, iterations: int, mesh: Mesh | None = None, state=None, key=None,
    chunk: int = 500,
):
    """Data-parallel training driver: full-batch CAVI over the sharded
    dataset, `chunk` iterations per device dispatch (the SVI analog shards
    each minibatch).  Sparse models only: a dense (VGP) posterior has
    latent dimension N, which the data-axis layout would shard."""
    from ..training.train import init_state

    mesh = make_mesh() if mesh is None else mesh
    if not getattr(model, "is_sparse", False):
        raise TypeError(
            "sharded_train supports sparse (inducing-point) models; a dense "
            "model's [N]-sized posterior cannot be replicated across the "
            "data mesh"
        )
    from ..models.base import as_2d

    X = as_2d(X)
    y, lik = model.likelihood.treat_labels(y)
    from ..models.base import match_dtype

    y = match_dtype(y, X)
    model = model.replace(likelihood=lik)
    Xs, ys, mask = shard_batch(mesh, X, y, with_mask=True)
    w = mask if _n_pad(mesh, X.shape[0]) else None
    if state is None:
        state = init_state(model, Xs, ys, key)
    model, state = replicate(mesh, (model, state))
    done = 0
    while done < iterations:
        n = min(chunk, iterations - done)
        model, state = _dp_steps(model, state, Xs, ys, w, n)
        done += n
    return model, state


# ------------------------------------------------------- multi-output CAVI
def _mo_dp_body(model, state, x, ys, w=None):
    from ..models.multioutput import mo_variational_update

    model, state = mo_variational_update(model, state, x, ys, w=w)
    return model, state.replace(step=state.step + 1)


def mo_data_parallel_step(mesh: Mesh, axis_name: str = "data"):
    """Data-parallel multi-output CAVI step: X and every task's y sharded
    along the data axis, model/state replicated.  All cross-data reductions
    of the MO step -- the [M]/[M,M] natural-gradient statistics per latent
    AND the [R, Q] mixing-matrix gradient contractions (mo_update_A) -- are
    B-axis einsums that GSPMD lowers to psums over `axis_name`."""
    return jax.jit(_mo_dp_body)


@partial(jax.jit, static_argnums=(5,))
def _mo_dp_steps(model, state, x, ys, w, n: int):
    def body(carry, _):
        m, s = carry
        return _mo_dp_body(m, s, x, ys, w), None

    (model, state), _ = jax.lax.scan(body, (model, state), None, length=n)
    return model, state


def mo_sharded_train(
    model, X, ys, iterations: int, mesh: Mesh | None = None, state=None, key=None,
    chunk: int = 200,
):
    """Data-parallel training driver for MOVGP/MOSVGP: chunked on-device
    CAVI scans over the full sharded dataset (all tasks share X)."""
    from ..models.base import as_2d, match_dtype
    from ..models.multioutput import mo_init_state

    mesh = make_mesh() if mesh is None else mesh
    X = as_2d(X)
    new_ys, liks = [], []
    for lik, y_t in zip(model.likelihoods, ys):
        y2, lik2 = lik.treat_labels(jnp.asarray(y_t))
        new_ys.append(match_dtype(y2, X))
        liks.append(lik2)
    model = model.replace(likelihoods=tuple(liks))
    sharded = shard_batch(mesh, X, *new_ys, with_mask=True)
    Xs, yss, mask = sharded[0], tuple(sharded[1:-1]), sharded[-1]
    w = mask if _n_pad(mesh, X.shape[0]) else None
    if state is None:
        state = mo_init_state(model, Xs, yss, key)
    model, state = replicate(mesh, (model, state))
    done = 0
    while done < iterations:
        n = min(chunk, iterations - done)
        model, state = _mo_dp_steps(model, state, Xs, yss, w, n)
        done += n
    return model, state


# -------------------------------------------------------minibatched (SVI)
def _local_parts(n_dev: int, batch_per_device: int, n_pad: int, axis_name: str,
                 mode: str = "gather"):
    """Per-device (index-generation, gather) pair for the minibatch draw
    (both run under shard_map on the local X shard; per-device folded PRNG
    keys -- no cross-device gather, the design SURVEY.md section 7 calls
    out for >=80% scaling: zero per-step host->device or cross-device data
    movement).  Padding lives at the end of the LAST shard; that device
    draws indices below its valid count, so pad rows are never sampled.

    Split so the scan driver can HOIST the RNG out of the step scan
    (train.py::_precomputed_draws rationale: the per-step fold_in+randint
    is a serial chain of small threefry ops): `gen(xs, ks)`
    produces the per-device index rows for a whole chunk of steps in one
    vectorized pass, `take(xs, ys, idx)` materializes one step's batch.

    mode="slice" draws one contiguous window per device instead of iid
    indices -- the same trade the single-chip trainer offers
    (training/train.py::_draw_batch): correlated batches for a sequential
    HBM read instead of a random-access gather."""
    from ..training.train import block_tile

    def _block_tile_for(xs):
        # block applies when the tile divides the per-device batch AND the
        # padded LAST shard keeps >= 1 whole valid tile (else hi // tile
        # == 0 would make randint's range empty -- undefined under jit)
        if not mode.startswith("block"):
            return None
        tile = block_tile(mode, batch_per_device)
        if tile is None or batch_per_device % tile:
            return None
        if xs.ndim == 3:  # pre-tiled by build_svi_trainer
            return tile
        return tile if xs.shape[0] - n_pad >= tile else None

    def _hi_rows(xs, dev):
        if n_pad:
            return xs.shape[0] - jnp.where(dev == n_dev - 1, n_pad, 0)
        return xs.shape[0]  # static bound: no pad rows anywhere

    def gen(xs, ks):
        """Index rows for len(ks) steps: ks [n] step keys (replicated);
        returns [n, cnt] per-device indices (cnt: 1 slice / b//tile block /
        b gather)."""
        dev = jax.lax.axis_index(axis_name)
        ks = jax.vmap(lambda s: jax.random.fold_in(s, dev))(ks)
        tile = _block_tile_for(xs)
        if mode == "slice":
            hi = _hi_rows(xs, dev)
            return jax.vmap(
                lambda k: jax.random.randint(
                    k, (1,), 0, hi - batch_per_device + 1
                )
            )(ks)
        if tile is not None:
            if xs.ndim == 3:
                # the dynamic valid-tile bound rounds down to whole tiles,
                # so up to tile-1 tail rows of the padded shard are never
                # sampled -- same class as the pad-row exclusion
                cut = -(-n_pad // tile)  # whole tiles lost to padding
                hi_t = (
                    xs.shape[0] - jnp.where(dev == n_dev - 1, cut, 0)
                    if n_pad else xs.shape[0]
                )
            else:
                hi_t = _hi_rows(xs, dev) // tile
            return jax.vmap(
                lambda k: jax.random.randint(
                    k, (batch_per_device // tile,), 0, hi_t
                )
            )(ks)
        hi = _hi_rows(xs, dev)
        return jax.vmap(
            lambda k: jax.random.randint(k, (batch_per_device,), 0, hi)
        )(ks)

    def take(xs, ys, idx):
        """One step's batch from its precomputed per-device index row."""
        tile = _block_tile_for(xs)
        if mode == "slice":
            start = idx[0]
            return (
                jax.lax.dynamic_slice_in_dim(xs, start, batch_per_device, 0),
                jax.lax.dynamic_slice_in_dim(ys, start, batch_per_device, 0),
            )
        if tile is not None:
            if xs.ndim == 3:
                # PRE-TILED [T, tile, D]/[T, tile] shard views
                # (build_svi_trainer hoists the relayout out of the whole
                # run -- see training/train.py::_tile_views)
                xt = jnp.take(xs, idx, axis=0).reshape(
                    batch_per_device, xs.shape[-1]
                )
                yt = jnp.take(ys, idx, axis=0).reshape(
                    (batch_per_device,) + ys.shape[2:]
                )
                return xt, yt
            n_t = xs.shape[0] // tile
            xt = jnp.take(
                xs[: n_t * tile].reshape(n_t, tile, xs.shape[1]), idx, axis=0
            ).reshape(batch_per_device, xs.shape[1])
            yt = jnp.take(
                ys[: n_t * tile].reshape((n_t, tile) + ys.shape[1:]),
                idx, axis=0,
            ).reshape((batch_per_device,) + ys.shape[1:])
            return xt, yt
        return jnp.take(xs, idx, axis=0), jnp.take(ys, idx, axis=0)

    return gen, take


def _local_draw(n_dev: int, batch_per_device: int, n_pad: int, axis_name: str,
                mode: str = "gather"):
    """Single-step per-device draw (legacy per-step-RNG form): the
    composition of `_local_parts` -- identical indices to the hoisted
    path (same fold_in chain)."""
    gen, take = _local_parts(n_dev, batch_per_device, n_pad, axis_name, mode)

    def draw(xs, ys, key):
        idx = gen(xs, key[None])[0]
        return take(xs, ys, idx)

    return draw


def _make_draw(mesh: Mesh, batch_per_device: int, n_pad: int, axis_name: str,
               mode: str = "gather"):
    draw = _local_draw(mesh.devices.size, batch_per_device, n_pad, axis_name, mode)
    P_ = P(axis_name)
    return jax.shard_map(draw, mesh=mesh, in_specs=(P_, P_, P()), out_specs=(P_, P_))


def _make_idx_gen(mesh: Mesh, batch_per_device: int, n_pad: int,
                  axis_name: str, mode: str = "gather"):
    """Chunk index generator: (X, key, step0, n) -> [n, n_dev * cnt]
    (sharded over the device axis on dim 1), with indices BIT-identical to
    the per-step `_make_draw` path (same fold_in(fold_in(key, step), dev)
    chain, vmapped over the chunk)."""
    gen, _ = _local_parts(mesh.devices.size, batch_per_device, n_pad,
                          axis_name, mode)
    sm = jax.shard_map(
        gen, mesh=mesh, in_specs=(P(axis_name), P()),
        out_specs=P(None, axis_name),
    )

    def gen_idx(X, key, step0, n):
        subs = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            step0 + jnp.arange(n, dtype=step0.dtype)
        )
        return sm(X, subs)

    return gen_idx


def _make_take(mesh: Mesh, batch_per_device: int, n_pad: int, axis_name: str,
               mode: str = "gather"):
    _, take = _local_parts(mesh.devices.size, batch_per_device, n_pad,
                           axis_name, mode)
    P_ = P(axis_name)
    return jax.shard_map(
        take, mesh=mesh, in_specs=(P_, P_, P(axis_name)), out_specs=(P_, P_)
    )


def sharded_svi_step(
    mesh: Mesh, batch_per_device: int, n_pad: int = 0, axis_name: str = "data",
    sampling: str = "gather",
):
    """Stochastic (minibatched) data-parallel CAVI step.

    Each device draws its own local minibatch from its X shard, then the
    jitted variational update runs on the sharded minibatch with GSPMD
    psum-ing the [M]/[M,M] statistics.  The statistics pass stays in XLA
    (`fused=False`): GSPMD cannot partition the Triton kernel's custom call
    and would gather the whole minibatch onto every device."""
    from ..inference.analytic_vi import variational_update

    draw_sharded = _make_draw(mesh, batch_per_device, n_pad, axis_name, sampling)
    take_sharded = _make_take(mesh, batch_per_device, n_pad, axis_name, sampling)

    def step_body(model, state, X, y):
        # key folded with the step counter (the single-chip trainer's
        # convention, training/train.py::_draw_batch): one threefry per
        # step instead of a split + fold
        sub = jax.random.fold_in(state.key, state.step)
        x_b, y_b = draw_sharded(X, y, sub)
        model, state = variational_update(model, state, x_b, y_b, fused=False)
        return model, state.replace(step=state.step + 1)

    def body_idx(model, state, X, y, idx):
        """Step on a PRECOMPUTED per-device index row (the scan driver
        hoists the draw RNG out of the scan; same indices as step_body)."""
        x_b, y_b = take_sharded(X, y, idx)
        model, state = variational_update(model, state, x_b, y_b, fused=False)
        return model, state.replace(step=state.step + 1)

    step = jax.jit(step_body)
    step.body = step_body  # for the scan-fused driver
    step.body_idx = body_idx
    step.gen_idx = _make_idx_gen(mesh, batch_per_device, n_pad, axis_name, sampling)
    return step


def _make_svi_steps(step_or_body):
    """Scan-fuse an SVI step body into a chunked multi-step dispatch.

    When given a step object carrying (body_idx, gen_idx) -- what
    sharded_svi_step returns -- the chunk's draw indices are precomputed in
    ONE vectorized RNG pass before the scan (bit-identical to the per-step
    fold; train.py::_precomputed_draws).  A bare body function gets the
    legacy per-step-RNG scan."""
    body_idx = getattr(step_or_body, "body_idx", None)
    gen_idx = getattr(step_or_body, "gen_idx", None)
    step_body = getattr(step_or_body, "body", step_or_body)

    if body_idx is not None and gen_idx is not None:

        @partial(jax.jit, static_argnums=(4,))
        def steps(model, state, X, y, n: int):
            idx_all = gen_idx(X, state.key, state.step, n)

            def body(carry, idx):
                m, s = carry
                return body_idx(m, s, X, y, idx), None

            (model, state), _ = jax.lax.scan(
                body, (model, state), idx_all, length=n
            )
            return model, state

        return steps

    @partial(jax.jit, static_argnums=(4,))
    def steps(model, state, X, y, n: int):
        def body(carry, _):
            m, s = carry
            return step_body(m, s, X, y), None

        (model, state), _ = jax.lax.scan(body, (model, state), None, length=n)
        return model, state

    return steps


def build_svi_trainer(
    model, X, y, mesh: Mesh | None = None, batch_per_device: int | None = None,
    state=None, key=None,
):
    """Build the sharded-SVI training pieces: returns
    (steps, model, state, Xs, ys) where `steps(model, state, Xs, ys, n)` is
    the chunked lax.scan dispatch.  `sharded_svi_train` is a loop over this;
    benchmarks/scaling.py uses it directly so the measured program IS the
    production driver."""
    from ..models.base import as_2d
    from ..training.train import init_state

    mesh = make_mesh() if mesh is None else mesh
    n_dev = mesh.devices.size
    if batch_per_device is None:
        batch_per_device = max(model.inference.batchsize // n_dev, 1)
    X = as_2d(X)
    y, lik = model.likelihood.treat_labels(y)
    from ..models.base import match_dtype

    y = match_dtype(y, X)
    model = model.replace(likelihood=lik)
    Xs, ys = shard_batch(mesh, X, y)
    n_pad = _n_pad(mesh, X.shape[0])
    shard_rows = (X.shape[0] + n_pad) // n_dev
    if batch_per_device > shard_rows - n_pad:
        raise ValueError(
            f"batch_per_device {batch_per_device} exceeds the smallest "
            f"shard's {shard_rows - n_pad} valid rows"
        )
    if state is None:
        # local vars sized to the global minibatch
        import dataclasses

        inf = dataclasses.replace(
            model.inference, batchsize=batch_per_device * n_dev
        )
        model = model.replace(inference=inf)
        state = init_state(model, Xs, ys, key)
        state = state.replace(
            rho=jnp.asarray(X.shape[0] / (batch_per_device * n_dev), X.dtype)
        )
    sampling = getattr(model.inference, "minibatch_sampling", "gather")
    if sampling.startswith("block"):
        # hoist the block-mode tile relayout out of the whole run (one
        # shard_map reshape at setup; see _local_draw's pre-tiled branch)
        from ..training.train import block_tile

        tile = block_tile(sampling, batch_per_device)
        if (
            tile is not None
            and batch_per_device % tile == 0
            and shard_rows % tile == 0
            and shard_rows - n_pad >= tile
        ):
            ax = "data"
            retile = jax.jit(
                jax.shard_map(
                    lambda a, b: (
                        a.reshape(-1, tile, a.shape[-1]),
                        b.reshape((-1, tile) + b.shape[1:]),
                    ),
                    mesh=mesh, in_specs=(P(ax), P(ax)), out_specs=(P(ax), P(ax)),
                )
            )
            Xs, ys = retile(Xs, ys)
    step = sharded_svi_step(mesh, batch_per_device, n_pad, sampling=sampling)
    steps = _make_svi_steps(step)
    model, state = replicate(mesh, (model, state))
    return steps, model, state, Xs, ys


def sharded_svi_train(
    model, X, y, iterations: int, mesh: Mesh | None = None,
    batch_per_device: int | None = None, state=None, key=None,
    chunk: int = 500,
):
    """Minibatched data-parallel training driver (the 1M-point BASELINE
    config on several devices).  Global batch = batch_per_device *
    n_devices; `chunk` SVI iterations run per device dispatch as one
    `lax.scan` of the GSPMD step."""
    steps, model, state, Xs, ys = build_svi_trainer(
        model, X, y, mesh, batch_per_device, state, key
    )
    done = 0
    while done < iterations:
        n = min(chunk, iterations - done)
        model, state = steps(model, state, Xs, ys, n)
        done += n
    return model, state


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host bring-up: call once per host before building meshes
    (the reference has no distributed backend; jax.distributed handles the
    rendezvous)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
    return make_mesh()
