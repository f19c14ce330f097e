"""One-pass CAVI statistics for SVGP + logistic + RBF as a Pallas Triton
kernel (NVIDIA GPUs).

One program walks `tiles` row tiles of the minibatch.  For each tile it
forms the gram against Z, kappa = Knm K^-1, Ktilde, the latent moments,
the logistic E-step (c, theta) and adds the tile's share of the two
statistics s1 = kappa^T (rho y / 2) and S2 = kappa^T diag(rho theta / 2)
kappa to accumulators held in registers.  Each program writes its partial
s1/S2 to its own slot of a [programs, M(, M)] buffer that XLA sums, so the
programs run in parallel and kappa never goes to device memory.

The wrapper pads rows to whole tiles (padded rows carry zero weight) and
input columns to a power of two (zero columns leave distances unchanged).
The caller, inference/analytic_vi.py, gives the kernel the gradient of its
XLA statistics pass through `jax.custom_vjp`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

TILE_ROWS = 32
NUM_WARPS = 4


def _kernel(x_ref, y_ref, w_ref, z_ref, zz_ref, kinv_ref, mu_ref, sig_ref,
            p_ref, s1_ref, s2_ref, c_ref, th_ref, *, tiles, kappa_algorithm):
    variance, jitt, rho = p_ref[0], p_ref[1], p_ref[2]
    z = z_ref[...]
    zz = zz_ref[...]
    kinv = kinv_ref[...]
    mu = mu_ref[...]
    sig = sig_ref[...]
    m = z.shape[0]

    def body(t, carry):
        s1, s2 = carry
        rows = pl.ds(t * TILE_ROWS, TILE_ROWS)
        x = x_ref[rows, :]
        y = y_ref[rows]
        w = w_ref[rows]
        xz = pl.dot(x, z, trans_b=True, precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.maximum(
            jnp.sum(x * x, axis=1)[:, None] + zz[None, :] - 2.0 * xz, 0.0
        )
        knm = variance * jnp.exp(-0.5 * d2)
        kappa = pl.dot(knm, kinv, precision=kappa_algorithm)
        ktilde = jnp.maximum(
            variance + jitt - jnp.sum(kappa * knm, axis=1), 1e-12
        )
        mf = jnp.sum(kappa * mu[None, :], axis=1)
        ks = pl.dot(kappa, sig)
        vf = ktilde + jnp.sum(ks * kappa, axis=1)
        c = jnp.sqrt(mf * mf + vf)
        theta = jnp.tanh(c / 2.0) / (2.0 * c)
        c_ref[rows] = c
        th_ref[rows] = theta
        g1 = w * rho * y / 2.0
        g2 = w * rho * theta / 2.0
        s1 = s1 + jnp.sum(kappa * g1[:, None], axis=0)
        s2 = s2 + pl.dot(kappa * g2[:, None], kappa, trans_a=True)
        return s1, s2

    s1, s2 = jax.lax.fori_loop(
        0, tiles, body,
        (jnp.zeros((m,), jnp.float32), jnp.zeros((m, m), jnp.float32)),
    )
    s1_ref[...] = s1
    s2_ref[...] = s2


def _layout(b: int):
    """(tiles per program, programs) for a batch of b rows: about two
    programs per SM of a large GPU, at least one tile each."""
    n_tiles = pl.cdiv(b, TILE_ROWS)
    tiles = max(1, n_tiles // 256)
    return tiles, pl.cdiv(n_tiles, tiles)


def _pad(x, y, z):
    b, d = x.shape
    tiles, progs = _layout(b)
    rows = tiles * progs * TILE_ROWS
    dp = max(16, pl.next_power_of_2(d))
    xp = jnp.zeros((rows, dp), jnp.float32).at[:b, :d].set(x)
    zp = jnp.zeros((z.shape[0], dp), jnp.float32).at[:, :d].set(z)
    yp = jnp.zeros((rows,), jnp.float32).at[:b].set(y)
    wp = jnp.zeros((rows,), jnp.float32).at[:b].set(1.0)
    return xp, yp, wp, zp, tiles, progs


def fused_logistic_stats(x, y, z, kinv, mu, sigma, variance, jitt, rho,
                         kappa_algorithm=None, interpret=False):
    """(s1 [M], S2 [M, M], c [B], theta [B]) of one logistic CAVI step on
    float32 inputs already divided by the RBF lengthscale."""
    b = x.shape[0]
    m = z.shape[0]
    xp, yp, wp, zp, tiles, progs = _pad(x, y, z)
    rows = tiles * TILE_ROWS
    params = jnp.stack([variance, jnp.asarray(jitt, jnp.float32), rho,
                        jnp.zeros((), jnp.float32)]).astype(jnp.float32)
    whole = lambda *shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    row_block = pl.BlockSpec((rows,), lambda i: (i,))
    s1p, s2p, c, theta = pl.pallas_call(
        functools.partial(_kernel, tiles=tiles, kappa_algorithm=kappa_algorithm),
        grid=(progs,),
        in_specs=[
            pl.BlockSpec((rows, xp.shape[1]), lambda i: (i, 0)),
            row_block,
            row_block,
            whole(m, zp.shape[1]),
            whole(m),
            whole(m, m),
            whole(m),
            whole(m, m),
            whole(4),
        ],
        out_specs=[
            pl.BlockSpec((None, m), lambda i: (i, 0)),
            pl.BlockSpec((None, m, m), lambda i: (i, 0, 0)),
            row_block,
            row_block,
        ],
        out_shape=[
            jax.ShapeDtypeStruct((progs, m), jnp.float32),
            jax.ShapeDtypeStruct((progs, m, m), jnp.float32),
            jax.ShapeDtypeStruct((xp.shape[0],), jnp.float32),
            jax.ShapeDtypeStruct((xp.shape[0],), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="cavi_logistic_stats",
    )(xp, yp, wp, zp, jnp.sum(zp * zp, 1), kinv, mu, sigma, params)
    return jnp.sum(s1p, 0), jnp.sum(s2p, 0), c[:b], theta[:b]
