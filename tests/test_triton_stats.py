"""The one-pass Triton statistics kernel (ops/triton_stats.py): its
arithmetic in Pallas interpret mode against the XLA statistics pass it
replaces, its padding, its gradient rule, and the gate and platform choice
that put it into a compiled step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import agp_tpu as agp
from agp_tpu.inference import analytic_vi
from agp_tpu.ops import triton_stats
from agp_tpu.ops.triton_stats import TILE_ROWS, fused_logistic_stats
from agp_tpu.reference import max_rel_err, rbf
from agp_tpu.training.train import init_state

ALG = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
KERNEL = "cavi_logistic_stats"  # the pallas_call's name in lowered programs


@pytest.fixture
def interpret(monkeypatch):
    """The kernel through Pallas's interpreter: the CPU has no Triton."""
    monkeypatch.setattr(triton_stats, "fused_logistic_stats",
                        functools.partial(fused_logistic_stats, interpret=True))


def _args(b, d=5, m=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d))
    z = rng.standard_normal((m, d))
    kinv = np.linalg.inv(rbf(z, z, 1.0, 1.0) + 1e-3 * np.eye(m))
    A = rng.standard_normal((m, m)) / np.sqrt(m)
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    return (f32(x), f32(np.sign(rng.standard_normal(b))), f32(z), f32(kinv),
            f32(rng.standard_normal(m)), f32(A @ A.T + np.eye(m)),
            jnp.float32(1.3), 1e-3, jnp.float32(7.0))


def _case(b, d=5, m=32, seed=0, ls=1.3):
    """(model, state, x, y): an SVGP + logistic model whose posterior is
    not the prior, and a batch of b rows."""
    rng = np.random.default_rng(seed)
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    x = f32(rng.standard_normal((b, d)))
    y = f32(np.sign(rng.standard_normal(b)))
    model = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=f32(ls), variance=f32(1.3)),
        agp.LogisticLikelihood.create(), agp.AnalyticSVI(b),
        f32(rng.standard_normal((m, d))), optimiser=None)
    A = rng.standard_normal((m, m)) / np.sqrt(m)
    state = init_state(model, x, y).replace(
        mu=f32(rng.standard_normal((1, m))),
        Sigma=f32((A @ A.T + np.eye(m))[None]), rho=jnp.float32(7.0))
    return model, state, x, y


# B = one row, a partial tile, whole tiles, and enough tiles that each
# program walks several of them
@pytest.mark.parametrize("b", [1, TILE_ROWS + 5, 8 * TILE_ROWS, 300 * TILE_ROWS + 3])
def test_kernel_matches_twin(b, interpret):
    """The kernel against the XLA statistics pass on the same model."""
    args = _case(b)
    out = jax.jit(analytic_vi._fused_logistic_stats)(*args)
    ref = jax.jit(analytic_vi._logistic_stats)(*args)
    assert [o.shape for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        assert max_rel_err(o, r) < 1e-5


def test_padded_columns_and_rows_leave_no_trace():
    """D=5 is padded to 16 columns and B to whole tiles: the statistics of
    the padded call equal those of the same rows fed one tile at a time."""
    args = _args(2 * TILE_ROWS)
    full = fused_logistic_stats(*args, ALG, True)
    halves = [fused_logistic_stats(args[0][s], args[1][s], *args[2:], ALG, True)
              for s in (slice(0, TILE_ROWS), slice(TILE_ROWS, None))]
    np.testing.assert_allclose(full[0], halves[0][0] + halves[1][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(full[1], halves[0][1] + halves[1][1], rtol=1e-5, atol=1e-6)


def test_gradient_rule_is_the_twin_gradient(interpret):
    """A loss that needs the forward values: the kernel's custom VJP pulls
    its cotangents back through the XLA pass, so both gradients agree to
    the forward outputs' rounding."""
    model, state, x, y = _case(50)
    w = [jnp.asarray(np.random.default_rng(3).standard_normal(o.shape), jnp.float32)
         for o in analytic_vi._logistic_stats(model, state, x, y)]

    def loss(fn, variance, mu):
        m = model.replace(kernel=model.kernel.replace(variance=variance))
        out = fn(m, state.replace(mu=mu), x, y)
        return sum(jnp.sum(o * o * wi) for o, wi in zip(out, w))

    grads = [jax.jit(jax.grad(functools.partial(loss, fn), argnums=(0, 1)))(
        model.kernel.variance, state.mu)
        for fn in (analytic_vi._fused_logistic_stats, analytic_vi._logistic_stats)]
    for a, b in zip(*grads):
        assert max_rel_err(a, b) < 1e-4


B_GATE = analytic_vi.FUSED_B[0]  # the smallest batch the kernel takes


def _svgp(lik=None, m=16, dtype=jnp.float32, ls=1.3, b=B_GATE):
    X = jnp.asarray(np.random.default_rng(1).standard_normal((2 * B_GATE, 3)), dtype)
    model = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(ls, dtype),
                                variance=jnp.asarray(1.0, dtype)),
        lik or agp.LogisticLikelihood.create(), agp.AnalyticSVI(b), X[:m],
        optimiser=None)
    return model, X


def _lowered_step(model, X, platform, **kw):
    y, lik = model.likelihood.treat_labels(jnp.sign(X[:, 0]))
    model = model.replace(likelihood=lik)
    y = y.astype(X.dtype)
    b = model.inference.batchsize
    step = jax.jit(functools.partial(analytic_vi.variational_update, **kw))
    state = init_state(model, X, y)
    return step.trace(model, state, X[:b], y[:b]).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("case,want", [
    ("flagship on a gpu", True),
    ("on a cpu", False),
    ("M below the gate", False),
    ("M above the gate", False),
    ("B below the gate", False),
    ("another likelihood", False),
    ("float64", False),
    ("several latents", False),
])
def test_shape_gate(case, want):
    """The kernel is in the step compiled for CUDA at the gate's shapes,
    and nowhere else."""
    kw = {}
    if case == "M below the gate":
        kw["m"] = analytic_vi.FUSED_M[0] - 1
    if case == "M above the gate":
        kw["m"] = analytic_vi.FUSED_M[1] + 1
    if case == "B below the gate":
        kw["b"] = B_GATE - 1
    if case == "another likelihood":
        kw["lik"] = agp.BayesianSVM.create()
    if case == "float64":
        kw["dtype"] = jnp.float64
    if case == "several latents":
        kw["lik"] = agp.LogisticSoftMaxLikelihood.create(3)
    model, X = _svgp(**kw)
    platform = "cpu" if case == "on a cpu" else "cuda"
    assert (KERNEL in _lowered_step(model, X, platform)) is want


def test_fused_false_keeps_the_step_in_xla():
    model, X = _svgp()
    assert KERNEL not in _lowered_step(model, X, "cuda", fused=False)


def test_fused_update_matches_xla_step(interpret, monkeypatch):
    """`variational_update`'s CUDA branch (the kernel, interpreted) lands
    on the same posterior as the XLA statistics pass."""
    model, X = _svgp(ls=np.array([1.3, 0.7, 2.0]))
    y = jnp.sign(X[:, 0])
    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y2 = y2.astype(X.dtype)
    s0 = init_state(model, X, y2)
    xb, yb = X[:B_GATE], y2[:B_GATE]
    assert analytic_vi._fused_logistic_applies(model, xb)
    _, s_x = jax.jit(functools.partial(analytic_vi.variational_update, fused=False))(
        model, s0, xb, yb)
    monkeypatch.setattr(jax.lax, "platform_dependent",
                        lambda *a, cuda, default: cuda(*a))
    _, s_f = jax.jit(analytic_vi.variational_update)(model, s0, xb, yb)
    for k in ("mu", "Sigma", "eta1", "eta2"):
        assert max_rel_err(getattr(s_f, k), getattr(s_x, k)) < 1e-4, k
    np.testing.assert_allclose(s_f.local_vars["theta"], s_x.local_vars["theta"], rtol=1e-4)


@pytest.mark.gpu
def test_kernel_compiled_for_the_gpu(gpu):
    args = jax.device_put(_case(4096, d=20, m=64), gpu)
    out = jax.jit(analytic_vi._fused_logistic_stats)(*args)
    ref = jax.jit(analytic_vi._logistic_stats)(*args)
    for o, r in zip(out, ref):
        assert max_rel_err(o, r) < 1e-3
