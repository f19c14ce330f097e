"""Smoke test of the CAVI training path on an NVIDIA GPU.

Drives agp_tpu's main path through its public entry points at the widths
of the repository's cells, on random data made from a seed, and compares
every result with an independent reference:

  0  device: a GPU is required, never a CPU fallback
  1  precision probe: kappa = Knm K^-1 and kappa^T diag(theta) kappa at
     each f32 dot setting, against float64
  2  flagship SVGP + logistic (N=200,000, D=20, M=64, B=4096): 20 steps
     against the float64 numpy CAVI (agp_tpu/reference.py), then
     `train` / `predict_y` / `proba_y` against the same run in float64 on
     the CPU
  3  large M (N=500,000, M=512, B=65,536): step parity, 300 iterations
  4  multiclass (K=10) and heteroscedastic steps against float64 on the CPU
  5  Gibbs sampling, the CAVI-vs-Gibbs posterior oracle, OnlineSVGP
  6  accuracy oracles for every model family
  7  compile seconds, steady-state rates and step memory of phases 2-5

The float64 CPU runs happen in one child process pinned to the CPU
(`--cpu-reference`), so only this process opens the GPU.  The last line
of standard output is the JSON result; any failed check exits non-zero
before it is printed.

  python chip_smoke.py              one GPU, every phase
  python chip_smoke.py --multi      four GPUs: the sharded paths only
  python chip_smoke.py --rehearse   toy sizes on any device, CPU included
                                    (checks the control flow; prints no
                                    result line)
"""
from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def use_compile_cache(environ=None, root=ROOT) -> str:
    """The persistent compile cache: JAX_COMPILATION_CACHE_DIR when it is
    set, else the fixed <root>/.jax_cache (put into the environment, where
    JAX reads it when it is imported)."""
    environ = os.environ if environ is None else environ
    return environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR", os.path.join(root, ".jax_cache")
    )


if __name__ == "__main__":
    use_compile_cache()

import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

SEED = 0
F32 = np.float32

# Step-parity tolerances of an f32 GPU run against float64 after 20 steps,
# as max |a - ref| / max |ref| over mu and over Sigma (PERF.md, Findings).
# Flagship: the default kappa algorithm measured 1.4e-5 / 2.5e-5 on an H100
# and plain TF32 kappa 1.2e-4 / 3.3e-4, so 1e-4 passes the first with 4x to
# spare and fails the second.  M=512 (cond(Kmm) ~35) and the coupled
# multi-latent E-steps amplify the TF32 statistics dots to a few 1e-4,
# which 1e-3 and 2e-3 bound.
STEP_TOL = 1e-4
STEP_TOL_LARGE_M = 1e-3
STEP_TOL_MULTILATENT = 2e-3
# Accuracy gap allowed between the GPU run and the float64 CPU run.
ACC_TOL = 0.005


class SmokeFailure(RuntimeError):
    pass


def require_gpu(devices, rehearse=False):
    """The first device must be a GPU; anything else is a failure, except
    in a rehearsal, which accepts any device."""
    platform = devices[0].platform
    if platform != "gpu" and not rehearse:
        raise SmokeFailure(
            f"no GPU: JAX's first device is {platform!r} "
            f"({devices[0].device_kind}); this test never falls back"
        )
    return platform


def smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as the card reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or out.stderr.strip()


def parity_errors(mu, Sigma, ref_mu, ref_Sigma):
    from agp_tpu.reference import max_rel_err

    return max_rel_err(mu, ref_mu), max_rel_err(Sigma, ref_Sigma)


def parity_ok(errors, tol=STEP_TOL) -> bool:
    return all(np.isfinite(e) and e <= tol for e in errors)


class Phase:
    """Prints one line per check, with its limit beside it; `close` raises
    if any check of the phase failed."""

    def __init__(self, number, title):
        self.number, self.failed = number, []
        self.t0 = time.perf_counter()
        self.say(f"== {title}")

    def say(self, msg):
        print(f"[{self.number}] {msg}", flush=True)

    def check(self, label, value, ok, limit):
        self.say(f"{label}: {value} ({limit}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(label)

    def close(self):
        self.say(f"phase took {time.perf_counter() - self.t0:.1f} s")
        if self.failed:
            raise SmokeFailure(f"phase {self.number} failed: {self.failed}")


# --------------------------------------------------------------- workloads
class Sizes:
    """Widths of the cells; `rehearse` shrinks N, M, B and iteration counts
    so that the control flow can be checked on a CPU."""

    def __init__(self, rehearse):
        r = rehearse
        self.flag = dict(N=2_000 if r else 200_000, test=1_000 if r else 50_000,
                         D=20, M=16 if r else 64, B=128 if r else 4096,
                         iters=42 if r else 3000)
        self.big = dict(N=4_000 if r else 500_000, D=20, M=32 if r else 512,
                        B=512 if r else 65_536, iters=12 if r else 300)
        self.mc = dict(N=2_000 if r else 50_000, D=10, M=16 if r else 64,
                       B=128 if r else 2048, K=10, iters=42 if r else 3000)
        self.het = dict(N=2_000 if r else 50_000, D=10, M=16 if r else 64,
                        B=128 if r else 2048, iters=42 if r else 3000)
        self.gibbs_n = 128 if r else 2048
        self.oracle_scale = 0.1 if r else 1.0
        self.steps = 4 if r else 20
        self.multi = dict(N=8_000 if r else 1_000_000, D=20, M=16 if r else 64,
                          B=512 if r else 16_384, iters=200 if r else 2000)
        self.rehearse = r


def linear_labels(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d), dtype=F32)
    w = rng.standard_normal(d, dtype=F32)
    return X, np.where(X @ w > 0, 1.0, -1.0).astype(F32)


def multiclass_data(c, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((c["N"], c["D"]), dtype=F32)
    W = rng.standard_normal((c["D"], c["K"]), dtype=F32)
    return X, np.argmax(X @ W, axis=1)


def hetero_data(c, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((c["N"], c["D"]), dtype=F32)
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(c["N"], dtype=F32)
    return X, y.astype(F32)


def batch_indices(n, b, steps, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, b) for _ in range(steps)]


def svgp(agp, jnp, lik, Z, B, dtype, ls=2.0, sampling="block"):
    kern = agp.SqExponentialKernel(
        lengthscale=jnp.asarray(ls, dtype), variance=jnp.asarray(1.0, dtype)
    )
    return agp.SVGP.create(
        kern, lik, agp.AnalyticSVI(B, minibatch_sampling=sampling),
        jnp.asarray(Z, dtype), optimiser=None,
    )


def run_steps(model, X, y, idx):
    """`variational_update` on the given minibatches, from the initial
    state; returns (model, state, compiled step)."""
    import jax
    import jax.numpy as jnp

    from agp_tpu.inference.analytic_vi import variational_update
    from agp_tpu.training.train import init_state

    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    Xd = jnp.asarray(X)
    yd = jnp.asarray(y2, Xd.dtype)
    state = init_state(model, Xd, yd)
    state = state.replace(rho=jnp.asarray(X.shape[0] / len(idx[0]), Xd.dtype))
    step = jax.jit(variational_update)
    for i in idx:
        ii = jnp.asarray(i)
        model, state = step(model, state, Xd[ii], yd[ii])
    jax.block_until_ready(state.mu)
    return model, state, step, (Xd[ii], yd[ii])


# -------------------------------------------------- float64 CPU reference
def cpu_reference(out_path, rehearse):
    """Child-process mode: float64 runs on the CPU that the GPU phases
    compare with, written to `out_path` (.npz)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu import config

    # like for like: the float32 run's diagonal jitter, not float64's
    config._JITTER[np.dtype(np.float64)] = config.jitter(np.float32)
    sz = Sizes(rehearse)
    f64 = jnp.float64
    out = {}
    c = sz.flag
    X, y = linear_labels(c["N"] + c["test"], c["D"], SEED)
    X = X.astype(np.float64)
    m = svgp(agp, jnp, agp.LogisticLikelihood.create(), X[:c["M"]], c["B"], f64)
    m, s = agp.train(m, X[:c["N"]], y[:c["N"]], iterations=c["iters"])
    Xte, yte = X[c["N"]:], y[c["N"]:]
    out["flag_acc"] = np.mean(np.asarray(agp.predict_y(m, s, Xte)) == yte)
    out["flag_proba"] = np.asarray(agp.proba_y(m, s, Xte[:1000]))

    c = sz.mc
    X, yk = multiclass_data(c, SEED + 2)
    m = svgp(agp, jnp, agp.LogisticSoftMaxLikelihood.create(c["K"]),
             X[:c["M"]], c["B"], f64)
    _, s, _, _ = run_steps(m, X.astype(np.float64), yk,
                           batch_indices(c["N"], c["B"], sz.steps, SEED + 3))
    out["mc_mu"], out["mc_Sigma"] = np.asarray(s.mu), np.asarray(s.Sigma)

    c = sz.het
    X, yh = hetero_data(c, SEED + 4)
    m = svgp(agp, jnp, agp.HeteroscedasticLikelihood.create(), X[:c["M"]],
             c["B"], f64)
    _, s, _, _ = run_steps(m, X.astype(np.float64), yh.astype(np.float64),
                           batch_indices(c["N"], c["B"], sz.steps, SEED + 5))
    out["het_mu"], out["het_Sigma"] = np.asarray(s.mu), np.asarray(s.Sigma)
    np.savez(out_path, **out)


def start_cpu_reference(tmpdir, rehearse):
    """Start the float64 child on the CPU; the GPU stays invisible to it."""
    out = os.path.join(tmpdir, "cpu_reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, os.path.abspath(__file__), "--cpu-reference", out]
    if rehearse:
        args.append("--rehearse")
    return subprocess.Popen(args, env=env), out


def finish_cpu_reference(proc, out, timeout=900):
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure("float64 CPU reference timed out")
    if rc != 0:
        raise SmokeFailure(f"float64 CPU reference exited {rc}")
    return dict(np.load(out))


# ------------------------------------------------------------------ timing
TIMES = {}


def timed_train(name, agp, jax, model, X, y, iters):
    """`iters` iterations of `agp.train` as three calls of iters // 3, each
    from the last one's state (the same minibatch draws as one call): the
    first compiles, the second absorbs the recompile that the likelihood's
    weakly-typed scalar leaves trigger once updated, the third is timed.
    Then the scan-fused step alone (`_vi_steps`, compiled by those calls)
    is timed from the same state: `train` adds per-call host work."""
    from agp_tpu.models.base import as_2d, match_dtype
    from agp_tpu.training.train import _vi_steps

    n = iters // 3
    t0 = time.perf_counter()
    model2, state = agp.train(model, X, y, iterations=n)
    jax.block_until_ready(state.mu)
    first = time.perf_counter() - t0
    model2, state = agp.train(model2, X, y, iterations=n, state=state)
    t0 = time.perf_counter()
    model2, state = agp.train(model2, X, y, iterations=n, state=state)
    jax.block_until_ready(state.mu)
    steady = time.perf_counter() - t0
    Xd = as_2d(X)
    yd = match_dtype(model.likelihood.treat_labels(y)[0], Xd)
    m3, s3 = _vi_steps(model2, state, Xd, yd, n)
    jax.block_until_ready(s3.mu)
    t0 = time.perf_counter()
    m3, s3 = _vi_steps(m3, s3, Xd, yd, n)
    jax.block_until_ready(s3.mu)
    scan = time.perf_counter() - t0
    TIMES.setdefault(name, {}).update(
        compile_s=max(first - steady, 0.0), train_iters_per_s=n / steady,
        scan_steps_per_s=n / scan)
    return model2, state


def note_memory(name, step, model, state, xb, yb):
    mem = step.lower(model, state, xb, yb).compile().memory_analysis()
    if mem is not None:
        TIMES.setdefault(name, {})["step_memory"] = {
            k: getattr(mem, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)
        }


# ------------------------------------------------------------------ phases
def phase_device(rehearse):
    import jax

    ph = Phase(0, "device")
    devs = jax.devices()
    platform = require_gpu(devs, rehearse)
    ph.say(f"platform {platform}, device_kind {devs[0].device_kind}, "
           f"count {len(devs)}, jax {jax.__version__}")
    ph.say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    ph.say(f"compile cache {os.environ.get('JAX_COMPILATION_CACHE_DIR')}")
    ph.say(f"nvidia-smi: {smi_line()}")
    ph.close()
    return devs


def phase_probe(sz):
    import jax
    import jax.numpy as jnp

    from agp_tpu.inference.analytic_vi import _kappa_precision
    from agp_tpu.reference import max_rel_err, rbf

    ph = Phase(1, "precision probe: f32 dot settings against float64")
    c = sz.flag
    X, _ = linear_labels(c["N"] + c["test"], c["D"], SEED)
    M = c["M"]
    rows = min(4096, X.shape[0] - M)
    Z = X[:M].astype(np.float64)
    K = rbf(Z, Z, 2.0, 1.0) + 1e-3 * np.eye(M)
    Kinv = np.linalg.inv(K).astype(F32)
    Knm = rbf(X[M:M + rows], Z, 2.0, 1.0).astype(F32)
    ref = Knm.astype(np.float64) @ Kinv.astype(np.float64)
    kap = ref.astype(F32)
    th = np.random.default_rng(SEED + 9).uniform(0.05, 0.25, rows).astype(F32)
    sref = (kap.astype(np.float64) * th[:, None]).T @ kap.astype(np.float64)
    P = jax.lax.DotAlgorithmPreset
    settings = {
        "DEFAULT": jax.lax.Precision.DEFAULT,
        "HIGH": jax.lax.Precision.HIGH,
        "HIGHEST": jax.lax.Precision.HIGHEST,
        "F32_F32_F32": P.F32_F32_F32,
        "TF32_TF32_F32_X3": P.TF32_TF32_F32_X3,
        "BF16_BF16_F32_X3": P.BF16_BF16_F32_X3,
    }
    if jax.devices()[0].platform != "gpu":  # the CPU has no TF32 dots
        settings.pop("TF32_TF32_F32_X3")
    ph.say(f"Kmm {M}x{M} cond {np.linalg.cond(K):.4g}, Knm {rows}x{M}; "
           f"default kappa algorithm {_kappa_precision(jnp.float32)}")
    for name, prec in settings.items():
        k = jax.jit(lambda a, b: jnp.dot(a, b, precision=prec))(Knm, Kinv)
        s = jax.jit(lambda a, t: jnp.einsum("bm,b,bn->mn", a, t, a,
                                            precision=prec))(kap, th)
        ph.say(f"{name:18s} kappa max rel err {max_rel_err(k, ref):.3e}   "
               f"kappa^T diag(theta) kappa {max_rel_err(s, sref):.3e}")
    ph.close()


def phase_flagship(sz, cpu_ref_wait):
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.reference import svgp_cavi

    ph = Phase(2, "flagship: SVGP + logistic, AnalyticSVI, block sampling")
    c = sz.flag
    X, y = linear_labels(c["N"] + c["test"], c["D"], SEED)
    Xtr, ytr, Xte, yte = X[:c["N"]], y[:c["N"]], X[c["N"]:], y[c["N"]:]
    idx = batch_indices(c["N"], c["B"], sz.steps, SEED + 1)
    m = svgp(agp, jnp, agp.LogisticLikelihood.create(), Xtr[:c["M"]], c["B"],
             jnp.float32)
    t0 = time.perf_counter()
    m1, s1, step, (xb, yb) = run_steps(m, Xtr, ytr, idx)
    ph.say(f"{sz.steps} steps on device in {time.perf_counter() - t0:.1f} s "
           "(compile included)")
    note_memory("flagship", step, m1, s1, xb, yb)
    ref = svgp_cavi([(Xtr[i], ytr[i]) for i in idx], Xtr[:c["M"]], 2.0, 1.0,
                    "logistic", rho=c["N"] / c["B"], jitter=1e-3)
    errs = parity_errors(s1.mu[0], s1.Sigma[0], ref["mu"], ref["Sigma"])
    ph.check(f"step parity vs float64 numpy, {sz.steps} steps, max rel err "
             "(mu, Sigma)", f"({errs[0]:.3e}, {errs[1]:.3e})",
             parity_ok(errs), f"each <= {STEP_TOL:g}: f32 rounding of "
             "kappa's cond(Kmm)-amplified product and TF32 statistics")
    check_fused_kernel(ph, Xtr, ytr, c)

    cref = cpu_ref_wait()
    m2, s2 = timed_train("flagship", agp, jax, m, Xtr, ytr, c["iters"])
    ph.say(f"trained {c['iters']} iterations")
    pred = np.asarray(agp.predict_y(m2, s2, Xte))
    acc = float(np.mean(pred == yte))
    proba = np.asarray(agp.proba_y(m2, s2, Xte))
    ph.check("mu finite", bool(np.all(np.isfinite(np.asarray(s2.mu)))), bool(
        np.all(np.isfinite(np.asarray(s2.mu)))), "all finite")
    ph.check(f"held-out accuracy on {len(yte)} points vs float64 CPU "
             f"{cref['flag_acc']:.4f}", f"{acc:.4f}",
             abs(acc - cref["flag_acc"]) <= ACC_TOL, f"|diff| <= {ACC_TOL}")
    dp = float(np.max(np.abs(proba[:len(cref["flag_proba"])] - cref["flag_proba"])))
    ph.check("proba_y in [0, 1]", bool(np.all((proba >= 0) & (proba <= 1))),
             bool(np.all((proba >= 0) & (proba <= 1))), "all in [0, 1]")
    ph.say(f"proba_y max |gpu - cpu float64| on 1000 points: {dp:.4f} "
           "(information: both runs draw the same minibatches)")
    ph.close()


def check_fused_kernel(ph, X, y, c):
    """The Triton statistics kernel, compiled for this GPU at the flagship
    width, against the XLA statistics pass it replaces (on another
    platform the XLA pass runs and this says so)."""
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.inference import analytic_vi
    from agp_tpu.reference import max_rel_err
    from agp_tpu.training.train import init_state

    M, B = c["M"], c["B"]
    m = svgp(agp, jnp, agp.LogisticLikelihood.create(), X[:M], B, jnp.float32)
    on_gpu = jax.default_backend() == "gpu"
    ph.say("Triton statistics kernel on this path: "
           f"{on_gpu and analytic_vi._fused_logistic_applies(m, jnp.asarray(X[:B]))}")
    if not on_gpu:
        return
    rng = np.random.default_rng(SEED + 8)
    A = rng.standard_normal((M, M)) / np.sqrt(M)
    xb, yb = jnp.asarray(X[:B]), jnp.asarray(y[:B])
    st = init_state(m, xb, yb).replace(
        mu=jnp.asarray(rng.standard_normal((1, M)), F32),
        Sigma=jnp.asarray((A @ A.T + np.eye(M))[None], F32),
        rho=jnp.float32(c["N"] / B))
    out = jax.jit(analytic_vi._fused_logistic_stats)(m, st, xb, yb)
    ref = jax.jit(analytic_vi._logistic_stats)(m, st, xb, yb)
    errs = [max_rel_err(o, r) for o, r in zip(out, ref)]
    ph.check(f"Triton kernel vs the XLA statistics pass at B={B}, M={M}: max "
             "rel err (s1, S2, c, theta)", ", ".join(f"{e:.2e}" for e in errs),
             max(errs) <= 1e-3, "each <= 1e-3: TF32 statistics dots in both, "
             "summed in another order")


def phase_large_m(sz):
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.reference import svgp_cavi

    ph = Phase(3, "large M: SVGP + logistic, M=512, B=65,536")
    c = sz.big
    X, y = linear_labels(c["N"], c["D"], SEED + 6)
    idx = batch_indices(c["N"], c["B"], sz.steps, SEED + 7)
    m = svgp(agp, jnp, agp.LogisticLikelihood.create(), X[:c["M"]], c["B"],
             jnp.float32, sampling="slice")
    m1, s1, step, (xb, yb) = run_steps(m, X, y, idx)
    note_memory("large_m", step, m1, s1, xb, yb)
    ref = svgp_cavi([(X[i], y[i]) for i in idx], X[:c["M"]], 2.0, 1.0,
                    "logistic", rho=c["N"] / c["B"], jitter=1e-3)
    errs = parity_errors(s1.mu[0], s1.Sigma[0], ref["mu"], ref["Sigma"])
    ph.check(f"step parity vs float64 numpy, {sz.steps} steps, max rel err "
             "(mu, Sigma)", f"({errs[0]:.3e}, {errs[1]:.3e})",
             parity_ok(errs, STEP_TOL_LARGE_M), f"each <= {STEP_TOL_LARGE_M:g}")
    m2, s2 = timed_train("large_m", agp, jax, m, X, y, c["iters"])
    fin = bool(np.all(np.isfinite(np.asarray(s2.mu)))
               and np.all(np.isfinite(np.asarray(s2.Sigma))))
    ph.check(f"posterior after {c['iters']} iterations finite", fin, fin,
             "mu and Sigma finite")
    ph.close()


def phase_multilatent(sz, cref):
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp

    ph = Phase(4, "multiclass (K=10) and heteroscedastic steps vs float64 CPU")
    c = sz.mc
    X, yk = multiclass_data(c, SEED + 2)
    m = svgp(agp, jnp, agp.LogisticSoftMaxLikelihood.create(c["K"]),
             X[:c["M"]], c["B"], jnp.float32)
    m1, s1, step, (xb, yb) = run_steps(
        m, X, yk, batch_indices(c["N"], c["B"], sz.steps, SEED + 3))
    note_memory("multiclass", step, m1, s1, xb, yb)
    errs = parity_errors(s1.mu, s1.Sigma, cref["mc_mu"], cref["mc_Sigma"])
    ph.check(f"multiclass step parity, {sz.steps} steps, max rel err "
             "(mu, Sigma)", f"({errs[0]:.3e}, {errs[1]:.3e})",
             parity_ok(errs, STEP_TOL_MULTILATENT),
             f"each <= {STEP_TOL_MULTILATENT:g}")
    timed_train("multiclass", agp, jax, m, X, yk, c["iters"])

    c = sz.het
    X, yh = hetero_data(c, SEED + 4)
    m = svgp(agp, jnp, agp.HeteroscedasticLikelihood.create(), X[:c["M"]],
             c["B"], jnp.float32)
    m1, s1, step, (xb, yb) = run_steps(
        m, X, yh, batch_indices(c["N"], c["B"], sz.steps, SEED + 5))
    note_memory("heteroscedastic", step, m1, s1, xb, yb)
    errs = parity_errors(s1.mu, s1.Sigma, cref["het_mu"], cref["het_Sigma"])
    ph.check(f"heteroscedastic step parity, {sz.steps} steps, max rel err "
             "(mu, Sigma)", f"({errs[0]:.3e}, {errs[1]:.3e})",
             parity_ok(errs, STEP_TOL_MULTILATENT),
             f"each <= {STEP_TOL_MULTILATENT:g}")
    timed_train("heteroscedastic", agp, jax, m, X, yh, c["iters"])
    ph.close()


def _toy(jax, jnp, n, d, key=0):
    X = jax.random.uniform(jax.random.PRNGKey(key), (n, d), jnp.float32) * 4 - 2
    f = jnp.sin(2 * X[:, 0]) + 0.5 * (X[:, 1] if d > 1 else 0.0)
    return X, f


def phase_sampling(sz):
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.models.mcgp import sample as mc_sample

    ph = Phase(5, "Gibbs sampling and streaming")
    n = sz.gibbs_n
    Xg = jax.random.normal(jax.random.PRNGKey(6), (n, 8), jnp.float32)
    yg = jnp.sign(Xg[:, 0] + 0.5 * Xg[:, 1])
    mg = agp.MCGP.create(Xg, yg, agp.SqExponentialKernel(
        lengthscale=jnp.asarray(2.0, jnp.float32)),
        agp.LogisticLikelihood.create(), agp.GibbsSampling(n_burnin=50))
    S, C = 400, 4
    t0 = time.perf_counter()
    smp = jax.block_until_ready(mc_sample(mg, S, key=jax.random.PRNGKey(1),
                                          n_chains=C))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    smp = jax.block_until_ready(mc_sample(mg, S, key=jax.random.PRNGKey(2),
                                          n_chains=C))
    dt = time.perf_counter() - t0
    TIMES["gibbs"] = dict(compile_s=max(first - dt, 0.0),
                          steps_per_s=(S + 50) * C / dt)
    fin = bool(jnp.all(jnp.isfinite(smp)))
    ph.check(f"MCGP Gibbs N={n}, {C} chains x {S} samples finite", fin, fin,
             "all finite")

    X, f = _toy(jax, jnp, 40, 2, key=12)
    y = np.asarray(jnp.sign(f))
    mv = agp.VGP.create(X, y, agp.SqExponentialKernel(),
                        agp.LogisticLikelihood.create(), agp.AnalyticVI(),
                        optimiser=None)
    mv, sv = agp.train(mv, iterations=100)
    mg = agp.MCGP.create(X, y, agp.SqExponentialKernel(),
                         agp.LogisticLikelihood.create(),
                         agp.GibbsSampling(n_burnin=300))
    samples = agp.sample(mg, 2000, key=jax.random.PRNGKey(13), n_chains=4)
    gmean = jnp.mean(samples, axis=(0, 1))[0]
    corr = float(jnp.corrcoef(jnp.stack([sv.mu[0], gmean]))[0, 1])
    ph.check("CAVI vs Gibbs posterior-mean correlation, logistic N=40",
             f"{corr:.4f}", corr >= 0.99, ">= 0.99")

    Bo, iters = 256, 20
    Xo, fo = _toy(jax, jnp, 8 * Bo, 2, key=7)
    yo = fo + 0.05 * jax.random.normal(jax.random.PRNGKey(8), fo.shape,
                                       jnp.float32)
    mo = agp.OnlineSVGP.create(
        agp.SqExponentialKernel(),
        agp.GaussianLikelihood.create(0.05, opt_noise=False),
        agp.AnalyticVI(), n_dim=2, capacity=128, optimiser=None)
    m1, s1 = None, None
    t0 = time.perf_counter()
    m1 = mo
    for i in range(8):
        m1, s1 = agp.online_train(m1, Xo[i * Bo:(i + 1) * Bo],
                                  yo[i * Bo:(i + 1) * Bo], state=s1,
                                  iterations=iters)
    jax.block_until_ready(s1.mu)
    TIMES["online_per_batch"] = dict(first_run_s=time.perf_counter() - t0)
    mu = agp.predict_f(m1, s1, Xo)
    rmse = float(jnp.sqrt(jnp.mean((mu - fo) ** 2)))
    ph.check("OnlineSVGP per-batch rmse after 8 batches", f"{rmse:.4f}",
             rmse < 0.1, "< 0.1")
    m0, s0 = agp.online_train(mo, Xo[:Bo], yo[:Bo], iterations=iters)
    m2, s2 = agp.online_train_stream(
        m0, Xo[Bo:].reshape(7, Bo, 2), yo[Bo:].reshape(7, Bo), state=s0,
        iterations=iters)
    mu = agp.predict_f(m2, s2, Xo)
    rmse = float(jnp.sqrt(jnp.mean((mu - fo) ** 2)))
    ph.check("online_train_stream rmse after 8 batches", f"{rmse:.4f}",
             rmse < 0.1, "< 0.1")
    ph.close()


# The on-device accuracy oracles: each returns (value, limit text, ok).
def _oracles(sz):
    import jax
    import jax.numpy as jnp
    import optax

    import agp_tpu as agp

    dt = jnp.float32
    s = sz.oracle_scale

    def n(k):
        return max(int(k * s), 64)

    def gp_exact():
        X, f = _toy(jax, jnp, 400, 2)
        y = np.asarray(f + 0.05 * jax.random.normal(jax.random.PRNGKey(1), f.shape, dt))
        m = agp.GP.create(X, y, agp.SqExponentialKernel(), noise=0.05, optimiser=None)
        m, st = agp.train(m, iterations=3)
        rmse = float(jnp.sqrt(jnp.mean((agp.predict_f(m, st, X) - f) ** 2)))
        return rmse, "< 0.1", rmse < 0.1

    def svgp_logistic():
        X, f = _toy(jax, jnp, n(20_000), 2, key=2)
        y = np.asarray(jnp.sign(f))
        m = agp.SVGP.create(agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
                            agp.AnalyticSVI(min(1024, n(20_000))), Z=X[:64], optimiser=None)
        m, st = agp.train(m, X, y, iterations=500)
        k = min(4096, X.shape[0])
        acc = float(jnp.mean((agp.predict_y(m, st, X[:k]) > 0) == (jnp.asarray(y[:k]) > 0)))
        return acc, "> 0.93", acc > 0.93

    def svgp_hyperopt():
        X, f = _toy(jax, jnp, 2000, 2, key=3)
        y = np.asarray(f + 0.05 * jax.random.normal(jax.random.PRNGKey(4), f.shape, dt))
        m = agp.SVGP.create(
            agp.SqExponentialKernel(lengthscale=jnp.asarray(3.0, dt)),
            agp.GaussianLikelihood.create(0.05, opt_noise=False),
            agp.AnalyticVI(), Z=X[:32], optimiser=optax.adam(0.05), atfrequency=5)
        m, st = agp.train(m, X, y, iterations=120)
        ls = float(jnp.ravel(m.kernel.lengthscale)[0])
        rmse = float(jnp.sqrt(jnp.mean((agp.predict_f(m, st, X[:512]) - f[:512]) ** 2)))
        ok = rmse < 0.25 and abs(ls - 3.0) > 0.3 and np.isfinite(ls)
        return rmse, "< 0.25 and lengthscale moved by > 0.3", ok

    def multiclass():
        X = jax.random.normal(jax.random.PRNGKey(5), (n(8000), 2), dt)
        centers = jnp.asarray([[1.5, 0.0], [-1.5, 1.0], [0.0, -1.5]], dt)
        y = np.asarray(jnp.argmin(jnp.sum((X[:, None, :] - centers[None]) ** 2, -1), axis=1))
        m = agp.SVGP.create(agp.SqExponentialKernel(), agp.LogisticSoftMaxLikelihood.create(3),
                            agp.AnalyticSVI(512), Z=X[:48], optimiser=None)
        m, st = agp.train(m, X, y, iterations=400)
        k = min(2048, X.shape[0])
        acc = float(jnp.mean(agp.predict_y(m, st, X[:k]) == jnp.asarray(y[:k])))
        return acc, "> 0.85", acc > 0.85

    def hetero():
        X, f = _toy(jax, jnp, 3000, 1, key=6)
        g = -1.5 + 1.2 * jnp.tanh(X[:, 0])
        noise = jnp.sqrt(1.0 / (8.0 * jax.nn.sigmoid(g)))
        y = np.asarray(f + noise * jax.random.normal(jax.random.PRNGKey(7), f.shape, dt))
        m = agp.VGP.create(X[:512], y[:512], agp.SqExponentialKernel(),
                           agp.HeteroscedasticLikelihood.create(lam=8.0),
                           agp.AnalyticVI(), optimiser=None)
        m, st = agp.train(m, iterations=60)
        rmse = float(jnp.sqrt(jnp.mean((agp.predict_f(m, st, X[:512])[0] - f[:512]) ** 2)))
        return rmse, "< 0.4", rmse < 0.4 and np.isfinite(rmse)

    def vstp():
        X, f = _toy(jax, jnp, 400, 2, key=8)
        y = np.array(f + 0.05 * jax.random.normal(jax.random.PRNGKey(9), f.shape, dt))
        y[::29] += 8.0
        m = agp.VStP.create(X, y, agp.SqExponentialKernel(), agp.StudentTLikelihood.create(4.0),
                            agp.AnalyticVI(), nu=5.0, optimiser=None)
        m, st = agp.train(m, iterations=60)
        rmse = float(jnp.sqrt(jnp.mean((agp.predict_f(m, st, X) - f) ** 2)))
        return rmse, "< 0.3", rmse < 0.3

    def online():
        X, f = _toy(jax, jnp, 4096, 2, key=10)
        y = np.asarray(f + 0.05 * jax.random.normal(jax.random.PRNGKey(11), f.shape, dt))
        m = agp.OnlineSVGP.create(agp.SqExponentialKernel(),
                                  agp.GaussianLikelihood.create(0.05, opt_noise=False),
                                  agp.AnalyticVI(), n_dim=2, capacity=128, optimiser=None)
        st = None
        for i in range(16):
            m, st = agp.online_train(m, X[i * 256:(i + 1) * 256], y[i * 256:(i + 1) * 256],
                                     state=st, iterations=20)
        rmse = float(jnp.sqrt(jnp.mean((agp.predict_f(m, st, X[:512]) - f[:512]) ** 2)))
        return rmse, "< 0.15", rmse < 0.15

    def gibbs_cavi():
        X, f = _toy(jax, jnp, 48, 2, key=12)
        y = np.asarray(jnp.sign(f))
        mv = agp.VGP.create(X, y, agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
                            agp.AnalyticVI(), optimiser=None)
        mv, sv = agp.train(mv, iterations=60)
        mg = agp.MCGP.create(X, y, agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
                             agp.GibbsSampling(n_burnin=200))
        gmean = jnp.mean(agp.sample(mg, 600, key=jax.random.PRNGKey(13)), axis=0)[0]
        corr = float(jnp.corrcoef(jnp.stack([sv.mu[0], gmean]))[0, 1])
        return corr, "> 0.95", corr > 0.95

    def mo():
        X, f = _toy(jax, jnp, 512, 2, key=14)
        y1, y2 = np.asarray(f), np.sign(np.asarray(f) - 0.2)
        m = agp.MOSVGP.create(
            agp.SqExponentialKernel(),
            [agp.GaussianLikelihood.create(0.1, opt_noise=False), agp.LogisticLikelihood.create()],
            agp.AnalyticVI(), X[:16], n_latent=2, optimiser=None)
        m, st = agp.mo_train(m, X, [y1, y2], iterations=60)
        mu, var = agp.mo_predict_f(m, st, X[:256])
        rmse = float(jnp.sqrt(jnp.mean((mu[0] - f[:256]) ** 2)))
        ok = rmse < 0.35 and bool(jnp.isfinite(mu).all() and jnp.isfinite(var).all())
        return rmse, "< 0.35, all finite", ok

    def quad_vi():
        X, f = _toy(jax, jnp, 400, 2, key=18)
        y = np.asarray(jnp.sign(f))
        m = agp.VGP.create(X, y, agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
                           agp.QuadratureVI(n_points=30, optimiser=optax.sgd(1e-3, momentum=0.9)),
                           optimiser=None)
        m, st = agp.train(m, iterations=300)
        acc = float(jnp.mean((agp.predict_y(m, st, X) > 0) == (jnp.asarray(y) > 0)))
        return acc, "> 0.9", acc > 0.9

    def nuts():
        X, f = _toy(jax, jnp, 64, 2, key=19)
        y = np.asarray(f + 0.1 * jax.random.normal(jax.random.PRNGKey(20), f.shape, dt))
        mg = agp.MCGP.create(X, y, agp.SqExponentialKernel(),
                             agp.GaussianLikelihood.create(0.01, opt_noise=False),
                             agp.HMCSampling(n_burnin=300))
        post = jnp.mean(agp.sample_nuts(mg, 700, key=jax.random.PRNGKey(21)), axis=0)[0]
        K = agp.SqExponentialKernel().gram(X, X)
        exact = K @ jnp.linalg.solve(K + 0.01 * jnp.eye(64), jnp.asarray(y))
        corr = float(jnp.corrcoef(jnp.stack([post, exact]))[0, 1])
        return corr, "> 0.95", corr > 0.95

    def proba():
        X, f = _toy(jax, jnp, 2000, 2, key=15)
        y = np.asarray(jnp.sign(f))
        m = agp.SVGP.create(agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
                            agp.AnalyticVI(), Z=X[:32], optimiser=None)
        m, st = agp.train(m, X, y, iterations=100)
        p = agp.proba_y(m, st, X[:1024])
        yy = jnp.asarray(y[:1024])
        inb = bool(jnp.all((p >= 0) & (p <= 1)))
        sep = float(jnp.mean(p[yy > 0]) - jnp.mean(p[yy < 0]))
        return sep, "> 0.3, p in [0, 1]", inb and sep > 0.3

    def real_data():
        raw = np.loadtxt(os.path.join(ROOT, "examples", "data", "breast_cancer.csv"),
                         delimiter=",", skiprows=1)
        X, y = raw[:, :-1], np.where(raw[:, -1] > 0.5, 1.0, -1.0)
        X = ((X - X.mean(0)) / X.std(0)).astype(F32)
        perm = np.random.RandomState(0).permutation(X.shape[0])
        tr, te = perm[:int(0.8 * X.shape[0])], perm[int(0.8 * X.shape[0]):]
        m = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(3.0, dt)),
                            agp.LogisticLikelihood.create(), agp.AnalyticVI(),
                            Z=X[tr][:64], optimiser=None)
        m, st = agp.train(m, X[tr], y[tr].astype(F32), iterations=30)
        acc = float(np.mean(np.asarray(agp.predict_y(m, st, X[te])) == y[te]))
        return acc, "> 0.95", acc > 0.95

    def online_hyperopt():
        from agp_tpu.inducing.algorithms import OIPS

        X, f = _toy(jax, jnp, 4096, 2, key=44)
        y = np.asarray(f + 0.05 * jax.random.normal(jax.random.PRNGKey(45), f.shape, dt))
        m = agp.OnlineSVGP.create(
            agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0, dt)),
            agp.GaussianLikelihood.create(0.05, opt_noise=False),
            agp.AnalyticVI(), n_dim=2, capacity=128, Zalg=OIPS(rho=0.95, capacity=128),
            optimiser=optax.adam(0.02), atfrequency=5)
        st = None
        for i in range(8):
            m, st = agp.online_train(m, X[i * 512:(i + 1) * 512], y[i * 512:(i + 1) * 512],
                                     state=st, iterations=25)
        ls = float(jnp.ravel(m.kernel.lengthscale)[0])
        rmse = float(jnp.sqrt(jnp.mean((agp.predict_f(m, st, X[:512]) - f[:512]) ** 2)))
        ok = rmse < 0.2 and np.isfinite(ls) and abs(ls - 2.0) > 1e-3
        return rmse, "< 0.2, lengthscale finite and moved", ok

    def mo_proba():
        X, f = _toy(jax, jnp, 2048, 2, key=46)
        y1, y2 = np.asarray(f), np.sign(np.asarray(f) - 0.2)
        m = agp.MOSVGP.create(
            agp.SqExponentialKernel(),
            [agp.GaussianLikelihood.create(0.1, opt_noise=False), agp.LogisticLikelihood.create()],
            agp.AnalyticVI(), X[:32], n_latent=2, optimiser=None)
        m, st = agp.mo_train(m, X, [y1, y2], iterations=80)
        probas = agp.mo_proba_y(m, st, X[:1024])
        p2 = probas[1]
        yy = jnp.asarray(y2[:1024])
        inb = bool(jnp.all((p2 >= 0) & (p2 <= 1)))
        sep = float(jnp.mean(p2[yy > 0]) - jnp.mean(p2[yy < 0]))
        fin = bool(jnp.isfinite(probas[0][0]).all() and jnp.isfinite(probas[0][1]).all())
        return sep, "> 0.2, p in [0, 1], regression finite", inb and fin and sep > 0.2

    return [gp_exact, svgp_logistic, svgp_hyperopt, multiclass, hetero, vstp,
            online, gibbs_cavi, mo, quad_vi, nuts, proba, real_data,
            online_hyperopt, mo_proba]


def phase_oracles(sz):
    ph = Phase(6, "accuracy oracles")
    for fn in _oracles(sz):
        t0 = time.perf_counter()
        value, limit, ok = fn()
        ph.check(f"{fn.__name__} ({time.perf_counter() - t0:.1f} s)",
                 f"{value:.4f}", bool(ok), limit)
    ph.close()


def phase_times():
    ph = Phase(7, "times (information, not a benchmark)")
    for name, t in TIMES.items():
        ph.say(f"{name}: {json.dumps(t, sort_keys=True)}")
    ph.close()


# ------------------------------------------------------------ four devices
_COLLECTIVE = re.compile(
    r"=\s*(.+?)\s+(all-gather|all-reduce|all-to-all|collective-permute|"
    r"reduce-scatter)(?:-start)?\(")


def collectives(hlo_text):
    """(op, elements) of every cross-device collective in compiled HLO
    text; an asynchronous pair counts once, at its start, with every array
    of its result type."""
    out = []
    for line in hlo_text.splitlines():
        m = _COLLECTIVE.search(line)
        if m:
            dims = re.findall(r"[a-z]\w*\[([\d,]*)\]", m.group(1))
            out.append((m.group(2), sum(
                int(np.prod([int(d) for d in ds.split(",") if d])) for ds in dims)))
    return out


def stray_collectives(hlo_text, m):
    """The collectives of a sharded CAVI step beyond the all-reduce of the
    [M] and [M, M] statistics: any gather or exchange, and any collective
    larger than both statistics twice over."""
    limit = 2 * m * (m + 1)
    return [c for c in collectives(hlo_text)
            if c[0] in ("all-gather", "all-to-all") or c[1] > limit]


def _flops(compiled):
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return (cost or {}).get("flops")


def check_sharded_work(ph, model, X, y, c, mesh, m1, s1):
    """That the sharded SVI step splits its work: its compiled program's
    collectives, its per-device flops against the same step on one device,
    and its rate beside the one-device trainer's (information)."""
    import jax

    from agp_tpu.models.base import as_2d, match_dtype
    from agp_tpu.parallel.mesh import build_svi_trainer, make_mesh
    from agp_tpu.training.train import _vi_steps

    nd, n = mesh.devices.size, 500
    steps, ms, ss, Xs, ys = build_svi_trainer(model, X, y, mesh)
    lowered = steps.lower(ms, ss, Xs, ys, n)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    ph.say(f"collectives of the compiled {nd}-device step: {collectives(hlo)}")
    stray = stray_collectives(hlo, c["M"])
    ph.check("collectives beyond the [M] + [M, M] statistics all-reduce",
             stray, not stray, "none: the minibatch is never gathered")
    in_step = "cavi_logistic_stats" in lowered.as_text()
    ph.check("Triton statistics kernel inside the GSPMD step", in_step,
             not in_step, "False: GSPMD cannot partition its custom call")
    one = build_svi_trainer(model, X, y, make_mesh(1))
    f1, fn = _flops(one[0].lower(*one[1:], n).compile()), _flops(compiled)
    ratio = fn / f1 if fn and f1 else float("nan")
    ph.check(f"per-device flops of the {nd}-device step / the same step on "
             "one device", f"{ratio:.4f}", ratio <= 1.5 / nd,
             f"<= {1.5 / nd:g}: each device runs its share of the batch")

    def rate(fn_steps, mdl, st, xa, ya):
        for _ in range(2):  # compile, then the weak-type recompile
            mdl, st = fn_steps(mdl, st, xa, ya, n)
        jax.block_until_ready(st.mu)
        t0 = time.perf_counter()
        mdl, st = fn_steps(mdl, st, xa, ya, n)
        jax.block_until_ready(st.mu)
        return n / (time.perf_counter() - t0)

    Xd = jax.device_put(as_2d(X), jax.devices()[0])
    yd = match_dtype(model.likelihood.treat_labels(y)[0], Xd)
    fused_one = "cavi_logistic_stats" in _vi_steps.lower(m1, s1, Xd, yd, n).as_text()
    r_n, r_1 = rate(steps, ms, ss, Xs, ys), rate(_vi_steps, m1, s1, Xd, yd)
    ph.say(f"steady-state steps/s at global B={c['B']}: {nd} devices "
           f"{r_n:.1f}, one device {r_1:.1f} (Triton kernel on one device: "
           f"{fused_one}; information)")


# Largest |difference| of two runs' posterior means, in Monte-Carlo
# standard errors, over all points: about 1e-6 per point beyond 5 for a
# normal z, so a few hundred points pass when the runs sample one posterior.
MC_Z_LIMIT = 5.0


def posterior_mean_z(a, b, batch):
    """Two Gibbs runs' samples `a`, `b` [chains, samples, points]: the
    largest |mean(a) - mean(b)| over points in units of the Monte-Carlo
    standard error, from batch means of `batch` consecutive samples of
    each chain, and the largest |mean(a) - mean(b)|."""
    def mean_and_se(k):
        bm = k.reshape(-1, batch, k.shape[-1]).mean(1)
        return bm.mean(0), bm.std(0, ddof=1) / np.sqrt(bm.shape[0])

    (m_a, se_a), (m_b, se_b) = mean_and_se(a), mean_and_se(b)
    z = np.abs(m_a - m_b) / np.sqrt(se_a ** 2 + se_b ** 2)
    return float(np.max(z)), float(np.max(np.abs(m_a - m_b)))


def check_gibbs_chains(ph, mesh):
    """Chain-sharded Gibbs against the same chains on one device.  The two
    programs draw the same random numbers, so their paths agree up to
    rounding until a Polya-Gamma accept test lands on the other side of
    a rounded value; from there the paths differ and only the posteriors
    can be compared, within Monte-Carlo error."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import agp_tpu as agp
    from agp_tpu.models.mcgp import _gibbs_chains

    nd = mesh.devices.size
    C, S, burn, batch = 2 * nd, 1000, 200, 100
    Xg = jax.random.normal(jax.random.PRNGKey(5), (256, 4), jnp.float32)
    yg = np.asarray(jnp.sign(Xg[:, 0]))
    mg = agp.MCGP.create(Xg, yg, agp.SqExponentialKernel(),
                         agp.LogisticLikelihood.create(),
                         agp.GibbsSampling(n_burnin=burn))
    keys = jax.random.split(jax.random.PRNGKey(6), C)
    keys_sh = jax.device_put(keys, NamedSharding(mesh, P("data")))
    first = [np.asarray(_gibbs_chains(mg, k, 8, 0, 1)) for k in (keys_sh, keys)]
    gap = np.max(np.abs(first[0] - first[1]), axis=(0, 2, 3))
    ph.say("chain-sharded vs one-device paths, max |diff| of f at sweeps "
           "1-8: " + ", ".join(f"{g:.2e}" for g in gap))
    ph.check("first sweep, chain-sharded vs one-device f, max |diff|",
             f"{gap[0]:.2e}", gap[0] <= 1e-3,
             "<= 1e-3: same keys, so the draws differ by rounding only")

    kept_sh = _gibbs_chains(mg, keys_sh, S, burn, 1)
    kept_one = _gibbs_chains(mg, keys, S, burn, 1)
    g_devs = {s.device for s in kept_sh.addressable_shards}
    ph.check("devices holding Gibbs chains", len(g_devs), len(g_devs) == nd,
             f"== {nd}")
    a, b = np.asarray(kept_sh)[:, :, 0], np.asarray(kept_one)[:, :, 0]
    apart = min(np.max(np.abs(a[i] - a[j]))
                for i in range(C) for j in range(i + 1, C))
    ph.check(f"{C} sharded chains, smallest max |diff| between two chains' "
             "paths", f"{apart:.3f}", apart > 0.1, "> 0.1: every chain has "
             "its own key")

    z, gap = posterior_mean_z(a, b, batch)
    ph.check(f"posterior means of f at {a.shape[-1]} points, chain-sharded "
             "vs one device, max |diff| / Monte-Carlo standard error",
             f"{z:.3f} (max |diff| {gap:.2e})", z <= MC_Z_LIMIT,
             f"<= {MC_Z_LIMIT:g}: standard errors from batch means of "
             f"{batch} sweeps, {C * S // batch} per run")


def phase_multi(sz):
    """The sharded paths on every device, each against one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import agp_tpu as agp
    from agp_tpu.inference.analytic_vi import variational_update
    from agp_tpu.parallel.mesh import make_mesh, sharded_svi_train, sharded_train
    from agp_tpu.reference import max_rel_err
    from agp_tpu.training.train import init_state

    ph = Phase("multi", "sharded paths against one device")
    devs = jax.devices()
    nd = len(devs)
    mesh = make_mesh(nd)
    c = sz.multi
    X, y = linear_labels(c["N"] + 50_000, c["D"], SEED + 10)
    Xtr, ytr, Xte, yte = X[:c["N"]], y[:c["N"]], X[c["N"]:], y[c["N"]:]
    m = svgp(agp, jnp, agp.LogisticLikelihood.create(), Xtr[:c["M"]], c["B"],
             jnp.float32)
    t0 = time.perf_counter()
    ms, ss = sharded_svi_train(m, Xtr, ytr, iterations=c["iters"], mesh=mesh)
    jax.block_until_ready(ss.mu)
    ph.say(f"sharded_svi_train on {nd} devices, N={c['N']}, global B={c['B']}: "
           f"{c['iters']} iterations in {time.perf_counter() - t0:.1f} s "
           "(compile included)")
    m1, s1 = agp.train(m, Xtr, ytr, iterations=c["iters"])
    acc_s = float(np.mean(np.asarray(agp.predict_y(ms, ss, Xte)) == yte))
    acc_1 = float(np.mean(np.asarray(agp.predict_y(m1, s1, Xte)) == yte))
    ph.check("sharded vs one-device held-out accuracy", f"{acc_s:.4f} vs "
             f"{acc_1:.4f}", abs(acc_s - acc_1) <= ACC_TOL,
             f"|diff| <= {ACC_TOL}")
    f_s = np.asarray(agp.predict_f(ms, ss, Xte[:10_000]))
    f_1 = np.asarray(agp.predict_f(m1, s1, Xte[:10_000]))
    corr = float(np.corrcoef(f_s.ravel(), f_1.ravel())[0, 1])
    ph.check("sharded vs one-device posterior predictive mean, correlation "
             "on 10,000 held-out points", f"{corr:.5f}", corr >= 0.99,
             ">= 0.99: the two training loops draw different minibatches")
    check_sharded_work(ph, m, Xtr, ytr, c, mesh, m1, s1)

    # full-batch GSPMD step: the same data on every path, so it must agree
    # with one device up to the order of the psum
    n_fb = 16_384 if not sz.rehearse else 512
    mf = svgp(agp, jnp, agp.LogisticLikelihood.create(), Xtr[:c["M"]], 0,
              jnp.float32)
    mf = mf.replace(inference=agp.AnalyticVI())
    _, s_sh = sharded_train(mf, Xtr[:n_fb], ytr[:n_fb], iterations=10, mesh=mesh)
    _, s_1 = agp.train(mf, Xtr[:n_fb], ytr[:n_fb], iterations=10)
    e = max(max_rel_err(s_sh.mu, s_1.mu), max_rel_err(s_sh.Sigma, s_1.Sigma))
    ph.check(f"full-batch sharded_train vs train, N={n_fb}, 10 iterations, "
             "max rel err (mu, Sigma)", f"{e:.3e}", e <= STEP_TOL_LARGE_M,
             f"<= {STEP_TOL_LARGE_M:g}: same data, psum order differs")

    # latent-sharded multiclass step, K=10, M=64
    K, M, N = 10, 64, 8 * 512
    mesh2 = Mesh(np.asarray(devs).reshape(nd // 2, 2), ("data", "latent"))
    Xm, ym = multiclass_data(dict(N=N, D=10, K=K), SEED + 11)
    mm = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(2.0, jnp.float32)),
                         agp.LogisticSoftMaxLikelihood.create(K), agp.AnalyticVI(),
                         jnp.asarray(Xm[:M]), optimiser=None)
    yh, tl = mm.likelihood.treat_labels(ym)
    mm = mm.replace(likelihood=tl)
    Xd, yd = jnp.asarray(Xm), jnp.asarray(yh, jnp.float32)
    st = init_state(mm, Xd, yd)
    step = jax.jit(variational_update)
    _, s_one = step(mm, st, Xd, yd)
    data, lat = NamedSharding(mesh2, P("data")), NamedSharding(mesh2, P("latent"))
    st_sh = st.replace(
        eta1=jax.device_put(st.eta1, lat), eta2=jax.device_put(st.eta2, lat),
        mu=jax.device_put(st.mu, lat), Sigma=jax.device_put(st.Sigma, lat),
        kmat={k: jax.device_put(v, lat) for k, v in st.kmat.items()})
    mm_sh = mm.replace(Z=jax.device_put(mm.Z, lat))
    _, s_sh = step(mm_sh, st_sh, jax.device_put(Xd, data), jax.device_put(yd, data))
    e = max_rel_err(s_sh.mu, s_one.mu)
    ph.check(f"latent-sharded multiclass step (K={K}, M={M}) vs one device, "
             "max rel err mu", f"{e:.3e}", e <= 1e-3,
             "<= 1e-3: same step, reduction order differs")
    lat_devs = {s.device for s in s_sh.mu.addressable_shards}
    ph.check("devices holding the multiclass posterior", len(lat_devs),
             len(lat_devs) == nd, f"== {nd}")

    check_gibbs_chains(ph, mesh)
    ph.close()


def main(argv):
    rehearse = "--rehearse" in argv
    if "--cpu-reference" in argv:
        cpu_reference(argv[argv.index("--cpu-reference") + 1], rehearse)
        return 0
    import jax

    import agp_tpu

    here = os.path.join(ROOT, "agp_tpu")
    if os.path.dirname(os.path.abspath(agp_tpu.__file__)) != here:
        raise SmokeFailure(f"agp_tpu imported from {agp_tpu.__file__}, not {here}")
    sz = Sizes(rehearse)
    devs = phase_device(rehearse)
    if "--multi" in argv:
        if len(devs) < 4 and not rehearse:
            raise SmokeFailure(f"--multi needs 4 devices, found {len(devs)}")
        phase_multi(sz)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            proc, out = start_cpu_reference(tmp, rehearse)
            try:
                phase_probe(sz)
                cref = {}

                def wait():
                    cref.update(finish_cpu_reference(proc, out))
                    return cref

                phase_flagship(sz, wait)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        phase_large_m(sz)
        phase_multilatent(sz, cref)
        phase_sampling(sz)
        phase_oracles(sz)
        phase_times()
    if rehearse:
        print("rehearsal complete: every phase ran; no result line on a rehearsal")
        return 0
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
