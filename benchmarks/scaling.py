"""Control-flow scaling check of the sharded CAVI training loops, CPU only.

The BASELINE scale target: SVGP + Logistic + AnalyticSVI on 1M points,
>=80% scaling efficiency at >=2 hosts.  This script never opens an
accelerator: it runs on virtual CPU devices and CPU worker processes, so
its numbers are CPU timings, not device metrics.  The multi-GPU path is
checked by `python chip_smoke.py --multi`.

  1. `--mode virtual`  -- 1/2/4/8 virtual CPU devices (GSPMD SVI scan,
     shard_map draw + psum'd statistics, and the full-batch GSPMD path),
     plus the single-device `_vi_steps` scan as the n=1 anchor.  NOTE: the
     virtual devices TIME-SHARE the host's physical cores, so per-device
     throughput necessarily falls with device count; what this mode
     proves is (a) the sharded program compiles/runs at every mesh size,
     (b) the n=1 sharded driver is within a few % of the single-device
     scan (no driver overhead), and (c) step time under STRONG scaling
     (fixed global batch) stays ~flat as devices grow on a fixed core
     budget -- i.e. partitioning adds no superlinear overhead.
  2. `--mode twoproc`  -- a real 2-process jax.distributed run
     (rendezvous over localhost) timing the same chunked training loop.

Run: python benchmarks/scaling.py --mode virtual --out <file>.json
     (repeat with the other mode; results merge into the same JSON)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def time_steps(steps, model, state, Xs, ys, chunk, reps):
    """Time `reps` chunked dispatches of `chunk` fused steps each."""
    import jax

    model, state = steps(model, state, Xs, ys, chunk)  # compile + warm
    model, state = steps(model, state, Xs, ys, chunk)  # steady-state dtypes
    jax.block_until_ready(state.mu)
    t0 = time.perf_counter()
    for _ in range(reps):
        model, state = steps(model, state, Xs, ys, chunk)
    jax.block_until_ready(state.mu)
    dt = time.perf_counter() - t0
    return chunk * reps / dt  # iters/s


def _build_model(M, D, batchsize, sampling="slice"):
    import jax.numpy as jnp
    import numpy as np

    import agp_tpu as agp

    rng = np.random.default_rng(0)
    Z = rng.standard_normal((M, D)).astype(np.float32)
    return agp.SVGP.create(
        agp.SqExponentialKernel(),
        agp.LogisticLikelihood.create(),
        agp.AnalyticSVI(batchsize, minibatch_sampling=sampling),
        jnp.asarray(Z),
        optimiser=None,
    )


def _data(N, D):
    import numpy as np

    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    y = np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)
    return X, y


def mode_virtual(args):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from agp_tpu.parallel.mesh import (
        _dp_steps,
        build_svi_trainer,
        make_mesh,
        replicate,
        shard_batch,
    )
    from agp_tpu.training.train import _vi_steps, init_state

    M, D, bpd = args.m, args.d, args.batch_per_device
    N = args.n
    X, y = _data(N, D)
    out = {"physical_cores": os.cpu_count(), "M": M, "D": D, "N": N}

    # --- n=1 anchor: single-device scan vs mesh-of-1 sharded driver ------
    model = _build_model(M, D, bpd, args.sampling)
    y2, lik = model.likelihood.treat_labels(y)
    model1 = model.replace(likelihood=lik)
    state1 = init_state(model1, jnp.asarray(X), jnp.asarray(y2))
    sd = time_steps(
        lambda m, s, Xs, ys, n: _vi_steps(m, s, Xs, ys, n),
        model1, state1, jnp.asarray(X), jnp.asarray(y2), args.chunk, args.reps,
    )
    out["single_device_scan_iters_per_s"] = sd

    rows = []
    for c in (1, 2, 4, 8):
        mesh = make_mesh(c)
        steps, m2, s2, Xs, ys = build_svi_trainer(
            _build_model(M, D, bpd * c, args.sampling), X, y, mesh,
            batch_per_device=bpd,
        )
        it = time_steps(steps, m2, s2, Xs, ys, args.chunk, args.reps)
        rows.append(
            {"devices": c, "iters_per_s": it, "global_batch": bpd * c,
             "weak_per_device_vs_n1": None}
        )
        print(f"[virtual svi weak] devices={c} iters/s={it:.0f}")
    base = rows[0]["iters_per_s"]
    for r in rows:
        r["weak_per_device_vs_n1"] = r["iters_per_s"] / base
    out["svi_weak_scaling"] = rows
    out["driver_vs_single_device_n1"] = rows[0]["iters_per_s"] / sd

    # --- strong scaling: fixed global batch ------------------------------
    gbatch = bpd * 8
    srows = []
    for c in (1, 2, 4, 8):
        mesh = make_mesh(c)
        steps, m2, s2, Xs, ys = build_svi_trainer(
            _build_model(M, D, gbatch, args.sampling), X, y, mesh,
            batch_per_device=gbatch // c,
        )
        it = time_steps(steps, m2, s2, Xs, ys, args.chunk, args.reps)
        srows.append({"devices": c, "iters_per_s": it, "global_batch": gbatch})
        print(f"[virtual svi strong] devices={c} iters/s={it:.0f}")
    out["svi_strong_scaling_fixed_global_batch"] = srows

    # --- full-batch GSPMD path (sharded_train internals) ------------------
    Nfb = 4096
    Xf, yf = _data(Nfb, D)
    frows = []
    for c in (1, 8):
        mesh = make_mesh(c)
        model = _build_model(M, D, Nfb)
        y2, lik = model.likelihood.treat_labels(yf)
        model = model.replace(likelihood=lik)
        import dataclasses

        model = model.replace(
            inference=dataclasses.replace(model.inference, stochastic=False)
        )
        Xs, ys, mask = shard_batch(mesh, Xf, jnp.asarray(y2, jnp.float32),
                                   with_mask=True)
        st = init_state(model, Xs, ys)
        model_r, st = replicate(mesh, (model, st))
        steps = lambda m, s, XX, yy, n: _dp_steps(m, s, XX, yy, None, n)
        it = time_steps(steps, model_r, st, Xs, ys, args.chunk, args.reps)
        frows.append({"devices": c, "iters_per_s": it, "N": Nfb})
        print(f"[virtual fullbatch] devices={c} iters/s={it:.0f}")
    out["fullbatch_gspmd"] = frows

    out["note"] = (
        "8 virtual CPU devices time-share %d physical cores: per-device "
        "throughput MUST fall with device count here; see the module "
        "docstring for what this mode does and does not prove."
        % (os.cpu_count() or 0)
    )
    return {"virtual_cpu": out}


def mode_twoproc(args):
    """Real 2-process jax.distributed run over localhost; each process
    hosts 1 virtual CPU device.  Efficiency vs a 1-process run of the same
    per-device work (weak scaling)."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    results = {}
    for nproc in (1, 2):
        procs = []
        for pid in range(nproc):
            env = dict(os.environ)
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
            env["JAX_PLATFORMS"] = "cpu"  # workers never open a GPU
            env["CUDA_VISIBLE_DEVICES"] = ""
            env["JAX_COMPILATION_CACHE_DIR"] = ""
            cmd = [
                sys.executable, os.path.abspath(__file__), "--mode", "worker",
                "--coordinator", coord if nproc > 1 else "none",
                "--num-processes", str(nproc), "--process-id", str(pid),
                "--m", str(args.m), "--d", str(args.d), "--n", str(args.n),
                "--batch-per-device", str(args.batch_per_device),
                "--chunk", str(args.chunk), "--reps", str(args.reps),
            ]
            procs.append(
                subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            )
        outs = [p.communicate(timeout=900)[0].decode() for p in procs]
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{o[-4000:]}")
        line = [l for l in outs[0].splitlines() if l.startswith("WORKER_RESULT ")][-1]
        results[nproc] = json.loads(line[len("WORKER_RESULT "):])
        print(f"[twoproc] procs={nproc} iters/s={results[nproc]['iters_per_s']:.0f}")
    eff = results[2]["iters_per_s"] / results[1]["iters_per_s"] * 100.0
    return {
        "two_process": {
            "per_device_batch": args.batch_per_device,
            "one_process_iters_per_s": results[1]["iters_per_s"],
            "two_process_iters_per_s": results[2]["iters_per_s"],
            "weak_efficiency_pct": eff,
            "note": "2 OS processes x 1 virtual CPU device, jax.distributed "
            "rendezvous over localhost; both processes share the same "
            "physical cores, so this validates the multi-process program + "
            "collectives, not hardware efficiency.",
        }
    }


def mode_worker(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.coordinator != "none":
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from agp_tpu.parallel.mesh import _make_svi_steps, make_mesh, sharded_svi_step
    from agp_tpu.training.train import init_state

    M, D, bpd = args.m, args.d, args.batch_per_device
    X, y = _data(args.n, D)
    model = _build_model(M, D, bpd * args.num_processes, "gather")
    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    mesh = make_mesh()
    n_dev = mesh.devices.size

    def globalize(arr, spec):
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
        )

    Xs = globalize(X, P("data", None))
    ys = globalize(np.asarray(y2, np.float32), P("data"))
    state = init_state(model, jnp.asarray(X), jnp.asarray(np.asarray(y2)))
    state = state.replace(rho=jnp.asarray(args.n / (bpd * n_dev), jnp.float32))
    model, state = jax.tree_util.tree_map(
        lambda x: globalize(np.asarray(x), P()), (model, state)
    )
    step = sharded_svi_step(mesh, bpd)
    steps = _make_svi_steps(step.body)
    it = time_steps(steps, model, state, Xs, ys, args.chunk, args.reps)
    if jax.process_index() == 0:
        print("WORKER_RESULT " + json.dumps({"iters_per_s": it,
                                             "devices": n_dev}))
    return {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True,
                    choices=["virtual", "twoproc", "worker"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--batch-per-device", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sampling", default="slice", choices=["slice", "gather"])
    ap.add_argument("--coordinator", default="none")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args()

    fn = {"virtual": mode_virtual, "twoproc": mode_twoproc,
          "worker": mode_worker}[args.mode]
    result = fn(args)
    if args.mode == "worker" or not result:
        return
    merged = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            merged = json.load(fh)
    merged.update(result)
    with open(args.out, "w") as fh:
        json.dump(merged, fh, indent=1)
    print(json.dumps({"wrote": args.out, "keys": sorted(merged)}))


if __name__ == "__main__":
    main()
