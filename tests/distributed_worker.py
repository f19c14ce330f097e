"""Worker process for the two-process jax.distributed CPU test.

Launched by tests/test_parallel.py::test_two_process_distributed as
  python tests/distributed_worker.py <pid> <nproc> <coordinator> <outdir>

Each process exposes 2 virtual CPU devices (XLA_FLAGS set by the launcher),
rendezvouses through `agp_tpu.parallel.mesh.initialize_distributed`, builds
a GLOBAL (2 proc x 2 dev) data mesh, trains an SVGP on globally-sharded
data with the GSPMD data-parallel step, and writes the resulting posterior
to <outdir>/proc<pid>.npz for the launcher to compare across processes and
against a single-process run.
"""
import json
import os
import sys

# the worker is launched as a script from tests/: put the repo root on the
# path so `import agp_tpu` resolves regardless of the launcher's environment
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coord = sys.argv[3]
    outdir = sys.argv[4]

    import jax

    # a CPU test: pin the CPU before any device use
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from agp_tpu.parallel.mesh import initialize_distributed, data_parallel_step

    mesh = None
    initialize_distributed(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.process_count() == nproc, jax.process_count()
    n_local = jax.local_device_count()
    n_global = jax.device_count()
    assert n_global == nproc * n_local, (n_global, n_local)

    import agp_tpu as agp
    from agp_tpu.parallel.mesh import make_mesh
    from agp_tpu.training.train import init_state

    mesh = make_mesh()

    # identical deterministic data on every process
    rng = np.random.default_rng(0)
    N, D, M = 64, 2, 8
    X = rng.uniform(-2.0, 2.0, (N, D))
    f = np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
    y = np.where(f > 0, 1.0, -1.0)

    model = agp.SVGP.create(
        agp.SqExponentialKernel(),
        agp.LogisticLikelihood.create(),
        agp.AnalyticVI(),
        Z=X[:M],
        optimiser=None,
    )
    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y2 = np.asarray(y2, dtype=X.dtype)

    data_sh = NamedSharding(mesh, P("data"))
    repl_sh = NamedSharding(mesh, P())

    def globalize(arr, sharding):
        arr = np.asarray(arr)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    Xg = globalize(X, NamedSharding(mesh, P("data", None)))
    yg = globalize(y2, data_sh)

    state = init_state(model, jnp.asarray(X), jnp.asarray(y2))
    model, state = jax.tree_util.tree_map(
        lambda x: globalize(x, repl_sh), (model, state)
    )

    step = data_parallel_step(mesh)
    for _ in range(10):
        model, state = step(model, state, Xg, yg)

    mu = np.asarray(state.mu)  # fully replicated -> addressable everywhere
    Sigma = np.asarray(state.Sigma)
    np.savez(os.path.join(outdir, f"proc{pid}.npz"), mu=mu, Sigma=Sigma)
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as fh:
        json.dump(
            {
                "process_count": jax.process_count(),
                "global_devices": n_global,
                "local_devices": n_local,
            },
            fh,
        )


if __name__ == "__main__":
    main()
