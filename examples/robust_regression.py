"""Robust regression with a Student-t likelihood + kernel autotuning."""
import os

import jax

if os.environ.get("AGP_EXAMPLES_CPU", "1") == "1":
    # tiny didactic workloads: the local CPU beats an accelerator's
    # compile and dispatch; AGP_EXAMPLES_CPU=0 keeps the default backend
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
import agp_tpu as agp

X = jnp.linspace(0, 6, 200)[:, None]
y = jnp.sin(X[:, 0]) + 0.1 * np.random.RandomState(0).standard_t(3, 200)

model = agp.VGP.create(X, np.asarray(y), agp.Matern52Kernel(),
                       agp.StudentTLikelihood.create(3.0), agp.AnalyticVI())
model, state = agp.train(model, iterations=100)
mu, var = agp.predict_f(model, state, X, cov=True)
print("rmse:", float(jnp.sqrt(jnp.mean((mu - jnp.sin(X[:, 0])) ** 2))))
print("learned lengthscale:", float(model.kernel.lengthscale[0]))
