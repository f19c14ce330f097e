"""Binary GP classification with Polya-Gamma augmented CAVI (mirrors the
reference's classification example)."""
import os

import jax

if os.environ.get("AGP_EXAMPLES_CPU", "1") == "1":
    # tiny didactic workloads: the local CPU beats an accelerator's
    # compile and dispatch; AGP_EXAMPLES_CPU=0 keeps the default backend
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
import agp_tpu as agp

key = jax.random.PRNGKey(0)
X = jax.random.uniform(key, (500, 2)) * 4 - 2
f = jnp.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
y = np.asarray(jnp.where(f > 0, 1, 0))

model = agp.SVGP.create(
    agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
    agp.AnalyticSVI(64), Z=X[:32],
)
model, state = agp.train(model, X, y, iterations=300)
acc = float(jnp.mean((agp.predict_y(model, state, X) > 0) == (jnp.asarray(y) > 0)))
print(f"train accuracy: {acc:.3f}")
