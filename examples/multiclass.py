"""Multiclass GP classification with the conjugate logistic-softmax
augmentation (BASELINE config #4)."""
import os

import jax

if os.environ.get("AGP_EXAMPLES_CPU", "1") == "1":
    # tiny didactic workloads: the local CPU beats an accelerator's
    # compile and dispatch; AGP_EXAMPLES_CPU=0 keeps the default backend
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
import agp_tpu as agp

key = jax.random.PRNGKey(0)
X = jax.random.normal(key, (600, 4))
W = jax.random.normal(jax.random.PRNGKey(1), (4, 5))
y = np.asarray(jnp.argmax(X @ W, axis=1))   # 5 classes

model = agp.SVGP.create(
    agp.SqExponentialKernel(), agp.LogisticSoftMaxLikelihood.create(5),
    agp.AnalyticSVI(128), Z=X[:48],
)
model, state = agp.train(model, X, y, iterations=300)
acc = float(jnp.mean(agp.predict_y(model, state, X) == jnp.asarray(y)))
probs = agp.proba_y(model, state, X[:5])
print(f"accuracy: {acc:.3f} (chance 0.2)")
print("class probabilities for 5 points:\n", np.asarray(probs).round(3))
