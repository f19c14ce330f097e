"""BASELINE config #5: heteroscedastic two-GP regression + online/streaming
inducing-point updates."""
import os

import jax

if os.environ.get("AGP_EXAMPLES_CPU", "1") == "1":
    # tiny didactic workloads: the local CPU beats an accelerator's
    # compile and dispatch; AGP_EXAMPLES_CPU=0 keeps the default backend
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
import agp_tpu as agp

# --- heteroscedastic: noise level driven by a second GP ---
X = jnp.linspace(0, 6, 300)[:, None]
f = jnp.sin(X[:, 0])
g = 2.0 * jnp.cos(X[:, 0] / 2.0)          # log-precision-ish latent
noise_sd = 1.0 / jnp.sqrt(5.0 * jax.nn.sigmoid(g))
y = np.asarray(f + noise_sd * jax.random.normal(jax.random.PRNGKey(0), f.shape))

het = agp.VGP.create(X, y, agp.SqExponentialKernel(), agp.HeteroscedasticLikelihood.create(5.0),
                     agp.AnalyticVI(), optimiser=None)
het, hstate = agp.train(het, iterations=50)
mu, var = agp.proba_y(het, hstate, X)
print(f"hetero rmse={float(jnp.sqrt(jnp.mean((mu - f)**2))):.3f}; "
      f"pred-noise tracks truth corr="
      f"{float(jnp.corrcoef(jnp.sqrt(var - 0*var.min()), noise_sd)[0,1]):.3f}")

# --- streaming: inducing set grows as batches arrive ---
om = agp.OnlineSVGP.create(agp.SqExponentialKernel(), agp.GaussianLikelihood.create(0.05, opt_noise=False),
                           agp.AnalyticVI(), n_dim=1, capacity=64)
state = None
for i in range(6):
    xb, yb = X[i*50:(i+1)*50], np.asarray(f)[i*50:(i+1)*50]
    om, state = agp.online_train(om, xb, yb, state=state, iterations=8)
    print(f"batch {i}: active inducing = {int(om.z_mask[0].sum())}")
mu = agp.predict_f(om, state, X)
print(f"online rmse={float(jnp.sqrt(jnp.mean((mu - f)**2))):.4f}")
