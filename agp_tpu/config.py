"""Global numeric configuration for the augmented-GP engine.

Mirrors the dtype-scaled jitter policy of the reference
(/root/reference/src/functions/utils.jl:4-13) but is otherwise an independent,
functional JAX design: no global mutable state enters jitted computations --
everything here is static (Python-level) configuration resolved at trace time.
"""
from __future__ import annotations

import jax.numpy as jnp

# Dtype-scaled jitter added to every kernel-matrix Cholesky
# (reference: functions/utils.jl:8-13).
_JITTER = {
    jnp.dtype(jnp.float64): 1e-4,
    jnp.dtype(jnp.float32): 1e-3,
    jnp.dtype(jnp.float16): 1e-2,
    jnp.dtype(jnp.bfloat16): 1e-2,
}


def jitter(dtype) -> float:
    """Return the numerical jitter used for the given dtype."""
    return _JITTER.get(jnp.dtype(dtype), 1e-3)


def default_dtype():
    """Default floating dtype: float64 when x64 is enabled, else float32."""
    return jnp.asarray(1.0).dtype
