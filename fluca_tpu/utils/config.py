"""Global numeric and compilation configuration.

The reference builds with PETSc double precision everywhere. On the
GPU, float32 is the performant width (float64 runs at a fraction of
the rate), so the compute dtype is configurable: float32 by default,
float64 for verification runs on the CPU (tests enable
``jax_enable_x64``).
"""

import os

import jax
import jax.numpy as jnp

# root of the checkout (this file is fluca_tpu/utils/config.py)
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_DTYPE_NAMES = {
    "float32": jnp.float32,
    "f32": jnp.float32,
    "float64": jnp.float64,
    "f64": jnp.float64,
    "bfloat16": jnp.bfloat16,
    "bf16": jnp.bfloat16,
}

_default_dtype = None


def default_dtype():
    """Compute dtype for field data and stencil coefficients."""
    global _default_dtype
    if _default_dtype is None:
        name = os.environ.get("FLUCA_TPU_DTYPE", "float32")
        _default_dtype = _DTYPE_NAMES[name]
    return _default_dtype


def set_default_dtype(dtype):
    global _default_dtype
    if isinstance(dtype, str):
        dtype = _DTYPE_NAMES[dtype]
    _default_dtype = dtype


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX
    as it is; otherwise the cache is ``<checkout>/.jax_cache``, a fixed
    path, so later runs from the same checkout hit it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
