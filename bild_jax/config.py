"""
Global configuration helpers for bild_jax.

The framework is dtype-polymorphic: on an accelerator it defaults to float32
with ``jax.lax.Precision.HIGHEST`` products (IEEE fp32, never TF32); for
CPU-oracle parity testing the test-suite enables float64 via
``jax.config.update('jax_enable_x64', True)`` and everything follows along.
"""
from __future__ import annotations

import os

import jax
import numpy as np

__all__ = ["fdtype", "idtype", "MATMUL_PRECISION", "enable_compilation_cache"]

# Precision for the small dense products in the Kalman recursion. These are
# numerically load-bearing (covariance propagation): one reduced-precision
# pass (TF32 on a GPU) costs ~1e-2 relative error at T=100, so always ask
# for full fp32.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST

# the checkout root (parent of the package): the compile cache's fixed home
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compilation_cache() -> str:
    """Enable JAX's persistent on-disk compilation cache.

    The cache lives in ``JAX_COMPILATION_CACHE_DIR`` when that is set, and
    otherwise in ``.jax_cache/`` at the checkout root: a fixed path, because
    the path is part of the cache key. Returns the directory in effect.

    Compiles of 0.2 s and up are kept (JAX's default threshold is higher),
    so that the small helper programs (trajectory generation, informed-init
    DP, eager gathers) are cached too and a second process starts warm.

    Known interaction: with a ``sys.monitoring`` line tracer active (e.g.
    ``COV=1`` test runs) the CPU-backend executable-serialization path can
    abort the process (``Fatal Python error: Aborted`` inside
    ``put_executable_and_time``; CPython 3.12 + XLA). Don't enable the
    persistent cache under a coverage tracer; the suite doesn't.
    """
    cache_dir = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                 or os.path.join(_ROOT, ".jax_cache"))
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return cache_dir


def fdtype():
    """Canonical float dtype: float64 iff x64 is enabled, else float32."""
    return jax.dtypes.canonicalize_dtype(np.float64)


def idtype():
    """Canonical int dtype: int64 iff x64 is enabled, else int32."""
    return jax.dtypes.canonicalize_dtype(np.int64)
