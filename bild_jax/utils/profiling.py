"""
Tracing / numerics debugging aids (SURVEY.md section 5 auxiliary subsystems).

The reference's only analysis aid is Cython annotated HTML (`make yellow`);
its numerical-sanitizer discipline is ``np.seterr(all='raise')`` in tests.
The JAX equivalents:

- `trace(logdir)`: context manager around the JAX profiler — produces a
  TensorBoard/XProf trace of device execution.
- `strict_numerics()`: context manager enabling ``jax_debug_nans`` and
  ``jax_debug_infs`` — jitted functions re-run op-by-op when a NaN/Inf
  appears and raise at the producing primitive (the ``np.seterr`` analog).
"""
from __future__ import annotations

import contextlib

import jax

__all__ = ["trace", "strict_numerics"]


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profile everything inside the block to ``logdir`` (view with
    TensorBoard's profile plugin or xprof)."""
    jax.profiler.start_trace(logdir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def strict_numerics(nans: bool = True, infs: bool = False):
    """
    Raise on NaN (and optionally Inf) production inside jitted code.

    NB: several AMIS quantities are legitimately infinite (log-densities of
    impossible states, the Dirichlet boundary singularity), so ``infs``
    defaults to False. Intended for debugging kernels and models; the AMIS
    ensemble update itself produces where-guarded NaN intermediates by
    design (0 * inf in the KL accumulator, reference ``bild/amis.py:885-898``)
    and will false-positive under this flag.
    """
    old_nans = jax.config.jax_debug_nans
    old_infs = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nans)
        jax.config.update("jax_debug_infs", old_infs)
