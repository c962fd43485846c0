"""
Moved: the temporal-parallel (associative-scan) Kalman likelihood now
lives in `bild_jax.experimental.assoc_kalman` (demoted from the production
ops namespace in round 5 — the sequential batched kernels win at every
configuration measurable on this hardware; measurements in the module
docstring). This shim keeps old imports working.
"""
from ..experimental.assoc_kalman import msrouse_logL_assoc  # noqa: F401

__all__ = ["msrouse_logL_assoc"]
