"""
Test harness config: run on a virtual 8-device CPU mesh with float64 enabled
(CPU is the parity oracle). Tests marked ``card`` need a CUDA card: they
request the ``card`` fixture, which skips them here. ``chip_smoke.py`` runs
them on the card with ``BILD_TEST_CARD=1``, which keeps JAX's default
backend and dtypes.

Must set env vars before jax is imported anywhere.
"""
import os
import sys

# optional line coverage (COV=1): must start before the package is imported
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import simplecov  # noqa: E402
simplecov.start_from_env()

ON_CARD = os.environ.get("BILD_TEST_CARD") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_CARD and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# strict-FP discipline for all host-side numpy code, mirroring the
# reference's test posture (reference tests/test_bild.py:10): any unguarded
# overflow/underflow/invalid in library numpy code fails the test. Library
# code uses targeted np.errstate guards where infinities are intentional.
np.seterr(all="raise")


@pytest.fixture
def card():
    """Skip unless JAX's default device is a CUDA card (decided at run
    time, never at import: every xdist worker must collect the same
    tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA card; `python chip_smoke.py` runs it there")


@pytest.fixture
def rng():
    return np.random.default_rng(685441950)


def logsumexp_safe(*args, **kwargs):
    """scipy logsumexp with benign underflow ignored (strict-FP posture)."""
    from scipy.special import logsumexp as _lse
    with np.errstate(under="ignore"):
        return _lse(*args, **kwargs)
