"""`ops.kalman_sqrt`: the square-root (Cholesky-factor) validation kernel —
algebraic equivalence to the standard filter, and the f32 parity gain that
settles the BASELINE.md 1e-6 north star (DESIGN.md section 7h)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bild_jax.models import MultiStateRouse
from bild_jax.ops.kalman import msrouse_logL_batch
from bild_jax.ops.kalman_sqrt import msrouse_logL_sqrt
from bild_jax.ops.oracle import msrouse_logL_numpy


def _parity_case(rng, P=8, T=100):
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    truth = np.zeros(T, dtype=int)
    truth[T // 3: T // 2] = 1
    truth[3 * T // 4: 9 * T // 10] = 1
    traj = model.trajectory_from_loopingprofile(
        truth, missing_frames=[7, T // 2, T // 2 + 1],
        key=jax.random.key(42))
    profiles = rng.integers(0, 2, size=(P, T))
    s2, Cind = model._noise_arrays(traj)
    args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
            model.w, s2, Cind, jnp.asarray(profiles), traj.data, traj.valid)
    oracle = np.array([
        msrouse_logL_numpy(*(np.asarray(x, dtype=np.float64) for x in
                             (model.Bs, model.Gs, model.Sigs, model.M0s,
                              model.C0s, model.w)),
                           model._get_noise(traj), p, traj[:])
        for p in profiles])
    return args, oracle


def test_sqrt_matches_oracle_f64(rng):
    """In f64 the sqrt form is algebraically the same filter: parity at
    rounding level, including missing frames."""
    args, oracle = _parity_case(rng)
    got = np.asarray(msrouse_logL_sqrt(*args))
    np.testing.assert_allclose(got, oracle, rtol=1e-12)


def test_sqrt_f32_meets_north_star(rng):
    """f32 sqrt-form parity vs the f64 oracle is within 1e-6 relative at the
    BASELINE parity config — the square-root mitigation from SURVEY.md
    section 7 "hard parts" (measured ~3.5e-7 here vs ~1.1e-6 for the plain
    f32 filter, whose rank-1 downdates lose the last bits)."""
    args, oracle = _parity_case(rng)
    args32 = tuple(jnp.asarray(a, jnp.float32)
                   if jnp.asarray(a).dtype == jnp.float64 else a
                   for a in args)
    got32 = np.asarray(msrouse_logL_sqrt(*args32))
    assert np.max(np.abs((got32 - oracle) / oracle)) < 1e-6


def test_sqrt_out_of_range_nan(rng):
    args, _ = _parity_case(rng, P=3, T=20)
    profiles = np.array(args[8])
    profiles[1, 5] = 7
    out = np.asarray(msrouse_logL_sqrt(*args[:8], jnp.asarray(profiles),
                                       *args[9:]))
    assert np.isnan(out[1])
    assert np.all(np.isfinite(out[[0, 2]]))
