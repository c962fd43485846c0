"""Parity tests: batched Kalman kernel vs the sequential float64 NumPy
oracle (analog of the compiled-vs-python equality test, reference
tests/test_bild.py:168-173; tolerance per BASELINE.md: 1e-6 rtol in float64,
1e-5 in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bild_jax import Trajectory
from bild_jax.models import MultiStateRouse
from bild_jax.ops.oracle import msrouse_logL_numpy
from bild_jax.ops.kalman import msrouse_logL_batch


def _arrays(model):
    return tuple(np.asarray(a) for a in
                 (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s))


def _random_profiles(rng, P, T, n):
    return rng.integers(0, n, size=(P, T))


def _batch_logL(model, traj, profiles):
    return np.asarray(model.logL_batch(jnp.asarray(profiles, dtype=jnp.int32), traj))


def _oracle_logL(model, traj, profiles):
    Bs, Gs, Sigs, M0s, C0s = _arrays(model)
    err = model._get_noise(traj)
    trajdata = traj[:]  # NaN sentinel view
    return np.array([
        msrouse_logL_numpy(Bs, Gs, Sigs, M0s, C0s, np.asarray(model.w),
                           err, p, trajdata)
        for p in profiles
    ])


class TestKalmanParity:
    def test_basic_1d(self, rng):
        model = MultiStateRouse(20, 1, 5, d=1, localization_error=0.5)
        traj = Trajectory.create(np.array([1.0, 2.0, np.nan, 4.0]))
        profiles = _random_profiles(rng, 16, 4, 2)
        got = _batch_logL(model, traj, profiles)
        want = _oracle_logL(model, traj, profiles)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        # sanity range from reference test (tests/test_bild.py:137-138)
        assert np.all(got > -100) and np.all(got < 0)

    def test_3d_with_distinct_errors(self, rng):
        # d* deduplication path: two unique localization errors over 3 dims
        model = MultiStateRouse(12, 1.0, 4.0, d=3,
                                localization_error=[0.3, 0.5, 0.3])
        prof_true = np.zeros(30, dtype=int)
        prof_true[10:20] = 1
        traj = model.trajectory_from_loopingprofile(prof_true)
        profiles = _random_profiles(rng, 8, 30, 2)
        got = _batch_logL(model, traj, profiles)
        want = _oracle_logL(model, traj, profiles)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_missing_frames_and_first_frame_missing(self, rng):
        model = MultiStateRouse(10, 2.0, 3.0, d=2, localization_error=0.2)
        data = rng.normal(size=(25, 2))
        data[0] = np.nan
        data[7] = np.nan
        data[23] = np.nan
        traj = Trajectory.create(data)
        profiles = _random_profiles(rng, 8, 25, 2)
        got = _batch_logL(model, traj, profiles)
        want = _oracle_logL(model, traj, profiles)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_three_states(self, rng):
        model = MultiStateRouse(8, 1.0, 2.0, d=1,
                                looppositions=(None, (0, -1), ((0, 3), (4, 7))),
                                localization_error=0.4)
        data = rng.normal(size=(15, 1))
        traj = Trajectory.create(data)
        profiles = _random_profiles(rng, 12, 15, 3)
        got = _batch_logL(model, traj, profiles)
        want = _oracle_logL(model, traj, profiles)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_traj_localization_error_fallback(self):
        model = MultiStateRouse(20, 1, 5, d=1)
        traj = Trajectory.create(np.array([1.0, 2.0, np.nan, 4.0]),
                                 localization_error=[0.5])
        profile = np.array([1, 1, 0, 0])
        logL = model.logL(profile, traj)

        model2 = MultiStateRouse(20, 1, 5, d=1, localization_error=0.5)
        logL2 = model2.logL(profile, traj)
        np.testing.assert_allclose(logL, logL2, rtol=1e-12)

        traj_noerr = Trajectory.create(np.array([1.0, 2.0, np.nan, 4.0]))
        try:
            model.logL(profile, traj_noerr)
            assert False, "should raise without localization error"
        except ValueError:
            pass

    def test_long_trajectory_stability(self, rng):
        # T = 500: check no blow-up and oracle parity in f64
        model = MultiStateRouse(16, 1.0, 5.0, d=1, localization_error=0.1)
        prof_true = (np.arange(500) // 100) % 2
        traj = model.trajectory_from_loopingprofile(prof_true)
        profiles = np.stack([prof_true, np.zeros(500, int), np.ones(500, int)])
        got = _batch_logL(model, traj, profiles)
        want = _oracle_logL(model, traj, profiles)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        # true profile should beat the constant ones
        assert got[0] > got[1] and got[0] > got[2]

    def test_out_of_range_states_yield_nan(self, rng):
        # a mid-profile out-of-range state must NOT return a finite,
        # plausible value (it would silently select zeroed dynamics)
        model = MultiStateRouse(10, 1, 5, d=1, localization_error=0.5)
        traj = Trajectory.create(np.linspace(0.0, 1.0, 6))
        profiles = np.array([
            [0, 1, 1, 0, 1, 0],    # valid
            [0, 1, 2, 0, 1, 0],    # mid-profile out of range
            [0, 1, 1, 0, 1, -1],   # negative state
            [2, 0, 0, 0, 0, 0],    # out-of-range initial state
        ])
        got = _batch_logL(model, traj, profiles)
        assert np.isfinite(got[0])
        assert np.all(np.isnan(got[1:]))


@pytest.fixture
def x32():
    """float32 for one test: the production dtype on an accelerator."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("gaps", [False, True], ids=["dense", "gaps"])
@pytest.mark.parametrize("errors", [[0.1], [0.08, 0.1, 0.12]],
                         ids=["q1", "q3"])
@pytest.mark.parametrize("n", [2, 3])
def test_f32_scan_matches_f64_oracle(x32, rng, n, errors, gaps):
    """The float32 XLA scan at the production width (N=20, d=3) stays
    within 1e-5 relative of the float64 oracle: full-precision products
    and the per-step re-symmetrization keep the recursion at the f32
    storage floor."""
    model = MultiStateRouse(20, 1.0, 5.0, d=3,
                            looppositions=(None, (0, -1), (0, 10))[:n],
                            localization_error=np.array(errors * (3 // len(errors))))
    assert model.Bs.dtype == jnp.float32
    truth = (np.arange(100) // 30) % n
    traj = model.trajectory_from_loopingprofile(
        truth, missing_frames=10 if gaps else None, key=jax.random.key(n))
    profiles = np.concatenate([truth[None], _random_profiles(rng, 7, 100, n)])
    got = np.asarray(model.logL_batch(profiles, traj), dtype=np.float64)
    want = _oracle_logL(model, traj, profiles)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_f32_scan_long_trajectory(x32, rng):
    """T=1000, three states: the centre-of-mass mode's growing variance is
    kept out of the float32 recursion (`_filter_Sigs`), which holds it at
    1e-5 relative of the float64 oracle."""
    model = MultiStateRouse(20, 1.0, 5.0, d=3,
                            looppositions=(None, (0, -1), (0, 10)),
                            localization_error=0.1)
    truth = (np.arange(1000) // 150) % 3
    traj = model.trajectory_from_loopingprofile(truth, key=jax.random.key(5))
    profiles = np.concatenate([truth[None], _random_profiles(rng, 3, 1000, 3)])
    got = np.asarray(model.logL_batch(profiles, traj), dtype=np.float64)
    np.testing.assert_allclose(got, _oracle_logL(model, traj, profiles),
                               rtol=1e-5)


@pytest.mark.parametrize("measurement", ["end2end", "monomer0"])
def test_filter_sigs_leave_likelihood_unchanged(rng, measurement):
    """Dropping the centre-of-mass noise is exact when the measurement does
    not see that mode, and skipped when it does."""
    N = 12
    w = "end2end" if measurement == "end2end" else np.eye(N)[0]
    model = MultiStateRouse(N, 1.0, 4.0, d=2, measurement=w,
                            localization_error=0.2)
    changed = not np.allclose(model._filter_Sigs, model.Sigs)
    assert changed == (measurement == "end2end")
    traj = model.trajectory_from_loopingprofile(
        (np.arange(40) // 10) % 2, key=jax.random.key(1))
    profiles = _random_profiles(rng, 6, 40, 2)
    np.testing.assert_allclose(_batch_logL(model, traj, profiles),
                               _oracle_logL(model, traj, profiles),
                               rtol=1e-10)
