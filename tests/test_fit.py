"""
Gradient-based parameter calibration (`bild_jax.fit`) — a capability the
reference cannot offer (its kernel is compiled Cython,
``bild/src/MSRouse_logL.pyx``): exactness of the differentiable dynamics
map, gradient correctness vs finite differences, and MLE recovery of
ground-truth parameters from simulated data.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bild_jax.fit import (FitResult, _dynamics_from_params, _spectral_consts,
                          fit_rouse, make_rouse_nll)
from bild_jax.models import MultiStateRouse


def _model(N=8, D=1.0, k=5.0, err=0.1, d=3):
    return MultiStateRouse(N, D, k, d=d, localization_error=err)


def test_dynamics_map_matches_construction():
    """(log D, log k) -> (B, Sig, C0) must reproduce RouseModel's own
    arrays at the model's parameters, for looped and unlooped states."""
    model = _model(N=10, D=0.7, k=3.2)
    consts = _spectral_consts(model)
    Bs, Sigs, C0s = _dynamics_from_params(
        consts, jnp.log(0.7), jnp.log(3.2), model.models[0].dt, jnp.float64)
    np.testing.assert_allclose(np.asarray(Bs), np.asarray(model.Bs),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(Sigs), np.asarray(model.Sigs),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(C0s), np.asarray(model.C0s),
                               rtol=1e-12, atol=1e-12)


def test_gradient_matches_finite_differences():
    model = _model(N=5)
    prof = np.zeros(20, dtype=int)
    prof[7:14] = 1
    traj = model.trajectory_from_loopingprofile(prof, key=jax.random.key(3))
    nll, p0 = make_rouse_nll(model, traj, prof, fit_localization="vector")

    g = jax.grad(nll)(p0)
    eps = 1e-6
    for name in ("log_D", "log_k"):
        p_hi = dict(p0); p_hi[name] = p0[name] + eps
        p_lo = dict(p0); p_lo[name] = p0[name] - eps
        fd = (nll(p_hi) - nll(p_lo)) / (2 * eps)
        np.testing.assert_allclose(float(g[name]), float(fd),
                                   rtol=1e-5, atol=1e-8, err_msg=name)
    # localization-error gradient (vector): probe dim 0
    p_hi = dict(p0); p_hi["log_err"] = p0["log_err"].at[0].add(eps)
    p_lo = dict(p0); p_lo["log_err"] = p0["log_err"].at[0].add(-eps)
    fd = (nll(p_hi) - nll(p_lo)) / (2 * eps)
    np.testing.assert_allclose(float(g["log_err"][0]), float(fd),
                               rtol=1e-5, atol=1e-8)


def test_nll_matches_likelihood_path():
    """At the model's own parameters the objective equals the production
    likelihood path (same kernel, wrapped differently)."""
    model = _model(N=8)
    prof = np.zeros(40, dtype=int)
    prof[10:25] = 1
    traj = model.trajectory_from_loopingprofile(prof, key=jax.random.key(9))
    nll, p0 = make_rouse_nll(model, traj, prof, fit_localization=False)
    expect = -float(model.logL(prof, traj)) / (traj.count_valid_frames() * model.d)
    np.testing.assert_allclose(float(nll(p0)), expect, rtol=1e-12)


@pytest.mark.slow
def test_fit_recovers_parameters():
    D_true, k_true, err_true = 1.0, 5.0, 0.1
    model = _model(N=8, D=D_true, k=k_true, err=err_true)
    rng = np.random.default_rng(42)
    B, T = 24, 100
    profiles = np.zeros((B, T), dtype=int)
    for b in range(B):                      # 1-3 looped segments per traj
        for _ in range(rng.integers(1, 4)):
            t0 = rng.integers(0, T - 10)
            profiles[b, t0:t0 + rng.integers(5, 30)] = 1
    batch = model.trajectories_from_loopingprofiles(profiles,
                                                    key=jax.random.key(7))

    start = _model(N=8, D=2.5 * D_true, k=0.4 * k_true, err=2.0 * err_true)
    fit = fit_rouse(start, batch, profiles, steps=400, learning_rate=0.05)

    assert isinstance(fit, FitResult)
    assert fit.nll_trace[-1] < fit.nll_trace[0] - 0.1   # moved substantially
    # MLE beats (or matches) the truth parameters on this dataset
    nll, _ = make_rouse_nll(start, batch, profiles)
    p_truth = {"log_D": jnp.log(D_true), "log_k": jnp.log(k_true),
               "log_err": jnp.asarray(np.log(err_true))}
    assert fit.nll_trace[-1] <= float(nll(p_truth)) + 1e-3
    # and lands near the truth (default = shared isotropic error)
    assert abs(np.log(fit.D / D_true)) < 0.35
    assert abs(np.log(fit.k / k_true)) < 0.35
    assert len(set(fit.localization_error)) == 1    # scalar mode: isotropic
    assert abs(np.log(fit.localization_error[0] / err_true)) < 0.35
    assert fit.grad_norm < 0.1

    # the returned calibrated model is usable on the production path
    t0 = model.trajectory_from_loopingprofile(profiles[0],
                                              key=jax.random.key(1))
    ll = fit.model.logL_batch(profiles[:2, :], t0)
    assert np.all(np.isfinite(np.asarray(ll)))
    assert fit.model.nStates == model.nStates


def test_fit_frozen_localization():
    """fit_localization=False freezes the error (dedup fast path) and the
    result reports the frozen value."""
    model = _model(N=6, err=0.15)
    prof = np.zeros(30, dtype=int)
    prof[5:20] = 1
    traj = model.trajectory_from_loopingprofile(prof, key=jax.random.key(5))
    fit = fit_rouse(model, traj, prof, fit_localization=False, steps=30,
                    learning_rate=0.02)
    assert "log_err" not in fit.params
    np.testing.assert_allclose(fit.localization_error, 0.15 * np.ones(3))
    assert fit.nll_trace[-1] <= fit.nll_trace[0] + 1e-9


@pytest.mark.slow
def test_calibrate_rouse_alternation():
    """Hard-EM alternation: inference profiles feed the fit, parameters
    move toward truth, and the final results/model are consistent."""
    from bild_jax.fit import CalibrationResult, calibrate_rouse

    D_true, k_true = 1.0, 5.0
    model = _model(N=6, D=D_true, k=k_true, err=0.1)
    rng = np.random.default_rng(3)
    B, T = 12, 60
    profiles = np.zeros((B, T), dtype=int)
    for b in range(B):
        t0 = rng.integers(0, T // 2)
        profiles[b, t0:t0 + rng.integers(10, 30)] = 1
    batch = model.trajectories_from_loopingprofiles(profiles,
                                                    key=jax.random.key(8))

    # in-basin start (the documented contract: tens of percent, not 2x —
    # see calibrate_rouse's docstring for the measured divergence outside)
    start = _model(N=6, D=1.35 * D_true, k=0.7 * k_true, err=0.1)
    cal = calibrate_rouse(
        start, batch, rounds=2,
        sample_kwargs=dict(k_max=3, steps_per_k=8, N=64),
        fit_kwargs=dict(steps=150, learning_rate=0.05,
                        fit_localization=False),
        key=jax.random.key(1))

    assert isinstance(cal, CalibrationResult)
    assert len(cal.fits) == 2
    # parameters moved toward truth
    assert abs(np.log(cal.D / D_true)) < abs(np.log(1.35))
    assert abs(np.log(cal.k / k_true)) < abs(np.log(0.7))
    # the convergence diagnostic the docstring prescribes: nll decreases
    # across rounds
    assert cal.fits[1].nll_trace[-1] < cal.fits[0].nll_trace[0]
    # final artifacts are mutually consistent
    assert cal.profiles.shape == (B, T)
    np.testing.assert_array_equal(cal.profiles,
                                  np.asarray(cal.results.best_profile()))
    assert cal.model.nStates == 2
    # profiles from the calibrated run track the truth
    assert np.mean(cal.profiles == profiles) > 0.85


def test_ragged_profiles_from_dataset_interface():
    """`fit_rouse`'s documented typical use passes sample_dataset's ragged
    best_profile() list; padding must be likelihood-neutral."""
    model = _model(N=5)
    lengths = [20, 14, 17]
    profs = [np.concatenate([np.zeros(L // 2, int), np.ones(L - L // 2, int)])
             for L in lengths]
    trajs = [model.trajectory_from_loopingprofile(p, key=jax.random.key(i))
             for i, p in enumerate(profs)]

    nll, p0 = make_rouse_nll(model, trajs, profs)           # ragged list
    padded = np.zeros((3, 20), dtype=int)
    for b, p in enumerate(profs):
        padded[b, :len(p)] = p
    nll2, _ = make_rouse_nll(model, trajs, padded)          # explicit pad
    v, v2 = float(nll(p0)), float(nll2(p0))
    assert np.isfinite(v)
    np.testing.assert_allclose(v, v2, rtol=1e-13)

    fit = fit_rouse(model, trajs, profs, steps=10, learning_rate=0.02)
    assert np.isfinite(fit.nll_trace).all()

    with pytest.raises(ValueError, match="profiles for"):
        make_rouse_nll(model, trajs, profs[:2])


def test_heterogeneous_localization_error_raises():
    """Per-trajectory metadata with DIFFERENT errors must raise, not be
    silently collapsed to trajectory 0's value."""
    from bild_jax.trajectory import make_trajectory

    model = MultiStateRouse(5, 1.0, 5.0, d=1)      # no model-level error
    rng = np.random.default_rng(0)
    t1 = make_trajectory(rng.normal(size=(10, 1)), localization_error=0.1)
    t2 = make_trajectory(rng.normal(size=(10, 1)), localization_error=0.2)
    with pytest.raises(ValueError, match="heterogeneous"):
        make_rouse_nll(model, [t1, t2], np.zeros((2, 10), int))
    # homogeneous metadata is fine
    t3 = make_trajectory(rng.normal(size=(10, 1)), localization_error=0.1)
    nll, p0 = make_rouse_nll(model, [t1, t3], np.zeros((2, 10), int))
    assert np.isfinite(float(nll(p0)))


def test_short_profile_raises():
    """A ragged profile shorter than its trajectory must raise instead of
    silently scoring the tail as state 0."""
    model = _model(N=5)
    profs = [np.zeros(20, dtype=int), np.zeros(16, dtype=int)]
    trajs = [model.trajectory_from_loopingprofile(p, key=jax.random.key(i))
             for i, p in enumerate(profs)]
    bad = [profs[0], profs[1][:9]]                  # second one truncated
    with pytest.raises(ValueError, match="profile 1 has 9 frames"):
        make_rouse_nll(model, trajs, bad)


def test_calibrate_metadata_only_error():
    """calibrate_rouse with NO model-level localization error: homogeneous
    per-trajectory metadata must be resolved into the sampling model
    (lockstep mode needs it) and survive into the calibrated model."""
    from bild_jax.fit import calibrate_rouse
    from bild_jax.trajectory import make_trajectory

    gen = _model(N=5, D=1.0, k=5.0, err=0.1, d=1)
    prof = np.zeros(30, dtype=int)
    prof[10:20] = 1
    trajs = [make_trajectory(
        np.asarray(gen.trajectory_from_loopingprofile(
            prof, key=jax.random.key(i)).data, dtype=float),
        localization_error=0.1) for i in range(3)]

    start = MultiStateRouse(5, 1.2, 4.0, d=1)       # no error set
    cal = calibrate_rouse(
        start, trajs, rounds=1,
        sample_kwargs=dict(k_max=2, steps_per_k=4, N=32),
        fit_kwargs=dict(steps=30, fit_localization=False),
        key=jax.random.key(2))
    np.testing.assert_allclose(
        np.asarray(cal.model.localization_error, dtype=float), 0.1)
    assert np.isfinite(cal.fits[0].nll_trace).all()


def test_weighted_nll_one_hot_equals_hard():
    """The posterior-weighted objective with one-hot weights must equal the
    plain (hard) objective on the selected profiles — value AND gradient."""
    model = _model(N=5, d=2)
    rng = np.random.default_rng(1)
    B, T, M = 3, 25, 4
    profiles = np.zeros((B, T), dtype=int)
    profiles[:, 8:15] = 1
    batch = model.trajectories_from_loopingprofiles(profiles,
                                                    key=jax.random.key(5))
    nll_hard, p0 = make_rouse_nll(model, batch, profiles)

    prof_sets = rng.integers(0, 2, size=(B, M, T)).astype(np.int32)
    prof_sets[:, 0] = profiles                       # slot 0 = the profile
    w = np.zeros((B, M))
    w[:, 0] = 1.0
    nll_soft, _ = make_rouse_nll(model, batch, prof_sets, weights=w)

    v_h, g_h = jax.value_and_grad(nll_hard)(p0)
    v_s, g_s = jax.value_and_grad(nll_soft)(p0)
    np.testing.assert_allclose(float(v_s), float(v_h), rtol=1e-12)
    for name in p0:
        np.testing.assert_allclose(np.asarray(g_s[name]),
                                   np.asarray(g_h[name]), rtol=1e-10)

    # shape mismatch is rejected
    with pytest.raises(ValueError, match="weighted profiles"):
        make_rouse_nll(model, batch, prof_sets[:, :, :10], weights=w)


def test_calibrate_soft_mode_and_init():
    """Soft mode runs end-to-end (posterior-weighted M-step); init
    validation; init='model' skips the neutral pre-fit."""
    from bild_jax.fit import calibrate_rouse

    model = _model(N=5, D=1.0, k=5.0, err=0.1, d=1)
    prof = np.zeros(30, dtype=int)
    prof[10:20] = 1
    batch = model.trajectories_from_loopingprofiles(
        np.tile(prof, (3, 1)), key=jax.random.key(4))
    start = _model(N=5, D=1.2, k=4.0, err=0.1, d=1)
    kw = dict(rounds=1,
              sample_kwargs=dict(k_max=2, steps_per_k=4, N=32),
              fit_kwargs=dict(steps=30, fit_localization=False),
              key=jax.random.key(2))
    cal = calibrate_rouse(start, batch, mode="soft", ensemble=8, **kw)
    assert np.isfinite(cal.fits[0].nll_trace).all()
    assert cal.pre_fit is not None                   # neutral default
    assert cal.results.top_profiles is not None      # E-step kept ensemble

    cal_m = calibrate_rouse(start, batch, init="model", **kw)
    assert cal_m.pre_fit is None

    with pytest.raises(ValueError, match="init"):
        calibrate_rouse(start, batch, init="warm", **kw)
    with pytest.raises(ValueError, match="mode"):
        calibrate_rouse(start, batch, mode="em", **kw)


def test_calibrate_dataset_engine():
    """engine='dataset': the E-step runs through sample_dataset (ragged
    bucketing + chunking), the ragged MAP profiles feed the fit, and
    parameters move toward truth. Soft mode / TrajectoryBatch input are
    rejected for this engine."""
    from bild_jax.fit import calibrate_rouse
    from bild_jax.parallel import stack_trajectories

    D_true, k_true = 1.0, 5.0
    model = _model(N=5, D=D_true, k=k_true, err=0.1, d=1)
    rng = np.random.default_rng(2)
    trajs = []
    for i, T in enumerate([24, 40, 24, 33]):      # two length buckets
        prof = np.zeros(T, dtype=int)
        t0 = rng.integers(0, T // 2)
        prof[t0:t0 + rng.integers(8, T // 2)] = 1
        trajs.append(model.trajectory_from_loopingprofile(
            prof, key=jax.random.key(60 + i)))

    start = _model(N=5, D=1.3 * D_true, k=0.75 * k_true, err=0.1, d=1)
    cal = calibrate_rouse(
        start, trajs, rounds=1, engine="dataset",
        sample_kwargs=dict(k_max=2, steps_per_k=4, N=32,
                           bucket_edges=(24, 48), informed_init=False),
        fit_kwargs=dict(steps=60, fit_localization=False),
        key=jax.random.key(3))
    assert abs(np.log(cal.D / D_true)) < abs(np.log(1.3))
    assert abs(np.log(cal.k / k_true)) < abs(np.log(0.75))
    # ragged outputs keep true lengths
    assert [len(p) for p in cal.profiles] == [24, 40, 24, 33]
    assert np.isfinite(cal.fits[0].nll_trace).all()

    with pytest.raises(ValueError, match="hard"):
        calibrate_rouse(start, trajs, engine="dataset", mode="soft")
    with pytest.raises(ValueError, match="Trajectory"):
        calibrate_rouse(start, stack_trajectories(trajs), engine="dataset")
    with pytest.raises(ValueError, match="engine"):
        calibrate_rouse(start, trajs, engine="chunked")
