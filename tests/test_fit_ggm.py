"""
GGM MSD-parameter calibration (`bild_jax.fit_ggm`) — a capability the
reference lacks (its GGM takes externally-fitted frozen MSDs,
``bild/models.py:536-606``): bit-parity of the differentiable objective
against the exact `logL_host` oracle, gradient correctness, parameter
recovery, and the EM alternation.
"""
import numpy as np
import pytest

import jax

from bild_jax.fit import fit_ggm, make_ggm_nll
from bild_jax.models import GenericGaussianModel as GGM
from bild_jax.trajectory import make_trajectory


def _mixed_case():
    """Mixed ss_orders, nonzero means, noise, motion blur, d=2, gaps —
    every code path of the window extraction at once."""
    spec = [
        [("twoLocusRouse", dict(G=1.0, J=5.0, noise2=0.02,
                                motion_blur_f=0.3), 0.1, 0)] * 2,
        [("powerlaw", dict(G=0.5, a=0.7, noise2=0.02,
                           motion_blur_f=0.3), -0.05, 1)] * 2,
    ]
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0, noise2=0.02,
                                         motion_blur_f=0.3), 0.1, 0)] * 2,
        [(GGM.MSD_function_powerlaw(G=0.5, a=0.7, noise2=0.02,
                                    motion_blur_f=0.3), -0.05, 1)] * 2,
    ])
    B, T = 4, 40
    profiles = np.zeros((B, T), dtype=int)
    profiles[0, 10:25] = 1
    profiles[1, :8] = 1
    profiles[2, 30:] = 1
    profiles[3, 5:12] = 1
    profiles[3, 20:33] = 1
    trajs = []
    for b in range(B):
        t = model.trajectory_from_loopingprofile(
            profiles[b], rng=np.random.default_rng(b))
        arr = np.asarray(t[:])
        if b == 2:   # gaps, including the overlap frame of an interval
            arr[7] = np.nan
            arr[29] = np.nan
            arr[31] = np.nan
        trajs.append(make_trajectory(arr))
    return spec, model, profiles, trajs


def test_nll_parity_vs_host_oracle():
    """-nll * n_obs at the spec's own parameters must equal the summed
    f64 host oracle (reference ``bild/models.py:608-661`` semantics,
    including the raw-first-datum conditioning convention)."""
    spec, model, profiles, trajs = _mixed_case()
    nll, p0 = make_ggm_nll(spec, trajs, profiles)
    n_obs = sum(np.isfinite(np.asarray(t[:])).sum() for t in trajs)
    ours = -float(nll(p0)) * n_obs
    host = sum(model.logL_host(profiles[b][: len(trajs[b])], trajs[b])
               for b in range(len(trajs)))
    np.testing.assert_allclose(ours, host, rtol=1e-10)


def test_gradient_matches_finite_differences():
    spec, _, profiles, trajs = _mixed_case()
    nll, p0 = make_ggm_nll(spec, trajs, profiles)
    g = jax.grad(nll)(p0)
    eps = 1e-6
    for s in p0:
        for k in p0[s]:
            pp = {a: dict(b) for a, b in p0.items()}
            pm = {a: dict(b) for a, b in p0.items()}
            pp[s][k] = p0[s][k] + eps
            pm[s][k] = p0[s][k] - eps
            fd = (float(nll(pp)) - float(nll(pm))) / (2 * eps)
            np.testing.assert_allclose(float(g[s][k]), fd, rtol=1e-4,
                                       atol=1e-7, err_msg=f"{s}/{k}")


def test_two_locus_recovery():
    """MLE recovery of per-state (G, J) from an offset start."""
    true0, true1 = dict(G=1.0, J=5.0), dict(G=0.2, J=1.0)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(**true0, noise2=0.01), 0.0, 0)],
        [(GGM.MSD_function_twoLocusRouse(**true1, noise2=0.01), 0.0, 0)],
    ])
    B, T = 12, 80
    rng = np.random.default_rng(0)
    profiles = np.zeros((B, T), dtype=int)
    for b in range(B):
        t0 = rng.integers(0, T // 2)
        profiles[b, t0:t0 + rng.integers(20, 50)] = 1
    trajs = [model.trajectory_from_loopingprofile(
        profiles[b], rng=np.random.default_rng(b)) for b in range(B)]

    spec = [
        [("twoLocusRouse", dict(G=1.6, J=3.0, noise2=0.01), 0.0, 0)],
        [("twoLocusRouse", dict(G=0.12, J=1.8, noise2=0.01), 0.0, 0)],
    ]
    fit = fit_ggm(spec, trajs, profiles, steps=400, learning_rate=0.05)
    assert fit.converged and fit.grad_norm < 1e-4
    for s, tru in enumerate((true0, true1)):
        for k, v in tru.items():
            assert abs(np.log(fit.parameters[s][k] / v)) < np.log(1.4), \
                (s, k, fit.parameters[s][k], v)
    # nll decreased and the rebuilt model is usable + prefers the truth
    assert fit.nll_trace[-1] < fit.nll_trace[0]
    lls = np.asarray(fit.model.logL_batch(
        np.stack([profiles[0], 0 * profiles[0]]), trajs[0]))
    assert lls[0] > lls[1]


def test_fit_noise_and_powerlaw_increments():
    """fit_noise adds a per-state noise parameter; an increment-stationary
    powerlaw state fits without a plateau."""
    model = GGM([
        [(GGM.MSD_function_powerlaw(G=1.0, a=0.6, noise2=0.05), 0.0, 1)],
        [(GGM.MSD_function_powerlaw(G=0.3, a=1.2, noise2=0.05), 0.0, 1)],
    ])
    T = 120
    profile = np.zeros(T, dtype=int)
    profile[40:90] = 1
    trajs = [model.trajectory_from_loopingprofile(
        profile, rng=np.random.default_rng(b)) for b in range(8)]
    spec = [
        [("powerlaw", dict(G=1.4, a=0.5, noise2=0.03), 0.0, 1)],
        [("powerlaw", dict(G=0.2, a=1.4, noise2=0.03), 0.0, 1)],
    ]
    fit = fit_ggm(spec, trajs, profile, fit_noise=True, steps=300)
    assert np.isfinite(fit.nll_trace).all()
    assert fit.nll_trace[-1] < fit.nll_trace[0]
    for s in range(2):
        assert fit.parameters[s]["noise2"] > 0
    # recovery within a loose factor (noise and exponent trade off)
    assert abs(np.log(fit.parameters[0]["a"] / 0.6)) < np.log(1.5)
    assert abs(np.log(fit.parameters[1]["a"] / 1.2)) < np.log(1.5)


def test_spec_validation():
    t = make_trajectory(np.random.default_rng(0).normal(size=(10, 1)))
    prof = np.zeros(10, dtype=int)

    with pytest.raises(ValueError, match="no plateau"):
        make_ggm_nll([[("powerlaw", dict(G=1.0, a=0.5), 0.0, 0)]], [t], prof)
    with pytest.raises(ValueError, match="unknown MSD family"):
        make_ggm_nll([[("brownian", dict(G=1.0), 0.0, 1)]], [t], prof)
    with pytest.raises(ValueError, match="missing"):
        make_ggm_nll([[("powerlaw", dict(G=1.0), 0.0, 1)]], [t], prof)
    with pytest.raises(ValueError, match="unknown parameters"):
        make_ggm_nll([[("powerlaw", dict(G=1.0, a=0.5, q=2), 0.0, 1)]],
                     [t], prof)
    with pytest.raises(ValueError, match="positive"):
        make_ggm_nll([[("powerlaw", dict(G=-1.0, a=0.5), 0.0, 1)]],
                     [t], prof)
    with pytest.raises(ValueError, match="tied across dims"):
        make_ggm_nll([[("powerlaw", dict(G=1.0, a=0.5), 0.0, 1),
                       ("powerlaw", dict(G=2.0, a=0.5), 0.0, 1)]],
                     [make_trajectory(np.zeros((10, 2)) + 0.5)], prof)
    with pytest.raises(ValueError, match="positive starting noise2"):
        make_ggm_nll([[("powerlaw", dict(G=1.0, a=0.5), 0.0, 1)]], [t],
                     prof, fit_noise=True)
    with pytest.raises(ValueError, match="data has d"):
        make_ggm_nll([[("powerlaw", dict(G=1.0, a=0.5), 0.0, 1)] * 2],
                     [t], prof)
    with pytest.raises(ValueError, match="out of range"):
        make_ggm_nll([[("powerlaw", dict(G=1.0, a=0.5), 0.0, 1)]], [t],
                     prof + 1)


def test_ragged_profile_lists():
    """make_ggm_nll accepts ragged per-trajectory profile lists (the
    sample_dataset(...).best_profile() payload) and scores them exactly
    like the equivalently padded (B, T) array."""
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0, noise2=0.02),
          0.0, 0)],
        [(GGM.MSD_function_powerlaw(G=0.5, a=0.7, noise2=0.02), 0.0, 1)],
    ])
    spec = [
        [("twoLocusRouse", dict(G=1.0, J=5.0, noise2=0.02), 0.0, 0)],
        [("powerlaw", dict(G=0.5, a=0.7, noise2=0.02), 0.0, 1)],
    ]
    lens = [20, 32, 26]
    rng = np.random.default_rng(5)
    ragged, trajs = [], []
    for b, T in enumerate(lens):
        p = np.zeros(T, dtype=int)
        t0 = rng.integers(0, T // 2)
        p[t0:t0 + rng.integers(5, T // 2)] = 1
        ragged.append(p)
        trajs.append(model.trajectory_from_loopingprofile(
            p, rng=np.random.default_rng(b)))
    Tmax = max(lens)
    padded = np.zeros((len(lens), Tmax), dtype=int)
    for b, p in enumerate(ragged):
        padded[b, : len(p)] = p

    nll_r, p0 = make_ggm_nll(spec, trajs, ragged)
    nll_p, _ = make_ggm_nll(spec, trajs, padded)
    assert float(nll_r(p0)) == float(nll_p(p0))

    with pytest.raises(ValueError, match="frames"):
        make_ggm_nll(spec, trajs, [p[:-2] for p in ragged])


@pytest.mark.slow
def test_calibrate_ggm_dataset_engine():
    """engine='dataset': the GGM E-step runs through sample_dataset
    (ragged bucketing + chunking) and per-state parameters move toward
    truth; a TrajectoryBatch input is rejected for this engine."""
    from bild_jax.fit import calibrate_ggm
    from bild_jax.parallel import stack_trajectories

    true0, true1 = dict(G=1.0, J=5.0), dict(G=0.2, J=1.0)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(**true0, noise2=0.01), 0.0, 0)],
        [(GGM.MSD_function_twoLocusRouse(**true1, noise2=0.01), 0.0, 0)],
    ])
    rng = np.random.default_rng(0)
    lens = [40, 56, 40, 48, 56, 44]
    trajs, profs = [], []
    for b, T in enumerate(lens):
        p = np.zeros(T, dtype=int)
        t0 = rng.integers(0, T // 3)
        p[t0:t0 + rng.integers(T // 3, 2 * T // 3)] = 1
        profs.append(p)
        trajs.append(model.trajectory_from_loopingprofile(
            p, rng=np.random.default_rng(b)))

    spec = [
        [("twoLocusRouse", dict(G=1.3, J=3.8, noise2=0.01), 0.0, 0)],
        [("twoLocusRouse", dict(G=0.15, J=1.4, noise2=0.01), 0.0, 0)],
    ]
    cal = calibrate_ggm(
        spec, trajs, rounds=1, engine="dataset",
        sample_kwargs=dict(k_max=3, steps_per_k=6, N=64,
                           bucket_edges=(40, 56), informed_init=False),
        fit_kwargs=dict(steps=200, learning_rate=0.05),
        key=jax.random.key(1))
    assert [len(p) for p in cal.profiles] == lens
    acc = float(np.mean(np.concatenate(
        [np.asarray(p) == t for p, t in zip(cal.profiles, profs)])))
    assert acc > 0.75
    # identifiability ceiling at this data size: the fit at the TRUE
    # profiles lands at (G 0.80, J 4.35 / G 0.19, J 0.53) — the calibrated
    # run (G 0.85, J 3.82 / G 0.15, J 1.04) sits at the same level, so
    # assert a ceiling-honest factor of truth rather than tight recovery
    for s, tru in enumerate((true0, true1)):
        for k, v in tru.items():
            assert abs(np.log(cal.parameters[s][k] / v)) < np.log(1.6), \
                (s, k, cal.parameters[s][k], v)

    with pytest.raises(ValueError, match="Trajectory"):
        calibrate_ggm(spec, stack_trajectories(trajs), engine="dataset")
    with pytest.raises(ValueError, match="engine"):
        calibrate_ggm(spec, trajs, engine="chunked")


@pytest.mark.slow
def test_calibrate_ggm_alternation():
    """EM alternation recovers per-state MSD parameters, and the
    calibrated run's frame accuracy matches inference AT THE TRUE
    parameters on the same data/budget (measured 0.861 true vs 0.864
    calibrated)."""
    from bild_jax.fit import GGMCalibrationResult, calibrate_ggm

    true0, true1 = dict(G=1.0, J=5.0), dict(G=0.2, J=1.0)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(**true0, noise2=0.01), 0.0, 0)],
        [(GGM.MSD_function_twoLocusRouse(**true1, noise2=0.01), 0.0, 0)],
    ])
    B, T = 12, 60
    rng = np.random.default_rng(0)
    profiles = np.zeros((B, T), dtype=int)
    for b in range(B):
        t0 = rng.integers(0, T // 2)
        profiles[b, t0:t0 + rng.integers(15, 35)] = 1
    trajs = [model.trajectory_from_loopingprofile(
        profiles[b], rng=np.random.default_rng(b)) for b in range(B)]

    spec = [
        [("twoLocusRouse", dict(G=1.3, J=3.8, noise2=0.01), 0.0, 0)],
        [("twoLocusRouse", dict(G=0.15, J=1.4, noise2=0.01), 0.0, 0)],
    ]
    cal = calibrate_ggm(spec, trajs, rounds=2,
                        sample_kwargs=dict(k_max=3, steps_per_k=8, N=64),
                        fit_kwargs=dict(steps=200, learning_rate=0.05),
                        key=jax.random.key(1))
    assert isinstance(cal, GGMCalibrationResult)
    assert len(cal.fits) == 2
    acc = float(np.mean(cal.profiles == profiles))
    assert acc > 0.8          # true-parameter inference scores 0.861 here
    for s, tru in enumerate((true0, true1)):
        for k, v in tru.items():
            assert abs(np.log(cal.parameters[s][k] / v)) < np.log(1.45), \
                (s, k, cal.parameters[s][k], v)
    # the final model embeds the fitted parameters
    lls = np.asarray(cal.model.logL_batch(
        np.stack([profiles[0], 0 * profiles[0]]), trajs[0]))
    assert lls[0] > lls[1]
