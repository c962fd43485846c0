"""Model-layer tests (mirrors reference tests/test_bild.py TestModels) plus
GGM interval-memo consistency and DataFrame input."""
import numpy as np
import jax
import scipy.stats

import bild_jax as bild
from bild_jax import Trajectory, make_trajectory
from bild_jax.models import MultiStateRouse, FactorizedModel, GenericGaussianModel


class TestModels:
    def setup_method(self):
        self.traj = Trajectory.create(np.array([1.0, 2, np.nan, 4]),
                                      localization_error=[0.5])
        self.profile = bild.Loopingprofile([1, 1, 0, 0])

    def test_base_initial_profile(self):
        model = MultiStateRouse(20, 1, 5, d=1)
        profile = bild.models.MultiStateModel.initial_loopingprofile(model, self.traj)
        assert len(profile) == 4

    def test_rouse(self):
        model = MultiStateRouse(20, 1, 5, d=1)
        logL = model.logL(self.profile, self.traj)
        assert -100 < logL < 0

        profile = model.initial_loopingprofile(self.traj)
        np.testing.assert_array_equal(profile.state, [1, 0, 0, 0])

        traj = model.trajectory_from_loopingprofile(
            bild.Loopingprofile([0, 0, 0, 1, 1, 1]), localization_error=0.1,
            key=jax.random.key(0))
        assert len(traj) == 6

        traj = model.trajectory_from_loopingprofile(
            bild.Loopingprofile(np.ones(20, dtype=int)), localization_error=0.1,
            missing_frames=0.9, key=jax.random.key(1))
        assert traj.count_valid_frames() < 18

        traj = model.trajectory_from_loopingprofile(
            bild.Loopingprofile(np.ones(20, dtype=int)), localization_error=0.1,
            missing_frames=12, key=jax.random.key(2))
        assert traj.count_valid_frames() == 8

    def test_factorized(self):
        model = FactorizedModel([scipy.stats.maxwell(scale=1),
                                 scipy.stats.maxwell(scale=4)], d=1)
        assert model.nStates == 2

        logL = model.logL(self.profile, self.traj)
        profile = model.initial_loopingprofile(self.traj)
        assert -100 < logL < 0
        np.testing.assert_array_equal(profile.state, [0, 0, 1, 1])

        model.clear_memo()
        logL2 = model.logL(self.profile, self.traj)
        np.testing.assert_allclose(logL, logL2, rtol=1e-12)

        traj = model.trajectory_from_loopingprofile(bild.Loopingprofile([0, 0, 0, 1, 1, 1]))
        assert len(traj) == 6

    def test_ggm_both_ss_orders(self):
        model = GenericGaussianModel([
            [(GenericGaussianModel.MSD_function_powerlaw(G=1.0, a=0.5), 0.0, 1)],
            [(GenericGaussianModel.MSD_function_powerlaw(G=1.0, a=1.0), 0.0, 1)],
        ])
        assert model.nStates == 2
        logL = model.logL(self.profile, self.traj)
        assert -100 < logL < 0
        traj = model.trajectory_from_loopingprofile(
            bild.Loopingprofile([0, 0, 0, 1, 1, 1]), rng=np.random.default_rng(0))
        assert len(traj) == 6

        model0 = GenericGaussianModel([
            [(GenericGaussianModel.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.0, 0)],
            [(GenericGaussianModel.MSD_function_twoLocusRouse(G=1.0, J=1.0), 0.0, 0)],
        ])
        logL = model0.logL(self.profile, self.traj)
        assert -100 < logL < 0
        traj = model0.trajectory_from_loopingprofile(
            bild.Loopingprofile([0, 0, 0, 1, 1, 1]), rng=np.random.default_rng(0))
        assert len(traj) == 6

    def test_ggm_memo_consistency(self, rng):
        # the interval memo must not change results across profiles/orders
        model = GenericGaussianModel([
            [(GenericGaussianModel.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.0, 0)],
            [(GenericGaussianModel.MSD_function_twoLocusRouse(G=1.0, J=1.0), 0.0, 0)],
        ])
        traj = Trajectory.create(rng.normal(size=(12, 1)))
        profiles = rng.integers(0, 2, size=(10, 12))
        memod = [model.logL(p, traj) for p in profiles]
        fresh = []
        for p in profiles:
            model.clear_memo()
            fresh.append(model.logL(p, traj))
        np.testing.assert_allclose(memod, fresh, rtol=1e-12)

        # switching trajectories invalidates the memo
        traj2 = Trajectory.create(rng.normal(size=(12, 1)))
        a = model.logL(profiles[0], traj2)
        model.clear_memo()
        b = model.logL(profiles[0], traj2)
        np.testing.assert_allclose(a, b, rtol=1e-12)

    def test_ggm_in_sampler(self, rng):
        # GGM must work as the model inside FixedkSampler (host logL path)
        from bild_jax.amis import FixedkSampler
        model = GenericGaussianModel([
            [(GenericGaussianModel.MSD_function_powerlaw(G=0.01, a=0.5), 0.0, 1)],
            [(GenericGaussianModel.MSD_function_powerlaw(G=1.0, a=1.0), 0.0, 1)],
        ])
        traj = Trajectory.create(np.cumsum(rng.normal(size=6)) * 0.1)
        s = FixedkSampler(traj, model, k=1)
        assert s.exhausted  # small space -> exhaustive
        assert np.isfinite(s.evidences[-1][0])


def test_make_trajectory_dataframe():
    import pandas as pd

    df = pd.DataFrame({
        "x1": [0.0, 1.0, 2.0], "y1": [0.0, 0.0, 0.0], "z1": [0.0, 0.0, 0.0],
        "x2": [1.0, 3.0, 2.5], "y2": [1.0, 1.0, 1.0], "z2": [0.0, 0.0, 0.0],
    })
    traj = make_trajectory(df)
    assert (traj.T, traj.d) == (3, 3)
    np.testing.assert_allclose(np.asarray(traj.data)[:, 0], [1.0, 2.0, 0.5])

    # frame column with a gap -> missing frame
    df2 = pd.DataFrame({"x": [0.0, 2.0], "frame": [0, 2]})
    traj2 = make_trajectory(df2)
    assert len(traj2) == 3
    assert traj2.count_valid_frames() == 2


def test_batched_generation_matches_single_statistics(rng):
    import jax
    import jax.numpy as jnp
    model = MultiStateRouse(10, 1, 5, d=2, localization_error=0.1)
    profiles = np.zeros((64, 30), dtype=int)
    profiles[::2, 10:20] = 1
    batch = model.trajectories_from_loopingprofiles(profiles, key=jax.random.key(0))
    assert batch.data.shape == (64, 30, 2)
    assert bool(jnp.all(batch.valid))
    # looped segments have smaller end-to-end distances on average
    mags = np.linalg.norm(np.asarray(batch.data), axis=-1)
    looped = mags[::2, 12:20].mean()
    free = mags[1::2, 12:20].mean()
    assert looped < free


class TestLikelihoodFingerprint:
    """`likelihood_fingerprint` keys checkpoint reuse: equal for equal
    likelihoods, different when any likelihood-relevant knob changes."""

    def test_rouse(self):
        a = MultiStateRouse(10, 1.0, 5.0, d=2, localization_error=0.1)
        b = MultiStateRouse(10, 1.0, 5.0, d=2, localization_error=0.1)
        assert a.likelihood_fingerprint() == b.likelihood_fingerprint()
        for other in (MultiStateRouse(10, 1.1, 5.0, d=2,
                                      localization_error=0.1),
                      MultiStateRouse(10, 1.0, 4.0, d=2,
                                      localization_error=0.1),
                      MultiStateRouse(10, 1.0, 5.0, d=2,
                                      localization_error=0.2),
                      MultiStateRouse(10, 1.0, 5.0, d=2),  # per-traj noise
                      MultiStateRouse(12, 1.0, 5.0, d=2,
                                      localization_error=0.1)):
            assert a.likelihood_fingerprint() != \
                other.likelihood_fingerprint()
        # transition restrictions feed segmentation/DP init
        c = MultiStateRouse(10, 1.0, 5.0, d=2, localization_error=0.1)
        c.transitions = c.transitions.copy()
        c.transitions[0, 1] = False
        assert a.likelihood_fingerprint() != c.likelihood_fingerprint()

    def test_factorized(self):
        mk = lambda s: FactorizedModel([scipy.stats.maxwell(scale=s),
                                        scipy.stats.maxwell(scale=1.0)])
        assert mk(0.1).likelihood_fingerprint() == \
            mk(0.1).likelihood_fingerprint()
        assert mk(0.1).likelihood_fingerprint() != \
            mk(0.2).likelihood_fingerprint()

    def test_ggm(self):
        GGM = GenericGaussianModel
        mk = lambda G, **kw: GGM([
            [(GGM.MSD_function_twoLocusRouse(G=G, J=5.0, noise2=0.01),
              0.0, 0)],
            [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0, noise2=0.01),
              0.0, 0)],
        ], **kw)
        assert mk(1.0).likelihood_fingerprint() == \
            mk(1.0).likelihood_fingerprint()
        assert mk(1.0).likelihood_fingerprint() != \
            mk(1.2).likelihood_fingerprint()
        assert mk(1.0).likelihood_fingerprint() != \
            mk(1.0, T_band=32).likelihood_fingerprint()

    def test_custom_model_has_none(self):
        class Custom(bild.models.MultiStateModel):
            def __init__(self):
                self.init_transitions(2)

            def logL(self, profile, traj):
                return 0.0

        assert Custom().likelihood_fingerprint() is None
