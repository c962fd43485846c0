"""End-to-end inference tests (mirrors reference tests/test_bild.py TestCore /
TestPostproc) plus stats coverage the reference lacks."""
import numpy as np
import pytest
import jax
from scipy import stats as sp_stats
from conftest import logsumexp_safe as logsumexp

import bild_jax as bild
from bild_jax import Trajectory
from bild_jax.models import FactorizedModel


def _setup():
    traj = Trajectory.create(np.array([0.1, 0.05, 6, 3, 4, 0.01, 5, 7]))
    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)])
    return traj, model


class TestSample:
    @pytest.mark.slow
    def test_sample(self):
        traj, model = _setup()
        for seed in range(3):
            res = bild.sample(traj, model,
                              init_runs=5,
                              sampler_kw={"max_fev": 1000},
                              key=jax.random.key(seed))
            assert len(res.k) > 4
            assert np.argmax(res.evidence) >= 3
            assert np.all(res.evidence_se > 0)
            np.testing.assert_array_equal(res.best_profile()[:],
                                          res.best_profile(dE=2)[:])

        for dE in (None, 2, "average"):
            logpost = res.log_marginal_posterior(dE=dE)
            np.testing.assert_array_almost_equal(
                logsumexp(logpost, axis=0), np.zeros(logpost.shape[1]), decimal=6)

    @pytest.mark.slow
    def test_sample_long_lookahead(self):
        traj, model = _setup()
        res = bild.sample(traj, model,
                          init_runs=5,
                          sampler_kw={"N": 10, "max_fev": 100, "max_fcomplete": 10},
                          k_lookahead=5,
                          key=jax.random.key(10))
        for dE in (None, 2):
            logpost = res.log_marginal_posterior(dE=dE)
            np.testing.assert_array_almost_equal(
                logsumexp(logpost, axis=0), np.zeros(logpost.shape[1]), decimal=6)

    @pytest.mark.slow
    def test_sample_reproducible_from_key(self):
        # the key seeds device-side sampling AND the host-side choice RNG
        traj, model = _setup()
        kw = dict(init_runs=5,
                  sampler_kw={"N": 10, "max_fev": 100, "max_fcomplete": 10})
        res_a = bild.sample(traj, model, key=jax.random.key(7), **kw)
        res_b = bild.sample(traj, model, key=jax.random.key(7), **kw)
        for name in res_a.log:
            np.testing.assert_array_equal(res_a.log[name], res_b.log[name])
        np.testing.assert_array_equal(res_a.evidence, res_b.evidence)
        np.testing.assert_array_equal(res_a.best_profile()[:],
                                      res_b.best_profile()[:])

    @pytest.mark.slow
    def test_sample_small_kmax(self):
        traj, model = _setup()
        res = bild.sample(traj, model,
                          init_runs=5,
                          sampler_kw={"N": 10, "max_fev": 100, "max_fcomplete": 10},
                          k_lookahead=5,
                          k_max=3,
                          key=jax.random.key(11))
        assert len(res.k) <= 5  # k_max + 1 samplers at most (+ tolerance)
        for dE in (None, 2):
            logpost = res.log_marginal_posterior(dE=dE)
            np.testing.assert_array_almost_equal(
                logsumexp(logpost, axis=0), np.zeros(logpost.shape[1]), decimal=6)


class TestPostproc:
    def setup_method(self):
        self.traj, self.model = _setup()

    def test_optimize_boundary(self):
        bad = bild.Loopingprofile([0, 1, 1, 1, 0, 0, 0, 1])
        better = bild.postproc.optimize_boundary(bad, self.traj, self.model)
        np.testing.assert_array_equal(better[:], [0, 0, 1, 1, 1, 0, 1, 1])

        try:
            bild.postproc.optimize_boundary(bad, self.traj, self.model, max_iteration=2)
            assert False
        except RuntimeError:
            pass

        bad = bild.Loopingprofile([0, 1, 0, 1, 0, 0, 0, 1])
        try:
            bild.postproc.optimize_boundary(bad, self.traj, self.model)
            assert False
        except bild.postproc.BoundaryEliminationError:
            pass

        flat = bild.Loopingprofile([1, 1, 1, 1, 1, 1, 1, 1])
        out = bild.postproc.optimize_boundary(flat, self.traj, self.model, max_iteration=1)
        np.testing.assert_array_equal(out[:], flat[:])

    def test_optimize_boundary_batch_matches_single(self):
        from bild_jax.parallel import stack_trajectories

        profiles = np.array([
            [0, 1, 1, 1, 0, 0, 0, 1],   # converges
            [0, 1, 0, 1, 0, 0, 0, 1],   # single API raises elimination
            [1, 1, 1, 1, 1, 1, 1, 1],   # flat: no boundaries
        ])
        batch = stack_trajectories([self.traj] * 3)
        out, elim = bild.postproc.optimize_boundary_batch(
            profiles, batch, self.model)
        single = bild.postproc.optimize_boundary(
            bild.Loopingprofile(profiles[0]), self.traj, self.model)
        np.testing.assert_array_equal(out[0], single[:])
        assert not elim[0]
        assert elim[1]                 # flagged instead of raising
        np.testing.assert_array_equal(out[2], profiles[2])
        assert not elim[2]


class TestStats:
    def test_KM_survival(self):
        data = np.array([1.0, 2, 2, 3, 5, 6, 7])
        censored = np.array([0, 0, 0, 1, 0, 1, 0], dtype=bool)
        out = bild.stats.KM_survival(data, censored)
        assert out.shape[1] == 4
        S = out[:, 1]
        assert S[0] == 1
        assert np.all(np.diff(S) <= 1e-12)  # non-increasing
        # column convention follows the reference (bild/stats.py:54-56): with
        # z = ppf((1-conf)/2) < 0, column 2 is the numerically-upper band
        assert np.all((out[:, 3] <= S + 1e-12) & (S <= out[:, 2] + 1e-12))

    def test_MLE_censored_exponential(self, rng):
        true_mean = 3.0
        data = rng.exponential(true_mean, size=2000)
        cens_at = 5.0
        censored = data > cens_at
        data = np.minimum(data, cens_at)
        m, lo, hi = bild.stats.MLE_censored_exponential(data, censored)
        assert lo < m < hi
        assert abs(m - true_mean) < 0.3

    def test_dwell_times_extraction(self):
        # profile [0,1,1,0,0,1]: state-1 intervals are [1,3) observed
        # (2 steps) and [5,6) at the edge (1 step, censored); the state-0
        # first interval covers only frame 0 (profile[0] is the steady-state
        # selector, not a step) and is dropped, [3,5) is observed (2 steps)
        prof = [0, 1, 1, 0, 0, 1]
        dur, cen = bild.stats.dwell_times(prof, 1)
        np.testing.assert_array_equal(dur, [2.0, 1.0])
        np.testing.assert_array_equal(cen, [False, True])
        dur0, cen0 = bild.stats.dwell_times(prof, 0)
        np.testing.assert_array_equal(dur0, [2.0])
        np.testing.assert_array_equal(cen0, [False])

    def test_dwell_times_constant_profile_censored(self):
        dur, cen = bild.stats.dwell_times(np.full(5, 2), 2, dt=0.5)
        np.testing.assert_array_equal(dur, [2.0])   # 4 steps * dt
        np.testing.assert_array_equal(cen, [True])
        assert bild.stats.dwell_times(np.full(5, 2), 0)[0].size == 0

    def test_dwell_times_batched_and_ragged(self):
        batch = np.array([[0, 1, 1, 0, 0, 1],
                          [1, 1, 1, 1, 1, 1]])
        dur, cen = bild.stats.dwell_times(batch, 1)
        np.testing.assert_array_equal(dur, [2.0, 1.0, 5.0])
        np.testing.assert_array_equal(cen, [False, True, True])
        ragged = [np.array([0, 1, 1, 0]), np.array([1, 1])]
        dur_r, cen_r = bild.stats.dwell_times(ragged, 1)
        np.testing.assert_array_equal(dur_r, [2.0, 1.0])
        np.testing.assert_array_equal(cen_r, [False, True])
        # feeds the estimators directly
        out = bild.stats.KM_survival(dur, cen)
        assert out.shape[1] == 4
        m, lo, hi = bild.stats.MLE_censored_exponential(dur, cen)
        assert lo < m < hi


def test_sample_keyboard_interrupt_returns_partial_results(monkeypatch):
    """Manual interruption mid-inference still returns a valid (partial)
    SamplingResults — reference behavior `bild/core.py:231-236`."""
    from bild_jax.amis import sampler as sampler_mod

    traj, model = _setup()
    calls = {"n": 0}
    real_steps = sampler_mod.FixedkSampler.steps

    def interrupting_steps(self, n):
        calls["n"] += 1
        if calls["n"] > 3:
            raise KeyboardInterrupt
        return real_steps(self, n)

    monkeypatch.setattr(sampler_mod.FixedkSampler, "steps",
                        interrupting_steps)
    res = bild.sample(traj, model, init_runs=2, key=jax.random.key(11))
    assert calls["n"] > 3                       # the interrupt fired
    assert len(res.k) >= 1                      # partial samplers retained
    assert np.isfinite(res.evidence).any()
    prof = res.best_profile()                   # usable results
    assert len(prof) == len(traj)
