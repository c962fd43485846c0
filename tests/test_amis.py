"""AMIS layer tests (mirrors reference tests/test_amis.py)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats
from conftest import logsumexp_safe as logsumexp

import bild_jax as bild
from bild_jax.amis import Dirichlet, CFC, FixedkSampler
from bild_jax import Trajectory
from bild_jax.models import FactorizedModel


class TestDirichlet:
    def test_logpdf_edge(self):
        # a < 1 with s == 0 -> +inf (reference tests/test_amis.py:51-54)
        lp = Dirichlet().logpdf(np.array([0.5, 4.0]), np.array([[0.0, 1.0]]))
        assert np.asarray(lp)[0] == np.inf

    def test_logpdf_matches_scipy(self, rng):
        a = np.array([0.7, 2.0, 1.3])
        ss = rng.dirichlet(a, size=20)
        want = stats.dirichlet(a).logpdf(ss.T)
        got = np.asarray(Dirichlet().logpdf(a, ss))
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_methodofmoments(self):
        ss = np.array([[0.0, 1.0], [0.5, 0.5], [1.0, 0.0]])
        a = np.asarray(Dirichlet().estimate(ss, np.zeros(len(ss))))
        np.testing.assert_allclose(a, [0.25, 0.25], rtol=1e-12)
        a = np.asarray(Dirichlet().estimate(ss, np.array([1, 1, -np.inf])))
        np.testing.assert_allclose(a, [0.5, 1.5], rtol=1e-12)

    def test_sample_shapes(self):
        s = Dirichlet().sample(jax.random.key(0), np.ones(3), N=7)
        assert s.shape == (7, 3)
        np.testing.assert_allclose(np.sum(np.asarray(s), axis=1), 1.0, rtol=1e-6)


class TestCFC:
    def test_pathological(self):
        # impossible to leave state 1 (reference tests/test_amis.py:66-97)
        cfc = CFC([[0, 1, 1], [0, 0, 0], [1, 1, 0]])
        log_marg = cfc.uniform_marginals(4)
        np.testing.assert_array_equal(log_marg[1, :-1], -np.inf)
        assert log_marg[1, -1] != -np.inf

        logp = np.asarray(cfc.logp_uniform(4))
        np.testing.assert_array_equal(logp[1, :-1], -np.inf)
        assert logp[1, -1] != -np.inf

        # impossible to enter state 1
        cfc = CFC([[0, 0, 1], [1, 0, 1], [1, 0, 0]])
        log_marg = cfc.uniform_marginals(4)
        np.testing.assert_array_equal(log_marg[1, 1:], -np.inf)
        assert log_marg[1, 0] != -np.inf

        logp = np.asarray(cfc.logp_uniform(4))
        np.testing.assert_array_equal(logp[1, 1:], -np.inf)
        assert logp[1, 0] != -np.inf

        logf = -np.log(2) * np.ones(3)
        logf[1] = -np.inf
        logp = np.asarray(cfc.solve_marginals_single(logf, np.array([-np.inf, 0.0, -np.inf])))
        np.testing.assert_array_equal(logp, logf)

    def test_full_sample(self):
        cfc = CFC([[0, 1, 1], [1, 0, 0], [1, 1, 0]])
        np.testing.assert_array_equal(cfc.full_sample(0), [[0], [1], [2]])
        np.testing.assert_array_equal(
            cfc.full_sample(1), [[0, 1], [0, 2], [1, 0], [2, 0], [2, 1]])

        cfc = CFC([[0, 1, 1], [1, 0, 0], [0, 1, 0]])
        np.testing.assert_array_equal(
            cfc.full_sample(1), [[0, 1], [0, 2], [1, 0], [2, 1]])

        try:
            cfc.full_sample(100)
            assert False
        except ValueError:
            pass

        cfc = CFC([[0, 0, 1], [1, 0, 0], [0, 1, 0]])
        np.testing.assert_array_equal(cfc.full_sample(1), [[0, 2], [1, 0], [2, 1]])
        assert len(cfc.full_sample(5)) == 3

    def test_sample(self):
        cfc = CFC([[0, 1, 1], [1, 0, 0], [1, 1, 0]])
        key = jax.random.key(17)
        for k in range(5):
            full = cfc.full_sample(k)
            key, sub = jax.random.split(key)
            sample = np.asarray(cfc.sample(sub, cfc.logp_uniform(k), N=10 * len(full)))
            eq = np.sum(sample[:, None, :] == full[None, :, :], axis=-1) == k + 1
            # every sampled trace is in the full sample, exactly once
            np.testing.assert_array_equal(np.sum(eq, axis=1), 1)
            # every trace appears
            assert np.all(np.sum(eq, axis=0) > 0)

    def test_logpmf(self):
        cfc = CFC([[0, 1, 1], [1, 0, 1], [1, 1, 0]])
        sample = cfc.full_sample(4)
        logL = np.asarray(cfc.logpmf(jnp.ones((3, 5)), jnp.asarray(sample)))
        np.testing.assert_allclose(logL, logL[0], rtol=1e-10)

        cfc = CFC([[0, 1, 0], [0, 0, 1], [1, 0, 0]])
        sample = cfc.full_sample(9)
        logL = np.asarray(cfc.logpmf(jnp.zeros((3, 10)), jnp.asarray(sample)))
        np.testing.assert_allclose(logL, -np.log(3), rtol=1e-10)

    def test_estimate(self, rng):
        cfc = CFC([[0, 1, 1], [1, 0, 0], [1, 1, 0]])
        logp = np.log(1 - rng.random((3, 3)))
        logp -= logsumexp(logp, axis=0)
        sample = cfc.sample(jax.random.key(3), jnp.asarray(logp), N=500)
        est = np.asarray(cfc.estimate(sample, np.zeros(500)))
        assert np.all(np.abs(np.exp(est) - np.exp(logp)) < 0.2)

        try:
            cfc.MOM_maxiter = 0
            cfc.estimate(sample, np.zeros(500))
            assert False
        except RuntimeError:
            pass

    def test_logp_from_marginals(self):
        # inverting the uniform marginals must reproduce the uniform weights
        # (reference bild/amis.py:307-334 & :451-472 are consistent this way)
        cfc = CFC([[0, 1, 1], [1, 0, 1], [1, 1, 0]])
        k = 3
        logp = np.asarray(cfc.logp_from_marginals(cfc.uniform_marginals(k)))
        expect = np.asarray(cfc.logp_uniform(k))
        np.testing.assert_allclose(np.exp(logp), np.exp(expect), atol=2e-2)

        # non-convergence raises, like estimate
        cfc.MOM_maxiter = 0
        try:
            cfc.logp_from_marginals(cfc.uniform_marginals(k))
            assert False
        except RuntimeError:
            pass

    def test_N_total(self):
        cfc = CFC([[0, 1, 1], [1, 0, 1], [1, 1, 0]])
        for k in range(10):
            assert cfc.N_total(k) == 3 * 2**k

        cfc = CFC([[0, 1, 0], [1, 0, 1], [0, 1, 0]])
        assert cfc.N_total(0) == 3
        assert cfc.N_total(1) == 4
        assert cfc.N_total(2) == 6

        cfc = CFC([[0, 1, 0], [0, 0, 1], [1, 0, 0]])
        for k in range(10):
            assert cfc.N_total(k) == 3


class TestFixedkSampler:
    def setup_method(self):
        self.traj = Trajectory.create(np.array([0.1, 1, 2, 3, 4, 5]))
        self.model = FactorizedModel([stats.maxwell(scale=0.1),
                                      stats.maxwell(scale=1.0)])

    def test_st2profile(self):
        sampler = FixedkSampler(self.traj, self.model, k=2)
        profile = sampler.st2profile([0.25, 0.5, 0.25], [0, 1, 0])
        np.testing.assert_array_equal(profile[:], [0, 0, 1, 1, 0, 0])

    def test_logL(self):
        sampler = FixedkSampler(self.traj, self.model, k=1)
        ss = np.array([[0.1, 0.9], [0.5, 0.5], [0.9, 0.1]])
        thetas = np.array([[1, 0], [1, 0], [1, 0]])
        logLs = np.asarray(sampler.logL(ss, thetas))
        assert np.all(np.isfinite(logLs))

    def test_sampling(self):
        sampler0 = FixedkSampler(self.traj, self.model, k=0)
        assert not sampler0.step()  # auto-exhaustive at k=0
        np.testing.assert_array_equal(sampler0.MAP_profile()[:], [1, 1, 1, 1, 1, 1])

        sampler1 = FixedkSampler(self.traj, self.model, k=1)
        assert not sampler1.step()
        np.testing.assert_array_equal(sampler1.MAP_profile()[:], [0, 1, 1, 1, 1, 1])

        assert sampler1.tstat(sampler0) > 10

        sampler2 = FixedkSampler(self.traj, self.model, k=2,
                                 N=10, max_fev=25, key=jax.random.key(5))
        assert sampler2.step()
        assert sampler2.step()
        assert not sampler2.step()  # max_fev exhausted after 2 steps

        samplerK = FixedkSampler(self.traj, self.model, k=10)
        assert not samplerK.step()  # k >= len(traj): degenerate
        assert samplerK.evidences[-1][0] == -np.inf

        # marginal posteriors normalize
        logpost = sampler1.log_marginal_posterior()
        np.testing.assert_array_almost_equal(
            logsumexp(logpost, axis=0), np.zeros(logpost.shape[1]), decimal=6)
        logpost = sampler2.log_marginal_posterior()
        np.testing.assert_array_almost_equal(
            logsumexp(logpost, axis=0), np.zeros(logpost.shape[1]), decimal=6)

    def test_marginal_posterior_nan_weight_gets_zero_weight(self):
        """A NaN log-weight (logL=-inf sample whose mixture density also hit
        -inf) must be dropped, not poison every frame of the marginals —
        same convention as the evidence sum in amis_update. Regression:
        the lockstep marginals path fed unmasked log-weights and a single
        such sample turned the whole (n, T) posterior NaN."""
        from bild_jax.amis.sampler import _marginal_posterior

        ss = jnp.asarray([[0.5, 0.5], [0.25, 0.75]])
        th = jnp.asarray([[0, 1], [1, 0]], dtype=jnp.int32)
        lw = jnp.asarray([0.0, np.nan])
        logpost = np.asarray(_marginal_posterior(ss, th, lw, T=4, nStates=2))
        assert not np.isnan(logpost).any()
        # only the first sample contributes: profile [0,0,1,1]
        expect = np.where(np.array([[1, 1, 0, 0], [0, 0, 1, 1]]), 0.0, -np.inf)
        np.testing.assert_allclose(logpost, expect)

    def test_evidence_sanity_vs_exhaustive(self):
        # AMIS evidence should approach the exhaustively-computed evidence
        sampler_ex = FixedkSampler(self.traj, self.model, k=1)
        assert sampler_ex.exhausted and sampler_ex._exhaustive is not None
        logev_exact = sampler_ex.evidences[-1][0]

        sampler = FixedkSampler(self.traj, self.model, k=1,
                                max_fcomplete=0,  # forbid exhaustive
                                N=100, max_fev=20000, key=jax.random.key(7))
        assert sampler._exhaustive is None
        for _ in range(30):
            sampler.step()
        logev, dlogev, KL = sampler.evidences[-1]
        assert abs(logev - logev_exact) < max(5 * dlogev, 0.1)

    @pytest.mark.slow
    def test_steps_batched_matches_stepwise(self):
        # steps(n) must sample identically to n sequential step() calls
        # (same PRNG split sequence inside the fused loop)
        a = FixedkSampler(self.traj, self.model, k=2, max_fcomplete=0,
                          N=30, max_fev=600, key=jax.random.key(11))
        b = FixedkSampler(self.traj, self.model, k=2, max_fcomplete=0,
                          N=30, max_fev=600, key=jax.random.key(11))
        for _ in range(5):
            assert a.step()
        assert b.steps(5) == 5
        np.testing.assert_allclose(np.asarray(a.evidences),
                                   np.asarray(b.evidences), rtol=1e-6)
        assert a.n_steps_host == b.n_steps_host == 5
        # budget cap: steps() never runs past max_fev exhaustion
        ran = b.steps(100)
        assert b.exhausted
        assert (b.n_steps_host + 1) * b.N >= b.max_fev

    def test_log_proposal_api(self):
        # reference-API surface (bild/amis.py:697-715): joint density of
        # (ss, thetas) under given (a, logp) parameters
        from scipy.stats import dirichlet as sp_dirichlet
        s = FixedkSampler(self.traj, self.model, k=2, max_fcomplete=0,
                          N=20, max_fev=200, key=jax.random.key(0))
        a = np.array([2.0, 3.0, 1.5])
        logp = np.log(np.full((2, 3), 0.5))
        rngl = np.random.default_rng(0)
        ss = rngl.dirichlet(a, size=4)
        thetas = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0], [1, 0, 1]])
        got = s.log_proposal((a, logp), ss, thetas)
        want_dir = np.array([sp_dirichlet.logpdf(x, a) for x in ss])
        want_cfc = np.asarray(s.cfc.logpmf(logp, thetas))
        np.testing.assert_allclose(got, want_dir + want_cfc, rtol=1e-5)
