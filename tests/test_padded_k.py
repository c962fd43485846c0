"""Padded-k AMIS: the masked proposal math must agree exactly with the
unpadded computation restricted to the active slots, and padded samplers
must reproduce exact-k evidences."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats

from bild_jax import Trajectory
from bild_jax.amis import FixedkSampler
from bild_jax.amis.cfc import CFC, cfc_logpmf, cfc_estimate, cfc_sample
from bild_jax.amis.dirichlet import (dirichlet_logpdf, dirichlet_estimate,
                                     dirichlet_sample_masked)
from bild_jax.models import FactorizedModel


def _padded_case(rng, k=2, K=6, N=40, n=3):
    active = np.arange(K + 1) < (k + 1)
    a = np.concatenate([rng.uniform(0.5, 3.0, size=k + 1), np.ones(K - k)])
    ss = np.zeros((N, K + 1))
    ss[:, : k + 1] = rng.dirichlet(a[: k + 1], size=N)
    trans = ~np.eye(n, dtype=bool)
    cfc = CFC(trans)
    th_act = np.asarray(cfc.sample(jax.random.key(1), cfc.logp_uniform(k), N=N))
    th = np.concatenate([th_act, rng.integers(0, n, size=(N, K - k))], axis=1)
    logp = np.full((n, K + 1), -np.log(n))
    logp[:, : k + 1] = np.asarray(cfc.logp_uniform(k))
    lw = rng.normal(size=N)
    return active, a, ss, th, logp, lw, trans, cfc, k, n


def test_masked_dirichlet_matches_sliced(rng):
    active, a, ss, th, logp, lw, trans, cfc, k, n = _padded_case(rng)
    got = np.asarray(dirichlet_logpdf(jnp.asarray(a), jnp.asarray(ss),
                                      active=jnp.asarray(active)))
    want = np.asarray(dirichlet_logpdf(jnp.asarray(a[: k + 1]),
                                       jnp.asarray(ss[:, : k + 1])))
    np.testing.assert_allclose(got, want, rtol=1e-10)

    est = np.asarray(dirichlet_estimate(jnp.asarray(ss), jnp.asarray(lw),
                                        active=jnp.asarray(active)))
    want_est = np.asarray(dirichlet_estimate(jnp.asarray(ss[:, : k + 1]),
                                             jnp.asarray(lw)))
    np.testing.assert_allclose(est[: k + 1], want_est, rtol=1e-10)
    np.testing.assert_allclose(est[k + 1:], 1.0)


def test_masked_dirichlet_sample(rng):
    active = jnp.asarray(np.arange(5) < 3)
    a = jnp.asarray([2.0, 1.0, 0.5, 1.0, 1.0])
    ss = np.asarray(dirichlet_sample_masked(jax.random.key(0), a, active, 2000))
    assert ss.shape == (2000, 5)
    np.testing.assert_allclose(ss[:, 3:], 0.0)
    np.testing.assert_allclose(np.sum(ss, axis=1), 1.0, rtol=1e-6)
    # means match Dirichlet(2, 1, 0.5)
    np.testing.assert_allclose(np.mean(ss[:, :3], axis=0),
                               np.array([2, 1, 0.5]) / 3.5, atol=0.03)


@pytest.mark.slow
def test_masked_cfc_matches_sliced(rng):
    active, a, ss, th, logp, lw, trans, cfc, k, n = _padded_case(rng)
    got = np.asarray(cfc_logpmf(jnp.asarray(logp), jnp.asarray(th),
                                jnp.asarray(trans), active=jnp.asarray(active)))
    want = np.asarray(cfc_logpmf(jnp.asarray(logp[:, : k + 1]),
                                 jnp.asarray(th[:, : k + 1]), jnp.asarray(trans)))
    np.testing.assert_allclose(got, want, rtol=1e-10)

    est, conv = cfc_estimate(jnp.asarray(th), jnp.asarray(lw), jnp.asarray(trans),
                             n, active=jnp.asarray(active))
    est_w, conv_w = cfc_estimate(jnp.asarray(th[:, : k + 1]), jnp.asarray(lw),
                                 jnp.asarray(trans), n)
    assert bool(conv) and bool(conv_w)
    np.testing.assert_allclose(np.asarray(est)[:, : k + 1], np.asarray(est_w),
                               rtol=1e-10)

    # padded sampling never dies even with restrictive transitions
    trans_cycle = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=bool)
    sample = np.asarray(cfc_sample(jax.random.key(2), jnp.asarray(logp),
                                   jnp.asarray(trans_cycle), 50,
                                   active=jnp.asarray(active)))
    assert sample.shape == (50, 7)


class TestPaddedSampler:
    def setup_method(self):
        self.traj = Trajectory.create(np.array([0.1, 1, 2, 3, 4, 5, 0.2, 0.1]))
        self.model = FactorizedModel([stats.maxwell(scale=0.1),
                                      stats.maxwell(scale=1.0)])

    @pytest.mark.slow
    def test_padded_matches_exact_evidence(self):
        for k in (2, 3):
            exact = FixedkSampler(self.traj, self.model, k=k, max_fcomplete=0,
                                  N=100, max_fev=5000, key=jax.random.key(5))
            padded = FixedkSampler(self.traj, self.model, k=k, max_fcomplete=0,
                                   N=100, max_fev=5000, key=jax.random.key(6),
                                   k_pad=6)
            for _ in range(20):
                exact.step()
                padded.step()
            le, se, _ = exact.evidences[-1]
            lp, sp, _ = padded.evidences[-1]
            assert abs(le - lp) < 5 * np.sqrt(se**2 + sp**2) + 0.05, (k, le, lp)
            # MAP profiles are equally good (different RNG streams may land
            # on different near-optimal profiles)
            lL_e = self.model.logL(exact.MAP_profile(), self.traj)
            lL_p = self.model.logL(padded.MAP_profile(), self.traj)
            assert abs(lL_e - lL_p) < 2.0, (k, lL_e, lL_p)

    @pytest.mark.slow
    def test_padded_posterior_normalized(self):
        from scipy.special import logsumexp

        s = FixedkSampler(self.traj, self.model, k=1, max_fcomplete=0,
                          N=50, max_fev=500, key=jax.random.key(7), k_pad=5)
        for _ in range(5):
            s.step()
        logpost = s.log_marginal_posterior()
        with np.errstate(under="ignore"):
            np.testing.assert_array_almost_equal(
                logsumexp(logpost, axis=0), np.zeros(logpost.shape[1]), decimal=6)
