"""A minimal user-defined model (no `lockstep_fns_single`) must still run
through `FixedkSampler` — exercising the stepwise dispatch fallback — and
produce the same inference quality as the fused path gets for built-ins.

This is the public extension point: the reference only requires
``logL(profile, traj)`` of a model (`bild/models.py:82-97`); our analog is
``logL_batch`` plus `transitions`/`nStates`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bild_jax import Trajectory
from bild_jax.amis.sampler import FixedkSampler


class IIDGaussianModel:
    """Two-state iid model: state s emits N(mu_s, 1) per frame. Simple
    enough that the evidence landscape is analytic-ish, with no
    lockstep_fns_single — forcing the sampler's stepwise path."""

    def __init__(self, mus=(0.0, 3.0)):
        self.mus = np.asarray(mus, dtype=float)
        self.nStates = len(mus)
        self.transitions = ~np.eye(self.nStates, dtype=bool)

    def logL_batch(self, profiles, traj):
        profiles = np.asarray(profiles)
        y = np.asarray(traj.data)[:, 0]                      # (T,)
        valid = np.asarray(traj.valid)
        mu = self.mus[profiles]                              # (P, T)
        ll = -0.5 * ((y[None, :] - mu) ** 2 + np.log(2 * np.pi))
        return jnp.asarray((ll * valid[None, :]).sum(axis=1))


@pytest.fixture(scope="module")
def iid_case():
    model = IIDGaussianModel()
    rng = np.random.default_rng(7)
    true = np.zeros(20, dtype=int)
    true[8:14] = 1
    y = model.mus[true] + 0.6 * rng.normal(size=20)
    traj = Trajectory.create(y)
    return model, traj, true


def test_stepwise_fallback_engaged(iid_case):
    model, traj, true = iid_case
    s = FixedkSampler(traj, model, k=2, N=32, max_fev=4000,
                      max_fcomplete=0)
    assert s._fused is None                     # custom model: no fused path
    ran = s.steps(6)
    assert ran == 6
    assert len(s.evidences) == 6
    ev = np.array(s.evidences)
    assert np.all(np.isfinite(ev[:, :2]))
    # MAP profile recovers the two switches of the generating truth
    prof = np.asarray(s.MAP_profile()[:])
    assert np.mean(prof == true) > 0.85


def test_stepwise_matches_fused_semantics(iid_case):
    """steps(n) equals n x step() for the stepwise path too (PRNG
    discipline is shared with the fused dispatch)."""
    model, traj, _ = iid_case
    a = FixedkSampler(traj, model, k=1, N=16, max_fev=2000,
                      max_fcomplete=0, key=jax.random.key(5))
    b = FixedkSampler(traj, model, k=1, N=16, max_fev=2000,
                      max_fcomplete=0, key=jax.random.key(5))
    a.steps(4)
    for _ in range(4):
        b.step()
    np.testing.assert_allclose(np.array(a.evidences),
                               np.array(b.evidences), rtol=1e-6)
