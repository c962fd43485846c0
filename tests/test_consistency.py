"""Cross-implementation consistency: the adaptive driver, the lockstep
runner, and exhaustive enumeration must agree on evidences and conclusions
for the same data."""
import numpy as np
import pytest
import jax
from scipy import stats as sp_stats

import bild_jax as bild
from bild_jax import Trajectory
from bild_jax.amis import FixedkSampler
from bild_jax.models import FactorizedModel
from bild_jax.parallel import stack_trajectories, sample_batch


@pytest.mark.slow
def test_lockstep_matches_exhaustive_evidence():
    # T=8 trajectory: k <= 2 spaces are exhaustively enumerable -> exact
    # evidences to compare the lockstep AMIS estimates against
    traj = Trajectory.create(np.array([0.1, 0.05, 6, 3, 4, 5, 6, 7]))
    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)])

    exact = {}
    for k in (0, 1, 2):
        s = FixedkSampler(traj, model, k=k)  # auto-exhaustive
        assert s.exhausted and s._exhaustive is not None
        exact[k] = s.evidences[-1][0]

    batch = stack_trajectories([traj])
    res = sample_batch(model, batch, k_max=2, steps_per_k=25, N=128,
                       key=jax.random.key(0))
    for k in (0, 1, 2):
        se = max(res.evidence_se[0, k], 1e-3)
        assert abs(res.evidence[0, k] - exact[k]) < 6 * se + 0.1, (
            k, res.evidence[0, k], exact[k])


@pytest.mark.slow
def test_adaptive_and_lockstep_agree_on_best_k():
    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)], d=1)
    prof = np.array([0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0], dtype=int)
    traj = model.trajectory_from_loopingprofile(prof, key=jax.random.key(3))

    res_a = bild.sample(traj, model, init_runs=5,
                        sampler_kw={"max_fev": 2000}, key=jax.random.key(4))
    res_l = sample_batch(model, stack_trajectories([traj]),
                         k_max=4, steps_per_k=20, N=128,
                         key=jax.random.key(5))
    assert res_a.best_k() == int(res_l.best_k()[0])
    np.testing.assert_array_equal(res_a.best_profile()[:],
                                  res_l.best_profile()[0])
