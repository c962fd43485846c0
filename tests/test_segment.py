"""DP segmentation + informed proposal initialization."""
import itertools

import numpy as np
import pytest
import jax

import bild_jax as bild
from bild_jax import Trajectory
from bild_jax.infer.segment import dp_segment
from bild_jax.models import MultiStateRouse, FactorizedModel
from bild_jax.parallel import sample_batch


def test_dp_segment_matches_bruteforce(rng):
    for _ in range(15):
        n = int(rng.integers(2, 4))
        T = int(rng.integers(3, 8))
        k = int(rng.integers(0, min(3, T - 1) + 1))
        table = rng.normal(size=(n, T))
        trans = ~np.eye(n, dtype=bool)

        best_score = -np.inf
        for prof in itertools.product(range(n), repeat=T):
            prof = np.array(prof)
            if np.count_nonzero(prof[1:] != prof[:-1]) != k:
                continue
            best_score = max(best_score, table[prof, np.arange(T)].sum())

        got, gscore = dp_segment(table, k, trans)
        if not np.isfinite(best_score):
            assert got is None or not np.isfinite(gscore)
            continue
        assert np.count_nonzero(got[1:] != got[:-1]) == k
        np.testing.assert_allclose(gscore, best_score, rtol=1e-12)


def test_dp_segment_respects_transitions(rng):
    trans = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=bool)  # cycle
    table = rng.normal(size=(3, 10))
    prof, _ = dp_segment(table, 3, trans)
    for a, b in zip(prof[:-1], prof[1:]):
        assert a == b or trans[a, b]


def test_dp_segment_infeasible():
    prof, score = dp_segment(np.zeros((2, 4)), 10)
    assert prof is None and score == -np.inf


@pytest.mark.slow
def test_segment_guess_models(rng):
    model = MultiStateRouse(10, 1, 5, d=1, localization_error=0.2)
    true = np.zeros(50, dtype=int)
    true[20:35] = 1
    traj = model.trajectory_from_loopingprofile(true, key=jax.random.key(0))
    fracs, theta = model.segment_guess(traj, 2)
    assert len(fracs) == 3 and len(theta) == 3
    np.testing.assert_allclose(np.sum(fracs), 1.0)
    assert np.all(theta[1:] != theta[:-1])

    # GGM derives frame scores from its interval-table diagonal
    from bild_jax.models import GenericGaussianModel
    ggm = GenericGaussianModel([
        [(GenericGaussianModel.MSD_function_powerlaw(), 0.0, 1)],
        [(GenericGaussianModel.MSD_function_powerlaw(G=2.0), 0.0, 1)],
    ])
    g = ggm.segment_guess(traj, 1)
    assert g is not None
    fracs, theta = g
    assert len(fracs) == 2 and len(theta) == 2
    np.testing.assert_allclose(np.sum(fracs), 1.0)


@pytest.mark.slow
def test_informed_init_improves_long_T():
    model = MultiStateRouse(10, 1, 5, d=1, localization_error=0.1)
    T, B = 300, 4
    profs = np.zeros((B, T), dtype=int)
    profs[:, 100:200] = 1
    batch = model.trajectories_from_loopingprofiles(profs, key=jax.random.key(0))
    res_u = sample_batch(model, batch, k_max=3, steps_per_k=8, N=128,
                         key=jax.random.key(1))
    res_i = sample_batch(model, batch, k_max=3, steps_per_k=8, N=128,
                         key=jax.random.key(1), informed_init=True)
    acc_u = np.mean(res_u.best_profile() == profs)
    acc_i = np.mean(res_i.best_profile() == profs)
    assert acc_i >= acc_u - 0.01  # informed never meaningfully worse
    assert acc_i > 0.95


@pytest.mark.slow
def test_informed_init_adaptive():
    from bild_jax.amis import FixedkSampler
    model = MultiStateRouse(10, 1, 5, d=1, localization_error=0.1)
    true = np.zeros(200, dtype=int)
    true[60:140] = 1
    traj = model.trajectory_from_loopingprofile(true, key=jax.random.key(2))
    s = FixedkSampler(traj, model, k=2, max_fcomplete=0, N=64, max_fev=1000,
                      key=jax.random.key(3), informed_init=True)
    for _ in range(10):
        s.step()
    acc = np.mean(s.MAP_profile()[:] == true)
    assert acc > 0.95


def test_dp_segment_handles_neg_inf():
    # -inf scores (e.g. bounded-support distributions) must not silently
    # corrupt the DP through prefix-sum cancellation
    rng = np.random.default_rng(5)
    table = rng.normal(size=(2, 20))
    table[0, 5] = -np.inf
    table[1, 12] = -np.inf
    prof, score = dp_segment(table, 2)
    assert np.isfinite(score)
    # the -inf cells are avoided (never forced here: alternatives exist)
    assert prof[5] != 0 and prof[12] != 1
    # score consistent with the table evaluated on the clamped copy (atol:
    # prefix sums pass through the 1e6-scale sentinel, costing ~1e-10 abs)
    clamped = np.clip(np.nan_to_num(table, neginf=-1e6), -1e6, 1e6)
    np.testing.assert_allclose(score, clamped[prof, np.arange(20)].sum(),
                               atol=1e-7)


def test_dp_segment_all_consistent(rng):
    from bild_jax.infer.segment import dp_segment_all
    table = rng.normal(size=(3, 15))
    profs, scores = dp_segment_all(table, 4)
    for k in range(5):
        p_k, s_k = dp_segment(table, k)
        np.testing.assert_array_equal(profs[k], p_k)
        np.testing.assert_allclose(scores[k], s_k, rtol=1e-12)
        assert np.count_nonzero(profs[k][1:] != profs[k][:-1]) == k
