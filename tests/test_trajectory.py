"""Trajectory container tests (noctiluca-subset surface, SURVEY.md 2.16)."""
import numpy as np

from bild_jax import Trajectory, make_trajectory


def test_create_1d():
    traj = Trajectory.create(np.array([1.0, 2.0, np.nan, 4.0]), localization_error=[0.5])
    assert len(traj) == 4
    assert traj.d == 1
    assert traj.count_valid_frames() == 3
    np.testing.assert_array_equal(np.asarray(traj.valid), [True, True, False, True])
    # NaN-sentinel view preserved
    assert np.isnan(traj[:][2, 0])
    assert traj[0] == [1.0]


def test_make_trajectory_coercions():
    t1 = make_trajectory(np.arange(5.0))
    assert (t1.T, t1.d) == (5, 1)

    t2 = make_trajectory(np.ones((7, 3)))
    assert (t2.T, t2.d) == (7, 3)

    # two loci -> relative trajectory
    x = np.zeros((2, 4, 3))
    x[1] = 1.0
    t3 = make_trajectory(x)
    assert (t3.T, t3.d) == (4, 3)
    np.testing.assert_allclose(np.asarray(t3.data), 1.0)

    # passthrough
    assert make_trajectory(t3) is t3


def test_localization_error_broadcast():
    traj = Trajectory.create(np.ones((4, 3)), localization_error=0.5)
    np.testing.assert_allclose(np.asarray(traj.localization_error), [0.5, 0.5, 0.5])


def test_abs_and_magnitudes():
    data = np.array([[3.0, 4.0], [np.nan, np.nan], [0.0, 1.0]])
    traj = Trajectory.create(data)
    mag = traj.abs()
    assert mag.d == 1
    np.testing.assert_allclose(mag[:][~np.isnan(mag[:][:, 0]), 0], [5.0, 1.0])
    np.testing.assert_allclose(np.asarray(traj.magnitudes())[[0, 2]], [5.0, 1.0])


def test_hash_eq_memoizable():
    a = Trajectory.create(np.arange(4.0))
    b = Trajectory.create(np.arange(4.0))
    c = Trajectory.create(np.arange(4.0) + 1)
    assert a == b and hash(a) == hash(b)
    assert a != c
    d = {a: 1}
    assert d[b] == 1
