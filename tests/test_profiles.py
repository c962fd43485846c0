"""Unit tests for profiles (mirrors reference tests/test_bild.py:51-121)."""
import numpy as np
import pytest
import jax.numpy as jnp

import bild_jax as bild
from bild_jax.profiles import st2profile, count_switches


class TestLoopingprofile:
    def setup_method(self):
        self.profile = bild.Loopingprofile([0, 0, 0, 1, 1, 0, 3, 3])

    def test_init(self):
        lp = bild.Loopingprofile()
        np.testing.assert_array_equal(lp.state, np.array([]))
        lp = bild.Loopingprofile([1, 2, 3])
        np.testing.assert_array_equal(lp.state, np.array([1, 2, 3]))

    def test_copy(self):
        new = self.profile.copy()
        np.testing.assert_array_equal(new.state, self.profile.state)
        new[2] = 5
        assert self.profile[2] == 0

    def test_operators(self):
        assert len(self.profile) == 8
        assert self.profile[3] == 1
        np.testing.assert_array_equal(self.profile[2:4], np.array([0, 1]))

        self.profile[2] = 3
        assert self.profile[2] == 3
        try:
            self.profile[5] = 3.74
            assert False, "float assignment should fail"
        except AssertionError:
            pass

        assert self.profile == bild.Loopingprofile([0, 0, 3, 1, 1, 0, 3, 3])
        assert self.profile != bild.Loopingprofile([1, 0, 3])

    def test_count_switches(self):
        assert self.profile.count_switches() == 3
        self.profile[5] = 1
        assert self.profile.count_switches() == 2
        self.profile[4] = 2
        assert self.profile.count_switches() == 4
        # device op agrees
        assert int(count_switches(jnp.asarray(self.profile.state))) == 4

    def test_intervals(self):
        ivs = self.profile.intervals()
        assert ivs == [(None, 3, 0), (3, 5, 1), (5, 6, 0), (6, None, 3)]
        ivs = bild.Loopingprofile([1, 1, 1, 1]).intervals()
        assert ivs == [(None, None, 1)]

    def test_plottable(self):
        t, y = self.profile.plottable()
        np.testing.assert_array_equal(t, np.array([-1, 2, 2, 4, 4, 5, 5, 7]))
        np.testing.assert_array_equal(y, np.array([0, 0, 1, 1, 0, 0, 3, 3]))


def test_state_probabilities():
    profiles = [bild.Loopingprofile([0, 1, 0, 1, 0]),
                bild.Loopingprofile([1, 1, 1, 1, 1])]
    np.testing.assert_array_equal(
        bild.state_probabilities(profiles),
        [[0.5, 0, 0.5, 0, 0.5], [0.5, 1, 0.5, 1, 0.5]],
    )
    np.testing.assert_array_equal(
        bild.state_probabilities(profiles, nStates=3),
        [[0.5, 0, 0.5, 0, 0.5], [0.5, 1, 0.5, 1, 0.5], [0, 0, 0, 0, 0]],
    )


class TestSt2Profile:
    def test_reference_case(self):
        # reference tests/test_amis.py:199-202
        prof = st2profile(jnp.array([0.25, 0.5, 0.25]), jnp.array([0, 1, 0]), T=6)
        np.testing.assert_array_equal(np.asarray(prof), [0, 0, 1, 1, 0, 0])

    def test_k0(self):
        prof = st2profile(jnp.array([1.0]), jnp.array([2]), T=5)
        np.testing.assert_array_equal(np.asarray(prof), [2, 2, 2, 2, 2])

    @pytest.mark.slow
    def test_matches_sequential_reference_algorithm(self, rng):
        # floor-based discretization, sequential overwrite semantics
        # (reference bild/amis.py:670-695)
        def reference_st2profile(s, theta, T):
            states = theta[0] * np.ones(T)
            if len(s) > 1:
                switchpos = np.cumsum(s)[:-1]
                switches = np.floor(switchpos * (T - 1)).astype(int) + 1
                for i in range(1, len(switches)):
                    states[switches[i - 1]:switches[i]] = theta[i]
                states[switches[-1]:] = theta[-1]
            return states.astype(int)

        for T in (2, 5, 17):
            for k in (0, 1, 2, 5):
                if k >= T:
                    continue
                for _ in range(20):
                    s = rng.dirichlet(np.ones(k + 1))
                    theta = rng.integers(0, 3, size=k + 1)
                    want = reference_st2profile(s, theta, T)
                    got = np.asarray(st2profile(jnp.asarray(s), jnp.asarray(theta), T))
                    np.testing.assert_array_equal(got, want)
