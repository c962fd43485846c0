"""
Looping profiles.

A looping profile is an integer state sequence; ``profile[t]`` is the model
state used to propagate *to* frame ``t``, and ``profile[0]`` selects the
steady-state ensemble the trajectory starts from (semantics of reference
``bild/util.py:10-24``).

Two representations coexist:

- `Loopingprofile`: a thin host-side wrapper (API-parity with reference
  ``bild/util.py:6-141``) for user interaction and post-processing.
- plain ``int32`` device arrays inside kernels; the functional helpers here
  (`count_switches`, `st2profile`, `state_probabilities_from_array`) operate
  on those and are jit/vmap-friendly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Loopingprofile",
    "state_probabilities",
    "count_switches",
    "st2profile",
]


class Loopingprofile:
    """
    Host-side profile wrapper. Reference parity: ``bild/util.py:6-141``.

    Operators: ``len``, get/setitem (integer dtype enforced on set), ``==``,
    plus `copy`, `count_switches`, `intervals`, `plottable`.
    """

    def __init__(self, states=None):
        if states is None:
            self.state = np.array([], dtype=int)
        else:
            self.state = np.asarray(states, dtype=int)

    def copy(self) -> "Loopingprofile":
        new = Loopingprofile()
        new.state = self.state.copy()
        return new

    def __len__(self):
        return len(self.state)

    def __getitem__(self, key):
        return self.state[key]

    def __setitem__(self, key, val):
        val = np.asarray(val)
        assert np.issubdtype(val.dtype, np.integer)
        self.state[key] = val

    def __eq__(self, other):
        try:
            if len(self) != len(other):
                return False
            return bool(np.all(self.state == np.asarray(other)))
        except Exception:
            return False

    def __array__(self, dtype=None):
        return self.state if dtype is None else self.state.astype(dtype)

    def __repr__(self):
        return f"Loopingprofile({self.state.tolist()})"

    def count_switches(self) -> int:
        return int(np.count_nonzero(self.state[1:] != self.state[:-1]))

    def _switch_frames(self) -> np.ndarray:
        """Indices of the first frame of each new interval (excluding 0)."""
        return np.flatnonzero(self.state[1:] != self.state[:-1]) + 1

    def intervals(self):
        """
        Constant-state intervals as ``(start, end, state)`` tuples; ``start``/
        ``end`` are ``None`` for the first/last interval (output format of
        reference ``bild/util.py:89-108``).
        """
        cuts = self._switch_frames().tolist()
        starts = [None, *cuts]
        ends = [*cuts, None]
        return [(a, b, int(self.state[0 if a is None else a]))
                for a, b in zip(starts, ends)]

    def plottable(self):
        """
        Step-function plotting coordinates (output format of reference
        ``bild/util.py:110-141``): each interval contributes a horizontal
        segment between its bounding edges, with the convention that frame
        ``t`` is drawn over ``(t-1, t]`` (the state *propagates to* frame t).
        """
        cuts = self._switch_frames()
        edges = np.concatenate(([0], cuts, [len(self.state)])) - 1
        t = np.repeat(edges, 2)[1:-1]
        y = np.repeat(self.state[np.concatenate(([0], cuts))], 2)
        return t, y


def state_probabilities(profiles, nStates=None) -> np.ndarray:
    """
    Marginal state probabilities over an ensemble of profiles.

    Reference parity: ``bild/util.py:143-169``. Returns ``(nStates, T)``.
    """
    allstates = np.array([np.asarray(profile)[:] for profile in profiles])
    if nStates is None:
        nStates = int(np.max(allstates)) + 1
    counts = np.array(
        [np.count_nonzero(allstates == i, axis=0) for i in range(nStates)]
    )
    return counts / allstates.shape[0]


# ---------------------------------------------------------------------------
# Functional (device) profile ops
# ---------------------------------------------------------------------------

def count_switches(states: jax.Array) -> jax.Array:
    """Number of switches in an int state array; jit/vmap friendly."""
    return jnp.count_nonzero(states[1:] != states[:-1])


def st2profile(s: jax.Array, theta: jax.Array, T: int, active=None) -> jax.Array:
    """
    Convert continuous parameters ``(s, θ)`` to a discrete ``(T,)`` profile.

    ``s`` is a ``(k+1,)`` vector of interval fractions (summing to 1), ``θ``
    the ``(k+1,)`` states. Discretization is the floor-based scheme of the
    reference (``bild/amis.py:670-695``, rationale ``bild/amis.py:30-44``):
    switch positions ``cumsum(s)[:k]`` in [0, 1) map to frame indices
    ``floor(pos * (T-1)) + 1``; frame ``t`` takes the state of the last
    switch at or before it.

    Fully vectorized (no per-switch loop): frame ``t`` takes
    ``θ[#switch positions <= t - 1]``, i.e. a counting comparison instead of
    sequential interval filling. vmap over leading axes of (s, θ) for batches.

    ``active`` (optional bool mask over slots, padded-k mode) hard-disables
    the switches INTO padded slots. This matters because the cumulative
    position at the end of the active slots is 1 only up to float round-off;
    ``1 - eps`` would otherwise floor to a spurious switch at the last frame.
    """
    theta = jnp.asarray(theta)
    s = jnp.asarray(s)
    k = s.shape[0] - 1
    if k == 0:
        return jnp.broadcast_to(theta[0], (T,)).astype(theta.dtype)
    switchpos = jnp.cumsum(s)[:-1]  # (k,) in [0, 1)
    switches = jnp.floor(switchpos * (T - 1)).astype(jnp.int32) + 1  # (k,)
    t_idx = jnp.arange(T, dtype=jnp.int32)
    # interval index at frame t = number of switches with switch <= t
    counts = switches[None, :] <= t_idx[:, None]
    if active is not None:
        counts = counts & jnp.asarray(active)[None, 1:]
    iv_idx = jnp.sum(counts, axis=1, dtype=jnp.int32)
    # theta[iv_idx] as a one-hot mul-sum instead of a (T,)-long gather from
    # a tiny (k+1,) vector: broadcasting over the k+1 axis fuses into
    # elementwise code
    onehot = iv_idx[:, None] == jnp.arange(k + 1, dtype=jnp.int32)[None, :]
    return jnp.sum(jnp.where(onehot, theta[None, :], 0), axis=1,
                   dtype=theta.dtype)
