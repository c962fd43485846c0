"""
Post-processing: greedy local optimization of profile boundaries.

Reference parity: ``bild/postproc.py``. Batched twist: each iteration
scores ALL candidate boundary moves (2 per boundary) in a single batched
likelihood call (`model.logL_batch`), replacing the reference's sequential
two-evaluations-per-boundary Python loop (``bild/postproc.py:46-58``).
`optimize_boundary_batch` goes one further: the whole greedy hill climb for
a TRAJECTORY BATCH runs as one jitted vmapped while_loop — the dataset-mode
companion to `parallel.sample_batch`.
"""
from __future__ import annotations

import numpy as np

from .profiles import Loopingprofile

__all__ = ["logLR_boundaries", "optimize_boundary",
           "optimize_boundary_batch", "BoundaryEliminationError"]


class BoundaryEliminationError(Exception):
    pass


def _candidate_moves(states):
    """All single-boundary moves of a profile.

    Returns (boundaries, candidates) where ``candidates[i, 0]`` moves
    boundary ``i`` left and ``candidates[i, 1]`` right.
    """
    boundaries = np.nonzero(np.diff(states))[0]  # boundary between b and b+1
    cands = np.empty((len(boundaries), 2, len(states)), dtype=int)
    for i, b in enumerate(boundaries):
        left = states.copy()
        left[b] = states[b + 1]
        right = states.copy()
        right[b + 1] = states[b]
        cands[i, 0] = left
        cands[i, 1] = right
    return boundaries, cands


def logLR_boundaries(profile, traj, model):
    """
    ``(k, 2)`` log-likelihood ratios for moving each boundary left/right
    (reference ``bild/postproc.py:13-59``), evaluated in one batch.
    """
    states = np.asarray(profile)[:]
    boundaries, cands = _candidate_moves(states)
    if len(boundaries) == 0:
        return np.array([])

    batch = np.concatenate([cands.reshape(-1, len(states)), states[None, :]])
    logLs = np.asarray(model.logL_batch(batch, traj), dtype=float)
    return logLs[:-1].reshape(len(boundaries), 2) - logLs[-1]


# boundary-climb runners cached by (logL_fn, shape config); bounded LRU like
# the lockstep runner cache
_BOUNDARY_RUNNERS = {}
_BOUNDARY_RUNNERS_MAX = 32


def _get_boundary_runner(logL_fn, T, Kb, max_iteration):
    cache_key = (logL_fn, T, Kb, max_iteration)
    if cache_key in _BOUNDARY_RUNNERS:
        return _BOUNDARY_RUNNERS[cache_key]
    while len(_BOUNDARY_RUNNERS) >= _BOUNDARY_RUNNERS_MAX:
        _BOUNDARY_RUNNERS.pop(next(iter(_BOUNDARY_RUNNERS)))

    import jax
    import jax.numpy as jnp

    def climb_one(states, pt):
        def body(carry):
            states, done, it, elim = carry
            d = states[1:] != states[:-1]
            pos = jnp.where(d, jnp.arange(T - 1), T)
            pos = jnp.sort(pos)[:Kb]                       # (Kb,)
            validb = pos < T
            nb = jnp.sum(validb)

            def mk(b):
                safe = jnp.minimum(b, T - 2)
                left = states.at[safe].set(states[safe + 1])
                right = states.at[safe + 1].set(states[safe])
                return left, right

            lefts, rights = jax.vmap(mk)(pos)              # (Kb, T) each
            cands = jnp.concatenate([lefts, rights, states[None]], axis=0)
            lls = logL_fn(cands, pt)                       # (2Kb+1,)
            gains = jnp.where(jnp.concatenate([validb, validb]),
                              lls[:-1] - lls[-1], -jnp.inf)
            i = jnp.argmax(gains)
            pos_gain = gains[i] > 0
            winner = cands[i]
            nb2 = jnp.sum(winner[1:] != winner[:-1])
            # a legal move shifts a boundary, never merges or drops one
            elim_now = pos_gain & (nb2 != nb) & ~done
            take = pos_gain & ~elim_now & ~done
            states = jnp.where(take, winner, states)
            newly_done = ~pos_gain | elim_now | (nb == 0)
            return states, done | newly_done, it + 1, elim | elim_now

        def cond(carry):
            _, done, it, _ = carry
            return (~done) & (it < max_iteration)

        states, done, it, elim = jax.lax.while_loop(
            cond, body, (states, jnp.asarray(False),
                         jnp.zeros((), jnp.int32), jnp.asarray(False)))
        return states, elim, done

    runner = jax.jit(jax.vmap(climb_one))
    _BOUNDARY_RUNNERS[cache_key] = runner
    return runner


def optimize_boundary_batch(profiles, batch, model, max_iteration=10000):
    """
    Greedy boundary hill climb for a whole trajectory batch in ONE jitted
    program: per iteration every trajectory's candidate moves (2 per
    boundary) are scored by the model's lockstep likelihood, the best
    positive move is taken, and trajectories freeze as they converge.

    Parameters: ``profiles (B, T)`` int states (e.g.
    ``BatchResults.best_profile()``), ``batch`` the matching
    `TrajectoryBatch`, ``model`` exposing ``lockstep_fns``.

    Returns ``(profiles (B, T), eliminated (B,))``. Semantics per trajectory
    match `optimize_boundary`, except that where the single-trajectory API
    raises `BoundaryEliminationError` the batch freezes that trajectory at
    its pre-elimination profile and flags it. Raises ``RuntimeError`` if any
    trajectory exceeds ``max_iteration``.
    """
    import jax.numpy as jnp

    profiles = np.asarray(profiles, dtype=int)
    B, T = profiles.shape
    Kb = int(np.max(np.sum(profiles[:, 1:] != profiles[:, :-1], axis=1),
                    initial=0))
    if Kb == 0 or T < 2:
        return profiles.copy(), np.zeros(B, dtype=bool)

    per_traj, logL_fn = model.lockstep_fns(batch)
    runner = _get_boundary_runner(logL_fn, T, Kb, max_iteration)
    states, elim, done = runner(jnp.asarray(profiles, jnp.int32), per_traj)
    done = np.asarray(done)
    if not np.all(done):
        raise RuntimeError(f"Exceeded max_iteration = {max_iteration}")
    return np.asarray(states), np.asarray(elim)


def optimize_boundary(profile, traj, model, max_iteration=10000):
    """
    Greedy hill climb on boundary positions (semantics of reference
    ``bild/postproc.py:64-117``). Raises `BoundaryEliminationError` if the
    best move would change the number of boundaries — i.e. shrink an
    interval to nothing, usually a sign the original sampling was too thin —
    and ``RuntimeError`` if ``max_iteration`` is exceeded.
    """
    states = np.asarray(profile)[:].copy()
    for _ in range(max_iteration):
        boundaries, cands = _candidate_moves(states)
        if len(boundaries) == 0:
            break

        batch = np.concatenate([cands.reshape(-1, len(states)), states[None, :]])
        logLs = np.asarray(model.logL_batch(batch, traj), dtype=float)
        gain = logLs[:-1].reshape(len(boundaries), 2) - logLs[-1]

        i, j = np.unravel_index(np.argmax(gain), gain.shape)
        if gain[i, j] <= 0:
            break
        winner = cands[i, j]
        # a legal move shifts a boundary; it never merges or drops one
        if np.count_nonzero(np.diff(winner)) != len(boundaries):
            raise BoundaryEliminationError(
                f"best move would eliminate the boundary after frame {boundaries[i]}")
        states = winner
    else:
        raise RuntimeError(f"Exceeded max_iteration = {max_iteration}")

    return Loopingprofile(states)
