"""
Factorized (time-scale-separated, HMM-like) model. Reference parity:
``FactorizedModel``, ``bild/models.py:372-534``.

Accelerator twist: the per-trajectory log-likelihood table (nStates x T) is
precomputed once on host (the distributions are arbitrary host callables,
e.g. scipy frozen distributions or KDEs) and shipped to device; profile
likelihoods are then a masked gather-sum, batched over profiles in one call
(replaces the per-frame Python list comprehension at reference
``bild/models.py:483-485``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import fdtype
from ..profiles import Loopingprofile
from ..trajectory import Trajectory
from .base import MultiStateModel

__all__ = ["FactorizedModel"]


class FactorizedModel(MultiStateModel):
    """
    Each frame's distance is drawn iid from a per-state distribution.

    ``distributions`` need a ``logpdf()`` accepting arrays; ``rvs()`` is
    needed only for `trajectory_from_loopingprofile`. Localization error is
    assumed baked into the distributions (reference notes,
    ``bild/models.py:394-399``), so ``traj.localization_error`` is ignored.
    """

    def __init__(self, distributions, d=3):
        self.distributions = list(distributions)
        self._d = d
        self._known_trajs = {}
        self.init_transitions(len(self.distributions))

    @property
    def d(self):
        return self._d

    def _fingerprint_parts(self):
        # distributions are arbitrary host callables; their logpdf sampled
        # on a fixed wide grid is the likelihood-relevant content
        probe = np.geomspace(1e-6, 1e6, 256)
        with np.errstate(divide="ignore", invalid="ignore",
                         under="ignore", over="ignore"):
            vals = [np.asarray(dist.logpdf(probe), dtype=float)
                    for dist in self.distributions]
        return [[self._d], *vals]

    # -- memoized logL table ----------------------------------------------
    def _memo(self, traj: Trajectory):
        if traj not in self._known_trajs:
            mags = np.asarray(traj.magnitudes())            # (T,), 0 at missing
            with np.errstate(divide="ignore", invalid="ignore"):
                table = np.array([dist.logpdf(mags) for dist in self.distributions])
            table = np.where(np.asarray(traj.valid)[None, :], table, 0.0)
            self._known_trajs[traj] = {
                "logL_table": jnp.asarray(table, dtype=fdtype()),  # (n, T)
            }
        return self._known_trajs[traj]

    def clear_memo(self):
        self._known_trajs = {}

    def _segment_table(self, traj):
        # NaN-free, missing frames already zeroed (equal score under every
        # state, so segmentation ignores them)
        return np.asarray(self._memo(traj)["logL_table"])

    # -- likelihood --------------------------------------------------------
    def logL(self, profile, traj) -> float:
        return float(self.logL_batch(np.asarray(profile)[None, :], traj)[0])

    def logL_batch(self, profiles, traj) -> jax.Array:
        table = self._memo(traj)["logL_table"]              # (n, T), 0 at missing
        profiles = jnp.asarray(profiles, dtype=jnp.int32)   # (P, T)
        n = table.shape[0]
        vals = jnp.zeros(profiles.shape, dtype=table.dtype)
        for s in range(n):
            vals = jnp.where(profiles == s, table[s][None, :], vals)
        return jnp.sum(vals, axis=1)

    def lockstep_segment_tables(self, batch) -> np.ndarray:
        """``(B, n, T)`` per-frame state-score tables for a batch (used for
        DP-segmentation informed initialization); masked frames score 0.
        Cached per batch object: `lockstep_fns` and the informed-init path
        both need it, and the host scipy evaluation is the expensive part."""
        if getattr(self, "_seg_cache_src", None) is batch.data:
            return self._seg_cache
        mags = np.linalg.norm(np.asarray(batch.data), axis=-1)      # (B, T)
        with np.errstate(divide="ignore", invalid="ignore", under="ignore"):
            tables = np.stack([dist.logpdf(mags) for dist in self.distributions],
                              axis=1)                                # (B, n, T)
        tables = np.where(np.asarray(batch.valid)[:, None, :], tables, 0.0)
        self._seg_cache_src = batch.data
        self._seg_cache = tables
        return tables

    def lockstep_fns(self, batch):
        """
        Lockstep-mode hooks (see ``MultiStateRouse.lockstep_fns``): the
        per-trajectory data is the precomputed ``(n, T)`` logL table (host
        scipy evaluations, batched once up front); the traceable likelihood
        is a masked gather-sum.
        """
        tables = jnp.asarray(self.lockstep_segment_tables(batch), dtype=fdtype())

        # stable logL_fn (cached on the model) so fused-step jit caches
        # persist across sampler instances
        if not hasattr(self, "_lockstep_logL_fn"):
            n = len(self.distributions)

            def logL_fn(profiles, per_traj):
                (table,) = per_traj                                  # (n, T)
                vals = jnp.zeros(profiles.shape, dtype=table.dtype)
                for s in range(n):
                    vals = jnp.where(profiles == s, table[s][None, :], vals)
                return jnp.sum(vals, axis=1)

            self._lockstep_logL_fn = logL_fn

        return (tables,), self._lockstep_logL_fn

    # -- convenience -------------------------------------------------------
    def initial_loopingprofile(self, traj) -> Loopingprofile:
        """
        MLE profile: per observed frame the argmax state, extended across
        missing frames by the segment-filling rule of the reference
        (``bild/models.py:453-481``): frames up to and including an observed
        frame take that frame's best state.
        """
        table = np.asarray(self._memo(traj)["logL_table"])
        valid = np.asarray(traj.valid)
        valid_times = np.nonzero(valid)[0]
        best_states = np.argmax(table[:, valid_times], axis=0)

        states = np.zeros(len(traj), dtype=int)
        states[: valid_times[0] + 1] = best_states[0]
        last_time = valid_times[0]
        for cur_time, cur_state in zip(valid_times[1:], best_states[1:]):
            states[last_time + 1 : cur_time + 1] = cur_state
            last_time = cur_time
        if last_time < len(traj):
            states[last_time + 1 :] = best_states[-1]
        return Loopingprofile(states)

    def trajectory_from_loopingprofile(self, profile,
                                       localization_error=0.0,
                                       missing_frames=None,
                                       key: Optional[jax.Array] = None) -> Trajectory:
        """
        Sample magnitudes from the per-state distributions and isotropic
        orientations (reference ``bild/models.py:487-534``). The distributions
        are host callables, so sampling runs on host; ``key``, if given, seeds
        the orientation draw deterministically.
        """
        localization_error = self._preproc_localization_error(localization_error)
        profile = np.asarray(profile, dtype=int)
        T = len(profile)
        missing_frames = self._preproc_missing_frames(missing_frames, T)

        magnitudes = np.array([self.distributions[s].rvs() for s in profile])
        if key is not None:
            dirs = np.asarray(jax.random.normal(key, (T, self.d)))
        else:
            dirs = np.random.normal(size=(T, self.d))
        data = dirs * (magnitudes / np.linalg.norm(dirs, axis=1))[:, None]
        data[missing_frames, :] = np.nan

        return Trajectory.create(data,
                                 localization_error=localization_error,
                                 loopingprofile=profile)
