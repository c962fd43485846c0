"""
Model interface (reference parity: ``MultiStateModel`` ABC,
``bild/models.py:24-160``).

The one addition over the reference interface is `logL_batch`: inference on
an accelerator evaluates likelihoods for a *batch* of profiles in one device call (the
reference explicitly loops profiles one by one, ``bild/amis.py:734-739``).
Models should override it with a vectorized implementation; the base version
is a correct host-side fallback.
"""
from __future__ import annotations

import abc

import numpy as np

from ..profiles import Loopingprofile

__all__ = ["MultiStateModel"]


class MultiStateModel(metaclass=abc.ABCMeta):
    """
    Abstract base class for inference models.

    Required: `logL` (and ideally `logL_batch`), `nStates`, `d`,
    ``transitions``. Recommended: `initial_loopingprofile`,
    `trajectory_from_loopingprofile`.

    ``transitions[i, j]`` says whether the switch ``i -> j`` is allowed;
    `init_transitions` allows everything but self-transitions (reference
    ``bild/models.py:49-50``).
    """

    def init_transitions(self, n: int):
        self.transitions = ~np.eye(n, dtype=bool)

    def _fingerprint_parts(self):
        """Subclass hook for `likelihood_fingerprint`: a list of
        array-likes that together determine the model's likelihood (and
        segmentation scores). ``None`` (the default) means "cannot
        fingerprint"."""
        return None

    def likelihood_fingerprint(self):
        """Stable hex digest of everything that determines this model's
        likelihood values, or ``None`` if the model cannot provide one.

        `parallel.sample_dataset` keys its chunk checkpoints on this, so a
        rerun with a re-parametrized model (e.g. after a
        `fit.calibrate_rouse` round) recomputes instead of silently
        loading stale results. Custom subclasses get checkpoint keying on
        data/configuration only unless they override
        `_fingerprint_parts`."""
        parts = self._fingerprint_parts()
        if parts is None:
            return None
        import hashlib
        h = hashlib.sha256()
        h.update(type(self).__name__.encode())
        h.update(np.ascontiguousarray(self.transitions).tobytes())
        for p in parts:
            a = np.ascontiguousarray(np.asarray(p, dtype=np.float64))
            h.update(repr(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    @property
    def nStates(self) -> int:
        return self.transitions.shape[0]

    @property
    def d(self) -> int:
        raise NotImplementedError  # pragma: no cover

    def initial_loopingprofile(self, traj) -> Loopingprofile:
        """Default: a random profile (reference ``bild/models.py:66-80``)."""
        return Loopingprofile(np.random.choice(self.nStates, size=len(traj)))

    @abc.abstractmethod
    def logL(self, loopingprofile, traj) -> float:
        """Log-likelihood of a (profile, trajectory) pair."""
        raise NotImplementedError  # pragma: no cover

    def logL_batch(self, profiles, traj):
        """
        Log-likelihoods for a ``(P, T)`` int array of profiles.

        Base fallback: host loop over `logL`. Override with a device-batched
        implementation.
        """
        profiles = np.asarray(profiles)
        return np.array([
            self.logL(Loopingprofile(p), traj) for p in profiles
        ])

    def _segment_table(self, traj):
        """``(n, T)`` per-frame state-score table for DP segmentation, or
        ``None`` if the model has no frame-factorized approximation."""
        return None

    def segment_guess(self, traj, k):
        """
        Informed ``(s_fractions, theta)`` initialization for a k-switch AMIS
        proposal: the optimal k-segmentation of the model's frame-factorized
        score table (`bild_jax.infer.segment.dp_segment`). ``None`` when
        unavailable or infeasible.
        """
        table = self._segment_table(traj)
        if table is None:
            return None
        from ..infer.segment import dp_segment, profile_to_st

        profile, score = dp_segment(np.asarray(table), k, self.transitions)
        if profile is None:
            return None
        return profile_to_st(profile)

    def lockstep_segment_tables(self, batch):
        """``(B, n, T)`` frame-factorized score tables for a batch, or
        ``None`` (no factorized approximation — lockstep informed-init then
        falls back to uniform, mirroring `segment_guess`)."""
        return None

    def lockstep_fns_single(self, traj):
        """
        ``(per_traj, logL_fn)`` for ONE trajectory, where ``logL_fn(profiles,
        per_traj)`` is jit-traceable — enables the fused single-dispatch AMIS
        step. Default: derive from ``lockstep_fns`` on a singleton batch;
        models without a traceable likelihood simply don't define
        ``lockstep_fns`` and samplers fall back to the split step.
        """
        import jax
        from ..parallel.batch import TrajectoryBatch

        batch = TrajectoryBatch(data=traj.data[None], valid=traj.valid[None])
        per_traj, logL_fn = self.lockstep_fns(batch)
        per_traj = jax.tree_util.tree_map(lambda x: x[0], per_traj)
        return per_traj, logL_fn

    # -- generative-path preprocessing (reference ``bild/models.py:99-160``)
    def _preproc_localization_error(self, localization_error):
        if np.isscalar(localization_error):
            localization_error = self.d * [localization_error]
        localization_error = np.asarray(localization_error, dtype=float)
        if localization_error.shape != (self.d,):
            raise ValueError("Did not understand localization_error")
        return localization_error

    def _preproc_missing_frames(self, missing_frames, T, rng=None):
        """
        Resolve the ``missing_frames`` argument: None/0 = none; float in
        (0, 1) = per-frame drop probability; int = that many random frames;
        array = explicit indices.
        """
        rng = np.random if rng is None else rng
        if missing_frames is None or (np.isscalar(missing_frames) and missing_frames == 0):
            return np.array([], dtype=int)
        if np.isscalar(missing_frames):
            if 0 < missing_frames < 1:
                return np.nonzero(rng.rand(T) < missing_frames)[0]
            return rng.choice(T, size=int(missing_frames), replace=False).astype(int)
        return np.asarray(missing_frames, dtype=int)
