"""
Multi-state Rouse model (reference parity: ``MultiStateRouse``,
``bild/models.py:163-370``), built on the batched physics
(`bild_jax.physics.RouseModel`) and batched Kalman kernel
(`bild_jax.ops.kalman`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.stats

import jax
import jax.numpy as jnp

from ..config import fdtype, MATMUL_PRECISION
from ..physics.rouse import RouseModel
from ..profiles import Loopingprofile
from ..trajectory import Trajectory
from ..ops.kalman import msrouse_logL_batch
from ..ops.kalman_cuda import MAX_N, msrouse_logL_cuda


@jax.jit
def _assoc_batch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata, valid):
    """Profile-vmapped temporal-parallel filter (`ops.assoc_kalman`).

    Module-level jit: the cache keys on shapes AND input shardings, so the
    time-sharded path (committed inputs from `logL_batch_assoc`) compiles
    once per (mesh, shape) instead of per call."""
    return jax.vmap(lambda p: msrouse_logL_assoc(
        Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, p, ydata, valid))(profiles)


@jax.jit
def _gen_batch(Bs, Gs, L_sigs, w, L_sss, M_sss, err, profiles, keys):
    """Batched generative model body for `trajectories_from_loopingprofiles`.

    Module-level jit (not a per-call ``jax.jit(vmap(closure))``): the cache
    keys on shapes/dtypes, so repeated chunked generation compiles once —
    a per-call closure retraced+recompiled ~4.5 s per 1024x100 chunk, half
    the steady-state wall of the 10k dataset benchmark."""
    def gen_one(profile, key):
        k0, k_scan, k_noise = jax.random.split(key, 3)
        eta0 = jax.random.normal(k0, (Bs.shape[1], M_sss.shape[-1]),
                                 dtype=M_sss.dtype)
        conf0 = (M_sss[profile[0]]
                 + jnp.matmul(L_sss[profile[0]], eta0,
                              precision=MATMUL_PRECISION))
        T = profile.shape[0]
        etas = jax.random.normal(k_scan, (T - 1,) + conf0.shape,
                                 dtype=conf0.dtype)

        def step(conf, x):
            st, eta = x
            conf = (jnp.matmul(Bs[st], conf, precision=MATMUL_PRECISION)
                    + Gs[st]
                    + jnp.matmul(L_sigs[st], eta,
                                 precision=MATMUL_PRECISION))
            return conf, jnp.matmul(w, conf, precision=MATMUL_PRECISION)

        _, meas = jax.lax.scan(step, conf0, (profile[1:], etas))
        data = jnp.concatenate(
            [jnp.matmul(w, conf0, precision=MATMUL_PRECISION)[None], meas])
        noise = jax.random.normal(k_noise, data.shape, dtype=data.dtype)
        return data + err[None, :] * noise

    return jax.vmap(gen_one)(profiles, keys)


def _select_kernel(dtype, N):
    """The Rouse likelihood path for the default backend, ``dtype`` and
    monomer count ``N``: the CUDA kernel (`ops.kalman_cuda`) for float32 on
    a GPU, where it holds one covariance row per warp lane (N <= 32); the
    XLA scan (`ops.kalman`) everywhere else."""
    if (dtype == jnp.float32 and jax.default_backend() == "gpu"
            and N <= MAX_N):
        return msrouse_logL_cuda
    return msrouse_logL_batch


from ..experimental.assoc_kalman import msrouse_logL_assoc
from .base import MultiStateModel

__all__ = ["MultiStateRouse"]


class MultiStateRouse(MultiStateModel):
    """
    Switch between per-state Rouse dynamics along the trajectory.

    Parameters (mirroring reference ``bild/models.py:222-249``)
    ----------
    N : int                 number of monomers
    D, k : float            free-monomer diffusion constant, backbone spring
    d : int                 spatial dimension
    looppositions : sequence
        one entry per state: ``None`` (no extra bond), a ``(left, right[,
        rel_strength])`` tuple, or a list of such tuples. ``(i, i+1, -1)``
        removes backbone bond ``i``.
    measurement : "end2end" or (N,) array
        measured linear combination of monomers; "end2end" = last - first.
    localization_error : None, float, or (d,) array
        model-side noise; if ``None``, use ``traj.localization_error``.
    dt : float              frame interval
    """

    def __init__(self, N, D, k, d=3,
                 looppositions=(None, (0, -1)),
                 measurement="end2end",
                 localization_error=None,
                 dt=1.0):
        self._d = d

        if isinstance(measurement, str) and measurement == "end2end":
            measurement = np.zeros(N)
            measurement[0] = -1
            measurement[-1] = 1
        measurement = np.asarray(measurement, dtype=float)
        assert len(measurement) == N
        self.measurement = measurement

        if localization_error is not None:
            if np.isscalar(localization_error):
                localization_error = localization_error * np.ones(d)
            localization_error = np.asarray(localization_error, dtype=float)
            if localization_error.shape != (d,):
                raise ValueError(
                    f"localization_error should be scalar or shape ({d},); "
                    f"got shape {localization_error.shape}"
                )
        self.localization_error = localization_error

        self.models = []
        for loop in looppositions:
            if loop is not None and np.isscalar(loop[0]):
                loop = (tuple(loop),)
            elif loop is not None:
                loop = tuple(tuple(b) for b in loop)
            self.models.append(RouseModel(N=N, D=D, k=k, d=d, dt=dt, add_bonds=loop))

        self.init_transitions(len(self.models))

        # stacked per-state dynamics, consumed by the batched kernel
        dtype = fdtype()
        self.Bs = jnp.stack([m.B for m in self.models])
        self.Gs = jnp.stack([m.G for m in self.models])
        self.Sigs = jnp.stack([m.Sig for m in self.models])
        self.M0s = jnp.stack([m.M_ss for m in self.models])
        self.C0s = jnp.stack([m.C_ss for m in self.models])
        self.L_sigs = jnp.stack([m.L_sig for m in self.models])
        self.w = jnp.asarray(measurement, dtype=dtype)
        self._filter_Sigs = self._unobserved_com_noise_removed(measurement)

    def _unobserved_com_noise_removed(self, measurement):
        """The likelihood's copy of ``Sigs``. The uniform (centre-of-mass)
        mode diffuses freely, so its variance grows along a trajectory. A
        measurement with ``sum(w) = 0`` (end-to-end) never sees it, but in
        float32 the growing variance costs digits in ``w C w`` by
        cancellation (~1e-5 relative at T=1000). Every ``B_s``, ``Sig_s``
        and ``C_ss`` has the uniform vector as an eigenvector (translation
        invariance), so projecting it out of ``Sig`` leaves the likelihood
        unchanged."""
        if abs(measurement.sum()) > 1e-12 * np.abs(measurement).sum():
            return self.Sigs
        N = len(measurement)
        proj = np.eye(N) - np.full((N, N), 1.0 / N)
        Sigs = np.asarray(self.Sigs, dtype=np.float64)
        return jnp.asarray(proj @ Sigs @ proj, dtype=self.Sigs.dtype)

    @property
    def d(self):
        return self._d

    def _fingerprint_parts(self):
        # the per-state dynamics (B, G, Sig, steady state) + measurement
        # vector + model noise fully determine the Kalman likelihood;
        # localization_error=None (per-trajectory noise) is a distinct
        # configuration, encoded by a sentinel
        err = (np.asarray([-1.0]) if self.localization_error is None
               else np.asarray(self.localization_error, dtype=float))
        return [[self._d], err, self.w, self.Bs, self.Gs, self.Sigs,
                self.M0s, self.C0s]

    # -- noise handling (reference ``bild/models.py:255-263``) -------------
    def _get_noise(self, traj) -> np.ndarray:
        if self.localization_error is not None:
            return np.asarray(self.localization_error)
        if getattr(traj, "localization_error", None) is not None:
            err = np.asarray(traj.localization_error)
            if err.ndim == 0:
                err = err * np.ones(self.d)
            return err
        raise ValueError(
            "No localization error specified (use model.localization_error "
            "or Trajectory.localization_error)"
        )

    def _noise_arrays(self, traj):
        err = self._get_noise(traj)
        unique, Cind = np.unique(err, return_inverse=True)
        return (jnp.asarray(unique**2, dtype=fdtype()),
                Cind.astype(np.int32))

    # -- likelihood --------------------------------------------------------
    def logL(self, profile, traj) -> float:
        """Rouse likelihood of one profile, via the batched Kalman kernel."""
        return float(self.logL_batch(np.asarray(profile)[None, :], traj)[0])

    def logL_batch(self, profiles, traj) -> jax.Array:
        """
        ``(P,)`` log-likelihoods for a ``(P, T)`` profile batch — the hot
        path (replaces the per-profile loop at reference ``bild/amis.py:734-739``),
        on the kernel `_select_kernel` picks for the backend, dtype and N.

        States must lie in ``[0, nStates)``; out-of-range states yield NaN
        (device code cannot raise).
        """
        s2, Cind = self._noise_arrays(traj)
        profiles = jnp.asarray(profiles, dtype=jnp.int32)
        args = (self.Bs, self.Gs, self._filter_Sigs, self.M0s, self.C0s,
                self.w, s2, Cind, profiles, traj.data, traj.valid)
        return _select_kernel(self.Bs.dtype, self.Bs.shape[-1])(*args)

    def logL_batch_assoc(self, profiles, traj, mesh=None, time_axis="time"):
        """
        ``(P,)`` log-likelihoods via the temporal-parallel associative-scan
        filter (`bild_jax.ops.assoc_kalman`) — the sequence-parallelism path
        for very long trajectories.

        On a single chip the sequential kernels win whenever a profile batch
        exists to saturate the device (measured guidance in
        ``ops/assoc_kalman.py``), so this is NOT auto-dispatched. Measured
        crossover rule (``tools/assoc_crossover.py``; DESIGN.md section 5,
        on a virtual CPU mesh): the associative
        formulation costs ~7-15x the sequential scan's work at P=1 and
        25-100x at P>=8, so time-sharding pays only for latency-critical
        SINGLE-profile evaluation of very long trajectories (T >~ 1e4) on a
        time axis of >~10-16 devices, or when ``T`` exceeds one chip's
        memory budget. With a ``mesh``, frames are sharded over
        ``mesh.shape[time_axis]`` devices and the O(log T) composition rides
        XLA collectives; parity vs the sequential kernel is tested through
        T=8192 with missing frames.
        """
        s2, Cind = self._noise_arrays(traj)
        Cind = jnp.asarray(Cind)
        profiles = jnp.asarray(profiles, dtype=jnp.int32)
        args = (self.Bs, self.Gs, self._filter_Sigs, self.M0s, self.C0s,
                self.w, s2, Cind)

        if mesh is None:
            return _assoc_batch(*args, profiles, traj.data, traj.valid)

        # committed input shardings drive the partitioning; the jitted
        # function is module-level so repeat calls (same shapes+shardings)
        # hit the jit cache instead of recompiling the sharded program
        from jax.sharding import NamedSharding, PartitionSpec as P
        t_sh = NamedSharding(mesh, P(time_axis))
        td_sh = NamedSharding(mesh, P(time_axis, None))
        pt_sh = NamedSharding(mesh, P(None, time_axis))
        return _assoc_batch(*args,
                            jax.device_put(profiles, pt_sh),
                            jax.device_put(jnp.asarray(traj.data), td_sh),
                            jax.device_put(jnp.asarray(traj.valid), t_sh))

    def lockstep_fns(self, batch):
        """
        Lockstep-mode hooks: ``(per_traj, logL_fn)`` where ``per_traj`` is a
        pytree with leading batch axis and ``logL_fn(profiles, per_traj)`` is
        a traceable single-trajectory batched likelihood (vmapped by the
        runner). Requires model-level ``localization_error`` (a shared noise
        model across the dataset). The closure is cached on the model so
        runner jit caches stay warm across `sample_batch` calls.
        """
        if self.localization_error is None:
            raise ValueError("lockstep batch mode needs model.localization_error")
        # cached: downstream runner caches (and their jits) key on this
        # closure's identity
        if not hasattr(self, "_lockstep_fn"):
            unique, Cind = np.unique(self.localization_error, return_inverse=True)
            s2 = jnp.asarray(unique**2, dtype=fdtype())
            Cind = Cind.astype(np.int32)
            Bs, Gs, Sigs, M0s, C0s, w = (self.Bs, self.Gs, self._filter_Sigs,
                                         self.M0s, self.C0s, self.w)
            kern = _select_kernel(Bs.dtype, Bs.shape[-1])

            def logL_fn(profiles, per_traj):
                ydata, valid = per_traj
                return kern(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                            profiles, ydata, valid)

            self._lockstep_fn = logL_fn

        return (batch.data, batch.valid), self._lockstep_fn

    def lockstep_fns_single(self, traj):
        """Fused-step hooks for one trajectory; unlike `lockstep_fns`, the
        localization error may come from the trajectory itself. The returned
        ``logL_fn`` is cached per noise configuration so downstream jit
        caches (the fused AMIS step) stay warm across sampler instances."""
        err_key = tuple(self._get_noise(traj).tolist())
        if not hasattr(self, "_single_fns"):
            self._single_fns = {}
        if err_key not in self._single_fns:
            # bounded: datasets with per-trajectory noise would otherwise
            # accumulate one closure (+ downstream compiled step) per value
            while len(self._single_fns) >= 16:
                self._single_fns.pop(next(iter(self._single_fns)))
            s2, Cind = self._noise_arrays(traj)
            Bs, Gs, Sigs, M0s, C0s, w = (self.Bs, self.Gs, self._filter_Sigs,
                                         self.M0s, self.C0s, self.w)
            fn = _select_kernel(Bs.dtype, Bs.shape[-1])

            def logL_fn(profiles, per_traj):
                ydata, valid = per_traj
                return fn(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                          profiles, ydata, valid)

            self._single_fns[err_key] = logL_fn
        return (traj.data, traj.valid), self._single_fns[err_key]

    def _segment_table(self, traj):
        """Frame-factorized scores via the steady-state Maxwell approximation
        (the same approximation behind `initial_loopingprofile`)."""
        if not hasattr(self, "_factorized_cache"):
            self._factorized_cache = self.toFactorized()
        return self._factorized_cache._segment_table(traj)

    def lockstep_segment_tables(self, batch):
        """``(B, n, T)`` frame-factorized score tables for a batch."""
        if not hasattr(self, "_factorized_cache"):
            self._factorized_cache = self.toFactorized()
        return self._factorized_cache.lockstep_segment_tables(batch)

    # -- convenience -------------------------------------------------------
    def initial_loopingprofile(self, traj) -> Loopingprofile:
        return self.toFactorized().initial_loopingprofile(traj)

    def trajectory_from_loopingprofile(self, profile,
                                       localization_error=None,
                                       missing_frames=None,
                                       key: Optional[jax.Array] = None) -> Trajectory:
        """
        Generative model (reference ``bild/models.py:295-350``): sample a
        steady-state conformation for ``profile[0]``, evolve with the
        state-selected dynamics (one ``lax.scan``), measure, add noise.

        ``key`` is an explicit JAX PRNG key; if omitted, one is drawn from
        numpy's global RNG (keeps reference-style implicit seeding usable).
        """
        if localization_error is None:
            if self.localization_error is None:
                raise ValueError("Need localization_error or model.localization_error")
            localization_error = self.localization_error
        localization_error = self._preproc_localization_error(localization_error)

        profile = np.asarray(profile, dtype=int)
        T = len(profile)
        missing_frames = self._preproc_missing_frames(missing_frames, T)

        if key is None:
            key = jax.random.key(np.random.randint(2**31))
        k0, k_scan, k_noise = jax.random.split(key, 3)

        conf0 = self.models[profile[0]].conf_ss(k0)
        states = jnp.asarray(profile[1:], dtype=jnp.int32)
        etas = jax.random.normal(k_scan, (T - 1,) + conf0.shape, dtype=conf0.dtype)

        Bs, Gs, L_sigs, w = self.Bs, self.Gs, self.L_sigs, self.w

        def step(conf, x):
            st, eta = x
            conf = (jnp.matmul(Bs[st], conf, precision=MATMUL_PRECISION)
                    + Gs[st]
                    + jnp.matmul(L_sigs[st], eta, precision=MATMUL_PRECISION))
            return conf, jnp.matmul(w, conf, precision=MATMUL_PRECISION)

        _, meas = jax.lax.scan(step, conf0, (states, etas))
        data = jnp.concatenate([jnp.matmul(w, conf0, precision=MATMUL_PRECISION)[None],
                                meas], axis=0)  # (T, d)

        noise = jax.random.normal(k_noise, data.shape, dtype=data.dtype)
        data = np.array(data + jnp.asarray(localization_error)[None, :] * noise)
        data[missing_frames, :] = np.nan

        return Trajectory.create(data,
                                 localization_error=localization_error,
                                 loopingprofile=profile)

    def trajectories_from_loopingprofiles(self, profiles, localization_error=None,
                                          key=None):
        """
        Batched generative model: sample one trajectory per row of the
        ``(B, T)`` int profile array in a single vmapped scan (one device
        dispatch instead of B; the per-trajectory `trajectory_from_loopingprofile`
        costs a dispatch round-trip each). Returns a
        `bild_jax.parallel.TrajectoryBatch`.
        """
        from ..parallel.batch import TrajectoryBatch

        if localization_error is None:
            if self.localization_error is None:
                raise ValueError("Need localization_error or model.localization_error")
            localization_error = self.localization_error
        localization_error = self._preproc_localization_error(localization_error)

        profiles = jnp.asarray(np.asarray(profiles, dtype=int), dtype=jnp.int32)
        B, T = profiles.shape
        if key is None:
            key = jax.random.key(np.random.randint(2**31))

        L_sss = jnp.stack([m.L_ss for m in self.models])
        err = jnp.asarray(localization_error, dtype=fdtype())

        keys = jax.random.split(key, B)
        data = _gen_batch(self.Bs, self.Gs, self.L_sigs, self.w,
                          L_sss, self.M0s, err, profiles, keys)
        return TrajectoryBatch(data=data, valid=jnp.ones((B, T), dtype=bool),
                               lengths=jnp.full((B,), T))

    def toFactorized(self):
        """
        Time-scale-separated approximation: per-state Maxwell distributions
        from the steady-state measurement variance (reference
        ``bild/models.py:352-370``).
        """
        from .factorized import FactorizedModel

        noise2_per_d = (
            float(np.sum(self.localization_error**2)) / self.d
            if self.localization_error is not None else 0.0
        )
        distributions = []
        for mod in self.models:
            _, C = mod.steady_state()
            s2 = float(self.w @ C @ self.w) + noise2_per_d
            distributions.append(scipy.stats.maxwell(scale=np.sqrt(s2)))
        return FactorizedModel(distributions, d=self.d)
