"""
Lockstep batched inference — the dataset-scale throughput mode.

The reference has no driver for multi-trajectory inference (users loop
externally; ``bild/amis.py:732-733`` even rejects intra-trajectory
parallelism). This module is the batched answer: run the SAME fixed
schedule of AMIS steps for every trajectory in a batch, with every step
``vmap``-ed over trajectories and the whole per-k program one ``jit``. Under
a device mesh the batch axis shards over devices (pure data parallelism);
the optional ``prof`` axis shards the AMIS proposal batch.

Control-flow difference vs the adaptive `bild_jax.sample` (by design):
no per-trajectory active learning — every k in ``0..k_max`` gets
``steps_per_k`` AMIS steps. The evidence maximum + dE rule then picks
``best_k`` per trajectory, exactly as in the adaptive mode.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..config import fdtype
from ..amis.cfc import CFC
from ..amis.sampler import AmisState, amis_propose, amis_update, _marginal_posterior
from ..profiles import st2profile
from ..trajectory import Trajectory

__all__ = ["TrajectoryBatch", "BatchResults", "stack_trajectories",
           "bucket_trajectories", "pad_batch_rows", "sample_batch"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrajectoryBatch:
    """A stacked, padded batch of trajectories: ``data (B, T, d)``,
    ``valid (B, T)`` (padding frames are simply invalid), and optional
    ``lengths (B,)`` — each trajectory's TRUE frame count, which the
    ``k >= len(traj)`` unidentifiability guard needs (a short trajectory
    padded into a long bucket must not earn finite evidence for k at or
    beyond its own frame count)."""

    data: jax.Array
    valid: jax.Array
    lengths: Optional[jax.Array] = None

    @property
    def B(self):
        return self.data.shape[0]

    @property
    def T(self):
        return self.data.shape[1]


def stack_trajectories(trajs: Sequence[Trajectory], T_pad: Optional[int] = None) -> TrajectoryBatch:
    """Stack `Trajectory` objects, padding to the longest (or ``T_pad``)."""
    T_max = max(len(t) for t in trajs)
    T_pad = T_max if T_pad is None else T_pad
    if T_pad < T_max:
        raise ValueError(f"T_pad={T_pad} < longest trajectory ({T_max})")
    d = trajs[0].d
    B = len(trajs)
    data = np.zeros((B, T_pad, d))
    valid = np.zeros((B, T_pad), dtype=bool)
    for i, t in enumerate(trajs):
        if t.d != d:
            raise ValueError("All trajectories in a batch need the same d")
        data[i, : len(t)] = np.asarray(t.data)
        valid[i, : len(t)] = np.asarray(t.valid)
    return TrajectoryBatch(data=jnp.asarray(data, dtype=fdtype()),
                           valid=jnp.asarray(valid),
                           lengths=jnp.asarray([len(t) for t in trajs]))


def pad_batch_rows(batch: TrajectoryBatch, n_rows: int) -> TrajectoryBatch:
    """Append ``n_rows`` all-invalid filler trajectories (length 0), e.g. to
    make B divisible by a mesh axis. Strip the corresponding result rows."""
    if n_rows == 0:
        return batch
    B, T = batch.B, batch.T
    data = jnp.concatenate(
        [batch.data, jnp.zeros((n_rows, T, batch.data.shape[2]),
                               dtype=batch.data.dtype)])
    valid = jnp.concatenate([batch.valid, jnp.zeros((n_rows, T), dtype=bool)])
    lengths = (jnp.full(B, T) if batch.lengths is None else batch.lengths)
    lengths = jnp.concatenate([lengths, jnp.zeros(n_rows, dtype=lengths.dtype)])
    return TrajectoryBatch(data=data, valid=valid, lengths=lengths)


def bucket_trajectories(trajs: Sequence[Trajectory], bucket_edges=(64, 128, 256, 512, 1024)):
    """
    Group ragged-length trajectories into padded batches by length bucket
    (bounds recompiles: one compiled program per bucket, SURVEY.md section 7
    "dynamic shapes" plan).

    Returns a list of ``(indices, TrajectoryBatch)`` where ``indices`` maps
    each batch row back to the position in ``trajs``.

    Note: padding frames behave exactly like trailing missing frames, which
    the profile formalism already supports (profiles span missing frames;
    reference ``bild/util.py:10-24``). Evidence values are therefore computed
    at the padded length — consistent within a bucket, and the same thing
    the reference computes for a trajectory whose tail frames are missing.
    """
    edges = sorted(bucket_edges)
    buckets = {}
    for i, t in enumerate(trajs):
        T = len(t)
        pad = next((e for e in edges if T <= e), None)
        if pad is None:
            pad = T  # oversize: its own exact-size bucket
        buckets.setdefault(pad, []).append(i)
    out = []
    for pad in sorted(buckets):
        idx = buckets[pad]
        out.append((np.array(idx),
                    stack_trajectories([trajs[i] for i in idx], T_pad=pad)))
    return out


@dataclasses.dataclass
class BatchResults:
    """
    Results of `sample_batch`: per-trajectory evidence curves and MAP
    profiles per k. Mirrors the point-estimate API of `SamplingResults`.
    """

    k: np.ndarray              # (K+1,)
    evidence: np.ndarray       # (B, K+1)
    evidence_se: np.ndarray    # (B, K+1)
    map_profiles: np.ndarray   # (K+1, B, T)
    dE: float = 0.0
    marginals: Optional[np.ndarray] = None  # (K+1, B, n, T) log-posteriors
    # (B, K+1) — CFC method-of-marginals fixed point converged at every AMIS
    # step of that (trajectory, k) run. The adaptive mode raises on
    # non-convergence (FixedkSampler.step); lockstep cannot, so the flag is
    # surfaced here instead of being silently dropped.
    mom_ok: Optional[np.ndarray] = None
    # with sample_batch(..., ensemble=M): the M highest-posterior-weight
    # ensemble samples per (k, trajectory) as discrete profiles plus their
    # UNNORMALIZED log importance weights (logL - logdelta, the marginals-
    # path convention). Duplicate profiles may appear; summing their weights
    # is the correct aggregation.
    top_profiles: Optional[np.ndarray] = None  # (K+1, B, M, T)
    top_logw: Optional[np.ndarray] = None      # (K+1, B, M)
    # adaptive mode (`infer.adaptive.sample_batch_adaptive`): likelihood
    # evaluations actually spent per trajectory, and rounds run — the
    # budget-allocation record the fixed lockstep schedule doesn't have
    evals: Optional[np.ndarray] = None         # (B,)
    rounds: Optional[int] = None

    def best_k(self, dE=None) -> np.ndarray:
        """(B,) smallest k within dE of each trajectory's max evidence."""
        dE = self.dE if dE is None else dE
        ev = self.evidence
        plausible = ev >= (np.max(ev, axis=1, keepdims=True) - dE)
        return np.argmax(plausible, axis=1)

    def best_profile(self, dE=None) -> np.ndarray:
        """(B, T) MAP profile at each trajectory's best k."""
        bk = self.best_k(dE)
        return self.map_profiles[bk, np.arange(len(bk))]

    def log_marginal_posterior(self, dE=None) -> np.ndarray:
        """
        (B, n, T) log marginal state posteriors. ``dE='average'`` averages
        over k weighted by evidence (mirrors
        `SamplingResults.log_marginal_posterior`). Requires the run to have
        used ``marginals=True``.
        """
        if self.marginals is None:
            raise ValueError("run sample_batch(..., marginals=True) first")
        from scipy.special import logsumexp

        if isinstance(dE, str) and dE == "average":
            finite = np.isfinite(self.evidence)              # (B, K+1)
            w = np.where(finite.T[:, :, None, None],
                         self.marginals + self.evidence.T[:, :, None, None],
                         -np.inf)
            logpost = logsumexp(w, axis=0)                   # (B, n, T)
            return logpost - logsumexp(logpost, axis=1, keepdims=True)
        bk = self.best_k(dE)
        return self.marginals[bk, np.arange(len(bk))]

    def profile_ensemble(self, dE=None):
        """
        Truncated posterior over profiles at each trajectory's best k:
        ``(B, M, T)`` int profiles and ``(B, M)`` weights, renormalized
        within the retained top-M set (the standard truncated-importance-
        sampling approximation). Requires ``sample_batch(..., ensemble=M)``.
        A trajectory with NO finite-weight sample gets uniform weights over
        its (meaningless) rows — its evidence is -inf across k, which is
        the signal callers should check.
        """
        if self.top_profiles is None:
            raise ValueError("run sample_batch(..., ensemble=M) first")
        from scipy.special import logsumexp

        bk = self.best_k(dE)
        rows = np.arange(len(bk))
        profs = self.top_profiles[bk, rows]
        lw = self.top_logw[bk, rows]                        # (B, M)
        norm = logsumexp(lw, axis=1, keepdims=True)
        with np.errstate(invalid="ignore"):
            w = np.exp(lw - norm)
        M = lw.shape[1]
        w = np.where(np.isfinite(norm), w, 1.0 / M)
        return profs, w


# lockstep runners are cached by (logL_fn identity, shape config): with
# padded-k parameter arrays, ONE compiled program serves every k <= k_max
# (one compile instead of one per k). Bounded
# LRU: entries retain closures + compiled executables, and datasets with
# many ragged length buckets would otherwise grow memory without bound.
_LOCKSTEP_RUNNERS = {}
_LOCKSTEP_RUNNERS_MAX = 32


def _get_lockstep_runner(logL_fn, T, n, N, S, steps, K1, marginals,
                         variant="per_k", mom_maxiter=1000, start=0,
                         top_m=0):
    """
    Compiled lockstep program. Variants (same per-(trajectory, k) math):

    - ``per_k``: vmap over trajectories, one k per call (active/logprior
      shared) — the checkpointable path.
    - ``fused``: vmap over k of vmap over trajectories — ALL k values run in
      ONE dispatch, removing per-k host prep + device sync gaps.
    - ``fused_scout``: ``fused`` that additionally returns the final
      `AmisState` and PRNG carry key per (k, trajectory) lane, so the refine
      phase can WARM-START from the scout ensemble instead of rerunning from
      scratch (buffer size ``S`` > ``steps`` run).
    - ``resume``: continue gathered scout states for ``steps - start`` more
      AMIS steps (per-trajectory k); summaries span the FULL ``steps``-step
      ensemble, bit-identical to a straight ``steps``-step run with the same
      keys (same buffer size, same split schedule, no re-seeding — the
      informed injection fires at scout step 1 only).
    """
    cache_key = (logL_fn, T, n, N, S, steps, K1, marginals, variant,
                 mom_maxiter, start, top_m)
    if cache_key in _LOCKSTEP_RUNNERS:
        # refresh recency: dict insertion order is the eviction order
        hit = _LOCKSTEP_RUNNERS.pop(cache_key)
        _LOCKSTEP_RUNNERS[cache_key] = hit
        return hit
    while len(_LOCKSTEP_RUNNERS) >= _LOCKSTEP_RUNNERS_MAX:
        _LOCKSTEP_RUNNERS.pop(next(iter(_LOCKSTEP_RUNNERS)))

    def _step_body(state, key, per_traj, transitions, active,
                   logprior, conc_brake_N, pol_brake_N):
        key, sub = jax.random.split(key)
        ss, th, profiles = amis_propose(state, sub, transitions, N=N, T=T,
                                        active=active)
        logLs = logL_fn(profiles, per_traj)
        state, _ = amis_update(state, ss, th, logLs, transitions,
                               logprior, conc_brake_N, pol_brake_N,
                               maxiter=mom_maxiter, active=active)
        return state, key

    def _summaries(state, active, n_done):
        """Per-k summaries over the first ``n_done`` filled ensemble rows."""
        ev = state.evidences[n_done - 1]                     # (3,)
        flat_logLs = state.logLs[:n_done].reshape(-1)
        idx = jnp.argmax(flat_logLs)
        ss_best = state.ss[:n_done].reshape(-1, K1)[idx]
        th_best = state.thetas[:n_done].reshape(-1, K1)[idx]
        map_prof = st2profile(ss_best, th_best, T, active=active)

        if marginals:
            log_w = (state.logLs[:n_done] - state.logdeltas[:n_done]
                     + jnp.log(float(n_done)))
            logpost = _marginal_posterior(
                state.ss[:n_done], state.thetas[:n_done], log_w,
                T=T, nStates=n, active=active)               # (n, T)
        else:
            logpost = jnp.zeros((0, 0), dtype=ev.dtype)

        if top_m:
            # top-M posterior samples: SAME weight convention as the
            # marginals path (log_w = logL - logdelta, NaN -> -inf); the
            # shared normalization constant is dropped — consumers
            # renormalize within the returned set
            log_w = (state.logLs[:n_done]
                     - state.logdeltas[:n_done]).reshape(-1)
            log_w = jnp.where(jnp.isnan(log_w), -jnp.inf, log_w)
            top_lw, idx = jax.lax.top_k(log_w, top_m)
            ss_sel = state.ss[:n_done].reshape(-1, K1)[idx]
            th_sel = state.thetas[:n_done].reshape(-1, K1)[idx]
            top_profs = jax.vmap(
                lambda s, t: st2profile(s, t, T, active=active))(ss_sel,
                                                                 th_sel)
        else:
            top_profs = jnp.zeros((0, T), dtype=map_prof.dtype)
            top_lw = jnp.zeros((0,), dtype=ev.dtype)
        return ev, map_prof, logpost, state.mom_ok, top_profs, top_lw

    def run_one(per_traj, key, transitions, a0, logp0, a_inf, logp_inf,
                use_informed, active, logprior, conc_brake_N, pol_brake_N):
        state = AmisState.create(S, N, K1 - 1, n, a0, logp0)

        def body(i, carry):
            state, key = carry
            state, key = _step_body(state, key, per_traj, transitions,
                                    active, logprior, conc_brake_N,
                                    pol_brake_N)
            # after the first (uniform) step, inject the informed proposal as
            # the second mixture component (see FixedkSampler.step)
            seed = use_informed & (i == 0)
            state = dataclasses.replace(
                state,
                a_params=state.a_params.at[1].set(
                    jnp.where(seed, a_inf, state.a_params[1])),
                logps=state.logps.at[1].set(
                    jnp.where(seed, logp_inf, state.logps[1])))
            return state, key

        state, key = jax.lax.fori_loop(0, steps, body, (state, key))
        out = _summaries(state, active, steps)
        if variant == "fused_scout":
            return out + (state, key)
        return out

    def run_resume(state, key, per_traj, transitions, active, logprior,
                   conc_brake_N, pol_brake_N):
        def body(_, carry):
            return _step_body(*carry, per_traj, transitions, active,
                              logprior, conc_brake_N, pol_brake_N)

        state, _ = jax.lax.fori_loop(0, steps - start, body, (state, key))
        return _summaries(state, active, steps)

    # a0/logp0 are per-trajectory (axis 0): the informed-init path seeds each
    # trajectory's proposal at its own DP segmentation
    if variant == "per_k":
        runner = jax.jit(jax.vmap(
            run_one,
            in_axes=(0, 0, None, 0, 0, 0, 0, 0, None, None, None, None)))
    elif variant in ("fused", "fused_scout"):
        over_B = jax.vmap(
            run_one, in_axes=(0, 0, None, 0, 0, 0, 0, 0, None, None, None, None))
        runner = jax.jit(jax.vmap(
            over_B, in_axes=(None, 0, None, 0, 0, 0, 0, 0, 0, 0, None, None)))
    elif variant == "resume":
        runner = jax.jit(jax.vmap(
            run_resume, in_axes=(0, 0, 0, None, 0, 0, None, None)))
    else:
        raise ValueError(f"unknown runner variant {variant!r}")
    _LOCKSTEP_RUNNERS[cache_key] = runner
    return runner


def _informed_proposals_all_k(model, batch, K1, n, T, cache_token=None):
    """
    Vectorized informed-init: one batched DP sweep for every trajectory and
    every k, then batched (s, theta) -> proposal-parameter conversion.
    Returns ``(a_inf (K1, B, K1), logp_inf (K1, B, n, K1), use (K1, B))`` or
    ``None`` if the model has no frame-factorized score tables. Cached on
    the model per (batch identity, K1): the segmentation is deterministic,
    and repeated `sample_batch` calls on the same batch otherwise redo
    ~0.3 s of host DP per call.

    ``cache_token`` is the identity object for the cache check — callers
    that slice the batch (the tail-trim in `sample_batch`) pass the
    ORIGINAL data array plus the effective length, since the sliced array
    is a fresh object on every call and would never hit.
    """
    token = (batch.data,) if cache_token is None else tuple(cache_token)
    cache = getattr(model, "_informed_init_cache", None)
    if (cache is not None and cache[0] is token[0] and cache[1] == token[1:]
            and cache[2] == K1):
        return cache[3]
    out = _informed_proposals_all_k_impl(model, batch, K1, n, T)
    # storing the token array in the cache keeps it alive, so the `is`
    # identity check cannot alias a recycled id()
    model._informed_init_cache = (token[0], token[1:], K1, out)
    return out


def _informed_proposals_all_k_impl(model, batch, K1, n, T):
    seg_tables = model.lockstep_segment_tables(batch)
    if seg_tables is None:
        return None
    from ..amis.sampler import informed_proposal_batch
    from ..infer.segment import dp_segment_all_batch, profiles_to_st_batch

    B = batch.B
    profs, feas = dp_segment_all_batch(np.asarray(seg_tables), K1 - 1,
                                       model.transitions)
    a_inf = np.ones((K1, B, K1))
    logp_inf = np.full((K1, B, n, K1), -math.log(n))
    for k in range(K1):
        ok = feas[k]
        if not np.any(ok):
            continue
        fracs, theta = profiles_to_st_batch(profs[k][ok], k)
        a_k, logp_k = informed_proposal_batch(fracs, theta, n, T)
        a_inf[k][ok, : k + 1] = a_k
        logp_inf[k][ok, :, : k + 1] = logp_k
    return a_inf, logp_inf, feas


# tail-trim memo: {id(orig.data): (orig.data, T_eff, trimmed_batch)}.
# Storing the original array in the value pins it, so the id cannot be
# recycled while the entry lives. Bounded (datasets stream many chunks).
_TRIM_CACHE = {}
_TRIM_CACHE_MAX = 8


def _trim_tail(batch: TrajectoryBatch, T_eff: int) -> TrajectoryBatch:
    key = id(batch.data)
    hit = _TRIM_CACHE.pop(key, None)
    if hit is not None and hit[0] is batch.data and hit[1] == T_eff:
        _TRIM_CACHE[key] = hit          # refresh recency
        return hit[2]
    while len(_TRIM_CACHE) >= _TRIM_CACHE_MAX:
        _TRIM_CACHE.pop(next(iter(_TRIM_CACHE)))
    trimmed = TrajectoryBatch(data=batch.data[:, :T_eff],
                              valid=batch.valid[:, :T_eff],
                              lengths=batch.lengths)
    _TRIM_CACHE[key] = (batch.data, T_eff, trimmed)
    return trimmed


def _checkpoint_config(batch, k_max, steps_per_k, N, marginals, informed_init,
                       ensemble=0, mom_maxiter=1000):
    cfg = [batch.B, batch.T, k_max, steps_per_k, N,
           int(marginals), int(informed_init)]
    if ensemble:
        # appended only when set, so pre-ensemble checkpoints stay resumable
        cfg.append(ensemble)
    if mom_maxiter != 1000:
        cfg.append(mom_maxiter)
    return np.array(cfg)


def _checkpoint_tag(model, batch, entry_key_data):
    """Content hash of (data, entry key, model fingerprint): shape/schedule
    equality (`_checkpoint_config`) is not enough — resuming a checkpoint
    against different data, a different PRNG stream, or a re-parametrized
    model would silently mix results from two different runs."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(batch.data)).tobytes())
    h.update(np.ascontiguousarray(entry_key_data).tobytes())
    fp = getattr(model, "likelihood_fingerprint", lambda: None)()
    if fp is not None:
        h.update(fp.encode())
    return h.hexdigest()


def _per_k_params(cfc, k, K1, B, n, informed):
    """Host-side proposal-init parameters for one k (numpy; caller casts)."""
    a0 = np.ones((B, K1))
    logp0 = np.full((B, n, K1), -math.log(n))
    logp0[:, :, : k + 1] = np.asarray(cfc.logp_uniform(k))[None]
    if informed is not None:
        a_inf, logp_inf, use_inf = (informed[0][k], informed[1][k],
                                    informed[2][k])
    else:
        a_inf, logp_inf, use_inf = a0, logp0, np.zeros(B, dtype=bool)
    active = np.arange(K1) < (k + 1)
    logprior = (sum(math.log(i + 1) for i in range(k))
                - cfc.N_total(k, log=True))
    return a0, logp0, a_inf, logp_inf, use_inf, active, logprior


def sample_batch(model, batch: TrajectoryBatch,
                 k_max=10,
                 steps_per_k=20,
                 N=128,
                 dE=0.0,
                 concentration_brake=1e-2,
                 polarization_brake=1e-3,
                 key=None,
                 mesh=None,
                 marginals=False,
                 informed_init=False,
                 checkpoint=None,
                 scout_steps=None,
                 refine_top=3,
                 mom_maxiter=1000,
                 ensemble=0,
                 row_keys=None,
                 informed_arrays=None,
                 lockstep=None) -> BatchResults:
    """
    Lockstep inference over a trajectory batch.

    Parameters
    ----------
    model : model exposing ``lockstep_fns`` (MultiStateRouse,
        FactorizedModel, GenericGaussianModel)
    batch : TrajectoryBatch
    k_max, steps_per_k, N : schedule — every k gets ``steps_per_k`` AMIS
        steps of ``N`` proposals (likelihood budget per trajectory:
        ``(k_max+1) * steps_per_k * N``).
    mesh : optional `jax.sharding.Mesh` with a ``data`` axis; the batch is
        sharded over it (data parallelism over trajectories). B not
        divisible by the axis is handled by padding with filler rows that
        are stripped from the results.
    informed_init : bool
        seed each trajectory's initial proposal at its DP segmentation
        (strongly recommended for long trajectories, where the uniform
        proposal rarely finds fine-grained switch positions — see DESIGN.md).
    checkpoint : optional path
        per-k checkpoint/resume: after each k the partial results and PRNG
        state are written (atomically) to this ``.npz`` path; a rerun with
        the same configuration resumes at the first incomplete k. A
        checkpoint from a different configuration raises, as does one
        written against different data, a different PRNG key, or a
        re-parametrized model (content tag mismatch).
    scout_steps : optional int
        two-phase budget schedule: every k first gets only ``scout_steps``
        AMIS steps (the scout), then each trajectory's ``refine_top``
        highest-evidence k values CONTINUE from their scout state for the
        remaining ``steps_per_k - scout_steps`` steps (warm-start refine —
        a refined (trajectory, k) ends up with exactly the ensemble a
        straight ``steps_per_k``-step run would have produced, same PRNG
        stream). The device-side analog of the reference's across-k active
        learning (``bild/core.py:138-192``): lockstep shapes stay static
        because every trajectory refines the same NUMBER of k values — just
        not the same ones. Likelihood budget:
        ``(k_max+1)*scout_steps + refine_top*(steps_per_k - scout_steps)``
        sweeps instead of ``(k_max+1)*steps_per_k``. Not combinable with
        ``checkpoint``.
    refine_top : int
        how many k values each trajectory refines (only with scout_steps).
    mom_maxiter : int
        iteration cap of the CFC method-of-marginals fixed point (reference
        ``CFC.MOM_maxiter``). Non-convergence cannot raise inside the jitted
        lockstep program; it is reported per (trajectory, k) in
        ``BatchResults.mom_ok`` instead.
    ensemble : int
        when > 0, additionally return the ``ensemble`` highest-weight
        posterior samples per (trajectory, k) as discrete profiles with
        their log importance weights (``BatchResults.top_profiles`` /
        ``top_logw``; see `BatchResults.profile_ensemble`). This is the
        E-step payload for posterior-weighted (soft-EM) parameter
        calibration (`bild_jax.fit.calibrate_rouse(mode='soft')`). Must not
        exceed the smallest ensemble any lane accumulates:
        ``scout_steps * N`` under the two-phase schedule (non-refined lanes
        keep only their scout ensemble), else ``steps_per_k * N``.

    row_keys : optional (B,) typed PRNG key array
        per-TRAJECTORY base keys; lane k of row b then samples from
        ``fold_in(row_keys[b], k)`` instead of the position-derived
        ``split`` schedule. This makes a trajectory's result independent of
        WHERE in the batch it sits — the property the process-local sharded
        dataset driver (`sample_dataset_sharded`) relies on for
        bit-identical results across process counts. Keys must be computed
        identically on every process of a multi-process launch.
    lockstep : optional (per_traj, logL_fn) pair
        overrides ``model.lockstep_fns(batch)``. The process-local sharded
        driver computes ``lockstep_fns`` on each process's OWN rows (the
        host-side table builds must never see the global batch) and feeds
        the per-trajectory leaves into one global array; ``batch`` then
        only supplies shapes and true lengths.
    informed_arrays : optional (a_inf, logp_inf, use) triple
        precomputed informed-init proposal arrays (shapes as returned by
        the internal DP sweep: ``(K1, B, K1)``, ``(K1, B, n, K1)``,
        ``(K1, B)``), possibly global device arrays fed process-locally.
        Overrides ``informed_init`` (whose host DP would pull the batch
        data to every host). Not combinable with ``checkpoint``.

    Notes
    -----
    Per-trajectory true lengths (``batch.lengths``) gate the evidence: k at
    or beyond a trajectory's own frame count is unidentifiable and gets
    -inf, matching adaptive mode's ``k >= len(traj)`` guard even when the
    trajectory is padded into a longer bucket.
    """
    multiproc = False
    if mesh is not None:
        from .mesh import is_multiprocess
        multiproc = is_multiprocess(mesh)
    if key is None:
        # multi-process: the default key must be IDENTICAL on every process
        # (divergent keys would desynchronize the SPMD host programs), so
        # process 0's draw is broadcast
        seed = np.random.randint(2**31)
        if multiproc:
            from .mesh import broadcast_from_process0
            seed = int(broadcast_from_process0(np.int64(seed)))
        key = jax.random.key(seed)
    if checkpoint is not None and scout_steps is not None:
        raise ValueError("scout_steps (two-phase schedule) cannot be "
                         "combined with checkpoint (per-k resume)")
    if checkpoint is not None and informed_arrays is not None:
        raise ValueError("informed_arrays (precomputed/fed informed init) "
                         "cannot be combined with checkpoint")
    if scout_steps is not None and not (1 <= scout_steps <= steps_per_k):
        # scout_steps=0 would build a 0-step runner whose final-evidence read
        # state.evidences[-1] is an out-of-bounds gather — silently clamped
        # under jit, i.e. garbage ranking rather than an error
        raise ValueError(f"scout_steps must be in [1, steps_per_k="
                         f"{steps_per_k}], got {scout_steps}")
    if steps_per_k < 1:
        raise ValueError(f"steps_per_k must be >= 1, got {steps_per_k}")
    min_ens = (scout_steps if scout_steps is not None else steps_per_k) * N
    if not 0 <= ensemble <= min_ens:
        raise ValueError(f"ensemble must be in [0, {min_ens}] (the smallest "
                         f"per-lane ensemble under this schedule), got "
                         f"{ensemble}")

    B_real = batch.B
    # trim the all-invalid tail of a padded bucket: frames past every
    # trajectory's true length cost full kernel propagation and contribute
    # nothing (a T=70 trajectory in a 128-bucket would waste ~45%). Results
    # are edge-padded back to the input T below. The trim is memoized on the
    # input data array's identity so repeated calls on the same batch hand
    # downstream `is`-keyed caches (GGM interval tables, informed init) the
    # SAME sliced arrays instead of defeating them with fresh slices.
    # Injected width-bearing arrays (`lockstep` per-trajectory tables,
    # `informed_arrays` proposals) were built by the caller at the input
    # width, so the trim must not change T under them: the sharded driver
    # composes chunks at a bucket-global T_pad precisely so a trajectory's
    # proposal stream is invariant to which chunk it lands in.
    T_in = batch.T
    informed_cache_token = (batch.data, T_in)
    if (batch.lengths is not None and batch.B > 0
            and lockstep is None and informed_arrays is None):
        T_eff = max(int(np.max(np.asarray(batch.lengths))), 1)
        if T_eff < T_in:
            batch = _trim_tail(batch, T_eff)
            informed_cache_token = (informed_cache_token[0], T_eff)
    if mesh is not None:
        batch = pad_batch_rows(batch, -batch.B % mesh.shape["data"])

    if lockstep is not None:
        per_traj, logL_fn = lockstep
    else:
        per_traj, logL_fn = model.lockstep_fns(batch)
    if mesh is not None:
        from .mesh import shard_batch
        per_traj = shard_batch(per_traj, mesh)

    B, T = batch.B, batch.T
    cfc = CFC(model.transitions)
    transitions = jnp.asarray(model.transitions)
    n = cfc.n
    dtype = fdtype()

    K1 = min(k_max, max(T - 1, 0)) + 1     # padded slot count
    cb = jnp.asarray(N * concentration_brake, dtype=dtype)
    pb = jnp.asarray(N * polarization_brake, dtype=dtype)

    if informed_arrays is not None:
        informed = None          # injected below, never host-assembled here
    elif informed_init:
        informed = _informed_proposals_all_k(
            model, batch, K1, n, T,
            cache_token=informed_cache_token + (batch.B,))
    else:
        informed = None

    def _keys_for(ks_list):
        """Per-(k, trajectory) PRNG keys: position-derived split schedule,
        or trajectory-identity fold_in when ``row_keys`` is given."""
        nonlocal key
        if row_keys is not None:
            return jnp.stack([
                jax.vmap(lambda rk: jax.random.fold_in(rk, kk))(row_keys)
                for kk in ks_list])
        out = []
        for _ in ks_list:
            key, sub = jax.random.split(key)
            # NB: filler rows from a mesh pad get the natural key suffix —
            # jax.random.split has the prefix property (split(k, B)[:B0] ==
            # split(k, B0)), so real rows' keys are pad-invariant
            out.append(jax.random.split(sub, B))
        return jnp.stack(out)

    def skipped_k():
        return (np.full((B, 3), [-np.inf, 1e-10, np.inf]),
                np.zeros((B, T), dtype=int),
                np.full((B, n, T), -np.inf),
                np.ones(B, dtype=bool),
                np.zeros((B, ensemble, T), dtype=int),
                np.full((B, ensemble), -np.inf))

    # np.array (not asarray): jax arrays view as read-only, refine writes.
    # Multi-process outputs are global (non-addressable) and go through the
    # replicating fetch so every process holds the full results.
    if multiproc:
        from .mesh import fetch_to_host
        _fetch = lambda x: np.array(fetch_to_host(x, mesh))
    else:
        _fetch = np.array

    if checkpoint is None:
        # one dispatch for ALL k: per-k host prep and device sync gaps would
        # otherwise serialize steps_per_k * (k_max+1) small programs.
        # Scouted schedule: the ensemble buffer is sized for the FULL
        # steps_per_k run so the refine phase warm-starts from the scout
        # state (continuing the same chain) instead of rerunning from step 1.
        s1 = steps_per_k if scout_steps is None else scout_steps
        runner = _get_lockstep_runner(
            logL_fn, T, n, N, steps_per_k, s1, K1, marginals,
            variant="fused" if scout_steps is None else "fused_scout",
            mom_maxiter=mom_maxiter, top_m=ensemble)
        ks = [k for k in range(k_max + 1) if k < T]
        params = [_per_k_params(cfc, k, K1, B, n, informed) for k in ks]
        stacks_np = [np.stack([p[i] for p in params]) for i in range(7)]
        stacked = [jnp.asarray(s, dtype=(bool if i in (4, 5) else dtype))
                   for i, s in enumerate(stacks_np)]
        if informed_arrays is not None:
            # injected (possibly process-locally fed, global) arrays replace
            # the host-assembled informed slots; lane axis restricted to ks
            a_inf_g, logp_inf_g, use_g = informed_arrays
            sel = jnp.asarray(ks)
            stacked[2] = jnp.asarray(a_inf_g, dtype=dtype)[sel]
            stacked[3] = jnp.asarray(logp_inf_g, dtype=dtype)[sel]
            stacked[4] = jnp.asarray(use_g)[sel]
        keys = _keys_for(ks)
        out = runner(
            per_traj, keys, transitions, *stacked[:6], stacked[6], cb, pb)
        if scout_steps is None:
            ev_all, map_all, marg_all, mom_all, top_all, tlw_all = out
            scout_state = keys_out = None
        else:
            (ev_all, map_all, marg_all, mom_all, top_all, tlw_all,
             scout_state, keys_out) = out
        ev_all, map_all = _fetch(ev_all), _fetch(map_all)
        mom_all = _fetch(mom_all)
        if marginals:
            marg_all = _fetch(marg_all)
        if ensemble:
            top_all, tlw_all = _fetch(top_all), _fetch(tlw_all)

        R = 0 if scout_steps is None else max(0, min(refine_top, len(ks)))
        if R > 0:
            # refine: each trajectory's top-R scouted k values continue from
            # their scout-phase AMIS state for the remaining steps, with
            # per-trajectory k in ONE static-shape dispatch (active/logprior
            # vary along the batch axis). Warm-starting makes the refined
            # result identical to a straight steps_per_k run on that
            # (trajectory, k) — the scout steps are not repeated.
            lengths = (np.asarray(batch.lengths) if batch.lengths is not None
                       else np.full(B, T))
            ks_arr = np.array(ks)
            ev_rank = np.where(ks_arr[:, None] >= lengths[None, :],
                               -np.inf, ev_all[:, :, 0])        # (nk, B)
            order = np.argsort(-ev_rank, axis=0)                # ks-indices
            kb = order[:R]                                      # (R, B)
            with np.errstate(invalid="ignore"):
                bad = ~np.isfinite(ev_rank[kb, np.arange(B)[None]])
            kb = np.where(bad, kb[0][None], kb)                 # pad w/ best

            flat_kb = kb.reshape(-1)                            # (R*B,)
            bidx = np.tile(np.arange(B), R)
            active_sel = stacks_np[5][flat_kb]
            logprior_sel = stacks_np[6][flat_kb]

            # device-side gather of the selected (k, trajectory) scout lanes
            sel_state = jax.tree_util.tree_map(
                lambda x: x[flat_kb, bidx], scout_state)
            keys_sel = keys_out[flat_kb, bidx]

            per_traj_R = jax.tree_util.tree_map(
                lambda x: jnp.concatenate([x] * R, axis=0), per_traj)
            if mesh is not None:
                from .mesh import shard_batch
                per_traj_R = shard_batch(per_traj_R, mesh)

            runner_r = _get_lockstep_runner(logL_fn, T, n, N, steps_per_k,
                                            steps_per_k, K1, marginals,
                                            variant="resume",
                                            mom_maxiter=mom_maxiter,
                                            start=scout_steps,
                                            top_m=ensemble)
            ev_r, map_r, marg_r, mom_r, top_r, tlw_r = runner_r(
                sel_state, keys_sel, per_traj_R, transitions,
                jnp.asarray(active_sel),
                jnp.asarray(logprior_sel, dtype=dtype), cb, pb)
            ev_r = _fetch(ev_r).reshape(R, B, 3)
            map_r = _fetch(map_r).reshape(R, B, T)
            mom_r = _fetch(mom_r).reshape(R, B)
            if marginals:
                marg_r = _fetch(marg_r).reshape(R, B, n, T)
            if ensemble:
                top_r = _fetch(top_r).reshape(R, B, ensemble, T)
                tlw_r = _fetch(tlw_r).reshape(R, B, ensemble)
            for r in range(R):
                ev_all[kb[r], np.arange(B)] = ev_r[r]
                map_all[kb[r], np.arange(B)] = map_r[r]
                mom_all[kb[r], np.arange(B)] = mom_r[r]
                if marginals:
                    marg_all[kb[r], np.arange(B)] = marg_r[r]
                if ensemble:
                    top_all[kb[r], np.arange(B)] = top_r[r]
                    tlw_all[kb[r], np.arange(B)] = tlw_r[r]
        evs, maps, margs, moms, tops, toplws = [], [], [], [], [], []
        for k in range(k_max + 1):
            if k >= T:
                ev_s, map_s, marg_s, mom_s, top_s, tlw_s = skipped_k()
                evs.append(ev_s)
                maps.append(map_s)
                margs.append(marg_s)
                moms.append(mom_s)
                tops.append(top_s)
                toplws.append(tlw_s)
            else:
                i = ks.index(k)
                evs.append(ev_all[i])
                maps.append(map_all[i])
                moms.append(mom_all[i])
                if marginals:
                    margs.append(marg_all[i])
                if ensemble:
                    tops.append(top_all[i])
                    toplws.append(tlw_all[i])
    else:
        # -- per-k loop with checkpoint/resume --------------------------------
        runner = _get_lockstep_runner(logL_fn, T, n, N, steps_per_k,
                                      steps_per_k, K1, marginals,
                                      mom_maxiter=mom_maxiter,
                                      top_m=ensemble)
        evs, maps, margs, moms, tops, toplws = [], [], [], [], [], []
        start_k = 0
        config = _checkpoint_config(batch, k_max, steps_per_k, N,
                                    marginals, informed_init, ensemble,
                                    mom_maxiter)
        entry_kd = np.asarray(jax.random.key_data(key))
        if row_keys is not None:
            # row keys define the PRNG streams; a different set must not
            # resume another run's checkpoint
            entry_kd = np.concatenate(
                [entry_kd.ravel(),
                 np.asarray(jax.random.key_data(row_keys)).ravel()])
        tag = _checkpoint_tag(model, batch, entry_kd)
        import os
        if os.path.exists(checkpoint):
            ck = np.load(checkpoint)
            if not np.array_equal(ck["config"], config):
                raise ValueError(
                    f"checkpoint {checkpoint} was written by a different "
                    f"sample_batch configuration: {ck['config']} vs {config}")
            if "tag" in ck.files and str(ck["tag"]) != tag:
                raise ValueError(
                    f"checkpoint {checkpoint} was written against different "
                    "data, PRNG key, or model parameters (content tag "
                    "mismatch) — resuming would mix results from two "
                    "different runs")
            start_k = int(ck["next_k"])
            evs = [ck["evs"][i] for i in range(start_k)]
            maps = [ck["maps"][i] for i in range(start_k)]
            if "moms" in ck.files and len(ck["moms"]):
                moms = [ck["moms"][i] for i in range(start_k)]
            else:  # checkpoint predating the mom_ok flag
                moms = [np.ones(B, dtype=bool) for _ in range(start_k)]
            if marginals:
                margs = [ck["margs"][i] for i in range(start_k)]
            if ensemble:
                tops = [ck["tops"][i] for i in range(start_k)]
                toplws = [ck["toplws"][i] for i in range(start_k)]
            key = jax.random.wrap_key_data(ck["key_data"])

        def save_checkpoint(next_k):
            # exactly-once I/O under multi-process launch: only process 0
            # writes (all processes hold identical results; resume requires
            # the checkpoint to be readable by every process, i.e. a shared
            # filesystem — or single-process resume)
            if multiproc and jax.process_index() != 0:
                return
            tmp = f"{checkpoint}.tmp"
            np.savez(tmp, config=config, tag=tag, next_k=next_k,
                     evs=np.stack(evs), maps=np.stack(maps),
                     moms=np.stack(moms),
                     margs=np.stack(margs) if marginals else np.zeros(0),
                     tops=np.stack(tops) if ensemble else np.zeros(0),
                     toplws=np.stack(toplws) if ensemble else np.zeros(0),
                     key_data=np.asarray(jax.random.key_data(key)))
            os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz",
                       checkpoint)

        for k in range(start_k, k_max + 1):
            if k >= T:
                ev_s, map_s, marg_s, mom_s, top_s, tlw_s = skipped_k()
                evs.append(ev_s)
                maps.append(map_s)
                margs.append(marg_s)
                moms.append(mom_s)
                tops.append(top_s)
                toplws.append(tlw_s)
                continue

            p = _per_k_params(cfc, k, K1, B, n, informed)
            a0, logp0, a_inf, logp_inf = (jnp.asarray(x, dtype=dtype)
                                          for x in p[:4])
            use_inf = jnp.asarray(p[4])
            active = jnp.asarray(p[5])
            logprior = jnp.asarray(p[6], dtype=dtype)

            keys = _keys_for([k])[0]
            (ev_k, map_k, marg_k, mom_k,
             top_k, tlw_k) = runner(per_traj, keys, transitions,
                                    a0, logp0, a_inf, logp_inf,
                                    use_inf, active, logprior,
                                    cb, pb)
            evs.append(_fetch(ev_k))
            maps.append(_fetch(map_k))
            moms.append(_fetch(mom_k))
            if marginals:
                margs.append(_fetch(marg_k))
            if ensemble:
                tops.append(_fetch(top_k))
                toplws.append(_fetch(tlw_k))
            save_checkpoint(k + 1)

    evs = np.stack(evs, axis=1)          # (B, K+1, 3)
    mom_ok = np.stack(moms, axis=1)      # (B, K+1)
    evidence = evs[:, :, 0]
    evidence_se = evs[:, :, 1]

    # unidentifiability guard at TRUE trajectory lengths (see Notes)
    if batch.lengths is not None:
        lengths = np.asarray(batch.lengths)
        over = np.arange(k_max + 1)[None, :] >= lengths[:, None]  # (B, K+1)
        evidence = np.where(over, -np.inf, evidence)
        evidence_se = np.where(over, 1e-10, evidence_se)

    map_profiles = np.stack(maps, axis=0)[:, :B_real]
    margs_out = np.stack(margs, axis=0)[:, :B_real] if marginals else None
    tops_out = np.stack(tops, axis=0)[:, :B_real] if ensemble else None
    toplw_out = np.stack(toplws, axis=0)[:, :B_real] if ensemble else None
    if map_profiles.shape[-1] < T_in:
        # restore the input length: trailing all-invalid frames carry the
        # edge state (profiles span missing frames) and uniform marginals
        pad = T_in - map_profiles.shape[-1]
        map_profiles = np.pad(map_profiles, [(0, 0), (0, 0), (0, pad)],
                              mode="edge")
        if margs_out is not None:
            margs_out = np.concatenate(
                [margs_out,
                 np.full(margs_out.shape[:3] + (pad,), -math.log(n))],
                axis=-1)
        if tops_out is not None:
            tops_out = np.pad(tops_out, [(0, 0), (0, 0), (0, 0), (0, pad)],
                              mode="edge")

    return BatchResults(
        k=np.arange(k_max + 1),
        evidence=evidence[:B_real],
        evidence_se=evidence_se[:B_real],
        map_profiles=map_profiles,
        dE=dE,
        marginals=margs_out,
        mom_ok=mom_ok[:B_real],
        top_profiles=tops_out,
        top_logw=toplw_out,
    )
