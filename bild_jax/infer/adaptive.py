"""
Batched adaptive scheduler: per-trajectory active learning at dataset scale.

The reference's core scheduling idea — evidence-driven, per-trajectory choice
of where the next likelihood budget goes, with certainty-based stopping
(``bild/core.py:138-192,217-227``) — exists in this package's adaptive mode
(`bild_jax.sample`, one trajectory at a time) and, until this module, was
absent from the lockstep dataset mode, which runs a fixed schedule: every
trajectory gets the same budget whether its posterior resolved after 2 AMIS
steps or needed 40.

`sample_batch_adaptive` closes that gap on the device. The control structure:

- Device state is a preallocated **lane grid**: one `AmisState` per
  (k-lane, trajectory), leaves shaped ``(L, B, ...)``. Lanes "open" lazily
  per trajectory (host bookkeeping only — the device grid is fixed shape, so
  the round program compiles exactly once per batch configuration).
- Each **round**, every live trajectory picks a lane by the reference's
  decision rule — expected KL information gain per k (`KLD_moreSamples`),
  lookahead importance of new k (`KLD_omitK`), certainty-based stopping —
  evaluated for ALL trajectories at once by a batched Monte-Carlo choice
  sampler that runs on device (`decide_batch`). The chosen ``(lane, traj)``
  pairs advance ``steps_per_round`` AMIS steps in ONE gather → advance →
  scatter dispatch with donated buffers.
- **Budget reallocation**: a converged trajectory stops consuming its slot;
  the freed slot goes to another live trajectory's next-highest-KLD lane
  (distinct (lane, traj) pairs, so one straggler can advance several of its
  k-lanes in the same round). Every dispatch therefore stays fully utilized
  — the batched generalization of the reference's one-sampler-at-a-time
  loop, where "which trajectory gets the next eval" becomes "which (k,
  trajectory) lanes fill the next tile".

Decision semantics match `bild_jax.infer.core.sample` /
`bild_jax.infer.choice.ChoiceSampler` (tested: `tests/test_adaptive.py`
feeds both the same evidence states and noise draws and compares decisions).
The differences vs the single-trajectory loop are structural, not semantic:
decisions happen every ``steps_per_round`` steps instead of every step, and
spare slots add extra (never harmful) samples at lower-ranked lanes.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import fdtype
from ..amis.cfc import CFC
from ..amis.sampler import AmisState, amis_propose, amis_update, _marginal_posterior
from ..profiles import st2profile
from ..parallel.batch import (BatchResults, TrajectoryBatch, _per_k_params,
                              _informed_proposals_all_k, _get_lockstep_runner,
                              _trim_tail)

__all__ = ["sample_batch_adaptive", "decide_batch"]

_NEG_INF = -jnp.inf


# ---------------------------------------------------------------------------
# batched choice-distribution decision (device)
# ---------------------------------------------------------------------------

def _pick(curves, margin):
    """Winning k per draw: smallest k within ``margin`` of that draw's max
    (reference ``bild/choicesampler.py:112-151``); ``curves (..., S, K)``."""
    floor = jnp.max(curves, axis=-1, keepdims=True) - margin
    return jnp.argmax(curves >= floor, axis=-1)


def _tally(picks, K):
    """Histogram winning ks: ``(..., S) -> (..., K)``."""
    return jnp.sum(picks[..., None] == jnp.arange(K), axis=-2)


@partial(jax.jit, static_argnames=("k_lookahead", "k_max"))
def decide_batch(logev, var_logev, n_steps, opened, noise, *,
                 margin, certainty, k_lookahead: int, k_max: int):
    """
    The reference's ``determine_next_step`` + stop rule
    (``bild/core.py:138-192,217-227``), vectorized over a batch of
    trajectories and evaluated on device.

    Parameters
    ----------
    logev, var_logev, n_steps : (B, K) arrays
        per-(trajectory, k) evidence point estimates, squared SEs, and AMIS
        step counts. Unopened or k>=T lanes carry ``logev=-inf``,
        ``n_steps=inf`` (zero expected gain — exactly how the reference's
        exhausted/-inf samplers enter its ChoiceSampler).
    opened : (B,) int
        number of samplers opened so far per trajectory (= the reference's
        ``len(samplers)``).
    noise : (samplesize, K) array
        the Monte-Carlo evidence-curve draws' standard-normal noise, shared
        across trajectories (common random numbers — the same trick the
        reference uses *within* one decision, ``choicesampler.py:99-110``).
    margin, certainty : floats — dE and certainty_in_k.

    Returns dict of (B,)-arrays: ``k_next``, ``is_open`` (k_next opens a new
    sampler), ``keep_going`` (the reference's run_condition), plus ``pk``
    (B, K) and ``KLD`` (B, K) for logging/slot allocation.
    """
    B, K = logev.shape
    dtype = noise.dtype

    # center per trajectory: the margin rule is shift-invariant, and at f32
    # a |logE| ~ 3000 would quantize the rms-step shifts away
    finite = jnp.isfinite(logev)
    center = jnp.max(jnp.where(finite, logev, _NEG_INF), axis=1, keepdims=True)
    logev_c = jnp.where(finite, logev - center, _NEG_INF).astype(dtype)
    sd = jnp.sqrt(var_logev).astype(dtype)
    step_rms = jnp.sqrt(var_logev / (n_steps + 1.0)).astype(dtype)  # inf->0

    curves = logev_c[:, None, :] + sd[:, None, :] * noise[None]     # (B,S,K)
    counts0 = _tally(_pick(curves, margin), K).astype(dtype)        # (B,K)
    samplesize = noise.shape[0]
    pk = counts0 / samplesize

    # KLD_moreSamples: central-difference histogram swing per probed k
    # (reference choicesampler.py:153-178); sequential over probes to bound
    # the (B, S, K) temporaries
    def probe(k):
        shift = 0.5 * step_rms[:, None, k, None] * (jnp.arange(K) == k)
        up = _tally(_pick(curves + shift, margin), K).astype(dtype)
        down = _tally(_pick(curves - shift, margin), K).astype(dtype)
        swing = up - down                                           # (B,K)
        return jnp.sum(swing**2 / (counts0 + 1.0), axis=-1) / (2.0 * samplesize)

    KLD = jax.lax.map(probe, jnp.arange(K)).T                       # (B,K)

    # KLD_omitK over the lookahead region [opened-k_lookahead, opened)
    # (reference choicesampler.py:180-210; core.py:180)
    ks = jnp.arange(K)
    omit = (ks[None, :] >= (opened - k_lookahead)[:, None]) & \
           (ks[None, :] < opened[:, None])                          # (B,K)
    omit_curves = jnp.where(omit[:, None, :], _NEG_INF, curves)
    reduced = _tally(_pick(omit_curves, margin), K).astype(dtype)
    reduced = reduced * (samplesize / jnp.sum(reduced, axis=-1, keepdims=True))
    gap = jnp.where(omit, 0.0, counts0 - reduced)
    I_la = jnp.sum(gap**2 / (reduced + 1.0), axis=-1) / (2.0 * samplesize)

    # decision logic (reference bild/core.py:153-186)
    k_new = opened
    bootstrap = (k_new < k_lookahead + 1) & (k_new <= k_max)
    k_KLD = jnp.argmax(KLD, axis=1)
    kld_at_best = jnp.take_along_axis(KLD, k_KLD[:, None], axis=1)[:, 0]
    I_la = jnp.where(k_new >= k_lookahead + 1, I_la, jnp.inf)
    want_open = (I_la > kld_at_best) & (k_new <= k_max)
    k_next = jnp.where(bootstrap | want_open, k_new, k_KLD)
    is_open = k_next == k_new

    # stop rule (reference bild/core.py:217-227): continue while a new k is
    # demanded, or certainty not reached and the chosen k still informative
    pk_max = jnp.max(pk, axis=1)
    kld_next = jnp.take_along_axis(
        KLD, jnp.minimum(k_next, K - 1)[:, None], axis=1)[:, 0]
    keep_going = is_open | ((pk_max < certainty) & (kld_next > 0))

    return {"k_next": k_next, "is_open": is_open, "keep_going": keep_going,
            "pk": pk, "KLD": KLD, "I_la": I_la}


@partial(jax.jit, static_argnames=("k_lookahead", "k_max"))
def _decide_packed(logev, var_logev, n_steps, opened, noise, *,
                   margin, certainty, k_lookahead: int, k_max: int):
    """`decide_batch` with everything the driver needs packed into ONE
    ``(B, K+3)`` array — each fetched leaf costs a device-to-host round
    trip, and the adaptive driver fetches every round."""
    out = decide_batch(logev, var_logev, n_steps, opened, noise,
                       margin=margin, certainty=certainty,
                       k_lookahead=k_lookahead, k_max=k_max)
    f = out["KLD"].dtype
    return jnp.concatenate(
        [out["k_next"][:, None].astype(f), out["is_open"][:, None].astype(f),
         out["keep_going"][:, None].astype(f), out["KLD"]], axis=1)


# ---------------------------------------------------------------------------
# device lane grid
# ---------------------------------------------------------------------------

def _fresh_lane(B, S, N, K1, n, a0, logp0):
    """`AmisState` for one lane, batched over trajectories: leaves (B, ...).
    ``a0 (B, K1)``, ``logp0 (B, n, K1)``."""
    dtype = fdtype()
    return AmisState(
        ss=jnp.zeros((B, S, N, K1), dtype=dtype),
        thetas=jnp.zeros((B, S, N, K1), dtype=jnp.int32),
        logLs=jnp.zeros((B, S, N), dtype=dtype),
        logdeltas=jnp.zeros((B, S, N), dtype=dtype),
        a_params=jnp.zeros((B, S + 1, K1), dtype=dtype).at[:, 0].set(
            jnp.asarray(a0, dtype=dtype)),
        logps=jnp.zeros((B, S + 1, n, K1), dtype=dtype).at[:, 0].set(
            jnp.asarray(logp0, dtype=dtype)),
        evidences=jnp.zeros((B, S, 3), dtype=dtype),
        n_steps=jnp.zeros((B,), dtype=jnp.int32),
        mom_ok=jnp.ones((B,), dtype=bool),
    )


# round programs are cached like the lockstep runners: one compile serves
# every chunk with the same (kernel, shape, schedule) configuration
_ROUND_RUNNERS = {}
_ROUND_RUNNERS_MAX = 32


def _get_round_runner(logL_fn, T, n, N, S, K1, m, maxiter):
    """One adaptive round: gather the chosen (lane, trajectory) pairs from
    the grid, advance each ``m`` AMIS steps (masked no-op beyond the lane's
    step capacity or for dead slots), scatter back. Buffers are donated —
    the multi-GB grid is updated in place rather than copied per round."""
    cache_key = (logL_fn, T, n, N, S, K1, m, maxiter)
    if cache_key in _ROUND_RUNNERS:
        hit = _ROUND_RUNNERS.pop(cache_key)
        _ROUND_RUNNERS[cache_key] = hit
        return hit
    while len(_ROUND_RUNNERS) >= _ROUND_RUNNERS_MAX:
        _ROUND_RUNNERS.pop(next(iter(_ROUND_RUNNERS)))

    def advance_one(state, key_raw, ptr, active, logprior, a_inf, logp_inf,
                    use_inf, alive, transitions, cb, pb):
        def body(_, carry):
            state, kraw = carry
            key = jax.random.wrap_key_data(kraw)
            key2, sub = jax.random.split(key)
            ss, th, profiles = amis_propose(state, sub, transitions, N=N,
                                            T=T, active=active)
            logLs = logL_fn(profiles, ptr)
            state2, _ = amis_update(state, ss, th,
                                    logLs.astype(state.logLs.dtype),
                                    transitions, logprior, cb, pb,
                                    maxiter=maxiter, active=active)
            # informed proposal becomes the second mixture component after
            # the lane's FIRST step (same rule as the lockstep runners)
            seed = use_inf & (state2.n_steps == 1)
            state2 = dataclasses.replace(
                state2,
                a_params=state2.a_params.at[1].set(
                    jnp.where(seed, a_inf, state2.a_params[1])),
                logps=state2.logps.at[1].set(
                    jnp.where(seed, logp_inf, state2.logps[1])))
            ok = alive & (state.n_steps < S)
            state = jax.tree_util.tree_map(
                lambda nw, old: jnp.where(ok, nw, old), state2, state)
            kraw = jnp.where(ok, jax.random.key_data(key2), kraw)
            return state, kraw

        state, key_raw = jax.lax.fori_loop(0, m, body, (state, key_raw))
        i_last = jnp.maximum(state.n_steps - 1, 0)
        packed = jnp.concatenate([
            state.evidences[i_last],
            jnp.stack([state.n_steps.astype(state.logLs.dtype),
                       state.mom_ok.astype(state.logLs.dtype)])])
        return state, key_raw, packed

    @partial(jax.jit, donate_argnums=(0, 1))
    def round_fn(grid, keys_raw, kb, bidx, live, per_traj, transitions,
                 actives_k, logpriors_k, a_inf_all, logp_inf_all, use_inf_all,
                 cb, pb):
        sel = jax.tree_util.tree_map(lambda x: x[kb, bidx], grid)
        ksel = keys_raw[kb, bidx]
        ptr = jax.tree_util.tree_map(lambda x: x[bidx], per_traj)
        sel, ksel, packed = jax.vmap(
            advance_one, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, None, None, None)
        )(sel, ksel, ptr, actives_k[kb], logpriors_k[kb],
          a_inf_all[kb, bidx], logp_inf_all[kb, bidx], use_inf_all[kb, bidx],
          live, transitions, cb, pb)
        grid = jax.tree_util.tree_map(
            lambda g, s: g.at[kb, bidx].set(s), grid, sel)
        keys_raw = keys_raw.at[kb, bidx].set(ksel)
        return grid, keys_raw, packed

    _ROUND_RUNNERS[cache_key] = round_fn
    return round_fn


@partial(jax.jit, static_argnames=("T", "n", "marginals"))
def _final_summaries(grid, actives_k, *, T: int, n: int, marginals: bool):
    """Per-(lane, trajectory) MAP profiles (and marginals) over each lane's
    FILLED ensemble rows (``n_steps`` varies per lane — masked, not sliced,
    unlike the lockstep `_summaries` whose step count is static)."""

    def one(state, active):
        S, N = state.logLs.shape
        nd = state.n_steps
        row_ok = jnp.arange(S)[:, None] < nd                    # (S, 1)
        logLs = jnp.where(row_ok, state.logLs, _NEG_INF)
        K1 = state.ss.shape[-1]
        idx = jnp.argmax(logLs.reshape(-1))
        map_prof = st2profile(state.ss.reshape(-1, K1)[idx],
                              state.thetas.reshape(-1, K1)[idx],
                              T, active=active)
        if marginals:
            log_w = jnp.where(
                row_ok, state.logLs - state.logdeltas
                + jnp.log(jnp.maximum(nd, 1).astype(state.logLs.dtype)),
                _NEG_INF)
            logpost = _marginal_posterior(state.ss, state.thetas, log_w,
                                          T=T, nStates=n, active=active)
        else:
            logpost = jnp.zeros((0, 0), dtype=state.logLs.dtype)
        return map_prof, logpost

    return jax.vmap(jax.vmap(one, in_axes=(0, None)))(grid, actives_k)


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

def sample_batch_adaptive(model, batch: TrajectoryBatch,
                          k_max=10,
                          N=128,
                          max_steps_per_k=24,
                          init_steps=4,
                          steps_per_round=2,
                          dE=0.0,
                          certainty_in_k=0.99,
                          k_lookahead=2,
                          samplesize=4096,
                          max_rounds=None,
                          concentration_brake=1e-2,
                          polarization_brake=1e-3,
                          informed_init=True,
                          marginals=False,
                          reallocate=True,
                          mom_maxiter=1000,
                          key=None) -> BatchResults:
    """
    Adaptive (per-trajectory active-learning) inference over a batch.

    Where `sample_batch` runs a fixed lockstep schedule (every trajectory
    gets ``steps_per_k`` AMIS steps at every k), this driver re-decides
    after every round where each trajectory's next likelihood budget goes —
    the reference's active-learning protocol (``bild/core.py:138-227``) at
    dataset scale — and stops each trajectory individually once its choice
    distribution over k concentrates beyond ``certainty_in_k``.

    Parameters beyond `sample_batch`'s shared ones:

    max_steps_per_k : int
        AMIS-step capacity per (trajectory, k) lane; a lane that hits it is
        exhausted (the reference's ``max_fev`` semantics,
        ``bild/amis.py:902-904``, with ``max_fev ~ max_steps_per_k * N``).
    init_steps : int
        steps a newly opened k runs before participating in decisions
        (reference ``init_runs``, ``bild/core.py:24``; the scout/refine
        lockstep experience shows ~4 steps suffice to rank k).
    steps_per_round : int
        AMIS steps per chosen lane per round; decisions happen between
        rounds (m-step decision batching — at 1 the decision cadence is the
        reference's, larger values trade decision granularity for fewer
        host round trips).
    certainty_in_k, k_lookahead, samplesize : the reference's stopping
        certainty, lookahead width, and choice-MC size (``bild/core.py:25-26``,
        ``choicesampler.py:84``).
    max_rounds : optional int
        hard cap on rounds; trajectories not converged by then keep their
        current estimates (like reference ``max_fev`` exhaustion). Default
        None runs until every trajectory converges or exhausts its lanes.
    reallocate : bool
        fill slots freed by converged trajectories with other live
        trajectories' next-best-KLD lanes (keeps every dispatch fully
        utilized). Off = pure reference semantics: one lane per live
        trajectory per round.

    Returns `BatchResults`; ``evals`` carries per-trajectory likelihood
    evaluations actually spent (the budget histogram), ``rounds`` the
    number of adaptive rounds run.
    """
    if key is None:
        key = jax.random.key(np.random.randint(2**31))
    if not 1 <= init_steps <= max_steps_per_k:
        raise ValueError(f"init_steps must be in [1, max_steps_per_k="
                         f"{max_steps_per_k}], got {init_steps}")
    if steps_per_round < 1:
        raise ValueError(f"steps_per_round must be >= 1, got {steps_per_round}")

    B_real = batch.B
    T_in = batch.T
    informed_cache_token = (batch.data, T_in)
    if batch.lengths is not None and batch.B > 0:
        T_eff = max(int(np.max(np.asarray(batch.lengths))), 1)
        if T_eff < T_in:
            batch = _trim_tail(batch, T_eff)
            informed_cache_token = (informed_cache_token[0], T_eff)

    B, T = batch.B, batch.T
    S, m = max_steps_per_k, steps_per_round
    per_traj, logL_fn = model.lockstep_fns(batch)
    cfc = CFC(model.transitions)
    transitions = jnp.asarray(model.transitions)
    n = cfc.n
    dtype = fdtype()
    cb = jnp.asarray(N * concentration_brake, dtype=dtype)
    pb = jnp.asarray(N * polarization_brake, dtype=dtype)

    L = min(k_max, max(T - 1, 0)) + 1          # device lanes (k < T)
    K1 = L                                     # padded parameter slots
    K_host = k_max + 2                         # host arrays incl. virtual opens
    lengths = (np.asarray(batch.lengths) if batch.lengths is not None
               else np.full(B, T))

    informed = _informed_proposals_all_k(
        model, batch, K1, n, T, cache_token=informed_cache_token + (B,)) \
        if informed_init else None
    params = [_per_k_params(cfc, k, K1, B, n, informed) for k in range(L)]
    # stacked per-lane arrays (lane axis 0)
    a0_k = np.stack([p[0] for p in params])
    logp0_k = np.stack([p[1] for p in params])
    a_inf_all = jnp.asarray(np.stack([p[2] for p in params]), dtype=dtype)
    logp_inf_all = jnp.asarray(np.stack([p[3] for p in params]), dtype=dtype)
    use_inf_all = jnp.asarray(np.stack([p[4] for p in params]))
    actives_np = np.stack([p[5] for p in params])
    actives_k = jnp.asarray(actives_np)
    logpriors_k = jnp.asarray(np.stack([p[6] for p in params]), dtype=dtype)

    # ---- host bookkeeping ------------------------------------------------
    logE = np.full((B, K_host), -np.inf)
    varE = np.full((B, K_host), 1e-20)
    nst = np.full((B, K_host), np.inf)         # inf = unopened/exhausted/k>=T
    nst_true = np.zeros((B, K_host))           # actual step counts
    momok_h = np.ones((B, k_max + 1), dtype=bool)
    opened = np.zeros(B, dtype=int)
    init_pending = np.zeros(B, dtype=int)
    done = np.zeros(B, dtype=bool)
    evals = np.zeros(B, dtype=np.int64)

    def record(ev_rows, ns_rows, mok_rows, kb, bidx):
        """Ingest fetched per-slot results into the host arrays."""
        ran = ns_rows - nst_true[bidx, kb]
        evals[bidx] += (ran * N).astype(np.int64)
        nst_true[bidx, kb] = ns_rows
        logE[bidx, kb] = ev_rows[:, 0]
        varE[bidx, kb] = ev_rows[:, 1] ** 2
        nst[bidx, kb] = np.where(ns_rows >= S, np.inf, ns_rows)
        momok_h[bidx, kb] &= mok_rows

    def host_open(rows, ks):
        """Open an unidentifiable k (k >= len or beyond device lanes) as the
        reference does (``bild/amis.py:641-648``): evidence -inf, exhausted,
        no likelihood work."""
        logE[rows, ks] = -np.inf
        varE[rows, ks] = 1e-20
        nst[rows, ks] = np.inf
        opened[rows] += 1

    # ---- bootstrap: lanes 0..k_lookahead via the fused scout runner ------
    n_boot = min(k_lookahead + 1, k_max + 1, L)
    boot_runner = _get_lockstep_runner(
        logL_fn, T, n, N, S, init_steps, K1, False,
        variant="fused_scout", mom_maxiter=mom_maxiter)
    stacked = [jnp.asarray(a0_k[:n_boot], dtype=dtype),
               jnp.asarray(logp0_k[:n_boot], dtype=dtype),
               a_inf_all[:n_boot], logp_inf_all[:n_boot],
               use_inf_all[:n_boot], actives_k[:n_boot]]
    boot_keys = []
    for kk in range(n_boot):
        key, sub = jax.random.split(key)
        boot_keys.append(jax.random.split(sub, B))
    (ev_b, _, _, mok_b, _, _, boot_state, boot_keys_out) = boot_runner(
        per_traj, jnp.stack(boot_keys), transitions, *stacked,
        logpriors_k[:n_boot], cb, pb)

    ev_b = np.asarray(ev_b)                    # (n_boot, B, 3)
    mok_b = np.asarray(mok_b)
    for kk in range(n_boot):
        record(ev_b[kk], np.full(B, float(init_steps)), mok_b[kk],
               np.full(B, kk), np.arange(B))
    opened[:] = n_boot
    # lanes at/after a trajectory's own length are unidentifiable
    for kk in range(n_boot):
        bad = kk >= lengths
        logE[bad, kk] = -np.inf
        varE[bad, kk] = 1e-20
        nst[bad, kk] = np.inf

    # assemble the full grid: bootstrapped lanes + fresh ones
    fresh = [_fresh_lane(B, S, N, K1, n, a0_k[kk], logp0_k[kk])
             for kk in range(n_boot, L)]
    grid = jax.tree_util.tree_map(
        lambda b, *f: jnp.concatenate([b] + [x[None] for x in f], axis=0)
        if f else b,
        boot_state, *fresh)
    keys_raw = jax.random.key_data(boot_keys_out)  # (n_boot, B, keysize)
    fresh_keys = []
    for kk in range(n_boot, L):
        key, sub = jax.random.split(key)
        fresh_keys.append(jax.random.key_data(jax.random.split(sub, B)))
    if fresh_keys:
        keys_raw = jnp.concatenate([keys_raw, jnp.stack(fresh_keys)], axis=0)

    runner = _get_round_runner(logL_fn, T, n, N, S, K1, m, mom_maxiter)

    margin = jnp.asarray(float(dE), dtype=dtype)
    certainty = jnp.asarray(float(certainty_in_k), dtype=dtype)

    def decide_all():
        key_l = decide_all.key
        decide_all.key, sub = jax.random.split(key_l)
        noise = jax.random.normal(sub, (samplesize, K_host), dtype=dtype)
        packed = np.asarray(_decide_packed(
            jnp.asarray(logE, dtype=dtype), jnp.asarray(varE, dtype=dtype),
            jnp.asarray(nst, dtype=dtype), jnp.asarray(opened), noise,
            margin=margin, certainty=certainty,
            k_lookahead=k_lookahead, k_max=k_max))
        return {"k_next": packed[:, 0].astype(int),
                "is_open": packed[:, 1] != 0,
                "keep_going": packed[:, 2] != 0,
                "KLD": packed[:, 3:]}

    key, decide_all.key = jax.random.split(key)

    rounds = 0
    while not done.all() and (max_rounds is None or rounds < max_rounds):
        # -- decide (re-run after virtual opens: an unidentifiable k opens
        #    with no device work, exactly like the reference's -inf sampler)
        for _ in range(K_host):
            dec = decide_all()
            live = ~done & (init_pending == 0)
            virt = live & dec["is_open"] & (
                (dec["k_next"] >= lengths) | (dec["k_next"] >= L))
            if not virt.any():
                break
            host_open(np.where(virt)[0], dec["k_next"][virt])

        live = ~done & (init_pending == 0)
        done |= live & ~dec["keep_going"]
        live = ~done & (init_pending == 0)

        # device opens: start init on the new lane
        opening = live & dec["is_open"]
        init_pending[opening] = init_steps
        opened[opening] += 1

        # primary slot per live trajectory
        kb_pri = np.where(init_pending > 0, opened - 1, dec["k_next"])
        rows = np.where(~done)[0]
        if rows.size == 0:
            break
        kb_list = list(kb_pri[rows])
        bidx_list = list(rows)
        used = set(zip(kb_list, bidx_list))

        # budget reallocation: spare slots -> highest-KLD remaining
        # (lane, trajectory) candidates of live, non-initializing rows
        spare = B - len(rows)
        if spare > 0 and reallocate:
            cand_ok = np.zeros((B, K_host), dtype=bool)
            nondec = ~done & (init_pending == 0)
            cand_ok[nondec] = True
            cand_ok &= np.isfinite(nst) & (nst > 0)      # opened, not exhausted
            cand_ok[:, L:] = False
            cand_ok &= dec["KLD"] > 0
            for kk, bb in used:
                if kk < K_host:
                    cand_ok[bb, kk] = False
            flat = np.argsort(-np.where(cand_ok, dec["KLD"], -np.inf),
                              axis=None)[:spare]
            for f in flat:
                bb, kk = divmod(int(f), K_host)
                if not cand_ok[bb, kk]:
                    break
                kb_list.append(kk)
                bidx_list.append(bb)
                used.add((kk, bb))

        # dead filler slots (masked no-ops) on distinct unused pairs
        n_live_slots = len(kb_list)
        if n_live_slots < B:
            need = B - n_live_slots
            for kk in range(L):
                for bb in range(B):
                    if need == 0:
                        break
                    if (kk, bb) not in used:
                        kb_list.append(kk)
                        bidx_list.append(bb)
                        used.add((kk, bb))
                        need -= 1
                if need == 0:
                    break

        kb = np.asarray(kb_list, dtype=np.int32)
        bidx = np.asarray(bidx_list, dtype=np.int32)
        live_mask = np.zeros(B, dtype=bool)
        live_mask[:n_live_slots] = True

        grid, keys_raw, packed = runner(
            grid, keys_raw, jnp.asarray(kb), jnp.asarray(bidx),
            jnp.asarray(live_mask), per_traj, transitions,
            actives_k, logpriors_k, a_inf_all, logp_inf_all, use_inf_all,
            cb, pb)

        packed = np.asarray(packed)            # ONE fetch per round
        sl = slice(0, n_live_slots)
        record(packed[sl, :3], packed[sl, 3], packed[sl, 4] != 0,
               kb[sl], bidx[sl])
        init_pending = np.maximum(init_pending - m, 0)
        rounds += 1

    # ---- final summaries -------------------------------------------------
    maps_d, margs_d = _final_summaries(grid, actives_k, T=T, n=n,
                                       marginals=marginals)
    maps_d = np.asarray(maps_d)                             # (L, B, T)
    K_out = k_max + 1
    map_profiles = np.zeros((K_out, B, T), dtype=int)
    map_profiles[:L] = maps_d
    margs_out = None
    if marginals:
        margs_out = np.full((K_out, B, n, T), -np.inf)
        margs_out[:L] = np.asarray(margs_d)

    evidence = logE[:, :K_out].copy()
    evidence_se = np.sqrt(varE[:, :K_out])
    # unidentifiability guard at true lengths (same as sample_batch)
    over = np.arange(K_out)[None, :] >= lengths[:, None]
    evidence[over] = -np.inf
    evidence_se[over] = 1e-10
    # never-opened lanes keep -inf evidence (logE initialized to -inf)

    if T < T_in:
        pad = T_in - T
        map_profiles = np.pad(map_profiles, [(0, 0), (0, 0), (0, pad)],
                              mode="edge")
        if margs_out is not None:
            margs_out = np.concatenate(
                [margs_out, np.full(margs_out.shape[:3] + (pad,),
                                    -math.log(n))], axis=-1)

    return BatchResults(
        k=np.arange(K_out),
        evidence=evidence[:B_real],
        evidence_se=evidence_se[:B_real],
        map_profiles=map_profiles[:, :B_real],
        dE=dE,
        marginals=margs_out[:, :B_real] if margs_out is not None else None,
        mom_ok=momok_h[:B_real],
        evals=evals[:B_real],
        rounds=rounds,
    )
