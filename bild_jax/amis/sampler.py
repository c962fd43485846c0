"""
Fixed-k AMIS sampler.

Reference parity: ``FixedkSampler``, ``bild/amis.py:540-972``. The AMIS
scheme (Cornuet et al. 2012) iterates: draw N profiles from the current
proposal, evaluate their likelihoods, deterministic-mixture-reweight the full
historical ensemble, refit the proposal by (braked) method of moments, and
update the evidence estimate.

Device-resident structure
-------------------------
All sampler state lives in a fixed-size device pytree (`AmisState`):
preallocated ``(S, N, .)`` ring-less buffers for the S = max_fev/N possible
steps, plus proposal-parameter and evidence tracks. One AMIS step is two
jitted calls around the model's batched likelihood:

    propose: params -> (ss, thetas, profiles)          [device]
    logL   : model.logL_batch(profiles, traj)          [device for Rouse/
                                                        Factorized; host for
                                                        ragged GGM]
    update : delta-reweighting of the WHOLE ensemble, weighted MoM proposal
             refit with concentration/polarization brakes, evidence/SEM/KL
                                                       [device]

This replaces the reference's per-profile Python loop and growing host lists
(``bild/amis.py:734-739,822-845``) with masked fixed-shape array programs —
the same functions vmap across trajectories for the lockstep batched runner.

Semantics preserved exactly (SURVEY.md section 7): floor-based ``st2profile``
discretization, prior ``k!/N_total`` (``bild/amis.py:654-659``), the
concentration and polarization brakes (``:856-873``), exhaustive enumeration
below ``max_fcomplete`` (``:741-803``), and the ``k >= T`` degeneracy guard
(``:641-648``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..config import fdtype
from ..profiles import Loopingprofile, st2profile
from .cfc import CFC, SampleSpaceTooLarge, cfc_sample, cfc_logpmf, cfc_estimate
from .dirichlet import (dirichlet_logpdf, dirichlet_estimate,
                        dirichlet_sample_masked)

__all__ = ["FixedkSampler", "AmisState"]

_NEG_INF = -jnp.inf


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AmisState:
    """Fixed-shape device state of one fixed-k AMIS sampler."""

    ss: jax.Array         # (S, N, k+1) float  — interval fractions
    thetas: jax.Array     # (S, N, k+1) int32  — state traces
    logLs: jax.Array      # (S, N) float
    logdeltas: jax.Array  # (S, N) float — deterministic-mixture proposal mass
    a_params: jax.Array   # (S+1, k+1) float — Dirichlet concentrations
    logps: jax.Array      # (S+1, n, k+1) float — CFC weights
    evidences: jax.Array  # (S, 3) float — (logev, dlogev, KL) per step
    n_steps: jax.Array    # () int32
    mom_ok: jax.Array     # () bool — CFC fixed point converged at every step

    @staticmethod
    def create(S, N, k, n, a0, logp0):
        dtype = fdtype()
        return AmisState(
            ss=jnp.zeros((S, N, k + 1), dtype=dtype),
            thetas=jnp.zeros((S, N, k + 1), dtype=jnp.int32),
            logLs=jnp.zeros((S, N), dtype=dtype),
            logdeltas=jnp.zeros((S, N), dtype=dtype),
            a_params=jnp.zeros((S + 1, k + 1), dtype=dtype).at[0].set(a0),
            logps=jnp.zeros((S + 1, n, k + 1), dtype=dtype).at[0].set(logp0),
            evidences=jnp.zeros((S, 3), dtype=dtype),
            n_steps=jnp.zeros((), dtype=jnp.int32),
            mom_ok=jnp.ones((), dtype=bool),
        )


def informed_proposal(fracs, theta, n, T):
    """
    Proposal parameters concentrated around a segmentation guess:
    Dirichlet mean = the guessed interval fractions at total concentration
    ``(k+1) * max(2, sqrt(T))`` — switch-position spread must shrink with
    trajectory length or the seed is useless at long T (measured: T=1000
    frame accuracy 0.91 at concentration ~8 vs 0.97 at ~130). CFC slots go
    80/20 toward the guessed states. Shared by the adaptive and lockstep
    informed-init paths.
    """
    fracs = np.asarray(fracs, dtype=float)
    theta = np.asarray(theta, dtype=int)
    k1 = len(fracs)
    conc = k1 * max(2.0, float(np.sqrt(T)))
    a = np.maximum(conc * fracs, 0.05)
    p = np.full((n, k1), 0.2 / max(n - 1, 1))
    p[theta, np.arange(k1)] = 0.8
    return a, np.log(p)


def informed_proposal_batch(fracs, theta, n, T):
    """`informed_proposal` vectorized over a batch: ``fracs/theta (B, k+1)``
    -> ``(a (B, k+1), logp (B, n, k+1))``. Same constants, no per-row loop
    (the dataset informed-init path calls this once per k for all B)."""
    fracs = np.asarray(fracs, dtype=float)
    theta = np.asarray(theta, dtype=int)
    B, k1 = fracs.shape
    conc = k1 * max(2.0, float(np.sqrt(T)))
    a = np.maximum(conc * fracs, 0.05)
    p = np.full((B, n, k1), 0.2 / max(n - 1, 1))
    np.put_along_axis(p, theta[:, None, :], 0.8, axis=1)
    return a, np.log(p)


def _log_proposal(a, logp, ss, thetas, transitions, active=None):
    """Joint proposal density: Dirichlet(s) x CFC(theta).

    A +inf Dirichlet density (zero coordinate with concentration < 1, the
    reference's ValueError->inf convention, ``bild/amis.py:104-108``)
    dominates the sum even when the CFC part is -inf: such points must get
    zero importance weight, and ``inf + -inf = nan`` would otherwise poison
    the mixture (a latent edge case in the reference, amplified in float32
    where the polarization brake can underflow CFC weights to exactly 0).
    """
    dlp = dirichlet_logpdf(a, ss, active=active)
    clp = cfc_logpmf(logp, thetas, transitions, active=active)
    return jnp.where(jnp.isposinf(dlp), jnp.inf, dlp + clp)


@partial(jax.jit, static_argnames=("N", "T"))
def amis_propose(state: AmisState, key, transitions, *, N: int, T: int,
                 active=None):
    """Draw N (s, theta) pairs from the current proposal; also return the
    discretized ``(N, T)`` profiles. ``active`` (bool ``(K,)``) enables the
    padded-k mode: one compiled program serves every true k <= K-1, padded
    slots have interval fraction exactly 0 and never produce a switch."""
    sc = state.n_steps
    a = state.a_params[sc]
    logp = state.logps[sc]
    kd, kc = jax.random.split(key)
    if active is None:
        ss = jax.random.dirichlet(kd, a, shape=(N,), dtype=a.dtype)
    else:
        ss = dirichlet_sample_masked(kd, a, active, N)
    thetas = cfc_sample(kc, logp, transitions, N, active=active)
    profiles = jax.vmap(lambda s, th: st2profile(s, th, T, active=active))(ss, thetas)
    return ss, thetas, profiles


@partial(jax.jit, static_argnames=("maxiter",))
def amis_update(state: AmisState, ss_new, th_new, logL_new, transitions,
                logprior, conc_brake_N, pol_brake_N, *, maxiter: int = 1000,
                active=None):
    """
    Ingest one new sample block and run the AMIS ensemble update
    (reference ``bild/amis.py:805-906``). Returns (state', (logev, dlogev, KL)).
    ``active`` enables the padded-k mode (see `amis_propose`).
    """
    S, N = state.logLs.shape
    k1 = state.ss.shape[-1]
    n = state.logps.shape[1]
    sc = state.n_steps                      # index of the step being ingested
    dtype = state.logLs.dtype

    a_cur = state.a_params[sc]
    logp_cur = state.logps[sc]

    # write the new block
    ss = state.ss.at[sc].set(ss_new)
    thetas = state.thetas.at[sc].set(th_new)
    logLs = state.logLs.at[sc].set(logL_new)

    # current-proposal density for every stored sample (flat over S*N)
    clp = _log_proposal(a_cur, logp_cur,
                        ss.reshape(S * N, k1), thetas.reshape(S * N, k1),
                        transitions, active=active).reshape(S, N)

    # mixture-delta for the new block: logsumexp over all proposals 0..sc
    def prop_j(a_j, logp_j):
        return _log_proposal(a_j, logp_j, ss_new, th_new, transitions,
                             active=active)

    all_lp = jax.vmap(prop_j)(state.a_params, state.logps)      # (S+1, N)
    slot_ok = (jnp.arange(S + 1) <= sc)[:, None]
    logdelta_new = jax.scipy.special.logsumexp(
        jnp.where(slot_ok, all_lp, _NEG_INF), axis=0)

    row = jnp.arange(S)[:, None]                                # (S, 1)
    is_old = row < sc
    is_new = row == sc
    logdeltas = jnp.where(
        is_old, jnp.logaddexp(state.logdeltas, clp),
        jnp.where(is_new, jnp.broadcast_to(logdelta_new[None, :], (S, N)),
                  state.logdeltas))

    # weights over the whole (masked) ensemble; a NaN log-weight marks an
    # inconsistent point (conflicting infinities) -> zero weight
    valid = row <= sc
    log_w = logLs - logdeltas + jnp.log1p(sc.astype(dtype))     # log(sc+1)
    log_w_masked = jnp.where(valid & ~jnp.isnan(log_w), log_w, _NEG_INF)
    flat_lw = log_w_masked.reshape(S * N)

    # proposal refit (weighted MoM); an invalid Dirichlet estimate (negative
    # or non-finite concentration from an over-dispersed or fully
    # zero-weighted ensemble — where the reference crashes in scipy) keeps
    # the previous proposal instead
    new_a = dirichlet_estimate(ss.reshape(S * N, k1), flat_lw, active=active)
    act = jnp.ones(k1, dtype=bool) if active is None else active
    a_invalid = jnp.any(jnp.where(act, ~jnp.isfinite(new_a) | (new_a <= 0),
                                  False))
    new_a = jnp.where(a_invalid, a_cur, new_a)

    new_logp, mom_conv = cfc_estimate(thetas.reshape(S * N, k1), flat_lw,
                                      transitions, n, maxiter=maxiter,
                                      active=active)
    lp_invalid = jnp.any(jnp.isnan(new_logp))
    new_logp = jnp.where(lp_invalid, logp_cur, new_logp)
    mom_conv = mom_conv | lp_invalid  # reverted, not a convergence failure

    # concentration brake (reference bild/amis.py:856-859); sums over active
    # slots only, so padded-k results match the exact-k program
    def asum(a):
        return jnp.sum(a) if active is None else jnp.sum(jnp.where(active, a, 0.0))

    log_cr = jnp.log(asum(new_a) / asum(a_cur))
    over = jnp.abs(log_cr) > conc_brake_N
    new_a = jnp.where(
        over, new_a * jnp.exp(jnp.sign(log_cr) * conc_brake_N - log_cr), new_a)
    if active is not None:
        new_a = jnp.where(active, new_a, 1.0)

    # polarization brake, per slot (reference bild/amis.py:861-873)
    old_p = jnp.exp(logp_cur)
    new_p = jnp.exp(new_logp)
    delta = new_p - old_p                                       # (n, k+1)
    mad = jnp.max(jnp.abs(delta), axis=0)                       # (k+1,)
    safe_mad = jnp.where(mad > 0, mad, 1.0)
    braked = jnp.log(old_p + pol_brake_N * delta / safe_mad)
    new_logp = jnp.where((mad > pol_brake_N)[None, :], braked, new_logp)
    if active is not None:
        new_logp = jnp.where(active[None, :], new_logp,
                             -jnp.log(jnp.asarray(float(n), dtype)))

    # evidence, SEM, KL (reference bild/amis.py:876-900)
    cnt = ((sc + 1) * N).astype(dtype)
    max_lw = jnp.max(log_w_masked)
    w_o = jnp.exp(log_w_masked - max_lw)
    ev_o = jnp.sum(w_o) / cnt
    logev = jnp.log(ev_o) + max_lw + logprior
    var = jnp.sum(jnp.where(valid, (w_o - ev_o) ** 2, 0.0)) / (cnt - 1)
    dlogev = jnp.sqrt(var / cnt) / ev_o

    kl_term = w_o * (logLs - clp)
    kl_term = jnp.where(valid & ~jnp.isnan(kl_term), kl_term, 0.0)
    KL = jnp.sum(kl_term) / cnt / ev_o - logev + logprior

    state = AmisState(
        ss=ss, thetas=thetas, logLs=logLs, logdeltas=logdeltas,
        a_params=state.a_params.at[sc + 1].set(new_a),
        logps=state.logps.at[sc + 1].set(new_logp),
        evidences=state.evidences.at[sc].set(jnp.stack([logev, dlogev, KL])),
        n_steps=sc + 1,
        mom_ok=state.mom_ok & mom_conv,
    )
    return state, (logev, dlogev, KL)


# fused steps are cached by (logL_fn identity, N, T): models hand out STABLE
# logL_fn objects (cached on the model instance), so re-creating samplers for
# the same model re-uses compiled steps instead of re-tracing per sampler.
# Bounded LRU (entries retain logL_fn closures + compiled executables; an
# unbounded cache would leak in long-running jobs that churn through models
# or per-trajectory noise configurations).
_FUSED_STEPS = {}
_FUSED_STEPS_MAX = 32


def _make_fused_steps(logL_fn, N: int, T: int):
    """Multi-step one-dispatch AMIS runner for models with a traceable
    likelihood (`lockstep_fns_single`): ``n_run`` iterations of propose ->
    batched logL -> ensemble update in a single jitted call, with the
    informed-proposal injection applied in-loop after the first step. All
    step outputs come back PACKED in one array: each fetched leaf costs a
    device-to-host round trip, so the adaptive loop fetches once per step.

    The PRNG split pattern inside the loop matches n sequential single-step
    calls exactly, so batched and stepwise execution sample identically.
    """
    cache_key = (logL_fn, N, T)
    if cache_key in _FUSED_STEPS:
        # refresh recency: dict insertion order is the eviction order
        hit = _FUSED_STEPS.pop(cache_key)
        _FUSED_STEPS[cache_key] = hit
        return hit
    while len(_FUSED_STEPS) >= _FUSED_STEPS_MAX:
        _FUSED_STEPS.pop(next(iter(_FUSED_STEPS)))

    @partial(jax.jit, static_argnames=("n_run",))
    def steps(state, key, transitions, logprior, cb, pb, active, per_traj,
              a_inf, logp_inf, use_inf, n_run):
        start = state.n_steps
        S = state.logLs.shape[0]

        def body(_, carry):
            state, key, mom_trace = carry
            key, sub = jax.random.split(key)
            ss, th, profiles = amis_propose(state, sub, transitions, N=N,
                                            T=T, active=active)
            logLs = logL_fn(profiles, per_traj)
            state, _ = amis_update(state, ss, th,
                                   logLs.astype(state.logLs.dtype),
                                   transitions, logprior, cb, pb,
                                   active=active)
            # cumulative convergence AFTER this step: lets the host drop
            # evidences from the diverged step onward (the reference raises
            # inside the failing step, before its evidence is recorded)
            mom_trace = mom_trace.at[state.n_steps - 1].set(state.mom_ok)
            # second mixture component <- informed proposal, after step 1
            seed = use_inf & (state.n_steps == 1)
            state = dataclasses.replace(
                state,
                a_params=state.a_params.at[1].set(
                    jnp.where(seed, a_inf, state.a_params[1])),
                logps=state.logps.at[1].set(
                    jnp.where(seed, logp_inf, state.logps[1])))
            return state, key, mom_trace

        mom_trace0 = jnp.ones((S,), dtype=bool)
        state, key, mom_trace = jax.lax.fori_loop(
            0, n_run, body, (state, key, mom_trace0))
        ev = jax.lax.dynamic_slice(
            state.evidences, (start, jnp.zeros((), start.dtype)), (n_run, 3))
        mom_rows = jax.lax.dynamic_slice(mom_trace, (start,), (n_run,))
        packed = jnp.concatenate([
            ev.reshape(-1),
            mom_rows.astype(ev.dtype),
            jnp.stack([state.mom_ok.astype(ev.dtype),
                       state.n_steps.astype(ev.dtype)])])
        return state, key, packed

    _FUSED_STEPS[cache_key] = steps
    return steps


@partial(jax.jit, static_argnames=("T", "nStates"))
def _marginal_posterior(ss, thetas, log_weights, *, T: int, nStates: int,
                        active=None):
    """Weighted state marginals over an ensemble: ``(n, T)`` log-probs.

    NaN log-weights mark inconsistent points (``logL = -inf`` against a
    ``logdelta = -inf`` mixture density) and get zero weight — the same
    convention `amis_update` applies before the evidence sum; without it a
    single such sample poisons every frame of the marginals. If EVERY
    weight in the ensemble is NaN/-inf (no finite-likelihood sample at
    all), the posterior is all ``-inf`` rather than the raw
    ``-inf - (-inf) = NaN`` — a defined "no information" marker that the
    matching all ``-inf`` evidence already signals."""
    log_weights = jnp.where(jnp.isnan(log_weights), _NEG_INF, log_weights)
    flat_ss = ss.reshape(-1, ss.shape[-1])
    flat_th = thetas.reshape(-1, thetas.shape[-1])
    profs = jax.vmap(lambda s, th: st2profile(s, th, T, active=active))(flat_ss, flat_th)
    indic = profs[:, None, :] == jnp.arange(nStates)[None, :, None]
    logpost = jax.scipy.special.logsumexp(
        log_weights.reshape(-1)[:, None, None], b=indic, axis=0)
    norm = jax.scipy.special.logsumexp(logpost, axis=0)
    return jnp.where(jnp.isfinite(norm), logpost - norm, _NEG_INF)


class FixedkSampler:
    """
    AMIS sampling at fixed switch count ``k`` for one (trajectory, model).

    Parameters mirror the reference (``bild/amis.py:623-629``); ``key`` is
    the explicit PRNG key (seeded from numpy's global RNG if omitted).
    """

    class ExhaustionImpractical(ValueError):
        pass

    def __init__(self, traj, model, k,
                 N=100,
                 concentration_brake=1e-2,
                 polarization_brake=1e-3,
                 max_fev=20000,
                 max_fcomplete=1000,
                 key=None,
                 k_pad=None,
                 informed_init=False):
        self.k = k
        self.k_pad = k_pad
        self.informed_init = informed_init
        self.N = N
        self.brakes = (concentration_brake, polarization_brake)
        self.max_fev = max_fev
        self.max_fcomplete = max_fcomplete
        self.exhausted = False
        self._steps_host = 0

        self.traj = traj
        self.model = model
        self.T = len(traj)

        self.key = key if key is not None else jax.random.key(np.random.randint(2**31))
        self.evidences = []          # host mirror: [(logev, dlogev, KL)]
        self._exhaustive = None      # dict if exhaustively enumerated

        if self.k >= self.T:
            # unidentifiable by construction (reference bild/amis.py:641-648)
            self.evidences = [(-np.inf, 1e-10, np.inf)]
            self.exhausted = True
            return

        self.cfc = CFC(model.transitions)
        self._transitions = jnp.asarray(model.transitions)
        self.n = self.cfc.n

        # uniform prior value over profiles: k! / N_total  (bild/amis.py:654-659)
        self.logprior = float(
            sum(math.log(i + 1) for i in range(self.k)) - self.cfc.N_total(self.k, log=True)
        )

        # padded-k slot count: one compiled program serves every k <= k_pad
        # (SURVEY.md section 7 padding plan); padded slots carry interval
        # fraction exactly 0 and are masked out of all proposal math
        self.K1 = max(self.k, k_pad if k_pad is not None else self.k) + 1
        self.active = jnp.arange(self.K1) < (self.k + 1)

        dtype = fdtype()
        a0 = jnp.ones(self.K1, dtype=dtype)
        logp0 = jnp.full((self.n, self.K1), -np.log(self.n), dtype=dtype)
        logp0 = logp0.at[:, : self.k + 1].set(self.cfc.logp_uniform(self.k))

        # informed initialization: the DP segmentation of the model's
        # frame-factorized scores becomes the SECOND mixture component (the
        # first stays uniform): at long T the uniform proposal rarely finds
        # fine-grained switch positions, but a sharp seed from a BAD guess
        # must not strand the sampler — the deterministic mixture hedges the
        # two automatically (measured: seeding the first component instead
        # collapsed evidence by ~160 nats on weak-signal trajectories).
        self._informed = None
        if informed_init:
            guess = model.segment_guess(traj, k)
            if guess is not None:
                fracs, theta = guess
                a_inf, logp_inf = informed_proposal(fracs, theta, self.n, self.T)
                a_full = np.ones(self.K1)
                a_full[: self.k + 1] = a_inf
                logp_full = np.full((self.n, self.K1), -np.log(self.n))
                logp_full[:, : self.k + 1] = logp_inf
                self._informed = (jnp.asarray(a_full, dtype=dtype),
                                  jnp.asarray(logp_full, dtype=dtype))

        self.S = max(1, -(-self.max_fev // self.N) - 1)  # max possible steps
        self.state = AmisState.create(self.S, self.N, self.K1 - 1, self.n, a0, logp0)

        # fused single-dispatch multi-step runner when the model likelihood
        # is traceable
        self._fused = None
        self._per_traj = None
        try:
            self._per_traj, logL_fn = model.lockstep_fns_single(traj)
            self._fused = _make_fused_steps(logL_fn, self.N, self.T)
        except (AttributeError, ValueError):
            pass

        try:
            self.fix_exhaustive()
        except (self.ExhaustionImpractical, SampleSpaceTooLarge):
            # space too large to enumerate -> fall back to AMIS stepping.
            # (full_sample refusing is a latent crash in the reference when
            # max_fcomplete < nStates.) Other errors — e.g. a genuine
            # ValueError inside model.logL_batch — propagate.
            pass

    # -- parameter conversion (host convenience) ---------------------------
    def st2profile(self, s, theta) -> Loopingprofile:
        """(s, theta) -> Loopingprofile (reference ``bild/amis.py:670-695``)."""
        arr = np.asarray(st2profile(jnp.asarray(s, dtype=fdtype()),
                                    jnp.asarray(theta, dtype=jnp.int32), self.T))
        return Loopingprofile(arr)

    def log_proposal(self, parameters, ss, thetas):
        """Joint proposal density Dirichlet(ss) x CFC(thetas) under the
        given ``(a, logp)`` parameters; ``(N,)`` (reference
        ``bild/amis.py:697-715``, with this implementation's
        infinity-dominance rule — see `_log_proposal`)."""
        a, logp = parameters
        ss = np.asarray(ss)
        if ss.shape[-1] == self.k + 1:        # exact-size (reference shape)
            active = None
        elif ss.shape[-1] == self.K1:          # padded-k arrays
            active = self.active
        else:
            raise ValueError(f"ss has {ss.shape[-1]} slots; expected "
                             f"{self.k + 1} (exact) or {self.K1} (padded)")
        return np.asarray(_log_proposal(
            jnp.asarray(a, dtype=fdtype()), jnp.asarray(logp, dtype=fdtype()),
            jnp.asarray(ss, dtype=fdtype()), jnp.asarray(thetas, jnp.int32),
            self._transitions, active=active))

    def logL(self, ss, thetas):
        """Batched likelihood of (s, theta) parameter arrays; ``(N,)``."""
        profiles = jax.vmap(lambda s, th: st2profile(s, th, self.T))(
            jnp.asarray(ss, dtype=fdtype()), jnp.asarray(thetas, dtype=jnp.int32))
        return self.model.logL_batch(profiles, self.traj)

    # -- exhaustive enumeration (reference ``bild/amis.py:741-803``) -------
    def fix_exhaustive(self):
        Nmax = min(self.max_fcomplete, self.max_fev)

        Nsamples = self.cfc.N_total(self.k)
        for i in range(self.k):
            Nsamples *= self.T - i - 1
            if Nsamples > Nmax:
                raise self.ExhaustionImpractical(
                    f"Parameter space too large for exhaustive sampling "
                    f"(number of profiles = {Nsamples} > Nmax = {Nmax})")

        # switch positions at inter-frame midpoints; ss = interval fractions
        switch_list = list(itertools.combinations(np.arange(self.T - 1) + 0.5, self.k))
        normed = (np.array(switch_list, dtype=float).reshape(len(switch_list), self.k)
                  / (self.T - 1))
        normed = np.concatenate(
            [np.zeros((len(normed), 1)), normed, np.ones((len(normed), 1))], axis=1)
        ss = np.diff(normed, axis=1)                       # (n_pos, k+1)

        thetas = self.cfc.full_sample(self.k, Nmax=Nmax)   # (n_theta, k+1)

        n_pos = len(ss)
        ss = np.tile(ss, (len(thetas), 1))
        thetas = np.repeat(thetas, n_pos, axis=0)

        profiles = jax.vmap(lambda s, th: st2profile(s, th, self.T))(
            jnp.asarray(ss, dtype=fdtype()), jnp.asarray(thetas, dtype=jnp.int32))
        logLs = np.asarray(self.model.logL_batch(profiles, self.traj), dtype=float)

        # exact evidence: mean over the uniform prior ensemble
        max_logL = np.max(logLs)
        with np.errstate(under="ignore"):
            weights_o = np.exp(logLs - max_logL)
            ev_o = np.mean(weights_o)
            logev = float(np.log(ev_o) + max_logL)
            dlogev = 1e-10
            KL = float(np.mean(logLs * weights_o) / ev_o - logev)

        self._exhaustive = {
            "ss": ss, "thetas": thetas,
            "logLs": logLs, "profiles": np.asarray(profiles),
        }
        self.evidences.append((logev, dlogev, KL))
        self.exhausted = True

    # -- one AMIS step -----------------------------------------------------
    @property
    def n_steps_host(self) -> int:
        """Steps run so far, without a device fetch (host mirror; re-synced
        from the device state after a checkpoint restore)."""
        return self._steps_host

    def step(self) -> bool:
        """Run one AMIS iteration; ``False`` iff the sampler is exhausted."""
        return self.steps(1) == 1

    def steps(self, n: int) -> int:
        """Run up to ``n`` AMIS iterations in ONE device dispatch (a single
        host round trip for all outputs); returns the number actually run.
        Sampling is bit-identical to ``n`` sequential `step` calls."""
        if self.exhausted or n <= 0:
            return 0
        n_run = min(int(n), self.S - self._steps_host)
        if n_run <= 0:  # pragma: no cover - guarded by `exhausted`
            self.exhausted = True
            return 0

        dtype = fdtype()
        logprior = jnp.asarray(self.logprior, dtype=dtype)
        cb = jnp.asarray(self.N * self.brakes[0], dtype=dtype)
        pb = jnp.asarray(self.N * self.brakes[1], dtype=dtype)

        if self._fused is not None:
            if self._informed is not None:
                a_inf, logp_inf = self._informed
                use_inf = jnp.asarray(True)
            else:
                a_inf = jnp.ones(self.K1, dtype=dtype)
                logp_inf = jnp.full((self.n, self.K1),
                                    -np.log(self.n), dtype=dtype)
                use_inf = jnp.asarray(False)
            self.state, self.key, packed = self._fused(
                self.state, self.key, self._transitions, logprior, cb, pb,
                self.active, self._per_traj, a_inf, logp_inf, use_inf,
                n_run=n_run)
            vals = np.asarray(packed)            # ONE fetch for everything
            ev_rows = vals[: 3 * n_run].reshape(n_run, 3)
            mom_rows = vals[3 * n_run: 4 * n_run] != 0
            mom_ok = bool(vals[-2] != 0)
            n_steps = int(vals[-1])
            if not mom_ok:
                # keep only evidences from steps before the divergence (the
                # reference's failing step raises before logging evidence)
                ev_rows = ev_rows[: int(np.argmin(mom_rows))]
        else:
            # fallback for models without a traceable likelihood: stepwise
            ev_rows = np.zeros((n_run, 3))
            for i in range(n_run):
                self.key, sub = jax.random.split(self.key)
                ss, thetas, profiles = amis_propose(
                    self.state, sub, self._transitions, N=self.N, T=self.T,
                    active=self.active)
                logLs = jnp.asarray(
                    self.model.logL_batch(profiles, self.traj), dtype=dtype)
                self.state, out = amis_update(
                    self.state, ss, thetas, logLs, self._transitions,
                    logprior, cb, pb, active=self.active)
                ev_rows[i] = jax.device_get(jnp.stack(out))
                if self._informed is not None and \
                        int(self.state.n_steps) == 1:
                    a_inf, logp_inf = self._informed
                    self.state = dataclasses.replace(
                        self.state,
                        a_params=self.state.a_params.at[1].set(a_inf),
                        logps=self.state.logps.at[1].set(logp_inf))
            mom_ok = bool(self.state.mom_ok)
            n_steps = int(self.state.n_steps)

        self.evidences.extend((float(a), float(b), float(c))
                              for a, b, c in ev_rows)
        self._steps_host = n_steps
        if not mom_ok:
            raise RuntimeError(
                "CFC method-of-marginals iteration did not converge")
        if (n_steps + 1) * self.N >= self.max_fev:
            self.exhausted = True
        return n_run

    # -- reference-API views ------------------------------------------------
    @property
    def samples(self):
        """List of per-step sample dicts (keys ``ss``, ``thetas``, ``logLs``,
        ``log_weights``), a view of the device buffers in the reference's
        ``FixedkSampler.samples`` format (``bild/amis.py:586-588``)."""
        if self._exhaustive is not None:
            ex = self._exhaustive
            return [{"ss": ex["ss"], "thetas": ex["thetas"], "logLs": ex["logLs"]}]
        sc = int(self.state.n_steps)
        ss = np.asarray(self.state.ss[:sc])
        th = np.asarray(self.state.thetas[:sc])
        lls = np.asarray(self.state.logLs[:sc])
        lws = lls - np.asarray(self.state.logdeltas[:sc]) + (np.log(sc) if sc else 0.0)
        return [{"ss": ss[i], "thetas": th[i], "logLs": lls[i],
                 "log_weights": lws[i]} for i in range(sc)]

    @property
    def parameters(self):
        """Proposal parameter track ``[(a, logp), ...]`` (reference
        ``bild/amis.py:593-594``)."""
        sc = int(self.state.n_steps)
        a = np.asarray(self.state.a_params[: sc + 1])
        logp = np.asarray(self.state.logps[: sc + 1])
        return [(a[i], logp[i]) for i in range(sc + 1)]

    # -- results -----------------------------------------------------------
    def tstat(self, other) -> float:
        """Evidence separation score (reference ``bild/amis.py:908-924``)."""
        logev0, dlogev0 = self.evidences[-1][:2]
        logev1, dlogev1 = other.evidences[-1][:2]
        return (logev0 - logev1) / np.sqrt(dlogev0**2 + dlogev1**2)

    def _ensemble(self):
        """(ss, thetas, log_weights) of the full valid ensemble (host)."""
        if self._exhaustive is not None:
            ex = self._exhaustive
            return ex["ss"], ex["thetas"], ex["logLs"]
        sc = int(self.state.n_steps)
        ss = np.asarray(self.state.ss[:sc]).reshape(-1, self.K1)
        th = np.asarray(self.state.thetas[:sc]).reshape(-1, self.K1)
        lw = (np.asarray(self.state.logLs[:sc])
              - np.asarray(self.state.logdeltas[:sc]) + np.log(sc)).reshape(-1)
        return ss, th, lw

    def MAP_profile(self) -> Loopingprofile:
        """Maximum-likelihood profile over all evaluated samples
        (reference ``bild/amis.py:926-940``)."""
        if self._exhaustive is not None:
            i = int(np.argmax(self._exhaustive["logLs"]))
            return Loopingprofile(self._exhaustive["profiles"][i])
        sc = int(self.state.n_steps)
        logLs = np.asarray(self.state.logLs[:sc])
        step_i, samp_i = np.unravel_index(np.argmax(logLs), logLs.shape)
        # slice away padded slots (their interval fractions are 0)
        k1 = self.k + 1
        return self.st2profile(
            np.asarray(self.state.ss[step_i, samp_i])[:k1],
            np.asarray(self.state.thetas[step_i, samp_i])[:k1])

    def log_marginal_posterior(self) -> np.ndarray:
        """``(n, T)`` normalized log marginal posterior (reference
        ``bild/amis.py:942-972``)."""
        ss, th, lw = self._ensemble()
        active = None if self._exhaustive is not None else self.active
        return np.asarray(_marginal_posterior(
            jnp.asarray(ss, dtype=fdtype()), jnp.asarray(th, dtype=jnp.int32),
            jnp.asarray(lw, dtype=fdtype()),
            T=self.T, nStates=self.model.nStates, active=active))
