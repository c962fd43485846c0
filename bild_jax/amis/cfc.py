"""
Conflict-Free Categorical (CFC) proposal over state traces theta.

Reference parity: ``bild/amis.py:153-536``. The CFC is a categorical over
length-(k+1) state sequences with transition constraints, parametrized by
per-slot weights ``logp`` (shape ``(n, k+1)``, normalized so
``logsumexp(logp, axis=0) == 0``) and sampled causally slot by slot.

Split of labor:

- device (jit/vmap-safe pure functions): `cfc_sample` (a ``lax.scan`` over
  slots), `cfc_logpmf`, `cfc_estimate` ("method of marginals" with a
  ``lax.while_loop`` fixed-point solve per slot);
- host (setup-time control logic, arbitrary-precision ints): counting
  trajectories through transition-matrix powers (`N_total`,
  `uniform_marginals`) and exhaustive enumeration (`full_sample`), exactly
  the quantities whose integer growth forced the reference to python ints
  (``bild/amis.py:426-438``).
"""
from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

__all__ = ["CFC", "SampleSpaceTooLarge", "cfc_sample", "cfc_logpmf",
           "cfc_estimate"]


class SampleSpaceTooLarge(ValueError):
    """`CFC.full_sample` would exceed its Nmax. A ValueError subclass so
    callers can distinguish it from genuine errors raised inside model
    likelihoods during exhaustive enumeration."""

# NB: the sampling/evaluation/estimation functions accept an optional
# ``active`` boolean mask over the K slot axis (padded-k mode): inactive
# slots are sampled from a uniform unconstrained categorical (their values
# are never used: the corresponding interval fractions are exactly 0) and
# contribute nothing to pmf or estimates.


# ---------------------------------------------------------------------------
# Device-side pure functions
# ---------------------------------------------------------------------------

def cfc_sample(key, logp, transitions, N, active=None):
    """
    Draw ``N`` state traces from CFC(logp); ``(N, k+1)`` int32.

    Causal scheme (reference ``bild/amis.py:223-256``): sample slot 0 from
    ``logp[:, 0]``, then each next slot from ``logp[:, i]`` restricted to the
    transitions allowed from the previous state. Implemented as a
    ``lax.scan`` over slots with ``jax.random.categorical`` on masked logits.
    """
    logp = jnp.asarray(logp)
    transitions = jnp.asarray(transitions, dtype=bool)
    n, k1 = logp.shape
    keys = jax.random.split(key, k1)

    th0 = jax.random.categorical(keys[0], jnp.broadcast_to(logp[:, 0], (N, n)), axis=-1)

    if k1 == 1:
        return th0[:, None].astype(jnp.int32)

    def step(carry, x):
        prev = carry
        ki, logp_i, act = x
        allowed = transitions[prev]  # (N, n)
        logits = jnp.where(allowed, logp_i[None, :], -jnp.inf)
        # padded slot: unconstrained uniform (value unused downstream) —
        # keeps the chain alive even from states with no allowed successor
        logits = jnp.where(act, logits, 0.0)
        th = jax.random.categorical(ki, logits, axis=-1)
        return th, th

    act = (jnp.ones(k1 - 1, dtype=bool) if active is None
           else jnp.asarray(active)[1:])
    _, ths = jax.lax.scan(step, th0, (keys[1:], logp[:, 1:].T, act))
    return jnp.concatenate([th0[:, None], ths.T], axis=1).astype(jnp.int32)


def cfc_logpmf(logp, thetas, transitions, active=None):
    """
    Log-pmf of traces ``thetas`` (``(N, k+1)`` int) under CFC(logp) -> (N,).
    Reference ``bild/amis.py:258-281``.

    Hot path: called on the whole stored AMIS ensemble (S*N traces) every
    step. Everything is expressed through one-hot masks instead of gathers
    (``take_along_axis``, integer indexing): ``n`` is tiny, so broadcasting
    over it fuses into elementwise code.
    """
    logp = jnp.asarray(logp)
    thetas = jnp.asarray(thetas)
    transitions = jnp.asarray(transitions, dtype=bool)
    n = logp.shape[0]

    onehot = thetas[:, :, None] == jnp.arange(n)          # (N, k+1, n)
    # exactly one state per slot is hot -> the where-sum reproduces the
    # gathered value bit-for-bit (incl. -inf weights)
    logp_theta = jnp.sum(jnp.where(onehot, logp.T[None], 0.0), axis=-1)
    if active is not None:
        logp_theta = jnp.where(jnp.asarray(active)[None, :], logp_theta, 0.0)
    if thetas.shape[1] > 1:
        # normalization of each conditional slot: logsumexp over the states
        # allowed from the previous slot's state
        allowed = jnp.any(onehot[:, :-1, :, None] & transitions[None, None],
                          axis=2)                         # (N, k, n)
        log_norm = logsumexp(
            jnp.where(allowed, logp.T[None, 1:, :], -jnp.inf), axis=-1)
        if active is not None:
            log_norm = jnp.where(jnp.asarray(active)[None, 1:], log_norm, 0.0)
        log_norm_sum = jnp.sum(log_norm, axis=1)
    else:
        log_norm_sum = 0.0
    log_norm0 = logsumexp(logp[:, 0])
    return jnp.sum(logp_theta, axis=1) - log_norm_sum - log_norm0


def _solve_marginals(logf, logg, transitions, maxiter, precision,
                     frozen=None):
    """
    Fixed-point solve for slot weights from (current, previous) marginals,
    batched over a leading slot axis: ``logf, logg (K, n)`` -> ``(logp (K, n),
    converged (K,))``. Reference ``bild/amis.py:336-392``.

    All K independent solves advance in ONE ``lax.while_loop`` (the reference
    — and a scan-of-while — solves slots sequentially, which serializes
    latency-bound micro-iterations on a device). A slot freezes at its first
    iterate with max-delta < precision, so results are bit-identical to
    per-slot solves; the loop ends when every slot is frozen. ``frozen``
    pre-freezes slots (padded-k mode). Convergence cannot raise inside jit,
    so the flag is surfaced to the host.
    """
    K, n = logf.shape
    i_f0 = logf == -jnp.inf                               # (K, n)
    i_g0 = logg == -jnp.inf
    # Kronecker-delta marginals: weights equal the marginal directly
    is_delta = (jnp.any(logf == 0, axis=1)
                | jnp.any(logg == 0, axis=1))             # (K,)
    done0 = is_delta if frozen is None else (is_delta | frozen)

    def body(state):
        logp_old, it, done = state
        log_norm = logsumexp(logp_old[:, None, :], b=transitions[None],
                             axis=2)                      # over j, per i
        log_norm = jnp.where(i_g0, 0.0, log_norm)
        logg_norm = logg - log_norm
        log_Sgp = logsumexp(logg_norm[:, :, None], b=transitions[None],
                            axis=1)                       # over i, per j
        log_Sgp = jnp.where(i_f0, 0.0, log_Sgp)
        logp = logf - log_Sgp
        logp = logp - logsumexp(logp, axis=1, keepdims=True)
        delta = jnp.where(i_f0, 0.0, jnp.abs(logp - logp_old))
        logp = jnp.where(done[:, None], logp_old, logp)   # freeze finished
        newly = jnp.max(delta, axis=1) < precision
        return logp, it + 1, done | newly

    def cond(state):
        _, it, done = state
        return (~jnp.all(done)) & (it < maxiter)

    logp, _, done = jax.lax.while_loop(
        cond, body, (logf, jnp.zeros((), jnp.int32), done0))
    logp = jnp.where(is_delta[:, None], logf, logp)
    return logp, done


def _solve_marginals_single(logf, logg, transitions, maxiter, precision):
    """Single-slot convenience wrapper around `_solve_marginals`."""
    logp, conv = _solve_marginals(logf[None], logg[None], transitions,
                                  maxiter, precision)
    return logp[0], conv[0]


def cfc_logp_from_marginals(log_marginals, transitions, maxiter=1000,
                            precision=1e-2, active=None):
    """Conversion of marginals to weights, all slots solved concurrently
    (reference ``bild/amis.py:307-334``). Returns ``(logp, converged)``.
    Inactive slots (padded-k mode) are skipped: their weights are uniform
    and they never count against convergence."""
    log_marginals = jnp.asarray(log_marginals)
    n, k1 = log_marginals.shape
    logp0 = log_marginals[:, 0]
    if k1 == 1:
        return logp0[:, None], jnp.asarray(True)

    act = (jnp.ones(k1 - 1, dtype=bool) if active is None
           else jnp.asarray(active)[1:])
    logps, convs = _solve_marginals(
        log_marginals[:, 1:].T, log_marginals[:, :-1].T, transitions,
        maxiter, precision, frozen=~act)
    uniform = -jnp.log(jnp.asarray(float(n), dtype=logps.dtype))
    logps = jnp.where(act[:, None], logps, uniform)
    convs = convs | ~act
    logp = jnp.concatenate([logp0[:, None], logps.T], axis=1)
    return logp, jnp.all(convs)


def cfc_estimate(thetas, log_weights, transitions, n, maxiter=1000,
                 precision=1e-2, active=None):
    """
    "Method of marginals" (reference ``bild/amis.py:283-305``): weighted
    marginals per slot, then invert to weights. Returns ``(logp, converged)``.
    """
    thetas = jnp.asarray(thetas)
    log_weights = jnp.asarray(log_weights)
    indicators = thetas[None, :, :] == jnp.arange(n)[:, None, None]  # (n, N, k+1)
    log_marginals = logsumexp(log_weights[None, :, None], b=indicators, axis=1)
    log_marginals = log_marginals - logsumexp(log_marginals, axis=0, keepdims=True)
    if active is not None:
        # padded slots carry arbitrary thetas: replace their marginals with
        # uniform so the fixed-point solver sees sane inputs
        uniform = jnp.full_like(log_marginals, -jnp.log(float(n)))
        log_marginals = jnp.where(jnp.asarray(active)[None, :],
                                  log_marginals, uniform)
    return cfc_logp_from_marginals(log_marginals, transitions, maxiter,
                                   precision, active=active)


def _solve_marginals_np(logf, logg, transitions, maxiter, precision):
    """
    Numpy twin of `_solve_marginals` for host-side setup work
    (`CFC.logp_uniform`). Calling the eager jax version from host control
    code re-traced + re-compiled a tiny while_loop on every call (its body
    closure is a fresh Python function each time), costing seconds per
    `sample_batch`; the setup solve is microscopic, so it belongs on host.
    """
    from scipy.special import logsumexp as sp_lse

    logf = np.asarray(logf, dtype=float)
    logg = np.asarray(logg, dtype=float)
    tr = np.asarray(transitions, dtype=bool)
    i_f0 = logf == -np.inf
    i_g0 = logg == -np.inf
    is_delta = np.any(logf == 0, axis=1) | np.any(logg == 0, axis=1)
    done = is_delta.copy()
    logp = logf.copy()
    for _ in range(maxiter):
        if done.all():
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            log_norm = sp_lse(logp[:, None, :], b=tr[None], axis=2)
            log_norm = np.where(i_g0, 0.0, log_norm)
            logg_norm = logg - log_norm
            log_Sgp = sp_lse(logg_norm[:, :, None], b=tr[None], axis=1)
            log_Sgp = np.where(i_f0, 0.0, log_Sgp)
            lp = logf - log_Sgp
            lp = lp - sp_lse(lp, axis=1, keepdims=True)
            delta = np.where(i_f0, 0.0, np.abs(lp - logp))
        lp = np.where(done[:, None], logp, lp)
        done = done | (np.max(delta, axis=1) < precision)
        logp = lp
    logp = np.where(is_delta[:, None], logf, logp)
    return logp, done


# ---------------------------------------------------------------------------
# Host-side CFC object (setup logic + convenience wrappers)
# ---------------------------------------------------------------------------

# logp_uniform(k) is pure in (transitions, k) and is re-derived at every
# sampler/batch construction; cache it process-wide (bounded: k and the
# state-space size are tiny in practice)
_LOGP_UNIFORM_CACHE = {}
_LOGP_UNIFORM_CACHE_MAX = 512

class CFC:
    """
    Conflict-Free Categorical distribution over state traces.

    ``transitions[i, j]`` = is the switch ``i -> j`` allowed.
    """

    def __init__(self, transitions):
        self.transitions = np.array(transitions, dtype=bool, copy=True)
        self._transitions_dev = jnp.asarray(self.transitions)
        self.MOM_maxiter = 1000
        self.MOM_precision = 1e-2

    @property
    def n(self):
        return self.transitions.shape[0]

    # -- device wrappers ---------------------------------------------------
    def sample(self, key, logp, N=1):
        return cfc_sample(key, logp, self._transitions_dev, N)

    def logpmf(self, logp, thetas):
        return cfc_logpmf(logp, thetas, self._transitions_dev)

    def estimate(self, thetas, log_weights):
        logp, converged = cfc_estimate(
            thetas, log_weights, self._transitions_dev, self.n,
            self.MOM_maxiter, self.MOM_precision,
        )
        if not bool(converged):
            raise RuntimeError("Iteration did not converge")
        return logp

    def logp_from_marginals(self, log_marginals):
        """Weight parameters reproducing the given per-slot marginals
        (reference ``bild/amis.py:307-334``); raises if the fixed-point
        solve of any slot diverges, like `estimate`."""
        logp, converged = cfc_logp_from_marginals(
            jnp.asarray(log_marginals), self._transitions_dev,
            self.MOM_maxiter, self.MOM_precision,
        )
        if not bool(converged):
            raise RuntimeError("Iteration did not converge")
        return logp

    def solve_marginals_single(self, logf, logg):
        logp, converged = _solve_marginals_single(
            jnp.asarray(logf), jnp.asarray(logg), self._transitions_dev,
            self.MOM_maxiter, self.MOM_precision,
        )
        if not bool(converged):
            raise RuntimeError("Iteration did not converge")
        return logp

    # -- host-side counting (arbitrary precision ints) ---------------------
    def _T_int(self):
        """Transition matrix as a python-int nested list."""
        return [[int(v) for v in row] for row in self.transitions]

    @staticmethod
    def _matmul_int(A, B):
        n = len(A)
        return [[sum(A[i][l] * B[l][j] for l in range(n)) for j in range(n)]
                for i in range(n)]

    def _matpow_int(self, p):
        n = self.n
        out = [[int(i == j) for j in range(n)] for i in range(n)]
        base = self._T_int()
        while p:
            if p & 1:
                out = self._matmul_int(out, base)
            base = self._matmul_int(base, base)
            p >>= 1
        return out

    def N_total(self, k, log=False):
        """Number of state traces with ``k`` switches (python int; exact)."""
        P = self._matpow_int(k)
        N = sum(sum(row) for row in P)
        return math.log(N) if log else N

    def uniform_marginals(self, k):
        """
        Per-slot marginals of the uniform distribution over all traces, via
        path counting with transition-matrix powers (reference
        ``bild/amis.py:394-449``); exact in python ints, returned as float
        log-marginals normalized per slot.
        """
        n = self.n
        counts = np.empty((n, k + 1), dtype=object)
        for i in range(k + 1):
            Pin = self._matpow_int(i)     # paths arriving at state s after i steps
            Pout = self._matpow_int(k - i)  # paths leaving state s for k-i steps
            col_in = [sum(Pin[a][s] for a in range(n)) for s in range(n)]
            row_out = [sum(Pout[s][b] for b in range(n)) for s in range(n)]
            for s in range(n):
                counts[s, i] = col_in[s] * row_out[s]

        def safe_log(x):
            return math.log(x) if x > 0 else -np.inf

        totals = [sum(counts[s, i] for s in range(n)) for i in range(k + 1)]
        out = np.array([[safe_log(counts[s, i]) - safe_log(totals[i])
                         for i in range(k + 1)] for s in range(n)])
        return out

    def logp_uniform(self, k):
        """Weights reproducing the uniform distribution (reference
        ``bild/amis.py:451-472``). Host-computed and cached: the result is
        pure in (transitions, k)."""
        cache_key = (self.transitions.tobytes(), self.transitions.shape, k,
                     self.MOM_maxiter, self.MOM_precision)
        hit = _LOGP_UNIFORM_CACHE.pop(cache_key, None)
        if hit is not None:
            _LOGP_UNIFORM_CACHE[cache_key] = hit    # refresh recency
            return hit
        lm = np.asarray(self.uniform_marginals(k))
        if k == 0:
            logp = lm[:, :1]
        else:
            logps, conv = _solve_marginals_np(
                lm[:, 1:].T, lm[:, :-1].T, self.transitions,
                self.MOM_maxiter, self.MOM_precision)
            if not bool(np.all(conv)):
                raise RuntimeError("Iteration did not converge")
            logp = np.concatenate([lm[:, :1], logps.T], axis=1)
        while len(_LOGP_UNIFORM_CACHE) >= _LOGP_UNIFORM_CACHE_MAX:
            _LOGP_UNIFORM_CACHE.pop(next(iter(_LOGP_UNIFORM_CACHE)))
        _LOGP_UNIFORM_CACHE[cache_key] = logp
        return logp

    def full_sample(self, k, Nmax=1000):
        """
        All state traces with ``k`` switches, ``(N_total, k+1)`` int array in
        lexicographic (decision-tree) order. Raises ``ValueError`` if the
        sample would exceed ``Nmax`` (reference ``bild/amis.py:496-536``).
        """
        N = self.N_total(k)
        if N > Nmax:
            raise SampleSpaceTooLarge(
                f"Full sample would be {N} > Nmax = {Nmax} traces")

        allowed = [np.nonzero(self.transitions[i])[0].tolist() for i in range(self.n)]
        rows = [[s] for s in range(self.n)]
        for _ in range(k):
            rows = [row + [nxt] for row in rows for nxt in allowed[row[-1]]]
        rows = [row for row in rows if len(row) == k + 1]
        return np.array(rows, dtype=int).reshape(len(rows), k + 1)
