"""
Generic Gaussian-process model. Reference parity: ``GenericGaussianModel``,
``bild/models.py:536-728``.

Pure states are Gaussian processes specified by their MSD; the likelihood of
a profile factorizes over constant-state intervals, with trajectory
continuity enforced by conditioning each interval on the last observation of
the previous one.

Device design
-------------
The reference evaluates each profile's intervals one by one with dense numpy
solves (``bild/models.py:608-661``). Here the model is device-batched via an
**interval table**: there are only ``nStates * T * (T+1) / 2`` distinct
interval contributions for a trajectory of length T, each a function of
``(state, t0, t1)`` alone. We precompute them ALL once per trajectory —
grouped into window-length buckets, each bucket a vmapped
Cholesky/solve over identity-padded fixed-shape blocks — and a profile
batch's log-likelihood becomes a pure gather-sum over its interval
decomposition (one fixed-shape device call for any number of profiles).

The MSD functions are host callables, but they are only ever evaluated at
integer lags ``0..T`` (plus the plateau at infinity), so each becomes a
``(T+1,)`` lag table shipped to device once.

Continuity conditioning on device uses the Gaussian factorization
``log N(v; 0, C) = log N(v0; 0, C00) + log N(v_rest - v0 * C10/C00; 0, Schur)``
— an algebraic identity for ANY vector v — with the reference's exact
conditional (which conditions on the *raw* first datum, not the
mean-subtracted one): set ``v = [trace_0, trace_rest - m]`` and subtract the
``v0`` marginal.

The straight host implementation is kept as `logL_host`, the float64 parity
oracle.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
from scipy import linalg as sp_linalg

import jax
import jax.numpy as jnp

from ..config import fdtype, MATMUL_PRECISION
from ..physics import gp
from ..physics.rouse import two_locus_msd
from ..profiles import Loopingprofile
from ..trajectory import Trajectory
from .base import MultiStateModel

__all__ = ["GenericGaussianModel"]

LOG_2PI = float(np.log(2.0 * np.pi))


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def _masked_gaussian_logpdf(x, C, n_terms):
    """log N(x; 0, C) where inactive rows/cols of C are identity and inactive
    x are zero; ``n_terms`` counts the active entries for the 2-pi term."""
    chol = jnp.linalg.cholesky(C)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    quad = jnp.dot(x, jax.scipy.linalg.cho_solve((chol, True), x),
                   precision=MATMUL_PRECISION)
    return -0.5 * (quad + logdet + n_terms * LOG_2PI)


@functools.partial(jax.jit, static_argnames=("ss_order", "Lb"))
def _interval_entries(t0s, t1s, values, valid, msd_tab, plateau, mean,
                      *, ss_order, Lb):
    """
    Interval log-likelihood contributions for one (state, dim).

    t0s, t1s : (nc, chunk) int32 — interval starts (incl.) / ends (excl.),
        chunked for lax.map memory control
    values : (T,) observed values for this dim (zeros at missing frames)
    valid : (T,) bool
    msd_tab : (T+1,) MSD at integer lags
    plateau : scalar, MSD(inf) (ss_order 0 only)
    mean : scalar state mean
    """
    T = values.shape[0]
    dt = values.dtype
    eyeL = jnp.eye(Lb, dtype=dt)

    def one_ss0(t0, t1):
        t_start = jnp.maximum(t0 - 1, 0)
        w = t_start + jnp.arange(Lb, dtype=t0.dtype)
        act = (w < t1) & valid[jnp.minimum(w, T - 1)]
        vals = values[jnp.minimum(w, T - 1)]

        nobs = jnp.sum(act.astype(dt))
        conditioning = (t0 > 0) & (nobs > 0)
        # hybrid vector: raw first valid datum when conditioning, centered
        # elsewhere (reproduces the reference's mu = trace[0] * C10/C00)
        i0 = jnp.argmax(act)
        first = jnp.arange(Lb) == i0
        x = jnp.where(conditioning & first, vals, vals - mean)
        x = jnp.where(act, x, 0.0)

        lag = jnp.minimum(jnp.abs(w[:, None] - w[None, :]), T)
        Cfull = 0.5 * (plateau - msd_tab[lag])
        C = jnp.where(act[:, None] & act[None, :], Cfull, eyeL)
        lp = _masked_gaussian_logpdf(x, C, nobs)

        c00 = 0.5 * plateau
        lp0 = -0.5 * (vals[i0] ** 2 / c00 + jnp.log(c00) + LOG_2PI)
        return lp - jnp.where(conditioning, lp0, 0.0)

    def one_ss1(t0, t1):
        t_start = jnp.maximum(t0 - 1, 0)
        w = t_start + jnp.arange(Lb, dtype=t0.dtype)
        act = (w < t1) & valid[jnp.minimum(w, T - 1)]
        # compact the valid frame times to the front (ascending)
        pos = jnp.where(act, w, T + Lb)
        v = jnp.sort(pos)
        K = jnp.sum(act)
        inc_act = jnp.arange(Lb - 1) < (K - 1)

        xv = values[jnp.minimum(v, T - 1)]
        x = jnp.where(inc_act, xv[1:] - xv[:-1] - mean, 0.0)

        a, b = v[:-1], v[1:]

        def m(p, q):
            return msd_tab[jnp.minimum(jnp.abs(p[:, None] - q[None, :]), T)]

        Cfull = 0.5 * (m(a, b) + m(b, a) - m(a, a) - m(b, b))
        C = jnp.where(inc_act[:, None] & inc_act[None, :], Cfull,
                      jnp.eye(Lb - 1, dtype=dt))
        n_inc = jnp.maximum(K - 1, 0).astype(dt)
        return _masked_gaussian_logpdf(x, C, n_inc)

    one = one_ss0 if ss_order == 0 else one_ss1
    return jax.lax.map(lambda ab: jax.vmap(one)(*ab), (t0s, t1s))


@functools.partial(jax.jit, static_argnames=("ss_order", "W", "T"))
def _stationary_prefix_entries(values, u, cond, Lchol, logdet_cum, mean,
                               c00, *, ss_order, W, T):
    """
    All interval contributions for gap-free trajectories via the Toeplitz
    structure of stationary windows.

    For a fully-observed trajectory, the window covariance of interval
    ``[t0, t1)`` depends only on the WINDOW LENGTH (``C_kl = f(|k-l|)``), so
    one Cholesky factor ``Lchol`` of the maximal window covariance is shared
    by every start, its leading submatrices factor every shorter window, and
    forward substitution is prefix-consistent: ONE batched triangular solve
    per window start yields every ``t1`` at once via prefix sums of ``y^2``
    (the per-interval Cholesky of the bucketed fallback is O(T^5) total
    across the table; this is O(T^3)).

    values : (B, T); u : (C,) window starts; cond : (C,) bool, continuity
    conditioning (ss_order 0: first window datum enters RAW, and the caller
    subtracts its marginal `lp0`). Returns ``(lp (B, C, W), lp0 (B, C))``
    where ``lp[b, c, k]`` is the Gaussian log-density of the first ``k+1``
    window entries (frames for ss0; increments for ss1).
    """
    B = values.shape[0]
    C = u.shape[0]
    dt = values.dtype
    karange = jnp.arange(W)

    idx = u[:, None] + karange[None, :]                    # (C, W)
    if ss_order == 0:
        inb = idx < T
        g = values[:, jnp.clip(idx, 0, T - 1)]             # (B, C, W)
        x = jnp.where((cond[:, None] & (karange == 0)[None, :])[None],
                      g, g - mean)
        lp0 = jnp.where(cond[None, :],
                        -0.5 * (g[:, :, 0] ** 2 / c00 + jnp.log(c00)
                                + LOG_2PI),
                        0.0)
    else:
        inb = (idx + 1) < T
        lo = values[:, jnp.clip(idx, 0, T - 1)]
        hi = values[:, jnp.clip(idx + 1, 0, T - 1)]
        x = hi - lo - mean
        lp0 = jnp.zeros((B, C), dt)
    x = jnp.where(inb[None], x, 0.0)

    y = jax.scipy.linalg.solve_triangular(
        Lchol, x.reshape(B * C, W).T, lower=True)          # (W, B*C)
    quad = jnp.cumsum(y * y, axis=0)
    lp = -0.5 * (quad + logdet_cum[:, None]
                 + (karange + 1).astype(dt)[:, None] * LOG_2PI)
    return lp.T.reshape(B, C, W), lp0


@functools.partial(jax.jit, static_argnames=("n_states", "Lb"))
def _profile_table_sum_banded(profiles, Bandflat, Headflat, Gflat,
                              n_states, Lb):
    """
    Banded-table gather-sum (see ``GenericGaussianModel`` ``T_band``).

    ``Bandflat[(s*T + t0)*(Lb+1) + l]`` is the exact contribution of interval
    ``[t0, t0+l)`` for ``l <= Lb``. Longer intervals decompose into the exact
    W-frame head window plus per-frame sliding-window conditionals:

        V[t0, t1] = Head[s*T + t0] + G[s*T + t1 - 1] - G[s*T + u + Lb]

    with ``u = max(t0-1, 0)``, ``W = Lb+1``, ``G`` the cumulative sum of
    ``g[t] = log p(x_t | x_{t-Lb..t-1})``. Everything is elementwise +
    gathers; same NaN contract as `_profile_table_sum`.
    """
    P, T = profiles.shape
    profiles = profiles.astype(jnp.int32)
    tgrid = jnp.arange(T, dtype=jnp.int32)

    start = jnp.concatenate(
        [jnp.ones((P, 1), bool), profiles[:, 1:] != profiles[:, :-1]], axis=1)
    idx = jnp.where(start, tgrid[None, :], T)
    suffix_min = jax.lax.associative_scan(
        jnp.minimum, idx[:, ::-1], axis=1)[:, ::-1]
    nxt = jnp.concatenate(
        [suffix_min[:, 1:], jnp.full((P, 1), T, dtype=jnp.int32)], axis=1)

    safe_s = jnp.clip(profiles, 0, n_states - 1)
    length = nxt - tgrid[None, :]               # interval length at starts
    u = jnp.maximum(tgrid - 1, 0)[None, :]
    inb = length <= Lb
    band_idx = ((safe_s * T + tgrid[None, :]) * (Lb + 1)
                + jnp.clip(length, 0, Lb))
    head_idx = safe_s * T + tgrid[None, :]
    ghi_idx = safe_s * T + jnp.clip(nxt - 1, 0, T - 1)
    glo_idx = safe_s * T + jnp.clip(u + Lb, 0, T - 1)
    val = jnp.where(inb, jnp.take(Bandflat, band_idx),
                    jnp.take(Headflat, head_idx)
                    + jnp.take(Gflat, ghi_idx) - jnp.take(Gflat, glo_idx))
    total = jnp.sum(val * start, axis=1)

    in_range = jnp.all((profiles >= 0) & (profiles < n_states), axis=1)
    return jnp.where(in_range, total, jnp.nan)


@functools.partial(jax.jit, static_argnames=("n_states",))
def _profile_table_sum(profiles, Vflat, n_states):
    """
    Gather-sum a profile batch's interval contributions from the flat table.

    ``Vflat[(s*T + t0)*(T+1) + t1]`` is the contribution of interval
    ``[t0, t1)`` in state s. Out-of-range states yield NaN (same contract as
    the Rouse kernels).
    """
    P, T = profiles.shape
    profiles = profiles.astype(jnp.int32)
    tgrid = jnp.arange(T, dtype=jnp.int32)

    start = jnp.concatenate(
        [jnp.ones((P, 1), bool), profiles[:, 1:] != profiles[:, :-1]], axis=1)
    idx = jnp.where(start, tgrid[None, :], T)
    # end of the interval starting at t = the next start strictly after t
    suffix_min = jax.lax.associative_scan(
        jnp.minimum, idx[:, ::-1], axis=1)[:, ::-1]
    nxt = jnp.concatenate(
        [suffix_min[:, 1:], jnp.full((P, 1), T, dtype=jnp.int32)], axis=1)

    safe_s = jnp.clip(profiles, 0, n_states - 1)
    flat = (safe_s * T + tgrid[None, :]) * (T + 1) + nxt
    total = jnp.sum(jnp.take(Vflat, flat) * start, axis=1)

    in_range = jnp.all((profiles >= 0) & (profiles < n_states), axis=1)
    return jnp.where(in_range, total, jnp.nan)


# lockstep profiles come from st2profile of (k_max+1)-slot parameters, so
# they carry at most k_max+1 intervals. The dense gather-sums above touch
# all T positions per profile — at (B=16, N=128, T=1000) each 2M-lane
# random `take` costs ~21 ms on the chip (measured, DESIGN.md section 7p)
# while only ~5 lanes per profile are interval starts. The sparse variants
# extract the <= _SPARSE_KCAP start positions per profile with one top_k
# and gather only there: same semantics, ~140x fewer gather lanes.
# Profiles with MORE intervals yield NaN (the established invalid-profile
# contract) — the public logL_batch keeps the dense path for arbitrary
# profiles.
_SPARSE_KCAP = 33        # supports k_max <= 32 (reference default: 20)


def _sparse_intervals(profiles, Kcap):
    """First ``Kcap`` interval (t0, t1, state) triples per profile row, plus
    a slot-valid mask and an ``ok`` flag (False where a profile has more
    than ``Kcap`` intervals)."""
    P, T = profiles.shape
    tgrid = jnp.arange(T, dtype=jnp.int32)
    start = jnp.concatenate(
        [jnp.ones((P, 1), bool), profiles[:, 1:] != profiles[:, :-1]], axis=1)
    idx = jnp.where(start, tgrid[None, :], T)
    t0 = -jax.lax.top_k(-idx, Kcap)[0]            # ascending starts, pad T
    t1 = jnp.concatenate(
        [t0[:, 1:], jnp.full((P, 1), T, dtype=t0.dtype)], axis=1)
    t1 = jnp.minimum(t1, T)
    slot_ok = t0 < T
    ok = jnp.sum(start, axis=1) <= Kcap
    s = jnp.take_along_axis(profiles, jnp.clip(t0, 0, T - 1), axis=1)
    return t0, t1, s, slot_ok, ok


@functools.partial(jax.jit, static_argnames=("n_states",))
def _profile_table_sum_sparse(profiles, Vflat, n_states):
    """`_profile_table_sum` evaluated only at interval starts (see
    `_sparse_intervals`); NaN for profiles with > 32 intervals."""
    P, T = profiles.shape
    profiles = profiles.astype(jnp.int32)
    Kcap = min(_SPARSE_KCAP, T)
    t0, t1, s, slot_ok, ok = _sparse_intervals(profiles, Kcap)
    safe_s = jnp.clip(s, 0, n_states - 1)
    flat = (safe_s * T + jnp.clip(t0, 0, T - 1)) * (T + 1) + t1
    val = jnp.take(Vflat, flat)
    total = jnp.sum(jnp.where(slot_ok, val, 0.0), axis=1)
    in_range = jnp.all((profiles >= 0) & (profiles < n_states), axis=1)
    return jnp.where(in_range & ok, total, jnp.nan)


@functools.partial(jax.jit, static_argnames=("n_states", "Lb"))
def _profile_table_sum_banded_sparse(profiles, Bandflat, Headflat, Gflat,
                                     n_states, Lb):
    """`_profile_table_sum_banded` evaluated only at interval starts (see
    `_sparse_intervals`); NaN for profiles with > 32 intervals."""
    P, T = profiles.shape
    profiles = profiles.astype(jnp.int32)
    Kcap = min(_SPARSE_KCAP, T)
    t0, t1, s, slot_ok, ok = _sparse_intervals(profiles, Kcap)
    safe_s = jnp.clip(s, 0, n_states - 1)
    t0c = jnp.clip(t0, 0, T - 1)
    length = t1 - t0
    u = jnp.maximum(t0c - 1, 0)
    inb = length <= Lb
    band_idx = (safe_s * T + t0c) * (Lb + 1) + jnp.clip(length, 0, Lb)
    head_idx = safe_s * T + t0c
    ghi_idx = safe_s * T + jnp.clip(t1 - 1, 0, T - 1)
    glo_idx = safe_s * T + jnp.clip(u + Lb, 0, T - 1)
    val = jnp.where(inb, jnp.take(Bandflat, band_idx),
                    jnp.take(Headflat, head_idx)
                    + jnp.take(Gflat, ghi_idx) - jnp.take(Gflat, glo_idx))
    total = jnp.sum(jnp.where(slot_ok, val, 0.0), axis=1)
    in_range = jnp.all((profiles >= 0) & (profiles < n_states), axis=1)
    return jnp.where(in_range & ok, total, jnp.nan)


def _length_buckets(max_len):
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(b)
    return out


class GenericGaussianModel(MultiStateModel):
    """
    ``state_spec`` is an ``(nStates, d)`` nested sequence of
    ``(msd_fun, mean, ss_order)`` triples; ``ss_order`` is 0 (positionally
    stationary) or 1 (increment-stationary). See reference
    ``bild/models.py:557-564``.

    T_band : optional int (>= 8)
        Long-trajectory mode: for gap-free trajectories with ``T > T_band``,
        interval contributions are computed from a BANDED table — exact for
        intervals whose conditioning window fits in ``T_band`` frames, and
        a per-frame sliding-window conditional (memory ``T_band - 1``) for
        the tail of longer intervals. Memory/build cost drop from
        O(n T^2) / O(T^3) to O(n T T_band) / O(T T_band^2).

        The tail is a truncated-memory approximation: the conditional of a
        frame given its last ``T_band - 1`` observations instead of the
        whole window. The error depends on the MSD's memory (measured at
        ``T_band = 64``: ~2e-3 nats per tail frame for two-locus Rouse and
        power-law a=0.5; up to ~2e-2 for a long-memory power-law a=0.8
        increment process — halve it by doubling ``T_band``). The error is
        therefore CONTROLLED, not just documented: at table-build time the
        model-expected worst-case tail error (`band_tail_error`, a
        closed-form Gaussian-KL estimate from the stationary window
        covariance) is evaluated against ``band_tol`` —

        - ``T_band='auto'`` picks the smallest power-of-two band (>= 32)
          whose estimate is within ``band_tol`` for the batch's T, falling
          back to the exact tables when no band below T qualifies;
        - an explicit integer ``T_band`` emits a ``UserWarning`` (with the
          estimate, stored in ``band_error_estimate``) when it exceeds
          ``band_tol``.

        Leave ``T_band=None`` (default) when bit-parity with `logL_host`
        matters more than memory. Trajectories with missing frames always
        use the exact tables and raise if they exceed ``T_band``.

    band_tol : float (nats, default 0.1)
        tolerance for the estimated worst-case per-trajectory tail error;
        compare against your evidence differences of interest (AMIS
        evidence SEMs are typically 0.01-0.1 nats).
    """

    def __init__(self, state_spec, T_band=None, band_tol=0.1):
        self.state_spec = np.asarray(state_spec, dtype=object)
        assert len(self.state_spec.shape) == 3
        self.init_transitions(self.state_spec.shape[0])
        if isinstance(T_band, str):
            if T_band != "auto":
                raise ValueError(f"T_band must be None, an int >= 8, or "
                                 f"'auto'; got {T_band!r}")
            self.T_band = "auto"
        elif T_band is not None and int(T_band) < 8:
            raise ValueError(f"T_band must be >= 8, got {T_band}")
        else:
            self.T_band = None if T_band is None else int(T_band)
        self.band_tol = float(band_tol)
        self.band_error_estimate = None   # last explicit-band estimate
        self._auto_band_cache = {}
        # single-slot payload caches (keyed on the data array identity):
        # bounded by construction, unlike a growing memo
        self._table_cache = None
        self._full_table_cache = None

    # -- MSD constructors (reference ``bild/models.py:583-599``) -----------
    @staticmethod
    def MSD_function_powerlaw(G=1.0, a=1.0, noise2=0.0, motion_blur_f=0.0):
        @gp.MSDfun
        @gp.imaging(noise2=noise2, f=motion_blur_f, alpha0=a)
        def msd(dt, G=G, a=a):
            return G * dt**a

        return msd

    @staticmethod
    def MSD_function_twoLocusRouse(G=1.0, J=1.0, noise2=0.0, motion_blur_f=0.0):
        @gp.MSDfun
        @gp.imaging(noise2=noise2, f=motion_blur_f, alpha0=0.5)
        def msd(dt, G=G, J=J):
            return two_locus_msd(dt, G, J)

        return msd

    @property
    def d(self):
        return self.state_spec.shape[1]

    def _fingerprint_parts(self):
        # per-(state, dim) MSD sampled on integer lags (what the interval
        # tables consume) + a deep-lag plateau probe, plus the means,
        # ss_orders, and band configuration
        dts = np.arange(1, 513, dtype=float)
        parts = []
        for s in range(self.state_spec.shape[0]):
            for dim in range(self.state_spec.shape[1]):
                msd_fun, mean, sso = self.state_spec[s, dim]
                parts.append(np.asarray(msd_fun(dts), dtype=float))
                parts.append([float(mean), float(sso),
                              float(msd_fun(1e9))])
        band = (-2.0 if self.T_band == "auto"
                else -1.0 if self.T_band is None else float(self.T_band))
        parts.append([band, self.band_tol])
        return parts

    def initial_loopingprofile(self, traj):
        """Per-frame argmax of the single-frame interval scores (the
        ``[t, t+1)`` diagonal of the interval table, i.e. each frame's
        conditional log-likelihood given its predecessor). The reference
        raises NotImplementedError here (``bild/models.py:605-606``); the
        device interval table makes a sensible initial guess free."""
        from ..profiles import Loopingprofile
        return Loopingprofile(np.argmax(self._segment_table(traj), axis=0))

    def _segment_table(self, traj):
        """``(n, T)`` frame-factorized scores: the single-frame diagonal of
        the interval table. Enables DP-segmentation informed init
        (`segment_guess`) for GGM."""
        mode, arrs, Lb = self._payload_for_traj(traj)
        T = len(traj)
        n = self.nStates
        if mode == "banded":
            Band = np.asarray(arrs[0][0]).reshape(n, T, Lb + 1)
            return Band[:, :, 1]
        V = np.asarray(arrs[0][0]).reshape(n, T, T + 1)
        return V[:, np.arange(T), np.arange(T) + 1]

    def lockstep_segment_tables(self, batch):
        """``(B, n, T)`` batched frame scores (see `_segment_table`); reuses
        the cached lockstep interval tables."""
        arrs, _ = self.lockstep_fns(batch)
        mode, _, Lb = self._lockstep_table_cache[1]
        B = batch.data.shape[0]
        T = batch.data.shape[1]
        n = self.nStates
        if mode == "banded":
            Band = np.asarray(arrs[0]).reshape(B, n, T, Lb + 1)
            return Band[:, :, :, 1]
        V = np.asarray(arrs[0]).reshape(B, n, T, T + 1)
        return V[:, :, np.arange(T), np.arange(T) + 1]

    def clear_memo(self):
        self._table_cache = None
        self._full_table_cache = None
        self._lockstep_table_cache = None

    # -- device interval table ---------------------------------------------
    def interval_table(self, traj) -> jax.Array:
        """``(n, T, T+1)`` EXACT table of interval log-likelihood
        contributions; entry ``[s, t0, t1]`` covers frames ``[t0, t1)`` in
        state s with the continuity conditioning applied whenever ``t0 > 0``.
        Always exact, independent of ``T_band`` (it materializes the full
        O(n T^2) table — the thing banded mode exists to avoid)."""
        if (self._full_table_cache is not None
                and self._full_table_cache[0] is traj.data):
            return self._full_table_cache[1]
        V = self._build_interval_table(np.asarray(traj.data),
                                       np.asarray(traj.valid))
        self._full_table_cache = (traj.data, V)
        return V

    # -- payload = ("full", (Vflat,), None) | ("banded", (Band, Head, G), Lb)
    def _tables_payload_batch(self, data, valid):
        data = np.asarray(data)
        valid = np.asarray(valid)
        B, T, _ = data.shape
        W = self._resolve_band(T)
        if W is not None and T > W:
            if not valid.all():
                raise ValueError(
                    "banded GGM tables (T_band) require gap-free "
                    "trajectories; rows with missing frames need the exact "
                    "tables — construct the model with T_band=None or "
                    "bucket gapped trajectories separately")
            Band, Head, G = self._banded_tables_batch(data, W)
            Lb = W - 1
            dt = fdtype()
            return ("banded",
                    (jnp.asarray(Band.reshape(B, -1), dtype=dt),
                     jnp.asarray(Head.reshape(B, -1), dtype=dt),
                     jnp.asarray(G.reshape(B, -1), dtype=dt)),
                    Lb)
        V = self._build_interval_tables_batch(data, valid)
        return ("full", (V.reshape(B, -1),), None)

    def _payload_for_traj(self, traj):
        """Single-trajectory payload with the arrays' leading B=1 axis
        retained (so lockstep and adaptive paths share builders)."""
        if self._table_cache is not None and self._table_cache[0] is traj.data:
            return self._table_cache[1]
        payload = self._tables_payload_batch(
            np.asarray(traj.data)[None], np.asarray(traj.valid)[None])
        self._table_cache = (traj.data, payload)
        return payload

    def _build_interval_table(self, data, valid) -> jax.Array:
        return self._build_interval_tables_batch(
            np.asarray(data)[None], np.asarray(valid)[None])[0]

    def _build_interval_tables_batch(self, data, valid) -> jax.Array:
        """``(B, n, T, T+1)`` interval tables for a whole trajectory batch.

        Gap-free trajectories take the Toeplitz fast path
        (`_stationary_tables_batch`, shared Cholesky factor + one batched
        triangular solve per (state, dim)); trajectories with missing frames
        fall back to the bucketed masked path, whose per-interval Cholesky
        handles arbitrary gap patterns."""
        data = np.asarray(data)
        valid = np.asarray(valid)
        B = data.shape[0]
        full = valid.all(axis=1)
        try:
            if np.all(full):
                return self._stationary_tables_batch(data)
            if np.any(full):
                Vf = np.asarray(self._stationary_tables_batch(data[full]))
                Vg = np.asarray(self._bucketed_tables_batch(data[~full],
                                                            valid[~full]))
                V = np.zeros((B,) + Vf.shape[1:])
                V[full] = Vf
                V[~full] = Vg
                return jnp.asarray(V, dtype=fdtype())
        except np.linalg.LinAlgError:   # degenerate stationary covariance
            pass
        return self._bucketed_tables_batch(data, valid)

    def _stationary_tables_batch(self, data) -> jax.Array:
        """Fast path for gap-free trajectories (see
        `_stationary_prefix_entries` for the algebra)."""
        B, T, d = data.shape
        n = self.nStates
        dt = fdtype()
        lags = np.arange(T + 1, dtype=float)
        V = np.zeros((B, n, T, T + 1))

        t0s = np.arange(T)
        us = np.maximum(t0s - 1, 0)
        conds = t0s > 0

        for s in range(n):
            for dim in range(d):
                msd_fun, mean, sso = self.state_spec[s, dim]
                msd_tab = np.asarray(msd_fun(lags), dtype=float)
                if int(sso) == 0:
                    plateau = float(msd_fun(np.inf))
                    W = T
                    km = np.abs(np.subtract.outer(np.arange(W),
                                                  np.arange(W)))
                    Cfull = 0.5 * (plateau - msd_tab[km])
                    c00 = 0.5 * plateau
                else:
                    W = max(T - 1, 1)
                    km = np.abs(np.subtract.outer(np.arange(W),
                                                  np.arange(W)))
                    Cfull = 0.5 * (msd_tab[np.abs(km - 1)] + msd_tab[km + 1]
                                   - 2 * msd_tab[km])
                    c00 = 1.0
                Lc = np.linalg.cholesky(Cfull)
                logdet_cum = np.cumsum(2.0 * np.log(np.diag(Lc)))

                vals_dev = jnp.asarray(data[:, :, dim], dtype=dt)
                Lc_dev = jnp.asarray(Lc, dtype=dt)
                ld_dev = jnp.asarray(logdet_cum, dtype=dt)
                chunk = max(1, int((1 << 27) // max(B * W * 4, 1)))
                for lo in range(0, T, chunk):
                    hi = min(lo + chunk, T)
                    lp, lp0 = _stationary_prefix_entries(
                        vals_dev, jnp.asarray(us[lo:hi]),
                        jnp.asarray(conds[lo:hi]), Lc_dev, ld_dev,
                        jnp.asarray(float(mean), dtype=dt),
                        jnp.asarray(float(c00), dtype=dt),
                        ss_order=int(sso), W=W, T=T)
                    lp = np.asarray(lp, dtype=float)       # (B, C, W)
                    lp0 = np.asarray(lp0, dtype=float)     # (B, C)
                    for ci, t0 in enumerate(range(lo, hi)):
                        u = us[t0]
                        t1s = np.arange(t0 + 1, T + 1)
                        if int(sso) == 0:
                            kidx = t1s - u - 1
                            contrib = (lp[:, ci, kidx]
                                       - lp0[:, ci][:, None])
                        else:
                            kidx = t1s - u - 2
                            contrib = np.where(
                                kidx[None, :] >= 0,
                                lp[:, ci, np.maximum(kidx, 0)], 0.0)
                        V[:, s, t0, t1s] += contrib
        return jnp.asarray(V, dtype=dt)

    def _bucketed_tables_batch(self, data, valid) -> jax.Array:
        """Masked bucketed builder: one vmapped device dispatch per
        (length-bucket, state, dim) covers all trajectories; handles
        arbitrary missing-frame patterns."""
        B, T, d = data.shape
        n = self.nStates
        dt = fdtype()

        # MSD lag tables: the only host evaluation of the user's callables
        lags = np.arange(T + 1, dtype=float)
        msd_tabs = np.empty((n, d, T + 1))
        plateaus = np.zeros((n, d))
        for s in range(n):
            for dim in range(d):
                msd_fun, _, sso = self.state_spec[s, dim]
                msd_tabs[s, dim] = msd_fun(lags)
                if sso == 0:
                    plateaus[s, dim] = float(msd_fun(np.inf))

        # static (t0, t1) pair lists, bucketed by conditioning-window length
        buckets = {}
        for t0 in range(T):
            for t1 in range(t0 + 1, T + 1):
                wlen = t1 - (t0 - 1 if t0 > 0 else 0)
                buckets.setdefault(
                    next(b for b in _length_buckets(T + 1) if b >= wlen),
                    []).append((t0, t1))

        values = jnp.asarray(data, dtype=dt)          # (B, T, d)
        valid_j = jnp.asarray(valid)                  # (B, T)
        V = np.zeros((B, n, T, T + 1))

        for Lb, pairs in buckets.items():
            t0s = np.fromiter((p[0] for p in pairs), dtype=np.int32)
            t1s = np.fromiter((p[1] for p in pairs), dtype=np.int32)
            # chunked lax.map inside _interval_entries bounds peak memory;
            # the budget is shared by the batch axis
            chunk = int(min(2048, max(8, (1 << 24) // (Lb * Lb * B))))
            n_pad = -len(pairs) % chunk
            t0p = np.concatenate([t0s, np.zeros(n_pad, np.int32)]).reshape(-1, chunk)
            t1p = np.concatenate([t1s, np.ones(n_pad, np.int32)]).reshape(-1, chunk)
            t0j, t1j = jnp.asarray(t0p), jnp.asarray(t1p)

            for s in range(n):
                acc = np.zeros((B, t0p.size))
                for dim in range(d):
                    _, mean, sso = self.state_spec[s, dim]
                    entries_b = jax.vmap(
                        functools.partial(_interval_entries,
                                          ss_order=int(sso), Lb=Lb),
                        in_axes=(None, None, 0, 0, None, None, None))
                    ent = entries_b(
                        t0j, t1j, values[:, :, dim], valid_j,
                        jnp.asarray(msd_tabs[s, dim], dtype=dt),
                        jnp.asarray(plateaus[s, dim], dtype=dt),
                        jnp.asarray(mean, dtype=dt))
                    acc += np.asarray(ent, dtype=float).reshape(B, -1)
                V[:, s, t0s, t1s] = acc[:, : len(pairs)]

        return jnp.asarray(V, dtype=dt)

    def _window_cov(self, s, dim, W):
        """Stationary covariance of one banded window for ``(state, dim)``:
        ``(Cfull (Wd, Wd), c00, sso, Wd)`` where ``Wd`` is the number of
        window ENTRIES (``W`` frames for ss_order 0, ``W - 1`` increments
        for ss_order 1) and ``c00`` the unconditional first-entry
        variance."""
        msd_fun, _, sso = self.state_spec[s, dim]
        lags = np.arange(W + 2, dtype=float)
        msd_tab = np.asarray(msd_fun(lags), dtype=float)
        if int(sso) == 0:
            plateau = float(msd_fun(np.inf))
            Wd = W
            km = np.abs(np.subtract.outer(np.arange(Wd), np.arange(Wd)))
            Cfull = 0.5 * (plateau - msd_tab[km])
            c00 = 0.5 * plateau
        else:
            Wd = W - 1
            km = np.abs(np.subtract.outer(np.arange(Wd), np.arange(Wd)))
            Cfull = 0.5 * (msd_tab[np.abs(km - 1)] + msd_tab[km + 1]
                           - 2 * msd_tab[km])
            c00 = 1.0
        return Cfull, c00, int(sso), Wd

    def band_tail_error(self, T, T_band=None):
        """
        Predicted worst-case tail error (nats) of the banded tables for one
        gap-free length-``T`` trajectory: the truncated-memory sliding
        conditional (``T_band - 1`` frames of memory) vs the exact
        full-window conditional.

        The prediction is **bias + fluctuation**:

        - Bias (expected deficit): per (state, dim), let ``v_m`` be the
          conditional variance of a window entry given ``m`` in-window
          predecessors (squared Cholesky diagonal of the stationary window
          covariance, window extended to ``min(T, max(4 T_band, 256))``
          entries). The expected per-frame log-likelihood deficit of
          conditioning on ``m_tr`` instead of ``m > m_tr`` predecessors is
          the Gaussian KL ``0.5 log(v_{m_tr} / v_m)`` (the mean-mismatch
          term contributes exactly ``(v_{m_tr} - v_m)/2 v_{m_tr}`` in
          expectation, cancelling the variance-ratio term). Summed over
          the tail offsets of one interval spanning all T frames (worst
          case), maxed over states, summed over dims -> ``KL``.
        - Fluctuation: each per-frame deficit has variance ~``2 KL_j``
          and neighboring frames share most of their window, so the
          realized deficit of one trajectory fluctuates around the bias
          with worst-case (fully correlated) scale
          ``sqrt(2 KL n_tail)``, ``n_tail = T - T_band``; a 1.5x safety
          factor rides on it. Measured across specs/bands (two-locus
          Rouse, power-law a in {0.5, 0.8, 1.0}, W in 16..128) the bound
          covers every realized |error| (tests/test_ggm_device.py).

        Offsets beyond the extended window reuse its deepest ``v`` — a
        slight underestimate for extremely long-memory MSDs.
        """
        W = self.T_band if T_band is None else T_band
        if not isinstance(W, (int, np.integer)):
            raise ValueError("band_tail_error needs a concrete T_band")
        if T <= W:
            return 0.0
        total = 0.0
        for dim in range(self.d):
            worst = 0.0
            for s in range(self.nStates):
                We = int(min(T, max(4 * W, 256)))
                C, _, sso, Wd_e = self._window_cov(s, dim, We)
                v = np.diag(np.linalg.cholesky(C)) ** 2
                Wd = W if sso == 0 else W - 1
                v_tr = v[Wd - 1]
                offs = np.arange(W, T)               # tail frame offsets
                m_ex = np.minimum(offs if sso == 0 else offs - 1, Wd_e - 1)
                with np.errstate(divide="ignore"):
                    err = float(np.sum(0.5 * np.log(v_tr / v[m_ex])))
                worst = max(worst, err)
            total += worst
        return total + 1.5 * float(np.sqrt(2.0 * total * (T - W)))

    def _resolve_band(self, T):
        """Concrete band width for a length-``T`` batch, or ``None`` for
        the exact tables. ``T_band='auto'``: the smallest power-of-two
        band >= 32 whose `band_tail_error` estimate is within ``band_tol``
        (resolved per T, cached); if no band strictly below T qualifies,
        the exact tables are used. Explicit integer bands get the same
        estimate and ``warnings.warn`` when they exceed ``band_tol``."""
        if self.T_band is None:
            return None
        if isinstance(self.T_band, str):            # 'auto'
            cached = self._auto_band_cache.get(T)
            if cached is not None or T in self._auto_band_cache:
                return cached
            W = 32
            choice = None
            while W < T:
                if self.band_tail_error(T, W) <= self.band_tol:
                    choice = W
                    break
                W *= 2
            self._auto_band_cache[T] = choice
            return choice
        if T > self.T_band:
            est = self.band_error_estimate = self.band_tail_error(T)
            if est > self.band_tol:
                import warnings
                warnings.warn(
                    f"banded GGM tables: estimated worst-case tail error "
                    f"{est:.3g} nats at T={T}, T_band={self.T_band} exceeds "
                    f"band_tol={self.band_tol}; increase T_band (or use "
                    f"T_band='auto') or validate against logL_host")
        return self.T_band

    def _banded_tables_batch(self, data, W):
        """
        Banded interval tables for gap-free trajectories:
        ``(Band (B, n, T, Lb+1), Head (B, n, T), G (B, n, T))`` with
        ``Lb = W - 1`` (see `_profile_table_sum_banded` for the
        decomposition). Two prefix-solves per (state, dim) — one with the
        reference's per-``t0`` conditioning (Band + Head), one with sliding
        fully-centered windows (the per-frame tail conditionals g) — each
        O(T * T_band^2) instead of the exact path's O(T^3).
        """
        B, T, d = data.shape
        n = self.nStates
        dt = fdtype()
        Lb = W - 1

        Band = np.zeros((B, n, T, Lb + 1))
        Head = np.zeros((B, n, T))
        g = np.zeros((B, n, T))

        t0s = np.arange(T)
        usA = np.maximum(t0s - 1, 0)
        condsA = t0s > 0
        usB = np.maximum(t0s - Lb, 0)          # sliding window [t-Lb, t]
        condsB = np.zeros(T, dtype=bool)

        for s in range(n):
            for dim in range(d):
                mean = self.state_spec[s, dim][1]
                Cfull, c00, sso, Wd = self._window_cov(s, dim, W)
                Lc = np.linalg.cholesky(Cfull)
                logdet_cum = np.cumsum(2.0 * np.log(np.diag(Lc)))

                vals_dev = jnp.asarray(data[:, :, dim], dtype=dt)
                Lc_dev = jnp.asarray(Lc, dtype=dt)
                ld_dev = jnp.asarray(logdet_cum, dtype=dt)
                mean_dev = jnp.asarray(float(mean), dtype=dt)
                c00_dev = jnp.asarray(float(c00), dtype=dt)

                chunk = max(1, int((1 << 27) // max(B * Wd * 4, 1)))
                lpA = np.empty((B, T, Wd))
                lp0A = np.empty((B, T))
                lpB = np.empty((B, T, Wd))
                for lo in range(0, T, chunk):
                    hi = min(lo + chunk, T)
                    a_lp, a_lp0 = _stationary_prefix_entries(
                        vals_dev, jnp.asarray(usA[lo:hi]),
                        jnp.asarray(condsA[lo:hi]), Lc_dev, ld_dev,
                        mean_dev, c00_dev, ss_order=int(sso), W=Wd, T=T)
                    b_lp, _ = _stationary_prefix_entries(
                        vals_dev, jnp.asarray(usB[lo:hi]),
                        jnp.asarray(condsB[lo:hi]), Lc_dev, ld_dev,
                        mean_dev, c00_dev, ss_order=int(sso), W=Wd, T=T)
                    lpA[:, lo:hi] = np.asarray(a_lp, dtype=float)
                    lp0A[:, lo:hi] = np.asarray(a_lp0, dtype=float)
                    lpB[:, lo:hi] = np.asarray(b_lp, dtype=float)

                # Band[t0, l] for l = 1..Lb: entry index into the t0 window
                ls = np.arange(1, Lb + 1)
                if int(sso) == 0:
                    # frames: kidx = (t0 + l) - u - 1
                    kidx = (t0s[:, None] + ls[None, :] - usA[:, None] - 1)
                    ok = (t0s[:, None] + ls[None, :]) <= T    # t1 in range
                    kidx = np.clip(kidx, 0, Wd - 1)
                    contrib = (np.take_along_axis(
                        lpA, kidx[None].repeat(B, 0), axis=2)
                        - lp0A[:, :, None])
                    Band[:, s, :, 1:] += np.where(ok[None], contrib, 0.0)
                    Head[:, s] += lpA[:, :, Wd - 1] - lp0A
                    g[:, s, Lb:] += (lpB[:, Lb:, Wd - 1]
                                     - lpB[:, Lb:, Wd - 2])
                else:
                    # increments: kidx = (t0 + l) - u - 2; < 0 -> no term
                    kidx = (t0s[:, None] + ls[None, :] - usA[:, None] - 2)
                    ok = ((t0s[:, None] + ls[None, :]) <= T) & (kidx >= 0)
                    kidx = np.clip(kidx, 0, Wd - 1)
                    contrib = np.take_along_axis(
                        lpA, kidx[None].repeat(B, 0), axis=2)
                    Band[:, s, :, 1:] += np.where(ok[None], contrib, 0.0)
                    Head[:, s] += lpA[:, :, Wd - 1]
                    g[:, s, Lb:] += (lpB[:, Lb:, Wd - 1]
                                     - lpB[:, Lb:, Wd - 2])

        G = np.cumsum(g, axis=2)
        return Band, Head, G

    # -- likelihood ---------------------------------------------------------
    def logL(self, profile, traj) -> float:
        return float(self.logL_batch(np.asarray(profile)[None, :], traj)[0])

    def logL_batch(self, profiles, traj) -> jax.Array:
        mode, arrs, Lb = self._payload_for_traj(traj)
        profiles = jnp.asarray(profiles, dtype=jnp.int32)
        if mode == "banded":
            return _profile_table_sum_banded(
                profiles, arrs[0][0], arrs[1][0], arrs[2][0],
                self.nStates, Lb)
        return _profile_table_sum(profiles, arrs[0][0], self.nStates)

    def logL_host(self, profile, traj) -> float:
        """Float64 host oracle: the straight blockwise algorithm of reference
        ``bild/models.py:608-661`` (parity target for the device table)."""
        profile = Loopingprofile(np.asarray(profile))
        ivs = profile.intervals()
        ivs[0] = (0, ivs[0][1], ivs[0][2])
        ivs[-1] = (ivs[-1][0], len(profile), ivs[-1][2])

        trajdata = traj[:]  # NaN-sentinel (T, d) view
        logL = 0.0
        for i, (t0, t1, n) in enumerate(ivs):
            t_start = t0 if i == 0 else t0 - 1
            for dim in range(self.d):
                trace = trajdata[t_start:t1][:, dim]
                ti = np.nonzero(~np.isnan(trace))[0]
                trace = trace[ti]
                if len(trace) == 0:
                    # no observations in the window -> no contribution (the
                    # reference would crash here; the device table returns 0)
                    continue

                msd_fun, m, ss_order = self.state_spec[n, dim]
                C = gp.msd2C(msd_fun, ti, ss_order)

                if ss_order == 0:
                    x = trace - m
                    if i > 0:
                        mu = trace[0] * C[1:, 0] / C[0, 0]
                        x = x[1:] - mu
                        C = C - C[:, [0]] * C[[0], :] / C[0, 0]
                        C = C[1:, 1:]
                elif ss_order == 1:
                    x = np.diff(trace) - m
                else:  # pragma: no cover
                    raise ValueError(f"ss_order should be 0 or 1; got {ss_order}")

                _, logdet = np.linalg.slogdet(C)
                xCx = x @ np.linalg.solve(C, x)
                logL += -0.5 * (xCx + logdet + len(C) * LOG_2PI)
        return float(logL)

    # -- lockstep hooks -------------------------------------------------------
    def lockstep_fns(self, batch):
        """
        Lockstep-mode hooks (see ``MultiStateRouse.lockstep_fns``): the
        per-trajectory data is the flattened interval table (full or banded
        per ``T_band``); the traceable likelihood is the matching
        gather-sum.
        """
        cache = getattr(self, "_lockstep_table_cache", None)
        if cache is not None and cache[0] is batch.data:
            payload = cache[1]
        else:
            payload = self._tables_payload_batch(
                np.asarray(batch.data), np.asarray(batch.valid))
            self._lockstep_table_cache = (batch.data, payload)
        mode, arrs, Lb = payload

        if not hasattr(self, "_lockstep_logL_fns"):
            self._lockstep_logL_fns = {}
        fn_key = (mode, Lb)
        if fn_key not in self._lockstep_logL_fns:
            n = self.nStates
            # sparse interval-start evaluation: lockstep profiles come from
            # (k+1)-slot AMIS parameters, so the dense all-T gather-sum
            # wastes ~140x the gather lanes — measured 87 ms -> ~4 ms per
            # fused step at config-7 shapes (DESIGN.md section 7p).
            # Profiles with > 32 intervals yield NaN (invalid-profile
            # contract; AMIS masks NaN to zero weight).
            if mode == "banded":
                def logL_fn(profiles, per_traj, Lb=Lb):
                    Bandflat, Headflat, Gflat = per_traj
                    return _profile_table_sum_banded_sparse(
                        profiles, Bandflat, Headflat, Gflat, n, Lb)
            else:
                def logL_fn(profiles, per_traj):
                    (Vflat,) = per_traj
                    return _profile_table_sum_sparse(profiles, Vflat, n)
            self._lockstep_logL_fns[fn_key] = logL_fn

        return arrs, self._lockstep_logL_fns[fn_key]

    # -- generative model (reference ``bild/models.py:663-728``) -----------
    def trajectory_from_loopingprofile(self, profile, missing_frames=None,
                                       rng: Optional[np.random.Generator] = None) -> Trajectory:
        rng = np.random.default_rng() if rng is None else rng
        profile = Loopingprofile(np.asarray(profile))
        missing_frames = self._preproc_missing_frames(missing_frames, len(profile))

        ivs = profile.intervals()
        ivs[-1] = (ivs[-1][0], len(profile), ivs[-1][2])

        snippets = []
        for i, (t0, t1, n) in enumerate(ivs):
            t_start = 0 if i == 0 else t0 - 1
            snippets.append([])
            for dim in range(self.d):
                ti = np.arange(t_start, t1)
                msd_fun, m, ss_order = self.state_spec[n, dim]
                continuing = ss_order == 0 and i > 0

                C = gp.msd2C(msd_fun, ti, ss_order)
                if continuing:
                    mu = (snippets[i - 1][dim][-1] - m) * C[1:, 0] / C[0, 0]
                    C = C - C[:, [0]] * C[[0], :] / C[0, 0]
                    C = C[1:, 1:]

                L = sp_linalg.cholesky(C, lower=True)
                x = L @ rng.standard_normal(len(L)) + m
                if continuing:
                    x += mu

                if ss_order == 0:
                    snippets[i].append(x)
                else:  # increments -> integrate, anchored at previous end (or 0)
                    x0 = 0.0 if i == 0 else snippets[i - 1][dim][-1]
                    cum = x0 + np.cumsum(x)
                    snippets[i].append(np.insert(cum, 0, 0) if i == 0 else cum)

        data = np.concatenate([np.array(snip).T for snip in snippets])
        data[missing_frames] = np.nan
        return Trajectory.create(data, loopingprofile=profile.state)
