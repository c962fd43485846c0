"""
Batched multi-state Kalman likelihood as an XLA scan: the float64/CPU path,
the gradient path and the plain reference for the CUDA kernel.

Batched inversion of the reference design (``bild/src/MSRouse_logL.pyx``):
the reference evaluates ONE profile at a time with BLAS-2 (``dsymv``) calls
and explicitly rejects parallelism (``bild/amis.py:732-733``); here the unit
of work is a **batch of P profiles** marched together through a single
``lax.scan`` over frames.

Key trick ("shared-weight propagation"): per scan step, instead of gathering
a per-profile propagator ``B[state_p]`` (a batch of tiny matmuls),
we propagate the whole batch through EVERY state's dynamics —

    M_s = B_s @ M        -> one (N, N) x (N, P*d)   GEMM per state
    C_s = B_s @ C @ B_s  -> two (N, N) x (N, P*q*N) GEMMs per state

— and select per profile with ``where``. For the typical 2-3 state models this
costs n_states x the FLOPs but runs as large dense products on shapes that
grow with the batch instead of per-sample gathers.

The d*-deduplication of covariance propagation across spatial dimensions with
equal localization error is kept (reference ``MSRouse_logL_py.py:70-77``):
``C`` carries ``q = d*`` covariance copies, not ``d``.

Missing frames are a boolean mask (scan-friendly), not NaN sentinels.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MATMUL_PRECISION

LOG_2PI = float(np.log(2.0 * np.pi))

__all__ = ["msrouse_logL_batch", "msrouse_logL_single", "kalman_update_batch"]


def kalman_update_batch(M, C, y, w, s2, Cind):
    """
    Batched Kalman measurement update (algorithm of reference
    ``bild/src/MSRouse_logL.pyx:19-90``).

    Parameters
    ----------
    M : (P, N, d)   prior means
    C : (P, q, N, N) prior covariances (q = d* deduplicated dims)
    y : (d,)        observation
    w : (N,)        measurement vector
    s2 : (q,)       unique squared localization errors
    Cind : (d,)     map d -> d*

    Returns
    -------
    M', C', logl : posterior mean, covariance, and (P,) observation log-likelihood
    """
    Cw = jnp.einsum("pqij,j->pqi", C, w, precision=MATMUL_PRECISION)   # (P, q, N)
    S = jnp.einsum("pqi,i->pq", Cw, w, precision=MATMUL_PRECISION) + s2  # (P, q)
    K = Cw / S[..., None]                                              # (P, q, N)
    C_new = C - K[..., :, None] * Cw[..., None, :]                     # (P, q, N, N)

    m = jnp.einsum("pid,i->pd", M, w, precision=MATMUL_PRECISION)      # (P, d)
    xmm = y[None, :] - m                                               # (P, d)
    Kd = jnp.take(K, Cind, axis=1)                                     # (P, d, N)
    M_new = M + jnp.swapaxes(Kd, 1, 2) * xmm[:, None, :]               # (P, N, d)

    Sd = jnp.take(S, Cind, axis=1)                                     # (P, d)
    logl = -0.5 * (xmm * xmm / Sd + jnp.log(Sd) + LOG_2PI)             # (P, d)
    return M_new, C_new, jnp.sum(logl, axis=1)


def _propagate_all_states(M, C, st, Bs, Gs, Sigs):
    """Shared-weight propagation through every state, then per-profile select."""
    n = Bs.shape[0]
    sel = [st == s for s in range(n)]

    M_cands = []
    C_cands = []
    for s in range(n):
        B = Bs[s]
        M_cands.append(
            jnp.einsum("ij,pjd->pid", B, M, precision=MATMUL_PRECISION) + Gs[s][None]
        )
        X = jnp.einsum("ij,pqjk->pqik", B, C, precision=MATMUL_PRECISION)
        C_cands.append(
            jnp.einsum("pqik,kj->pqij", X, B, precision=MATMUL_PRECISION)
            + Sigs[s][None, None]
        )

    M_new = jnp.select([c[:, None, None] for c in sel], M_cands)
    C_new = jnp.select([c[:, None, None, None] for c in sel], C_cands)
    return M_new, C_new


@partial(jax.jit, static_argnames=("symmetrize",))
def msrouse_logL_batch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                       profiles, ydata, valid, symmetrize=True):
    """
    Log-likelihood of a batch of profiles for one trajectory.

    Parameters
    ----------
    Bs, Sigs : (n, N, N)   per-state propagator / one-step noise covariance
    Gs : (n, N, d)          per-state drift
    M0s : (n, N, d), C0s : (n, N, N)
        per-state steady states; the initial condition is selected by
        ``profiles[:, 0]`` (reference semantics ``bild/util.py:10-24``)
    w : (N,)                measurement vector
    s2 : (q,)               unique squared localization errors
    Cind : (d,) int         map d -> d*
    profiles : (P, T) int   state sequences
    ydata : (T, d)          trajectory data (zeros at missing frames)
    valid : (T,) bool       frame-observed mask
    symmetrize : bool
        re-symmetrize covariances each step (guards f32 drift; fp-level no-op
        in f64)

    Returns
    -------
    (P,) log-likelihoods
    """
    P, T = profiles.shape
    q = s2.shape[0]

    st0 = profiles[:, 0]
    M = jnp.take(M0s, st0, axis=0)                                    # (P, N, d)
    C = jnp.broadcast_to(jnp.take(C0s, st0, axis=0)[:, None],
                         (P, q) + C0s.shape[1:])                      # (P, q, N, N)
    acc = jnp.zeros((P,), dtype=ydata.dtype)

    M_u, C_u, ll = kalman_update_batch(M, C, ydata[0], w, s2, Cind)
    M = jnp.where(valid[0], M_u, M)
    C = jnp.where(valid[0], C_u, C)
    acc = acc + jnp.where(valid[0], ll, 0.0)

    def step(carry, x):
        M, C, acc = carry
        st, y, v = x
        M, C = _propagate_all_states(M, C, st, Bs, Gs, Sigs)
        if symmetrize:
            C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
        M_u, C_u, ll = kalman_update_batch(M, C, y, w, s2, Cind)
        M = jnp.where(v, M_u, M)
        C = jnp.where(v, C_u, C)
        acc = acc + jnp.where(v, ll, 0.0)
        return (M, C, acc), None

    xs = (profiles[:, 1:].T, ydata[1:], valid[1:])
    (M, C, acc), _ = jax.lax.scan(step, (M, C, acc), xs)

    # out-of-range states would otherwise select zeroed dynamics mid-scan and
    # return a finite-but-wrong value; surface them as NaN instead
    n = Bs.shape[0]
    in_range = jnp.all((profiles >= 0) & (profiles < n), axis=1)
    return jnp.where(in_range, acc, jnp.nan)


def msrouse_logL_single(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profile, ydata, valid):
    """Single-profile convenience wrapper around the batched kernel."""
    return msrouse_logL_batch(
        Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
        jnp.asarray(profile)[None, :], ydata, valid,
    )[0]
