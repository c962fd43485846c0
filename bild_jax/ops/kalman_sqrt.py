"""
Square-root (Cholesky-factor) form of the Rouse-Kalman likelihood.

Purpose: settle the BASELINE.md 1e-6 parity north star (SURVEY.md section 7
"hard parts": Joseph-form/square-root filtering as the mitigation for f32
covariance degradation, re reference ``bild/src/MSRouse_logL.pyx:218-247``).
The standard filter propagates the covariance ``C`` and applies a rank-1
downdate per observation — the numerically hazardous operations that could,
in principle, dominate the f32 error. This kernel instead carries the lower
Cholesky factor ``L`` (``C = L L^T``), which is stable by construction:

- propagation ``C' = B C B^T + Sig`` becomes an LQ re-triangularization of
  the pre-array ``[B L | chol(Sig)]`` (N x 2N),
- the measurement update becomes an LQ of the (N+1) x (N+1) pre-array

      [ sqrt(s2)  w^T L ]          [ sqrt(S)        0  ]
      [    0        L   ]   ->     [ Cw/sqrt(S)     L' ]

  which yields the innovation variance ``S``, the gain numerator ``Cw``,
  and the DOWNDATED factor ``L'`` in one orthogonal transform — no
  subtraction of nearly-equal matrices anywhere.

This costs a QR per frame per profile (vs one GEMM), so it is a
VALIDATION-tier kernel, not a production path; it exists to measure where
the f32 parity floor really is (measurement + verdict: DESIGN.md
section 7h).

Interface mirrors `kalman.msrouse_logL_batch`; semantics identical
(reference algorithm ``bild/src/MSRouse_logL.pyx:95-256``).
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

LOG_2PI = float(np.log(2.0 * np.pi))

__all__ = ["msrouse_logL_sqrt"]

# host-side f64 Cholesky factors of the per-state noise/steady-state
# covariances, keyed by array content (mirrors kalman_sym's operator cache)
_SQRT_OPS_CACHE = {}
_SQRT_OPS_CACHE_MAX = 16


def _psd_factor(C):
    """Symmetric factor ``L`` with ``L L^T = C`` for PSD input. eigh-based
    rather than Cholesky: the Rouse steady state pins free modes (center of
    mass / disconnected fragments) to ZERO variance (`physics.rouse`), so
    the matrices are PSD, not PD. The LQ re-triangularizations downstream
    accept any factor, not just triangular ones."""
    lam, U = np.linalg.eigh(np.asarray(C, dtype=np.float64))
    return (U * np.sqrt(np.clip(lam, 0.0, None))[..., None, :])


def _sqrt_operators(Sigs, C0s, dtype):
    key = (np.asarray(Sigs).tobytes(), np.asarray(C0s).tobytes())
    hit = _SQRT_OPS_CACHE.pop(key, None)
    if hit is None:
        while len(_SQRT_OPS_CACHE) >= _SQRT_OPS_CACHE_MAX:
            _SQRT_OPS_CACHE.pop(next(iter(_SQRT_OPS_CACHE)))
        hit = (_psd_factor(Sigs), _psd_factor(C0s))
    _SQRT_OPS_CACHE[key] = hit
    LSigs, L0s = hit
    return jnp.asarray(LSigs, dtype=dtype), jnp.asarray(L0s, dtype=dtype)


def _lq(A):
    """Lower-triangular L with ``L L^T = A A^T`` (LQ via QR of the
    transpose). The diagonal sign is irrelevant: only ``L L^T`` enters."""
    R = jnp.linalg.qr(A.T, mode="r")
    return R.T


def msrouse_logL_sqrt(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                      profiles, ydata, valid):
    """
    (P,) log-likelihoods of a ``(P, T)`` profile batch — square-root-form
    drop-in for `kalman.msrouse_logL_batch` (same arguments/semantics,
    including the d*-deduplication via ``s2``/``Cind`` and NaN for
    out-of-range states). Requires CONCRETE model arrays: the Cholesky
    factors are precomputed host-side in f64 (as in `kalman_sym`).
    """
    fdt = jnp.asarray(ydata).dtype
    LSigs, L0s = _sqrt_operators(Sigs, C0s, fdt)
    return _sqrt_impl(Bs, Gs, LSigs, M0s, L0s, w, s2, Cind,
                      profiles, ydata, valid)


@jax.jit
def _sqrt_impl(Bs, Gs, LSigs, M0s, L0s, w, s2, Cind,
               profiles, ydata, valid):
    # full-precision passes for every dot issued below — INCLUDING the
    # matmuls inside jnp.linalg.qr. Without this an accelerator may lower
    # f32 dots to a reduced-precision pass (TF32 on a GPU), and a
    # stability-tier kernel with reduced-precision QR would be
    # self-defeating.
    with jax.default_matmul_precision("highest"):
        return _sqrt_body(Bs, Gs, LSigs, M0s, L0s, w, s2, Cind,
                          profiles, ydata, valid)


def _sqrt_body(Bs, Gs, LSigs, M0s, L0s, w, s2, Cind,
               profiles, ydata, valid):
    fdt = jnp.asarray(ydata).dtype
    Bs = jnp.asarray(Bs, dtype=fdt)
    Gs = jnp.asarray(Gs, dtype=fdt)
    M0s = jnp.asarray(M0s, dtype=fdt)
    w = jnp.asarray(w, dtype=fdt)
    s2 = jnp.asarray(s2, dtype=fdt)
    Cind = jnp.asarray(Cind)
    profiles = jnp.asarray(profiles, dtype=jnp.int32)

    n, N = Bs.shape[:2]
    d = Gs.shape[2]
    q = s2.shape[0]
    sroot = jnp.sqrt(s2)

    def update(M, Ls, y):
        """Measurement update: per-q LQ of the augmented pre-array."""
        def upd_q(L, sr):
            pre = jnp.zeros((N + 1, N + 1), fdt)
            pre = pre.at[0, 0].set(sr)
            pre = pre.at[0, 1:].set(w @ L)
            pre = pre.at[1:, 1:].set(L)
            post = _lq(pre)
            S = post[0, 0] * post[0, 0]
            # post[1:,0] = Cw/sqrt(S) up to the common sign of column 0,
            # so K = Cw/S = post[1:,0]/post[0,0] is sign-invariant
            K = post[1:, 0] / post[0, 0]
            return post[1:, 1:], S, K

        Ls_new, S, K = jax.vmap(upd_q)(Ls, sroot)     # (q,N,N), (q,), (q,N)
        m = M.T @ w                                    # (d,)
        xmm = y - m
        Kd = K[Cind]                                   # (d, N)
        Sd = S[Cind]                                   # (d,)
        M_new = M + Kd.T * xmm[None, :]
        ll = -0.5 * jnp.sum(xmm * xmm / Sd + jnp.log(Sd) + LOG_2PI)
        return M_new, Ls_new, ll

    def run_one(prof):
        st0 = prof[0]
        M = M0s[st0]                                   # (N, d)
        Ls = jnp.broadcast_to(L0s[st0][None], (q, N, N))
        acc = jnp.zeros((), fdt)

        M_u, Ls_u, ll = update(M, Ls, ydata[0])
        M = jnp.where(valid[0], M_u, M)
        Ls = jnp.where(valid[0], Ls_u, Ls)
        acc = acc + jnp.where(valid[0], ll, 0.0)

        def step(carry, x):
            M, Ls, acc = carry
            st, y, v = x
            B = Bs[st]
            M = B @ M + Gs[st]
            pre = jnp.concatenate(
                [jnp.einsum("ij,qjk->qik", B, Ls),
                 jnp.broadcast_to(LSigs[st][None], (q, N, N))], axis=2)
            Ls = jax.vmap(_lq)(pre)                    # (q, N, N)
            M_u, Ls_u, ll = update(M, Ls, y)
            M = jnp.where(v, M_u, M)
            Ls = jnp.where(v, Ls_u, Ls)
            acc = acc + jnp.where(v, ll, 0.0)
            return (M, Ls, acc), None

        xs = (prof[1:], ydata[1:], valid[1:])
        (M, Ls, acc), _ = jax.lax.scan(step, (M, Ls, acc), xs)
        return acc

    out = jax.vmap(run_one)(profiles)
    in_range = jnp.all((profiles >= 0) & (profiles < n), axis=1)
    return jnp.where(in_range, out, jnp.nan)
