"""
Temporal-parallel (associative-scan) Kalman likelihood for long trajectories.

The sequential kernels (`kalman.py`, `kalman_cuda.py`) parallelize over the
profile batch but walk frames serially — optimal when P is large. For the
opposite regime (few profiles, very long T: single-trajectory inference at
T ~ 1e4-1e6 frames) this module evaluates the SAME likelihood with
``jax.lax.associative_scan`` over time, the linear-Gaussian filtering
formulation of Särkkä & García-Fernández, "Temporal Parallelization of
Bayesian Smoothers" (IEEE TAC 2021): each frame contributes a conditional-
Gaussian element ``(A, b, C, J, eta)`` and the filter is their associative
composition, giving O(log T) depth on parallel hardware. This is the genuine
"sequence parallelism" axis of this workload (SURVEY.md section 5:
long-context) — there is no attention to ring-shard.

Spatial dimensions are independent single-output SSMs sharing the state
dynamics (selected per frame by the profile); we vmap the filter over dims.

Semantics match ``msrouse_logL_batch`` exactly: ``profile[0]`` selects the
initial steady-state ensemble, observed frames Kalman-update, missing frames
propagate only.

EXPERIMENTAL (demoted round 5). The kernel is correct — parity-tested vs
the sequential filter through T=8192 on an 8-device mesh
(``tests/test_assoc_kalman.py``) — but it has never won anywhere it can
be measured:

- Crossover grid (``tools/assoc_crossover.py``, 8-device virtual CPU
  mesh): the sequential kernel wins at EVERY cell of
  T in {1024..16384} x P in {1, 8, 64}. The associative formulation does
  ~7-15x the sequential scan's work at P=1 and 25-100x at P>=8.
- AMIS always has a profile batch (P >= 100) to fill a device with, and
  the composition's batched tiny (N x N) LU solves parallelize poorly.
- On the first accelerator it was built for, its best case (P=1,
  T=16384) failed to compile; on the H100 it has not been measured.

The remaining hypothetical win (n_dev >= ~10 devices with TIME sharded
and P ~= 1) is extrapolated from structure ratios, not
demonstrated — hence experimental status: nothing dispatches here by
default; `MultiStateRouse.logL_batch_assoc` remains the explicit opt-in.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import MATMUL_PRECISION

LOG_2PI = float(np.log(2.0 * np.pi))

__all__ = ["msrouse_logL_assoc"]


def _compose(e1, e2):
    """Associative composition of filtering elements (Lemma 8 of the paper).

    ``e1`` is the earlier block, ``e2`` the later; leaves carry leading batch
    dims (the scan axis plus any vmap axes).
    """
    A1, b1, C1, J1, h1 = e1
    A2, b2, C2, J2, h2 = e2
    N = A1.shape[-1]
    I = jnp.eye(N, dtype=A1.dtype)

    D = I + jnp.matmul(C1, J2, precision=MATMUL_PRECISION)       # (.., N, N)
    Dinv_A1 = jnp.linalg.solve(D, A1)
    Dinv_bh = jnp.linalg.solve(
        D, (b1 + jnp.einsum("...ij,...j->...i", C1, h2,
                            precision=MATMUL_PRECISION))[..., None])[..., 0]
    Dinv_C1 = jnp.linalg.solve(D, C1)

    A = jnp.matmul(A2, Dinv_A1, precision=MATMUL_PRECISION)
    b = jnp.einsum("...ij,...j->...i", A2, Dinv_bh,
                   precision=MATMUL_PRECISION) + b2
    C = jnp.matmul(jnp.matmul(A2, Dinv_C1, precision=MATMUL_PRECISION),
                   jnp.swapaxes(A2, -1, -2), precision=MATMUL_PRECISION) + C2

    E = jnp.swapaxes(D, -1, -2)                                   # I + J2 C1
    Einv_hb = jnp.linalg.solve(
        E, (h2 - jnp.einsum("...ij,...j->...i", J2, b1,
                            precision=MATMUL_PRECISION))[..., None])[..., 0]
    Einv_J2 = jnp.linalg.solve(E, J2)

    A1T = jnp.swapaxes(A1, -1, -2)
    h = jnp.einsum("...ij,...j->...i", A1T, Einv_hb,
                   precision=MATMUL_PRECISION) + h1
    J = jnp.matmul(jnp.matmul(A1T, Einv_J2, precision=MATMUL_PRECISION),
                   A1, precision=MATMUL_PRECISION) + J1
    return A, b, C, J, h


def _filter_one_dim(Fs, Qs, m0, C0, w, s2d, y, valid):
    """
    Parallel filter + predictive log-likelihood for one spatial dimension.

    Fs, Qs : (T, N, N) per-frame dynamics (already profile-gathered; frame 0
             entries are unused)
    m0, C0 : steady-state init (N,), (N, N)
    w : (N,) measurement vector; s2d : scalar noise variance
    y : (T,) observations; valid : (T,) bool
    """
    T, N, _ = Fs.shape
    dtype = y.dtype
    I = jnp.eye(N, dtype=dtype)

    # -- elements for t >= 1 (vectorized over T-1) -------------------------
    F = Fs[1:]
    Q = Qs[1:]
    yv = y[1:]
    vv = valid[1:]

    Qw = jnp.einsum("tij,j->ti", Q, w, precision=MATMUL_PRECISION)    # (T-1, N)
    S = jnp.einsum("ti,i->t", Qw, w, precision=MATMUL_PRECISION) + s2d
    K = Qw / S[:, None]                                               # (T-1, N)
    ImKH = I[None] - K[:, :, None] * w[None, None, :]                 # (T-1, N, N)
    Fw = jnp.einsum("tji,j->ti", F, w, precision=MATMUL_PRECISION)    # F^T w

    A_obs = jnp.matmul(ImKH, F, precision=MATMUL_PRECISION)
    b_obs = K * yv[:, None]
    C_obs = jnp.matmul(ImKH, Q, precision=MATMUL_PRECISION)
    h_obs = Fw * (yv / S)[:, None]
    J_obs = Fw[:, :, None] * Fw[:, None, :] / S[:, None, None]

    v3 = vv[:, None, None]
    v2 = vv[:, None]
    A = jnp.where(v3, A_obs, F)
    b = jnp.where(v2, b_obs, 0.0)
    C = jnp.where(v3, C_obs, Q)
    h = jnp.where(v2, h_obs, 0.0)
    J = jnp.where(v3, J_obs, 0.0)

    # -- element for t = 0 (steady state, optionally updated) --------------
    S0 = w @ C0 @ w + s2d
    K0 = (C0 @ w) / S0
    ll0 = jnp.where(valid[0],
                    -0.5 * ((y[0] - w @ m0) ** 2 / S0 + jnp.log(S0) + LOG_2PI),
                    0.0)
    b0 = jnp.where(valid[0], m0 + K0 * (y[0] - w @ m0), m0)
    C0u = jnp.where(valid[0], (I - K0[:, None] * w[None, :]) @ C0, C0)

    elems = (
        jnp.concatenate([jnp.zeros((1, N, N), dtype), A]),
        jnp.concatenate([b0[None], b]),
        jnp.concatenate([C0u[None], C]),
        jnp.concatenate([jnp.zeros((1, N, N), dtype), J]),
        jnp.concatenate([jnp.zeros((1, N), dtype), h]),
    )

    # -- parallel prefix ---------------------------------------------------
    _, b_f, C_f, _, _ = jax.lax.associative_scan(_compose, elems, axis=0)
    m_filt = b_f                                                  # (T, N)
    P_filt = C_f                                                  # (T, N, N)

    # -- predictive log-likelihood, vectorized over t >= 1 -----------------
    m_prev = m_filt[:-1]
    P_prev = P_filt[:-1]
    mu = jnp.einsum("i,tij,tj->t", w, F, m_prev, precision=MATMUL_PRECISION)
    FP = jnp.matmul(F, P_prev, precision=MATMUL_PRECISION)
    var = (jnp.einsum("i,tij,tkj,k->t", w, FP, F, w, precision=MATMUL_PRECISION)
           + S)  # S = w Q w + s2 already
    ll = -0.5 * ((yv - mu) ** 2 / var + jnp.log(var) + LOG_2PI)
    return ll0 + jnp.sum(jnp.where(vv, ll, 0.0))


@jax.jit
def msrouse_logL_assoc(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profile, ydata, valid):
    """
    Log-likelihood of ONE profile via the temporal-parallel filter.

    Same argument convention as `kalman.msrouse_logL_single`; ``Gs`` must be
    zero (no external force — true for every model in this package). vmap
    over a leading profile axis for batches.
    """
    profile = jnp.asarray(profile, dtype=jnp.int32)
    Fs = jnp.take(Bs, profile, axis=0)          # (T, N, N)
    Qs = jnp.take(Sigs, profile, axis=0)
    m0_full = jnp.take(M0s, profile[0], axis=0)  # (N, d)
    C0 = jnp.take(C0s, profile[0], axis=0)       # (N, N)
    s2_dims = jnp.take(s2, jnp.asarray(Cind), axis=0)  # (d,)

    def per_dim(m0_d, s2d, y_d):
        return _filter_one_dim(Fs, Qs, m0_d, C0, w, s2d, y_d, valid)

    lls = jax.vmap(per_dim)(m0_full.T, s2_dims, ydata.T)
    return jnp.sum(lls)
