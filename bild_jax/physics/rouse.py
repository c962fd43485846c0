"""
Rouse polymer dynamics (JAX replacement for the ``rouse`` package subset).

The reference treats ``rouse.Model`` as a black box supplying discrete-time
linear-Gaussian dynamics (interface inventory: SURVEY.md section 2.17; consumed
at reference ``bild/src/MSRouse_logL.pyx:152-163`` and ``bild/models.py:242-249,
331-338,366-367``):

    x_{t+1} = B x_t + G + eta,   eta ~ N(0, Sig)     (per spatial dimension)

Here everything is derived in closed form from the spectral decomposition of
the connectivity Laplacian ``A`` (tridiagonal backbone + extra bonds):

- continuous dynamics  dx/dt = -kappa A x + xi,  <xi xi'> = 2 D delta(t-t'),
- ``B = exp(-kappa A dt) = V diag(exp(-kappa lam dt)) V^T``,
- per-mode one-step noise variance ``D/(kappa lam) (1 - exp(-2 kappa lam dt))``
  (free modes, lam = 0: ``2 D dt``),
- steady-state covariance per mode ``D/(kappa lam)``; free modes (center of
  mass, or disconnected fragments after bond removal) are pinned to zero
  variance at the origin. This choice is invisible to any measurement vector
  orthogonal to the free modes (e.g. the default end-to-end vector) because
  neither propagation nor the Kalman update mixes eigenmodes of a single
  state's dynamics into the free-mode subspace through ``w``.

The eigendecomposition is computed once at construction (host, float64); the
resulting dense ``B``/``Sig``/steady-state arrays are what the batched Kalman
kernels consume on device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
from scipy.special import erfc as _erfc

import jax
import jax.numpy as jnp

from ..config import fdtype, MATMUL_PRECISION

__all__ = ["RouseModel", "two_locus_msd"]

_FREE_MODE_TOL = 1e-10


def _build_laplacian(N: int, extra_bonds) -> np.ndarray:
    """
    Connectivity Laplacian: backbone bonds ``(i, i+1)`` with strength 1 plus
    ``extra_bonds`` given as ``(left, right[, rel_strength])`` tuples.
    Negative relative strength removes connectivity; ``(i, i+1, -1)`` removes
    backbone bond ``i`` (reference convention, ``bild/models.py:189-190``).
    Negative monomer indices count from the chain end (so ``(0, -1)`` is an
    end-to-end bond).
    """
    A = np.zeros((N, N), dtype=np.float64)
    bonds = [(i, i + 1, 1.0) for i in range(N - 1)]
    if extra_bonds is not None:
        for bond in extra_bonds:
            if bond is None:
                continue
            if len(bond) == 2:
                l, r = bond
                strength = 1.0
            else:
                l, r, strength = bond
            l = int(l) % N
            r = int(r) % N
            if l == r:
                continue  # vacuous bond, e.g. (0, 0) for "no loop"
            bonds.append((l, r, float(strength)))
    for l, r, strength in bonds:
        A[l, l] += strength
        A[r, r] += strength
        A[l, r] -= strength
        A[r, l] -= strength
    return A


@dataclasses.dataclass(frozen=True)
class RouseModel:
    """
    An N-monomer Rouse chain with optional extra bonds.

    Parameters mirror the used surface of ``rouse.Model(N, D, k, d,
    add_bonds=...)`` (reference ``bild/models.py:246``): ``D`` is the free
    monomer 1d diffusion constant, ``k`` the backbone spring constant, ``d``
    the spatial dimension, ``dt`` the frame interval.

    Attributes (all device arrays, canonical float dtype)
    ----------
    B : (N, N)        propagator ``exp(-k A dt)`` (symmetric)
    G : (N, d)        additive drift; zero (no external force in BILD's usage)
    Sig : (N, N)      one-step noise covariance per spatial dimension
    C_ss : (N, N)     steady-state covariance per spatial dimension
    M_ss : (N, d)     steady-state mean (zeros)
    L_ss : (N, N)     a factor with ``L_ss @ L_ss.T = C_ss`` (for sampling)
    L_sig : (N, N)    a factor with ``L_sig @ L_sig.T = Sig`` (for sampling)
    """

    N: int
    D: float
    k: float
    d: int
    dt: float
    add_bonds: Optional[Tuple] = None

    # derived (populated in __post_init__)
    B: jax.Array = dataclasses.field(init=False, repr=False)
    G: jax.Array = dataclasses.field(init=False, repr=False)
    Sig: jax.Array = dataclasses.field(init=False, repr=False)
    C_ss: jax.Array = dataclasses.field(init=False, repr=False)
    M_ss: jax.Array = dataclasses.field(init=False, repr=False)
    L_ss: jax.Array = dataclasses.field(init=False, repr=False)
    L_sig: jax.Array = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        A = _build_laplacian(self.N, self.add_bonds)
        lam, V = np.linalg.eigh(A)
        lam = np.clip(lam, 0.0, None)
        free = lam <= _FREE_MODE_TOL * max(1.0, float(lam[-1]))
        kl = self.k * lam

        with np.errstate(divide="ignore", invalid="ignore"):
            b = np.exp(-kl * self.dt)
            sig = np.where(free, 2.0 * self.D * self.dt,
                           self.D / kl * (1.0 - np.exp(-2.0 * kl * self.dt)))
            css = np.where(free, 0.0, self.D / kl)

        def _sandwich(diag):
            return (V * diag[None, :]) @ V.T

        dtype = fdtype()
        object.__setattr__(self, "B", jnp.asarray(_sandwich(b), dtype=dtype))
        object.__setattr__(self, "Sig", jnp.asarray(_sandwich(sig), dtype=dtype))
        object.__setattr__(self, "C_ss", jnp.asarray(_sandwich(css), dtype=dtype))
        object.__setattr__(self, "G", jnp.zeros((self.N, self.d), dtype=dtype))
        object.__setattr__(self, "M_ss", jnp.zeros((self.N, self.d), dtype=dtype))
        object.__setattr__(self, "L_ss",
                           jnp.asarray(V * np.sqrt(css)[None, :], dtype=dtype))
        object.__setattr__(self, "L_sig",
                           jnp.asarray(V * np.sqrt(sig)[None, :], dtype=dtype))

    # -- rouse.Model API surface used by the reference --------------------
    def check_dynamics(self):
        """Dynamics are always precomputed; kept for API parity."""
        return True

    @property
    def _dynamics(self):
        """Reference-compatible view of the discrete dynamics (consumed as
        ``m._dynamics['B'|'G'|'Sig']`` at reference ``MSRouse_logL.pyx:155-157``)."""
        return {"B": self.B, "G": self.G, "Sig": self.Sig}

    def steady_state(self) -> Tuple[jax.Array, jax.Array]:
        """``(M, C)``: steady-state mean ``(N, d)`` and covariance ``(N, N)``."""
        return self.M_ss, self.C_ss

    def propagate_M(self, M: jax.Array, check_dynamics: bool = False) -> jax.Array:
        return jnp.matmul(self.B, M, precision=MATMUL_PRECISION) + self.G

    def propagate_C(self, C: jax.Array, check_dynamics: bool = False) -> jax.Array:
        BC = jnp.matmul(self.B, C, precision=MATMUL_PRECISION)
        return jnp.matmul(BC, self.B, precision=MATMUL_PRECISION) + self.Sig

    def conf_ss(self, key: jax.Array) -> jax.Array:
        """Sample an ``(N, d)`` steady-state conformation."""
        eta = jax.random.normal(key, (self.N, self.d), dtype=fdtype())
        return self.M_ss + jnp.matmul(self.L_ss, eta, precision=MATMUL_PRECISION)

    def evolve(self, conf: jax.Array, key: jax.Array) -> jax.Array:
        """One discrete-time step from conformation ``conf`` (``(N, d)``)."""
        eta = jax.random.normal(key, (self.N, self.d), dtype=fdtype())
        return (self.propagate_M(conf)
                + jnp.matmul(self.L_sig, eta, precision=MATMUL_PRECISION))


def two_locus_msd(dt, G=1.0, J=1.0):
    """
    Analytic MSD of the separation vector of two loci on an infinite Rouse
    chain (replaces ``rouse.twoLocusMSD``, used at reference
    ``bild/models.py:592-599``).

    Parametrized by the short-time prefactor ``G`` (``MSD ~ G sqrt(t)`` for
    ``t -> 0``) and the plateau ``2 J`` (``J`` = equilibrium variance of the
    separation). Derived from the continuum Rouse two-point function:

        MSD(t) = G sqrt(t) (1 - exp(-u^2)) + 2 J erfc(u),
        u      = 2 J / (G sqrt(pi t)).
    """
    dt = np.abs(np.asarray(dt, dtype=float))
    scalar = dt.ndim == 0
    dt = np.atleast_1d(dt)
    out = np.zeros_like(dt)
    out[np.isinf(dt)] = 2.0 * J  # plateau
    pos = (dt > 0) & np.isfinite(dt)
    t = dt[pos]
    with np.errstate(over="ignore", under="ignore"):
        u = 2.0 * J / (G * np.sqrt(np.pi * t))
        out[pos] = G * np.sqrt(t) * (1.0 - np.exp(-u * u)) + 2.0 * J * _erfc(u)
    return out[0] if scalar else out
