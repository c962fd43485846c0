"""
Minimal stand-in for the ``rouse`` package: only what the reference ``bild``
uses (interface inventory SURVEY.md section 2.17).

``twoLocusMSD`` delegates to the repo's validated closed form
(``bild_jax/physics/rouse.py:178``). ``Model`` is a float64 numpy
implementation of the used API surface — the same spectral construction as
``bild_jax.physics.rouse.RouseModel`` but host-side f64 throughout, so the
reference's python kernel (``bild/src/MSRouse_logL_py.py``) runs at its
native precision:

- ``_dynamics['B'|'G'|'Sig']``, ``check_dynamics()``
- ``steady_state() -> (M (N,d), C (N,N))``
- ``propagate_M(M)``, ``propagate_C(C)`` (C may be batched ``(d*, N, N)``)
- ``conf_ss()``, ``evolve(conf)`` (numpy global-RNG generative path)
"""
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from bild_jax.physics.rouse import two_locus_msd as twoLocusMSD  # noqa: F401,E402
from bild_jax.physics.rouse import _build_laplacian  # noqa: E402


class Model:
    def __init__(self, N, D=1.0, k=1.0, d=3, add_bonds=None, dt=1.0):
        self.N, self.D, self.k, self.d, self.dt = N, float(D), float(k), d, float(dt)
        A = _build_laplacian(N, add_bonds)
        lam, V = np.linalg.eigh(A)
        lam = np.clip(lam, 0.0, None)
        free = lam <= 1e-10 * max(1.0, float(lam[-1]))
        kl = self.k * lam
        with np.errstate(divide="ignore", invalid="ignore"):
            b = np.exp(-kl * self.dt)
            sig = np.where(free, 2.0 * self.D * self.dt,
                           self.D / kl * (1.0 - np.exp(-2.0 * kl * self.dt)))
            css = np.where(free, 0.0, self.D / kl)
        self.B = (V * b[None, :]) @ V.T
        self.Sig = (V * sig[None, :]) @ V.T
        self.C_ss = (V * css[None, :]) @ V.T
        self.G = np.zeros((N, d))
        self._L_ss = V * np.sqrt(css)[None, :]
        self._L_sig = V * np.sqrt(sig)[None, :]

    @property
    def _dynamics(self):
        return {"B": self.B, "G": self.G, "Sig": self.Sig}

    def check_dynamics(self, *args, **kwargs):
        return True

    def steady_state(self):
        return np.zeros((self.N, self.d)), self.C_ss

    def propagate_M(self, M, check_dynamics=False):
        return self.B @ M + self.G

    def propagate_C(self, C, check_dynamics=False):
        return self.B @ C @ self.B + self.Sig

    def conf_ss(self):
        return self._L_ss @ np.random.normal(size=(self.N, self.d))

    def evolve(self, conf):
        return (self.B @ conf + self.G
                + self._L_sig @ np.random.normal(size=(self.N, self.d)))
