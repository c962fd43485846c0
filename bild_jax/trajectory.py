"""
Trajectory container (JAX replacement for the ``noctiluca`` subset).

The reference consumes ``noctiluca.Trajectory`` / ``make_Trajectory`` (see
reference ``bild/core.py:9,111`` and the interface inventory in SURVEY.md
section 2.16). That container encodes missing frames as NaN sentinels; NaNs
are hostile to ``lax.scan``/masked compute, so here a `Trajectory` is a JAX
pytree carrying

- ``data``  : ``(T, d)`` float array with missing frames zero-filled,
- ``valid`` : ``(T,)`` bool mask (True = frame observed),

plus static metadata (``localization_error``, an optional ground-truth
``loopingprofile``). The NaN-sentinel convention is still honored at the
boundary: `make_trajectory` accepts NaN-laden arrays of shape ``(N, T, d)``,
``(T, d)`` or ``(T,)`` (same coercion rules as ``noctiluca``'s
``make_Trajectory``), and ``traj[:]`` returns a NaN-sentinel view for
user-facing compatibility.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import fdtype

__all__ = ["Trajectory", "make_trajectory"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Trajectory:
    """
    A single particle-tracking trajectory.

    Parameters
    ----------
    data : (T, d) array
        the measured positions (distance vectors). Missing frames may be
        passed as NaN rows; they are converted to the mask representation.
    localization_error : (d,) array or None
        per-dimension measurement noise std. ``None`` means "unknown"; models
        fall back to their own setting (cf. reference ``bild/models.py:255-263``).
    loopingprofile : array or None
        ground-truth profile metadata for synthetic trajectories (cf.
        reference ``bild/models.py:347-350``). Not used in inference.
    """

    data: jax.Array
    valid: jax.Array
    localization_error: Optional[jax.Array] = dataclasses.field(
        default=None, metadata=dict(static=False)
    )
    loopingprofile: Optional[np.ndarray] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    # -- construction -----------------------------------------------------
    @staticmethod
    def create(data, localization_error=None, loopingprofile=None) -> "Trajectory":
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        if data.ndim != 2:
            raise ValueError(f"Trajectory data should be (T,) or (T, d); got shape {data.shape}")
        valid = ~np.any(np.isnan(data), axis=1)
        data = np.where(valid[:, None], np.nan_to_num(data), 0.0)
        if localization_error is not None:
            localization_error = np.asarray(localization_error, dtype=np.float64)
            if localization_error.ndim == 0:
                localization_error = localization_error * np.ones(data.shape[1])
            if localization_error.shape != (data.shape[1],):
                raise ValueError(
                    "localization_error should be scalar or (d,); "
                    f"got shape {localization_error.shape} for d={data.shape[1]}"
                )
            localization_error = jnp.asarray(localization_error, dtype=fdtype())
        if loopingprofile is not None and not isinstance(loopingprofile, np.ndarray):
            loopingprofile = np.asarray(loopingprofile)
        return Trajectory(
            data=jnp.asarray(data, dtype=fdtype()),
            valid=jnp.asarray(valid),
            localization_error=localization_error,
            loopingprofile=loopingprofile,
        )

    # -- basic API (mirrors the used noctiluca surface) -------------------
    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def T(self) -> int:
        return self.data.shape[0]

    @property
    def d(self) -> int:
        return self.data.shape[1]

    def __getitem__(self, key):
        """NaN-sentinel view, matching ``noctiluca.Trajectory.__getitem__``."""
        dat = np.asarray(self.data)
        val = np.asarray(self.valid)
        out = np.where(val[:, None], dat, np.nan)
        return out[key]

    def abs(self) -> "Trajectory":
        """Magnitude trajectory ``|x_t|`` of shape (T, 1) (cf. noctiluca ``traj.abs()``)."""
        mag = jnp.linalg.norm(self.data, axis=1, keepdims=True)
        return Trajectory(
            data=mag,
            valid=self.valid,
            localization_error=None,
            loopingprofile=self.loopingprofile,
        )

    def magnitudes(self) -> jax.Array:
        """(T,) distance magnitudes; 0 at missing frames (use ``valid``)."""
        return jnp.linalg.norm(self.data, axis=1)

    def count_valid_frames(self) -> int:
        return int(np.sum(np.asarray(self.valid)))

    # -- hashing for memo tables (host-side identity) ---------------------
    def __hash__(self):
        return hash((self.data.shape, bytes(np.asarray(self.data).tobytes())))

    def __eq__(self, other):
        if not isinstance(other, Trajectory):
            return NotImplemented
        return (
            self.data.shape == other.data.shape
            and bool(np.all(np.asarray(self.data) == np.asarray(other.data)))
            and bool(np.all(np.asarray(self.valid) == np.asarray(other.valid)))
        )


def _from_dataframe(df) -> np.ndarray:
    """
    Extract an ``(N, T, d)`` array from a DataFrame using the noctiluca
    column convention (``x1, y1, z1, x2, ...`` with an optional ``frame``
    column; see reference ``bild/core.py:48-52``). Unsuffixed ``x, y, z``
    denote a single locus. Frames missing from the index become NaN rows.
    """
    import re

    cols = {}
    for col in df.columns:
        mm = re.fullmatch(r"([xyz])(\d*)", str(col))
        if mm:
            dim = "xyz".index(mm.group(1))
            locus = int(mm.group(2)) if mm.group(2) else 1
            cols[(locus, dim)] = col
    if not cols:
        raise ValueError("DataFrame needs coordinate columns x[1], y[1], z[1], x2, ...")

    loci = sorted({k[0] for k in cols})
    dims = sorted({k[1] for k in cols})
    if "frame" in df.columns:
        frames = np.asarray(df["frame"], dtype=int)
    else:
        frames = np.arange(len(df))
    f0 = frames.min()
    T = int(frames.max() - f0) + 1

    arr = np.full((len(loci), T, len(dims)), np.nan)
    for i, locus in enumerate(loci):
        for j, dim in enumerate(dims):
            key = (locus, dim)
            if key in cols:
                arr[i, frames - f0, j] = np.asarray(df[cols[key]], dtype=float)
    return arr


def make_trajectory(obj, localization_error=None, **meta) -> Trajectory:
    """
    Coerce user input to a `Trajectory`.

    Mirrors the coercion surface of ``noctiluca.make_Trajectory`` used by the
    reference (``bild/core.py:41-52,111``): accepts an existing `Trajectory`,
    or ndarray of shape ``(N, T, d)``, ``(T, d)``, ``(T,)``. ``N = 2`` loci
    are converted to the relative (difference) trajectory, which is the
    quantity BILD models.
    """
    if isinstance(obj, Trajectory):
        return obj
    if hasattr(obj, "columns"):  # pandas DataFrame, noctiluca column scheme
        arr = _from_dataframe(obj)
    else:
        arr = np.asarray(obj, dtype=float)
    if arr.ndim == 3:
        if arr.shape[0] == 1:
            arr = arr[0]
        elif arr.shape[0] == 2:
            arr = arr[1] - arr[0]
        else:
            raise ValueError(f"Cannot interpret {arr.shape[0]}-locus trajectory; expected N in (1, 2)")
    return Trajectory.create(arr, localization_error=localization_error, **meta)
