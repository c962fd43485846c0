"""
Gradient-based calibration of ``MultiStateRouse`` physical parameters.

The reference framework treats the model parameters (monomer diffusion
constant ``D``, backbone spring constant ``k``, localization error) as
fixed inputs: its likelihood kernel is compiled Cython
(``bild/src/MSRouse_logL.pyx``) and cannot be differentiated, so users
calibrate parameters externally (e.g. MSD fits via ``bayesmsd``) before
running BILD. Here the likelihood is a pure JAX function, so the SAME
kernel that scores looping profiles also yields exact gradients of the
data log-likelihood with respect to the physical parameters — a new
capability, not a port.

Differentiability comes cheap because of how `physics.rouse.RouseModel`
is built (see its module docstring): the connectivity Laplacian ``A`` of
each loop state depends only on the bond STRUCTURE, never on ``(D, k)``.
Its eigendecomposition ``A = V diag(lam) V^T`` is therefore a constant,
computed once on host in float64, and the discrete-time dynamics are
elementwise functions of the eigenvalues:

    B   = V diag(exp(-k lam dt)) V^T
    Sig = V diag(D/(k lam) (1 - exp(-2 k lam dt))) V^T
    C0  = V diag(D/(k lam)) V^T            (free modes: 2 D dt / pinned 0)

so the map ``(D, k) -> (B, Sig, C0)`` is smooth, closed-form, and runs as
a handful of (n_states, N)-shaped elementwise ops plus two small GEMMs —
no ``eigh`` on the gradient tape. Free modes (``lam = 0``: center of
mass, disconnected fragments) are handled with constant masks and
``jnp.where`` on BOTH branches' safe inputs, so no NaN reaches the tape
(the classic ``where`` autodiff trap).

The likelihood path is the XLA scan kernel (`ops.kalman.msrouse_logL_batch`)
— `lax.scan` has a transpose rule, so reverse-mode AD through the whole
T-step Kalman recursion is a single compiled backward scan. The entire
optimization (optax adam by default) runs inside ONE jitted `lax.scan`
over steps: one device dispatch for the whole fit.

Typical use — self-contained EM-style refinement:

    res = sample_dataset(model, trajs, ...)           # infer profiles
    fit = fit_rouse(model, trajs, res.best_profile()) # refit parameters
    model = fit.model                                 # calibrated model
    # ... optionally iterate

Reference context: ``bild/models.py:163-370`` (MultiStateRouse holds
fixed parameters), ``bild/src/MSRouse_logL.pyx:95-256`` (opaque compiled
kernel — the capability boundary this module crosses).
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from .config import fdtype, MATMUL_PRECISION
from .ops.kalman import msrouse_logL_batch
from .physics.rouse import _build_laplacian, _FREE_MODE_TOL
from .trajectory import Trajectory

__all__ = ["fit_rouse", "FitResult", "make_rouse_nll", "calibrate_rouse",
           "CalibrationResult", "fit_ggm", "make_ggm_nll", "GGMFitResult",
           "MSDFamily", "POWERLAW", "TWO_LOCUS_ROUSE", "calibrate_ggm",
           "GGMCalibrationResult"]


def _spectral_consts(model):
    """
    Per-state eigendecompositions of the (parameter-independent) Laplacians.

    Returns (lams, Vs, free): (n, N) eigenvalues, (n, N, N) eigenvectors,
    (n, N) bool free-mode mask — all host float64 constants.
    """
    lams, Vs, frees = [], [], []
    for m in model.models:
        A = _build_laplacian(m.N, m.add_bonds)
        lam, V = np.linalg.eigh(A)
        lam = np.clip(lam, 0.0, None)
        lams.append(lam)
        Vs.append(V)
        frees.append(lam <= _FREE_MODE_TOL * max(1.0, float(lam[-1])))
    return np.stack(lams), np.stack(Vs), np.stack(frees)


def _dynamics_from_params(consts, log_D, log_k, dt, dtype):
    """
    Differentiable ``(log D, log k) -> (Bs, Sigs, C0s)``.

    Same formulas as `RouseModel.__post_init__` (kept in lockstep with it;
    parity asserted by ``tests/test_fit.py``), expressed in jnp with the
    free-mode division guarded on both `where` branches.
    """
    lams, Vs, free = consts
    lam = jnp.asarray(lams, dtype=dtype)
    V = jnp.asarray(Vs, dtype=dtype)
    free = jnp.asarray(free)

    D = jnp.exp(log_D).astype(dtype)
    k = jnp.exp(log_k).astype(dtype)

    kl = k * lam                                       # (n, N)
    safe_kl = jnp.where(free, 1.0, kl)
    b = jnp.exp(-kl * dt)
    sig = jnp.where(free, 2.0 * D * dt,
                    D / safe_kl * (1.0 - jnp.exp(-2.0 * kl * dt)))
    css = jnp.where(free, 0.0, D / safe_kl)

    def sandwich(diag):                                # V diag V^T per state
        return jnp.einsum("snm,sm,skm->snk", V, diag, V,
                          precision=MATMUL_PRECISION)

    return sandwich(b), sandwich(sig), sandwich(css)


def _as_batch_arrays(data):
    """Coerce Trajectory / TrajectoryBatch / sequence to (B,T,d), (B,T) bool."""
    if isinstance(data, Trajectory):
        return data.data[None], data.valid[None], [data]
    if hasattr(data, "data") and hasattr(data, "valid"):   # TrajectoryBatch
        return jnp.asarray(data.data), jnp.asarray(data.valid), None
    trajs = list(data)
    from .parallel import stack_trajectories
    batch = stack_trajectories(trajs)
    return jnp.asarray(batch.data), jnp.asarray(batch.valid), trajs


def _coerce_profiles(profiles, B, T, valid):
    """(T,) / (B, T) arrays broadcast; ragged sequences (e.g.
    ``sample_dataset(...).best_profile()``) pad to T with state 0 — padding
    frames are invalid in the batch, so the value never reaches the
    likelihood sum. A profile SHORTER than its trajectory's frame count
    would silently score real frames as state 0, so that is an error."""
    if not isinstance(profiles, np.ndarray) or profiles.dtype == object:
        seq = list(profiles)
        if len(seq) and np.ndim(seq[0]) >= 1 \
                and any(len(np.asarray(p)) != T for p in seq):
            if len(seq) != B:
                raise ValueError(f"got {len(seq)} profiles for {B} "
                                 "trajectories")
            valid = np.asarray(valid)
            # frame count = position of each row's last observed frame + 1
            lengths = np.where(valid.any(axis=1),
                               T - np.argmax(valid[:, ::-1], axis=1), 0)
            out = np.zeros((B, T), dtype=np.int32)
            for b, p in enumerate(seq):
                p = np.asarray(p, dtype=np.int32)
                if not lengths[b] <= len(p) <= T:
                    raise ValueError(
                        f"profile {b} has {len(p)} frames but trajectory "
                        f"{b} has {lengths[b]} (batch padded to {T})")
                out[b, :len(p)] = p
            return jnp.asarray(out)
        profiles = np.asarray([np.asarray(p) for p in seq]) \
            if len(seq) and np.ndim(seq[0]) >= 1 else np.asarray(seq)
    return jnp.asarray(np.broadcast_to(profiles.astype(np.int32), (B, T)))


def _resolve_err0(model, trajs, d):
    """Starting/frozen localization error, resolved like the likelihood
    path (``bild/models.py:255-263`` semantics: an explicit model value
    wins, else per-trajectory metadata). The fit shares ONE noise level
    across the batch, so heterogeneous per-trajectory errors are an error
    rather than a silent collapse to trajectory 0's value."""
    if model.localization_error is not None:
        err0 = np.asarray(model.localization_error, dtype=float)
    elif trajs is not None:
        errs = np.stack([np.broadcast_to(
            np.asarray(model._get_noise(t), dtype=float), (d,))
            for t in trajs])
        if not (errs == errs[0]).all():
            raise ValueError(
                "trajectories carry heterogeneous localization errors; the "
                "fit shares one noise level across the batch — set "
                "model.localization_error explicitly or fit homogeneous "
                "subsets")
        err0 = errs[0]
    else:
        raise ValueError("fitting a TrajectoryBatch requires "
                         "model.localization_error to be set")
    return np.broadcast_to(err0, (d,))


def make_rouse_nll(model, data, profiles, fit_localization=True,
                   weights=None):
    """
    Build the differentiable objective.

    Parameters
    ----------
    model : MultiStateRouse
        supplies the loop-state structure, measurement vector, dt, and the
        parameter initialization.
    data : Trajectory | TrajectoryBatch | sequence of Trajectory
    profiles : (T,) or (B, T) int array, or sequence of per-trajectory
        (T_b,) int arrays (ragged — e.g. ``sample_dataset(...)
        .best_profile()``; each is padded to the batch length, which is
        harmless because padding frames are invalid and carry no
        likelihood). The looping profile believed to underlie each
        trajectory: ground truth in simulation studies, the inferred MAP
        otherwise. With ``weights``: a ``(B, M, T)`` array of M candidate
        profiles per trajectory (e.g. `BatchResults.profile_ensemble`).
    weights : optional (B, M) array
        posterior weights over M candidate profiles per trajectory (each
        row summing to 1). The objective becomes the posterior-EXPECTED
        negative log-likelihood ``-sum_b sum_m w_bm logL(theta; prof_bm,
        y_b)`` — the proper EM M-step (soft EM), replacing the
        MAP-profile point estimate (hard EM). Rows of zero weight are
        masked before the multiply so a ``-inf`` likelihood on a
        zero-weight candidate cannot poison the sum.
    fit_localization : bool | "scalar" | "vector"
        ``True`` / ``"scalar"`` (default) fits ONE isotropic localization
        error shared by all spatial dimensions — per-dim errors are only
        weakly identified at typical data sizes (measured: +-50% scatter at
        B=24, T=100 where the shared error recovers within 15%), and the
        single-error case keeps the kernel's d* covariance deduplication.
        ``"vector"`` fits a per-dimension error. ``False`` freezes the
        error at the model/trajectory metadata value (reference resolution
        semantics, ``bild/models.py:255-263``).

    Returns
    -------
    nll : callable
        ``nll(params) -> scalar`` — negative mean per-observed-scalar
        log-likelihood (normalized so learning rates transfer across batch
        sizes), jit/grad-compatible.
    params0 : dict
        initialization pytree: ``log_D``, ``log_k`` scalars and, when
        ``fit_localization``, ``log_err`` of shape (d,).
    """
    nll, params0, _ = _build_nll(model, data, profiles, fit_localization,
                                 weights)
    return nll, params0


def _build_nll(model, data, profiles, fit_localization, weights=None):
    """`make_rouse_nll` body; also returns the resolved starting error so
    `fit_rouse` does not re-derive (and cannot drift from) it."""
    dtype = fdtype()
    ydata, valid, trajs = _as_batch_arrays(data)
    B, T, d = ydata.shape
    if weights is not None:
        profiles = jnp.asarray(np.asarray(profiles, dtype=np.int32))
        weights = jnp.asarray(np.asarray(weights), dtype=dtype)
        if profiles.shape[:2] != weights.shape or profiles.shape != \
                (B, weights.shape[1], T):
            raise ValueError(
                f"weighted profiles must be (B={B}, M, T={T}) with (B, M) "
                f"weights; got {profiles.shape} / {weights.shape}")
    else:
        profiles = _coerce_profiles(profiles, B, T, valid)

    m0 = model.models[0]
    consts = _spectral_consts(model)
    n = len(model.models)
    dt = m0.dt
    w = model.w.astype(dtype)

    err0 = _resolve_err0(model, trajs, d)

    mode = {True: "scalar", False: "off"}.get(fit_localization,
                                              fit_localization)
    if mode not in ("scalar", "vector", "off"):
        raise ValueError(f"fit_localization: got {fit_localization!r}")

    params0 = {"log_D": jnp.asarray(np.log(m0.D), dtype=dtype),
               "log_k": jnp.asarray(np.log(m0.k), dtype=dtype)}
    if mode == "scalar":
        params0["log_err"] = jnp.asarray(np.mean(np.log(err0)), dtype=dtype)
        Cind = np.zeros(d, dtype=np.int32)          # q=1: keeps d* dedup
        s2_frozen = None
    elif mode == "vector":
        params0["log_err"] = jnp.asarray(np.log(err0), dtype=dtype)
        Cind = np.arange(d, dtype=np.int32)         # q=d: per-dim carry
        s2_frozen = None
    else:
        # frozen error deduplicates dims like the production path
        uniq, Cind = np.unique(err0, return_inverse=True)
        Cind = Cind.astype(np.int32)
        s2_frozen = jnp.asarray(uniq**2, dtype=dtype)

    Gs = jnp.zeros((n, m0.N, d), dtype=dtype)
    M0s = jnp.zeros((n, m0.N, d), dtype=dtype)
    n_obs = jnp.sum(valid) * d

    def nll(params):
        Bs, Sigs, C0s = _dynamics_from_params(
            consts, params["log_D"], params["log_k"], dt, dtype)
        s2 = (s2_frozen if mode == "off"
              else jnp.atleast_1d(jnp.exp(2.0 * params["log_err"])))

        if weights is None:
            def one(prof, y, v):
                return msrouse_logL_batch(Bs, Gs, Sigs, M0s, C0s, w, s2,
                                          Cind, prof[None], y, v)[0]

            ll = jax.vmap(one)(profiles, ydata, valid)
            return -jnp.sum(ll) / n_obs.astype(dtype)

        def one(profs, y, v):                       # profs: (M, T)
            return msrouse_logL_batch(Bs, Gs, Sigs, M0s, C0s, w, s2,
                                      Cind, profs, y, v)

        ll = jax.vmap(one)(profiles, ydata, valid)  # (B, M)
        ll = jnp.where(weights > 0, ll, 0.0)        # mask 0 * (-inf)
        return -jnp.sum(weights * ll) / n_obs.astype(dtype)

    return nll, params0, err0


def _run_adam(nll, params0, steps, learning_rate, optimizer=None):
    """Shared optimizer loop: the whole optax run inside ONE jitted
    `lax.scan` (single device dispatch regardless of ``steps``). Returns
    host ``(params, nll_trace, grad_norm)``; ``nll_trace[i]`` is the
    objective BEFORE step i, with the post-fit value appended."""
    import optax

    opt = optimizer if optimizer is not None else optax.adam(learning_rate)

    @jax.jit
    def run(params):
        state = opt.init(params)

        def step(carry, _):
            params, state = carry
            val, grads = jax.value_and_grad(nll)(params)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            return (params, state), val

        (params, _), vals = jax.lax.scan(step, (params, state), None,
                                         length=steps)
        gnorm = optax.global_norm(jax.grad(nll)(params))
        return params, jnp.concatenate([vals, nll(params)[None]]), gnorm

    params, trace, gnorm = run(params0)
    return (jax.device_get(params), np.asarray(trace, dtype=float),
            float(gnorm))


def _rebuild_model(model, D, k, err):
    """`MultiStateRouse` clone with new ``(D, k, localization_error)``,
    preserving loop structure, measurement, dt, and transition-matrix
    customizations."""
    from .models import MultiStateRouse
    m0 = model.models[0]
    fitted = MultiStateRouse(
        m0.N, D, k, d=model.d,
        looppositions=[m.add_bonds for m in model.models],
        measurement=np.asarray(model.measurement),
        localization_error=np.asarray(err, dtype=float).copy(),
        dt=m0.dt)
    fitted.transitions = model.transitions.copy()
    return fitted


@dataclasses.dataclass
class FitResult:
    """Outcome of `fit_rouse`. ``nll_trace[0]`` is the initial objective."""
    D: float
    k: float
    localization_error: np.ndarray        # (d,) — fitted or frozen
    params: dict                          # raw optimized pytree
    nll_trace: np.ndarray                 # (steps + 1,)
    grad_norm: float                      # at the optimum
    model: object                         # re-built calibrated MultiStateRouse

    @property
    def converged(self) -> bool:
        """Heuristic: relative objective change over the last 10% of steps."""
        tail = max(2, len(self.nll_trace) // 10)
        a, b = self.nll_trace[-tail], self.nll_trace[-1]
        return bool(abs(a - b) <= 1e-6 * max(1.0, abs(b)))


def fit_rouse(model, data, profiles, *, fit_localization=True,
              steps: int = 300, learning_rate: float = 0.05,
              optimizer=None, weights=None) -> FitResult:
    """
    Maximum-likelihood calibration of ``(D, k[, localization_error])``
    given trajectories and their looping profiles.

    All parameters are optimized in log space (positivity for free) with
    optax adam by default; pass any optax ``GradientTransformation`` via
    ``optimizer`` to override. The full optimization loop runs inside one
    jitted `lax.scan` — a single device dispatch regardless of ``steps``.

    See `make_rouse_nll` for the argument contract — including ``weights``
    for the posterior-expected (soft-EM) objective — and the module
    docstring for scope (the reference has no analog of this function).
    """
    nll, params0, err0 = _build_nll(model, data, profiles, fit_localization,
                                    weights)
    params, trace, gnorm = _run_adam(nll, params0, steps, learning_rate,
                                     optimizer)

    D = float(np.exp(params["log_D"]))
    k = float(np.exp(params["log_k"]))
    m0 = model.models[0]
    d = model.d
    if fit_localization:
        err = np.broadcast_to(
            np.exp(np.asarray(params["log_err"], dtype=float)), (d,))
    else:
        err = err0

    fitted = _rebuild_model(model, D, k, err)

    return FitResult(D=D, k=k, localization_error=err, params=params,
                     nll_trace=trace, grad_norm=float(gnorm), model=fitted)


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of `calibrate_rouse`: the final calibrated model, the last
    inference results, and the per-round fit history."""
    model: object                         # calibrated MultiStateRouse
    results: object     # final round's BatchResults / DatasetResults
    fits: list                            # FitResult per round
    # final MAP profiles: (B, T) array (engine="batch") or ragged list of
    # (T_i,) arrays (engine="dataset")
    profiles: object
    # round-0 neutral (constant-profile) fit when init="neutral"; its nll is
    # NOT comparable to fits[i].nll_trace (different conditioning profiles)
    pre_fit: object = None

    @property
    def D(self):
        return self.fits[-1].D

    @property
    def k(self):
        return self.fits[-1].k

    @property
    def localization_error(self):
        return self.fits[-1].localization_error


def calibrate_rouse(model, data, *, rounds: int = 2,
                    mode: str = "hard", ensemble: int = 16,
                    init: str = "neutral", engine: str = "batch",
                    sample_kwargs: dict | None = None,
                    fit_kwargs: dict | None = None,
                    key=None) -> CalibrationResult:
    """
    Joint profile inference + parameter calibration by EM alternation.

    Each round runs lockstep batched inference
    (`parallel.sample_batch`) with the current parameters, then refits
    ``(D, k[, localization_error])`` by gradient MLE (`fit_rouse`). Two
    E-step flavors:

    - ``mode="hard"`` (Viterbi-style EM): the M-step sees only each
      trajectory's MAP profile. Accurate when profiles are well
      determined (per-frame posteriors here are typically >0.99 — PERF
      `5p`), and the cheapest option.
    - ``mode="soft"`` (proper EM on the truncated posterior): the M-step
      minimizes the posterior-EXPECTED negative log-likelihood over each
      trajectory's ``ensemble`` highest-weight sampled profiles
      (`BatchResults.profile_ensemble` — the standard truncated
      importance-sampling approximation of the E-step). Costs ``ensemble``
      likelihood evaluations per trajectory per fit step. Measured (B=12,
      T=60, both in-basin and 2x-off starts): results statistically
      indistinguishable from hard EM — the posterior concentrates fast
      enough here that hedging buys nothing; the option exists for
      low-information regimes (short/noisy trajectories) where the MAP
      profile is a poor summary.

    **EM is a local method; the neutral init is what widens the basin.**
    By default (``init="neutral"``) round 0 fits ``(D, k[, error])``
    against the constant ground-state profile — an MSD-level calibration
    needing NO sampling — and alternation starts from there. Measured at
    B=12, T=60: a 2x-off start diverges without it (both modes end at
    k 0.88 vs true 5, frame accuracy 0.33 — the first E-step locks onto a
    label-swapped profile assignment and the M-step follows) and converges
    with it (D 0.94, k 4.69, frame accuracy 0.982); an in-basin 35%-off
    start also improves (accuracy 0.982 vs 0.951). Use ``init="model"``
    to start the alternation at the passed model's own parameters. The
    per-round ``fits[i].nll_trace`` is the diagnostic to watch: it must
    DECREASE across rounds on a common scale. When in doubt, freeze the
    localization error (``fit_kwargs=dict(fit_localization=False)``); a
    learnable error absorbs E-step profile mistakes first.

    No reference analog: the reference calibrates parameters externally
    before inference and cannot iterate (its kernel is not
    differentiable).

    Parameters
    ----------
    model : MultiStateRouse — starting parameters and state structure.
        If ``model.localization_error`` is None, the (homogeneous)
        per-trajectory metadata is resolved into the model up front —
        lockstep sampling shares one noise model across the batch.
    data : Trajectory | TrajectoryBatch | sequence of Trajectory
    rounds : alternation count (2 is usually enough; parameters move in
        round 1, profiles react in round 2)
    mode : "hard" (MAP profile M-step) or "soft" (posterior-weighted)
    ensemble : candidate profiles per trajectory in soft mode (capped at
        the per-lane ensemble size, see `parallel.sample_batch`)
    init : "neutral" (default — round-0 constant-profile fit, see above)
        or "model" (start at the passed model's parameters)
    engine : "batch" (default) runs the E-step as one lockstep
        `parallel.sample_batch` over the stacked batch — right for up to
        a few hundred similar-length trajectories. "dataset" runs it
        through `parallel.sample_dataset` instead (length bucketing,
        fixed-size chunks, optional per-chunk checkpointing, mesh
        sharding via its ``sample_kwargs``) — the 10k-scale path for
        ragged datasets; requires ``mode="hard"`` (DatasetResults does
        not carry profile ensembles) and a Trajectory sequence.
    sample_kwargs / fit_kwargs : forwarded to `parallel.sample_batch` /
        `fit_rouse`
    key : PRNG key for the inference passes (split per round)

    Returns
    -------
    CalibrationResult
    """
    from .parallel import sample_batch, sample_dataset, stack_trajectories

    if mode not in ("hard", "soft"):
        raise ValueError(f"mode must be 'hard' or 'soft', got {mode!r}")
    if init not in ("neutral", "model"):
        raise ValueError(f"init must be 'neutral' or 'model', got {init!r}")
    if engine not in ("batch", "dataset"):
        raise ValueError(f"engine must be 'batch' or 'dataset', got "
                         f"{engine!r}")
    if engine == "dataset" and mode == "soft":
        raise ValueError("engine='dataset' supports mode='hard' only "
                         "(DatasetResults carries no profile ensembles)")

    if isinstance(data, Trajectory):
        trajs = [data]
    elif hasattr(data, "data") and hasattr(data, "valid"):  # TrajectoryBatch
        if engine == "dataset":
            raise ValueError("engine='dataset' needs a Trajectory "
                             "sequence (it buckets ragged lengths itself)")
        trajs = None
    else:
        trajs = list(data)
    if engine == "batch":
        batch = data if trajs is None else stack_trajectories(trajs)
        fit_data = batch
    else:
        batch = None
        fit_data = trajs
    if model.localization_error is None:
        # lockstep sampling (the E-step) needs a model-level noise; resolve
        # the homogeneous per-trajectory metadata the same way the fit does
        err = _resolve_err0(model, trajs, model.d)
        m0 = model.models[0]
        model = _rebuild_model(model, m0.D, m0.k, err)
    if key is None:
        key = jax.random.key(0)

    sample_kwargs = dict(sample_kwargs or {})
    fit_kwargs = dict(fit_kwargs or {})
    if mode == "soft":
        sample_kwargs["ensemble"] = ensemble

    pre_fit = None
    if init == "neutral":
        if engine == "batch":
            neutral = np.zeros((batch.B, batch.T), dtype=int)
        else:
            neutral = [np.zeros(len(t), dtype=int) for t in trajs]
        pre_fit = fit_rouse(model, fit_data, neutral, **fit_kwargs)
        model = pre_fit.model

    fits, res, profiles = [], None, None
    for r in range(rounds):
        key, sub = jax.random.split(key)
        if engine == "dataset":
            res = sample_dataset(model, trajs, key=sub, **sample_kwargs)
            profiles = res.best_profile()            # ragged list
            fit = fit_rouse(model, fit_data, profiles, **fit_kwargs)
        else:
            res = sample_batch(model, batch, key=sub, **sample_kwargs)
            profiles = np.asarray(res.best_profile())
            if mode == "soft":
                profs, weights = res.profile_ensemble()
                fit = fit_rouse(model, fit_data, profs, weights=weights,
                                **fit_kwargs)
            else:
                fit = fit_rouse(model, fit_data, profiles, **fit_kwargs)
        fits.append(fit)
        model = fit.model

    return CalibrationResult(model=model, results=res, fits=fits,
                             profiles=profiles, pre_fit=pre_fit)


# GGM MSD-parameter calibration lives in its own module; re-exported here so
# `bild_jax.fit` is the single calibration namespace
from .fit_ggm import (fit_ggm, make_ggm_nll, GGMFitResult,  # noqa: E402
                      MSDFamily, POWERLAW, TWO_LOCUS_ROUSE,
                      calibrate_ggm, GGMCalibrationResult)
