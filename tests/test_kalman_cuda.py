"""The CUDA Rouse-Kalman kernel's Python side (`ops.kalman_cuda`), on the
CPU: argument layout, the trajectory-batch (vmap) path, NaN for
out-of-range states, and the choice of kernel per backend. The kernel
itself is stood in for by a host callback with its exact input contract
(leading batch dims broadcast onto every input, float32/int32 buffers);
`tests/test_card.py` and ``chip_smoke.py`` run the real one on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bild_jax.models.msrouse as msr
from bild_jax import Trajectory
from bild_jax.models import MultiStateRouse
from bild_jax.ops import kalman_cuda
from bild_jax.ops.kalman import msrouse_logL_batch
from bild_jax.ops.oracle import msrouse_logL_numpy

ARGS = ("Bs", "Gs", "Sigs", "M0s", "C0s", "w", "s2", "Cind", "profiles",
        "ydata", "valid")


def _kernel_contract(N, d, out_shape):
    """Pure-JAX stand-in for the FFI call: checks the buffers the kernel
    receives (shapes, dtypes, the shared leading batch dims) and computes
    its result with the XLA scan, one batch element at a time."""
    def call(*bufs):
        b = dict(zip(ARGS, bufs))
        lead = b["profiles"].shape[:-2]
        P, T = b["profiles"].shape[-2:]
        n, q = b["Bs"].shape[-3], b["s2"].shape[-1]
        want = {"Bs": (n, N, N), "Gs": (n, N, d), "Sigs": (n, N, N),
                "M0s": (n, N, d), "C0s": (n, N, N), "w": (N,), "s2": (q,),
                "Cind": (d,), "profiles": (P, T), "ydata": (T, d),
                "valid": (T,)}
        for k, x in b.items():
            assert x.shape == lead + want[k], (k, x.shape)
            assert x.dtype == (jnp.int32 if k in ("Cind", "profiles", "valid")
                               else jnp.float32), (k, x.dtype)
        assert tuple(out_shape) == lead + (P,)
        flat = [b[k].reshape((-1,) + want[k]) for k in ARGS]
        out = jax.vmap(lambda *a: msrouse_logL_batch(*a[:10], a[10] != 0))(
            *flat)
        return out.reshape(out_shape).astype(jnp.float32)
    return call


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(kalman_cuda, "_ffi", _kernel_contract)


def _setup(rng, T=12, P=5, errors=(0.3, 0.5, 0.3)):
    model = MultiStateRouse(8, 1.0, 4.0, d=3, localization_error=list(errors))
    data = rng.normal(size=(T, 3))
    data[3] = np.nan
    traj = Trajectory.create(data)
    s2, Cind = model._noise_arrays(traj)
    profiles = rng.integers(0, 2, size=(P, T)).astype(np.int32)
    head = (model.Bs, model.Gs, model._filter_Sigs, model.M0s, model.C0s,
            model.w, s2, Cind)
    return model, traj, head, profiles


def test_wrapper_layout_matches_scan(stand_in, rng):
    _, traj, head, profiles = _setup(rng)
    got = np.asarray(kalman_cuda.msrouse_logL_cuda(
        *head, profiles, traj.data, traj.valid))
    want = np.asarray(msrouse_logL_batch(*head, profiles, traj.data,
                                         traj.valid))
    assert got.dtype == np.float32 and got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_wrapper_trajectory_batch_vmap(stand_in, rng):
    """The lockstep runners vmap the likelihood over trajectories (and
    jit it): every trajectory is one batch element of the kernel."""
    _, traj, head, profiles = _setup(rng)
    B = 3
    ys = jnp.stack([traj.data + 0.1 * b for b in range(B)])
    valids = jnp.stack([traj.valid] * B).at[1, 5].set(False)
    profs = jnp.stack([profiles, 1 - profiles, profiles[::-1]])

    def one(fn):
        return lambda p, y, v: fn(*head, p, y, v)

    got = jax.jit(jax.vmap(one(kalman_cuda.msrouse_logL_cuda)))(
        profs, ys, valids)
    want = jax.vmap(one(msrouse_logL_batch))(profs, ys, valids)
    assert got.shape == (B, 5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_wrapper_batch_beyond_grid_rows(stand_in, rng):
    """vmap over k, then over trajectories, as the fused lockstep runner
    does: 11 x 6,000 = 66,000 batch elements, more than a CUDA grid's y
    dimension holds, reach the kernel as one (11, 6000) leading batch."""
    model = MultiStateRouse(4, 1.0, 4.0, d=1, localization_error=0.2)
    K1, B, T = 11, 6000, 4
    traj = Trajectory.create(rng.normal(size=(T, 1)))
    s2, Cind = model._noise_arrays(traj)
    head = (model.Bs, model.Gs, model._filter_Sigs, model.M0s, model.C0s,
            model.w, s2, Cind)
    profiles = rng.integers(0, 2, size=(K1, B, 1, T)).astype(np.int32)
    ys = jnp.asarray(rng.normal(size=(B, T, 1)))
    valid = jnp.ones((B, T), bool)

    def run(fn):
        per_traj = jax.vmap(lambda p, y, v: fn(*head, p, y, v))
        return jax.jit(jax.vmap(per_traj, in_axes=(0, None, None)))(
            profiles, ys, valid)

    got, want = run(kalman_cuda.msrouse_logL_cuda), run(msrouse_logL_batch)
    assert got.shape == (K1, B, 1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_wrapper_out_of_range_states_nan(stand_in, rng):
    _, traj, head, profiles = _setup(rng)
    profiles[1, 4] = 2
    profiles[2, 0] = -1
    got = np.asarray(kalman_cuda.msrouse_logL_cuda(
        *head, profiles, traj.data, traj.valid))
    assert np.isfinite(got[[0, 3, 4]]).all() and np.isnan(got[1:3]).all()


def test_wrapper_rejects_n_above_warp(rng):
    model = MultiStateRouse(kalman_cuda.MAX_N + 1, 1.0, 4.0, d=1,
                            localization_error=0.2)
    traj = Trajectory.create(rng.normal(size=(6, 1)))
    s2, Cind = model._noise_arrays(traj)
    with pytest.raises(ValueError, match="N <= 32"):
        kalman_cuda.msrouse_logL_cuda(
            model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
            s2, Cind, np.zeros((2, 6), np.int32), traj.data, traj.valid)


@pytest.mark.parametrize("backend,dtype,N,want", [
    ("gpu", jnp.float32, 20, "cuda"),
    ("gpu", jnp.float32, 33, "scan"),
    ("gpu", jnp.float64, 20, "scan"),
    ("cpu", jnp.float32, 20, "scan"),
])
def test_kernel_choice(monkeypatch, backend, dtype, N, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    got = msr._select_kernel(jnp.dtype(dtype), N)
    assert got is {"cuda": kalman_cuda.msrouse_logL_cuda,
                   "scan": msrouse_logL_batch}[want]


def test_gpu_without_nvcc_raises(monkeypatch, tmp_path, rng):
    """On a GPU the float32 path is the kernel: if it cannot be built, the
    likelihood raises instead of quietly running the scan."""
    import shutil
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_toolkit"))
    monkeypatch.setattr(kalman_cuda, "_BUILD", str(tmp_path))
    monkeypatch.setattr(kalman_cuda, "_targets", {})
    jax.config.update("jax_enable_x64", False)
    try:
        model = MultiStateRouse(8, 1.0, 4.0, d=1, localization_error=0.2)
        traj = Trajectory.create(rng.normal(size=(6, 1)))
        with pytest.raises(RuntimeError, match="nvcc"):
            model.logL_batch(np.zeros((2, 6), int), traj)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_wrapper_splits_over_mesh(monkeypatch, rng):
    """Under a device mesh each device runs the kernel on its own rows: the
    call is partitioned to local batch shapes instead of replicated on an
    all-gathered batch."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    seen = []

    def recording(N, d, out_shape):
        seen.append(out_shape)
        return _kernel_contract(N, d, out_shape)

    monkeypatch.setattr(kalman_cuda, "_ffi", recording)
    monkeypatch.setattr(kalman_cuda, "_calls", {})
    _, traj, head, profiles = _setup(rng, P=3)
    B = 8
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    rows = NamedSharding(mesh, P("data"))
    profs = jax.device_put(np.stack([np.roll(profiles, b, axis=1)
                                     for b in range(B)]), rows)
    ys = jax.device_put(np.stack([np.asarray(traj.data) + 0.1 * b
                                  for b in range(B)]), rows)
    valids = jax.device_put(np.stack([np.asarray(traj.valid)] * B), rows)

    def one(fn):
        return jax.jit(jax.vmap(lambda p, y, v: fn(*head, p, y, v)))

    got = one(kalman_cuda.msrouse_logL_cuda)(profs, ys, valids)
    want = one(msrouse_logL_batch)(profs, ys, valids)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    assert got.sharding.spec[0] == "data"
    # the partitioned lowering traced the kernel call at the local shape
    assert seen[-1] == (B // 4, 3)
