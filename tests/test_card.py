"""Card-only tests: the float32 device paths on a CUDA card against float64
references. On a GPU a float32 product at default precision may run in
TF32 (~1e-3 relative); every product on these paths asks for full fp32, so
each test holds it to the float32 storage floor.

They skip elsewhere; ``python chip_smoke.py`` runs them on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]


@pytest.mark.parametrize("n,T", [(2, 100), (3, 1000)])
def test_rouse_likelihood_f32_matches_oracle(rng, n, T):
    from bild_jax.models import MultiStateRouse
    from bild_jax.ops.oracle import msrouse_logL_numpy

    model = MultiStateRouse(20, 1.0, 5.0, d=3,
                            looppositions=(None, (0, -1), (0, 10))[:n],
                            localization_error=[0.08, 0.1, 0.12])
    assert model.Bs.dtype == jnp.float32
    truth = (np.arange(T) // 37) % n
    traj = model.trajectory_from_loopingprofile(
        truth, missing_frames=T // 10, key=jax.random.key(T))
    profiles = np.concatenate([truth[None], rng.integers(0, n, (15, T))])
    got = np.asarray(model.logL_batch(profiles, traj), dtype=np.float64)
    arrs = [np.asarray(a, dtype=np.float64) for a in
            (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w)]
    want = [msrouse_logL_numpy(*arrs, model._get_noise(traj), p, traj[:])
            for p in profiles]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gaussian_logpdf_f32_full_precision(rng):
    """The GGM gap path's Cholesky solve and its quadratic-form product."""
    from bild_jax.models.ggm import _masked_gaussian_logpdf

    L = 64
    A = rng.normal(size=(L, L))
    C = A @ A.T / L + np.eye(L)
    x = rng.normal(size=L)
    got = float(_masked_gaussian_logpdf(jnp.asarray(x, jnp.float32),
                                        jnp.asarray(C, jnp.float32), L))
    _, logdet = np.linalg.slogdet(C)
    want = -0.5 * (x @ np.linalg.solve(C, x) + logdet + L * np.log(2 * np.pi))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_dirichlet_estimate_f32_full_precision(rng):
    from bild_jax.amis.dirichlet import dirichlet_estimate

    ss = rng.dirichlet(np.ones(5) * 3.0, size=4096)
    lw = rng.normal(size=4096)
    got = np.asarray(dirichlet_estimate(jnp.asarray(ss, jnp.float32),
                                        jnp.asarray(lw, jnp.float32)))
    w = np.exp(lw - lw.max())
    w /= w.sum()
    m = w @ ss
    v = w @ (ss - m) ** 2
    want = (np.mean(m * (1 - m) / v) - 1) * m
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("N,d,n,errors", [(20, 3, 2, [0.08, 0.1, 0.12]),
                                          (8, 1, 3, [0.2])])
def test_cuda_kernel_matches_scan(rng, N, d, n, errors):
    """The CUDA kernel against the float32 XLA scan: vmapped over
    trajectories (its own blocks each), with missing frames, and NaN for
    out-of-range states."""
    from bild_jax.models import MultiStateRouse
    from bild_jax.ops.kalman import msrouse_logL_batch
    from bild_jax.ops.kalman_cuda import msrouse_logL_cuda

    model = MultiStateRouse(N, 1.0, 5.0, d=d,
                            looppositions=(None, (0, -1), (0, N // 2))[:n],
                            localization_error=errors)
    T, B = 70, 3
    trajs = [model.trajectory_from_loopingprofile(
        (np.arange(T) // (20 + b)) % n, missing_frames=7,
        key=jax.random.key(b)) for b in range(B)]
    s2, Cind = model._noise_arrays(trajs[0])
    head = (model.Bs, model.Gs, model._filter_Sigs, model.M0s, model.C0s,
            model.w, s2, Cind)
    profiles = rng.integers(0, n, size=(B, 40, T)).astype(np.int32)
    profiles[0, 3, 10] = n
    profiles[2, 5, 0] = -1
    ys = jnp.stack([t.data for t in trajs])
    valid = jnp.stack([t.valid for t in trajs])

    def run(fn):
        return np.asarray(jax.jit(jax.vmap(
            lambda p, y, v: fn(*head, p, y, v)))(profiles, ys, valid))

    got, want = run(msrouse_logL_cuda), run(msrouse_logL_batch)
    assert np.isnan(got[0, 3]) and np.isnan(got[2, 5])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)


def test_cuda_kernel_batch_beyond_grid_rows(rng):
    """The fused lockstep runner vmaps over k and trajectories: at k_max=10
    and 6,000 trajectories the kernel sees 66,000 batch elements, more than
    a CUDA grid's y dimension holds (65,535)."""
    from bild_jax.models import MultiStateRouse
    from bild_jax.ops.kalman import msrouse_logL_batch
    from bild_jax.ops.kalman_cuda import msrouse_logL_cuda

    model = MultiStateRouse(20, 1.0, 5.0, d=3, looppositions=(None, (0, -1)),
                            localization_error=0.1)
    K1, B, P, T = 11, 6000, 2, 16
    traj = model.trajectory_from_loopingprofile(np.arange(T) // 8,
                                                key=jax.random.key(0))
    s2, Cind = model._noise_arrays(traj)
    head = (model.Bs, model.Gs, model._filter_Sigs, model.M0s, model.C0s,
            model.w, s2, Cind)
    profiles = rng.integers(0, 2, size=(K1, B, P, T)).astype(np.int32)
    ys = traj.data[None] + 0.01 * jnp.arange(B, dtype=jnp.float32)[:, None,
                                                                     None]
    valid = jnp.broadcast_to(traj.valid, (B, T))

    def run(fn):
        per_traj = jax.vmap(lambda p, y, v: fn(*head, p, y, v))
        return np.asarray(jax.jit(jax.vmap(per_traj, in_axes=(0, None, None)))(
            profiles, ys, valid))

    got, want = run(msrouse_logL_cuda), run(msrouse_logL_batch)
    assert got.shape == (K1, B, P) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
