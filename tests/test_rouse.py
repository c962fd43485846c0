"""Rouse physics tests: self-consistency of the derived linear-Gaussian
dynamics (the reference treats these as a black box from the `rouse` package;
SURVEY.md 2.17)."""
import numpy as np
import jax
import jax.numpy as jnp

from bild_jax.physics import RouseModel, two_locus_msd


def _model(**kw):
    defaults = dict(N=10, D=1.0, k=3.0, d=2, dt=1.0)
    defaults.update(kw)
    return RouseModel(**defaults)


def test_steady_state_is_fixed_point():
    for bonds in (None, ((0, -1),), ((0, -1, 2.0), (2, 5)), ((3, 4, -1),)):
        m = _model(add_bonds=bonds)
        C = np.asarray(m.C_ss)
        # C_ss = B C_ss B^T + Sig  (free modes handled separately: their
        # steady variance is pinned to 0 but their noise keeps acting)
        prop = np.asarray(m.B) @ C @ np.asarray(m.B).T + np.asarray(m.Sig)
        # project out free modes (nullspace of A): for the default chain the
        # free mode is the center of mass
        lam, V = np.linalg.eigh(np.asarray(m.B))
        free = lam > 1 - 1e-10  # eigenvalue 1 <=> free mode
        P = np.eye(m.N) - (V[:, free] @ V[:, free].T)
        np.testing.assert_allclose(P @ prop @ P.T, P @ C @ P.T, atol=1e-10)


def test_propagation_converges_to_steady_state():
    m = _model(add_bonds=((0, -1),))
    # start from a weird covariance; measured (bonded) subspace must converge
    C = 5.0 * np.eye(m.N) + 0.3
    M = np.outer(np.linspace(-1, 1, m.N), np.ones(m.d))
    for _ in range(200):
        M = np.asarray(m.propagate_M(jnp.asarray(M)))
        C = np.asarray(m.propagate_C(jnp.asarray(C)))
    w = np.zeros(m.N)
    w[0], w[-1] = -1, 1
    np.testing.assert_allclose(w @ C @ w, w @ np.asarray(m.C_ss) @ w, rtol=1e-8)
    np.testing.assert_allclose(w @ M, 0.0, atol=1e-8)


def test_loop_tightens_end2end_distance():
    free = _model(add_bonds=None)
    looped = _model(add_bonds=((0, -1),))
    w = np.zeros(10)
    w[0], w[-1] = -1, 1
    var_free = w @ np.asarray(free.C_ss) @ w
    var_loop = w @ np.asarray(looped.C_ss) @ w
    assert var_loop < var_free


def test_bond_removal_disconnects():
    # removing a backbone bond -> extra free mode; still finite dynamics
    m = _model(add_bonds=((4, 5, -1),))
    assert np.all(np.isfinite(np.asarray(m.C_ss)))
    assert np.all(np.isfinite(np.asarray(m.Sig)))
    # two zero modes now (two disconnected fragments)
    lamB = np.linalg.eigvalsh(np.asarray(m.B))
    assert np.sum(lamB > 1 - 1e-12) == 2


def test_sampling_matches_moments():
    m = _model(N=5, d=3, add_bonds=((0, -1),))
    key = jax.random.key(0)
    confs = jax.vmap(m.conf_ss)(jax.random.split(key, 20000))  # (S, N, d)
    flat = np.asarray(confs).transpose(1, 0, 2).reshape(m.N, -1)
    C_emp = np.cov(flat)
    np.testing.assert_allclose(C_emp, np.asarray(m.C_ss), atol=0.05)

    # evolve preserves the steady state ensemble
    k1, k2 = jax.random.split(jax.random.key(1))
    confs2 = jax.vmap(m.evolve)(confs, jax.random.split(k2, confs.shape[0]))
    flat2 = np.asarray(confs2).transpose(1, 0, 2).reshape(m.N, -1)
    w = np.array([-1.0, 0, 0, 0, 1.0])
    np.testing.assert_allclose(np.var(w @ flat2), w @ np.asarray(m.C_ss) @ w, rtol=0.05)


def test_two_locus_msd_limits():
    G, J = 2.0, 5.0
    t_small = np.array([1e-8])
    np.testing.assert_allclose(two_locus_msd(t_small, G, J), G * np.sqrt(t_small), rtol=1e-6)
    assert abs(two_locus_msd(1e14, G, J) - 2 * J) < 1e-4  # plateau approached as 1/sqrt(t)
    assert two_locus_msd(np.inf, G, J) == 2 * J
    assert two_locus_msd(0.0, G, J) == 0.0
    # monotone increasing
    ts = np.logspace(-3, 6, 200)
    msd = two_locus_msd(ts, G, J)
    assert np.all(np.diff(msd) > 0)
