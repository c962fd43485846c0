"""Multi-device tests: lockstep batched inference sharded over the virtual
8-device CPU mesh (capability the reference lacks; SURVEY.md section 2,
parallelism inventory)."""
import numpy as np
import jax
import pytest
from scipy import stats as sp_stats

pytestmark = pytest.mark.slow  # heavy integration lane

import bild_jax as bild
from bild_jax.models import FactorizedModel, MultiStateRouse
from bild_jax.parallel import make_mesh, stack_trajectories, sample_batch
from bild_jax import Trajectory


def _factorized_batch(B=8, T=8):
    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)], d=1)
    rng = np.random.default_rng(0)
    trajs, true_ks = [], []
    for i in range(B):
        prof = np.zeros(T, dtype=int)
        if i % 2 == 1:
            prof[T // 2:] = 1  # one switch
        traj = model.trajectory_from_loopingprofile(
            prof, key=jax.random.key(100 + i))
        trajs.append(traj)
        true_ks.append(int(np.sum(prof[1:] != prof[:-1])))
    return model, trajs, np.array(true_ks)


def test_stack_trajectories_padding():
    t1 = Trajectory.create(np.ones((4, 1)))
    t2 = Trajectory.create(np.ones((7, 1)))
    batch = stack_trajectories([t1, t2])
    assert batch.data.shape == (2, 7, 1)
    assert batch.valid[0, 4:].sum() == 0  # padding invalid
    assert batch.valid[1].sum() == 7


def test_sample_batch_factorized():
    model, trajs, true_ks = _factorized_batch()
    batch = stack_trajectories(trajs)
    res = sample_batch(model, batch, k_max=3, steps_per_k=10, N=50,
                       key=jax.random.key(0))
    assert res.evidence.shape == (8, 4)
    best = res.best_k()
    # evidence should at least distinguish 0-switch from 1-switch trajectories
    assert np.all(best[true_ks == 0] == 0)
    assert np.all(best[true_ks == 1] >= 1)

    profs = res.best_profile()
    assert profs.shape == (8, 8)


def test_sample_batch_scout_refine():
    """Two-phase schedule: same decisions as the full schedule, structural
    invariants hold (refined rows overwrite scouted rows; marginals stay
    normalized at refined k)."""
    model, trajs, true_ks = _factorized_batch()
    batch = stack_trajectories(trajs)
    kw = dict(k_max=3, steps_per_k=10, N=50, marginals=True)
    full = sample_batch(model, batch, key=jax.random.key(0), **kw)
    scout = sample_batch(model, batch, key=jax.random.key(0),
                         scout_steps=3, refine_top=2, **kw)
    assert scout.evidence.shape == full.evidence.shape
    assert np.all(scout.best_k()[true_ks == 0] == 0)
    assert np.all(scout.best_k()[true_ks == 1] >= 1)
    # each trajectory's best k was refined: its evidence must carry the
    # full-schedule error bar scale, not the scout's
    bk = scout.best_k()
    assert np.all(np.isfinite(scout.evidence[np.arange(8), bk]))
    # scout with refine_top >= nk refines everything; warm-start refine
    # continues each scout chain with the same PRNG stream, so this is
    # BIT-IDENTICAL to the straight full schedule
    all_ref = sample_batch(model, batch, key=jax.random.key(0),
                           scout_steps=2, refine_top=10, **kw)
    np.testing.assert_array_equal(all_ref.evidence, full.evidence)
    np.testing.assert_array_equal(all_ref.map_profiles, full.map_profiles)
    np.testing.assert_array_equal(all_ref.marginals, full.marginals)
    assert np.all(all_ref.best_k()[true_ks == 0] == 0)


def test_sample_batch_scout_short_trajectory():
    """A trajectory shorter than some k values forces non-finite scout
    evidence for those (trajectory, k) lanes; the refine selection pads
    them with duplicates of the best lane (the `bad` mask path). Results
    must stay sane: -inf at unidentifiable k, finite elsewhere."""
    model, trajs, _ = _factorized_batch(B=4, T=8)
    # replace row 0 with a 3-frame trajectory padded into the 8-bucket
    short = model.trajectory_from_loopingprofile(
        np.zeros(3, dtype=int), key=jax.random.key(7))
    batch = stack_trajectories([short] + trajs[1:])
    res = sample_batch(model, batch, k_max=4, steps_per_k=6, N=30,
                       scout_steps=2, refine_top=4, key=jax.random.key(3))
    # k >= len(short)=3 is unidentifiable for row 0
    assert np.all(np.isneginf(res.evidence[0, 3:]))
    assert np.all(np.isfinite(res.evidence[0, :3]))
    # the full-length rows keep finite evidence at every k < T
    assert np.all(np.isfinite(res.evidence[1:, :5]))
    assert res.best_k()[0] == 0


def test_sample_batch_scout_checkpoint_incompatible(tmp_path):
    model, trajs, _ = _factorized_batch(B=2)
    batch = stack_trajectories(trajs)
    with pytest.raises(ValueError, match="scout_steps"):
        sample_batch(model, batch, k_max=2, steps_per_k=4, N=10,
                     scout_steps=2, checkpoint=str(tmp_path / "ck.npz"),
                     key=jax.random.key(0))


def test_sample_batch_sharded_over_mesh():
    model, trajs, true_ks = _factorized_batch()
    batch = stack_trajectories(trajs)
    mesh = make_mesh(shape=(8, 1))
    assert mesh.devices.size == 8
    res = sample_batch(model, batch, k_max=2, steps_per_k=8, N=30,
                       key=jax.random.key(1), mesh=mesh)
    # sharded run must agree with itself structurally and distinguish k
    assert np.all(res.best_k()[true_ks == 0] == 0)
    # scout/refine under a mesh (refine re-shards the tiled batch)
    res2 = sample_batch(model, batch, k_max=2, steps_per_k=8, N=30,
                        key=jax.random.key(1), mesh=mesh,
                        scout_steps=3, refine_top=2)
    assert np.all(res2.best_k()[true_ks == 0] == 0)


def test_sample_batch_sharding_invariance_bitexact():
    """Data parallelism must not change the math: mesh-sharded
    `sample_batch` is BIT-IDENTICAL to the unsharded run — on a pure data
    mesh (8,1) and on a 2-axis data x prof mesh (4,2) like the driver
    dryrun's, for both the fused and the scout/refine schedules. (Promoted
    from bench_scaling.py per VERDICT r3 weak-spot 3: the strongest
    multi-chip correctness claim belongs in the suite.)"""
    model, trajs, _ = _factorized_batch()
    batch = stack_trajectories(trajs)
    kw = dict(k_max=2, steps_per_k=6, N=24, marginals=True,
              key=jax.random.key(11))
    skw = dict(kw, scout_steps=2, refine_top=2)
    ref = sample_batch(model, batch, **kw)
    ref_s = sample_batch(model, batch, **skw)
    for shape in ((8, 1), (4, 2)):
        mesh = make_mesh(shape=shape, axis_names=("data", "prof"))
        res = sample_batch(model, batch, mesh=mesh, **kw)
        res_s = sample_batch(model, batch, mesh=mesh, **skw)
        for a, b in ((res, ref), (res_s, ref_s)):
            np.testing.assert_array_equal(a.evidence, b.evidence,
                                          err_msg=str(shape))
            np.testing.assert_array_equal(a.evidence_se, b.evidence_se)
            np.testing.assert_array_equal(a.map_profiles, b.map_profiles)
            np.testing.assert_array_equal(a.marginals, b.marginals)


def test_sample_batch_marginals():
    from scipy.special import logsumexp

    model, trajs, true_ks = _factorized_batch(B=4)
    batch = stack_trajectories(trajs)
    res = sample_batch(model, batch, k_max=2, steps_per_k=8, N=30,
                       key=jax.random.key(3), marginals=True)
    for dE in (None, 2, "average"):
        with np.errstate(under="ignore"):
            logpost = res.log_marginal_posterior(dE=dE)  # (B, n, T)
            assert logpost.shape == (4, 2, 8)
            np.testing.assert_array_almost_equal(
                logsumexp(logpost, axis=1), np.zeros((4, 8)), decimal=6)


def test_sample_batch_rouse():
    model = MultiStateRouse(10, 1, 5, d=1, localization_error=0.3)
    T = 20
    prof0 = np.zeros(T, dtype=int)
    prof1 = np.zeros(T, dtype=int)
    prof1[8:14] = 1
    trajs = [model.trajectory_from_loopingprofile(p, key=jax.random.key(i))
             for i, p in enumerate([prof0, prof1, prof0, prof1])]
    batch = stack_trajectories(trajs)
    res = sample_batch(model, batch, k_max=3, steps_per_k=8, N=50,
                       key=jax.random.key(2))
    assert res.evidence.shape == (4, 4)
    assert np.all(np.isfinite(res.evidence))
    # constant trajectories prefer k=0
    assert np.all(res.best_k()[[0, 2]] == 0)


def test_sample_batch_k_exceeding_T_is_skipped():
    """k >= T samplers short-circuit to -inf evidence (reference degeneracy
    guard, `bild/amis.py:641-648`) inside the lockstep driver too."""
    from bild_jax.parallel import sample_batch, stack_trajectories

    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)], d=1)
    trajs = [model.trajectory_from_loopingprofile(
        np.zeros(4, dtype=int), key=jax.random.key(i)) for i in range(3)]
    batch = stack_trajectories(trajs)
    res = sample_batch(model, batch, k_max=5, steps_per_k=3, N=8,
                       informed_init=False, key=jax.random.key(1))
    assert res.evidence.shape == (3, 6)
    # k = 4, 5 >= T = 4: impossible switch counts are -inf, never the best
    assert np.all(np.isneginf(res.evidence[:, 4:]))
    assert np.all(res.best_k() < 4)


def test_sample_batch_ensemble():
    """ensemble=M returns the M highest-weight posterior samples per
    (trajectory, k): shapes, descending weights, normalization in
    `profile_ensemble`, bit-identity of all other outputs with an
    ensemble=0 run, and equality across the fused / scouted / per-k
    checkpoint paths."""
    import os
    import tempfile

    from bild_jax.parallel import sample_batch, stack_trajectories

    model = MultiStateRouse(5, 1.0, 5.0, d=1, localization_error=0.1)
    prof = np.zeros(30, dtype=int)
    prof[10:20] = 1
    trajs = [model.trajectory_from_loopingprofile(prof, key=jax.random.key(i))
             for i in range(3)]
    batch = stack_trajectories(trajs)

    res = sample_batch(model, batch, k_max=3, steps_per_k=5, N=32,
                       key=jax.random.key(0), ensemble=8)
    assert res.top_profiles.shape == (4, 3, 8, 30)
    assert res.top_logw.shape == (4, 3, 8)
    assert (np.diff(res.top_logw, axis=-1) <= 1e-12).all()   # sorted desc
    profs, w = res.profile_ensemble()
    assert profs.shape == (3, 8, 30) and w.shape == (3, 8)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-12)

    # requesting the ensemble must not perturb anything else
    res0 = sample_batch(model, batch, k_max=3, steps_per_k=5, N=32,
                        key=jax.random.key(0))
    np.testing.assert_array_equal(res.evidence, res0.evidence)
    np.testing.assert_array_equal(res.map_profiles, res0.map_profiles)
    assert res0.top_profiles is None
    with pytest.raises(ValueError, match="ensemble"):
        res0.profile_ensemble()

    # scout/refine path carries the ensemble too
    res_s = sample_batch(model, batch, k_max=3, steps_per_k=5, N=32,
                         scout_steps=2, refine_top=2,
                         key=jax.random.key(0), ensemble=8)
    _, w2 = res_s.profile_ensemble()
    np.testing.assert_allclose(w2.sum(axis=1), 1.0, rtol=1e-12)

    # per-k checkpoint path: identical tops to the fused path, and a
    # resumed rerun reproduces them bit-for-bit
    with tempfile.TemporaryDirectory() as tdir:
        ck = os.path.join(tdir, "ck.npz")
        r1 = sample_batch(model, batch, k_max=3, steps_per_k=5, N=32,
                          key=jax.random.key(0), ensemble=8, checkpoint=ck)
        r2 = sample_batch(model, batch, k_max=3, steps_per_k=5, N=32,
                          key=jax.random.key(0), ensemble=8, checkpoint=ck)
        np.testing.assert_array_equal(r1.top_profiles, res.top_profiles)
        np.testing.assert_array_equal(r2.top_profiles, r1.top_profiles)
        np.testing.assert_array_equal(r2.top_logw, r1.top_logw)

    # cap: a lane only ever accumulates steps_per_k * N samples
    with pytest.raises(ValueError, match="ensemble"):
        sample_batch(model, batch, k_max=2, steps_per_k=2, N=8, ensemble=17)
