"""
Process-local sharded ingestion (`bild_jax.parallel.sharded`) — the
single-process properties. The real 2-process disjoint-shard run is
covered by ``tests/test_distributed.py::test_two_process_sharded_ingestion``
(slow lane).
"""
import numpy as np
import pytest

import jax

from bild_jax.models import FactorizedModel, MultiStateRouse
from bild_jax.parallel import (sample_batch, sample_dataset_sharded,
                               stack_trajectories)


@pytest.fixture(scope="module")
def factorized_setup():
    from scipy import stats as sp_stats
    np.random.seed(180357)
    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)], d=1)
    trajs = []
    for i, T in enumerate([8, 14, 8, 11, 14, 8]):
        prof = np.zeros(T, dtype=int)
        if i % 2 == 1:
            prof[T // 2:] = 1
        trajs.append(model.trajectory_from_loopingprofile(
            prof, key=jax.random.key(70 + i)))
    return model, trajs


KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
          informed_init=True, marginals=True)


def test_composition_and_order_invariance(factorized_setup):
    """A trajectory's result must not depend on where it lands: different
    chunk sizes and shuffled shard order give bit-identical results
    (id-keyed PRNG streams + row-independent math)."""
    model, trajs = factorized_setup
    ids = np.array([5, 17, 2, 30, 11, 8])
    r1 = sample_dataset_sharded(model, trajs, ids, mesh=None, chunk_size=2,
                                key=jax.random.key(7), **KW)
    r2 = sample_dataset_sharded(model, trajs, ids, mesh=None, chunk_size=4,
                                key=jax.random.key(7), **KW)
    perm = np.array([4, 2, 0, 5, 1, 3])
    r3 = sample_dataset_sharded(model, [trajs[i] for i in perm], ids[perm],
                                mesh=None, chunk_size=2,
                                key=jax.random.key(7), **KW)
    # results come back in ascending-id order
    np.testing.assert_array_equal(r1.ids, np.sort(ids))
    for other in (r2, r3):
        np.testing.assert_array_equal(r1.evidence, other.evidence)
        np.testing.assert_array_equal(r1.evidence_se, other.evidence_se)
        for a, b in zip(r1.profiles_by_k, other.profiles_by_k):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r1.marginals, other.marginals):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_resume(factorized_setup, tmp_path):
    model, trajs = factorized_setup
    ids = np.arange(6)
    kw = dict(KW, chunk_size=2, key=jax.random.key(9),
              checkpoint_dir=str(tmp_path))
    r1 = sample_dataset_sharded(model, trajs, ids, mesh=None, **kw)
    assert len(list(tmp_path.glob("shard_chunk_*.npz"))) > 0
    r2 = sample_dataset_sharded(model, trajs, ids, mesh=None, **kw)
    np.testing.assert_array_equal(r1.evidence, r2.evidence)
    for a, b in zip(r1.marginals, r2.marginals):
        np.testing.assert_array_equal(a, b)


def test_argument_guards(factorized_setup):
    model, trajs = factorized_setup
    with pytest.raises(ValueError, match="ids"):
        sample_dataset_sharded(model, trajs, np.arange(3), mesh=None, **KW)
    with pytest.raises(ValueError, match="duplicate"):
        sample_dataset_sharded(model, trajs, np.zeros(6, dtype=int),
                               mesh=None, **KW)
    with pytest.raises(ValueError, match=r"\[0, 2\^31\)"):
        sample_dataset_sharded(model, trajs, np.arange(6) - 3, mesh=None,
                               **KW)
    with pytest.raises(ValueError, match="no trajectories"):
        sample_dataset_sharded(model, [], [], mesh=None, **KW)


def test_row_keys_position_invariance():
    """`sample_batch(row_keys=...)`: shuffling batch rows permutes results
    exactly (no dependence on batch position)."""
    model = MultiStateRouse(8, 1.0, 5.0, d=2, localization_error=0.1)
    rng = np.random.default_rng(5)
    profs = np.zeros((6, 30), dtype=int)
    profs[::2, 10:20] = 1
    batch = model.trajectories_from_loopingprofiles(profs,
                                                    key=jax.random.key(1))
    base = jax.random.key(3)
    ids = np.array([4, 9, 1, 7, 2, 6], dtype=np.uint32)
    row_keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jax.numpy.asarray(ids))

    res = sample_batch(model, batch, k_max=2, steps_per_k=4, N=16,
                       key=base, row_keys=row_keys)

    perm = np.array([3, 1, 5, 0, 2, 4])
    from bild_jax.parallel.batch import TrajectoryBatch
    batch_p = TrajectoryBatch(data=batch.data[perm], valid=batch.valid[perm],
                              lengths=batch.lengths[perm])
    rk_p = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jax.numpy.asarray(ids[perm]))
    res_p = sample_batch(model, batch_p, k_max=2, steps_per_k=4, N=16,
                         key=base, row_keys=rk_p)
    np.testing.assert_array_equal(res.evidence[perm], res_p.evidence)
    np.testing.assert_array_equal(res.map_profiles[:, perm], res_p.map_profiles)


def test_informed_arrays_injection_matches_host_path(factorized_setup):
    """Precomputed informed arrays (the process-local feed path) reproduce
    the host-assembled informed_init exactly."""
    model, trajs = factorized_setup
    sub = [t for t in trajs if len(t) == 8]
    batch = stack_trajectories(sub)
    from bild_jax.parallel.batch import (_informed_proposals_all_k_impl)
    K1 = 4
    inf = _informed_proposals_all_k_impl(model, batch, K1, 2, batch.T)
    assert inf is not None
    r_host = sample_batch(model, batch, k_max=3, steps_per_k=4, N=16,
                          informed_init=True, key=jax.random.key(2))
    r_inj = sample_batch(model, batch, k_max=3, steps_per_k=4, N=16,
                         informed_init=False, informed_arrays=inf,
                         key=jax.random.key(2))
    np.testing.assert_array_equal(r_host.evidence, r_inj.evidence)
    np.testing.assert_array_equal(r_host.map_profiles, r_inj.map_profiles)

    with pytest.raises(ValueError, match="informed_arrays"):
        sample_batch(model, batch, k_max=3, steps_per_k=4, N=16,
                     informed_arrays=inf, checkpoint="x.npz",
                     key=jax.random.key(2))
