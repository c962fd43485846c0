"""`sample_dataset`: bucketing + chunking + original-order reassembly +
chunk-granular checkpoint resume."""
import os

import numpy as np
import jax
import pytest

pytestmark = pytest.mark.slow  # heavy integration lane
from scipy import stats as sp_stats

from bild_jax.models import FactorizedModel
from bild_jax.parallel import sample_dataset


def _ragged_set():
    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)], d=1)
    lengths = [8, 14, 8, 11, 14, 8]          # two buckets (<=8, <=16)
    trajs, true_ks = [], []
    for i, T in enumerate(lengths):
        prof = np.zeros(T, dtype=int)
        if i % 2 == 1:
            prof[T // 2:] = 1
        trajs.append(model.trajectory_from_loopingprofile(
            prof, key=jax.random.key(50 + i)))
        true_ks.append(int(np.sum(prof[1:] != prof[:-1])))
    return model, trajs, np.array(true_ks), lengths


def test_sample_dataset_order_and_lengths():
    model, trajs, true_ks, lengths = _ragged_set()
    res = sample_dataset(model, trajs, k_max=3, steps_per_k=8, N=30,
                         bucket_edges=(8, 16), chunk_size=2,
                         informed_init=False, key=jax.random.key(0))
    assert res.evidence.shape == (6, 4)
    best = res.best_profile()
    # original order and true lengths restored despite bucket regrouping
    for p, T in zip(best, lengths):
        assert p.shape == (T,)
    bk = res.best_k()
    assert np.all(bk[true_ks == 0] == 0)
    assert np.all(bk[true_ks == 1] >= 1)


def test_sample_dataset_marginals_normalized():
    model, trajs, _, lengths = _ragged_set()
    res = sample_dataset(model, trajs, k_max=2, steps_per_k=6, N=20,
                         bucket_edges=(8, 16), marginals=True,
                         informed_init=False, key=jax.random.key(1))
    from scipy.special import logsumexp
    with np.errstate(under="ignore"):
        for lp, T in zip(res.log_marginal_posterior(dE="average"), lengths):
            assert lp.shape == (2, T)
            np.testing.assert_array_almost_equal(
                logsumexp(lp, axis=0), np.zeros(T), decimal=6)


def test_sample_dataset_checkpoint_resume(tmp_path):
    model, trajs, _, _ = _ragged_set()
    kw = dict(k_max=2, steps_per_k=6, N=20, bucket_edges=(8, 16),
              chunk_size=2, informed_init=False,
              checkpoint_dir=str(tmp_path))
    r1 = sample_dataset(model, trajs, key=jax.random.key(2), **kw)
    files = sorted(os.listdir(tmp_path))
    # 3 trajs per bucket at chunk_size=2 -> 2 chunks per bucket
    assert len(files) == 4
    mtimes = {f: os.path.getmtime(tmp_path / f) for f in files}

    r2 = sample_dataset(model, trajs, key=jax.random.key(2), **kw)
    np.testing.assert_array_equal(r1.evidence, r2.evidence)
    for a, b in zip(r1.profiles_by_k, r2.profiles_by_k):
        np.testing.assert_array_equal(a, b)
    # resumed, not recomputed: files untouched
    for f in files:
        assert os.path.getmtime(tmp_path / f) == mtimes[f]

    # a different key -> different tags -> fresh compute, no stale mixing
    r3 = sample_dataset(model, trajs, key=jax.random.key(3), **kw)
    assert len(os.listdir(tmp_path)) > len(files)
    assert r3.evidence.shape == r1.evidence.shape


def test_sample_dataset_scout_schedule():
    model, trajs, true_ks, _ = _ragged_set()
    res = sample_dataset(model, trajs, k_max=3, steps_per_k=8, N=30,
                         bucket_edges=(8, 16), scout_steps=3, refine_top=2,
                         informed_init=False, key=jax.random.key(4))
    assert np.all(res.best_k()[true_ks == 0] == 0)


def test_sample_dataset_optimize_boundaries():
    model, trajs, true_ks, lengths = _ragged_set()
    res = sample_dataset(model, trajs, k_max=2, steps_per_k=6, N=20,
                         bucket_edges=(8, 16), informed_init=False,
                         optimize_boundaries=True, key=jax.random.key(5))
    assert res.optimized is not None and res.eliminated is not None
    for p, T in zip(res.optimized, lengths):
        assert p.shape == (T,)
    # optimized profiles keep the boundary count of the MAP profiles
    for p, bp in zip(res.optimized, res.best_profile()):
        assert np.sum(p[1:] != p[:-1]) == np.sum(bp[1:] != bp[:-1])


def test_sample_kw_keys_checkpoints_and_ensemble_rejected(tmp_path):
    """Extra sample_batch kwargs must key the chunk checkpoints (a rerun
    with e.g. a different mom_maxiter would otherwise silently load stale
    results), and ensemble= is rejected rather than silently dropped."""
    model, trajs, _, _ = _ragged_set()
    ckdir = str(tmp_path / "ck")
    kw = dict(k_max=2, steps_per_k=3, N=16, informed_init=False,
              key=jax.random.key(0), checkpoint_dir=ckdir)
    sample_dataset(model, trajs, **kw)
    files1 = set(os.listdir(ckdir))
    sample_dataset(model, trajs, mom_maxiter=7, **kw)
    files2 = set(os.listdir(ckdir))
    # the kwarg-carrying run wrote NEW chunk files (different tags)
    assert files2 > files1

    # a re-parametrized model must also key new chunk files (its
    # likelihood_fingerprint enters the config hash) — same data/key
    other = FactorizedModel([sp_stats.maxwell(scale=0.15),
                             sp_stats.maxwell(scale=1)], d=1)
    sample_dataset(other, trajs, **kw)
    files3 = set(os.listdir(ckdir))
    assert files3 > files2

    with pytest.raises(ValueError, match="ensemble"):
        sample_dataset(model, trajs, ensemble=4, **kw)
