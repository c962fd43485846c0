"""Dataset-mode hardening: true-length evidence guard, mesh padding for
non-divisible B, per-k checkpoint/resume, vectorized informed init, strict
shard_batch."""
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # heavy integration lane
import jax
import jax.numpy as jnp

from bild_jax import Trajectory
from bild_jax.models import FactorizedModel
from bild_jax.parallel import (make_mesh, pad_batch_rows, sample_batch,
                               shard_batch, stack_trajectories)
from scipy import stats as sp_stats


def _model():
    return FactorizedModel([sp_stats.maxwell(scale=0.1),
                            sp_stats.maxwell(scale=1.0)])


def _trajs(rng, lengths):
    out = []
    for i, T in enumerate(lengths):
        mags = np.where(rng.random(T) < 0.5, 0.05, 3.0)
        out.append(Trajectory.create(mags))
    return out


class TestTrueLengthGuard:
    def test_padded_short_traj_gets_neg_inf(self, rng):
        # a 4-frame trajectory padded into a 12-frame bucket: k >= 4 must be
        # -inf for it (matching adaptive mode), while the 12-frame rows keep
        # finite evidence up to k_max
        trajs = _trajs(rng, [4, 12, 12])
        batch = stack_trajectories(trajs)  # pads to 12
        res = sample_batch(_model(), batch, k_max=6, steps_per_k=4, N=16,
                           key=jax.random.key(0))
        assert np.all(np.isinf(res.evidence[0, 4:]))
        assert np.all(res.evidence[0, 4:] < 0)
        assert np.all(np.isfinite(res.evidence[0, :4]))
        assert np.all(np.isfinite(res.evidence[1:, :]))
        assert res.best_k()[0] < 4


class TestBucketTailTrim:
    def test_results_restore_bucket_length(self, rng):
        # all trajectories shorter than the bucket: the kernel runs at the
        # trimmed length, results come back edge-padded to the bucket T
        model = _model()
        trajs = _trajs(rng, [9, 11, 10])
        batch = stack_trajectories(trajs, T_pad=16)
        res = sample_batch(model, batch, k_max=2, steps_per_k=5, N=20,
                           marginals=True, key=jax.random.key(0))
        assert res.map_profiles.shape == (3, 3, 16)
        # trailing frames carry the edge state
        bp = res.best_profile()
        for row, T in enumerate([9, 11, 10]):
            assert np.all(bp[row, T:] == bp[row, T - 1])
        # padded marginals stay normalized (uniform)
        from scipy.special import logsumexp
        with np.errstate(under="ignore"):
            lp = res.log_marginal_posterior(dE=0)
            np.testing.assert_array_almost_equal(
                logsumexp(lp, axis=1), np.zeros((3, 16)), decimal=6)


class TestMeshPadding:
    def test_non_divisible_B(self, rng):
        # B=5 on a 4-device data axis: padded internally, results stripped
        mesh = make_mesh((4, 1))
        trajs = _trajs(rng, [8] * 5)
        batch = stack_trajectories(trajs)
        res = sample_batch(_model(), batch, k_max=2, steps_per_k=4, N=16,
                           mesh=mesh, key=jax.random.key(1))
        assert res.evidence.shape == (5, 3)
        assert np.all(np.isfinite(res.evidence))

    def test_shard_batch_raises_on_non_divisible(self):
        mesh = make_mesh((4, 1))
        with pytest.raises(ValueError, match="not divisible"):
            shard_batch((jnp.zeros((5, 3)),), mesh)

    def test_pad_batch_rows(self, rng):
        batch = stack_trajectories(_trajs(rng, [6, 6]))
        padded = pad_batch_rows(batch, 2)
        assert padded.B == 4
        assert not np.any(np.asarray(padded.valid[2:]))
        np.testing.assert_array_equal(np.asarray(padded.lengths), [6, 6, 0, 0])


class TestCheckpointResume:
    def test_resume_matches_uninterrupted(self, rng, tmp_path):
        trajs = _trajs(rng, [8] * 3)
        batch = stack_trajectories(trajs)
        kw = dict(k_max=3, steps_per_k=4, N=16, marginals=True)

        ref = sample_batch(_model(), batch, key=jax.random.key(7), **kw)

        # interrupted run: monkeypatch the runner loop by running only to
        # k=1 via a checkpoint, then resuming
        path = str(tmp_path / "ck.npz")
        model = _model()

        # first run writes checkpoints; simulate a kill by truncating the
        # checkpoint back to next_k=2 and rerunning
        full = sample_batch(model, batch, key=jax.random.key(7),
                            checkpoint=path, **kw)
        ck = dict(np.load(path))
        assert int(ck["next_k"]) == 4

        # key state as it was when the k=1 checkpoint was written: the loop
        # splits once per completed k
        key2 = jax.random.key(7)
        for _ in range(2):
            key2, _ = jax.random.split(key2)
        np.savez(path, config=ck["config"], next_k=2,
                 evs=ck["evs"][:2], maps=ck["maps"][:2],
                 margs=ck["margs"][:2],
                 key_data=np.asarray(jax.random.key_data(key2)))
        resumed = sample_batch(model, batch, key=jax.random.key(7),
                               checkpoint=path, **kw)

        np.testing.assert_array_equal(resumed.evidence, full.evidence)
        np.testing.assert_array_equal(resumed.map_profiles, full.map_profiles)
        np.testing.assert_array_equal(resumed.marginals, full.marginals)
        np.testing.assert_array_equal(full.evidence, ref.evidence)

    def test_config_mismatch_raises(self, rng, tmp_path):
        batch = stack_trajectories(_trajs(rng, [8] * 2))
        path = str(tmp_path / "ck.npz")
        model = _model()
        sample_batch(model, batch, k_max=2, steps_per_k=4, N=16,
                     key=jax.random.key(0), checkpoint=path)
        with pytest.raises(ValueError, match="different"):
            sample_batch(model, batch, k_max=3, steps_per_k=4, N=16,
                         key=jax.random.key(0), checkpoint=path)

    def test_content_tag_mismatch_raises(self, rng, tmp_path):
        """Same shapes/schedule but different data, PRNG key, or model
        parameters must be rejected — resuming would silently mix results
        from two different runs."""
        trajs = _trajs(rng, [8] * 2)
        batch = stack_trajectories(trajs)
        path = str(tmp_path / "ck.npz")
        kw = dict(k_max=2, steps_per_k=4, N=16, checkpoint=path)
        sample_batch(_model(), batch, key=jax.random.key(0), **kw)

        with pytest.raises(ValueError, match="tag"):
            sample_batch(_model(), batch, key=jax.random.key(1), **kw)
        other = FactorizedModel([sp_stats.maxwell(scale=0.2),
                                 sp_stats.maxwell(scale=1.0)])
        with pytest.raises(ValueError, match="tag"):
            sample_batch(other, batch, key=jax.random.key(0), **kw)
        batch2 = stack_trajectories(_trajs(rng, [8] * 2))  # fresh draws
        with pytest.raises(ValueError, match="tag"):
            sample_batch(_model(), batch2, key=jax.random.key(0), **kw)
        # identical everything still resumes cleanly (no-op: complete)
        res = sample_batch(_model(), batch, key=jax.random.key(0), **kw)
        assert np.all(np.isfinite(res.evidence))


class TestVectorizedInformedInit:
    def test_informed_matches_feasibility_and_runs(self, rng):
        # informed init must seed feasible (b, k) pairs and leave results
        # finite; equivalence of the underlying DP is covered in
        # test_segment.py / the batched-DP parity test
        from bild_jax.parallel.batch import _informed_proposals_all_k
        model = _model()
        trajs = _trajs(rng, [10] * 4)
        batch = stack_trajectories(trajs)
        out = _informed_proposals_all_k(model, batch, K1=4, n=2, T=10)
        assert out is not None
        a_inf, logp_inf, feas = out
        assert a_inf.shape == (4, 4, 4)
        assert logp_inf.shape == (4, 4, 2, 4)
        assert np.all(np.isfinite(a_inf))
        # k=0 always feasible
        assert np.all(feas[0])

        res = sample_batch(model, batch, k_max=3, steps_per_k=4, N=16,
                           informed_init=True, key=jax.random.key(3))
        assert np.all(np.isfinite(res.evidence))

    def test_batched_dp_matches_serial(self, rng):
        from bild_jax.infer.segment import dp_segment_all, dp_segment_all_batch
        B, n, T, kmax = 9, 3, 25, 5
        tables = rng.normal(size=(B, n, T))
        tables[1, :, 3] = np.nan
        trans = ~np.eye(n, dtype=bool)
        trans[0, 2] = False
        profs, feas = dp_segment_all_batch(tables, kmax, trans)
        frames = np.arange(T)
        clean = np.nan_to_num(tables, nan=0.0)
        for b in range(B):
            ref_p, _ = dp_segment_all(tables[b], kmax, trans)
            for k in range(kmax + 1):
                if ref_p[k] is None:
                    assert not feas[k, b]
                    continue
                assert feas[k, b]
                got = clean[b][profs[k, b], frames].sum()
                want = clean[b][ref_p[k], frames].sum()
                assert np.isclose(got, want)
                assert np.sum(profs[k, b][1:] != profs[k, b][:-1]) == k

    def test_batched_st_matches_serial(self, rng):
        from bild_jax.infer.segment import profile_to_st, profiles_to_st_batch
        profs = np.array([[0, 0, 1, 1, 2, 2, 0, 0],
                          [1, 1, 0, 0, 2, 2, 2, 1],
                          [0, 1, 1, 1, 1, 1, 2, 0]])
        fr, th = profiles_to_st_batch(profs, 3)
        for i in range(3):
            f1, t1 = profile_to_st(profs[i])
            np.testing.assert_array_equal(fr[i], f1)
            np.testing.assert_array_equal(th[i], t1)
