"""
Round-4 coverage: error branches and edge paths that the behavioral suites
skip — input-validation raises, fallback selection, container edge cases,
checkpoint restore of degenerate/pending samplers. Each test pins semantics
the library documents (and the reference implies), not just line hits.
"""
import os

import numpy as np
import pytest
import jax
from scipy import stats as sp_stats

import bild_jax as bild
from bild_jax import Trajectory, make_trajectory
from bild_jax.models import FactorizedModel
from bild_jax.models.base import MultiStateModel
from bild_jax.profiles import Loopingprofile


def _model():
    return FactorizedModel([sp_stats.maxwell(scale=0.1),
                            sp_stats.maxwell(scale=1.0)], d=1)


def _traj(T=8, seed=0):
    rng = np.random.default_rng(seed)
    return Trajectory.create(np.abs(rng.normal(size=T)) + 0.05)


# -- Trajectory / make_trajectory edge cases -------------------------------

class TestTrajectoryEdges:
    def test_bad_ndim_rejected(self):
        with pytest.raises(ValueError, match="should be"):
            Trajectory.create(np.zeros((2, 3, 4)))

    def test_bad_localization_error_shape(self):
        with pytest.raises(ValueError, match="localization_error"):
            Trajectory.create(np.zeros((5, 2)), localization_error=np.zeros(3))

    def test_three_locus_rejected(self):
        with pytest.raises(ValueError, match="locus"):
            make_trajectory(np.zeros((3, 5, 2)))

    def test_eq_non_trajectory(self):
        t = _traj()
        assert (t == 5) is False
        assert t != "str"

    def test_abs_magnitudes(self):
        data = np.array([[3.0, 4.0], [np.nan, np.nan], [0.0, 1.0]])
        t = Trajectory.create(data)
        a = t.abs()
        assert a.data.shape == (3, 1)
        np.testing.assert_allclose(np.asarray(a.data)[[0, 2], 0], [5.0, 1.0])
        np.testing.assert_array_equal(np.asarray(a.valid), [True, False, True])
        np.testing.assert_allclose(np.asarray(t.magnitudes())[0], 5.0)

    def test_dataframe_without_coordinates(self):
        pd = pytest.importorskip("pandas")
        with pytest.raises(ValueError, match="coordinate columns"):
            make_trajectory(pd.DataFrame({"a": [1.0, 2.0]}))

    def test_loopingprofile_metadata_coerced(self):
        t = Trajectory.create(np.zeros(4), loopingprofile=[0, 1, 1, 0])
        assert isinstance(t.loopingprofile, np.ndarray)


# -- io.py: loader validation + fallback selection --------------------------

class TestLoaderEdges:
    def _write(self, path, lines):
        path.write_text("\n".join(lines) + "\n")

    def test_two_locus_needs_even_columns(self, tmp_path):
        from bild_jax.io import load_trajectories_csv_python
        p = tmp_path / "odd.csv"
        self._write(p, ["0,0,1.0,2.0,3.0", "0,1,1.5,2.5,3.5"])
        with pytest.raises(ValueError, match="even number"):
            load_trajectories_csv_python(p, two_locus=True)

    def test_max_frames_guard(self, tmp_path):
        from bild_jax.io import load_trajectories_csv_python
        p = tmp_path / "long.csv"
        self._write(p, ["0,0,1.0", "0,99,2.0"])
        with pytest.raises(ValueError, match="max_frames"):
            load_trajectories_csv_python(p, max_frames=10)

    def test_missing_file_raises_precise_error(self, tmp_path):
        # the native parser reports failure by status; the fallback python
        # parse then produces the precise host error
        from bild_jax.io import load_trajectories_csv
        with pytest.raises(FileNotFoundError):
            load_trajectories_csv(tmp_path / "nope.csv")

    def test_python_path_when_native_unavailable(self, tmp_path, monkeypatch):
        from bild_jax import io as bio
        p = tmp_path / "ok.csv"
        self._write(p, ["# comment", "id,frame,x", "1,0,0.5", "1,2,1.5"])
        monkeypatch.setattr(bio.native, "get_lib", lambda: None)
        (t,) = bio.load_trajectories_csv(p)
        assert len(t) == 3  # frame gap materialized as missing frame
        assert t.count_valid_frames() == 2


# -- postproc edge semantics -------------------------------------------------

class TestPostprocEdges:
    def test_logLR_boundaries_constant_profile(self):
        from bild_jax.postproc import logLR_boundaries
        out = logLR_boundaries(Loopingprofile(np.zeros(6, dtype=int)),
                               _traj(6), _model())
        assert out.size == 0

    def test_optimize_boundary_max_iteration(self):
        from bild_jax.postproc import optimize_boundary
        prof = Loopingprofile(np.array([0, 0, 1, 1, 0, 0]))
        with pytest.raises(RuntimeError, match="max_iteration"):
            optimize_boundary(prof, _traj(6), _model(), max_iteration=0)

    def test_optimize_boundary_batch_no_boundaries(self):
        from bild_jax.parallel.batch import stack_trajectories
        from bild_jax.postproc import optimize_boundary_batch
        batch = stack_trajectories([_traj(6, seed=1), _traj(6, seed=2)])
        profs = np.zeros((2, 6), dtype=int)
        out, elim = optimize_boundary_batch(profs, batch, _model())
        np.testing.assert_array_equal(out, profs)
        assert not elim.any()

    def test_optimize_boundary_batch_max_iteration(self):
        from bild_jax.parallel.batch import stack_trajectories
        from bild_jax.postproc import optimize_boundary_batch
        batch = stack_trajectories([_traj(6, seed=1)])
        profs = np.array([[0, 0, 1, 1, 0, 0]])
        with pytest.raises(RuntimeError, match="max_iteration"):
            optimize_boundary_batch(profs, batch, _model(), max_iteration=0)


# -- MultiStateModel base fallbacks ------------------------------------------

class _TinyModel(MultiStateModel):
    """Minimal custom subclass: logL only — exercises every base fallback."""

    def __init__(self, n=2, d=1):
        self.init_transitions(n)
        self._d = d

    @property
    def d(self):
        return self._d

    def logL(self, loopingprofile, traj):
        # deterministic, profile-dependent, finite
        return -float(np.sum(loopingprofile[:])) - len(traj) * 0.1


class TestBaseFallbacks:
    def test_logL_batch_host_loop(self):
        m = _TinyModel()
        t = _traj(5)
        profs = np.array([[0] * 5, [1] * 5, [0, 1, 0, 1, 0]])
        out = m.logL_batch(profs, t)
        np.testing.assert_allclose(
            out, [m.logL(Loopingprofile(p), t) for p in profs])

    def test_default_initial_loopingprofile(self):
        m = _TinyModel(n=3)
        prof = m.initial_loopingprofile(_traj(7))
        assert len(prof) == 7
        assert set(np.asarray(prof[:])) <= {0, 1, 2}

    def test_segment_guess_none_without_table(self):
        assert _TinyModel().segment_guess(_traj(5), 1) is None

    def test_fingerprint_none_for_custom_model(self):
        assert _TinyModel().likelihood_fingerprint() is None

    def test_preproc_localization_error(self):
        m = _TinyModel(d=2)
        np.testing.assert_allclose(
            m._preproc_localization_error(0.5), [0.5, 0.5])
        with pytest.raises(ValueError, match="localization_error"):
            m._preproc_localization_error([0.1, 0.2, 0.3])

    def test_preproc_missing_frames(self):
        m = _TinyModel()
        rng = np.random.RandomState(0)
        assert m._preproc_missing_frames(None, 10).size == 0
        assert m._preproc_missing_frames(0, 10).size == 0
        frac = m._preproc_missing_frames(0.5, 1000, rng=rng)
        assert 300 < len(frac) < 700
        assert len(m._preproc_missing_frames(3, 10, rng=rng)) == 3
        np.testing.assert_array_equal(
            m._preproc_missing_frames([1, 4], 10), [1, 4])


# -- stats edge cases ---------------------------------------------------------

class TestStatsEdges:
    def test_dwell_times_input_forms(self):
        from bild_jax.stats import dwell_times
        # 1-d input; first interval is censored with duration (b-1)*dt
        d, c = dwell_times(np.array([0, 0, 0, 1, 1]), state=0, dt=2.0)
        np.testing.assert_allclose(d, [4.0])  # (3-1)*2
        np.testing.assert_array_equal(c, [True])

        # object array of ragged profiles (DatasetResults.best_profile form)
        ragged = np.empty(2, dtype=object)
        ragged[0] = np.array([0, 1, 1, 0])
        ragged[1] = np.array([1, 1])
        d, c = dwell_times(ragged, state=1)
        np.testing.assert_allclose(d, [2.0, 1.0])
        # [0,1,1,0]'s interval is interior (observed); the all-1 profile's
        # touches both window ends (censored)
        np.testing.assert_array_equal(c, [False, True])

        # empty profile rows are skipped
        d, c = dwell_times([np.array([], dtype=int), np.array([1, 1, 1])],
                           state=1)
        np.testing.assert_allclose(d, [2.0])

        # first interval covering only frame 0 is dropped (vacuous bound)
        d, c = dwell_times(np.array([1, 0, 0]), state=1)
        assert d.size == 0

    def test_KM_survival_without_anchor(self):
        from bild_jax.stats import KM_survival
        data = np.array([1.0, 2.0, 3.0, 4.0])
        cens = np.array([False, False, True, False])
        full = KM_survival(data, cens, S1at=0)
        bare = KM_survival(data, cens, S1at=None)
        assert len(bare) == len(full) - 1
        np.testing.assert_allclose(bare[:, 1], full[1:, 1])


# -- checkpoint: degenerate / pending / mismatch restores ---------------------

class TestCheckpointEdges:
    def _results(self, model, traj, ks=(0, 1), **kw):
        from bild_jax.amis.sampler import FixedkSampler
        from bild_jax.infer.core import SamplingResults
        # max_fcomplete=0 forbids exhaustive enumeration so small-k samplers
        # stay steppable (exhaustive restore is covered by test_checkpoint)
        samplers = [FixedkSampler(traj, model, k, N=20, max_fev=100,
                                  max_fcomplete=0, key=jax.random.key(k),
                                  **kw) for k in ks]
        return SamplingResults(traj, model, 0.0, samplers)

    def test_degenerate_and_pending_informed_roundtrip(self, tmp_path):
        from bild_jax.utils import save_results, load_results
        model = _model()
        traj = Trajectory.create(
            np.array([0.1, 0.05, 6.0, 3.0, 4.0, 0.01, 5.0, 7.0]),
            localization_error=0.02)
        res = self._results(model, traj, ks=(2, 20), informed_init=True)
        assert res.samplers[1].exhausted          # k=20 >= T: degenerate
        assert res.samplers[0]._informed is not None  # pending (no step ran)

        path = tmp_path / "edge.npz"
        save_results(path, res)
        res2 = load_results(path, model)

        s0, s1 = res2.samplers
        assert not hasattr(s1, "state") and s1.exhausted
        assert s1.evidences == [(-np.inf, 1e-10, np.inf)]
        # pending informed proposal is rebuilt on load (fires on first step)
        assert s0._informed is not None
        np.testing.assert_allclose(np.asarray(s0._informed[0]),
                                   np.asarray(res.samplers[0]._informed[0]))
        np.testing.assert_allclose(np.asarray(res2.traj.localization_error),
                                   [0.02])
        assert s0.step()                           # restored sampler steps

    def test_custom_model_roundtrip_and_nstates_mismatch(self, tmp_path):
        from bild_jax.utils import save_results, load_results
        model = _TinyModel(n=2)
        traj = _traj(6)
        res = self._results(model, traj, ks=(1,))
        assert res.samplers[0]._fused is None      # no traceable likelihood
        assert res.samplers[0].step()              # stepwise fallback path
        path = tmp_path / "tiny.npz"
        save_results(path, res)  # no fingerprint: keyed on shape only

        res2 = load_results(path, model)
        assert res2.samplers[0]._fused is None     # no traceable likelihood
        np.testing.assert_allclose(res2.evidence, res.evidence)

        with pytest.raises(ValueError, match="mismatch"):
            load_results(path, _TinyModel(n=3))


# -- DatasetResults accessor edges -------------------------------------------

class TestDatasetResultsEdges:
    def _results(self, marginals=False):
        from bild_jax.parallel.dataset import DatasetResults
        ev = np.array([[0.0, -1.0], [-3.0, -0.5]])
        profs = [np.zeros((2, 4), dtype=int), np.ones((2, 3), dtype=int)]
        margs = None
        if marginals:
            margs = [np.log(np.full((2, 2, 4), 0.5)),
                     np.log(np.full((2, 2, 3), 0.5))]
        return DatasetResults(k=np.arange(2), evidence=ev,
                              evidence_se=np.full((2, 2), 0.1),
                              profiles_by_k=profs, marginals=margs)

    def test_log_marginal_posterior_requires_marginals(self):
        with pytest.raises(ValueError, match="marginals=True"):
            self._results().log_marginal_posterior()

    def test_log_marginal_posterior_average(self):
        out = self._results(marginals=True).log_marginal_posterior("average")
        assert [o.shape for o in out] == [(2, 4), (2, 3)]
        for o in out:  # normalized over states at every frame
            np.testing.assert_allclose(
                np.exp(o).sum(axis=0), np.ones(o.shape[1]), rtol=1e-12)

    def test_sample_dataset_rejects_ensemble_kwarg(self):
        from bild_jax.parallel import sample_dataset
        with pytest.raises(ValueError, match="ensemble"):
            sample_dataset(_model(), [_traj(6)], ensemble=4)


# -- FixedkSampler API views and secondary paths ------------------------------

class _TinySegModel(_TinyModel):
    """Custom model with a frame-factorized score table but NO traceable
    lockstep likelihood: informed init must flow through the stepwise
    fallback's deferred proposal injection."""

    def _segment_table(self, traj):
        T = len(traj)
        tab = np.zeros((2, T))
        tab[1, T // 2:] = 1.0
        return tab


class TestSamplerViews:
    def _sampler(self, k=1, k_pad=None, **kw):
        from bild_jax.amis.sampler import FixedkSampler
        kw.setdefault("N", 16)
        kw.setdefault("max_fev", 200)
        kw.setdefault("max_fcomplete", 0)
        return FixedkSampler(_traj(10, seed=3), _model(), k, k_pad=k_pad,
                             key=jax.random.key(3), **kw)

    def test_steps_zero_and_views(self):
        s = self._sampler()
        assert s.steps(0) == 0
        assert s.steps(2) == 2
        assert s.n_steps_host == 2
        samples = s.samples
        assert len(samples) == 2
        assert samples[0]["ss"].shape == (16, s.K1)
        assert samples[0]["log_weights"].shape == (16,)
        params = s.parameters
        assert len(params) == 3          # initial + one per step
        assert params[0][0].shape == (s.K1,)

    def test_steps_after_exhaustion(self):
        s = self._sampler(max_fev=48)    # S = ceil(48/16)-1 = 2 steps max
        assert s.steps(10) == 2
        assert s.exhausted
        assert s.steps(1) == 0           # no-op once exhausted

    def test_exhaustive_samples_view(self):
        s = self._sampler(max_fcomplete=50)   # k=1, T=10, n=2: 18 profiles
        assert s._exhaustive is not None
        (sample,) = s.samples
        assert sample["logLs"].shape == sample["thetas"].shape[:1]

    def test_log_proposal_exact_padded_and_invalid(self):
        s = self._sampler(k=1, k_pad=3)       # K1 = 4 > k+1 = 2
        a, logp = s.parameters[0]
        ss_exact = np.array([[0.3, 0.7]])
        th = np.zeros((1, 2), dtype=int)
        out_exact = s.log_proposal((a[:2], logp[:, :2]), ss_exact, th)
        ss_padded = np.array([[0.3, 0.7, 0.0, 0.0]])
        th_padded = np.zeros((1, 4), dtype=int)
        out_padded = s.log_proposal((a, logp), ss_padded, th_padded)
        assert np.isfinite(out_exact).all() and np.isfinite(out_padded).all()
        with pytest.raises(ValueError, match="slots"):
            s.log_proposal((a, logp), np.ones((1, 3)) / 3,
                           np.zeros((1, 3), dtype=int))

    def test_amis_propose_unpadded(self):
        from bild_jax.amis.sampler import amis_propose
        import jax.numpy as jnp
        s = self._sampler()
        ss, thetas, profiles = amis_propose(
            s.state, jax.random.key(7), s._transitions, N=8, T=s.T)
        assert ss.shape == (8, s.K1) and profiles.shape == (8, s.T)
        np.testing.assert_allclose(np.asarray(ss.sum(-1)), 1.0, rtol=1e-6)

    def test_fused_steps_cache_hit(self):
        from bild_jax.amis.sampler import _make_fused_steps

        def fake_logL(profiles, per_traj):
            import jax.numpy as jnp
            return -jnp.sum(profiles.astype(float), axis=-1)

        first = _make_fused_steps(fake_logL, 8, 10)
        assert _make_fused_steps(fake_logL, 8, 10) is first

    def test_stepwise_informed_injection(self):
        from bild_jax.amis.sampler import FixedkSampler
        model = _TinySegModel()
        traj = _traj(10, seed=5)
        s = FixedkSampler(traj, model, 1, N=8, max_fev=100, max_fcomplete=0,
                          informed_init=True, key=jax.random.key(9))
        assert s._fused is None and s._informed is not None
        a_inf = np.asarray(s._informed[0])
        assert s.step()
        # the informed proposal was injected as the SECOND mixture component
        np.testing.assert_allclose(np.asarray(s.state.a_params[1]), a_inf)
        assert s.step()


# -- DP segmentation edges -----------------------------------------------------

class TestSegmentEdges:
    def test_batch_st_requires_exact_k(self):
        from bild_jax.infer.segment import profiles_to_st_batch
        with pytest.raises(AssertionError, match="exactly k"):
            profiles_to_st_batch(np.array([[0, 1, 0]]), k=1)  # 2 switches

    def test_unreachable_state_column(self):
        from bild_jax.infer.segment import dp_segment_all
        # state 0 has no allowed predecessor: only 0->1 switches exist
        trans = np.array([[False, True], [False, False]])
        table = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]])
        profiles, scores = dp_segment_all(table, 2, transitions=trans)
        np.testing.assert_array_equal(profiles[1], [0, 0, 1, 1])
        assert profiles[2] is None          # a second switch is impossible
        assert scores[2] == -np.inf

    def test_infeasible_k_exceeds_frames(self):
        from bild_jax.infer.segment import dp_segment, dp_segment_all_batch
        table = np.ones((2, 3))
        prof, score = dp_segment(table, k=5)
        assert prof is None and score == -np.inf
        profiles, feasible = dp_segment_all_batch(np.ones((2, 2, 3)), k_max=5)
        assert profiles.shape == (6, 2, 3)
        assert feasible[:3].all() and not feasible[3:].any()

    def test_segment_guess_none_when_infeasible(self):
        m = _TinySegModel()
        assert m.segment_guess(_traj(4), k=10) is None  # k >= T
        assert m.lockstep_segment_tables(None) is None  # base default


# -- native loader build path --------------------------------------------------

def test_native_build_compiles(tmp_path, monkeypatch):
    from bild_jax import native
    monkeypatch.setattr(native, "_SO", str(tmp_path / "_loader_test.so"))
    assert native._build()
    assert (tmp_path / "_loader_test.so").exists()


# -- MoM divergence surfacing (fused path) -------------------------------------

def test_fused_mom_divergence_truncates_and_raises():
    """When the CFC method-of-marginals diverges mid-run, evidences from the
    failing step onward are dropped (the reference raises inside the failing
    step, before logging its evidence) and the failure surfaces as a
    RuntimeError. The device run is faked: forcing a genuine divergence needs
    pathological data; the host-side failure protocol is what's pinned here."""
    import dataclasses
    import jax.numpy as jnp
    from bild_jax.amis.sampler import FixedkSampler

    s = FixedkSampler(_traj(10, seed=3), _model(), 1, N=16, max_fev=200,
                      max_fcomplete=0, key=jax.random.key(3))

    def fake_fused(state, key, transitions, logprior, cb, pb, active,
                   per_traj, a_inf, logp_inf, use_inf, n_run):
        ev = jnp.arange(3.0 * n_run)
        mom_rows = jnp.concatenate(
            [jnp.ones(n_run - 1), jnp.zeros(1)])     # diverged at last step
        packed = jnp.concatenate(
            [ev, mom_rows, jnp.asarray([0.0, float(n_run)])])
        state = dataclasses.replace(
            state, n_steps=jnp.asarray(n_run, jnp.int32))
        return state, key, packed

    s._fused = fake_fused
    with pytest.raises(RuntimeError, match="did not converge"):
        s.steps(2)
    assert len(s.evidences) == 1          # only pre-divergence evidence kept


# -- fit.py edges ---------------------------------------------------------------

class TestFitEdges:
    def _rouse(self, err=0.1):
        from bild_jax.models import MultiStateRouse
        return MultiStateRouse(5, 1.0, 3.0, d=1, localization_error=err)

    def test_profile_coercion_forms_and_converged(self):
        from bild_jax.fit import fit_rouse
        model = self._rouse()
        traj = model.trajectory_from_loopingprofile(
            np.zeros(12, dtype=int), key=jax.random.key(0))
        prof = np.zeros(12, dtype=int)
        # a single 1-d profile broadcasts over the singleton batch
        fit = fit_rouse(model, traj, prof, steps=3, fit_localization=False)
        # a LIST of per-trajectory 1-d profiles is coerced the same way
        fit2 = fit_rouse(model, [traj], [prof], steps=3,
                         fit_localization=False)
        np.testing.assert_allclose(fit.nll_trace, fit2.nll_trace)
        assert isinstance(fit.converged, bool)

    def test_fit_localization_mode_validation(self):
        from bild_jax.fit import fit_rouse
        model = self._rouse()
        traj = model.trajectory_from_loopingprofile(
            np.zeros(10, dtype=int), key=jax.random.key(1))
        with pytest.raises(ValueError, match="fit_localization"):
            fit_rouse(model, traj, np.zeros(10, dtype=int),
                      fit_localization="banana", steps=2)

    def test_resolve_err0_requires_model_error_for_batch(self):
        from bild_jax.fit import _resolve_err0
        with pytest.raises(ValueError, match="localization_error"):
            _resolve_err0(self._rouse(err=None), None, 1)

    def test_calibrate_single_trajectory_default_key(self):
        from bild_jax.fit import calibrate_rouse
        model = self._rouse()
        prof = np.zeros(16, dtype=int)
        prof[6:11] = 1
        traj = model.trajectory_from_loopingprofile(prof,
                                                    key=jax.random.key(2))
        cal = calibrate_rouse(
            model, traj, rounds=1,
            sample_kwargs=dict(k_max=2, steps_per_k=2, N=16),
            fit_kwargs=dict(steps=5, fit_localization=False))
        assert cal.D > 0 and cal.k > 0
        np.testing.assert_allclose(cal.localization_error, [0.1])


# -- mop-up: small-file residual branches --------------------------------------

class TestSmallResiduals:
    def test_csv_non_numeric_and_empty_value_rows(self, tmp_path):
        from bild_jax.io import load_trajectories_csv_python
        p = tmp_path / "messy.csv"
        p.write_text("0,0,1.0\n0,1\n0,2,abc\n0,3,4.0\n")
        (t,) = load_trajectories_csv_python(p)
        # row with no values skipped (frame 1 missing), non-numeric -> NaN
        assert len(t) == 4
        np.testing.assert_array_equal(np.asarray(t.valid),
                                      [True, False, False, True])

    def test_loopingprofile_eq_and_array(self):
        prof = Loopingprofile(np.array([0, 1, 1]))
        assert prof != Loopingprofile(np.array([0, 1]))   # length mismatch
        assert prof != object()                           # not coercible
        assert np.asarray(prof, dtype=float).dtype == np.float64

    def test_choicesampler_default_rng(self):
        from bild_jax.infer.choice import ChoiceSampler
        cs = ChoiceSampler(np.array([-1.0, -2.0]), np.array([0.1, 0.2]),
                           n_steps=np.array([2.0, 2.0]), margin=0.0)
        assert set(np.unique(cs.evaluate())) <= {0, 1}

    def test_idtype_tracks_x64(self):
        from bild_jax.config import idtype
        assert idtype() == np.int64      # conftest enables x64

    def test_gp_validation(self):
        from bild_jax.physics.gp import imaging, msd2C
        with pytest.raises(ValueError, match="exposure fraction"):
            imaging(f=1.5)
        with pytest.raises(ValueError, match="ss_order"):
            msd2C(lambda t: t, np.arange(3.0), ss_order=2)

    def test_rouse_bond_edge_cases(self):
        from bild_jax.physics.rouse import RouseModel
        # None entries and vacuous (l == r) bonds are skipped; 2-tuples get
        # default strength — all equivalent to the plain backbone chain here
        m_plain = RouseModel(5, 1.0, 2.0, d=1, dt=1.0)
        m_edges = RouseModel(5, 1.0, 2.0, d=1, dt=1.0,
                             add_bonds=[None, (0, 0), (2, 2, 1.0)])
        np.testing.assert_allclose(np.asarray(m_edges.B),
                                   np.asarray(m_plain.B))
        assert m_plain.check_dynamics()
        dyn = m_plain._dynamics
        np.testing.assert_allclose(np.asarray(dyn["B"]),
                                   np.asarray(m_plain.B))

    def test_kalman_single_wrapper(self):
        from bild_jax.ops.kalman import msrouse_logL_batch, msrouse_logL_single
        import jax.numpy as jnp
        model = MultiStateRouse_small()
        traj = Trajectory.create(np.array([1.0, 2.0, 1.5, 0.5]))
        s2, Cind = model._noise_arrays(traj)
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                model.w, s2, Cind)
        prof = jnp.zeros(4, dtype=jnp.int32)
        single = msrouse_logL_single(*args, prof, traj.data, traj.valid)
        batch = msrouse_logL_batch(*args, prof[None], traj.data, traj.valid)
        np.testing.assert_allclose(np.asarray(single), np.asarray(batch[0]))

    def test_sqrt_operator_cache_hit(self):
        from bild_jax.ops import kalman_sqrt as ks
        from bild_jax.config import fdtype
        model = MultiStateRouse_small()
        first = ks._sqrt_operators(model.Sigs, model.C0s, fdtype())
        n_cached = len(ks._SQRT_OPS_CACHE)
        again = ks._sqrt_operators(model.Sigs, model.C0s, fdtype())
        assert len(ks._SQRT_OPS_CACHE) == n_cached   # hit, not a new entry
        np.testing.assert_array_equal(np.asarray(first[0]),
                                      np.asarray(again[0]))

    def test_dataset_progress_bar(self):
        from bild_jax.parallel import sample_dataset
        res = sample_dataset(_model(), [_traj(8, seed=1), _traj(8, seed=2)],
                             k_max=1, steps_per_k=2, N=16,
                             show_progress=True, key=jax.random.key(4))
        assert res.evidence.shape == (2, 2)

    def test_exhaustive_checkpoint_roundtrip(self, tmp_path):
        from bild_jax.amis.sampler import FixedkSampler
        from bild_jax.infer.core import SamplingResults
        from bild_jax.utils import save_results, load_results
        model = _model()
        traj = _traj(10, seed=7)
        samplers = [FixedkSampler(traj, model, k, N=16, max_fev=200,
                                  max_fcomplete=50, key=jax.random.key(11))
                    for k in (0, 1)]
        s = samplers[1]
        assert s._exhaustive is not None
        res = SamplingResults(traj, model, 0.0, samplers)
        path = tmp_path / "ex.npz"
        save_results(path, res)
        res2 = load_results(path, model)
        s2 = res2.samplers[0]
        assert s2._exhaustive is not None
        assert set(s2._exhaustive) == set(s._exhaustive)
        np.testing.assert_allclose(res2.evidence, res.evidence)
        np.testing.assert_array_equal(res2.best_profile()[:],
                                      res.best_profile()[:])


def MultiStateRouse_small():
    from bild_jax.models import MultiStateRouse
    return MultiStateRouse(5, 1.0, 3.0, d=1, localization_error=0.1)


# -- sample_batch argument guards and k >= T lockstep skip ----------------------

class TestSampleBatchGuards:
    def _batch(self, T=6):
        from bild_jax.parallel.batch import stack_trajectories
        return stack_trajectories([_traj(T, seed=1), _traj(T, seed=2)])

    def test_argument_validation(self, tmp_path):
        from bild_jax.parallel import sample_batch
        m, batch = _model(), self._batch()
        with pytest.raises(ValueError, match="scout_steps"):
            sample_batch(m, batch, k_max=1, steps_per_k=4, N=16,
                         scout_steps=0)
        with pytest.raises(ValueError, match="steps_per_k"):
            sample_batch(m, batch, k_max=1, steps_per_k=0, N=16)
        with pytest.raises(ValueError, match="checkpoint"):
            sample_batch(m, batch, k_max=1, steps_per_k=4, N=16,
                         scout_steps=2, checkpoint=str(tmp_path / "ck.npz"))
        with pytest.raises(ValueError, match="ensemble"):
            sample_batch(m, batch, k_max=1, steps_per_k=2, N=16,
                         ensemble=10**9)

    def test_k_exceeding_T_skipped(self):
        from bild_jax.parallel import sample_batch
        m, batch = _model(), self._batch(T=4)
        res = sample_batch(m, batch, k_max=5, steps_per_k=2, N=16,
                           key=jax.random.key(0))
        # ks >= T are unidentifiable by construction: -inf evidence, and the
        # result keeps the full (k_max+1) layout
        assert res.evidence.shape == (2, 6)
        assert np.isneginf(res.evidence[:, 4:]).all()
        assert np.isfinite(res.evidence[:, :4]).all()
        assert res.best_k().max() < 4


# -- MultiStateRouse noise-resolution guards ------------------------------------

class TestMSRouseGuards:
    def test_ctor_localization_error_validation(self):
        from bild_jax.models import MultiStateRouse
        with pytest.raises(ValueError, match="localization_error"):
            MultiStateRouse(5, 1.0, 3.0, d=2,
                            localization_error=np.zeros(3))

    def test_noise_resolution_and_scalar_metadata(self):
        from bild_jax.models import MultiStateRouse
        from bild_jax.parallel.batch import stack_trajectories
        import jax.numpy as jnp
        m = MultiStateRouse(5, 1.0, 3.0, d=1)     # no model-level error
        t = _traj(6)                               # no trajectory metadata
        with pytest.raises(ValueError, match="localization error"):
            m._get_noise(t)
        with pytest.raises(ValueError, match="localization_error"):
            m.lockstep_fns(stack_trajectories([t]))
        with pytest.raises(ValueError, match="localization_error"):
            m.trajectory_from_loopingprofile(np.zeros(6, dtype=int),
                                             key=jax.random.key(0))
        # 0-d trajectory metadata broadcasts to (d,) like the reference
        # (bild/models.py:255-263)
        t_scalar = Trajectory(data=t.data, valid=t.valid,
                              localization_error=jnp.asarray(0.25))
        np.testing.assert_allclose(m._get_noise(t_scalar), [0.25])

    def test_generate_batch_default_key(self):
        from bild_jax.models import MultiStateRouse
        m = MultiStateRouse(5, 1.0, 3.0, d=1, localization_error=0.1)
        batch = m.trajectories_from_loopingprofiles(
            np.zeros((2, 6), dtype=int))
        assert batch.data.shape == (2, 6, 1)


# -- GGM banded validation / caches; CFC non-convergence; sample default key ----

def _ggm(T_band=None, **kw):
    from bild_jax.models import GenericGaussianModel as GGM
    return GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
    ], T_band=T_band, **kw)


class TestGGMBandedEdges:
    def test_T_band_validation(self):
        with pytest.raises(ValueError, match="T_band"):
            _ggm(T_band="banana")
        with pytest.raises(ValueError, match="T_band"):
            _ggm(T_band=4)

    def test_interval_table_cached_per_traj(self):
        model = _ggm()
        traj = model.trajectory_from_loopingprofile(
            np.zeros(12, dtype=int), rng=np.random.default_rng(0))
        first = model.interval_table(traj)
        assert model.interval_table(traj) is first      # cache hit
        traj2 = model.trajectory_from_loopingprofile(
            np.zeros(12, dtype=int), rng=np.random.default_rng(1))
        assert model.interval_table(traj2) is not first  # keyed on data

    def test_band_tail_error_guards(self):
        model = _ggm(T_band="auto")
        with pytest.raises(ValueError, match="concrete T_band"):
            model.band_tail_error(100)          # 'auto' has no fixed band
        assert model.band_tail_error(16, T_band=32) == 0.0   # T <= W
        err = model.band_tail_error(256, T_band=32)
        assert err > 0.0

    def test_auto_band_resolution_cached(self):
        model = _ggm(T_band="auto")
        W = model._resolve_band(96)
        assert 96 in model._auto_band_cache
        assert model._resolve_band(96) == W     # cache hit


class TestCFCNonConvergence:
    def test_solve_marginals_single_raises(self):
        from bild_jax.amis.cfc import CFC
        cfc = CFC([[0, 1], [1, 0]])
        cfc.MOM_maxiter = 0                      # forbid any iteration
        # a target with genuinely coupled marginals cannot converge in 0 steps
        logf = np.log(np.array([0.7, 0.3]))
        logg = np.log(np.array([0.4, 0.6]))
        with pytest.raises(RuntimeError, match="did not converge"):
            cfc.solve_marginals_single(logf, logg)


def test_sample_default_key():
    res = bild.sample(_traj(8), _model(), k_max=1, init_runs=2,
                      sampler_kw={"N": 16, "max_fev": 64})
    assert np.isfinite(res.evidence).any()


# -- fit_ggm edges ---------------------------------------------------------------

class TestFitGGMEdges:
    def _spec(self, **extra):
        p0 = dict(G=1.0, J=5.0, noise2=0.01, **extra)
        p1 = dict(G=0.2, J=1.0, noise2=0.01, **extra)
        return [[("twoLocusRouse", p0, 0.0, 0)],
                [("twoLocusRouse", p1, 0.0, 0)]]

    def _traj_ggm(self, profile, seed=0):
        from bild_jax.models import GenericGaussianModel as GGM
        model = GGM([
            [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0, noise2=0.01),
              0.0, 0)],
            [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0, noise2=0.01),
              0.0, 0)],
        ])
        return model.trajectory_from_loopingprofile(
            profile, rng=np.random.default_rng(seed))

    def test_ss_order_validation(self):
        from bild_jax.fit_ggm import make_ggm_nll
        bad = [[("twoLocusRouse", dict(G=1.0, J=5.0, noise2=0.01), 0.0, 2)]]
        traj = self._traj_ggm(np.zeros(10, dtype=int))
        with pytest.raises(ValueError, match="ss_order"):
            make_ggm_nll(bad, traj, np.zeros(10, dtype=int))

    def test_single_trajectory_and_empty_rows(self):
        from bild_jax.fit_ggm import fit_ggm
        prof = np.zeros(24, dtype=int)
        prof[8:16] = 1
        traj = self._traj_ggm(prof)
        # single Trajectory input (the (T, d) -> (1, T, d) view)
        fit = fit_ggm(self._spec(), traj, prof, steps=3)
        assert np.isfinite(fit.nll_trace).all()
        # an all-missing trajectory contributes nothing but does not break
        empty = Trajectory.create(np.full(24, np.nan))
        fit2 = fit_ggm(self._spec(), [traj, empty],
                       [prof, np.zeros(24, dtype=int)], steps=3)
        np.testing.assert_allclose(fit2.nll_trace, fit.nll_trace)

    def test_calibrate_single_trajectory_motion_blur_roundtrip(self):
        from bild_jax.fit_ggm import calibrate_ggm
        prof = np.zeros(24, dtype=int)
        prof[8:16] = 1
        traj = self._traj_ggm(prof, seed=3)
        cal = calibrate_ggm(
            self._spec(motion_blur_f=0.5), traj, rounds=1,
            sample_kwargs=dict(k_max=2, steps_per_k=2, N=16,
                               informed_init=False),
            fit_kwargs=dict(steps=3))
        # motion_blur_f survives the parameters -> spec round trip
        from bild_jax.fit_ggm import _spec_with_parameters
        spec2 = _spec_with_parameters(self._spec(motion_blur_f=0.5),
                                      cal.parameters)
        assert spec2[0][0][1]["motion_blur_f"] == 0.5
        assert cal.parameters[0]["G"] > 0


# -- final semantic stragglers ----------------------------------------------------

def test_logLR_boundaries_matches_direct_logL():
    """Each (boundary, direction) entry equals logL(moved) - logL(current),
    computed independently through model.logL (pins the batch layout)."""
    from bild_jax.postproc import logLR_boundaries
    model, traj = _model(), _traj(8, seed=4)
    states = np.array([0, 0, 0, 1, 1, 1, 0, 0])
    out = logLR_boundaries(Loopingprofile(states), traj, model)
    assert out.shape == (2, 2)
    base = model.logL(Loopingprofile(states), traj)
    moved = states.copy(); moved[2] = 1          # boundary 0 moved left
    np.testing.assert_allclose(
        out[0, 0], model.logL(Loopingprofile(moved), traj) - base,
        rtol=1e-10)
    moved = states.copy(); moved[6] = 1          # boundary 1 moved right
    np.testing.assert_allclose(
        out[1, 1], model.logL(Loopingprofile(moved), traj) - base,
        rtol=1e-10)


def test_loopingprofile_repr():
    assert repr(Loopingprofile(np.array([0, 1]))) == "Loopingprofile([0, 1])"


def test_batch_generative_requires_localization_error():
    from bild_jax.models import MultiStateRouse
    m = MultiStateRouse(5, 1.0, 3.0, d=1)
    with pytest.raises(ValueError, match="localization_error"):
        m.trajectories_from_loopingprofiles(np.zeros((1, 6), dtype=int))


# -- multi-process protocol decisions, unit-tested without a cluster -------------
# (the 2-process integration path lives in tests/test_distributed.py; these
# pin the guard DECISIONS by faking the process-level primitives)

class TestMultiprocessProtocolUnit:
    def _run(self, **kw):
        from bild_jax.parallel import make_mesh, sample_dataset
        kw.setdefault("k_max", 1)
        kw.setdefault("steps_per_k", 2)
        kw.setdefault("N", 16)
        return sample_dataset(_model(), [_traj(8, seed=1), _traj(8, seed=2)],
                              mesh=make_mesh(), **kw)

    def test_divergence_guard_raises(self, monkeypatch):
        from bild_jax.parallel import mesh as mesh_mod
        monkeypatch.setattr(mesh_mod, "is_multiprocess", lambda m: True)
        # process 0's hash never matches ours -> divergent launch
        monkeypatch.setattr(mesh_mod, "broadcast_from_process0",
                            lambda x: np.asarray(x) + 1)
        with pytest.raises(ValueError, match="diverged"):
            self._run(key=jax.random.key(0))

    def test_seed_broadcast_and_identity_run(self, monkeypatch):
        from bild_jax.parallel import mesh as mesh_mod
        monkeypatch.setattr(mesh_mod, "is_multiprocess", lambda m: True)
        seen = []
        def echo(x):
            seen.append(np.asarray(x))
            return x
        monkeypatch.setattr(mesh_mod, "broadcast_from_process0", echo)
        res = self._run(key=None)        # key drawn, then broadcast
        assert np.isfinite(res.evidence).any()
        assert len(seen) >= 2            # seed + dataset digest

    def test_checkpoint_hit_unreadable_on_this_process(self, monkeypatch,
                                                       tmp_path):
        from bild_jax.parallel import mesh as mesh_mod
        monkeypatch.setattr(mesh_mod, "is_multiprocess", lambda m: True)
        calls = []
        def fake_broadcast(x):
            calls.append(x)
            # echo the digest, then claim process 0 has the checkpoint
            return x if len(calls) == 1 else np.int64(1)
        monkeypatch.setattr(mesh_mod, "broadcast_from_process0",
                            fake_broadcast)
        with pytest.raises(FileNotFoundError, match="shared filesystem"):
            self._run(key=jax.random.key(0),
                      checkpoint_dir=str(tmp_path / "ck"))

    def test_nonzero_process_skips_checkpoint_writes(self, monkeypatch,
                                                     tmp_path):
        from bild_jax.parallel import mesh as mesh_mod
        monkeypatch.setattr(mesh_mod, "is_multiprocess", lambda m: True)
        monkeypatch.setattr(mesh_mod, "broadcast_from_process0", lambda x: x)
        monkeypatch.setattr(jax, "process_index", lambda *a, **k: 1)
        ckdir = tmp_path / "ck"
        res = self._run(key=jax.random.key(0), checkpoint_dir=str(ckdir))
        assert np.isfinite(res.evidence).any()
        assert list(ckdir.glob("chunk_*.npz")) == []   # exactly-once: not us


class TestBatchResiduals:
    def test_per_k_checkpoint_skips_infeasible_k(self, tmp_path):
        from bild_jax.parallel import sample_batch
        from bild_jax.parallel.batch import stack_trajectories
        batch = stack_trajectories([_traj(4, seed=1), _traj(4, seed=2)])
        ck = str(tmp_path / "perk.npz")
        res = sample_batch(_model(), batch, k_max=5, steps_per_k=2, N=16,
                           checkpoint=ck, key=jax.random.key(0))
        assert np.isneginf(res.evidence[:, 4:]).all()
        # resume from the finished checkpoint reproduces bit-identically
        res2 = sample_batch(_model(), batch, k_max=5, steps_per_k=2, N=16,
                            checkpoint=ck, key=jax.random.key(0))
        np.testing.assert_array_equal(res.evidence, res2.evidence)

    def test_mesh_padding_with_ensemble(self):
        from bild_jax.parallel import make_mesh, sample_batch
        from bild_jax.parallel.batch import stack_trajectories
        batch = stack_trajectories([_traj(8, seed=s) for s in range(3)])
        res = sample_batch(_model(), batch, k_max=1, steps_per_k=2, N=16,
                           mesh=make_mesh(), ensemble=4,
                           key=jax.random.key(1))
        # B=3 padded to the 8-device mesh and unpadded back
        assert res.evidence.shape == (3, 2)
        profs, weights = res.profile_ensemble(0)
        assert profs.shape == (3, 4, 8) and weights.shape == (3, 4)


def test_dataset_log_marginal_posterior_best_k():
    from bild_jax.parallel.dataset import DatasetResults
    ev = np.array([[0.0, -1.0]])
    res = DatasetResults(k=np.arange(2), evidence=ev,
                         evidence_se=np.full((1, 2), 0.1),
                         profiles_by_k=[np.zeros((2, 4), dtype=int)],
                         marginals=[np.log(np.full((2, 2, 4), 0.5))])
    (m,) = res.log_marginal_posterior()      # best-k (non-average) accessor
    assert m.shape == (2, 4)


class _NoSegFactorized(FactorizedModel):
    """Lockstep-capable model that HIDES its frame-factorized score table
    from the informed-init path (the likelihood still uses it internally):
    informed init must fall back to the uniform proposal."""

    hide_tables = True

    def lockstep_segment_tables(self, batch):
        if self.hide_tables:
            return None
        return super().lockstep_segment_tables(batch)

    def lockstep_fns(self, batch):
        self.hide_tables = False
        try:
            return super().lockstep_fns(batch)
        finally:
            self.hide_tables = True


class TestBatchResiduals2:
    def _batch(self, T=8, B=2):
        from bild_jax.parallel.batch import stack_trajectories
        return stack_trajectories([_traj(T, seed=s) for s in range(B)])

    def test_stack_trajectories_validation(self):
        from bild_jax.parallel.batch import stack_trajectories
        with pytest.raises(ValueError, match="T_pad"):
            stack_trajectories([_traj(8)], T_pad=4)
        t2 = Trajectory.create(np.abs(np.random.default_rng(0)
                                      .normal(size=(6, 2))) + 0.1)
        with pytest.raises(ValueError, match="same d"):
            stack_trajectories([_traj(6), t2])

    def test_marginals_accessor_requires_flag(self):
        from bild_jax.parallel import sample_batch
        res = sample_batch(_model(), self._batch(), k_max=1, steps_per_k=2,
                           N=16, key=jax.random.key(0))
        with pytest.raises(ValueError, match="marginals=True"):
            res.log_marginal_posterior()

    def test_informed_cache_hit_and_uniform_fallback(self):
        from bild_jax.parallel import sample_batch
        model, batch = _model(), self._batch()
        kw = dict(k_max=2, steps_per_k=2, N=16, informed_init=True,
                  key=jax.random.key(1))
        res = sample_batch(model, batch, **kw)
        res2 = sample_batch(model, batch, **kw)    # informed tables cached
        np.testing.assert_array_equal(res.evidence, res2.evidence)

        model2 = _NoSegFactorized(
            [sp_stats.maxwell(scale=0.1), sp_stats.maxwell(scale=1.0)], d=1)
        res3 = sample_batch(model2, batch, **kw)   # uniform fallback
        assert np.isfinite(res3.evidence).all()

        # infeasible informed ks (k >= T) skip table building per k
        short = self._batch(T=4)
        res4 = sample_batch(model, short, k_max=5, steps_per_k=2, N=16,
                            informed_init=True, key=jax.random.key(2))
        assert np.isneginf(res4.evidence[:, 4:]).all()

    def test_checkpoint_with_ensemble_and_mom_maxiter(self, tmp_path):
        from bild_jax.parallel import sample_batch
        ck = str(tmp_path / "perk_ens.npz")
        kw = dict(k_max=5, steps_per_k=2, N=16, ensemble=4, mom_maxiter=500,
                  key=jax.random.key(3))
        short = self._batch(T=4)
        res = sample_batch(_model(), short, checkpoint=ck, **kw)
        res2 = sample_batch(_model(), short, checkpoint=ck, **kw)  # resume
        np.testing.assert_array_equal(res.evidence, res2.evidence)
        p1, w1 = res.profile_ensemble(0)
        p2, w2 = res2.profile_ensemble(0)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_allclose(w1, w2)

    def test_multiproc_seed_broadcast_and_write_skip(self, monkeypatch,
                                                     tmp_path):
        from bild_jax.parallel import make_mesh, sample_batch
        from bild_jax.parallel import mesh as mesh_mod
        monkeypatch.setattr(mesh_mod, "is_multiprocess", lambda m: True)
        monkeypatch.setattr(mesh_mod, "broadcast_from_process0", lambda x: x)
        res = sample_batch(_model(), self._batch(), k_max=1, steps_per_k=2,
                           N=16, mesh=make_mesh(), key=None)
        assert np.isfinite(res.evidence).any()

        monkeypatch.setattr(jax, "process_index", lambda *a, **k: 1)
        ck = str(tmp_path / "never.npz")
        sample_batch(_model(), self._batch(), k_max=1, steps_per_k=2, N=16,
                     mesh=make_mesh(), checkpoint=ck, key=jax.random.key(5))
        assert not os.path.exists(ck)      # exactly-once: process 0 writes
