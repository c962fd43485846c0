"""CLI entry point (`python -m bild_jax`): end-to-end on a tiny CSV.

The reference is library-only; the CLI is this package's batteries-included
dataset path, so it gets the same in-process integration treatment as
`sample_dataset` (`tests/test_dataset_driver.py`) — argument parsing,
loading, inference, npz output, and checkpoint-rerun identity.
"""
import numpy as np
import jax
import pytest

from bild_jax.__main__ import build_parser, main
from bild_jax.models import MultiStateRouse


def _write_csv(path, trajs):
    with open(path, "w") as f:
        f.write("traj_id,frame,v0\n")
        for tid, traj in enumerate(trajs):
            data = np.asarray(traj.data)
            valid = np.asarray(traj.valid)
            for t in range(len(traj)):
                if valid[t]:
                    f.write(f"{tid},{t},{data[t, 0]:.6f}\n")


@pytest.fixture(scope="module")
def tiny_csv(tmp_path_factory):
    model = MultiStateRouse(8, 1.0, 4.0, d=1, localization_error=0.15)
    trajs = []
    for i, k_true in enumerate([0, 1, 0]):
        prof = np.zeros(16, dtype=int)
        if k_true:
            prof[8:] = 1
        trajs.append(model.trajectory_from_loopingprofile(
            prof, key=jax.random.key(100 + i)))
    # one longer trajectory with an INTERIOR loop interval, so --dwell-times
    # sees at least one fully-observed (uncensored) dwell
    prof = np.zeros(24, dtype=int)
    prof[6:18] = 1
    trajs.append(model.trajectory_from_loopingprofile(
        prof, key=jax.random.key(103)))
    path = tmp_path_factory.mktemp("cli") / "tiny.csv"
    _write_csv(path, trajs)
    return str(path)


def test_parser_defaults():
    args = build_parser().parse_args(["data.csv"])
    assert args.out == "bild_results.npz"
    assert args.k_max == 10 and args.monomers == 20
    assert not args.two_locus and not args.marginals
    assert args.loop_positions is None


def test_parse_looppositions():
    from bild_jax.__main__ import _parse_looppositions as parse
    assert parse("none;0,-1") == (None, (0, -1))
    assert parse("none;0,-1;0,10") == (None, (0, -1), (0, 10))
    assert parse("none;0,-1,0.5") == (None, (0, -1, 0.5))
    assert parse("none;0,-1+3,5") == (None, [(0, -1), (3, 5)])
    with pytest.raises(ValueError):
        parse("none")                      # < 2 states
    with pytest.raises(ValueError):
        parse("none;0")                    # malformed bond


def test_cli_three_state_model(tiny_csv, tmp_path):
    out = str(tmp_path / "res3.npz")
    rc = main([tiny_csv, "--out", out, *CLI_FAST,
               "--loop-positions", "none;0,-1;0,3"])
    assert rc == 0
    res = np.load(out, allow_pickle=True)
    assert res["evidence"].shape == (4, 3)
    assert np.all(np.isfinite(res["evidence"][:, 0]))


CLI_FAST = ["--monomers", "8", "--k-max", "2", "--steps-per-k", "4",
            "--proposals", "16", "--scout-steps", "0",
            "--localization-error", "0.15", "--chunk-size", "4", "--quiet"]


def test_cli_end_to_end(tiny_csv, tmp_path):
    out = str(tmp_path / "res.npz")
    rc = main([tiny_csv, "--out", out, *CLI_FAST,
               "--marginals", "--optimize-boundaries", "--dwell-times"])
    assert rc == 0
    res = np.load(out, allow_pickle=True)
    assert res["evidence"].shape == (4, 3)          # (B, k_max+1)
    assert res["best_k"].shape == (4,)
    assert list(res["lengths"]) == [16, 16, 16, 24]
    profiles = res["best_profiles"]
    assert [len(p) for p in profiles] == [16, 16, 16, 24]
    lmp = res["log_marginal_posterior"]
    assert all(m.shape == (2, len(p)) for m, p in zip(lmp, profiles))
    # marginal posterior columns normalize
    np.testing.assert_allclose(
        np.exp(lmp[0].astype(float)).sum(axis=0), 1.0, rtol=1e-5)
    assert res["optimized_profiles"][0].shape == (16,)
    # --dwell-times: censored samples per state, exponential mean with CI
    # for any state with at least one fully-observed interval (the
    # "postproc credible intervals" leg of the 10k-dataset target)
    for s in (0, 1):
        dur = res[f"dwell_durations_state{s}"]
        cen = res[f"dwell_censored_state{s}"]
        assert dur.shape == cen.shape and cen.dtype == bool
        if np.count_nonzero(~cen):
            m, lo, hi = res[f"dwell_exp_mean_ci_state{s}"]
            assert lo < m < hi
            assert res[f"dwell_KM_state{s}"].shape[1] == 4
    # the interior-loop trajectory guarantees (deterministically, fixed
    # keys) a fully-observed dwell for SOME state -> the CI branch ran
    # (state labeling at this tiny budget is arbitrary)
    assert any(np.count_nonzero(~res[f"dwell_censored_state{s}"]) > 0
               for s in (0, 1))


def test_cli_checkpoint_rerun_identical(tiny_csv, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out1 = str(tmp_path / "r1.npz")
    out2 = str(tmp_path / "r2.npz")
    rc = main([tiny_csv, "--out", out1, *CLI_FAST,
               "--checkpoint-dir", ckpt])
    assert rc == 0
    # rerun resumes every chunk from the checkpoint -> identical output
    rc = main([tiny_csv, "--out", out2, *CLI_FAST,
               "--checkpoint-dir", ckpt])
    assert rc == 0
    a, b = np.load(out1, allow_pickle=True), np.load(out2, allow_pickle=True)
    np.testing.assert_array_equal(a["evidence"], b["evidence"])
    np.testing.assert_array_equal(a["best_k"], b["best_k"])


def test_cli_warns_when_k_max_binds(tiny_csv, tmp_path, capsys):
    # k_max=0 forces every trajectory to the ceiling -> stderr warning
    out = str(tmp_path / "cap.npz")
    rc = main([tiny_csv, "--out", out, "--monomers", "8", "--k-max", "0",
               "--steps-per-k", "2", "--proposals", "8", "--scout-steps", "0",
               "--localization-error", "0.15", "--chunk-size", "4", "--quiet"])
    assert rc == 0
    assert "consider raising --k-max" in capsys.readouterr().err


def test_cli_empty_input_fails_cleanly(tmp_path, capsys):
    path = tmp_path / "empty.csv"
    path.write_text("traj_id,frame,v0\n")
    rc = main([str(path), "--quiet"])
    assert rc == 1
    assert "no trajectories" in capsys.readouterr().err


def test_cli_fit_params(tiny_csv, tmp_path):
    """--fit-params calibrates (D, k) before the dataset run and records
    the fitted values in the output npz."""
    out = str(tmp_path / "res_fit.npz")
    rc = main([tiny_csv, "--out", out, *CLI_FAST, "--fit-params", "1",
               "--fit-subset", "4"])
    assert rc == 0
    res = np.load(out, allow_pickle=True)
    # fitted parameters are recorded, positive, and differ from the
    # starting values (the tiny dataset will not leave them untouched)
    D, k = float(res["fitted_D"]), float(res["fitted_k"])
    assert D > 0 and k > 0
    assert (D, k) != (1.0, 5.0)
    assert res["best_k"].shape == (4,)


@pytest.mark.slow
def test_cli_verbose_output(tiny_csv, tmp_path, capsys):
    """Without --quiet the CLI narrates every stage: dataset summary,
    calibration, per-state dwell statistics (both the with-CI and the
    no-fully-observed branches), switch-count histogram, output path."""
    out = str(tmp_path / "res_verbose.npz")
    rc = main([tiny_csv, "--out", out, *CLI_FAST[:-1],  # drop --quiet
               "--dwell-times", "--fit-params", "1", "--fit-subset", "4"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "4 trajectories, d=1" in text
    assert "calibrated on 4 trajectories" in text
    # state 1 has the interior (fully-observed) dwell -> exponential CI;
    # state 0 only touches the window ends -> censored-only message
    assert "state 1" in text and "95% CI" in text
    assert "state 0: no fully-observed dwell intervals" in text
    assert "switch-count histogram:" in text
    assert f"wrote {out}" in text
