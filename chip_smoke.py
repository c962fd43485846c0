#!/usr/bin/env python3
"""
Smoke run of bild_jax's main path on one CUDA card.

    python chip_smoke.py               # every phase below, on one card
    python chip_smoke.py --four-cards  # only the 4-card data-mesh phase

Phases (each prints its result and wall time on one line):

- card tests: ``pytest -m card`` in a child process, run before this
  process imports JAX (one JAX process on the card at a time);
- device: the card's name and power limit (``nvidia-smi``), JAX's version
  and ``device_kind``; refuses anything but a GPU;
- parity: the float32 Rouse likelihood path on the card against the float64
  oracle (`bild_jax.ops.oracle`) at N=20, d=3: n=2/T=100, n=3/T=1000, and
  10% missing frames with three distinct per-dimension errors; and the
  CUDA kernel against the float32 XLA scan on 8192 profiles;
- sample: `bild.sample` on one trajectory, frame accuracy and key
  reproducibility;
- sample_batch: the 128-trajectory (T=100) and 3-state T=1000 lockstep
  shapes, accuracy against the generating truth;
- sample_dataset: 2048 trajectories in two 1024-chunks with boundary
  postproc and marginals, rerun from its checkpoint directory;
- ggm: GenericGaussianModel parity against its float64 host oracle, gap-free
  and with NaN frames, and lockstep accuracy at 64 x T=100;
- cli: ``python -m bild_jax`` (in-process) on a synthesized two-locus CSV.

``--four-cards`` runs `sample_dataset` on 4096 trajectories over a 4-card
``data`` mesh and on a 1-device mesh in the same process, and compares them.

Any failed phase exits non-zero. The last line of a passing run is the JSON
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# every f32 product at full precision (no TF32): max relative error of the
# f32 likelihood against the f64 oracle
PARITY_RTOL = 1e-5
# The 4-card and 1-device runs compile to other per-device shapes (256 and
# 1024 rows), so float32 reductions may run in another order; AMIS turns a
# last-bit difference in one (trajectory, k) lane into another sample
# ensemble, whose evidence differs by the sampler's own noise. On one card,
# the same 256 trajectories run at 1024 and at 256 rows agree within 1e-3
# nats in 82-100% of the lanes of each k (`tools/shape_spread.py`). So
# best_k must be identical, the evidence at it agree within this many
# combined standard errors (+1e-3 nats), and in every block of one device's
# rows of a chunk at one k, at least this share of the lanes agree within
# 1e-3 nats: a sharding fault breaks whole blocks.
FOUR_CARD_Z = 6.0
FOUR_CARD_BLOCK_AGREE = 0.5

# (n_states, B, T, k_max, seed) of the lockstep phases: bench_e2e configs 3, 4
BATCH_SHAPES = {"config3_B128_T100": (2, 128, 100, 4, 3),
                "config4_B16_T1000_n3": (3, 16, 1000, 6, 4)}
DATASET_B, DATASET_T, CHUNK = 2048, 100, 1024
GGM_B, GGM_T = 64, 100
CLI_B = 64
FOUR_CARD_B = 4096
# the AMIS budget of every lockstep phase (bench_e2e's)
AMIS_KW = dict(steps_per_k=12, N=128, scout_steps=4, refine_top=3)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    out = {}
    yield out
    dt = time.perf_counter() - t0
    print(f"[{name}] ok {json.dumps(out)} wall_s={dt:.2f}", flush=True)


def nvidia_smi():
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    check(p.returncode == 0, f"nvidia-smi rc={p.returncode}: {p.stderr}")
    return p.stdout.strip()


def run_card_tests():
    """Card-marked tests in a child process (before this one opens the
    card). Returns (summary line, wall seconds)."""
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-q", "-m", "card",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=ROOT, env={**os.environ, "BILD_TEST_CARD": "1"},
        capture_output=True, text=True)
    dt = time.perf_counter() - t0
    lines = [l for l in p.stdout.splitlines() if l.strip()]
    summary = lines[-1] if lines else ""
    if p.returncode != 0 or "passed" not in summary or "skipped" in summary:
        print(p.stdout[-6000:], p.stderr[-3000:], sep="\n", file=sys.stderr)
        fail(f"card tests: rc={p.returncode}: {summary}")
    return summary, dt


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"no CUDA card: JAX's default device is {dev.platform!r}")
    return dev


# -- helpers ---------------------------------------------------------------
def truth_profiles(rng, B, T, n_states, k_max=4):
    from bench_e2e import _truth_profiles
    return _truth_profiles(rng, B, T, n_states, k_max)


def frame_accuracy(profiles, truths):
    return float(np.mean([np.mean(np.asarray(p) == np.asarray(t))
                          for p, t in zip(profiles, truths)]))


def switch_accuracy(best_k, truths):
    true_k = [int(np.sum(t[1:] != t[:-1])) for t in truths]
    return float(np.mean(np.asarray(best_k) == np.asarray(true_k)))


def rouse_model(n_states=2, localization_error=0.1):
    from bild_jax.models import MultiStateRouse
    loops = (None, (0, -1), (0, 10))[:n_states]
    return MultiStateRouse(20, 1.0, 5.0, d=3, looppositions=loops,
                           localization_error=localization_error)


def rouse_parity(model, T, P, seed, missing_frames=None):
    """Max relative error of `model.logL_batch` (the card's path) against
    the f64 oracle, over P profiles: half piecewise-constant, half
    per-frame random."""
    import jax
    from bild_jax.ops.oracle import msrouse_logL_numpy

    rng = np.random.default_rng(seed)
    n = model.nStates
    truth = truth_profiles(rng, 1, T, n)[0]
    traj = model.trajectory_from_loopingprofile(
        truth, missing_frames=missing_frames, key=jax.random.key(seed))
    profiles = np.concatenate([truth_profiles(rng, P // 2, T, n),
                               rng.integers(0, n, size=(P - P // 2, T))])
    got = np.asarray(model.logL_batch(profiles, traj), dtype=np.float64)
    arrs = [np.asarray(a, dtype=np.float64) for a in
            (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w)]
    want = np.array([msrouse_logL_numpy(*arrs, model._get_noise(traj), p,
                                        traj[:]) for p in profiles])
    check(np.all(np.isfinite(got)), "non-finite likelihoods")
    return float(np.max(np.abs(got - want) / np.abs(want)))


# -- phases ----------------------------------------------------------------
def phase_parity():
    with phase("parity") as out:
        cases = {
            "n2_T100_P256": (rouse_model(2), 100, 256, None),
            "n3_T1000_P64": (rouse_model(3), 1000, 64, None),
            "n2_T100_P256_gaps10_q3": (
                rouse_model(2, localization_error=[0.08, 0.1, 0.12]),
                100, 256, 0.1),
        }
        for name, (model, T, P, gaps) in cases.items():
            rel = rouse_parity(model, T, P, seed=T + P, missing_frames=gaps)
            out[name] = rel
            check(rel <= PARITY_RTOL, f"parity {name}: {rel:.3g} > "
                                      f"{PARITY_RTOL:g}")
        rel = kernel_vs_scan(8192, 100)
        out["kernel_vs_f32_scan_P8192_T100"] = rel
        check(rel <= PARITY_RTOL, f"kernel vs scan: {rel:.3g}")


def kernel_vs_scan(P, T):
    """Max relative difference of the CUDA kernel from the float32 XLA
    scan over P profiles (half piecewise-constant, half per-frame random)."""
    import jax
    from bild_jax.ops.kalman import msrouse_logL_batch
    from bild_jax.ops.kalman_cuda import msrouse_logL_cuda

    model = rouse_model(2)
    rng = np.random.default_rng(P)
    traj = model.trajectory_from_loopingprofile(
        truth_profiles(rng, 1, T, 2)[0], key=jax.random.key(P))
    s2, Cind = model._noise_arrays(traj)
    profiles = np.concatenate([truth_profiles(rng, P // 2, T, 2),
                               rng.integers(0, 2, size=(P - P // 2, T))])
    args = (model.Bs, model.Gs, model._filter_Sigs, model.M0s, model.C0s,
            model.w, s2, Cind, profiles, traj.data, traj.valid)
    got, want = (np.asarray(f(*args), np.float64)
                 for f in (msrouse_logL_cuda, msrouse_logL_batch))
    check(np.all(np.isfinite(got)), "non-finite kernel likelihoods")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def phase_sample():
    import jax
    import bild_jax as bild
    with phase("sample") as out:
        model = rouse_model(2)
        true = np.zeros(100, dtype=int)
        true[30:60] = 1
        traj = model.trajectory_from_loopingprofile(true, key=jax.random.key(42))
        lls = np.asarray(model.logL_batch(
            np.stack([true, 0 * true, 0 * true + 1]), traj))
        check(np.argmax(lls) == 0, f"true profile does not win: {lls}")
        res = bild.sample(traj, model, key=jax.random.key(7))
        res2 = bild.sample(traj, model, key=jax.random.key(7))
        acc = frame_accuracy([res.best_profile()[:]], [true])
        out.update(frame_accuracy=acc, best_k=int(res.best_k()),
                   n_samplers=len(res.k))
        check(acc >= 0.9, f"sample frame accuracy {acc}")
        check(np.array_equal(res.evidence, res2.evidence)
              and np.array_equal(res.best_profile()[:],
                                 res2.best_profile()[:]),
              "same key, different result")


def phase_sample_batch():
    import jax
    from bild_jax.parallel import sample_batch
    for name, (n, B, T, k_max, seed) in BATCH_SHAPES.items():
        with phase(f"sample_batch {name}") as out:
            model = rouse_model(n)
            truths = truth_profiles(np.random.default_rng(seed), B, T, n)
            batch = model.trajectories_from_loopingprofiles(
                truths, key=jax.random.key(0))
            res = sample_batch(model, batch, k_max=k_max, informed_init=True,
                               key=jax.random.key(seed), **AMIS_KW)
            fa = frame_accuracy(res.best_profile(), truths)
            sa = switch_accuracy(res.best_k(), truths)
            out.update(frame_accuracy=fa, switch_count_accuracy=sa)
            check(fa >= 0.95 and sa >= 0.6,
                  f"{name}: accuracy frame={fa} switch={sa}")


def dataset_trajectories(model, B, T, seed):
    import jax
    from bild_jax import Trajectory
    truths = truth_profiles(np.random.default_rng(seed), B, T, 2)
    batch = model.trajectories_from_loopingprofiles(
        truths, key=jax.random.key(seed))
    data = np.asarray(batch.data)
    return [Trajectory.create(x, localization_error=model.localization_error)
            for x in data], truths


def dataset_kwargs(seed):
    import jax
    return dict(k_max=4, chunk_size=CHUNK, key=jax.random.key(seed),
                **AMIS_KW)


def phase_sample_dataset():
    from scipy.special import logsumexp
    from bild_jax.parallel import sample_dataset
    with phase(f"sample_dataset B{DATASET_B}_T{DATASET_T}") as out, \
            tempfile.TemporaryDirectory() as ckpt:
        model = rouse_model(2)
        trajs, truths = dataset_trajectories(model, DATASET_B, DATASET_T,
                                             seed=5)
        kw = dict(dataset_kwargs(5), marginals=True, optimize_boundaries=True,
                  checkpoint_dir=ckpt)
        t0 = time.perf_counter()
        res = sample_dataset(model, trajs, **kw)
        out["first_run_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        again = sample_dataset(model, trajs, **kw)
        out["rerun_s"] = round(time.perf_counter() - t0, 2)
        check(len(os.listdir(ckpt)) >= 2, "no chunk checkpoints written")
        check(np.array_equal(res.evidence, again.evidence)
              and all(np.array_equal(a, b) for a, b in
                      zip(res.optimized, again.optimized)),
              "checkpoint rerun differs")
        fa = frame_accuracy(res.best_profile(), truths)
        fo = frame_accuracy(res.optimized, truths)
        sa = switch_accuracy(res.best_k(), truths)
        post = res.log_marginal_posterior(dE="average")
        norm = max(float(np.max(np.abs(logsumexp(p, axis=0)))) for p in post)
        out.update(frame_accuracy=fa, frame_accuracy_postproc=fo,
                   switch_count_accuracy=sa, marginal_norm_err=norm)
        check(fa >= 0.95 and fo >= 0.95 and sa >= 0.6,
              f"dataset accuracy frame={fa} postproc={fo} switch={sa}")
        check(norm < 1e-3, f"marginals not normalized: {norm}")


def phase_ggm():
    import jax
    from bild_jax.models import GenericGaussianModel as GGM
    from bild_jax.parallel import sample_batch, stack_trajectories
    with phase("ggm") as out:
        rng = np.random.default_rng(6)
        model = GGM([
            [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
            [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
        ])
        truths = truth_profiles(rng, GGM_B, GGM_T, 2)
        trajs = [model.trajectory_from_loopingprofile(t, rng=rng)
                 for t in truths]
        gappy = model.trajectory_from_loopingprofile(truths[0], rng=rng,
                                                     missing_frames=0.1)
        profiles = truth_profiles(rng, 32, GGM_T, 2)
        for name, traj in (("gap_free", trajs[0]), ("nan_frames", gappy)):
            got = np.asarray(model.logL_batch(profiles, traj), np.float64)
            want = np.array([model.logL_host(p, traj) for p in profiles])
            rel = float(np.max(np.abs(got - want) / np.abs(want)))
            out[f"parity_{name}"] = rel
            check(rel <= PARITY_RTOL, f"GGM parity {name}: {rel:.3g}")
        res = sample_batch(model, stack_trajectories(trajs), k_max=4,
                           key=jax.random.key(6), **AMIS_KW)
        fa = frame_accuracy(res.best_profile(), truths)
        out["frame_accuracy"] = fa
        check(fa >= 0.85, f"GGM frame accuracy {fa}")


def phase_cli():
    from bild_jax.__main__ import main
    with phase("cli") as out, tempfile.TemporaryDirectory() as tmp:
        model = rouse_model(2)
        trajs, truths = dataset_trajectories(model, CLI_B, 100, seed=9)
        rng = np.random.default_rng(9)
        csv = os.path.join(tmp, "tracks.csv")
        with open(csv, "w") as f:
            f.write("traj_id,frame,x1,y1,z1,x2,y2,z2\n")
            for i, tr in enumerate(trajs):
                rel = tr[:]
                first = np.cumsum(rng.normal(size=rel.shape), axis=0)
                for t, (a, b) in enumerate(zip(first, first + rel)):
                    f.write(f"{i},{t}," + ",".join(f"{v:.6f}" for v in
                                                   (*a, *b)) + "\n")
        npz = os.path.join(tmp, "out.npz")
        amis = [f"--{k}={v}" for k, v in (
            ("steps-per-k", AMIS_KW["steps_per_k"]),
            ("proposals", AMIS_KW["N"]),
            ("scout-steps", AMIS_KW["scout_steps"]),
            ("refine-top", AMIS_KW["refine_top"]))]
        rc = main([csv, "--two-locus", "--out", npz, "--k-max=4", *amis,
                   f"--chunk-size={CHUNK}", "--optimize-boundaries",
                   "--checkpoint-dir", os.path.join(tmp, "ckpt"), "--quiet"])
        check(rc == 0, f"CLI rc={rc}")
        got = np.load(npz, allow_pickle=True)
        fa = frame_accuracy(got["optimized_profiles"], truths)
        out["frame_accuracy"] = fa
        check(fa >= 0.9, f"CLI frame accuracy {fa}")


def phase_four_cards():
    """`sample_dataset` over a 4-card data mesh against a 1-device mesh."""
    import jax
    from bild_jax.parallel import make_mesh, sample_dataset
    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}")
    model = rouse_model(2)
    trajs, truths = dataset_trajectories(model, FOUR_CARD_B, 100, seed=11)
    runs = {}
    for name, mesh in (("mesh4", make_mesh(axis_names=("data",))),
                       ("mesh1", make_mesh(axis_names=("data",),
                                           devices=devs[:1]))):
        with phase(f"sample_dataset B{FOUR_CARD_B} {name}") as out:
            t0 = time.perf_counter()
            runs[name] = sample_dataset(model, trajs, mesh=mesh,
                                        **dataset_kwargs(11))
            out["wall_s"] = round(time.perf_counter() - t0, 2)
            out["frame_accuracy"] = frame_accuracy(
                runs[name].best_profile(), truths)
    with phase("four_cards compare") as out:
        a, b = runs["mesh4"], runs["mesh1"]
        out.update(compare_runs(a, b, block_rows=CHUNK // len(devs)))
        check(out["identical_best_k"] and out["best_k_within_z_limit"]
              and out["min_block_frac_agree_within_mnat"]
              >= FOUR_CARD_BLOCK_AGREE,
              f"mesh vs 1-device: best_k same={out['identical_best_k']}, "
              f"best-k z up to {out['max_z_best_k']:.3g}, worst block "
              f"agrees in {out['min_block_frac_agree_within_mnat']:.3g}")


def compare_runs(a, b, block_rows):
    """Agreement of two results on the same trajectories (rows of
    ``evidence``): best k and MAP profiles, and the evidence of every finite
    (trajectory, k) lane, in nats and in combined standard errors (z); and
    the least share of lanes within 1e-3 nats over blocks of ``block_rows``
    rows at one k."""
    fin = np.isfinite(a.evidence) & np.isfinite(b.evidence)
    check(np.array_equal(fin, np.isfinite(a.evidence))
          and np.array_equal(fin, np.isfinite(b.evidence)),
          "finite evidence pattern differs")
    dE = np.abs(a.evidence - b.evidence)
    se = np.hypot(a.evidence_se, b.evidence_se)
    z = dE[fin] / np.maximum(se[fin], 1e-300)
    rows = np.arange(len(a.evidence))
    k = a.best_k()
    dE_best, se_best = dE[rows, k], se[rows, k]
    agree_k = [float(np.mean(dE[:, j][fin[:, j]] <= 1e-3))
               for j in range(dE.shape[1]) if fin[:, j].any()]
    agree_blocks = [np.mean(blk[f] <= 1e-3)
                    for lo in range(0, len(dE), block_rows)
                    for blk, f in zip(dE[lo:lo + block_rows].T,
                                      fin[lo:lo + block_rows].T) if f.any()]
    return dict(
        identical_best_k=bool(np.array_equal(k, b.best_k())),
        identical_best_profile_frac=float(np.mean([
            np.array_equal(p, q) for p, q in zip(a.best_profile(),
                                                 b.best_profile())])),
        lane_frac_agree_within_mnat=float(np.mean(dE[fin] <= 1e-3)),
        lane_frac_agree_within_mnat_by_k=agree_k,
        min_block_frac_agree_within_mnat=float(np.min(agree_blocks)),
        max_abs_evidence_diff=float(np.max(dE[fin])),
        max_abs_evidence_diff_best_k=float(np.max(dE_best)),
        max_z_best_k=float(np.max(dE_best / np.maximum(se_best, 1e-300))),
        best_k_within_z_limit=bool(np.all(
            dE_best <= FOUR_CARD_Z * se_best + 1e-3)),
        max_z_all_lanes=float(np.max(z)),
        lane_frac_z_within_limit=float(np.mean(z <= FOUR_CARD_Z)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only sample_dataset over a 4-card data mesh "
                         "and its 1-device comparison")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "bild_jax")):
        fail(f"no bild_jax package next to {__file__}")
    smi = nvidia_smi()
    if not args.four_cards:
        tests_summary, tests_s = run_card_tests()

    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    dev = require_gpu()
    import jax
    from bild_jax.config import enable_compilation_cache
    cache = enable_compilation_cache()
    print(smi, flush=True)
    print(f"[device] ok jax={jax.__version__} platform={dev.platform} "
          f"kind={dev.device_kind!r} count={len(jax.devices())} "
          f"cache={cache} wall_s={time.perf_counter() - t0:.2f}", flush=True)

    if args.four_cards:
        phase_four_cards()
    else:
        print(f"[card tests] ok {tests_summary} wall_s={tests_s:.2f}",
              flush=True)
        phase_parity()
        phase_sample()
        phase_sample_batch()
        phase_sample_dataset()
        phase_ggm()
        phase_cli()

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
