"""
Fixed-lockstep vs adaptive-scheduler comparison on the PERF configs.

For each config (3: B=128/T=100/2-state, 4: B=16/T=1000/3-state, 5: the
10,240-trajectory dataset), runs the fixed schedule (`sample_batch`, the
shipped scout/refine defaults from bench_e2e.py) and the adaptive scheduler
(`sample_batch_adaptive`) on the SAME synthetic data, and records frame /
switch-count accuracy, wall-clock, and likelihood evals per trajectory
(fixed: the schedule constant; adaptive: measured per trajectory, with a
histogram). Writes one JSON artifact.

Usage:  python tools/adaptive_compare.py [--configs 3,4] [--out ADAPTIVE.json]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench_e2e import _truth_profiles, _accuracy, _switch_accuracy  # noqa: E402


def _hist(evals):
    evals = np.asarray(evals)
    qs = np.percentile(evals, [0, 10, 25, 50, 75, 90, 100])
    counts, edges = np.histogram(evals, bins=10)
    return {
        "mean": float(evals.mean()),
        "quantiles_0_10_25_50_75_90_100": [int(q) for q in qs],
        "hist_counts": counts.tolist(),
        "hist_edges": [int(e) for e in edges],
    }


def _run_pair(model, truths, batch, fixed_kw, adaptive_kw, key_fixed,
              key_adaptive):
    import jax
    from bild_jax.parallel import sample_batch, sample_batch_adaptive

    # warm both programs (compiles excluded from the timed run)
    res_f = sample_batch(model, batch, key=key_fixed, **fixed_kw)
    t0 = time.perf_counter()
    res_f = sample_batch(model, batch, key=key_fixed, **fixed_kw)
    dt_f = time.perf_counter() - t0

    res_a = sample_batch_adaptive(model, batch, key=key_adaptive,
                                  **adaptive_kw)
    t0 = time.perf_counter()
    res_a = sample_batch_adaptive(model, batch, key=key_adaptive,
                                  **adaptive_kw)
    dt_a = time.perf_counter() - t0

    k_eff = min(fixed_kw["k_max"] + 1,
                int(np.min(np.asarray(batch.lengths))) if batch.lengths
                is not None else fixed_kw["k_max"] + 1)
    ss, st, rt = (fixed_kw.get("scout_steps"), fixed_kw["steps_per_k"],
                  fixed_kw.get("refine_top", 0))
    if ss:
        fixed_evals = (k_eff * ss + min(rt, k_eff) * (st - ss)) * fixed_kw["N"]
    else:
        fixed_evals = k_eff * st * fixed_kw["N"]

    return {
        "fixed": {
            "wall_s": round(dt_f, 2),
            "frame_accuracy": _accuracy(res_f.best_profile(), truths),
            "switch_count_accuracy": _switch_accuracy(res_f.best_k(), truths),
            "evals_per_traj": int(fixed_evals),
        },
        "adaptive": {
            "wall_s": round(dt_a, 2),
            "frame_accuracy": _accuracy(res_a.best_profile(), truths),
            "switch_count_accuracy": _switch_accuracy(res_a.best_k(), truths),
            "rounds": int(res_a.rounds),
            "evals": _hist(res_a.evals),
        },
        "evals_ratio_adaptive_over_fixed": round(
            float(np.mean(res_a.evals)) / fixed_evals, 3),
    }


def config3(adaptive_kw):
    import jax
    from bild_jax.models import MultiStateRouse

    rng = np.random.default_rng(3)
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    truths = _truth_profiles(rng, 128, 100, 2)
    batch = model.trajectories_from_loopingprofiles(truths,
                                                    key=jax.random.key(0))
    fixed_kw = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
                    scout_steps=4, refine_top=3)
    out = _run_pair(model, truths, batch, fixed_kw, adaptive_kw,
                    jax.random.key(3), jax.random.key(3))
    out["config"] = 3
    return out


def config4(adaptive_kw):
    import jax
    from bild_jax.models import MultiStateRouse

    rng = np.random.default_rng(4)
    model = MultiStateRouse(20, 1.0, 5.0, d=3,
                            looppositions=(None, (0, -1), (0, 10)),
                            localization_error=0.1)
    truths = _truth_profiles(rng, 16, 1000, 3)
    batch = model.trajectories_from_loopingprofiles(truths,
                                                    key=jax.random.key(0))
    fixed_kw = dict(k_max=6, steps_per_k=12, N=128, informed_init=True,
                    scout_steps=4, refine_top=3)
    kw = dict(adaptive_kw)
    kw["k_max"] = 6
    out = _run_pair(model, truths, batch, fixed_kw, kw,
                    jax.random.key(4), jax.random.key(4))
    out["config"] = 4
    return out


def config5(adaptive_kw, postproc=True):
    """The 10,240-trajectory dataset; adaptive through sample_dataset
    (one-shot: wall includes compiles, amortized over the dataset —
    same protocol as bench_e2e config 5)."""
    import jax
    from bild_jax.models import MultiStateRouse
    from bild_jax.parallel import sample_batch, sample_batch_adaptive
    from bild_jax.postproc import optimize_boundary_batch

    rng = np.random.default_rng(5)
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    B_total, chunk = 10240, 1024

    out = {"config": "5p" if postproc else 5, "B": B_total}
    for mode in ("fixed", "adaptive"):
        rngm = np.random.default_rng(5)
        t0 = time.perf_counter()
        accf = accs = cred = 0.0
        evals = []
        for c in range(B_total // chunk):
            truths = _truth_profiles(rngm, chunk, 100, 2)
            batch = model.trajectories_from_loopingprofiles(
                truths, key=jax.random.key(100 + c))
            if mode == "fixed":
                res = sample_batch(model, batch, k_max=4, steps_per_k=12,
                                   N=128, informed_init=True, scout_steps=4,
                                   refine_top=3, marginals=postproc,
                                   key=jax.random.key(200 + c))
            else:
                res = sample_batch_adaptive(model, batch, marginals=postproc,
                                            key=jax.random.key(200 + c),
                                            **adaptive_kw)
                evals.append(np.asarray(res.evals))
            profiles = res.best_profile()
            accf += _accuracy(profiles, truths)
            accs += _switch_accuracy(res.best_k(), truths)
            if postproc:
                opt, _ = optimize_boundary_batch(profiles, batch, model)
                logpost = res.log_marginal_posterior(dE="average")
                picked = np.take_along_axis(
                    np.exp(logpost), np.asarray(opt)[:, None, :], axis=1)
                cred += float(np.mean(picked))
        dt = time.perf_counter() - t0
        n_chunks = B_total // chunk
        rec = {
            "wall_minutes": round(dt / 60, 2),
            "traj_per_s": round(B_total / dt, 2),
            "frame_accuracy": round(accf / n_chunks, 4),
            "switch_count_accuracy": round(accs / n_chunks, 4),
        }
        if postproc:
            rec["mean_credibility"] = round(cred / n_chunks, 4)
        if mode == "fixed":
            rec["evals_per_traj"] = (5 * 4 + 3 * 8) * 128
        else:
            rec["evals"] = _hist(np.concatenate(evals))
        out[mode] = rec
    out["evals_ratio_adaptive_over_fixed"] = round(
        out["adaptive"]["evals"]["mean"] / out["fixed"]["evals_per_traj"], 3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="3,4")
    ap.add_argument("--out", default="ADAPTIVE.json")
    ap.add_argument("--init-steps", type=int, default=4)
    ap.add_argument("--steps-per-round", type=int, default=2)
    ap.add_argument("--max-steps-per-k", type=int, default=24)
    ap.add_argument("--samplesize", type=int, default=4096)
    args = ap.parse_args()

    from bild_jax.config import enable_compilation_cache
    enable_compilation_cache()

    adaptive_kw = dict(k_max=4, N=128, informed_init=True,
                       init_steps=args.init_steps,
                       steps_per_round=args.steps_per_round,
                       max_steps_per_k=args.max_steps_per_k,
                       samplesize=args.samplesize)

    runners = {"3": lambda: config3(adaptive_kw),
               "4": lambda: config4(adaptive_kw),
               "5": lambda: config5(adaptive_kw, postproc=False),
               "5p": lambda: config5(adaptive_kw, postproc=True)}
    results = {}
    for c in (x.strip() for x in args.configs.split(",")):
        print(f"== config {c} ==", flush=True)
        results[c] = runners[c]()
        print(json.dumps(results[c]), flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
