"""
Config-4 switch-count forensics (VERDICT r3 #8): is the ~0.7 best_k
accuracy at T=1000 / 3-state posterior-honest, or a sampler miss at fine
switch resolution?

Method (same per-miss protocol that closed config 6, DESIGN.md section 7e):
regenerate the EXACT config-4 dataset (seed 4 / key 4), rerun the config-4
lockstep schedule, and additionally

  - repeat the base-budget run under several PRNG keys (key-to-key
    accuracy variance: is the metric itself stable?),
  - run a 4x budget schedule (steps_per_k 12 -> 48, scout 4 -> 8,
    refine_top 3 -> 5): a budget-starved sampler improves with budget, a
    posterior-honest one tracks the (flat) evidence landscape,
  - for EVERY miss of every run record under/over selection, logL(truth)
    vs logL(found MAP) under the model (does the data itself prefer the
    found profile?), and the evidence gap in units of the AMIS SEs.

Prints one JSON row per miss and a summary verdict. Runs wherever JAX runs
(designed for an accelerator; CPU x64 works but is ~10 min).

Usage: python tools/forensics_config4.py [--out /tmp/config4_forensics.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/config4_forensics.json")
    ap.add_argument("--big-steps", type=int, default=48)
    ap.add_argument("--keys", default="4,104,204",
                    help="PRNG keys for base-budget repeats")
    args = ap.parse_args()

    import jax
    from bild_jax.models import MultiStateRouse
    from bild_jax.parallel import sample_batch
    from bild_jax.trajectory import Trajectory
    from bench_e2e import _truth_profiles

    rng = np.random.default_rng(4)
    model = MultiStateRouse(20, 1.0, 5.0, d=3,
                            looppositions=(None, (0, -1), (0, 10)),
                            localization_error=0.1)
    truths = _truth_profiles(rng, 16, 1000, 3)
    true_k = np.sum(truths[:, 1:] != truths[:, :-1], axis=1)
    batch = model.trajectories_from_loopingprofiles(truths,
                                                    key=jax.random.key(0))

    def analyze(res, tag):
        """Per-miss rows: does the DATA prefer the found profile?"""
        best_k = np.asarray(res.best_k())
        maps = np.asarray(res.best_profile())
        ev = np.asarray(res.evidence)                # (B, K+1)
        se = np.asarray(res.evidence_se)
        rows = []
        for b in np.flatnonzero(best_k != true_k):
            traj = Trajectory(data=np.asarray(batch.data[b]),
                              valid=np.asarray(batch.valid[b]))
            ll = np.asarray(model.logL_batch(
                np.stack([truths[b], maps[b]]), traj))
            gap_k = ev[b, best_k[b]] - ev[b, true_k[b]]
            gap_se = np.sqrt(se[b, best_k[b]] ** 2 + se[b, true_k[b]] ** 2)
            rows.append({
                "run": tag,
                "b": int(b),
                "true_k": int(true_k[b]),
                "best_k": int(best_k[b]),
                "under": bool(best_k[b] < true_k[b]),
                "logL_truth": round(float(ll[0]), 2),
                "logL_found_map": round(float(ll[1]), 2),
                "data_prefers_found": bool(ll[1] >= ll[0]),
                "evidence_gap_nats": round(float(gap_k), 3),
                "evidence_gap_se": round(float(gap_se), 3),
                "frame_acc": round(float(np.mean(maps[b] == truths[b])), 4),
            })
            print(json.dumps(rows[-1]), flush=True)
        return best_k, rows

    base_kw = dict(k_max=6, steps_per_k=12, N=128, informed_init=True,
                   scout_steps=4, refine_top=3)
    all_rows, accs, votes = [], {}, []
    for key in (int(x) for x in args.keys.split(",")):
        t0 = time.perf_counter()
        res = sample_batch(model, batch, key=jax.random.key(key), **base_kw)
        dt = time.perf_counter() - t0
        best_k, rows = analyze(res, f"base_key{key}")
        all_rows += rows
        votes.append(best_k)
        accs[f"base_key{key}"] = round(float(np.mean(best_k == true_k)), 4)
        print(f"base key={key}: {dt:.1f}s acc={accs[f'base_key{key}']}",
              flush=True)

    t0 = time.perf_counter()
    res_big = sample_batch(model, batch, key=jax.random.key(44),
                           k_max=6, steps_per_k=args.big_steps, N=128,
                           informed_init=True, scout_steps=8, refine_top=5)
    dt = time.perf_counter() - t0
    best_k_big, rows = analyze(res_big, "big_key44")
    all_rows += rows
    accs["big_key44"] = round(float(np.mean(best_k_big == true_k)), 4)
    print(f"4x budget: {dt:.1f}s acc={accs['big_key44']}", flush=True)

    # per-row stability across base keys: rows whose best_k is unanimous
    votes = np.stack(votes)                          # (n_keys, B)
    unanimous = np.all(votes == votes[0], axis=0)
    stable_correct = unanimous & (votes[0] == true_k)
    stable_wrong = unanimous & (votes[0] != true_k)

    n_data = sum(r["data_prefers_found"] for r in all_rows)
    summary = {
        "accuracies": accs,
        "n_rows": int(len(true_k)),
        "n_stable_correct": int(np.sum(stable_correct)),
        "n_stable_wrong": int(np.sum(stable_wrong)),
        "n_key_dependent": int(np.sum(~unanimous)),
        "n_miss_rows_total": len(all_rows),
        "n_data_prefers_found": n_data,
    }
    print(json.dumps(summary), flush=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "misses": all_rows}, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
