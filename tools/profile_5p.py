"""Per-chunk phase timing for bench_e2e config 5p.

Decomposes the 10,240-trajectory north-star run into per-chunk phases
(host data generation, device inference, boundary postproc, marginal
extraction) to attribute wall-time variance between runs: steady-state
device throughput vs host-side work vs one-time compiles.  Writes one JSON line per chunk plus a summary.

Usage: python tools/profile_5p.py [--chunks N]
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
    ap.add_argument("--chunks", type=int, default=10)
    args = ap.parse_args()

    import jax
    from bild_jax.config import enable_compilation_cache
    enable_compilation_cache()
    from bild_jax.models import MultiStateRouse
    from bild_jax.parallel import sample_batch
    from bild_jax.postproc import optimize_boundary_batch
    from bench_e2e import _truth_profiles, _accuracy, _switch_accuracy

    rng = np.random.default_rng(5)
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    chunk = 1024
    rows = []
    t_start = time.perf_counter()
    for c in range(args.chunks):
        t0 = time.perf_counter()
        truths = _truth_profiles(rng, chunk, 100, 2)
        batch = model.trajectories_from_loopingprofiles(
            truths, key=jax.random.key(100 + c))
        jax.block_until_ready(batch.data)
        t1 = time.perf_counter()
        res = sample_batch(model, batch, k_max=4, steps_per_k=12, N=128,
                           informed_init=True, scout_steps=4, refine_top=3,
                           marginals=True, key=jax.random.key(200 + c))
        profiles = res.best_profile()  # forces device->host
        t2 = time.perf_counter()
        acc = _accuracy(profiles, truths)
        sw = _switch_accuracy(res.best_k(), truths)
        t3 = time.perf_counter()
        opt, _ = optimize_boundary_batch(profiles, batch, model)
        t4 = time.perf_counter()
        logpost = res.log_marginal_posterior(dE="average")
        picked = np.take_along_axis(
            np.exp(logpost), np.asarray(opt)[:, None, :], axis=1)
        cred = float(np.mean(picked))
        t5 = time.perf_counter()
        row = {
            "chunk": c,
            "datagen_s": round(t1 - t0, 3),
            "inference_s": round(t2 - t1, 3),
            "accuracy_host_s": round(t3 - t2, 3),
            "postproc_s": round(t4 - t3, 3),
            "marginals_s": round(t5 - t4, 3),
            "total_s": round(t5 - t0, 3),
            "frame_accuracy": acc,
            "mean_credibility": round(cred, 4),
            "_unused_sw": sw,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    total = time.perf_counter() - t_start
    steady = [r["total_s"] for r in rows[1:]] or [rows[0]["total_s"]]
    summary = {
        "summary": True,
        "chunks": args.chunks,
        "wall_minutes": round(total / 60, 3),
        "first_chunk_s": rows[0]["total_s"],
        "steady_mean_s": round(float(np.mean(steady)), 3),
        "steady_std_s": round(float(np.std(steady)), 3),
        "phase_means_steady": {
            k: round(float(np.mean([r[k] for r in rows[1:]] or
                                   [rows[0][k]])), 3)
            for k in ("datagen_s", "inference_s", "accuracy_host_s",
                      "postproc_s", "marginals_s")
        },
    }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
