"""
End-to-end example: dataset-scale looping inference.

1. Load trajectories from a CSV table (native C++ parser) or synthesize them.
2. `sample_dataset`: buckets ragged lengths, chunks, lockstep-infers
   across all devices with the scout/refine budget schedule.
3. Report per-trajectory best profiles + switch-count posterior summary.

Run:  python examples/infer_dataset.py [dataset.csv]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

import bild_jax as bild
from bild_jax.parallel import make_mesh, sample_dataset


def synthesize(model, B=64, T=100, seed=0):
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed), B)
    trajs = []
    for i in range(B):
        prof = np.zeros(T, dtype=int)
        if rng.random() < 0.7:
            a, b = sorted(rng.integers(1, T - 1, size=2))
            prof[a:b] = 1
        trajs.append(model.trajectory_from_loopingprofile(prof, key=keys[i]))
    return trajs


def main(csv_path=None):
    # BILD_SMOKE=1: tiny shapes so CI can exercise this end-to-end cheaply.
    # The CLI argument is only consulted when run as a script — main() may
    # be imported and called under another process's argv (e.g. pytest,
    # whose argv[1] is a test directory, not a CSV).
    smoke = os.environ.get("BILD_SMOKE") == "1"
    if csv_path is None and __name__ == "__main__" and len(sys.argv) > 1:
        csv_path = sys.argv[1]
    # flagship 2-state (unlooped/looped) Rouse model, dual-color 3d readout
    model = bild.models.MultiStateRouse(8 if smoke else 20, D=1, k=5, d=3,
                                        localization_error=0.1)

    if csv_path is not None:
        trajs = bild.io.load_trajectories_csv(csv_path, two_locus=True,
                                              localization_error=0.1)
        print(f"loaded {len(trajs)} trajectories from {csv_path}")
    else:
        trajs = synthesize(model, B=6, T=24) if smoke else synthesize(model)
        print(f"synthesized {len(trajs)} trajectories")

    mesh = make_mesh()
    print(f"devices: {mesh.devices.size}")

    # sample_dataset owns bucketing, chunking, and original-order
    # reassembly; the scouted schedule spends the full budget only on each
    # trajectory's most plausible switch counts. (For manual control over
    # buckets, see `bucket_trajectories` + `sample_batch`.)
    t0 = time.time()
    res = sample_dataset(model, trajs, k_max=2 if smoke else 4,
                         steps_per_k=3 if smoke else 15, N=32 if smoke else 128,
                         scout_steps=None if smoke else 4, refine_top=3,
                         informed_init=True, mesh=mesh,
                         key=jax.random.key(42))
    best_k = res.best_k(dE=0)
    profiles = res.best_profile()
    print(f"k histogram {np.bincount(best_k, minlength=5)}")
    for i in range(min(3, len(trajs))):
        print(f"  traj {i}: k={best_k[i]}, "
              f"profile {''.join(map(str, profiles[i][:40]))}...")

    # dataset-level dwell-time statistics: censored samples per state ->
    # exponential mean with confidence interval (stats.dwell_times bridges
    # inferred profiles to the survival estimators)
    from bild_jax import stats
    for s in range(model.nStates):
        dur, cen = stats.dwell_times(profiles, s)
        if np.count_nonzero(~cen):
            m, lo, hi = stats.MLE_censored_exponential(dur, cen)
            print(f"  state {s}: {dur.size} dwells, exp mean {m:.2f} frames "
                  f"(95% CI [{lo:.2f}, {hi:.2f}])")
    print(f"total wall: {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
