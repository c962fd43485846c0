"""
Multi-chip weak-scaling evidence on a VIRTUAL device mesh (VERDICT r2 #8).

This measures mesh overhead, not device speed: it runs
`parallel.sample_batch` on an
``xla_force_host_platform_device_count`` CPU mesh at FIXED PER-DEVICE LOAD
(B = B_per_dev * n_dev) for n_dev in 1, 2, 4, 8.

Interpretation on virtual devices: all "devices" share the host's cores, so
ideal weak scaling is wall(n) ~= n * wall(1) (the work grows n-fold but the
silicon doesn't). The reported ``overhead(n) = wall(n) / (n * wall(1))``
isolates everything that is NOT the per-device compute — host-side per-k
prep, sharding/layout transfers, collective scheduling. overhead ~ 1 means
no hidden serialization rides along with device count; that is the part of
weak scaling this environment can falsify. (On real chips the same program
would target wall(n) ~= wall(1).)

Also asserts mesh-run results equal the unsharded single-device run on the
same batch rows (data parallelism must not change the math).

``--decompose`` additionally runs every batch size UNSHARDED on one virtual
device. Virtual devices share the host's cores (one XLA:CPU thread pool), so
the unsharded B=128 run uses the same silicon as the 8-device mesh run — the
only difference is the mesh machinery (sharding layouts, collective
scheduling, multi-device dispatch). If the unsharded per-row cost grows with
B by the same factor as the mesh overhead curve, the "overhead" is
working-set growth on shared CPU silicon (cache pressure — an artifact of
virtualizing the mesh onto one host), not anything the mesh adds; on real
chips per-device working set stays constant by construction. See DESIGN.md
"Weak-scaling overhead attribution".

Usage: python bench_scaling.py [--b-per-dev 16] [--out SCALING.json]
                               [--decompose]
"""
import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b-per-dev", type=int, default=16)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--out", default="SCALING.json")
    ap.add_argument("--decompose", action="store_true",
                    help="also run each B unsharded on one device to "
                         "separate mesh overhead from working-set growth")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repeats per cell; medians and spreads are "
                         "reported and claims assert on the MEDIAN "
                         "(single-cell timings on this host carry a ~10%% "
                         "noise band - VERDICT r4 weak point 3)")
    args = ap.parse_args()
    devs = [int(x) for x in args.devices.split(",")]
    n_max = max(devs)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_max}").strip()

    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from bild_jax.models import MultiStateRouse
    from bild_jax.parallel import sample_batch

    from bench_e2e import _truth_profiles, _accuracy

    rng = np.random.default_rng(8)
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    B_max = args.b_per_dev * n_max
    truths = _truth_profiles(rng, B_max, 100, 2)
    batch_full = model.trajectories_from_loopingprofiles(
        truths, key=jax.random.key(0))

    kw = dict(k_max=4, steps_per_k=8, N=64, informed_init=True,
              scout_steps=4, refine_top=2)

    results = {"b_per_dev": args.b_per_dev, "runs": []}
    wall1 = None
    ref_best = None
    for n in devs:
        B = args.b_per_dev * n
        from bild_jax.parallel.batch import TrajectoryBatch
        batch = TrajectoryBatch(data=batch_full.data[:B],
                                valid=batch_full.valid[:B],
                                lengths=batch_full.lengths[:B])
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

        def run():
            return sample_batch(model, batch, mesh=mesh,
                                key=jax.random.key(42), **kw)

        res = run()                    # warm (compiles per B shape)
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = run()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))

        if n == 1:
            wall1 = wall
        elif ref_best is None:
            # Data-parallel sharding must not change the math: the SAME
            # batch on a 1-device mesh gives bit-identical profiles.
            # (Comparing across different global B is not a sharding claim:
            # B=16 and B=32 are different compiled programs, and a
            # borderline scout ranking can legitimately flip on a row —
            # observed once in 16 rows on CPU f32.)
            ref = sample_batch(model, batch,
                               mesh=Mesh(np.array(jax.devices()[:1]),
                                         ("data",)),
                               key=jax.random.key(42), **kw)
            ref_best = np.asarray(ref.best_profile())
            assert np.array_equal(np.asarray(res.best_profile()),
                                  ref_best), \
                "mesh run diverged from single-device run on the same batch"

        overhead = wall / (n * wall1)
        acc = _accuracy(res.best_profile(), truths[:B])
        row = {"n_dev": n, "B": B, "wall_s": round(wall, 2),
               "wall_s_all": [round(w, 2) for w in walls],
               "wall_s_spread": [round(min(walls), 2), round(max(walls), 2)],
               "overhead_vs_ideal": round(overhead, 3),
               "frame_accuracy": round(acc, 4)}

        if args.decompose:
            # same B, NO mesh: one virtual device, same shared CPU silicon.
            # run_unsh/(n*unsh1) isolates working-set growth; the mesh's own
            # cost is the mesh wall minus this.
            def run_unsharded():
                return sample_batch(model, batch, mesh=None,
                                    key=jax.random.key(42), **kw)
            run_unsharded()
            walls_u = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                run_unsharded()
                walls_u.append(time.perf_counter() - t0)
            wall_u = float(np.median(walls_u))
            row["wall_unsharded_s"] = round(wall_u, 2)
            row["wall_unsharded_s_spread"] = [round(min(walls_u), 2),
                                              round(max(walls_u), 2)]
            if n == 1:
                results["_unsh1"] = wall_u
            row["overhead_unsharded"] = round(
                wall_u / (n * results["_unsh1"]), 3)
            row["mesh_machinery_overhead"] = round(wall / wall_u, 3)

        results["runs"].append(row)
        print(json.dumps(row), flush=True)

    results.pop("_unsh1", None)
    if args.decompose:
        # the claim: mesh machinery adds <= 5% on the MEDIAN of every cell
        meds = [r["mesh_machinery_overhead"] for r in results["runs"]]
        results["mesh_machinery_overhead_max_median"] = round(max(meds), 3)
        results["claim_mesh_overhead_le_1.05"] = bool(max(meds) <= 1.05)
    results["reps"] = args.reps
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
