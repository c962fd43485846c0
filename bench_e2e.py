"""
End-to-end benchmarks: BASELINE.md north-star configs 2-5.

Each config runs a full inference workload on the default device and records
wall-clock, throughput, and accuracy against the generating truth. Results
are written as JSON (one dict per config) to ``--out`` and printed.

Configs (BASELINE.md "North-star targets"):
  2  adaptive `sample` on one 2-locus trajectory (T=100, 2-state Rouse),
     plus the on-device f32-kernel vs f64-oracle parity check
  3  128 synthetic 3-d dual-color trajectories, joint lockstep inference
     (throughput metric: trajectories/s warm)
  4  3-state model, T=1000 frames, batched lockstep AMIS
  5  10,240-trajectory dataset, single chip (the "10k trajectories in
     minutes" target; pass --configs 5 explicitly, it runs ~2-10 min)
  5p config 5 + batched boundary postproc + evidence-averaged marginal
     posteriors (the full "10k + postproc credible intervals" north star)
  6  GenericGaussianModel dataset inference (device interval tables)

Usage:
  python bench_e2e.py [--configs 2,3,4] [--out PERF.json]
"""
import argparse
import json
import time

import numpy as np


def _truth_profiles(rng, B, T, n_states, k_max=4):
    """Random piecewise-constant truth profiles with 0..k_max switches."""
    profs = np.zeros((B, T), dtype=int)
    for b in range(B):
        k = int(rng.integers(0, k_max + 1))
        cuts = np.sort(rng.choice(np.arange(1, T), size=k, replace=False))
        bounds = np.concatenate([[0], cuts, [T]])
        s = int(rng.integers(0, n_states))
        for i in range(k + 1):
            profs[b, bounds[i]:bounds[i + 1]] = s
            choices = [c for c in range(n_states) if c != s]
            s = int(rng.choice(choices))
    return profs


def _accuracy(best_profiles, truths):
    return float(np.mean(np.asarray(best_profiles) == np.asarray(truths)))


def _switch_accuracy(best_k, truths):
    true_k = np.sum(truths[:, 1:] != truths[:, :-1], axis=1)
    return float(np.mean(np.asarray(best_k) == true_k))


def config2():
    """Adaptive single-trajectory inference + kernel parity artifact."""
    import jax
    import bild_jax as bild
    from bild_jax.models import MultiStateRouse
    from bild_jax.ops.oracle import msrouse_logL_numpy

    rng = np.random.default_rng(2)
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    truth = np.zeros(100, dtype=int)
    truth[30:60] = 1
    truth[75:90] = 1
    traj = model.trajectory_from_loopingprofile(truth, key=jax.random.key(42))

    # device-kernel vs f64-oracle parity (BASELINE.md line 35: 1e-6 rtol
    # target; on-device f32 measured here, exact-f64 parity covered by CI)
    profiles = rng.integers(0, 2, size=(64, 100))
    dev = np.asarray(model.logL_batch(profiles, traj), dtype=float)
    Bs, Gs, Sigs, M0s, C0s = (np.asarray(a, dtype=np.float64) for a in
                              (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s))
    oracle = np.array([
        msrouse_logL_numpy(Bs, Gs, Sigs, M0s, C0s,
                           np.asarray(model.w, dtype=np.float64),
                           model._get_noise(traj), p, traj[:])
        for p in profiles])
    parity = float(np.max(np.abs((dev - oracle) / oracle)))

    def run():
        return bild.sample(traj, model, key=jax.random.key(7))

    res = run()                       # warm (compiles)
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0

    best = np.asarray(res.best_profile()[:])
    return {
        "config": 2,
        "wall_s_warm": round(dt, 2),
        "n_samplers": len(res.k),
        "best_k": int(res.best_k()),
        "true_k": int(np.sum(truth[1:] != truth[:-1])),
        "frame_accuracy": _accuracy(best[None], truth[None]),
        "kernel_parity_rel_vs_f64_oracle": parity,
    }


def _lockstep(model, truths, key, **kw):
    import jax
    from bild_jax.parallel import sample_batch

    batch = model.trajectories_from_loopingprofiles(truths, key=jax.random.key(0))

    def run():
        return sample_batch(model, batch, key=key, **kw)

    res = run()                       # warm
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    return res, dt


def config3():
    """128-trajectory joint lockstep inference (T=100, 3-d, 2-state)."""
    import jax
    from bild_jax.models import MultiStateRouse

    rng = np.random.default_rng(3)
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    truths = _truth_profiles(rng, 128, 100, 2)
    res, dt = _lockstep(model, truths, jax.random.key(3),
                        k_max=4, steps_per_k=12, N=128, informed_init=True,
                        scout_steps=4, refine_top=3)
    return {
        "config": 3,
        "B": 128,
        "wall_s_warm": round(dt, 2),
        "traj_per_s": round(128 / dt, 2),
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
    }


def config4():
    """3-state model, T=1000, batched lockstep AMIS."""
    import jax
    from bild_jax.models import MultiStateRouse

    rng = np.random.default_rng(4)
    model = MultiStateRouse(20, 1.0, 5.0, d=3,
                            looppositions=(None, (0, -1), (0, 10)),
                            localization_error=0.1)
    truths = _truth_profiles(rng, 16, 1000, 3)
    res, dt = _lockstep(model, truths, jax.random.key(4),
                        k_max=6, steps_per_k=12, N=128, informed_init=True,
                        scout_steps=4, refine_top=3)
    return {
        "config": 4,
        "B": 16,
        "T": 1000,
        "n_states": 3,
        "wall_s_warm": round(dt, 2),
        "traj_per_s": round(16 / dt, 2),
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
    }


def config5(postproc=False):
    """10,240-trajectory dataset on one chip (no warm repeat: reported
    wall-clock includes one-time compiles, amortized over the dataset).

    With ``postproc=True`` this is the full BASELINE.md north star
    ("10k-trajectory dataset + postproc credible intervals"): each chunk
    additionally runs the batched boundary hill climb on the MAP profiles
    and computes evidence-averaged marginal state posteriors; the reported
    wall time includes both, and ``mean_credibility`` is the mean posterior
    probability of the selected state over all frames (how credible the
    reported profiles are under the sampled posterior).
    """
    import jax
    from bild_jax.models import MultiStateRouse
    from bild_jax.parallel import sample_batch
    from bild_jax.postproc import optimize_boundary_batch

    rng = np.random.default_rng(5)
    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    B_total, chunk = 10240, 1024
    t0 = time.perf_counter()
    acc_frames = 0.0
    acc_switch = 0.0
    acc_post = 0.0
    cred = 0.0
    for c in range(B_total // chunk):
        truths = _truth_profiles(rng, chunk, 100, 2)
        batch = model.trajectories_from_loopingprofiles(
            truths, key=jax.random.key(100 + c))
        res = sample_batch(model, batch, k_max=4, steps_per_k=12, N=128,
                           informed_init=True, scout_steps=4, refine_top=3,
                           marginals=postproc, key=jax.random.key(200 + c))
        profiles = res.best_profile()
        acc_frames += _accuracy(profiles, truths)
        acc_switch += _switch_accuracy(res.best_k(), truths)
        if postproc:
            opt, _ = optimize_boundary_batch(profiles, batch, model)
            acc_post += _accuracy(opt, truths)
            logpost = res.log_marginal_posterior(dE="average")  # (B, n, T)
            picked = np.take_along_axis(
                np.exp(logpost), np.asarray(opt)[:, None, :], axis=1)
            cred += float(np.mean(picked))
    dt = time.perf_counter() - t0
    n_chunks = B_total // chunk
    out = {
        "config": 5,
        "B": B_total,
        "wall_minutes": round(dt / 60, 2),
        "traj_per_s": round(B_total / dt, 2),
        "frame_accuracy": round(acc_frames / n_chunks, 4),
        "switch_count_accuracy": round(acc_switch / n_chunks, 4),
    }
    if postproc:
        out["postproc"] = True
        out["frame_accuracy_postproc"] = round(acc_post / n_chunks, 4)
        out["mean_credibility"] = round(cred / n_chunks, 4)
    return out


def config6():
    """GenericGaussianModel dataset inference (device interval tables)."""
    import jax
    from bild_jax.models import GenericGaussianModel as GGM
    from bild_jax.parallel import sample_batch, stack_trajectories

    rng = np.random.default_rng(6)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
    ])
    B, T = 64, 100
    truths = _truth_profiles(rng, B, T, 2)
    trajs = [model.trajectory_from_loopingprofile(truths[b], rng=rng)
             for b in range(B)]
    batch = stack_trajectories(trajs)

    def run():
        model.clear_memo()            # warm = batched table build + inference
        return sample_batch(model, batch, k_max=4, steps_per_k=12, N=128,
                            scout_steps=4, refine_top=3,
                            key=jax.random.key(6))

    res = run()                       # warm (compiles + table build)
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    return {
        "config": 6,
        "model": "GenericGaussianModel",
        "B": B,
        "wall_s_warm": round(dt, 2),
        "traj_per_s": round(B / dt, 2),
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
    }


def config7():
    """GGM long-T: T=1000 banded interval tables (T_band=128), B=16."""
    import jax
    from bild_jax.models import GenericGaussianModel as GGM

    rng = np.random.default_rng(7)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
    ], T_band=128)
    from bild_jax.parallel import sample_batch, stack_trajectories
    truths = _truth_profiles(rng, 16, 1000, 2)
    trajs = [model.trajectory_from_loopingprofile(t, rng=rng)
             for t in truths]
    batch = stack_trajectories(trajs)

    def run():
        return sample_batch(model, batch, k_max=4, steps_per_k=12, N=128,
                            informed_init=True, scout_steps=4, refine_top=3,
                            key=jax.random.key(7))

    res = run()                       # warm (compiles + banded table build)
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    return {
        "config": 7,
        "model": "GenericGaussianModel T=1000 banded",
        "B": 16,
        "T": 1000,
        "T_band": 128,
        "wall_s_warm": round(dt, 2),
        "traj_per_s": round(16 / dt, 2),
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="2,3,4,6,7")
    ap.add_argument("--out", default="PERF.json")
    args = ap.parse_args()

    import jax
    from bild_jax.config import enable_compilation_cache
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("bench_e2e.py measures an accelerator; JAX found "
                         "only the CPU")
    enable_compilation_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    runners = {"2": config2, "3": config3, "4": config4, "5": config5,
               "5p": lambda: config5(postproc=True), "6": config6,
               "7": config7}
    results = {}
    for c in (x.strip() for x in args.configs.split(",")):
        if c not in runners:
            raise SystemExit(f"unknown config {c!r}; valid configs: "
                             f"{', '.join(runners)}")
        print(f"== config {c} ==", flush=True)
        r = runners[c]()
        r["device"] = device
        results[c] = r
        print(json.dumps(r), flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
