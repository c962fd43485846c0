"""
A/B of the two float32 Rouse likelihood paths on one GPU: the CUDA kernel
(`ops.kalman_cuda`) against the XLA scan (`ops.kalman`), in turns
(scan, kernel, kernel, scan per round) within one process.

  build   nvcc resource usage of the kernel at N=20, d=3
  a       the likelihood alone: P=8192, T=100, N=20, d=3, n=2
  b       `sample_batch` at the config-3 shape (128 trajectories, T=100)
  c       `sample_batch` at the config-4 shape (3 states, T=1000, B=16)
  d       one 1024-trajectory chunk of config 5p (lockstep with marginals,
          boundary postproc, evidence-averaged posteriors)

Prints one JSON line per measurement (times in seconds, each the median of
the turns) and the card's name and power limit.

  python tools/rouse_kernel_ab.py [--rounds 2]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit("needs a GPU")
    from bild_jax.config import enable_compilation_cache
    enable_compilation_cache()
    import bild_jax.models.msrouse as msr
    from bild_jax.ops import kalman_cuda
    from bild_jax.ops.kalman import msrouse_logL_batch
    from bild_jax.parallel import sample_batch
    from bild_jax.postproc import optimize_boundary_batch
    from bench_e2e import _truth_profiles

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(card=smi, jax=jax.__version__)

    t0 = time.perf_counter()
    kalman_cuda.build_library(20, 3)
    emit(step="build", seconds=time.perf_counter() - t0)
    usage = subprocess.run(
        [kalman_cuda._nvcc(), *kalman_cuda._NVCC_FLAGS, "-DBILD_N=20",
         "-DBILD_D=3", "-I", jax.ffi.include_dir(), "--resource-usage",
         "-o", os.devnull, kalman_cuda._SRC], capture_output=True, text=True)
    emit(step="resource_usage", text=(usage.stdout + usage.stderr)[-1500:])

    paths = {"scan": msrouse_logL_batch, "cuda": kalman_cuda.msrouse_logL_cuda}
    order = ["scan", "cuda", "cuda", "scan"] * args.rounds

    def use(k):
        msr._select_kernel = lambda *_: paths[k]

    def model(n):
        return msr.MultiStateRouse(20, 1.0, 5.0, d=3,
                                   looppositions=(None, (0, -1), (0, 10))[:n],
                                   localization_error=0.1)

    def ab(name, make_run, **info):
        """make_run(path) -> zero-arg run returning a result; warmed once,
        then timed in turns."""
        runs, times, results = {}, {k: [] for k in paths}, {}
        for k in paths:
            use(k)
            runs[k] = make_run(k)
            t0 = time.perf_counter()
            results[k] = runs[k]()
            emit(step=name, path=k, warm_seconds=time.perf_counter() - t0)
        for k in order:
            use(k)
            t0 = time.perf_counter()
            runs[k]()
            times[k].append(time.perf_counter() - t0)
        emit(step=name, **info,
             scan_s=float(np.median(times["scan"])),
             cuda_s=float(np.median(times["cuda"])),
             scan_all=times["scan"], cuda_all=times["cuda"],
             speedup=float(np.median(times["scan"]) / np.median(times["cuda"])))
        return results

    # (a): the likelihood alone
    P, T = 8192, 100
    m2 = model(2)
    rng = np.random.default_rng(0)
    truth = _truth_profiles(rng, 1, T, 2)[0]
    traj = m2.trajectory_from_loopingprofile(truth, key=jax.random.key(0))
    s2, Cind = m2._noise_arrays(traj)
    profiles = jax.device_put(np.concatenate(
        [_truth_profiles(rng, P // 2, T, 2),
         rng.integers(0, 2, size=(P - P // 2, T))]).astype(np.int32))
    kargs = (m2.Bs, m2.Gs, m2._filter_Sigs, m2.M0s, m2.C0s, m2.w, s2, Cind,
             profiles, traj.data, traj.valid)

    def kernel_run(k):
        f = jax.jit(paths[k])
        return lambda: f(*kargs).block_until_ready()

    ab("a_kernel_P8192_T100", kernel_run, P=P, T=T)

    # (b), (c): lockstep sample_batch at the config-3 / config-4 shapes
    for name, n, B, T, k_max, seed in (("b_config3_B128_T100", 2, 128, 100, 4, 3),
                                       ("c_config4_B16_T1000", 3, 16, 1000, 6, 4)):
        truths = _truth_profiles(np.random.default_rng(seed), B, T, n)

        def lockstep_run(k, n=n, truths=truths, k_max=k_max, seed=seed):
            mdl = model(n)
            batch = mdl.trajectories_from_loopingprofiles(
                truths, key=jax.random.key(0))

            def run():
                res = sample_batch(mdl, batch, k_max=k_max, steps_per_k=12,
                                   N=128, informed_init=True, scout_steps=4,
                                   refine_top=3, key=jax.random.key(seed))
                return (float(np.mean(np.asarray(res.best_profile())
                                      == truths)),
                        res.best_k())
            return run

        res = ab(name, lockstep_run, B=B, T=T, n_states=n)
        emit(step=name, frame_accuracy={k: v[0] for k, v in res.items()},
             same_best_k=bool(np.array_equal(res["scan"][1], res["cuda"][1])))

    # (d): one 1024-trajectory chunk of config 5p
    truths = _truth_profiles(np.random.default_rng(5), 1024, 100, 2)

    def chunk_run(k):
        mdl = model(2)

        def run():
            batch = mdl.trajectories_from_loopingprofiles(
                truths, key=jax.random.key(100))
            res = sample_batch(mdl, batch, k_max=4, steps_per_k=12, N=128,
                               informed_init=True, scout_steps=4,
                               refine_top=3, marginals=True,
                               key=jax.random.key(200))
            opt, _ = optimize_boundary_batch(res.best_profile(), batch, mdl)
            post = res.log_marginal_posterior(dE="average")
            return (float(np.mean(np.asarray(opt) == truths)),
                    float(np.mean(np.exp(np.max(post, axis=1)))))
        return run

    res = ab("d_config5p_chunk_B1024_T100", chunk_run, B=1024, T=100)
    emit(step="d_config5p_chunk_B1024_T100",
         postproc_frame_accuracy={k: v[0] for k, v in res.items()})


if __name__ == "__main__":
    main()
