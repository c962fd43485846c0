"""
Benchmark: batched Rouse-Kalman likelihood throughput on one accelerator.

Config matches the BASELINE.md headline workload: 2-state Rouse model at the
reference scale (N=20 monomers), 3-d dual-color trajectory, T=100 frames,
scored for a batch of P=8192 candidate profiles — the dispatch shape of
dataset (lockstep) mode, where B trajectories x N proposals land in one
kernel call. This is the kernel that dominates every BILD inference
(reference hot path: ``bild/src/MSRouse_logL.pyx``, called ~20k times per
k-sampler). It runs the path `MultiStateRouse.logL_batch` dispatches to on
this backend (``models/msrouse.py:_select_kernel``).

Baseline = the sequential float64 NumPy transcription of the reference
algorithm (``bild_jax/ops/oracle.py``) on one host CPU thread, i.e. the
reference's own execution model (it explicitly rejects parallelism,
``bild/amis.py:732-733``).

Refuses to run without an accelerator. Prints ONE JSON line:
  {"metric": "logL_evals_per_sec", "value": ..., "unit": "profiles/s",
   "vs_baseline": ..., "device": {"platform", "kind", "count"}}
"""
import json
import sys
import time

import numpy as np


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py measures an accelerator; JAX found only the CPU")

    from bild_jax.config import enable_compilation_cache
    enable_compilation_cache()

    from bild_jax.models import MultiStateRouse
    from bild_jax.models.msrouse import _select_kernel
    from bild_jax.ops.oracle import msrouse_logL_numpy

    P, T = 8192, 100
    rng = np.random.default_rng(685441950)

    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    true_prof = ((np.arange(T) // 25) % 2).astype(int)
    traj = model.trajectory_from_loopingprofile(true_prof, key=jax.random.key(0))
    profiles = jax.device_put(rng.integers(0, 2, size=(P, T)).astype(np.int32))

    # --- device path: warm once, then time n_rep dispatches ---------------
    s2, Cind = model._noise_arrays(traj)
    kernel = _select_kernel(model.Bs.dtype, model.Bs.shape[-1])
    args = (model.Bs, model.Gs, model._filter_Sigs, model.M0s, model.C0s,
            model.w, s2, Cind, profiles, traj.data, traj.valid)
    kernel(*args).block_until_ready()
    n_rep = 10
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = kernel(*args)
    out.block_until_ready()
    rate_device = P * n_rep / (time.perf_counter() - t0)

    # --- baseline: sequential float64 oracle on host ---------------------
    arrs = [np.asarray(a, dtype=np.float64) for a in
            (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w)]
    err = model._get_noise(traj)
    trajdata = traj[:]
    n_base = 16
    t0 = time.perf_counter()
    for p in np.asarray(profiles)[:n_base]:
        msrouse_logL_numpy(*arrs, err, p, trajdata)
    rate_base = n_base / (time.perf_counter() - t0)

    print(json.dumps({
        "metric": "logL_evals_per_sec",
        "value": round(rate_device, 1),
        "unit": "profiles/s",
        "vs_baseline": round(rate_device / rate_base, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
