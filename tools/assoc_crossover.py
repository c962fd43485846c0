"""
Measure the sequential-scan vs time-sharded associative Kalman crossover
(VERDICT r3 #10): at what (T, P) does sharding TIME across a mesh beat the
sequential batched kernel?

Runs both paths on the virtual 8-device CPU mesh (the same environment the
driver's `dryrun_multichip` validates) over a grid of trajectory lengths T
and profile-batch sizes P, and prints one JSON row per cell. Interpretation
on virtual devices: all devices share the host's cores, so the comparison
isolates program STRUCTURE (serial T-step scan vs O(log T)-depth composition
+ collectives), not silicon; on real chips the assoc path additionally gains
n_dev-fold HBM/compute. The resulting rule lives in
``MultiStateRouse.logL_batch_assoc``'s docstring and DESIGN.md.

Usage: python tools/assoc_crossover.py [--out /tmp/assoc_crossover.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax
import jax.numpy as jnp

# the virtual mesh lives on the CPU platform
jax.config.update("jax_platforms", "cpu")


def _time(fn, *args):
    out = fn(*args)                       # warm (compile)
    jax.block_until_ready(out)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/assoc_crossover.json")
    ap.add_argument("--lengths", default="1024,2048,4096,8192,16384")
    ap.add_argument("--profiles", default="1,8,64")
    args = ap.parse_args()

    from bild_jax import Trajectory
    from bild_jax.models import MultiStateRouse
    from bild_jax.ops.kalman import msrouse_logL_batch
    from bild_jax.parallel import make_mesh

    model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
    mesh = make_mesh((8,), axis_names=("time",))
    rng = np.random.default_rng(7)

    rows = []
    for T in (int(x) for x in args.lengths.split(",")):
        data = rng.normal(size=(T, 3))
        traj = Trajectory.create(data)
        s2, Cind = model._noise_arrays(traj)
        for P in (int(x) for x in args.profiles.split(",")):
            profiles = rng.integers(0, 2, size=(P, T))
            pj = jnp.asarray(profiles, dtype=jnp.int32)

            t_seq = _time(msrouse_logL_batch, model.Bs, model.Gs, model.Sigs,
                          model.M0s, model.C0s, model.w, s2, Cind, pj,
                          traj.data, traj.valid)
            t_assoc = _time(
                lambda p: model.logL_batch_assoc(np.asarray(p), traj,
                                                 mesh=mesh), profiles)
            row = {"T": T, "P": P, "seq_ms": round(t_seq * 1e3, 1),
                   "assoc8_ms": round(t_assoc * 1e3, 1),
                   "speedup": round(t_seq / t_assoc, 2)}
            rows.append(row)
            print(json.dumps(row), flush=True)

    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
