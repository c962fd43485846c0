"""
GGM lockstep performance forensics (VERDICT r4 weak point 4).

Config 6 (B=64, T=100, full tables) runs ~41 traj/s vs 127.8 for Rouse at
the same T; config 7 (B=16, T=1000, banded) runs 3.64 traj/s — with no
attribution. This tool splits the wall between:

  1. interval-table build (host+device hybrid, `_tables_payload_batch`)
  2. lockstep inference with tables cached (the fused AMIS runner)
  3. inside inference: the likelihood gather-sum alone vs the AMIS
     propose/update machinery (measured by timing the jitted pieces at the
     exact config shapes)

plus the same phases for the Rouse model at config-6 shapes as the
contrast. Writes one JSON artifact.

Usage: python tools/profile_ggm.py [--out GGM_FORENSICS.json]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench_e2e import _truth_profiles  # noqa: E402


def _timeit(fn, reps=5):
    fn()                       # warm
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _block(x):
    import jax
    return jax.block_until_ready(x)


def profile_config(tag, model, truths, T, k_max, rng_key, N=128,
                   steps_per_k=12, scout=4, refine=3, informed=None):
    import jax
    import jax.numpy as jnp
    from bild_jax.parallel import sample_batch, stack_trajectories

    if hasattr(model, "trajectories_from_loopingprofiles"):
        batch = model.trajectories_from_loopingprofiles(
            truths, key=jax.random.key(0))
    else:
        trajs = [model.trajectory_from_loopingprofile(
            t, rng=np.random.default_rng(1000 + i))
            for i, t in enumerate(truths)]
        batch = stack_trajectories(trajs)
    B = batch.B
    if informed is None:
        informed = hasattr(model, "lockstep_segment_tables") and \
            model.lockstep_segment_tables(batch) is not None

    out = {"tag": tag, "B": B, "T": T}

    # 1. table build (GGM only; Rouse has no per-batch build)
    if hasattr(model, "_tables_payload_batch"):
        data = np.asarray(batch.data)
        valid = np.asarray(batch.valid)

        def build():
            _block(jax.tree_util.tree_leaves(
                model._tables_payload_batch(data, valid)[1]))

        out["table_build_s"] = round(_timeit(build, reps=3), 3)

    # 2. inference with tables cached
    kw = dict(k_max=k_max, steps_per_k=steps_per_k, N=N,
              informed_init=informed, scout_steps=scout, refine_top=refine,
              key=rng_key)

    def infer():
        return sample_batch(model, batch, **kw)

    out["inference_s"] = round(_timeit(infer, reps=3), 3)
    out["traj_per_s_inference_only"] = round(B / out["inference_s"], 2)

    # 3. in-loop decomposition at runner shapes (B trajectories vmapped,
    #    (N, T) profiles each — the fused runner's per-step shape). A
    #    single dispatch has a fixed launch cost, so each piece is timed as
    #    ONE jitted fori_loop of `iters` repetitions on device.
    import dataclasses
    import math
    from functools import partial
    from bild_jax.amis.cfc import CFC
    from bild_jax.amis.sampler import AmisState, amis_propose, amis_update

    per_traj, logL_fn = model.lockstep_fns(batch)
    rng = np.random.default_rng(0)
    n = model.nStates
    cfc = CFC(model.transitions)
    transitions = jnp.asarray(model.transitions)
    k = min(2, T - 1)
    iters = 32

    profs = jnp.asarray(rng.integers(0, n, size=(B, N, T)), dtype=jnp.int32)

    @jax.jit
    def lik_loop(profs, per_traj):
        def body(i, acc):
            return acc + jnp.sum(jax.vmap(logL_fn)(
                jnp.where(i % 2 == 0, profs, (profs + 1) % n), per_traj),
                axis=1)
        return jax.lax.fori_loop(0, iters, body, jnp.zeros(B))

    def lik():
        _block(lik_loop(profs, per_traj))

    out["logL_inloop_ms"] = round(_timeit(lik) * 1e3 / iters, 3)

    # full AMIS step (propose -> logL -> update), in-loop
    from bild_jax.config import fdtype
    dtype = fdtype()
    a0 = jnp.ones((B, k + 1), dtype=dtype)
    logp0 = jnp.tile(jnp.asarray(cfc.logp_uniform(k), dtype=dtype)[None],
                     (B, 1, 1))
    logprior = jnp.asarray(
        sum(math.log(i + 1) for i in range(k)) - cfc.N_total(k, log=True),
        dtype=dtype)
    S = steps_per_k
    states = jax.vmap(lambda a, lp: AmisState.create(S, N, k, cfc.n, a, lp))(
        a0, logp0)
    keys = jax.random.split(jax.random.key(0), B)

    @jax.jit
    def step_loop(states, keys, per_traj):
        def body(i, carry):
            states, keys = carry
            def one(state, key, pt):
                key, sub = jax.random.split(key)
                ss, th, profiles = amis_propose(state, sub, transitions,
                                                N=N, T=T)
                logLs = logL_fn(profiles, pt)
                state, _ = amis_update(
                    state, ss, th, logLs.astype(state.logLs.dtype),
                    transitions, logprior, jnp.asarray(N * 1e-2, dtype),
                    jnp.asarray(N * 1e-3, dtype))
                # rewind so the loop can run past the S-step buffer
                return dataclasses.replace(
                    state, n_steps=jnp.zeros((), jnp.int32)), key
            return jax.vmap(one)(states, keys, per_traj)
        return jax.lax.fori_loop(0, iters, body, (states, keys))

    def full_step():
        st, ks = step_loop(states, keys, per_traj)
        _block(st.logLs)

    out["amis_step_inloop_ms"] = round(_timeit(full_step) * 1e3 / iters, 3)
    out["propose_update_ms"] = round(
        out["amis_step_inloop_ms"] - out["logL_inloop_ms"], 3)

    n_steps = (k_max + 1) * scout + refine * (steps_per_k - scout)
    out["n_logL_steps"] = n_steps
    out["amis_total_s_est"] = round(
        out["amis_step_inloop_ms"] * n_steps / 1e3, 3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="GGM_FORENSICS.json")
    ap.add_argument("--configs", default="6,7,rouse")
    args = ap.parse_args()

    import jax
    from bild_jax.config import enable_compilation_cache
    enable_compilation_cache()
    from bild_jax.models import GenericGaussianModel as GGM
    from bild_jax.models import MultiStateRouse

    results = {}
    todo = [x.strip() for x in args.configs.split(",")]

    if "6" in todo:
        rng = np.random.default_rng(6)
        model = GGM([
            [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
            [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
        ])
        truths = _truth_profiles(rng, 64, 100, 2)
        results["6"] = profile_config("ggm_T100_full", model, truths, 100,
                                      4, jax.random.key(6), informed=False)
        print(json.dumps(results["6"]), flush=True)

    if "7" in todo:
        rng = np.random.default_rng(7)
        model = GGM([
            [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
            [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
        ], T_band=128)
        truths = _truth_profiles(rng, 16, 1000, 2)
        results["7"] = profile_config("ggm_T1000_banded", model, truths,
                                      1000, 4, jax.random.key(7))
        print(json.dumps(results["7"]), flush=True)

    if "rouse" in todo:
        rng = np.random.default_rng(3)
        model = MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1)
        truths = _truth_profiles(rng, 64, 100, 2)
        results["rouse"] = profile_config("rouse_T100_contrast", model,
                                          truths, 100, 4, jax.random.key(3))
        print(json.dumps(results["rouse"]), flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
