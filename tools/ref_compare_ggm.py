"""
Run the REFERENCE bild sampler (via tools/refshim) on the exact config-6
dataset from bench_e2e.py and record its per-trajectory model selection.

Purpose: VERDICT r2 item 4 asked whether config 6's switch-count accuracy
(~0.53 at our budget) reflects an implementation defect or genuine posterior
uncertainty; the closing criterion is "compare to reference behavior on the
same data". The shim was validated first: reference ``GenericGaussianModel
.logL`` agrees with our ``logL_host`` to the last bit (see
tests/test_reference_parity.py).

The reference runs at ITS OWN defaults (adaptive scheme, init_runs=20,
N=100/step, i.e. >= 2000 likelihood evals per k — a larger budget than our
config-6 lockstep schedule of 12 steps x 128), with only k_max matched to our
run (k_max=4). If the reference's switch-count accuracy on identical data is
comparable, the residual misses are posterior uncertainty, not sampler loss.

Usage:
    python tools/ref_compare_ggm.py [--n 16] [--out ref_ggm_cmp.jsonl]

Appends one JSON line per trajectory (resumable; already-done indices are
skipped based on the output file).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'refshim'))
sys.path.insert(0, '/root/reference')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)


def make_config6_data():
    """Exactly the dataset of bench_e2e.config6 (rng seed 6, B=64, T=100)."""
    from bench_e2e import _truth_profiles
    from bild_jax.models import GenericGaussianModel as GGM

    rng = np.random.default_rng(6)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
    ])
    B, T = 64, 100
    truths = _truth_profiles(rng, B, T, 2)
    trajs = [model.trajectory_from_loopingprofile(truths[b], rng=rng)
             for b in range(B)]
    return truths, trajs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=16)
    ap.add_argument('--out', default='/tmp/ref_ggm_cmp.jsonl')
    args = ap.parse_args(argv)

    truths, trajs = make_config6_data()

    import bild  # the reference package, running through the shim
    from bild.models import GenericGaussianModel as RefGGM
    import noctiluca

    ref_model = RefGGM([
        [(RefGGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(RefGGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
    ])

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                done.add(json.loads(line)['b'])

    for b in range(args.n):
        if b in done:
            continue
        truth = truths[b]
        true_k = int(np.sum(truth[1:] != truth[:-1]))
        data = np.asarray(trajs[b][:])          # (T, d) NaN-sentinel view
        traj_ref = noctiluca.Trajectory(data)

        t0 = time.perf_counter()
        res = bild.sample(traj_ref, ref_model, k_max=4)
        dt = time.perf_counter() - t0

        best = np.asarray(res.best_profile()[:], dtype=int)
        rec = {
            'b': b,
            'true_k': true_k,
            'ref_best_k': int(res.best_k()),
            'ref_frame_acc': float(np.mean(best == truth)),
            'ref_evidences': [float(e) for e in res.evidence],
            'wall_s': round(dt, 1),
        }
        with open(args.out, 'a') as f:
            f.write(json.dumps(rec) + '\n')
        print(rec, flush=True)

    # aggregate
    recs = [json.loads(l) for l in open(args.out)]
    recs = [r for r in recs if r['b'] < args.n]
    ok_k = np.mean([r['ref_best_k'] == r['true_k'] for r in recs])
    fr = np.mean([r['ref_frame_acc'] for r in recs])
    under = np.mean([r['ref_best_k'] < r['true_k'] for r in recs])
    print(f"\nreference on config-6 data (n={len(recs)}): "
          f"switch_count_accuracy={ok_k:.3f} frame_accuracy={fr:.3f} "
          f"under_selection={under:.3f}")


if __name__ == '__main__':
    main()
