"""
Run the REFERENCE bild sampler (via tools/refshim, python fallback kernel)
and OUR sampler on identical MultiStateRouse trajectories, and compare the
inference outcomes.

This closes BASELINE.md's north-star check "Full AMIS posterior, one
trajectory (<= 5 switches): MAP profile matches reference sampler" by
actually running the reference sampler — not a transcription — on this host
(the shimmed ``rouse.Model`` is float64 numpy with the same spectral
construction as ``bild_jax/physics/rouse.py``; kernel-level parity is
asserted bit-tight in tests/test_reference_parity.py).

Both samplers are stochastic (AMIS evidence SE ~0.1-0.5 nats), so agreement
is statistical: we record per-trajectory best_k, MAP-profile frame overlap,
and the evidence curves.

Usage:
    python tools/ref_compare_rouse.py [--n 12] [--out /tmp/ref_rouse_cmp.jsonl]
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

T = 100
N_MONOMERS = 20
K_MAX = 4


def make_data(n):
    """n trajectories from OUR generative model, truths with 0..4 switches."""
    from bench_e2e import _truth_profiles
    import bild_jax as bt

    model = bt.models.MultiStateRouse(N_MONOMERS, 1.0, 5.0, d=3,
                                      localization_error=0.1)
    rng = np.random.default_rng(33)
    truths = _truth_profiles(rng, n, T, 2)
    trajs = [model.trajectory_from_loopingprofile(
        truths[b], key=jax.random.key(1000 + b)) for b in range(n)]
    return model, truths, trajs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=12)
    ap.add_argument('--out', default='/tmp/ref_rouse_cmp.jsonl')
    args = ap.parse_args(argv)

    import bild_jax as bt
    our_model, truths, trajs = make_data(args.n)

    import bild  # reference
    import noctiluca
    ref_model = bild.models.MultiStateRouse(N_MONOMERS, 1.0, 5.0, d=3,
                                            localization_error=0.1)

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
        data = np.asarray(trajs[b][:])
        ref_traj = noctiluca.Trajectory(data)

        t0 = time.perf_counter()
        ref_res = bild.sample(ref_traj, ref_model, k_max=K_MAX)
        dt_ref = time.perf_counter() - t0
        ref_map = np.asarray(ref_res.best_profile()[:], dtype=int)

        t0 = time.perf_counter()
        our_res = bt.sample(trajs[b], our_model, k_max=K_MAX,
                            key=jax.random.key(b))
        dt_our = time.perf_counter() - t0
        our_map = np.asarray(our_res.best_profile()[:], dtype=int)

        # posterior credibility of the TRUTH under each sampler's marginal
        # posterior (the calibration statistic of PERF_r03 `mean_credibility`,
        # here computed for BOTH samplers on identical data)
        ref_post = np.exp(np.asarray(ref_res.log_marginal_posterior()))
        our_post = np.exp(np.asarray(our_res.log_marginal_posterior()))
        tidx = np.arange(T)
        truth_np = np.asarray(truth, dtype=int)

        rec = {
            'b': b,
            'true_k': true_k,
            'ref_best_k': int(ref_res.best_k()),
            'our_best_k': int(our_res.best_k()),
            'map_overlap': float(np.mean(ref_map == our_map)),
            'ref_frame_acc': float(np.mean(ref_map == truth)),
            'our_frame_acc': float(np.mean(our_map == truth)),
            'ref_evidences': [float(e) for e in ref_res.evidence],
            'our_evidences': [float(e) for e in np.asarray(our_res.evidence)],
            'ref_evidence_se': [float(e) for e in ref_res.evidence_se],
            'our_evidence_se': [float(e) for e in
                                np.asarray(our_res.evidence_se)],
            'ref_truth_cred': float(np.mean(ref_post[truth_np, tidx])),
            'our_truth_cred': float(np.mean(our_post[truth_np, tidx])),
            'ref_wall_s': round(dt_ref, 1),
            'our_wall_s': round(dt_our, 1),
        }
        with open(args.out, 'a') as f:
            f.write(json.dumps(rec) + '\n')
        print(rec, flush=True)

    recs = [json.loads(l) for l in open(args.out)]
    recs = [r for r in recs if r['b'] < args.n]
    agree_k = np.mean([r['ref_best_k'] == r['our_best_k'] for r in recs])
    overlap = np.mean([r['map_overlap'] for r in recs])
    acc_ref = np.mean([r['ref_frame_acc'] for r in recs])
    acc_our = np.mean([r['our_frame_acc'] for r in recs])
    print(f"\nn={len(recs)}: best_k agreement={agree_k:.3f}, "
          f"mean MAP overlap={overlap:.4f}, "
          f"frame acc ref={acc_ref:.4f} ours={acc_our:.4f}")

    # evidence-curve agreement normalized by the combined AMIS SE, per
    # (trajectory, k): |logE_ref - logE_our| / sqrt(se_ref^2 + se_our^2)
    z = []
    for r in recs:
        if 'ref_evidence_se' not in r:
            continue
        for k in range(min(len(r['ref_evidences']), len(r['our_evidences']))):
            e_r, e_o = r['ref_evidences'][k], r['our_evidences'][k]
            s_r, s_o = r['ref_evidence_se'][k], r['our_evidence_se'][k]
            if np.isfinite([e_r, e_o, s_r, s_o]).all():
                z.append(abs(e_r - e_o) / np.sqrt(s_r**2 + s_o**2 + 1e-12))
    if z:
        z = np.asarray(z)
        cred = [(r.get('ref_truth_cred'), r.get('our_truth_cred'))
                for r in recs if 'ref_truth_cred' in r]
        cr, co = np.mean([c[0] for c in cred]), np.mean([c[1] for c in cred])
        print(f"evidence |z| over {len(z)} (traj,k) pairs: "
              f"median={np.median(z):.2f}, frac<=2={np.mean(z <= 2):.3f}, "
              f"frac<=3={np.mean(z <= 3):.3f}")
        print(f"truth credibility: ref={cr:.4f} ours={co:.4f}")


if __name__ == '__main__':
    main()
