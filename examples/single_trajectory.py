"""
End-to-end example: full adaptive Bayesian inference on one trajectory
(the reference's core use case, reference README.md usage).

Run:  python examples/single_trajectory.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

import bild_jax as bild


def main():
    # BILD_SMOKE=1: tiny shapes so CI can exercise this end-to-end cheaply
    smoke = os.environ.get("BILD_SMOKE") == "1"
    T = 24 if smoke else 100
    model = bild.models.MultiStateRouse(8 if smoke else 20, D=1, k=5, d=3,
                                        localization_error=0.1)

    # ground truth: a loop over the middle third of the trajectory
    truth = np.zeros(T, dtype=int)
    truth[3 * T // 10: 6 * T // 10] = 1
    traj = model.trajectory_from_loopingprofile(truth, key=jax.random.key(0))

    res = bild.sample(traj, model, key=jax.random.key(1))

    print("evidence over k:", np.round(res.evidence, 2))
    print("best k:", res.best_k())
    best = res.best_profile()
    print("truth   :", "".join(map(str, truth)))
    print("inferred:", "".join(map(str, best[:])))

    refined = bild.postproc.optimize_boundary(best, traj, model)
    print("refined :", "".join(map(str, refined[:])))

    post = res.log_marginal_posterior(dE="average")
    p_loop = np.exp(post[1])
    print("P(looped) per frame (first 10):", np.round(p_loop[:10], 2))

    acc = np.mean(refined[:] == truth)
    print(f"frame accuracy: {acc:.3f}")


if __name__ == "__main__":
    main()
