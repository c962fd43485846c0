"""
End-to-end example: calibrate the physical model by gradient-based maximum
likelihood, then run inference with the calibrated model.

This closes the loop the reference leaves to external tools (MSD fitting
with ``bayesmsd`` before BILD): here the BILD likelihood itself is
differentiable, so the same kernel both scores looping profiles and fits
``(D, k, localization_error)``. See `bild_jax.fit` and DESIGN.md section 7k.

Run:  python examples/calibrate_params.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

import bild_jax as bild
from bild_jax.fit import fit_rouse
from bild_jax.parallel import sample_batch


def main():
    smoke = os.environ.get("BILD_SMOKE") == "1"
    B = 4 if smoke else 24
    T = 24 if smoke else 100
    N = 6 if smoke else 20
    steps = 40 if smoke else 300

    D_true, k_true, err_true = 1.0, 5.0, 0.1
    truth_model = bild.models.MultiStateRouse(N, D_true, k_true, d=3,
                                              localization_error=err_true)

    # simulate a dataset with known looping profiles
    rng = np.random.default_rng(8)
    profiles = np.zeros((B, T), dtype=int)
    for b in range(B):
        t0 = rng.integers(0, T // 2)
        profiles[b, t0:t0 + rng.integers(T // 4, T // 2)] = 1
    batch = truth_model.trajectories_from_loopingprofiles(
        profiles, key=jax.random.key(3))

    # start from deliberately wrong parameters (x2 off) and calibrate;
    # in real use the profiles would come from res.best_profile() of an
    # inference pass with the uncalibrated model (EM-style alternation)
    start = bild.models.MultiStateRouse(N, 2 * D_true, 0.5 * k_true, d=3,
                                        localization_error=2 * err_true)
    fit = fit_rouse(start, batch, profiles, steps=steps, learning_rate=0.05)
    print(f"nll: {fit.nll_trace[0]:.4f} -> {fit.nll_trace[-1]:.4f} "
          f"(grad norm {fit.grad_norm:.1e})")
    print(f"D: {fit.D:.3f} (true {D_true}), k: {fit.k:.3f} (true {k_true}), "
          f"localization error: {fit.localization_error[0]:.3f} "
          f"(true {err_true})")

    # inference with the calibrated model
    res = sample_batch(fit.model, batch, k_max=2 if smoke else 4,
                       steps_per_k=4 if smoke else 10,
                       N=32 if smoke else 128, key=jax.random.key(4))
    acc = float(np.mean(np.asarray(res.best_profile()) == profiles))
    print(f"frame accuracy with calibrated model: {acc:.3f}")


if __name__ == "__main__":
    main()
