"""
Example: inference with the GenericGaussianModel (GGM).

The GGM describes each looping state as an arbitrary Gaussian process given
by its MSD — useful when the Rouse picture doesn't apply or when you want a
model-agnostic check (reference ``bild/models.py:536-728``). bild_jax runs
it device-batched through a precomputed interval table (DESIGN.md §4b).

Run:  python examples/ggm_model.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

import bild_jax as bild
from bild_jax.models import GenericGaussianModel as GGM
from bild_jax.parallel import sample_dataset


def main():
    # two states, both two-locus Rouse-like MSDs with different plateau:
    # state 0 = unlooped (large G), state 1 = looped (small G)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
    ])

    # BILD_SMOKE=1: tiny shapes so CI can exercise this end-to-end cheaply
    smoke = os.environ.get("BILD_SMOKE") == "1"
    T, B = (24, 3) if smoke else (100, 16)
    rng = np.random.default_rng(0)
    true = np.zeros(T, dtype=int)
    true[3 * T // 10: 6 * T // 10] = 1
    trajs = [model.trajectory_from_loopingprofile(true, rng=rng)
             for _ in range(B)]

    # quick per-frame guess (beyond the reference, which has no GGM init)
    guess = model.initial_loopingprofile(trajs[0])
    print("per-frame MLE guess accuracy:",
          np.mean(np.asarray(guess[:]) == true))

    # single-trajectory adaptive inference with DP-segmentation seeding
    res = bild.sample(trajs[0], model, key=jax.random.key(1),
                      sampler_kw={"informed_init": True})
    print("adaptive: best_k =", res.best_k(), "accuracy =",
          np.mean(np.asarray(res.best_profile()[:]) == true))

    # dataset mode (scouted schedule)
    ds = sample_dataset(model, trajs, k_max=2 if smoke else 4,
                        steps_per_k=3 if smoke else 12, N=32 if smoke else 128,
                        scout_steps=None if smoke else 4, refine_top=3,
                        informed_init=True, key=jax.random.key(2))
    accs = [float(np.mean(p == true)) for p in ds.best_profile()]
    print(f"dataset: mean frame accuracy {np.mean(accs):.3f} over "
          f"{len(trajs)} trajectories, best_k histogram "
          f"{np.bincount(ds.best_k(), minlength=5).tolist()}")

    # MSD-parameter calibration through the differentiable likelihood —
    # the reference needs an external bayesmsd fit here, which cannot
    # condition on the looping profile (see fit_ggm's docstring)
    from bild_jax.fit import fit_ggm

    spec = [  # start ~40% off the truth
        [("twoLocusRouse", dict(G=1.4, J=3.5), 0.1, 0)],
        [("twoLocusRouse", dict(G=0.13, J=1.5), 0.1, 0)],
    ]
    fit = fit_ggm(spec, trajs, np.stack(ds.best_profile()),
                  steps=50 if smoke else 300)
    print("fitted MSD parameters (true: G=1/J=5, G=0.2/J=1):",
          [{k: round(v, 3) for k, v in p.items()}
           for p in fit.parameters])


if __name__ == "__main__":
    main()
