"""
Direct behavioral parity against the REFERENCE package itself.

The reference (/root/reference/bild) runs on this host through the minimal
dependency shims in tools/refshim (noctiluca/rouse/bayesmsd stand-ins backed
by this repo's validated numpy implementations). That lets us assert parity
not against a transcription of the reference's math, but against the
reference's own code paths (``bild/models.py:608-661`` for the GGM
likelihood).

Skipped when /root/reference is not present (e.g. installed wheels).
"""
import os
import sys

import numpy as np
import pytest

REF = '/root/reference'
SHIM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    'tools', 'refshim')

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, 'bild')),
    reason='reference checkout not available')


@pytest.fixture(scope='module')
def ref_bild():
    for p in (SHIM, REF):
        if p not in sys.path:
            sys.path.insert(0, p)
    import bild as ref
    assert ref.__file__.startswith(REF)
    return ref


def _specs(GGM):
    return [
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.0, 0)],
    ]


def test_ggm_logL_matches_reference_exactly(ref_bild):
    from bild_jax.models import GenericGaussianModel as OurGGM
    import noctiluca  # the shim

    RefGGM = ref_bild.models.GenericGaussianModel
    ref_model = RefGGM(_specs(RefGGM))
    our_model = OurGGM(_specs(OurGGM))

    rng = np.random.default_rng(17)
    T = 60
    truth = np.zeros(T, dtype=int)
    truth[20:35] = 1
    truth[50:] = 1
    traj = our_model.trajectory_from_loopingprofile(
        truth, missing_frames=0.1, rng=rng)
    data = np.asarray(traj[:])              # NaN-sentinel (T, d)
    assert np.isnan(data).any()             # gaps exercised
    ref_traj = noctiluca.Trajectory(data)

    profiles = [truth, np.zeros(T, int), np.ones(T, int),
                (np.arange(T) >= 30).astype(int)]
    for prof in profiles:
        l_ref = ref_model.logL(ref_bild.util.Loopingprofile(prof), ref_traj)
        l_our = float(our_model.logL_host(prof, traj))
        # identical f64 numpy math end to end -> tight tolerance
        assert l_our == pytest.approx(l_ref, rel=1e-9, abs=1e-9)


def test_rouse_kernel_matches_reference_exactly(ref_bild):
    """Run the REFERENCE Kalman kernel (``bild/src/MSRouse_logL_py.py``,
    selected by cython_imports' fallback) through the shimmed ``rouse.Model``
    and compare against both our f64 numpy oracle and our device kernel on
    identical inputs."""
    from bild_jax.models import MultiStateRouse as OurMSR
    from bild_jax.ops.oracle import msrouse_logL_numpy
    from bild_jax.trajectory import make_trajectory
    import noctiluca  # the shim

    N, D, k, d = 12, 1.0, 3.0, 3
    loops = (None, (0, -1), ((0, 5), (6, 11)))
    ref_model = ref_bild.models.MultiStateRouse(
        N, D, k, d=d, looppositions=loops, localization_error=0.1)
    our_model = OurMSR(N, D, k, d=d, looppositions=loops,
                       localization_error=0.1)

    rng = np.random.default_rng(5)
    T = 40
    data = rng.normal(scale=0.5, size=(T, d))
    data[[3, 17, 18]] = np.nan                      # gaps
    ref_traj = noctiluca.Trajectory(data)
    traj = make_trajectory(data)

    profiles = [rng.integers(0, 3, size=T) for _ in range(4)]
    profiles.append(np.zeros(T, dtype=int))
    for prof in profiles:
        l_ref = ref_model.logL(ref_bild.util.Loopingprofile(prof), ref_traj)
        # (a) our numpy f64 oracle, fed OUR spectral dynamics: the only
        # difference from the reference path is eigh round-off in B/Sig/C_ss
        l_oracle = msrouse_logL_numpy(
            our_model.Bs, our_model.Gs, our_model.Sigs,
            our_model.M0s, our_model.C0s, np.asarray(our_model.w),
            np.asarray(our_model.localization_error), prof, data)
        assert l_oracle == pytest.approx(l_ref, rel=1e-9, abs=1e-9)
        # (b) the batched device kernel (CPU f64 under the test config)
        l_dev = float(our_model.logL(prof, traj))
        assert l_dev == pytest.approx(l_ref, rel=1e-8, abs=1e-8)


def test_rouse_generative_roundtrip_through_reference(ref_bild):
    """Sample from the REFERENCE MultiStateRouse generative path (which runs
    the shimmed ``rouse.Model.conf_ss``/``evolve``) and score with OUR device
    model: the generating profile must beat the constant profiles."""
    from bild_jax.models import MultiStateRouse as OurMSR
    from bild_jax.trajectory import make_trajectory

    N, T = 16, 80
    ref_model = ref_bild.models.MultiStateRouse(
        N, 1.0, 5.0, d=3, localization_error=0.05)
    our_model = OurMSR(N, 1.0, 5.0, d=3, localization_error=0.05)

    truth = np.zeros(T, dtype=int)
    truth[30:60] = 1
    np.random.seed(11)                       # reference uses global numpy RNG
    ref_traj = ref_model.trajectory_from_loopingprofile(
        ref_bild.util.Loopingprofile(truth))
    traj = make_trajectory(np.asarray(ref_traj[:]))

    cands = np.stack([truth, 0 * truth, 0 * truth + 1])
    lls = np.asarray(our_model.logL_batch(cands, traj))
    assert np.all(np.isfinite(lls))
    assert lls[0] == lls.max()


def test_ggm_generative_roundtrip_through_reference(ref_bild):
    """Sample from the REFERENCE generative model, score with OUR device
    model: the true profile must beat the constants (cross-implementation
    sanity in the other direction)."""
    from bild_jax.models import GenericGaussianModel as OurGGM
    from bild_jax.trajectory import make_trajectory

    RefGGM = ref_bild.models.GenericGaussianModel
    ref_model = RefGGM(_specs(RefGGM))
    our_model = OurGGM(_specs(OurGGM))

    T = 80
    truth = np.zeros(T, dtype=int)
    truth[25:55] = 1
    np.random.seed(3)                        # reference uses global numpy RNG
    ref_traj = ref_model.trajectory_from_loopingprofile(
        ref_bild.util.Loopingprofile(truth))
    traj = make_trajectory(np.asarray(ref_traj[:]))

    cands = np.stack([truth, 0 * truth, 0 * truth + 1])
    lls = np.asarray(our_model.logL_batch(cands, traj))
    assert np.all(np.isfinite(lls))
    assert lls[0] == lls.max()
