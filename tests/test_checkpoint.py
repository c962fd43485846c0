"""Checkpoint round-trip: save, load, continue sampling."""
import numpy as np
import pytest
import jax
from scipy import stats as sp_stats

import bild_jax as bild
from bild_jax import Trajectory
from bild_jax.models import FactorizedModel
from bild_jax.utils import save_results, load_results


@pytest.mark.slow
def test_roundtrip(tmp_path):
    traj = Trajectory.create(np.array([0.1, 0.05, 6, 3, 4, 0.01, 5, 7]))
    model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                             sp_stats.maxwell(scale=1)])
    res = bild.sample(traj, model, init_runs=3,
                      sampler_kw={"N": 20, "max_fev": 200},
                      key=jax.random.key(0))

    path = tmp_path / "ckpt.npz"
    save_results(path, res)
    res2 = load_results(path, model)

    np.testing.assert_array_equal(res.best_profile()[:], res2.best_profile()[:])
    np.testing.assert_allclose(res.evidence, res2.evidence, rtol=1e-12)
    np.testing.assert_allclose(res.log_marginal_posterior(dE=2),
                               res2.log_marginal_posterior(dE=2), rtol=1e-6)

    # resume sampling on a restored non-exhausted sampler
    for s in res2.samplers:
        if not s.exhausted:
            n_before = int(s.state.n_steps)
            assert s.step()
            assert int(s.state.n_steps) == n_before + 1
            break
    else:
        raise AssertionError("expected at least one non-exhausted sampler")

    # loading with a re-parametrized model is rejected (fingerprint),
    # not silently resumed at the wrong parameters
    other = FactorizedModel([sp_stats.maxwell(scale=0.2),
                             sp_stats.maxwell(scale=1)])
    with pytest.raises(ValueError, match="fingerprint"):
        load_results(path, other)


def test_strict_numerics_context():
    import jax
    import jax.numpy as jnp
    from bild_jax.utils import strict_numerics

    f = jax.jit(jnp.log)
    with strict_numerics():
        try:
            f(jnp.asarray(-1.0)).block_until_ready()
            raise AssertionError("expected FloatingPointError")
        except FloatingPointError:
            pass
    # flag restored: NaN flows silently again
    assert bool(jnp.isnan(f(jnp.asarray(-1.0))))
