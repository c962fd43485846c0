"""
Batched adaptive scheduler (`bild_jax.infer.adaptive`).

The load-bearing test is decision parity: `decide_batch` fed the same
evidence states and the same Monte-Carlo noise draws as the host
`ChoiceSampler` + `infer.core.sample` decision logic must produce the same
choice distributions, information-gain scores, next-k decisions, and stop
verdicts (the reference protocol of ``bild/core.py:138-227`` /
``bild/choicesampler.py:112-210``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bild_jax.infer.adaptive import decide_batch, sample_batch_adaptive
from bild_jax.infer.choice import ChoiceSampler
from bild_jax.models import MultiStateRouse
from bild_jax.parallel import sample_batch


def host_decision(logE, dlogE, N, dE, k_lookahead, k_max, certainty, noise):
    """The reference decision protocol, transcribed from
    `bild_jax.infer.core.sample.determine_next_step` (itself matching
    ``bild/core.py:138-192``) for a single trajectory whose samplers'
    evidence state is (logE, dlogE, N) over the opened k values."""
    k_new = len(logE)
    cs = ChoiceSampler(logE, dlogE**2, N, dE, noise=noise)
    pk = cs.counts0 / cs.samplesize

    if k_new < k_lookahead + 1 and k_new <= k_max:
        return {"k_next": k_new, "pk": pk, "KLD": None,
                "keep_going": True}

    KLD = cs.KLD_moreSamples()
    k_KLD = int(np.argmax(KLD))
    if k_new >= k_lookahead + 1:
        I_la = cs.KLD_omitK(np.arange(k_new - k_lookahead, k_new))
    else:  # pragma: no cover - implied by the branch above
        I_la = np.inf
    k_next = k_KLD
    if I_la > KLD[k_KLD] and k_new <= k_max:
        k_next = k_new

    if k_next == k_new:
        keep = True
    else:
        keep = bool((np.max(pk) < certainty) and (KLD[k_next] > 0))
    return {"k_next": k_next, "pk": pk, "KLD": KLD, "keep_going": keep}


def _random_states(rng, n_cases, K_host, k_max):
    """Random per-trajectory evidence states: varying opened counts,
    exhausted lanes, and -inf (k >= T) samplers."""
    B = n_cases
    logE = np.full((B, K_host), -np.inf)
    varE = np.full((B, K_host), 1e-20)
    nst = np.full((B, K_host), np.inf)
    opened = np.zeros(B, dtype=int)
    for b in range(B):
        no = int(rng.integers(1, k_max + 2))
        opened[b] = no
        for k in range(no):
            if rng.random() < 0.15:     # k >= T style sampler: -inf, exhausted
                continue
            logE[b, k] = -100 * rng.random() - k * rng.random() * 5
            varE[b, k] = (0.1 + 2 * rng.random()) ** 2
            nst[b, k] = np.inf if rng.random() < 0.2 else rng.integers(1, 40)
    return logE, varE, nst, opened


def test_decide_batch_matches_host_protocol(rng):
    K_host, k_max, k_lookahead = 8, 6, 2
    dE, certainty = 0.7, 0.99
    S = 600
    logE, varE, nst, opened = _random_states(rng, 48, K_host, k_max)
    noise = rng.standard_normal((S, K_host))

    out = decide_batch(jnp.asarray(logE), jnp.asarray(varE),
                       jnp.asarray(nst), jnp.asarray(opened),
                       jnp.asarray(noise), margin=dE, certainty=certainty,
                       k_lookahead=k_lookahead, k_max=k_max)
    out = {k: np.asarray(v) for k, v in out.items()}

    for b in range(len(opened)):
        no = opened[b]
        ref = host_decision(logE[b, :no], np.sqrt(varE[b, :no]), nst[b, :no],
                            dE, k_lookahead, k_max, certainty,
                            noise[:, :no])
        assert out["k_next"][b] == ref["k_next"], f"case {b}"
        assert out["keep_going"][b] == ref["keep_going"], f"case {b}"
        np.testing.assert_allclose(out["pk"][b, :no], ref["pk"],
                                   atol=1e-12, err_msg=f"case {b}")
        if ref["KLD"] is not None:
            np.testing.assert_allclose(out["KLD"][b, :no], ref["KLD"],
                                       rtol=1e-9, atol=1e-15,
                                       err_msg=f"case {b}")
        # padded (unopened) lanes never score or win
        assert np.all(out["pk"][b, no:] == 0)
        assert np.all(out["KLD"][b, no:] == 0)


@pytest.fixture(scope="module")
def rouse_setup():
    model = MultiStateRouse(8, 1.0, 5.0, d=2, localization_error=0.1)
    rng = np.random.default_rng(11)
    B, T = 6, 40
    profs = np.zeros((B, T), dtype=int)
    for b in range(B):
        k = int(rng.integers(0, 3))
        cuts = np.sort(rng.choice(np.arange(1, T), size=k, replace=False))
        bounds = np.concatenate([[0], cuts, [T]])
        s = int(rng.integers(0, 2))
        for i in range(k + 1):
            profs[b, bounds[i]:bounds[i + 1]] = s
            s = 1 - s
    batch = model.trajectories_from_loopingprofiles(profs, key=jax.random.key(1))
    return model, batch, profs


def test_adaptive_end_to_end(rouse_setup):
    model, batch, profs = rouse_setup
    res = sample_batch_adaptive(model, batch, k_max=4, N=32,
                                max_steps_per_k=12, init_steps=3,
                                steps_per_round=2, samplesize=512,
                                informed_init=True, marginals=True,
                                key=jax.random.key(2))
    B, T = batch.B, batch.T
    assert res.evidence.shape == (B, 5)
    assert res.map_profiles.shape == (5, B, T)
    # k=0 evidence always finite (always bootstrapped)
    assert np.all(np.isfinite(res.evidence[:, 0]))
    # per-trajectory budget record exists and differs across trajectories
    assert res.evals.shape == (B,)
    assert np.all(res.evals > 0)
    assert res.rounds >= 1
    # marginals normalized over states at every frame
    lm = res.log_marginal_posterior()
    norm = np.exp(lm).sum(axis=1)
    np.testing.assert_allclose(norm, 1.0, atol=1e-5)
    # accuracy sanity: adaptive recovers truth about as well as lockstep
    acc = np.mean(np.asarray(res.best_profile()) == profs)
    assert acc > 0.8


def test_adaptive_matches_lockstep_quality(rouse_setup):
    model, batch, profs = rouse_setup
    res_a = sample_batch_adaptive(model, batch, k_max=3, N=32,
                                  max_steps_per_k=12, init_steps=3,
                                  steps_per_round=3, samplesize=512,
                                  informed_init=True, key=jax.random.key(3))
    res_f = sample_batch(model, batch, k_max=3, steps_per_k=8, N=32,
                         informed_init=True, key=jax.random.key(3))
    acc_a = np.mean(np.asarray(res_a.best_profile()) == profs)
    acc_f = np.mean(np.asarray(res_f.best_profile()) == profs)
    assert acc_a >= acc_f - 0.05
    # and spends a budget the fixed schedule cannot introspect
    fixed_evals = 4 * 8 * 32
    assert np.mean(res_a.evals) != fixed_evals or res_a.rounds > 0


def test_adaptive_respects_lengths():
    model = MultiStateRouse(8, 1.0, 5.0, d=2, localization_error=0.1)
    rng = np.random.default_rng(4)
    from bild_jax.trajectory import make_trajectory
    from bild_jax.parallel import stack_trajectories
    trajs = [make_trajectory(rng.standard_normal((T, 2))) for T in (3, 40)]
    batch = stack_trajectories(trajs)
    res = sample_batch_adaptive(model, batch, k_max=4, N=16,
                                max_steps_per_k=8, init_steps=2,
                                steps_per_round=2, samplesize=256,
                                informed_init=False, key=jax.random.key(5))
    # trajectory 0 has 3 frames: k >= 3 must be -inf
    assert np.all(res.evidence[0, 3:] == -np.inf)
    assert np.all(np.isfinite(res.evidence[0, :1]))
    assert np.all(np.isfinite(res.evidence[1, :3]))


def test_adaptive_deterministic(rouse_setup):
    model, batch, _ = rouse_setup
    kw = dict(k_max=3, N=32, max_steps_per_k=10, init_steps=3,
              steps_per_round=2, samplesize=256, informed_init=True)
    r1 = sample_batch_adaptive(model, batch, key=jax.random.key(9), **kw)
    r2 = sample_batch_adaptive(model, batch, key=jax.random.key(9), **kw)
    np.testing.assert_array_equal(r1.evidence, r2.evidence)
    np.testing.assert_array_equal(r1.map_profiles, r2.map_profiles)
    np.testing.assert_array_equal(r1.evals, r2.evals)


def test_adaptive_reallocate_off(rouse_setup):
    model, batch, profs = rouse_setup
    res = sample_batch_adaptive(model, batch, k_max=3, N=32,
                                max_steps_per_k=10, init_steps=3,
                                steps_per_round=2, samplesize=512,
                                reallocate=False, informed_init=True,
                                key=jax.random.key(6))
    assert np.all(np.isfinite(res.evidence[:, 0]))
    acc = np.mean(np.asarray(res.best_profile()) == profs)
    assert acc > 0.8


def test_sample_dataset_adaptive_schedule(rouse_setup, tmp_path):
    model, batch, profs = rouse_setup
    from bild_jax.parallel import sample_dataset
    from bild_jax.trajectory import make_trajectory
    trajs = [make_trajectory(np.asarray(batch.data[i]))
             for i in range(batch.B)]
    kw = dict(k_max=3, N=32, schedule="adaptive", init_steps=3,
              steps_per_round=2, max_steps_per_k=10, samplesize=256,
              informed_init=True, key=jax.random.key(12),
              checkpoint_dir=str(tmp_path))
    res = sample_dataset(model, trajs, **kw)
    assert res.evals is not None and np.all(res.evals > 0)
    acc = np.mean(np.concatenate(res.best_profile())
                  == np.concatenate([profs[i] for i in range(batch.B)]))
    assert acc > 0.8
    # chunk-checkpoint resume reproduces results incl. the evals record
    res2 = sample_dataset(model, trajs, **kw)
    np.testing.assert_array_equal(res.evidence, res2.evidence)
    np.testing.assert_array_equal(res.evals, res2.evals)

    with pytest.raises(ValueError, match="schedule"):
        sample_dataset(model, trajs, schedule="nope")


def test_adaptive_argument_guards(rouse_setup):
    model, batch, _ = rouse_setup
    with pytest.raises(ValueError, match="init_steps"):
        sample_batch_adaptive(model, batch, init_steps=0)
    with pytest.raises(ValueError, match="init_steps"):
        sample_batch_adaptive(model, batch, init_steps=30, max_steps_per_k=8)
    with pytest.raises(ValueError, match="steps_per_round"):
        sample_batch_adaptive(model, batch, steps_per_round=0)
