"""ChoiceSampler unit tests (no counterpart in the reference suite; behavior
pinned against bild/choicesampler.py semantics)."""
import numpy as np

from bild_jax import ChoiceSampler


def _cs(muhat, dE=0.0, N=None, rng=None, **kw):
    muhat = np.asarray(muhat, dtype=float)
    shat = np.full_like(muhat, 0.25)
    N = np.full(len(muhat), 5.0) if N is None else np.asarray(N, dtype=float)
    return ChoiceSampler(muhat, shat, N, dE,
                         rng=rng or np.random.default_rng(0), **kw)


def test_choice_distribution_concentrates_on_max():
    cs = _cs([0.0, 10.0, 0.0])
    pk = cs.counts0 / cs.samplesize
    assert pk[1] > 0.99


def test_dE_prefers_smaller_k():
    # k=0 within margin of k=1 -> chosen under the dE rule
    cs = _cs([9.5, 10.0, 0.0], dE=2.0)
    pk = cs.counts0 / cs.samplesize
    assert pk[0] > 0.9


def test_exhausted_sampler_gets_zero_gain():
    cs = _cs([0.0, 1.0, 0.5], N=[5, np.inf, 5])
    KLD = cs.KLD_moreSamples()
    assert KLD[1] == 0.0          # Dmu = 0 for exhausted (N = inf)
    assert np.all(KLD >= 0.0)


def test_KLD_omitK_importance():
    # omitting the clear winner changes the choice distribution a lot;
    # omitting an irrelevant k barely matters
    cs = _cs([0.0, 5.0, -10.0])
    gain_winner = cs.KLD_omitK(np.array([1]))
    gain_loser = cs.KLD_omitK(np.array([2]))
    assert gain_winner > 100 * max(gain_loser, 1e-12)


def test_Dn_matches_KLD_moreSamples():
    # Dn is the central-difference histogram swing that KLD_moreSamples
    # scores (reference bild/choicesampler.py:153-178): recomputing the KL
    # from Dn() must reproduce KLD_moreSamples() exactly.
    cs = _cs([0.0, 0.8, 0.4])
    swing = cs.Dn()
    assert swing.shape == (3, 3)
    expect = np.sum(swing**2 / (cs.counts0 + 1.0), axis=-1) \
        / (2.0 * cs.samplesize)
    np.testing.assert_allclose(cs.KLD_moreSamples(), expect, rtol=0, atol=0)
    # exhausted k: zero step size -> zero swing row
    cs2 = _cs([0.0, 0.8, 0.4], N=[5, np.inf, 5])
    assert np.all(cs2.Dn()[1] == 0.0)


def test_init_sample_redraws():
    cs = _cs([0.0, 0.1, 0.2])
    before = cs.evaluate().copy()
    curves_before = cs._curves.copy()
    counts_before = cs.counts0.copy()
    cs.init_sample()
    after = cs.evaluate()
    # new draws from the same generator stream: same shape/semantics,
    # different sample; counts0 is refreshed consistently. Compare the
    # cached continuous curves (almost surely distinct) rather than the
    # discretized picks, which can legitimately coincide.
    assert before.shape == after.shape
    assert np.any(curves_before != cs._curves)
    np.testing.assert_array_equal(cs.counts0, cs._tally(after))
    assert np.sum(cs.counts0) == cs.samplesize == np.sum(counts_before)


def test_evaluate_common_random_numbers():
    cs = _cs([0.0, 0.1, 0.2])
    a = cs.evaluate()
    b = cs.evaluate()
    np.testing.assert_array_equal(a, b)  # same underlying normal sample
    moved = cs.evaluate(k_change=0, n_step=50.0)
    assert np.mean(moved == 0) > np.mean(a == 0)
