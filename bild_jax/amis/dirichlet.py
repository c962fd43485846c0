"""
Dirichlet proposal over switch-interval fractions ``s``.

Reference parity: ``bild/amis.py:59-151``. JAX-native: sampling uses explicit
PRNG keys; `logpdf` and the weighted method-of-moments `estimate` are pure
functions usable inside jitted AMIS steps (and vmappable across a batch of
lockstep samplers).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

__all__ = ["Dirichlet", "dirichlet_logpdf", "dirichlet_estimate",
           "dirichlet_sample_masked"]


def dirichlet_sample_masked(key, a, active, N):
    """
    ``(N, K)`` Dirichlet draws over the ``active`` slots; padded slots get
    exactly 0 (so they never produce a switch in `st2profile`). With all
    slots active this is an ordinary Dirichlet sample (gamma-normalization
    construction).
    """
    a = jnp.asarray(a)
    g = jax.random.gamma(key, jnp.where(active, a, 1.0), shape=(N,) + a.shape,
                         dtype=a.dtype)
    g = jnp.where(active[None, :], g, 0.0)
    return g / jnp.sum(g, axis=-1, keepdims=True)


def dirichlet_logpdf(a, ss, active=None):
    """
    Log-density of Dirichlet(a) at samples ``ss`` (``(N, k+1)``) -> ``(N,)``.

    Edge cases follow the reference's scipy-exception semantics
    (``bild/amis.py:83-108``): a zero coordinate contributes +inf when the
    corresponding ``a < 1`` (density diverges there), -inf when ``a > 1``
    (density vanishes), and 0 when ``a == 1``.

    ``active`` (optional boolean ``(K,)``) restricts the distribution to a
    slot subset (padded-k mode); inactive slots contribute nothing.
    """
    a = jnp.asarray(a)
    ss = jnp.asarray(ss)
    if active is None:
        lognorm = jnp.sum(gammaln(a)) - gammaln(jnp.sum(a))
    else:
        lognorm = (jnp.sum(jnp.where(active, gammaln(a), 0.0))
                   - gammaln(jnp.sum(jnp.where(active, a, 0.0))))
    zero = ss <= 0
    terms = jnp.where(
        zero,
        jnp.where(a[None, :] < 1, jnp.inf, jnp.where(a[None, :] > 1, -jnp.inf, 0.0)),
        (a[None, :] - 1) * jnp.log(jnp.where(zero, 1.0, ss)),
    )
    if active is not None:
        terms = jnp.where(active[None, :], terms, 0.0)
    return jnp.sum(terms, axis=-1) - lognorm


def dirichlet_estimate(ss, log_weights, active=None):
    """
    Weighted method-of-moments estimate (reference ``bild/amis.py:110-151``):
    mean positions m, variances v, total concentration ``A = mean(m(1-m)/v)-1``,
    result ``A*m``. Degenerate zero-variance ensembles return a very
    concentrated (finite) distribution, to be reined in by the concentration
    brake. ``active`` restricts the estimate to a slot subset (padded-k
    mode); inactive slots return concentration 1.
    """
    ss = jnp.asarray(ss)
    log_weights = jnp.asarray(log_weights)
    w = jnp.exp(log_weights - jnp.max(log_weights))
    w = w / jnp.sum(w)

    hi = jax.lax.Precision.HIGHEST
    m = jnp.matmul(w, ss, precision=hi)
    v = jnp.matmul(w, (ss - m[None, :]) ** 2, precision=hi)

    # degenerate (zero-variance) ensembles: the tolerance guards against pure
    # round-off variance (e.g. k=0, where every s is exactly 1 up to fp error
    # in the weight normalization), which would otherwise produce enormous or
    # even negative concentrations. It must scale with the dtype's machine
    # epsilon: a fixed 1e-12 sits exactly at float32 round-off scale and
    # intermittently misses, yielding NaN evidence downstream.
    eps = jnp.finfo(ss.dtype).eps
    degenerate = v <= (50 * eps) ** 2
    if active is not None:
        degenerate = degenerate & active
    safe_v = jnp.where(degenerate | (v <= 0), 1.0, v)
    ratio = m * (1 - m) / safe_v
    if active is None:
        s = jnp.mean(ratio) - 1
    else:
        n_act = jnp.sum(active)
        s = jnp.sum(jnp.where(active, ratio, 0.0)) / n_act - 1
    s = jnp.where(jnp.any(degenerate), 1e10, s)
    # NB: an over-dispersed weighted ensemble can yield s <= 0, i.e. an
    # INVALID concentration (the reference would crash in scipy at the next
    # draw). We return it as-is; `amis_update` detects invalid estimates and
    # keeps the previous proposal instead (conservative, numerically safe —
    # clamping to a tiny positive concentration is NOT safe: in float32 the
    # corner-hugging proposal underflows to exact-zero draws whose density
    # singularity zero-weights the entire ensemble).
    out = s * m
    if active is not None:
        out = jnp.where(active, out, 1.0)
    return out


class Dirichlet:
    """Thin stateless wrapper bundling sample/logpdf/estimate."""

    def sample(self, key, a, N=1):
        """``(N, k+1)`` draws from Dirichlet(a)."""
        return jax.random.dirichlet(key, jnp.asarray(a), shape=(N,))

    def logpdf(self, a, ss):
        return dirichlet_logpdf(a, ss)

    def estimate(self, ss, log_weights):
        return dirichlet_estimate(ss, log_weights)
