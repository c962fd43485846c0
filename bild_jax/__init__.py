"""
bild_jax — Bayesian Inference of Looping Dynamics on accelerators.

A from-scratch JAX/XLA framework with the capabilities of
OpenTrajectoryAnalysis/bild (Gabriele, Brandao, Grosse-Holz et al., Science
376, 2022): given a particle-tracking trajectory, infer the posterior over
piecewise-constant state profiles ("looping profiles") of a switching
linear-Gaussian physical model, via AMIS with an information-gain driven
outer loop over switch counts.

Public surface mirrors the reference (``bild/__init__.py:12-17``):
``sample``, ``SamplingResults``, ``Loopingprofile``, plus the submodules
``models``, ``amis``, ``postproc``, ``stats``. Accelerator-side additions live in
``bild_jax.parallel`` (multi-chip dataset inference), ``bild_jax.ops``
(batched kernels), and ``bild_jax.fit`` (gradient-based calibration of the
physical model parameters — enabled by the differentiable likelihood; the
reference's compiled kernel has no analog).
"""

from .profiles import Loopingprofile, state_probabilities  # noqa: F401
from .trajectory import Trajectory, make_trajectory  # noqa: F401
from . import profiles as util  # noqa: F401  (reference calls this module `util`)
from . import models  # noqa: F401
from . import physics  # noqa: F401
from . import ops  # noqa: F401
from . import amis  # noqa: F401
from . import io  # noqa: F401
from . import parallel  # noqa: F401
from . import postproc  # noqa: F401
from . import stats  # noqa: F401
from . import fit  # noqa: F401
from .infer import sample, SamplingResults  # noqa: F401
from .infer.choice import ChoiceSampler  # noqa: F401

__version__ = "0.1.0"
