"""
Minimal stand-in for the ``bayesmsd`` package: the reference ``bild`` imports
``bayesmsd.gp.msd2C_fun`` and ``bayesmsd.deco`` (``bild/models.py:21-22``).
Both delegate to the repo's validated numpy implementations
(``bild_jax/physics/gp.py``).
"""
from . import gp, deco  # noqa: F401
