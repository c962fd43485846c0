from .kalman import msrouse_logL_batch, msrouse_logL_single  # noqa: F401
