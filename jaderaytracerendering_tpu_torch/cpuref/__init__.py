from . import integrator  # noqa: F401
