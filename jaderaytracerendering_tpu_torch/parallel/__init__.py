"""Multi-device rendering over torch.distributed (``sharding``)."""

from . import sharding  # noqa: F401
