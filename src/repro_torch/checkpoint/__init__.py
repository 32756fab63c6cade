"""Checkpoint interop: the parameter bridge from numpy trees."""
from .bridge import params_from_numpy  # noqa: F401
