"""Launchers: production mesh, dry-run, roofline, train/serve CLIs."""
from .mesh import (axis_size, dp_axes, dp_size,  # noqa: F401
                   make_host_mesh, make_mesh, make_production_mesh)
