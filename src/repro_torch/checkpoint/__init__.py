"""Checkpoints: the parameter bridge from numpy trees, and the Bebop
checkpoint format and manager, which read and write the JAX package's
files."""
from .bridge import params_from_numpy  # noqa: F401
from .format import (Manifest, TensorRecord, decode_manifest,  # noqa: F401
                     encode_manifest, flatten_tree, read_tensors,
                     unflatten_tree, write_tensor)
from .manager import CheckpointManager  # noqa: F401
