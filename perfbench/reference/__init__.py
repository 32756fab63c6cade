"""Plain PyTorch references of what the benchmark's cells compute.

Nothing here imports the program, JAX or the JAX package: the references
take the benchmark's own inputs and weights and work out again whatever
the program derived from them.
"""
