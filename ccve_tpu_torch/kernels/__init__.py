"""Hand-written CUDA kernels for Hopper (`csrc/*.cu`), their Python
wrappers and their plain PyTorch versions.

Every wrapper checks its tensors, runs the plain version for CPU tensors,
and for CUDA tensors launches its kernel (built by `_build.load`) or
raises. Each wrapper counts its kernel launches in its `launches`
attribute, a plain integer.
"""
