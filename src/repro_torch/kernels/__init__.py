"""Hand-written Hopper kernels, their builds and their plain versions.

Each kernel has a wrapper module (``rwkv6_scan``) that checks its inputs,
counts its launches and runs the plain PyTorch version from ``ref`` when the
tensors lie on the CPU.  ``build`` compiles ``csrc/*.cu`` with ``nvcc`` at
first use and loads the result with ``ctypes``.
"""
