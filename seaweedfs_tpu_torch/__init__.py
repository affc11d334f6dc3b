"""PyTorch / CUDA port of the seaweedfs_tpu erasure-coding data plane.

The package mirrors `seaweedfs_tpu`'s module paths and keeps its own copy of
everything it needs: it imports torch and numpy, never jax, and nothing of
the reference package.  Entry points run on the CUDA card unless the caller
passes `device="cpu"`, which selects the plain PyTorch versions of the
kernels.
"""

__version__ = "0.1.0"  # the reference package's, which `version` prints
