"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on CUDA (or raises); it never falls back
from one to the other.  ``launches`` on each wrapper counts kernel
launches only.
"""
