"""Compute primitives of the port: plain torch ops and hand-written kernels."""
