"""Checkpoints of the port: the native npz bundles, read and written, and
their conversion to and from state dicts."""
