"""Checkpoint conversion for the port (native npz bundles -> state dicts)."""
