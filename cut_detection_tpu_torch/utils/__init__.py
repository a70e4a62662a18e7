"""Device helpers for the port."""
