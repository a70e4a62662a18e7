"""Eval-mode model modules of the port (float32)."""
