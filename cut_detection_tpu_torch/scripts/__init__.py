"""Measurement entry points of the port (``python -m
cut_detection_tpu_torch.scripts.<name>``)."""
