"""Measurement and workflow entry points of the port (``python -m
cut_detection_tpu_torch.scripts.<name>``), ports of the scripts of the
same names under the repository's ``scripts/``; ``bench_clip`` writes the
seeded clip two of them read."""
