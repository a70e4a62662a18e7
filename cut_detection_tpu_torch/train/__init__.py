"""Training: losses, on-device augmentation, the supervised and SimCLR
contrastive loops, and their checkpoints.  Counterpart of
``cut_detection_tpu/train/``."""
