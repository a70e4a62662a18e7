"""Host-side segmentation of per-frame scores (numpy only).

Counterpart of ``cut_detection_tpu/segmentation``'s host path: the
run-length table, the orphan glue and the CSV writer.
"""
