"""Host decode of the port: video sources, batching, prefetch and the
decode subprocess.  Copies of the JAX package's ``cut_detection_tpu/data``
modules that the pipeline calls, trimmed to those names."""
